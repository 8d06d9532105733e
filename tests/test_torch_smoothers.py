"""Hybrid Gauss-Seidel and FSAI AMG smoothers against the JAX package.

On the 10³ Laplacian of ``data/ps3d10pt7`` with ex2's and ex8's AMG
options, on the CPU in float64:

* the port's host setup builds the JAX package's hierarchy: level sizes,
  smoother kinds and sweeps, the hybrid-GS triangles and diagonals, and
  the FSAI smoother's G, Gᵀ and ω bit for bit (adaptive FSAI picks, on a
  Laplacian, among candidates whose Kaporin gradients are equal in exact
  arithmetic, so its pattern follows the last bits of the row solves: the
  port's compiled solve makes the LAPACK calls the JAX package's vmapped
  solve makes on the CPU);
* ``_smooth`` on every level, both phases, with and without the zero-guess
  elision, and a whole V-cycle, on the JAX package's hierarchy carried
  across with ``convert.amg_state``, and a whole V-cycle on the port's own
  hierarchy, match the JAX package's to rel 1e-12 (float64 summation
  order only).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypredrive_tpu.config import sections as jax_sections
from hypredrive_tpu.precon.amg import cycle as jax_cycle
from hypredrive_tpu.precon.amg import hierarchy as jax_hierarchy
from hypredrive_tpu_torch import convert
from hypredrive_tpu_torch.config import sections
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.precon.amg import cycle, hierarchy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12

CONFIGS = {
    # examples/ex2.yml: forward/backward hybrid GS and adaptive FSAI on
    # the finest level
    "ex2": {"interpolation": {"prolongation_type": "extended+i",
                              "max_nnz_row": 4},
            "coarsening": {"type": "pmis", "strong_th": 0.25,
                           "rand_seed": 7919, "max_coarse_size": 64},
            "relaxation": {"down_type": "forward-hl1gs",
                           "up_type": "backward-hl1gs"},
            "smoother": {"type": "fsai", "num_levels": 1, "num_sweeps": 1,
                         "fsai": {"algo_type": 1, "max_steps": 5,
                                  "max_step_size": 1, "eig_max_iters": 4,
                                  "kap_tolerance": 1e-2}}},
    # examples/ex8.yml variant 3: symmetric hybrid GS
    "ex8_gs_sym": {"coarsening": {"type": "hmis", "strong_th": 0.8},
                   "interpolation": {"prolongation_type": "mm-ext+i"},
                   "relaxation": {"down_type": "l1sym-hgs", "up_type":
                                  "l1sym-hgs", "down_sweeps": 1,
                                  "up_sweeps": 1}},
    # examples/ex8.yml variant 4: the ilu complex smoother (→ FSAI, default
    # adaptive options) on level 0 under Chebyshev
    "ex8_ilu_smoother": {"coarsening": {"type": "hmis", "strong_th": 0.9},
                         "interpolation": {"prolongation_type": "mm-ext+i"},
                         "relaxation": {"down_type": 16, "up_type": 16},
                         "smoother": {"type": "ilu", "num_levels": 1}},
    # static FSAI on two levels, two sweeps, relax type 8 (GS sym) below
    "sfsai_two_levels": {"relaxation": {"type": 8, "num_sweeps": 2},
                         "smoother": {"type": "fsai", "num_levels": 2,
                                      "num_sweeps": 2,
                                      "fsai": {"algo_type": "bj-sfsai",
                                               "max_steps": 3,
                                               "max_step_size": 2}}},
}


@pytest.fixture(scope="module")
def laplacian():
    A, _ = ij.read_matrix_auto(os.path.join(REPO, "data", "ps3d10pt7",
                                            "np1", "IJ.out.A"))
    return A


@pytest.fixture(scope="module")
def hierarchies(laplacian):
    """(JAX package's state, port's own state) per config."""
    out = {}
    for name, cfg in CONFIGS.items():
        sj = jax_hierarchy.setup_hierarchy(
            laplacian, jax_sections.AMG_SCHEMA.parse(cfg, "amg", []),
            dtype=jnp.float64)
        st = hierarchy.setup_hierarchy(
            laplacian, sections.AMG_SCHEMA.parse(cfg, "amg", []),
            dtype=torch.float64)
        out[name] = (sj, st)
    return out


def _csr_equal(Et, Ej):
    """The same stored entries, bit for bit."""
    At, Aj = Et.to_csr(), Ej.to_csr()
    At.sort_indices()
    Aj.sort_indices()
    assert At.shape == Aj.shape
    np.testing.assert_array_equal(At.indptr, Aj.indptr)
    np.testing.assert_array_equal(At.indices, Aj.indices)
    np.testing.assert_array_equal(At.data, Aj.data)


def _csr_close(Et, Ej):
    At, Aj = Et.to_csr(), Ej.to_csr()
    assert At.shape == Aj.shape
    assert abs(At - Aj).max() <= RTOL * abs(Aj).max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hierarchy_matches_jax(name, hierarchies):
    sj, st = hierarchies[name]
    assert [lv.A.shape for lv in st.levels] == \
        [lv.A.shape for lv in sj.levels]
    for lt, lj in zip(st.levels[:-1], sj.levels[:-1]):
        assert (lt.smoother, lt.pre_sweeps, lt.post_sweeps,
                lt.up_smoother) == (lj.smoother, lj.pre_sweeps,
                                    lj.post_sweeps, lj.up_smoother)
        for kind, at, aj in ((lt.smoother, lt.smooth_arrays,
                              lj.smooth_arrays),
                             (lt.up_smoother, lt.up_arrays, lj.up_arrays)):
            if kind == "fsai":
                _csr_equal(at[0], aj[0])
                _csr_equal(at[1], aj[1])
                assert at[2] == float(aj[2])
            elif kind is not None and kind.startswith("gs-"):
                np.testing.assert_array_equal(at[0].numpy(),
                                              np.asarray(aj[0]))
                for mt, mj in zip(at[1:], aj[1:]):
                    assert (mt is None) == (mj is None)
                    if mt is not None:
                        _csr_close(mt, mj)
    kinds = {lv.smoother for lv in st.levels[:-1]}
    assert kinds & {"fsai", "gs-fwd", "gs-sym"}


def _levels_and_vectors(name, hierarchies):
    sj, _ = hierarchies[name]
    st = convert.amg_state(sj)
    rng = np.random.default_rng(3)
    for lt, lj in zip(st.levels[:-1], sj.levels[:-1]):
        n = lt.A.shape[0]
        yield lt, lj, rng.standard_normal(n), rng.standard_normal(n)


def _close(z, ref):
    ref = np.asarray(ref)
    assert np.abs(z.numpy() - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("phase,zero_guess", [("pre", True),
                                              ("pre", False),
                                              ("post", False)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_smooth_matches_jax(name, phase, zero_guess, hierarchies):
    for lt, lj, x, b in _levels_and_vectors(name, hierarchies):
        if zero_guess:
            x = np.zeros_like(x)
        sweeps = lt.pre_sweeps if phase == "pre" else lt.post_sweeps
        ref = jax_cycle._smooth(lj, jnp.asarray(x), jnp.asarray(b), sweeps,
                                phase=phase, zero_guess=zero_guess)
        z = cycle._smooth(lt, torch.tensor(x), torch.tensor(b), sweeps,
                          phase=phase, zero_guess=zero_guess)
        _close(z, ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_amg_cycle_matches_jax(name, hierarchies):
    sj, st = hierarchies[name]
    r = np.random.default_rng(4).standard_normal(sj.levels[0].A.shape[0])
    ref = jax_cycle.amg_apply(sj, jnp.asarray(r))
    _close(cycle.amg_apply(convert.amg_state(sj), torch.tensor(r)), ref)
    # the port's own hierarchy: the same setup, so the same cycle
    _close(cycle.amg_apply(st, torch.tensor(r)), ref)
