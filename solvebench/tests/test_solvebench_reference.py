"""The plain reference against the port on tiny forms of each
configuration (``exec_policy: host``), and the frozen generators against
the port's own."""

import numpy as np
import pytest
import torch

from solvebench import reference
from solvebench.mix import drift_right_hand_sides, right_hand_sides
from solvebench.manifest import Manifest
from solvebench.problems import laplacian_3d_7pt as lap
from solvebench.problems import multiphysics_fv as mfv
from solvebench.problems import multiphysics_fv_drift as drift
from solvebench.sequence import SequenceSession
from solvebench.session import LibrarySession, tolerance
from solvebench.tests.tiny import TINY, held_out_config


def test_frozen_generators_are_the_ports():
    from hypredrive_tpu_torch.ops.csr import (laplacian_3d_7pt,
                                              multiphysics_fv_system)

    A, _ = lap.build(7)
    B = laplacian_3d_7pt(7)
    assert (A != B).nnz == 0 and A.shape == B.shape
    kw = dict(contrast=0.3, coupling=0.12, convection=0.08)
    (A, da), (B, db) = (mfv.build(5, 3, **kw),
                        multiphysics_fv_system(5, 3, **kw))
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data) and np.array_equal(da, db)


def test_full_sizes_are_the_stated_ones():
    """The cells' systems have the rows the configurations state (built
    here only for the small one)."""
    cfg = Manifest().config("multiphys64_gmres_mgr")
    assert cfg["problem"]["nx"] ** 3 * cfg["problem"]["ndof"] == 786432
    assert Manifest().config("poisson128_pcg_amg")["problem"]["nx"] == 128
    cfg = held_out_config()
    assert cfg["problem"]["nx"] ** 3 * cfg["problem"]["ndof"] == 786432


def test_seeds_give_the_same_inputs():
    mix = Manifest().traffic("steady_rhs")
    a = right_hand_sides(mix, 50, 2 ** 31 + 17)
    b = right_hand_sides(mix, 50, 2 ** 31 + 17)
    c = right_hand_sides(mix, 50, -3)
    assert a.shape == (8, 50) and np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("config", ["poisson128_pcg_amg",
                                    "multiphys64_gmres_mgr"])
def test_reference_agrees_with_the_port(config):
    """The reference's residual of the port's solution is the one the
    port reports (its untimed true residual), within float64 rounding,
    and meets the tolerance; a wrong solution fails."""
    man = Manifest()
    cfg = man.config(config)
    cfg["problem"].update(TINY[config])
    A, dofmap = man.system(cfg["problem"])
    rhs = right_hand_sides(man.traffic("steady_rhs"), A.shape[0], 7)
    s = LibrarySession(cfg, A, dofmap, torch.device("cpu"), "float64")
    s.setup(rhs[0])
    for b in rhs[:3]:
        x, iters, converged = s.solve(b)
        ours = reference.relative_residual(A, b, x)
        theirs = s.drv.get_final_rel_res_norm()
        assert converged and iters > 0
        assert abs(ours - theirs) <= 1e-9 * theirs + 1e-15
        assert reference.within(ours, tolerance(cfg))
        assert not reference.within(
            reference.relative_residual(A, b, np.zeros_like(x)),
            tolerance(cfg))
    s.free()


def test_a_non_finite_solution_fails():
    A = lap.laplacian_3d_7pt(3)
    b = np.ones(27)
    x = np.full(27, np.nan)
    assert not reference.within(reference.relative_residual(A, b, x), 1.0)


@pytest.mark.parametrize("k", range(6))
def test_drift_sequence_is_the_frozen_generator(k):
    """System k of the sequence is the frozen generator at coupling and
    convection scaled by f_k, on the pattern of system 0."""
    cfg = held_out_config()["problem"]
    args = {key: v for key, v in cfg.items() if key != "kind"}
    args["nx"] = 6
    systems, dofmap = drift.sequence(k + 1, **args)
    f = 1.0 + 0.1 * np.sin(2.1 * k)
    B, db = mfv.multiphysics_fv_system(
        6, 3, seed=args["seed"], contrast=args["contrast"],
        coupling=args["coupling"] * f, convection=args["convection"] * f)
    A = systems[k]
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(dofmap, db)
    assert np.max(np.abs(A.data - B.data)) <= 1e-13 * np.max(np.abs(B.data))
    assert all(np.shares_memory(S.indices, A.indices) for S in systems)
    if k:
        assert not np.array_equal(A.data, systems[0].data)
    assert (drift.build(**args)[0] != systems[0]).nnz == 0


def test_drift_right_hand_sides_follow_the_seed():
    """b_k = cos(0.3 k)·1 + 0.1·N(0, 1), the noise drawn in order from the
    seed: the same seed gives the same vectors, another seed others."""
    mix = Manifest().traffic("newton_seq")
    a = drift_right_hand_sides(mix, 40, 2 ** 31 + 17)
    b = drift_right_hand_sides(mix, 40, 2 ** 31 + 17)
    c = drift_right_hand_sides(mix, 40, -3)
    assert a.shape == (mix["systems_count"], 40) and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    rng = np.random.default_rng((2 ** 31 + 17) % (1 << 64))
    for k in range(3):
        want = np.cos(0.3 * k) + 0.1 * rng.standard_normal(40)
        assert np.array_equal(a[k], want)


def test_reference_agrees_with_the_port_over_a_sequence():
    """Over a tiny Newton sequence with per-timestep reuse: the
    reference's residual of each solution against its own system is the
    port's, within float64 rounding, and meets the tolerance; against the
    system before it, it does not; the preconditioner is rebuilt on the
    first system of each time step only."""
    man = Manifest()
    cfg = held_out_config()
    cfg["problem"].update(TINY["multiphys64_fgmres_mgr"])
    systems, dofmap = man.sequence(cfg["problem"], 6)
    rhs = drift_right_hand_sides({"systems_count": 6}, systems[0].shape[0],
                                 7)
    s = SequenceSession(cfg, dofmap, 6, 2, torch.device("cpu"), "float64")
    rebuilt = []
    for k, (A, b) in enumerate(zip(systems, rhs)):
        rec = s.solve(A, b)
        ours = reference.relative_residual(A, b, rec["x"])
        theirs = s.drv.get_final_rel_res_norm()
        assert rec["converged"] and rec["iters"] > 0
        assert abs(ours - theirs) <= 1e-9 * theirs + 1e-15
        assert reference.within(ours, tolerance(cfg))
        if k:
            assert not reference.within(reference.relative_residual(
                systems[k - 1], b, rec["x"]), tolerance(cfg))
        rebuilt.append(rec["rebuilt"])
    assert rebuilt == [True, False] * 3
    s.free()
