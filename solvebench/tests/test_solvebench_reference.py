"""The plain reference against the port on tiny forms of each
configuration (``exec_policy: host``), and the frozen generators against
the port's own."""

import numpy as np
import pytest
import torch

from solvebench import reference
from solvebench.mix import right_hand_sides
from solvebench.manifest import Manifest
from solvebench.problems import laplacian_3d_7pt as lap
from solvebench.problems import multiphysics_fv as mfv
from solvebench.session import LibrarySession, tolerance
from solvebench.tests.tiny import TINY


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
