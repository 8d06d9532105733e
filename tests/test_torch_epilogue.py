"""The cycles' vector chains behind ``ops/epilogue.py`` on the CPU.

On the CPU, and on a dense operator anywhere, each ``EllMatrix`` step
method runs the torch chain the cycles ran before the chains were folded
into the SpMV kernels, so every number the tests against the JAX package
see is unchanged: here each method equals that chain, written out, bit for
bit, and counts ``epilogue_plain``.  The row-shard mesh's
``DistEllMatrix`` takes the same chains as its methods and counts
nothing.  The kernels' epilogues themselves run only on a card
(``tests/test_torch_cuda.py``).
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypredrive_tpu_torch.core import trace
from hypredrive_tpu_torch.ops import epilogue
from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
from hypredrive_tpu_torch.precon.chebyshev import (cheby_apply,
                                                   cheby_coefficients,
                                                   cheby_steps)
from hypredrive_tpu_torch.solvers import device_loop as dl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = (torch.float32, torch.float64)


def _layout(name, rng):
    """Host matrices whose device form has the named parts."""
    if name == "dia":
        return laplacian_3d_7pt(10)
    if name == "mixed":
        return sp.csr_matrix(laplacian_3d_7pt(10) + sp.random(
            1000, 1000, density=3e-3, random_state=rng, format="csr"))
    if name == "csr":
        return sp.random(900, 700, density=0.01, random_state=rng,
                         format="csr")
    return sp.csr_matrix(rng.standard_normal((60, 60)))   # dense


LAYOUTS = ("dia", "mixed", "csr", "dense")


def _operand(lay, dtype):
    rng = np.random.default_rng(11)
    A = _layout(lay, rng)
    E = EllMatrix.from_csr(A, dtype=dtype)
    assert (E.dense is not None) == (lay == "dense")
    if lay in ("dia", "mixed"):
        assert E.dia_data is not None
    assert (E.data is not None) == (lay in ("mixed", "csr"))
    m, n = A.shape

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=dtype)
    return E, vec, m, n


@pytest.fixture(params=[(lay, dt) for lay in LAYOUTS for dt in DTYPES],
                ids=lambda p: f"{p[0]}-{str(p[1])[6:]}")
def operand(request):
    return _operand(*request.param)


def _mixed(dtype):
    """The ``mixed`` layout: a DIA part and a CSR remainder."""
    return _operand("mixed", dtype)


def _counts():
    return trace.stats["epilogue_fused"], trace.stats["epilogue_plain"]


def _eq(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_methods_equal_the_chains_on_the_cpu(operand):
    E, vec, m, n = operand
    trace.reset_stats()
    theta, c1, c2 = 1.7, 0.61, 0.93
    if m == n:
        b, x, u = vec(m), vec(m), vec(m).abs()
        assert _eq(E.residual(b, x), b - E.matvec(x))
        r, z0 = E.residual(b, x, u, theta)
        assert _eq(r, b - E.matvec(x)) and _eq(z0, u * r / theta)
        z, d = vec(m), vec(m)
        rk = u * (r - E.matvec(z))
        dn = c1 * d + c2 * rk
        zn = z + dn
        z2, d2 = E.cheby_step(r, z, d, u, c1, c2)
        assert _eq(z2, zn) and _eq(d2, dn)
        assert _eq(E.cheby_step(r, z, d, u, c1, c2, x, last=True), x + zn)
        assert _eq(E.cheby_step(r, z, d, u, c1, c2, last=True), zn)
        assert _eq(E.jacobi_step(x, b, u), x + u * (b - E.matvec(x)))
        calls = 6
    else:
        calls = 0
    x, e = vec(m), vec(n)
    assert _eq(E.matvec_add(x, e), x + E.matvec(e))
    assert _counts() == (0, calls + 1)


class _Plain:
    """An operator with a matvec and the torch chains as its step
    methods, as the row-shard mesh's ``DistEllMatrix`` takes them."""

    residual = epilogue.residual_plain
    cheby_step = epilogue.cheby_step_plain
    jacobi_step = epilogue.jacobi_step_plain
    matvec_add = epilogue.matvec_add_plain

    def __init__(self, E):
        self.E, self.shape = E, E.shape

    def matvec(self, x):
        return self.E.matvec(x)


def test_entry_points_take_the_method_where_there_is_one(operand):
    """The cycles call the level operator's step methods: an
    ``EllMatrix`` runs its own (and counts it), an operator that takes
    the torch chains as its methods runs the same chain uncounted."""
    E, vec, m, n = operand
    b, x, u, z, d, e = tuple(vec(m) for _ in range(5)) + (vec(n),)
    square = m == n
    for A, counted in ((E, 5 if square else 1), (_Plain(E), 0)):
        trace.reset_stats()
        if square:
            r, z0 = A.residual(b, x, u, 2.5)
            assert _eq(r, b - E.matvec(x)) and _eq(z0, u * r / 2.5)
            assert _eq(A.residual(b, x), b - E.matvec(x))
            z2, d2 = A.cheby_step(r, z, d, u, 0.3, 0.4)
            assert _eq(z2, z + (0.3 * d + 0.4 * (u * (r - E.matvec(z)))))
            assert _eq(A.jacobi_step(x, b, u), x + u * (b - E.matvec(x)))
        assert _eq(A.matvec_add(x, e), x + E.matvec(e))
        assert _counts() == (0, counted)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("with_x", [False, True])
def test_cheby_steps_is_the_recurrence(order, with_x):
    """The recurrence cheby_apply and the AMG smoother share, against the
    loop both ran before, written out."""
    rng = np.random.default_rng(order)
    E = EllMatrix.from_csr(laplacian_3d_7pt(6))
    n = E.shape[0]
    d_inv = 1.0 / E.diagonal()
    theta, delta, rhos = cheby_coefficients(12.0, 0.3, order)
    rhos = tuple(float(r) for r in rhos)
    r = torch.tensor(rng.standard_normal(n))
    x = torch.tensor(rng.standard_normal(n)) if with_x else None
    z = d_inv * r / theta
    d = z
    rho_prev = rhos[0]
    for k in range(1, len(rhos)):
        rk = d_inv * (r - E.matvec(z))
        d = rhos[k] * rho_prev * d + (2.0 * rhos[k] / delta) * rk
        z = z + d
        rho_prev = rhos[k]
    want = z if x is None else x + z
    got = cheby_steps(E, d_inv, delta, rhos, r, d_inv * r / theta, x)
    assert _eq(got, want)
    if x is None:
        assert _eq(cheby_apply((E, d_inv, theta, delta, rhos), r), want)


def test_reciprocal_is_torch_s_for_the_dtype():
    """The reciprocal torch multiplies by to divide a CUDA tensor by a
    Python float: taken in double, rounded to the tensor's type (1.7 is a
    value where rounding θ to float32 first gives another float)."""
    assert epilogue.reciprocal(1.7, torch.float64) == 1.0 / 1.7
    r32 = epilogue.reciprocal(1.7, torch.float32)
    assert r32 == float(np.float32(1.0 / 1.7)) != 1.0 / 1.7
    assert r32 != float(np.float32(1.0) / np.float32(1.7))


def test_args_refuse_vectors_the_kernel_cannot_take():
    like = torch.zeros(8, dtype=torch.float64)
    ep = epilogue.args(epilogue.JACOBI, 8, like, b=like, u=like, x=like,
                       out=like, d=None)
    assert ep.kind == epilogue.JACOBI and ep.d is None
    assert ep.b == like.data_ptr()
    for bad in (torch.zeros(7, dtype=torch.float64),
                torch.zeros(8, dtype=torch.float32),
                torch.zeros(16, dtype=torch.float64)[::2]):
        with pytest.raises(ValueError):
            epilogue.args(epilogue.ADD, 8, like, x=bad, out=like)


def test_counters_are_registered_and_replayed():
    assert {"epilogue_fused", "epilogue_plain"} <= set(trace.STAT_KEYS)
    assert {"epilogue_fused", "epilogue_plain"} <= set(dl.REPLAYED)
    trace.reset_stats()
    E = EllMatrix.from_csr(laplacian_3d_7pt(4))
    v = torch.ones(E.shape[0], dtype=torch.float64)
    with dl.uncounted():
        E.residual(v, v)
    assert _counts() == (0, 0)


def test_amg_cycle_counts_plain_steps_on_the_cpu():
    """One V-cycle of the default AMG (Chebyshev(2), one sweep each way)
    on the CPU: every step is a torch chain, counted as plain."""
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

    A = laplacian_3d_7pt(12)
    st = setup_hierarchy(A, AMG_SCHEMA.defaults())
    trace.reset_stats()
    z = amg_apply(st, torch.ones(A.shape[0], dtype=torch.float64))
    assert torch.isfinite(z).all()
    smoothed = len(st.levels) - 1
    # a level: the pre-sweep's Chebyshev step, the residual, the
    # correction, the post-sweep's residual and Chebyshev step
    assert _counts() == (0, 5 * smoothed)


def test_mesh_levels_keep_the_plain_cycle():
    """A ``DistEllMatrix`` level's step methods are the torch chains: the
    cycle runs them on it and counts no step."""
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.parallel import (DistEllMatrix, make_mesh,
                                               pad_vector)
    from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

    mesh = make_mesh(8, device="cpu")
    A = laplacian_3d_7pt(8)
    st = setup_hierarchy(A, AMG_SCHEMA.defaults(), mesh=mesh)
    assert all(isinstance(lv.A, DistEllMatrix) for lv in st.levels)
    for name in ("residual", "cheby_step", "jacobi_step", "matvec_add"):
        assert getattr(DistEllMatrix, name) is getattr(epilogue,
                                                       name + "_plain")
    r = pad_vector(np.random.default_rng(2).standard_normal(A.shape[0]),
                   st.levels[0].A.shape[0], mesh)
    trace.reset_stats()
    z = amg_apply(st, r)
    assert torch.isfinite(z).all() and _counts() == (0, 0)
    D = st.levels[0].A
    b = torch.ones_like(r)
    assert _eq(D.residual(b, r), b - D.matvec(r))
    assert _counts() == (0, 0)


def _share_reader():
    sys.path.insert(0, REPO)
    try:
        from solvebench.manifest import Manifest
    finally:
        sys.path.remove(REPO)
    return Manifest(REPO).reader("fused_epilogue_share")


@pytest.mark.parametrize("before,after,want", [
    ({}, {}, None),
    ({"epilogue_fused": 0, "epilogue_plain": 0},
     {"epilogue_fused": 0, "epilogue_plain": 0}, None),
    ({"epilogue_fused": 10, "epilogue_plain": 5},
     {"epilogue_fused": 40, "epilogue_plain": 15}, 75.0),
    ({"epilogue_fused": 0, "epilogue_plain": 0},
     {"epilogue_fused": 0, "epilogue_plain": 8}, 0.0),
    ({}, {"epilogue_fused": 3}, 100.0),
])
def test_fused_epilogue_share_reads_the_window(before, after, want):
    from types import SimpleNamespace

    read = _share_reader()
    got = read(SimpleNamespace(before=before, after=after, solves=[1]))
    assert got == want


def test_epilogue_launchers_are_counted_apart_and_need_a_card():
    """The kernels with an epilogue count their launches on their own
    wrappers, which the device loop replays like the plain ones; on the
    CPU they refuse to run (there is no plain epilogue kernel)."""
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv_epilogue
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv_epilogue

    assert {dia_spmv_epilogue, csr_spmv_epilogue} <= set(dl.counted())
    E, _, n, _ = _mixed(torch.float64)
    v = torch.ones(n, dtype=torch.float64)
    ep = epilogue.args(epilogue.ADD, n, v, x=v, out=torch.empty_like(v))
    n0 = (dia_spmv_epilogue.launches, csr_spmv_epilogue.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        dia_spmv_epilogue(E.dia_data, E.dia_offsets, v, n, ep)
    with pytest.raises(ValueError, match="unsupported device"):
        csr_spmv_epilogue(E.indptr, E.indices, E.data, v, n, E.tiles,
                          None, ep)
    assert (dia_spmv_epilogue.launches, csr_spmv_epilogue.launches) == n0


def _roofline_metric():
    sys.path.insert(0, REPO)
    try:
        from solvebench.manifest import Manifest
    finally:
        sys.path.remove(REPO)
    return Manifest(REPO)._module("metrics", "epilogue_roofline")


def test_epilogue_roofline_reads_nothing_off_the_card_or_without_methods():
    from types import SimpleNamespace

    read = _roofline_metric().read
    E = EllMatrix.from_csr(laplacian_3d_7pt(4))
    ops = [("A0", E), ("P0", E), ("R0", E)]
    assert read(SimpleNamespace(on_card=False,
                                operators=lambda: ops)) is None
    # a program whose operators have a matvec and no step methods
    bare = [("A0", object()), ("P0", None), ("R0", None)]
    assert read(SimpleNamespace(on_card=True,
                                operators=lambda: bare)) is None


@pytest.mark.parametrize("kind", ["chebyshev-2", "chebyshev-3", "l1-jacobi",
                                  "masked-jacobi", "none"])
def test_epilogue_roofline_times_the_steps_the_cycle_calls(kind):
    """The reader's steps for a finest level: the residual; the residual
    with the Chebyshev start and each Chebyshev step, or the Jacobi step,
    by the level's relaxation; the correction on P.  Each runs (here the
    plain chain) on vectors shaped as the timing makes them."""
    from types import SimpleNamespace

    mod = _roofline_metric()
    A = EllMatrix.from_csr(laplacian_3d_7pt(4))
    P = EllMatrix.from_csr(sp.random(64, 20, density=0.2, random_state=1,
                                     format="csr"))
    if kind.startswith("chebyshev"):
        order = int(kind[-1])
        level = SimpleNamespace(smoother="chebyshev", smooth_arrays=(
            None, 1.0, 1.0, (0.5,) * order))
    elif kind == "masked-jacobi":
        level = SimpleNamespace(f_kind="masked-jacobi")
    else:
        level = SimpleNamespace(smoother=kind)
    steps = mod._steps(level, A, P)
    want = {"chebyshev-2": 4, "chebyshev-3": 5, "l1-jacobi": 3,
            "masked-jacobi": 3, "none": 2}[kind]
    assert len(steps) == want
    assert steps[-1][0] is P and all(s[0] is A for s in steps[:-1])
    trace.reset_stats()
    for op, n_vec, call in steps:
        m, n = op.shape
        v = [torch.randn(m, dtype=torch.float64) for _ in range(5)]
        out = call(op, v + [torch.randn(n, dtype=torch.float64)])
        for t in out if isinstance(out, tuple) else (out,):
            assert t.shape == (m,) and torch.isfinite(t).all()
        assert 2 <= n_vec <= 5
    assert _counts() == (0, want)
    assert mod._steps(None, A, None)[0][0] is A
