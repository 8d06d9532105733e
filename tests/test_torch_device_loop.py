"""The device loop (``solvers/device_loop.py``) on the CPU, against the
JAX package's jitted ``lax.while_loop`` cores.

The port's cores run their device-loop bodies eagerly here (the CUDA
graphs exist only on a card; ``tests/test_torch_cuda.py`` holds the
graphs against these same bodies there).  The JAX cores run under
``jax.jit`` on the CPU, as the JAX package's own tests run them.  Both
sides get the same preconditioner: the JAX package's AMG or MGR state,
carried across by ``convert``, so only summation order differs.

Problems: an 8³ 7-point Laplacian (512 rows) with the default AMG, and
``data/multiphys2k`` (ex3's system, 5,184 rows) with ex3's MGR; b from a
seeded numpy generator, x0 = 0, float64.  Iteration counts must be equal.
Histories agree to 1e-12 relative to ‖r0‖: the two packages run the same
recurrences in float64 and differ only in summation order, whose rounding
scales with the vectors, ‖r0‖, not with a residual that has shrunk to
1e-9 of it (``tests/test_torch_krylov.py`` explains the floor).

The small Krylov kernels' plain versions (``ops/krylov_small.py``) are
held bit for bit against the numpy Givens step and back-substitution the
host used to run (``givens_step`` and ``back_substitute`` below), in
float64 and float32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from hypredrive_tpu.config.sections import AMG_SCHEMA as JAX_AMG_SCHEMA
from hypredrive_tpu.config.sections import MGR_SCHEMA as JAX_MGR_SCHEMA
from hypredrive_tpu.ops.device_matrix import EllMatrix as JaxEll
from hypredrive_tpu.precon.amg.cycle import amg_apply as jax_amg_apply
from hypredrive_tpu.precon.amg.hierarchy import \
    setup_hierarchy as jax_setup_hierarchy
from hypredrive_tpu.precon.components import \
    apply_component as jax_apply_component
from hypredrive_tpu.precon.components import \
    build_component as jax_build_component
from hypredrive_tpu.precon.mgr import mgr_apply as jax_mgr_apply
from hypredrive_tpu.precon.mgr import setup_mgr as jax_setup_mgr
from hypredrive_tpu.solvers.bicgstab import _bicgstab_core
from hypredrive_tpu.solvers.fgmres import _fgmres_core
from hypredrive_tpu.solvers.gmres import _gmres_core
from hypredrive_tpu.solvers.pcg import _pcg_core
from hypredrive_tpu_torch import convert, flagship
from hypredrive_tpu_torch.io import ij
from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
from hypredrive_tpu_torch.ops.krylov_small import (givens_update,
                                                   hessenberg_backsolve)
from hypredrive_tpu_torch.precon.amg.cycle import amg_apply
from hypredrive_tpu_torch.precon.components import (apply_component,
                                                    build_component)
from hypredrive_tpu_torch.precon.mgr import mgr_apply
from hypredrive_tpu_torch.solvers import device_loop
from hypredrive_tpu_torch.solvers.bicgstab import bicgstab_core
from hypredrive_tpu_torch.solvers.fgmres import fgmres_core
from hypredrive_tpu_torch.solvers.gmres import gmres_core
from hypredrive_tpu_torch.solvers.pcg import pcg_core

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP2K = os.path.join(REPO, "data", "multiphys2k", "np1")
HIST_TOL = 1e-12      # times ‖r0‖
RTOL = 1e-9
EX3_MGR = {"level": {0: {"f_dofs": [2], "prolongation_type": "jacobi"},
                     1: {"f_dofs": [1], "g_relaxation": "l1-hsgs",
                         "restriction_type": "columped"}},
           "coarsest_level": "amg"}


def _lap8():
    A = laplacian_3d_7pt(8)
    sj = jax_setup_hierarchy(A, JAX_AMG_SCHEMA.defaults(), dtype=jnp.float64)
    st = convert.amg_state(sj)
    return (A, np.zeros(A.shape[0], np.int64),
            lambda r: jax_amg_apply(sj, r), sj,
            lambda r: amg_apply(st, r))


def _mp2k():
    A, dofmap = ij.read_matrix_auto(os.path.join(MP2K, "IJ.out.A"))[0], \
        ij.read_dofmap_auto(os.path.join(MP2K, "dofmap.out"))
    errs = []
    args = JAX_MGR_SCHEMA.parse(EX3_MGR, "mgr", errs)
    assert not errs
    sj = jax_setup_mgr(A, args, dofmap, jnp.float64)
    st = convert.mgr_state(sj)
    return (A, np.asarray(dofmap, np.int64),
            lambda r: jax_mgr_apply(sj, r), sj,
            lambda r: mgr_apply(st, r))


PROBLEMS = {"lap8_amg": _lap8, "mp2k_mgr": _mp2k}
_built = {}


def _problem(name):
    if name not in _built:
        A, tags, pc_j, sj, pc_t = PROBLEMS[name]()
        b = np.random.default_rng(7).standard_normal(A.shape[0])
        _built[name] = (name, A, tags, pc_j, sj, pc_t, b)
    return _built[name]


# name: (JAX core, port core, statics after atol, Laplacian only)
CASES = {
    "pcg": (_pcg_core, pcg_core, (200, True, 0), True),
    "pcg_mnorm": (_pcg_core, pcg_core, (200, False, 0), True),
    "pcg_recompute3": (_pcg_core, pcg_core, (200, True, 3), True),
    "bicgstab": (_bicgstab_core, bicgstab_core, (200,), False),
    "gmres30": (_gmres_core, gmres_core, (200, 30, False), False),
    "gmres5_restart": (_gmres_core, gmres_core, (200, 5, False), False),
    "gmres5_skip_real_res": (_gmres_core, gmres_core, (200, 5, True), False),
    "fgmres30": (_fgmres_core, fgmres_core, (200, 30), False),
    "fgmres4_restart": (_fgmres_core, fgmres_core, (200, 4), False),
}


def _assert_history(ht, hj, iters):
    ht, hj = np.asarray(ht)[:iters + 1], np.asarray(hj)[:iters + 1]
    assert np.all(np.isfinite(ht))
    np.testing.assert_allclose(ht, hj, rtol=0, atol=HIST_TOL * hj[0])


@pytest.mark.parametrize("name,case", [
    (p, c) for p in sorted(PROBLEMS) for c in sorted(CASES)
    if p == "lap8_amg" or not CASES[c][3]])   # PCG: the SPD Laplacian only
def test_device_loop_matches_jax(name, case):
    _, A, _, pc_j, sj, pc_t, b = _problem(name)
    jcore, tcore, statics, _ = CASES[case]
    E = JaxEll.from_csr(A)

    @jax.jit
    def run_j(bj, x0):
        return jcore(lambda v: E.matvec(v), pc_j, bj, x0, jnp.asarray(RTOL),
                     jnp.asarray(0.0), *statics)

    xj, it_j, _, done_j, hj = run_j(jnp.asarray(b), jnp.zeros(len(b)))
    Et = EllMatrix.from_csr(A)
    bt = torch.tensor(b)
    xt, it_t, _, done_t, ht = tcore(Et.matvec, pc_t, bt, torch.zeros_like(bt),
                                    RTOL, 0.0, *statics)[:5]
    assert it_t == int(it_j) and done_t == bool(done_j)
    _assert_history(ht, hj, it_t)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_gmres_xref_histories_match_jax(name):
    """Tagged reference-solution error histories (one tag on the
    Laplacian, the dofmap's on multiphys2k)."""
    _, A, tags, pc_j, sj, pc_t, b = _problem(name)
    xref = np.random.default_rng(3).standard_normal(A.shape[0])
    nt = int(tags.max()) + 1
    E = JaxEll.from_csr(A)

    @jax.jit
    def run_j(bj, x0, xr, tg):
        return _gmres_core(lambda v: E.matvec(v), pc_j, bj, x0,
                           jnp.asarray(RTOL), jnp.asarray(0.0), 200, 5,
                           False, num_tags=nt, xref=xr, tags=tg)

    _, it_j, _, _, hj, ej = run_j(jnp.asarray(b), jnp.zeros(len(b)),
                                  jnp.asarray(xref),
                                  jnp.asarray(tags, jnp.int32))
    Et = EllMatrix.from_csr(A)
    bt = torch.tensor(b)
    _, it_t, _, _, ht, et = gmres_core(
        Et.matvec, pc_t, bt, torch.zeros_like(bt), RTOL, 0.0, 200, 5, False,
        xref=torch.tensor(xref), tags=torch.tensor(tags), num_tags=nt)
    assert it_t == int(it_j) and et.shape == (201, nt)
    _assert_history(ht, hj, it_t)
    ej = np.asarray(ej)[:it_t + 1]
    np.testing.assert_allclose(et[:it_t + 1], ej, rtol=0,
                               atol=HIST_TOL * np.abs(ej).max())
    assert np.all(np.isnan(et[it_t + 1:]))


@pytest.mark.parametrize("tagged", [False, True], ids=["cycle_end",
                                                      "xref_every_step"])
def test_gmres50_givens_and_backsolve_match_jax(tagged):
    """GMRES(50) on the 16³ Laplacian without a preconditioner (73
    iterations: a whole cycle of Givens steps j = 0..49 and the 50 × 50
    back-substitution at its end, then a cycle of 23; with xref the back-
    substitution after every step too): the port's plain Givens update and
    back-substitution against the JAX package's ``rot_step`` and
    ``back_sub`` (``bs``) in its jitted core.  Equal iteration counts,
    histories (and error histories) within HIST_TOL · ‖r0‖ and x within
    1e-10 of its largest entry, the tolerances of the other JAX comparisons
    here."""
    A = laplacian_3d_7pt(16)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    xref = np.random.default_rng(6).standard_normal(A.shape[0])
    tags = np.zeros(A.shape[0], np.int64)
    kw_j = dict(num_tags=1, xref=jnp.asarray(xref),
                tags=jnp.asarray(tags, jnp.int32)) if tagged else {}
    kw_t = dict(num_tags=1, xref=torch.tensor(xref),
                tags=torch.tensor(tags)) if tagged else {}
    E = JaxEll.from_csr(A)

    @jax.jit
    def run_j(bj, x0):
        return _gmres_core(lambda v: E.matvec(v), lambda r: r, bj, x0,
                           jnp.asarray(RTOL), jnp.asarray(0.0), 200, 50,
                           False, **kw_j)

    out_j = run_j(jnp.asarray(b), jnp.zeros(len(b)))
    bt = torch.tensor(b)
    out_t = gmres_core(EllMatrix.from_csr(A).matvec, lambda r: r, bt,
                       torch.zeros_like(bt), RTOL, 0.0, 200, 50, False,
                       **kw_t)
    it_t = out_t[1]
    assert it_t == int(out_j[1]) and it_t > 50
    _assert_history(out_t[4], out_j[4], it_t)
    xj = np.asarray(out_j[0])
    np.testing.assert_allclose(out_t[0].numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
    if tagged:
        ej = np.asarray(out_j[5])[:it_t + 1]
        np.testing.assert_allclose(out_t[5][:it_t + 1], ej, rtol=0,
                                   atol=HIST_TOL * np.abs(ej).max())


# ---------------------------------------------------------------------------
# masked iterations and the unrolled form
# ---------------------------------------------------------------------------

def _lap_solver(n=6):
    A = laplacian_3d_7pt(n)
    E = EllMatrix.from_csr(A)
    d = torch.tensor(1.0 / A.diagonal())
    b = torch.tensor(np.random.default_rng(2).standard_normal(A.shape[0]))
    return E.matvec, (lambda r: d * r), b


SOLVES = {
    "pcg": lambda mv, pc, b, **k: pcg_core(mv, pc, b, torch.zeros_like(b),
                                           1e-6, 0.0, 60, True, 0, **k),
    "bicgstab": lambda mv, pc, b, **k: bicgstab_core(
        mv, pc, b, torch.zeros_like(b), 1e-6, 0.0, 60, **k),
    "gmres": lambda mv, pc, b, **k: gmres_core(
        mv, pc, b, torch.zeros_like(b), 1e-6, 0.0, 60, 8, True, **k),
    "fgmres": lambda mv, pc, b, **k: fgmres_core(
        mv, pc, b, torch.zeros_like(b), 1e-6, 0.0, 60, 8, **k),
}


@pytest.mark.parametrize("method", sorted(SOLVES))
def test_masked_iterations_change_nothing(method, monkeypatch):
    """After convergence every body is masked: the eager loop's one
    masked replay, a further call of each body, and the unrolled form's
    whole budget leave x, r, the counter and the history as the
    converged solve left them, bit for bit."""
    mv, pc, b = _lap_solver()
    loops = []
    run = device_loop.run

    def keep_loop(*args, **kw):
        out = run(*args, **kw)
        loops.append(out[0])
        return out

    monkeypatch.setattr(device_loop, "run", keep_loop)
    device_loop.reset_stats()
    out = SOLVES[method](mv, pc, b)
    assert device_loop.stats["masked"] >= 1 and out[3]
    L = loops[-1]
    state = [t.clone() for t in (L.x, L.hist,
                                 L.r if hasattr(L, "r") else L.V)]
    count = (L.i if hasattr(L, "i") else L.total).clone()
    for name, body in L.bodies.items():
        if name not in ("start", "solve"):
            body()
    for t, t0 in zip((L.x, L.hist, L.r if hasattr(L, "r") else L.V), state):
        assert torch.equal(t, t0) or torch.equal(t.isnan(), t0.isnan()) and \
            torch.equal(t.nan_to_num(), t0.nan_to_num())
    assert torch.equal(L.i if hasattr(L, "i") else L.total, count)
    # the unrolled form: the whole budget, masked past convergence
    xu, iu, nu, du, hu = SOLVES[method](mv, pc, b, unroll=True)[:5]
    assert torch.equal(xu, out[0]) and int(iu) == out[1] and bool(du)
    np.testing.assert_array_equal(hu.double().numpy(), out[4])


@pytest.mark.parametrize("rtol", [0.0, 1e-3])
@pytest.mark.parametrize("method", ["gmres", "fgmres", "pcg", "bicgstab"])
def test_unrolled_nested_component_matches_jax(method, rtol):
    """A ``krylov`` component (fixed budget, inner Jacobi) runs its core
    unrolled; it matches the JAX package's nested ``while_loop`` also
    where a relative tolerance ends it before its budget."""
    A = laplacian_3d_7pt(6)
    cfg = {"krylov": {"type": method, "max_iter": 7, "krylov_dim": 4,
                      "relative_tol": rtol, "preconditioner": "jacobi"}}
    r = np.random.default_rng(9).standard_normal(A.shape[0])
    jk, js = jax_build_component(cfg, A, jnp.float64)
    zj = np.asarray(jax.jit(lambda s, v: jax_apply_component(jk, s, v))(
        js, jnp.asarray(r)))
    tk, ts = build_component(cfg, A, torch.float64)
    device_loop.reset_stats()
    zt = apply_component(tk, ts, torch.tensor(r)).numpy()
    assert device_loop.stats["host_reads"] == 0
    np.testing.assert_allclose(zt, zj, rtol=1e-10,
                               atol=1e-10 * np.abs(zj).max())


# ---------------------------------------------------------------------------
# the small Krylov kernels' plain versions against the host code
# ---------------------------------------------------------------------------

def givens_step(H, cs, sn, g, j):
    """The host Givens step the port ran before the device loop, in H's
    dtype.  It squares by multiplication, as the kernel and XLA's ``** 2``
    do (numpy's scalar ``** 2`` goes through ``pow`` and is not always the
    correctly rounded square)."""
    for i in range(j):
        t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
        H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
        H[i, j] = t
    d = np.sqrt(H[j, j] * H[j, j] + H[j + 1, j] * H[j + 1, j])
    c_new = H[j, j] / d if d > 0 else H.dtype.type(1.0)
    s_new = H[j + 1, j] / d if d > 0 else H.dtype.type(0.0)
    H[j, j] = c_new * H[j, j] + s_new * H[j + 1, j]
    H[j + 1, j] = 0.0
    cs[j], sn[j] = c_new, s_new
    g[j + 1] = -s_new * g[j]
    g[j] = c_new * g[j]
    return abs(g[j + 1])


def back_substitute(H, g, j):
    """y solving the leading j×j upper-triangular system H y = g (zero
    where H[k, k] == 0), in H's dtype, summing each row left to right."""
    y = np.zeros(H.shape[1], H.dtype)
    for k in range(j - 1, -1, -1):
        if H[k, k] != 0:
            acc = H.dtype.type(0.0)
            for l in range(k + 1, j):
                acc = acc + H[k, l] * y[l]
            y[k] = (g[k] - acc) / H[k, k]
    return y


def _hessenberg_cycle(m, dtype, seed):
    """A cycle's columns, rotated one by one through both versions."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    cols = [rng.standard_normal(j + 2).astype(np_dt) for j in range(m)]
    cols[m // 2][m // 2 + 1] = 0        # a lucky breakdown column
    return np_dt, cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("m", [1, 5, 30, 50])
def test_givens_and_backsolve_plain_bit_identical_to_host(m, dtype):
    np_dt, cols = _hessenberg_cycle(m, dtype, seed=m)
    H, cs, sn = np.zeros((m + 1, m), np_dt), np.zeros(m, np_dt), \
        np.zeros(m, np_dt)
    g = np.zeros(m + 1, np_dt)
    g[0] = np_dt(3.7)
    Ht, cst, snt = (torch.zeros(s, dtype=dtype) for s in ((m + 1, m), m, m))
    gt = torch.tensor(g)
    hist = torch.full((m + 2,), float("nan"), dtype=dtype)
    base = torch.tensor(0)
    norm, thr = torch.zeros((), dtype=dtype), torch.tensor(1e-3, dtype=dtype)
    done, on = torch.zeros((), dtype=torch.bool), torch.tensor(True)
    y, count = torch.zeros(m, dtype=dtype), torch.tensor(0)
    for j, col in enumerate(cols):
        H[:j + 2, j] = col
        r = givens_step(H, cs, sn, g, j)
        givens_update(Ht, cst, snt, gt, torch.tensor(col), j, on, norm, thr,
                      done, hist, base)
        for a, t in ((H, Ht), (cs, cst), (sn, snt), (g, gt)):
            assert np.array_equal(a, t.numpy())
        assert norm.item() == r and hist[j + 1].item() == r
        assert bool(done) == bool(r <= np_dt(1e-3))
        count.fill_(j + 1)
        hessenberg_backsolve(Ht, gt, y, count, on)
        assert np.array_equal(back_substitute(H, g, j + 1), y.numpy())
    # masked: nothing written, the solve gives zeros
    snap = [t.clone() for t in (Ht, cst, snt, gt, norm, hist)]
    off = torch.tensor(False)
    givens_update(Ht, cst, snt, gt, torch.tensor(cols[-1]), m - 1, off,
                  norm, thr, done, hist, base)
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip((Ht, cst, snt, gt, norm, hist), snap))
    hessenberg_backsolve(Ht, gt, y, count, off)
    assert not y.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_givens_plain_takes_correctly_rounded_roots(dtype):
    """One rotation of 2,000 random columns (and one whose root torch's
    CPU sqrt rounds the wrong way) against the numpy step: bit-identical,
    so the plain version's square root is correctly rounded."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    cols = np.random.default_rng(4).standard_normal((2000, 2)).astype(np_dt)
    cols = np.concatenate([np.array([[float.fromhex("0x1.014923c114d2ep+1"),
                                      float.fromhex("0x1.2d2ffa36e332ap-3")]],
                                    np_dt), cols])
    for col in cols:
        H, cs, sn = np.zeros((2, 1), np_dt), np.zeros(1, np_dt), \
            np.zeros(1, np_dt)
        g = np.array([1.0, 0.0], np_dt)
        H[:, 0] = col
        givens_step(H, cs, sn, g, 0)
        Ht, cst, snt = (torch.zeros(s, dtype=dtype) for s in ((2, 1), 1, 1))
        gt = torch.tensor([1.0, 0.0], dtype=dtype)
        givens_update(Ht, cst, snt, gt, torch.tensor(col), 0,
                      torch.tensor(True), torch.zeros((), dtype=dtype),
                      torch.tensor(0.0, dtype=dtype), torch.tensor(False),
                      torch.zeros(2, dtype=dtype), torch.tensor(0))
        assert np.array_equal(H, Ht.numpy()) and cs[0] == cst[0].item()


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_flagship_entry_matches_jax_entry():
    """``flagship.entry()`` (16³ float32 PCG + AMG) against
    ``__graft_entry__.entry()``: equal count; final norms to rel 1e-3
    (float32 with different summation orders; they differ by 4e-5)."""
    fn, args = flagship.entry("host")
    x, iters, norm = fn(*args)
    fj, aj = jax_entry.entry()
    _, it_j, norm_j = jax.jit(fj)(*aj)
    assert iters == int(it_j) and torch.isfinite(x).all()
    assert abs(norm - float(norm_j)) <= 1e-3 * float(norm_j)


def test_profile_solve_writes_trace(tmp_path):
    trace = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "hypredrive_tpu_torch.tools.profile_solve",
         os.path.join(REPO, "examples", "ex1.yml"), "--trace", str(trace),
         "--exec-policy", "host"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "converged=True iters=5" in out.stdout
    assert "solve_warm: " in out.stdout and "not measured" in out.stdout
    assert "solve_warm device loop: 7 replays (1 masked)" in out.stdout
    assert trace.stat().st_size > 0
