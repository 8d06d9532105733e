"""The small dense steps of GMRES and FGMRES: Givens update and Hessenberg
back-substitution.

The CUDA kernels (``csrc/krylov_small.cu``) are the device form of what
the JAX package leaves to XLA inside its jitted loop
(``hypredrive_tpu/solvers/gmres.py``: the ``rot_step`` and ``back_sub``
``fori_loop``s); they are not ports of TPU kernels.  Without them a
captured GMRES step would hold dozens of 0-d launches for the rotations.

H is the (m + 1, m) Hessenberg matrix of one restart cycle; cs, sn (m)
and g (m + 1) are the rotations and the rotated right-hand side.  Every
flag, count and norm the kernels read or write is a 0-d tensor on the
device, so that a captured graph needs no host value:

- :func:`givens_update` writes the Arnoldi column ``col`` (j + 2 entries)
  into ``H[:, j]``, applies rotations 0..j-1 to it, forms rotation j,
  rotates g and writes ``norm = |g[j+1]|``, ``done = norm <= thr`` and
  ``hist[hist_base + j + 1] = norm`` when that index is in range;
- :func:`hessenberg_backsolve` writes y (m) solving the leading
  ``jcount`` × ``jcount`` upper-triangular system ``H y = g``, zero where
  ``H[k, k] == 0`` and past ``jcount``.

Both are masked by the device flag ``active``: when it is false the update
writes nothing and the solve writes zeros.  Each wrapper launches its
kernel for CUDA tensors and runs its plain version for CPU tensors; the
plain versions read ``active``, ``jcount`` and the argument of the root
to the host and are never captured.  Both sides do the arithmetic in the same order (the kernels
are built with ``-fmad=false``) and take correctly rounded square roots,
so they agree bit for bit.
``givens_update.launches`` and ``hessenberg_backsolve.launches`` count
the kernel launches.

Each kernel is one block that stages its operands in shared memory and
runs the recurrence in one instruction stream out of it (the Givens step
on 128 threads; the back-substitution on 256, the triangle streamed in
chunks through two buffers when it does not fit); the source's header
says how.  :func:`empty_node` and :func:`latency_probe` are measurement
helpers, not counted: the floor under any one-block launch and the
latencies of the operations the recurrences chain.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels


def givens_update_plain(H, cs, sn, g, col, j: int, active, norm, thr, done,
                        hist, hist_base) -> None:
    """Plain torch version of :func:`givens_update` (in place)."""
    if not bool(active):
        return
    H[:j + 2, j] = col
    for i in range(j):
        hi, hn = H[i, j].clone(), H[i + 1, j].clone()
        H[i, j] = cs[i] * hi + sn[i] * hn
        H[i + 1, j] = -sn[i] * hi + cs[i] * hn
    hjj, hnj = H[j, j].clone(), H[j + 1, j].clone()
    # correctly rounded, as the kernel's sqrt is: torch's CPU sqrt (SLEEF,
    # 0.5001 ulp) misses in about 1 of 150 float32 and float64 arguments;
    # a float32 root taken in float64 and rounded back is exact too
    d = torch.tensor(math.sqrt(float(hjj * hjj + hnj * hnj)),
                     dtype=H.dtype, device=H.device)
    pos = bool(d > 0)
    c = hjj / d if pos else torch.ones_like(d)
    s = hnj / d if pos else torch.zeros_like(d)
    H[j, j] = c * hjj + s * hnj
    H[j + 1, j] = 0.0
    cs[j], sn[j] = c, s
    gj = g[j].clone()
    g[j + 1] = -s * gj
    g[j] = c * gj
    r = torch.abs(g[j + 1])
    norm.copy_(r)
    done.copy_(r <= thr)
    e = int(hist_base) + j + 1
    if e < hist.shape[0]:
        hist[e] = r


def hessenberg_backsolve_plain(H, g, y, jcount, active) -> None:
    """Plain torch version of :func:`hessenberg_backsolve` (into y)."""
    y.zero_()
    if not bool(active):
        return
    m = H.shape[1]
    n = min(int(jcount), m)
    for k in range(n - 1, -1, -1):
        hkk = H[k, k]
        if bool(hkk != 0):
            acc = torch.zeros_like(hkk)
            for l in range(k + 1, n):
                acc = acc + H[k, l] * y[l]
            y[k] = (g[k] - acc) / hkk


def _check(H, vecs, flags, ints):
    if H.dim() != 2 or H.shape[0] != H.shape[1] + 1:
        raise ValueError(f"krylov_small: H of shape {tuple(H.shape)}, "
                         "expected (m + 1, m)")
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"krylov_small: dtype {H.dtype}; float32 or float64")
    for t in vecs:
        if t.dtype != H.dtype or t.dim() > 1 or not t.is_contiguous():
            raise ValueError("krylov_small: vectors and scalars must be "
                             "contiguous, of H's dtype")
    for t in flags:
        if t.dtype != torch.bool or t.numel() != 1:
            raise TypeError("krylov_small: flags must be one bool")
    for t in ints:
        if t.dtype != torch.int64 or t.numel() != 1:
            raise TypeError("krylov_small: counts must be one int64")
    devs = {t.device for t in (H, *vecs, *flags, *ints)}
    if len(devs) != 1:
        raise ValueError(f"krylov_small: tensors on several devices {devs}")
    if not H.is_contiguous():
        raise ValueError("krylov_small: H must be contiguous")


def _fn(name, dtype):
    return getattr(kernels.lib(), f"hdtt_{name}_"
                   f"{'f32' if dtype == torch.float32 else 'f64'}")


def givens_update(H, cs, sn, g, col, j: int, active, norm, thr, done, hist,
                  hist_base) -> None:
    """Step j of the Givens QR of H, masked by ``active`` (module
    docstring); the CUDA kernel on CUDA tensors, else the plain version."""
    m = H.shape[1]
    _check(H, (cs, sn, g, col, norm, thr, hist), (active, done), (hist_base,))
    if not (0 <= j < m and col.shape[0] == j + 2 and cs.shape[0] == m
            and sn.shape[0] == m and g.shape[0] == m + 1):
        raise ValueError(f"givens_update: step {j} of m = {m} with col "
                         f"{tuple(col.shape)}, g {tuple(g.shape)}")
    if H.device.type == "cpu":
        return givens_update_plain(H, cs, sn, g, col, j, active, norm, thr,
                                   done, hist, hist_base)
    if H.device.type != "cuda":
        raise ValueError(f"givens_update: unsupported device {H.device}")
    with torch.cuda.device(H.device):   # launch on H's card
        rc = _fn("givens_update", H.dtype)(
            H.data_ptr(), cs.data_ptr(), sn.data_ptr(), g.data_ptr(),
            col.data_ptr(), j, m, active.data_ptr(), norm.data_ptr(),
            thr.data_ptr(), done.data_ptr(), hist.data_ptr(),
            hist_base.data_ptr(), hist.shape[0],
            torch.cuda.current_stream(H.device).cuda_stream)
    kernels.check(rc, "givens_update")
    givens_update.launches += 1


def hessenberg_backsolve(H, g, y, jcount, active) -> None:
    """y = the masked back-substitution of H y = g (module docstring); the
    CUDA kernel on CUDA tensors, else the plain version."""
    m = H.shape[1]
    _check(H, (g, y), (active,), (jcount,))
    if g.shape[0] != m + 1 or y.shape[0] != m:
        raise ValueError(f"hessenberg_backsolve: g {tuple(g.shape)}, y "
                         f"{tuple(y.shape)} for m = {m}")
    if H.device.type == "cpu":
        return hessenberg_backsolve_plain(H, g, y, jcount, active)
    if H.device.type != "cuda":
        raise ValueError(f"hessenberg_backsolve: unsupported device "
                         f"{H.device}")
    with torch.cuda.device(H.device):   # launch on H's card
        rc = _fn("hessenberg_backsolve", H.dtype)(
            H.data_ptr(), g.data_ptr(), y.data_ptr(), m, jcount.data_ptr(),
            active.data_ptr(),
            torch.cuda.current_stream(H.device).cuda_stream)
    kernels.check(rc, "hessenberg_backsolve")
    hessenberg_backsolve.launches += 1


givens_update.launches = 0
hessenberg_backsolve.launches = 0


def empty_node(threads: int) -> None:
    """Launch one empty block of ``threads`` threads on the current CUDA
    stream (the floor under a one-block kernel node)."""
    rc = kernels.lib().hdtt_empty_node(
        threads, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "empty_node")


def latency_probe(dtype) -> dict:
    """Cycles and nanoseconds per operation of 4,096 dependent adds,
    multiplies, divides and square roots in ``dtype``, timed on the current
    card by one thread's SM clock and global timer (built like the
    kernels, with ``-fmad=false``)."""
    reps = 4096
    out = torch.zeros(8, dtype=torch.int64, device="cuda")
    sink = torch.zeros(4, dtype=dtype, device="cuda")
    rc = _fn("latency_probe", dtype)(
        reps, out.data_ptr(), sink.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "latency_probe")
    v = out.tolist()
    return {op: {"cycles": v[2 * i] / reps, "ns": v[2 * i + 1] / reps}
            for i, op in enumerate(("add", "mul", "div", "sqrt"))}


def graph_nodes(graph) -> int:
    """The node count of a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True`` (before or after ``instantiate``)."""
    n = ctypes.c_int64(0)
    rc = kernels.lib().hdtt_graph_nodes(graph.raw_cuda_graph(),
                                        ctypes.byref(n))
    kernels.check(rc, "graph_nodes")
    return int(n.value)
