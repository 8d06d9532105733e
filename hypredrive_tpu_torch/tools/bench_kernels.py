#!/usr/bin/env python
"""Kernel micro-benchmarks on the card: the SpMV hot path beside its
ceiling, the library call and its bound.

The counterpart of three TPU scripts:

* ``scripts/bench_kernels.py``: the streaming ceiling (a triad,
  z = y + 1.5·x), the DIA SpMV on an nx³ 7-point Laplacian (``BK_NX``,
  default 64, float32) and the AMG V-cycle at that size;
* ``scripts/bench_pallas_spmv.py``: the CSR SpMV on the whole operators of
  levels 1-3 of the 64³ default-AMG hierarchy;
* ``scripts/bench_diag.py``: the kernels' build and a launch of each, the
  hierarchy's layout per level (rows, nnz, diagonals, CSR remainder) and
  each level's matvec.

The rows launch ``csrc/dia_spmv.cu`` and ``csrc/csr_spmv.cu``.  Each row is
timed by CUDA-graph replay (``core/entry.py::replay_ms``) over copies of
its operand that fill four times the L2, so no call reads its operand
from what the previous one left there.  Each SpMV row prints its kernel's
relative error against scipy (float64 products of the same values), µs,
Gnnz/s, the bound (the least bytes over the device-memory rate) and the
share of it reached, and the device time of ``torch.sparse_csr_tensor @
x`` on the same operand.  ``--exec-policy host`` runs the kernels' plain
versions on the CPU, timed by the host's clock, with no bound.

One launch of each kernel per row counts on the kernels' launch counters
(the row's correctness call, and the probe's); the timing loops count
none.  ``spmv_row``, the measurement of one SpMV row, is also what
``chip_smoke.py``'s kernel checks use.

The ``epilogue`` rows time each of the cycles' fused steps
(``ops/epilogue.py``: the residual with the Chebyshev start, the last
Chebyshev step, the Jacobi step on A0 and A1, the correction x + P·e on P0
and P1) against the torch chain it replaces, over the same operand copies,
and say whether the two agree bit for bit.

Usage: BK_NX=64 python -m hypredrive_tpu_torch.tools.bench_kernels
           [--dtype float64] [--exec-policy host]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np

from ..core.entry import add_exec_policy, device, replay_ms, synchronize
from ..core.errors import HypredrvError
from ..solvers.device_loop import uncounted

HBM_TB_S = 3.35   # H100 SXM device-memory rate (NVIDIA data sheet)
L2_BYTES = 50 * 2**20   # H100 SXM L2 cache (NVIDIA data sheet)
BOUND_SHARE_MAX = 1.05  # a kernel faster than its bound: a wrong bound or timing


def bound_ms(nbytes):
    """The least time to move ``nbytes`` at the device-memory rate."""
    return nbytes / (HBM_TB_S * 1e12) * 1e3


def spmv_bytes(kind, E, itemsize):
    """Least bytes one matvec of E's DIA or CSR part moves: its stored
    entries (values; the CSR's indices and indptr too), y and x once.  A
    DIA slot that holds no entry of the matrix (a zero inside the band or
    past its ends) is no work of the function and is not counted."""
    import torch

    nr, nc = E.shape
    if kind == "dia_spmv":
        entries = int(torch.count_nonzero(E.dia_data))
        return entries * itemsize + (nr + nc) * itemsize
    return (E.data.numel() * (itemsize + 4)
            + (nr + 1) * E.indptr.element_size() + (nr + nc) * itemsize)


def operand_copies(nbytes):
    """Copies of a kernel's operand (the matrix part and x) that one timing
    cycles through: enough to fill four times the L2, so that every call
    reads its operand from device memory, as the bound assumes, and not
    from what the previous call left in the L2."""
    return max(1, -(-4 * L2_BYTES // nbytes))


def dia_as_csr(dia, offsets, n_cols):
    """(crow, col, values) int32/int32/dtype of a (D, n_rows) DIA part, the
    entries inside the columns, row by row in offset order."""
    import torch

    n_rows = dia.shape[1]
    offs = torch.tensor(offsets, device=dia.device)
    cols = torch.arange(n_rows, device=dia.device)[:, None] + offs[None, :]
    ok = (cols >= 0) & (cols < n_cols)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=dia.device)
    crow[1:] = torch.cumsum(ok.sum(dim=1), 0)
    return crow.int(), cols[ok].int(), dia.t()[ok].contiguous()


def library_spmv(crow, col, values, shape):
    """One PyTorch call computing the same product: a sparse CSR tensor
    times x (cuSPARSE on the card).  The yardstick of library_ms; the port
    never calls it."""
    import torch

    A = torch.sparse_csr_tensor(crow, col, values, size=shape,
                                check_invariants=False)
    return lambda x: torch.mv(A, x)


def _host_ms(fns, reps=20):
    """Host time of one call on the CPU (no card: the plain versions)."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    fns[0]()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    return (time.perf_counter() - t0) / reps * 1e3


def spmv_row(op, x, run, library, nbytes, ref):
    """One SpMV row: ``run(op, x)``, a kernel on operand ``op`` (a tuple of
    tensors), against ``ref``, the product it must give; its time; the
    time and error of ``library(op)``, one PyTorch call computing the same
    product; on the card the bound and the share of it reached.  On the
    card every timing is a graph replay over copies of op and x that fill
    four times the L2, and a kernel faster than its bound raises; on the
    CPU the host's clock over one copy, with no bound.  Only the first
    call counts as a launch.  Returns (row, ops, xs): the copies, for
    further timings over the same operands."""
    on_card = x.device.type == "cuda"
    copies = operand_copies(nbytes) if on_card else 1
    ops = [op] + [tuple(t.clone() for t in op) for _ in range(copies - 1)]
    xs = [x] + [x.clone() for _ in ops[1:]]
    ref = ref.double()
    scale = float(ref.abs().max()) or 1.0
    err = float((run(op, x).double() - ref).abs().max())
    timer = replay_ms if on_card else _host_ms
    with uncounted():
        ms = timer([lambda o=o, v=v: run(o, v) for o, v in zip(ops, xs)])
    row = {"max_abs_err": err, "max_rel_err": err / scale, "device_ms": ms,
           "bytes": nbytes, "operand_copies": len(ops),
           "bound_ms": bound_ms(nbytes) if on_card else None,
           "bound_by": "bytes",
           "timer": "graph replay" if on_card else "host clock"}
    row["bound_share"] = (None if row["bound_ms"] is None
                          else row["bound_ms"] / ms)
    try:
        libs = [library(o) for o in ops]
        yl = libs[0](x)
        row["library_rel_err"] = float((yl.double() - ref).abs().max()) / scale
        row["library_ms"] = timer([lambda f=f, v=v: f(v)
                                   for f, v in zip(libs, xs)])
    except RuntimeError as exc:   # no such call here, or not capturable
        row["library_ms"] = None
        row["library_error"] = str(exc)[:200]
    if on_card and row["bound_share"] > BOUND_SHARE_MAX:
        raise HypredrvError(f"{ms:.4f} ms beats the bound "
                            f"{row['bound_ms']:.4f} ms: the bound or the "
                            "timing is wrong")
    return row, ops, xs


class Bench:
    """The rows, timed on ``dev``: by graph replay over operand copies on
    the card, by the host's clock on the CPU; no timing counts a launch."""

    def __init__(self, dev, dtype):
        self.dev, self.dtype = dev, dtype
        self.on_card = dev.type == "cuda"
        self.rows = []
        self.rng = np.random.default_rng(0)

    def ms(self, fns):
        with uncounted():
            return replay_ms(fns) if self.on_card else _host_ms(fns)

    def copies(self, nbytes):
        return operand_copies(nbytes) if self.on_card else 1

    def _print(self, row):
        bound = ("" if row["bound_ms"] is None else
                 f"  bound {row['bound_ms']:.4f} ms "
                 f"({100 * row['bound_share']:.1f}%)")
        lib = ("" if "library_ms" not in row else
               "  library n/a" if row["library_ms"] is None else
               f"  library {row['library_ms']:.4f} ms")
        err = ("" if row.get("rel_err") is None
               else f"  rel {row['rel_err']:.2e}")
        if "plain_ms" in row:
            err = (f"  plain {row['plain_ms'] * 1e3:9.2f} us "
                   f"{'bit-equal' if row['bit_equal'] else 'DIFFERS'}, "
                   "fused")
        rate = (f"  {row['gnnz_s']:7.2f} Gnnz/s" if "gnnz_s" in row
                else f"  {row['gb_s']:7.1f} GB/s")
        print(f"{row['name']:9s} {row['shape']:30s}{err}  "
              f"{row['ms'] * 1e3:9.2f} us{rate}{bound}{lib}", flush=True)

    def _row(self, name, shape, ms, nbytes, **extra):
        bound = bound_ms(nbytes) if self.on_card else None
        row = {"name": name, "shape": shape,
               "dtype": str(self.dtype).replace("torch.", ""), "ms": ms,
               "bytes": nbytes, "bound_ms": bound,
               "bound_share": None if bound is None else bound / ms,
               "timer": "graph replay" if self.on_card else "host clock",
               **extra}
        self.rows.append(row)
        self._print(row)
        return row

    def triad(self, n):
        """z = y + 1.5·x over n elements: 3n words, the streaming ceiling."""
        import torch

        nbytes = 3 * n * self.dtype.itemsize
        ops = [tuple(torch.ones(n, dtype=self.dtype, device=self.dev)
                     for _ in range(3)) for _ in range(self.copies(nbytes))]
        ms = self.ms([lambda o=o: torch.add(o[1], o[0], alpha=1.5, out=o[2])
                      for o in ops])
        return self._row("triad", f"n={n}", ms, nbytes,
                         gb_s=nbytes / (ms * 1e-3) / 1e9)

    def spmv(self, kind, shape, E, A_part):
        """One kernel part of device matrix E (``kind``: dia_spmv or
        csr_spmv) against scipy's product with ``A_part``, the same part
        on the host."""
        import torch

        from ..ops.csr_spmv import csr_spmv
        from ..ops.dia_spmv import dia_spmv

        nr, nc = E.shape
        nbytes = spmv_bytes(kind, E, self.dtype.itemsize)
        x_host = self.rng.standard_normal(nc).astype(
            np.float32 if self.dtype == torch.float32 else np.float64)
        x = torch.as_tensor(x_host, device=self.dev)
        ref = torch.as_tensor(A_part.astype(np.float64)
                              @ x_host.astype(np.float64))
        if kind == "dia_spmv":
            offs = E.dia_offsets
            op = (E.dia_data,)

            def run(o, v):
                return dia_spmv(o[0], offs, v, nc)

            def library(o):
                return library_spmv(*dia_as_csr(o[0], offs, nc), E.shape)
            nnz = int(torch.count_nonzero(E.dia_data))
        else:
            op = (E.indptr, E.indices, E.data, E.tiles)

            def run(o, v):
                return csr_spmv(o[0], o[1], o[2], v, nr, o[3])

            def library(o):
                return library_spmv(o[0].int(), o[1], o[2], E.shape)
            nnz = E.data.numel()
        m, _, _ = spmv_row(op, x, run, library, nbytes, ref.to(self.dev))
        return self._row(kind, shape, m["device_ms"], nbytes,
                         rel_err=m["max_rel_err"], nnz=nnz,
                         gnnz_s=nnz / (m["device_ms"] * 1e-3) / 1e9,
                         **{k: v for k, v in m.items()
                            if k.startswith("library")})

    def matrix(self, label, E, A_host):
        """Each kernel part of E (DIA, CSR) against scipy."""
        import scipy.sparse as sp

        out = []
        if E.dia_data is not None:
            crow, col, val = dia_as_csr(E.dia_data.cpu(), E.dia_offsets,
                                        E.shape[1])
            part = sp.csr_matrix((val.numpy(), col.numpy(), crow.numpy()),
                                 shape=E.shape)
            out.append(self.spmv("dia_spmv", f"{label} D={len(E.dia_offsets)}",
                                 E, part))
        if E.data is not None:
            part = sp.csr_matrix((E.data.cpu().numpy(),
                                  E.indices.cpu().numpy(),
                                  E.indptr.cpu().numpy()), shape=E.shape)
            out.append(self.spmv("csr_spmv",
                                 f"{label} nnz={E.data.numel()}", E, part))
        return out

    def epilogues(self, label, E, P):
        """Each fused step on level operator E (the correction on its
        prolongation P) against its torch chain: device ms of both, the
        bound of the fused step (the least bytes: the matrix part, each
        vector read or written once) and whether the two agree bit for
        bit."""
        import torch

        from ..ops import epilogue as ep

        def vec(k):
            return torch.as_tensor(self.rng.standard_normal(k),
                                   dtype=self.dtype, device=self.dev)

        w = self.dtype.itemsize
        theta, c1, c2 = 1.7, 0.61, 0.93
        steps = (   # name, operator, vectors read or written, fused, plain
            ("residual_z0", E, 4,
             lambda M, v: M.residual(v[0], v[1], v[2].abs(), theta),
             lambda M, v: ep.residual_plain(M, v[0], v[1], v[2].abs(),
                                            theta)),
            ("cheby_last", E, 4,
             lambda M, v: M.cheby_step(v[0], v[1], v[1], v[2], c1, c2,
                                       v[3], True),
             lambda M, v: ep.cheby_step_plain(M, v[0], v[1], v[1], v[2],
                                              c1, c2, v[3], True)),
            ("jacobi", E, 3,
             lambda M, v: M.jacobi_step(v[1], v[0], v[2]),
             lambda M, v: ep.jacobi_step_plain(M, v[1], v[0], v[2])),
            ("add", P, 2,
             lambda M, v: M.matvec_add(v[0], v[4]),
             lambda M, v: ep.matvec_add_plain(M, v[0], v[4])))
        out = []
        for name, M, n_vec, fused, plain in steps:
            nr, nc = M.shape
            matrix = sum(t.numel() * t.element_size() for t in (
                M.dia_data, M.data, M.indices, M.indptr) if t is not None)
            nbytes = matrix + nc * w + n_vec * nr * w
            mats = [M] + [copy.deepcopy(M)
                          for _ in range(self.copies(nbytes) - 1)]
            vecs = [[vec(nr) for _ in range(4)] + [vec(nc)] for _ in mats]
            a, b = fused(mats[0], vecs[0]), plain(mats[0], vecs[0])
            a, b = (a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,))
            equal = all(torch.equal(x, y) for x, y in zip(a, b))
            ms = {k: self.ms([lambda M=M, v=v, f=f: f(M, v)
                              for M, v in zip(mats, vecs)])
                  for k, f in (("fused", fused), ("plain", plain))}
            out.append(self._row(
                "epilogue", f"{label} {name} n={nr}", ms["fused"], nbytes,
                plain_ms=ms["plain"], bit_equal=equal,
                gb_s=nbytes / (ms["fused"] * 1e-3) / 1e9))
        return out

    def vcycle(self, state, A_host):
        """One AMG V-cycle apply, over copies of the whole hierarchy."""
        import torch

        from ..precon.amg.cycle import amg_apply

        nbytes = sum(t.numel() * t.element_size() for lv in state.levels
                     for E in (lv.A, lv.P, lv.R) if E is not None
                     for t in (E.dia_data, E.indptr, E.indices, E.data,
                               E.tiles, E.dense) if t is not None)
        states = [state] + [copy.deepcopy(state)
                            for _ in range(self.copies(nbytes) - 1)]
        n = A_host.shape[0]
        bs = [torch.ones(n, dtype=self.dtype, device=self.dev)
              for _ in states]
        ms = self.ms([lambda s=s, b=b: amg_apply(s, b)
                      for s, b in zip(states, bs)])
        return self._row("vcycle", f"n={n} levels={len(state.levels)}", ms,
                         nbytes, nnz=int(A_host.nnz),
                         gnnz_s=A_host.nnz / (ms * 1e-3) / 1e9,
                         hierarchy_copies=len(states))


def probe(dev):
    """bench_diag's probe: build the kernels (timed) and launch each once
    on a small operand, against its plain version."""
    import torch

    from ..ops.csr_spmv import csr_spmv, csr_spmv_plain, csr_tiles
    from ..ops.dia_spmv import dia_spmv, dia_spmv_plain

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from ..ops import kernels

        kernels.lib()
    build_s = time.perf_counter() - t0
    n = 1024
    x = torch.ones(n, dtype=torch.float32, device=dev)
    dia = torch.full((3, n), 2.0, dtype=torch.float32, device=dev)
    y = dia_spmv(dia, (-1, 0, 1), x, n)
    y_plain = dia_spmv_plain(dia, (-1, 0, 1), x, n)
    indptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    indices = (np.arange(2 * n) // 2 + np.tile([0, 1], n)) % n
    ip = torch.as_tensor(indptr, device=dev)
    ix = torch.as_tensor(indices.astype(np.int32), device=dev)
    vals = torch.ones(2 * n, dtype=torch.float32, device=dev)
    tiles = torch.as_tensor(csr_tiles(indptr), device=dev)
    z = csr_spmv(ip, ix, vals, x, n, tiles)
    z_plain = csr_spmv_plain(ip, ix, vals, x, n)
    synchronize(dev)
    ok = bool(torch.equal(y, y_plain) and torch.equal(z, z_plain))
    print(f"probe: kernels built and loaded in {build_s:.3f} s; dia_spmv "
          f"and csr_spmv launched on {dev.type}: "
          f"{'OK' if ok else 'MISMATCH'}", flush=True)
    return {"build_s": build_s, "launch_ok": ok}


def run(nx=64, dtype="float32", policy="device"):
    """Every row on an nx³ Laplacian; returns {"probe", "levels", "rows"}."""
    import torch

    from ..config.sections import AMG_SCHEMA
    from ..ops.csr import laplacian_3d_7pt
    from ..ops.device_matrix import EllMatrix
    from ..precon.amg.hierarchy import setup_hierarchy

    dev = device(policy)
    dt = getattr(torch, dtype)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} nx={nx} dtype={dtype}", flush=True)
    out = {"probe": probe(dev)}
    A_host = laplacian_3d_7pt(nx, dtype=np.float32 if dt == torch.float32
                              else np.float64)
    E = EllMatrix.from_csr(A_host, dtype=dt, device=dev)
    n = A_host.shape[0]
    print(f"n={n} nnz={A_host.nnz} dia_offsets={E.dia_offsets} csr_nnz="
          f"{0 if E.data is None else E.data.numel()}", flush=True)
    bench = Bench(dev, dt)
    bench.triad(n)
    bench.matrix(f"A0 {n}x{n}", E, A_host)

    state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(), dtype=dt,
                            device=dev, fine_matrix=E)
    levels = []
    print("lvl |        n |      nnz | D(dia) | csr nnz | dense | "
          "matvec us", flush=True)
    for i, lv in enumerate(state.levels):
        L = lv.A
        xi = torch.ones(L.shape[1], dtype=dt, device=dev)
        t = bench.ms(lambda L=L, xi=xi: L.matvec(xi))
        levels.append({"level": i, "n": L.shape[0], "nnz": L.nnz,
                       "dia": len(L.dia_offsets),
                       "csr_nnz": 0 if L.data is None else L.data.numel(),
                       "dense": L.dense is not None, "matvec_ms": t})
        d = levels[-1]
        print(f"{i:3d} | {d['n']:8d} | {d['nnz']:8d} | {d['dia']:6d} | "
              f"{d['csr_nnz']:7d} | {str(d['dense']):5s} | {t * 1e3:9.2f}",
              flush=True)
    out["levels"] = levels
    # bench_pallas_spmv: the CSR kernel on the whole level operator
    for i, lv in enumerate(state.levels[1:4], start=1):
        C = lv.A.to_csr().tocoo()
        whole = EllMatrix.from_split(
            C.shape, C.nnz, ((), None, C.row, C.col, C.data), dt, dev)
        bench.matrix(f"A{i} {C.shape[0]}x{C.shape[1]}", whole, C.tocsr())
    for i, lv in enumerate(state.levels[:2]):
        if lv.P is not None:
            bench.epilogues(f"A{i}/P{i}", lv.A, lv.P)
    bench.vcycle(state, A_host)
    out["rows"] = bench.rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    out = run(int(os.environ.get("BK_NX", "64")), args.dtype,
              args.exec_policy)
    return 0 if out["probe"]["launch_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
