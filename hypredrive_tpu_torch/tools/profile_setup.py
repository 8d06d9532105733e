"""Profile the AMG setup and V-cycle phases on the card.

The port of ``scripts/profile_setup.py``.  Breaks the bench's
``amg_setup_s`` (a 64³ float32 Laplacian, the AMG defaults) into:

- the host graph work per level (strength, coarsen, interp, RAP);
- the device matrix build (``EllMatrix.from_csr``: the DIA part, the CSR
  remainder and its ``csr_tiles`` table) of every level's A, P and R, with
  the bytes uploaded and their rate;
- the ``setup_hierarchy`` total and the hierarchy summary;
- the first cycle (with the kernels' build at first use) and the device
  time per cycle (CUDA-graph replay);
- host-to-device copies of 1, 16 and 64 MB, and the host time per matvec
  launch without a synchronise (in place of the JAX script's dispatch
  latency over the TPU's link);
- the adaptive FSAI build of the same operator with its defaults (the
  setup of AMG's ``ilu`` smoother, ex8's entry 3): the host's row solves
  and the upload of G and Gᵀ, float64 as the CLI's solves.

The JAX script's gather-plan building is TPU-only and has no counterpart.
Every phase is a lap of one clock, so the phases add up to the total.

Usage: python -m hypredrive_tpu_torch.tools.profile_setup [grid_n]
           [--exec-policy host]
"""

from __future__ import annotations

import argparse
import sys
import time

import scipy.sparse as sp
import torch

from ..core.entry import add_exec_policy, device, replay_ms, synchronize


class Clock:
    """Consecutive laps of one clock: ``lap(name)`` is the time since the
    previous lap, so the laps add up to the time since the start."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.laps = {}

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.last
        self.last = now
        return self.laps[name]

    def total(self) -> float:
        return self.last - self.start


def _uploaded_bytes(E) -> int:
    return sum(t.numel() * t.element_size()
               for t in (E.dia_data, E.indptr, E.indices, E.data, E.tiles,
                         E.dense) if t is not None)


def run(n1: int = 64, policy: str = "device") -> dict:
    """The phases on an n1³ Laplacian; prints each as it ends."""
    from ..config.sections import AMG_SCHEMA
    from ..ops.csr import laplacian_3d_7pt
    from ..ops.device_matrix import EllMatrix
    from ..precon.amg import hierarchy as H
    from ..precon.amg.coarsen import coarsen
    from ..precon.amg.cycle import amg_apply
    from ..precon.amg.interp import build_interpolation
    from ..precon.amg.strength import strength_graph
    from ..precon.fsai import build_fsai_adaptive

    clock = Clock()
    dev = device(policy)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} device={name}", flush=True)
    clock.lap("device")
    A = laplacian_3d_7pt(n1)
    print(f"matrix build: {clock.lap('matrix_build'):.3f}s  n={A.shape[0]} "
          f"nnz={A.nnz}", flush=True)
    args = AMG_SCHEMA.defaults()
    dtype = torch.float32

    # --- phase 1: host-side graph work only (no device arrays) ---
    A_l = A
    host_levels = []
    while A_l.shape[0] > 64 and len(host_levels) < 24:
        lv = len(host_levels)
        clock.lap("host_graph")
        S = strength_graph(A_l, theta=0.25)
        t_s = clock.lap(f"host_L{lv}_strength")
        cf = coarsen(S, ctype=8, seed=lv)
        nC = int((cf > 0).sum())
        t_c = clock.lap(f"host_L{lv}_coarsen")
        if nC == 0 or nC >= A_l.shape[0]:
            break
        P = build_interpolation(A_l, S, cf, prolongation_type=6)
        t_i = clock.lap(f"host_L{lv}_interp")
        A_c = sp.csr_matrix(P.T @ A_l @ P)
        A_c.sort_indices()
        t_r = clock.lap(f"host_L{lv}_rap")
        print(f"  lvl {lv}: n={A_l.shape[0]} nnz={A_l.nnz} "
              f"strength={t_s:.3f} coarsen={t_c:.3f} interp={t_i:.3f} "
              f"rap={t_r:.3f}", flush=True)
        host_levels.append((A_l, P))
        A_l = A_c
    clock.lap("host_graph")
    host_s = sum(t for k, t in clock.laps.items() if k.startswith("host_"))
    print(f"host graph total: {host_s:.3f}s ({len(host_levels) + 1} levels)",
          flush=True)

    # --- phase 2: the device matrices of those levels (A, P, R) ---
    upload = 0
    for A_lvl, P_lvl in host_levels:
        for M in (A_lvl, P_lvl, sp.csr_matrix(P_lvl.T)):
            upload += _uploaded_bytes(
                EllMatrix.from_csr(M, dtype=dtype, device=dev))
    synchronize(dev)
    t_up = clock.lap("device_matrix_build")
    print(f"device matrix build (EllMatrix.from_csr, csr_tiles): "
          f"{t_up:.3f}s  bytes={upload / 1e6:.1f}MB "
          f"({upload / 1e6 / t_up:.1f} MB/s)", flush=True)

    # --- phase 3: full setup_hierarchy (includes the upload) ---
    state = H.setup_hierarchy(A, args, dtype=dtype, device=dev)
    synchronize(dev)
    t_setup = clock.lap("setup_hierarchy")
    print(f"setup_hierarchy total: {t_setup:.3f}s", flush=True)
    print(H.hierarchy_summary(state), flush=True)

    # --- phase 4: the first cycle, then the cycle's own time ---
    b = torch.ones(A.shape[0], dtype=dtype, device=dev)
    amg_apply(state, b)
    synchronize(dev)
    t_first = clock.lap("first_cycle")
    if dev.type == "cuda":
        t_cycle = replay_ms(lambda: amg_apply(state, b)) / 1e3
        how = "device, CUDA-graph replay"
    else:
        reps = 20
        for _ in range(reps):
            amg_apply(state, b)
        t_cycle = (time.perf_counter() - clock.last) / reps
        how = "host clock"
    clock.lap("cycles")
    tot_nnz = sum(lv.A.nnz for lv in state.levels)
    print(f"first cycle (kernel build at first use): {t_first:.3f}s  "
          f"per-cycle: {t_cycle * 1e3:.3f}ms ({how}) "
          f"eff={2 * tot_nnz / t_cycle / 1e9:.2f} Gnnz/s", flush=True)

    # --- transfer bandwidth probe (host to device) ---
    copies = {}
    if dev.type == "cuda":
        for mb in (1, 16, 64):
            x = torch.ones(mb * 1024 * 1024 // 4, dtype=torch.float32)
            synchronize(dev)
            t0 = time.perf_counter()
            x.to(dev)
            synchronize(dev)
            copies[mb] = time.perf_counter() - t0
            print(f"host->device {mb}MB: {copies[mb]:.4f}s "
                  f"({mb / copies[mb]:.1f} MB/s)", flush=True)
    else:
        print("host->device copies: not measured (no card)", flush=True)
    clock.lap("transfer_probe")

    # --- host time per matvec launch, no synchronise inside the loop ---
    A0 = state.levels[0].A
    x = torch.ones(A.shape[0], dtype=dtype, device=dev)
    A0.matvec(x)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(50):
        A0.matvec(x)
    launch_s = (time.perf_counter() - t0) / 50
    synchronize(dev)
    clock.lap("launch_probe")
    print(f"matvec launch (host, no sync): {launch_s * 1e6:.1f} us/call",
          flush=True)

    # --- the adaptive FSAI build of the same operator ---
    fsai = build_fsai_adaptive(A, device=dev)
    synchronize(dev)
    t_fsai = clock.lap("fsai_adaptive")
    print(f"adaptive FSAI build (host row solves, upload): {t_fsai:.3f}s  "
          f"G nnz={fsai.G.nnz}", flush=True)
    total = clock.total()
    print(f"total: {total:.3f}s (the sum of the phases above)", flush=True)
    return {"device": name, "rows": A.shape[0], "nnz": int(A.nnz),
            "host_levels": len(host_levels) + 1,
            "levels": len(state.levels), "host_graph_s": host_s,
            "upload_bytes": upload, "setup_hierarchy_s": t_setup,
            "first_cycle_s": t_first, "cycle_s": t_cycle,
            "cycle_timing": how, "h2d_s": copies,
            "launch_s": launch_s, "fsai_adaptive_s": t_fsai,
            "fsai_nnz": int(fsai.G.nnz), "phases": dict(clock.laps),
            "total_s": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid_n", type=int, nargs="?", default=64)
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    run(args.grid_n, args.exec_policy)
    return 0


if __name__ == "__main__":
    sys.exit(main())
