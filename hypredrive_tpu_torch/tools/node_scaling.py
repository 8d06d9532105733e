#!/usr/bin/env python
"""Weak/strong scaling sweep over row shards, one card per rank.

The port of ``scripts/node_scaling.py`` (the reference's
scripts/node_scaling.sh + perf_laplacian.sh, ref:
docs/usrman-src/performance.rst:83-186): runs CG + AMG on generated
Laplacians over meshes of 1, 2, 4 and 8 row shards and reports rows/s and
nnz/s per shard, plus the efficiency against one shard.

Under ``torchrun --nproc_per_node=N`` (one rank per card, the JAX
script's one device per shard) a mesh of c shards spans c ranks, c / N
shards a card past N ranks; ranks outside a mesh wait for the next one.
Run as a plain ``python -m`` (no torchrun), every mesh is c shards of one
card, so the efficiency there measures the distributed layer's overhead
on one card, not scaling across cards.  ``--exec-policy host`` runs the shards on the
CPU (gloo between ranks) in place of the JAX script's ``--virtual N``.

Usage:
  python -m hypredrive_tpu_torch.tools.node_scaling --mode weak --rows-per-chip 262144
  torchrun --nproc_per_node=4 -m hypredrive_tpu_torch.tools.node_scaling --mode strong --rows 1048576
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..core.entry import add_exec_policy, device, synchronize

SHARD_COUNTS = (1, 2, 4, 8)


def run(mode: str = "weak", rows_per_chip: int = 262_144,
        rows: int = 1_048_576, reps: int = 20, policy: str = "device",
        shard_counts=SHARD_COUNTS):
    """One PCG + AMG solve (to 1e-8, 50 iterations at most, b = ones) per
    mesh, timed over ``reps`` warm solves; prints the table (rank 0) and
    returns its rows (on every rank of each mesh)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..config.sections import AMG_SCHEMA
    from ..ops.csr import laplacian_3d_7pt
    from ..parallel import DistEllMatrix, make_mesh, pad_vector
    from ..precon.amg.cycle import amg_apply
    from ..precon.amg.hierarchy import setup_hierarchy
    from ..solvers.pcg import pcg_core

    dev = device(policy)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world > 1 and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say = print if rank == 0 else (lambda *a, **k: None)
    if world == 1:
        say(f"# row shards of one device ({name}): the efficiency is the "
            "distributed layer's overhead on one device, not scaling "
            "across cards")
    else:
        say(f"# {world} ranks, one device each ({name})")
    results = []
    say(f"{'shards':>6} {'ranks':>5} {'rows':>10} {'nnz':>12} "
        f"{'t_solve[s]':>11} {'iters':>6} {'nnz/s/shard':>12} {'eff%':>6}")
    base_rate = None
    for ndev in shard_counts:
        ranks = min(world, ndev)
        group = None
        if world > 1:
            # every rank takes part in creating each group
            group = dist.new_group(list(range(ranks)))
        if rank >= ranks:
            continue
        n_rows = rows_per_chip * ndev if mode == "weak" else rows
        nx = max(4, round(n_rows ** (1 / 3)))
        A = laplacian_3d_7pt(nx)
        mesh = make_mesh(ndev, device=dev, group=group)
        D = DistEllMatrix.from_csr(A, mesh)
        state = setup_hierarchy(A, AMG_SCHEMA.defaults(), mesh=mesh)
        b = pad_vector(np.ones(A.shape[0]), D.shape[0], mesh)
        x0 = pad_vector(np.zeros(A.shape[0]), D.shape[0], mesh)

        def step():
            return pcg_core(D.matvec, lambda r: amg_apply(state, r), b, x0,
                            1e-8, 0.0, 50, True, 0, group=mesh.reduce_group)

        out = step()  # warm
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step()
        synchronize(dev)
        dt = (time.perf_counter() - t0) / reps
        it = int(out[1])
        rate = A.nnz * max(it, 1) / dt / ndev
        if base_rate is None:
            base_rate = rate
        eff = 100.0 * rate / base_rate
        say(f"{ndev:>6} {ranks:>5} {A.shape[0]:>10} {A.nnz:>12} "
            f"{dt:>11.4f} {it:>6} {rate:>12.3e} {eff:>6.1f}")
        results.append({"shards": ndev, "ranks": ranks,
                        "rows": int(A.shape[0]),
                        "nnz": int(A.nnz), "t_solve": dt, "iters": it,
                        "nnz_per_s_per_shard": rate, "efficiency_pct": eff,
                        "mode": mode, "device": name})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("weak", "strong"), default="weak")
    ap.add_argument("--rows-per-chip", type=int, default=262_144,
                    help="rows per shard (weak scaling)")
    ap.add_argument("--rows", type=int, default=1_048_576,
                    help="total rows (strong scaling)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None, help="append JSON lines here")
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    from ..core import runtime

    runtime.initialize()       # the process group under torchrun
    results = run(args.mode, args.rows_per_chip, args.rows, args.reps,
                  args.exec_policy)
    import torch.distributed as dist

    if args.json and (not dist.is_initialized() or dist.get_rank() == 0):
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
