"""hypredrive-lsseq — pack / unpack / inspect sequence containers.

Reference analogue: utils/lsseq_driver.c (4585 LoC), documented in
docs/usrman-src/utilities.rst:395-455: a CLI that packs a directory of
per-system IJ matrix/rhs/dofmap files into one compressed `.lsseq`
container (with sparsity-pattern dedup), unpacks a container back into
multipart IJ files, and prints a container summary + manifest.

Usage:
    python -m hypredrive_tpu_torch.tools.lsseq pack OUT.lsseq -m PAT [-r PAT] \
        [-d PAT] [--codec zlib|zstd|lz4] [--parts N] [--info k=v ...]
    python -m hypredrive_tpu_torch.tools.lsseq unpack IN.lsseq OUTDIR [--ids 0,1]
    python -m hypredrive_tpu_torch.tools.lsseq inspect IN.lsseq

PAT is a glob or a printf-style pattern with one %d (system index).
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys

import numpy as np


def _expand(pattern: str):
    """Return ordered file list from a glob or %d printf pattern."""
    if "%" in pattern:
        out = []
        i = 0
        while True:
            p = pattern % i
            if not os.path.exists(p):
                break
            out.append(p)
            i += 1
        return out
    return sorted(globmod.glob(pattern))


def cmd_pack(args) -> int:
    from ..io import comp
    from ..io.ij import read_matrix_auto, read_vector_auto, read_dofmap_auto
    from ..io.lsseq import write_lsseq

    mats = _expand(args.matrix)
    if not mats:
        print(f"lsseq pack: no matrices match {args.matrix!r}",
              file=sys.stderr)
        return 1
    rhss = _expand(args.rhs) if args.rhs else []
    dofs = _expand(args.dofmap) if args.dofmap else []
    systems = []
    for i, mp in enumerate(mats):
        A, _ = read_matrix_auto(mp)
        entry = {"A": A}
        entry["b"] = (read_vector_auto(rhss[i]) if i < len(rhss)
                      else np.zeros(A.shape[0]))
        if i < len(dofs):
            entry["dofmap"] = read_dofmap_auto(dofs[i])
        systems.append(entry)
    info = {"tool": "hypredrive_tpu_torch.tools.lsseq"}
    for kv in args.info or []:
        k, _, v = kv.partition("=")
        info[k] = v
    timesteps = None
    if args.timesteps:
        raw = np.loadtxt(args.timesteps, dtype=np.int64, ndmin=2)
        timesteps = [(int(t), int(s)) for t, s in raw[:, :2]]
    write_lsseq(args.output, systems, codec=comp.codec_from_name(args.codec),
                info=info, timesteps=timesteps, n_parts=args.parts)
    size = os.path.getsize(args.output)
    raw_nnz = sum(s["A"].nnz for s in systems)
    print(f"packed {len(systems)} system(s), {raw_nnz} total nnz -> "
          f"{args.output} ({size} bytes, codec={args.codec}, "
          f"parts={args.parts})")
    return 0


def cmd_unpack(args) -> int:
    from ..io.ij import (write_matrix_multipart, write_vector_multipart,
                         write_dofmap_ascii)
    from ..io.lsseq import LSSeqFile

    f = LSSeqFile(args.input)
    os.makedirs(args.outdir, exist_ok=True)
    ids = ([int(t) for t in args.ids.split(",")] if args.ids
           else range(f.num_systems))
    for i in ids:
        A = f.read_matrix(i)
        b = f.read_rhs(i)
        pre = os.path.join(args.outdir, f"IJ.out.A.{i:05d}")
        write_matrix_multipart(pre, A, f.num_parts)
        write_vector_multipart(os.path.join(args.outdir, f"IJ.out.b.{i:05d}"),
                               b, f.num_parts)
        dof = f.read_dofmap(i)
        if dof is not None:
            write_dofmap_ascii(
                os.path.join(args.outdir, f"dofmap.out.{i:05d}"), dof)
        print(f"system {i}: {A.shape[0]} rows, {A.nnz} nnz, "
              f"pattern {f.pattern_id(i)}")
    return 0


def cmd_inspect(args) -> int:
    from ..io import comp
    from ..io.lsseq import LSSeqFile

    f = LSSeqFile(args.input)
    s = f.summary()
    print(f"{args.input}: {s.num_systems} system(s), {s.num_parts} part(s), "
          f"{s.num_patterns} unique pattern(s), codec={comp.codec_name(s.codec)}")
    print(f"  dofmap: {'yes' if s.has_dofmap else 'no'}   "
          f"timesteps: {s.num_timesteps if s.has_timesteps else 'no'}")
    if f.info:
        print("  manifest:")
        for k, v in f.info.items():
            print(f"    {k} = {v}")
    if args.verbose:
        for i in range(s.num_systems):
            A = f.read_matrix(i)
            print(f"  system {i}: {A.shape[0]} rows, {A.nnz} nnz, "
                  f"pattern {f.pattern_id(i)}")
        if s.has_timesteps:
            print(f"  timestep table: {f.read_timesteps()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hypredrive-lsseq",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pack", help="pack IJ files into a container")
    p.add_argument("output")
    p.add_argument("-m", "--matrix", required=True,
                   help="glob or %%d pattern for matrix files")
    p.add_argument("-r", "--rhs", help="glob or %%d pattern for rhs files")
    p.add_argument("-d", "--dofmap", help="pattern for dofmap files")
    p.add_argument("--codec", default="zlib",
                   choices=["none", "zlib", "zstd", "lz4"])
    p.add_argument("--parts", type=int, default=1)
    p.add_argument("--info", nargs="*", metavar="K=V")
    p.add_argument("--timesteps", help="text file of 'timestep system' rows")
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("unpack", help="unpack a container to IJ files")
    p.add_argument("input")
    p.add_argument("outdir")
    p.add_argument("--ids", help="comma-separated system ids")
    p.set_defaults(fn=cmd_unpack)

    p = sub.add_parser("inspect", help="print container summary/manifest")
    p.add_argument("input")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
