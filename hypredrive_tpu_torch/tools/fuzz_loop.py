#!/usr/bin/env python
"""Coverage-guided mutation fuzzer for the port's input-handling surfaces.

The port of ``scripts/fuzz_loop.py`` (the reference's libFuzzer/AFL
harness, ref: tests/fuzz/harness.c): the same five modes -- parse (YAML),
matrix, vector, lsseq (binary readers), comp (codec blobs) -- aimed at
this package's readers, driven by an in-process mutation loop with edge
coverage feedback (``sys.settrace`` over ``hypredrive_tpu_torch`` files
only; an input that executes a new (line -> line) edge joins the live
corpus and gets mutated further).

Contract under test: every malformed input raises a typed
HypredrvError/ConfigError -- never any other exception.  Crashing inputs
are minimized by truncation and saved to
``tests/fuzz_corpus_torch/<mode>/``, which ``tests/test_torch_fuzz.py``
replays with the JAX package's corpus (``tests/fuzz_corpus/``, read
here as seeds and never written).

The readers run on the host; ``--exec-policy`` is taken as by every tool
(the default needs the card).

Usage: python -m hypredrive_tpu_torch.tools.fuzz_loop [--minutes N | --seconds S]
           [--mode parse|matrix|...] [--seed N] [--exec-policy host]
Exit status 1 if any new crash was found.
"""

from __future__ import annotations

import argparse
import atexit
import hashlib
import os
import random
import shutil
import struct
import sys
import tempfile
import time

import numpy as np

from ..core.entry import add_exec_policy, device

PKG_DIR = os.sep + "hypredrive_tpu_torch" + os.sep
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS_DIR = os.path.join(REPO, "tests", "fuzz_corpus_torch")
JAX_CORPUS_DIR = os.path.join(REPO, "tests", "fuzz_corpus")

MAGIC_BYTES = [b"\x00", b"\xff", b"\x7f", b"\x80",
               struct.pack("<q", -1), struct.pack("<q", 1 << 62),
               struct.pack("<d", float("nan")),
               struct.pack("<d", float("inf")),
               b"HDRVLSQ1", b"include:", b"- ", b"{", b"}", b"\t"]

_SCRATCH = []


def _scratch() -> str:
    """This process's directory for the files the readers are given."""
    if not _SCRATCH:
        d = tempfile.mkdtemp(prefix="hdtt_fuzz_")
        atexit.register(shutil.rmtree, d, True)
        _SCRATCH.append(d)
    return _SCRATCH[0]


# ---------------------------------------------------------------------------
# coverage collector: (file, prev_line, line) edges inside the package
# ---------------------------------------------------------------------------

class EdgeTracer:
    def __init__(self):
        self.edges = set()
        self._prev = None

    def __call__(self, frame, event, arg):
        fn = frame.f_code.co_filename
        if PKG_DIR not in fn:
            return None
        if event == "line":
            self.edges.add((fn, self._prev, frame.f_lineno))
            self._prev = frame.f_lineno
        return self

    def run(self, fn, *args):
        self.edges = set()
        self._prev = None
        old = sys.gettrace()
        sys.settrace(self)
        try:
            fn(*args)
        finally:
            sys.settrace(old)
        return frozenset(self.edges)


# ---------------------------------------------------------------------------
# targets: each takes bytes and must raise only typed errors
# ---------------------------------------------------------------------------

def _typed_errors():
    from ..core.errors import ConfigError, HypredrvError

    return (HypredrvError, ConfigError)


def _write(name: str, data: bytes) -> str:
    path = os.path.join(_scratch(), name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def target_parse(data: bytes):
    from ..config.parse import parse_input

    parse_input(data.decode("utf-8", errors="replace"))


def target_matrix(data: bytes):
    from ..io import ij

    ij.read_matrix_auto(_write("m.bin", data))


def target_vector(data: bytes):
    from ..io import ij

    ij.read_vector_auto(_write("v.bin", data))


def target_lsseq(data: bytes):
    from ..io import lsseq

    r = lsseq.LSSeqFile(_write("s.bin", data))
    if getattr(r, "num_systems", 0):
        r.read_matrix(0)


def target_comp(data: bytes):
    from ..io import comp

    for codec in (comp.COMP_ZLIB, comp.COMP_LZ4, comp.COMP_BLOSC):
        try:
            comp.decompress(codec, data)
        except _typed_errors():
            pass


TARGETS = {
    "parse": target_parse,
    "matrix": target_matrix,
    "vector": target_vector,
    "lsseq": target_lsseq,
    "comp": target_comp,
}


# ---------------------------------------------------------------------------
# seeds: valid artifacts produced in-process, then the saved regressions
# ---------------------------------------------------------------------------

def corpus_files(mode: str):
    """The saved regressions of ``mode``: the JAX package's corpus, then
    this package's own."""
    out = []
    for root in (JAX_CORPUS_DIR, CORPUS_DIR):
        d = os.path.join(root, mode)
        if os.path.isdir(d):
            out += [os.path.join(d, f) for f in sorted(os.listdir(d))]
    return out


def make_seeds(mode: str):
    import scipy.sparse as sp

    seeds = []
    if mode == "parse":
        seeds += [
            b"linear_system:\n  rhs_mode: ones\nsolver: pcg\n"
            b"preconditioner: amg\n",
            b"solver:\n  gmres:\n    max_iter: 20\nlinear_system:\n"
            b"  rhs_mode: ones\npreconditioner:\n  - amg\n  - ilu\n",
            b"include: sub.yml\nsolver: pcg\n",
        ]
    elif mode in ("matrix", "vector", "lsseq"):
        from ..io import ij, lsseq

        rng = np.random.default_rng(0)
        A = sp.csr_matrix(sp.random(12, 12, 0.3, random_state=rng)
                          + sp.identity(12))
        p = os.path.join(_scratch(), "seed.bin")
        if mode == "matrix":
            rows, cols = A.nonzero()
            ij.write_matrix_binary_part(
                p, rows, cols, np.asarray(A[rows, cols]).ravel(),
                A.shape, A.nnz, (0, A.shape[0] - 1))
        elif mode == "vector":
            ij.write_vector_binary_part(p, rng.standard_normal(12))
        else:
            lsseq.write_lsseq(p, [{"A": A, "b": rng.standard_normal(12)}],
                              codec=1)
        with open(p, "rb") as f:
            seeds.append(f.read())
    elif mode == "comp":
        from ..io import comp

        raw = b"payload " * 64
        seeds += [comp.compress(comp.COMP_ZLIB, raw),
                  comp.compress(comp.COMP_LZ4, raw),
                  comp.compress(comp.COMP_BLOSC, raw)]
    for path in corpus_files(mode):
        with open(path, "rb") as f:
            seeds.append(f.read())
    return seeds or [b""]


def mutate(rng: random.Random, data: bytes) -> bytes:
    buf = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        op = rng.randrange(6)
        if op == 0 and buf:                      # flip byte
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
        elif op == 1 and buf:                    # truncate
            del buf[rng.randrange(len(buf)):]
        elif op == 2:                            # insert magic
            m = rng.choice(MAGIC_BYTES)
            pos = rng.randrange(len(buf) + 1)
            buf[pos:pos] = m
        elif op == 3 and buf:                    # overwrite with random run
            pos = rng.randrange(len(buf))
            n = min(len(buf) - pos, rng.randint(1, 16))
            buf[pos:pos + n] = bytes(rng.getrandbits(8) for _ in range(n))
        elif op == 4 and len(buf) > 8:           # splice with itself
            a, b = sorted(rng.randrange(len(buf)) for _ in range(2))
            buf[a:a] = buf[b:min(len(buf), b + rng.randint(1, 64))]
        elif op == 5 and buf:                    # duplicate tail
            buf += buf[-rng.randint(1, min(64, len(buf))):]
    return bytes(buf[:1 << 16])


def minimize(target, data: bytes, exc_type) -> bytes:
    """Shrink a crashing input by binary truncation (keeps same type)."""
    best = data
    step = len(best) // 2
    while step > 0 and len(best) > 1:
        cand = best[:len(best) - step]
        try:
            target(cand)
        except _typed_errors():
            step //= 2
        except exc_type:
            best = cand
        except Exception:
            step //= 2
        else:
            step //= 2
    return best


def run_mode(mode: str, budget_s: float, rng: random.Random):
    """Fuzz one mode for ``budget_s`` seconds; returns the crash count."""
    target = TARGETS[mode]
    tracer = EdgeTracer()
    corpus = []
    seen_cov = set()
    crashes = []
    typed = _typed_errors()

    def execute(data):
        """Returns (new_edges, crash_exc)."""
        try:
            edges = tracer.run(target, data)
        except typed:
            edges = frozenset(tracer.edges)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            return frozenset(tracer.edges), e
        new = edges - seen_cov
        seen_cov.update(edges)
        return new, None

    for s in make_seeds(mode):
        new, crash = execute(s)
        if crash is not None:
            crashes.append((s, crash))
        corpus.append(s)

    t_end = time.monotonic() + budget_s
    execs = 0
    while time.monotonic() < t_end:
        parent = rng.choice(corpus)
        child = mutate(rng, parent)
        new, crash = execute(child)
        execs += 1
        if crash is not None:
            crashes.append((child, crash))
            t_end = min(t_end, time.monotonic() + 5)   # wrap up soon
        elif new:
            corpus.append(child)
            if len(corpus) > 256:
                corpus.pop(rng.randrange(1, len(corpus)))

    saved = []
    for data, exc in crashes[:8]:
        small = minimize(target, data, type(exc))
        d = os.path.join(CORPUS_DIR, mode)
        os.makedirs(d, exist_ok=True)
        name = hashlib.sha1(small).hexdigest()[:16]
        path = os.path.join(d, name)
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(small)
            saved.append((path, exc))
    print(f"[{mode}] execs={execs} corpus={len(corpus)} "
          f"edges={len(seen_cov)} crashes={len(crashes)}")
    for path, exc in saved:
        print(f"  crash saved: {path}  {type(exc).__name__}: {exc}")
    return len(crashes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the whole budget in seconds (overrides --minutes)")
    ap.add_argument("--mode", choices=sorted(TARGETS), default=None,
                    help="single mode (default: all five)")
    ap.add_argument("--seed", type=int, default=None)
    add_exec_policy(ap)
    args = ap.parse_args(argv)
    device(args.exec_policy)
    modes = [args.mode] if args.mode else sorted(TARGETS)
    rng = random.Random(args.seed)
    budget = args.seconds if args.seconds is not None else args.minutes * 60
    per = budget / len(modes)
    total_crashes = 0
    for m in modes:
        total_crashes += run_mode(m, per, rng)
    if total_crashes:
        print(f"FAIL: {total_crashes} crash(es) found")
        return 1
    print("OK: no crashes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
