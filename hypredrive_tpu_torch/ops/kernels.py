"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface.  On first use ``nvcc`` compiles
every ``csrc/*.cu`` for Hopper (``sm_90a``), one process per source, all
started together, and links them into one shared library under
``build/hypredrive_tpu_torch/cuda-<hash>/``, keyed by a hash of the
sources and flags; ``ctypes`` loads it.  Nothing here runs at import
time: a machine without ``nvcc`` or a card can import every module.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from ..core.errors import ErrorCode, HypredrvError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "hypredrive_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> Optional[str]:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    return None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def build() -> str:
    """Compile the kernels if the build dir lacks them; the library path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, "cuda-" + h.hexdigest()[:16])
    so = os.path.join(out_dir, "libhdtt_kernels.so")
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    if nvcc is None:
        raise HypredrvError("nvcc not found: cannot build the CUDA kernels",
                            ErrorCode.EXTERNAL)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for obj, src in zip(objs, srcs)]
    errs = [p.communicate(timeout=900)[1] for p in procs]
    failed = [(p.args, p.returncode, err) for p, err in zip(procs, errs)
              if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=900)
        if link.returncode != 0:
            failed.append((link.args, link.returncode, link.stderr))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        args, rc, err = failed[0]
        raise HypredrvError(f"nvcc failed ({rc}): {' '.join(args)}\n"
                            f"{err[-4000:]}", ErrorCode.EXTERNAL)
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            for suffix in ("f32", "f64"):
                fn = getattr(cdll, f"hdtt_dia_spmv_{suffix}")
                fn.restype = ctypes.c_int
                fn.argtypes = [vp, vp, i32, vp, vp, i64, i64, vp]
                fn = getattr(cdll, f"hdtt_csr_spmv_{suffix}")
                fn.restype = ctypes.c_int
                fn.argtypes = [vp, vp, vp, vp, vp, i64, vp, i64, i32, vp]
            _lib = cdll
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        raise HypredrvError(f"{name}: CUDA error {rc}", ErrorCode.EXTERNAL)
