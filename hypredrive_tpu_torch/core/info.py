"""System information report.

Counterpart of ``hypredrive_tpu/core/info.py``.  The reference's ``-i``
report enumerates hosts, CPUs, GPUs, bindings and loaded libraries (ref:
src/internal/info.c).  This one names the host, PyTorch and its CUDA
version, every CUDA device with its memory, the ``nvcc`` the kernels are
built with, and the directory of the built kernel library.
"""

from __future__ import annotations

import os
import platform
import socket
import subprocess
import sys


def _nvcc_version(nvcc) -> str:
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable ({exc})"
    return out.splitlines()[-1] if out else "unknown"


def system_info() -> str:
    import numpy
    import scipy
    import torch

    from ..ops import kernels
    from ..version import __version__

    bar = "=" * 84
    lines = [bar, "SYSTEM INFORMATION", bar,
             f"Host            : {socket.gethostname()}",
             f"OS              : {platform.platform()}",
             f"Python          : {sys.version.split()[0]}",
             f"numpy           : {numpy.__version__}",
             f"scipy           : {scipy.__version__}",
             f"torch           : {torch.__version__}",
             f"torch CUDA      : {torch.version.cuda or 'none (CPU build)'}"]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lines.append(f"CUDA devices    : {n}")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  [{i}] {p.name}, {p.total_memory / 2**30:.1f} GiB, "
                     f"sm_{p.major}{p.minor}, {p.multi_processor_count} SMs")
    nvcc = kernels.find_nvcc()
    lines.append(f"nvcc            : "
                 f"{_nvcc_version(nvcc) if nvcc else 'not found'}")
    built = (sorted(d for d in os.listdir(kernels.BUILD_ROOT)
                    if d.startswith("cuda-"))
             if os.path.isdir(kernels.BUILD_ROOT) else [])
    lines.append(f"kernel builds   : {kernels.BUILD_ROOT} "
                 f"({', '.join(built) if built else 'none yet'})")
    lines.append(f"hypredrive_tpu_torch: {__version__}")
    lines.append(bar)
    return "\n".join(lines)


def library_banner() -> str:
    """One-line version banner (ref: hypredrv_PrintLibInfo, info.c:4596)."""
    import torch

    from ..version import __version__

    return (f"hypredrive-tpu-torch v{__version__} (PyTorch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")
