"""hypredrive_tpu_torch — the PyTorch + CUDA port of hypredrive_tpu.

YAML-configured PCG preconditioned by a BoomerAMG-equivalent AMG, for one
NVIDIA Hopper card (H100).  The layout mirrors ``hypredrive_tpu`` module for
module.  The AMG setup runs on the host in numpy/scipy (the same code as
the JAX package); the solve runs in eager PyTorch on the device, and every
sparse matvec there is a hand-written CUDA kernel (``csrc/``).

``general.exec_policy: host`` runs everything on the CPU with the kernels'
plain torch versions; the default ``device`` needs CUDA.  This package
imports ``torch`` and never ``jax``.
"""

from .version import __version__

from .core.errors import (
    ConfigError,
    ErrorCode,
    HypredrvError,
    error_code_describe,
)
from .core.stats import Stats
from .config import InputArgs, config_from_dict, parse_input
from .api import HypreDrive, solve

__all__ = [
    "__version__",
    "ErrorCode",
    "HypredrvError",
    "ConfigError",
    "error_code_describe",
    "Stats",
    "InputArgs",
    "parse_input",
    "config_from_dict",
    "HypreDrive",
    "solve",
]
