"""Env-driven diagnostic logging.

Mirrors the reference logger (ref: src/internal/logging.c): levels 0-4 from
``HYPREDRV_LOG_LEVEL``, rank-0-only emission, ``[level][object][ls_id]``
prefixes, and text-block dumps.  Level semantics follow the reference docs:
1 = operation begin/end, 2 = decisions, 3+ = data sources/contexts.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

_LEVEL_NAMES = {0: "off", 1: "ops", 2: "decisions", 3: "data", 4: "trace"}


def _parse_level(value: Optional[str]) -> int:
    if not value:
        return 0
    value = value.strip().lower()
    for lvl, name in _LEVEL_NAMES.items():
        if value == name:
            return lvl
    try:
        return max(0, min(4, int(value)))
    except ValueError:
        return 0


class Logger:
    def __init__(self):
        self.level = _parse_level(os.environ.get("HYPREDRV_LOG_LEVEL"))
        stream_name = os.environ.get("HYPREDRV_LOG_STREAM", "stderr")
        self.stream = sys.stdout if stream_name == "stdout" else sys.stderr
        self.rank = 0  # one process: rank 0 always emits

    def enabled(self, level: int) -> bool:
        return self.level >= level and self.rank == 0

    def log(self, level: int, msg: str, *, obj: str = "", ls_id: Optional[int] = None):
        if not self.enabled(level):
            return
        prefix = f"[{level}]"
        if obj:
            prefix += f"[{obj}]"
        if ls_id is not None:
            prefix += f"[ls:{ls_id}]"
        print(f"{prefix} {msg}", file=self.stream, flush=True)

    def warn(self, msg: str, *, obj: str = ""):
        """Always-visible (level-independent) rank-0 warning — used when a
        config falls outside a supported subset and behavior degrades."""
        if self.rank != 0:
            return
        prefix = "[warn]" + (f"[{obj}]" if obj else "")
        print(f"{prefix} {msg}", file=self.stream, flush=True)

    def text_block(self, level: int, title: str, text: str):
        """Multi-line dump, mirroring HYPREDRV_LOG_TEXTBLOCK
        (ref: src/internal/logging.h:72-113)."""
        if not self.enabled(level):
            return
        bar = "-" * 68
        print(f"{bar}\n{title}\n{bar}\n{text}\n{bar}", file=self.stream, flush=True)


logger = Logger()


def log(level: int, msg: str, **kw):
    logger.log(level, msg, **kw)
