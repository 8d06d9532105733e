"""Error model.

The reference keeps a sticky, process-global 30-bit error bitfield plus a
message queue, with `HYPREDRV_SAFE_CALL` aborting on error
(ref: include/internal/error.h:16-80, src/internal/error.c:555-661).

The framework is Python-native, so the primary error channel is
exceptions.  For API parity we keep the same error *codes* as a bitfield
(IntFlag), attach them to the exception, and provide a sticky module-level
error state with `describe`/`clear` mirroring
HYPREDRV_ErrorCodeDescribe/Clear (ref: include/HYPREDRV.h:170-187).

The reference Allreduces error state across ranks
(ref: src/internal/error.c:802); this package runs as one process, so
`distributed_error_sync` only folds a code into the local state.
"""

from __future__ import annotations

import enum
from typing import List, Optional


class ErrorCode(enum.IntFlag):
    """Sticky error bitfield (ref: include/internal/error.h:16-49)."""

    NONE = 0x0
    GENERIC = 0x1
    MEMORY = 0x2
    IO = 0x4
    YAML = 0x8
    INVALID_ARG = 0x10
    INVALID_KEY = 0x20
    INVALID_VAL = 0x40
    MISSING_KEY = 0x80
    INVALID_SOLVER = 0x100
    INVALID_PRECON = 0x200
    UNKNOWN_OBJ = 0x400
    FILE_NOT_FOUND = 0x800
    MATRIX = 0x1000
    VECTOR = 0x2000
    SOLVER_FAILURE = 0x4000
    EXTERNAL = 0x8000
    NOT_IMPLEMENTED = 0x10000


_DESCRIPTIONS = {
    ErrorCode.GENERIC: "generic error",
    ErrorCode.MEMORY: "memory allocation error",
    ErrorCode.IO: "file input/output error",
    ErrorCode.YAML: "YAML parsing error",
    ErrorCode.INVALID_ARG: "invalid argument",
    ErrorCode.INVALID_KEY: "invalid configuration key",
    ErrorCode.INVALID_VAL: "invalid configuration value",
    ErrorCode.MISSING_KEY: "missing required configuration key",
    ErrorCode.INVALID_SOLVER: "invalid solver",
    ErrorCode.INVALID_PRECON: "invalid preconditioner",
    ErrorCode.UNKNOWN_OBJ: "unknown object handle",
    ErrorCode.FILE_NOT_FOUND: "file not found",
    ErrorCode.MATRIX: "matrix error",
    ErrorCode.VECTOR: "vector error",
    ErrorCode.SOLVER_FAILURE: "linear solver did not converge",
    ErrorCode.EXTERNAL: "external library error",
    ErrorCode.NOT_IMPLEMENTED: "feature not implemented",
}


def error_code_describe(code: int) -> str:
    """Human-readable description of an error bitfield.

    Mirrors HYPREDRV_ErrorCodeDescribe (ref: include/HYPREDRV.h:170).
    """
    code = ErrorCode(code)
    if code == ErrorCode.NONE:
        return "no error"
    parts = [desc for bit, desc in _DESCRIPTIONS.items() if code & bit]
    return "; ".join(parts) if parts else f"unknown error code 0x{int(code):x}"


class HypredrvError(Exception):
    """Base exception carrying an ErrorCode bitfield."""

    def __init__(self, message: str, code: ErrorCode = ErrorCode.GENERIC):
        super().__init__(message)
        self.code = code
        _global_state.record(code, message)


class ConfigError(HypredrvError):
    """Configuration (YAML/schema) error; collects multiple messages."""

    def __init__(self, messages, code: ErrorCode = ErrorCode.YAML):
        if isinstance(messages, str):
            messages = [messages]
        self.messages = list(messages)
        super().__init__("\n".join(self.messages), code)


class SolverFailure(HypredrvError):
    """Raised (optionally) when a solve does not converge.

    The reference treats divergence as a *soft* error: it is recorded and
    consumed so the run continues (ref: src/internal/utils.c:20-34).  The
    framework mirrors that: solvers record failure in their result and only
    raise when the caller asks for strict mode.
    """

    def __init__(self, message: str):
        super().__init__(message, ErrorCode.SOLVER_FAILURE)


class _ErrorState:
    """Sticky process-global error state (ref: src/internal/error.c)."""

    def __init__(self):
        self.code = ErrorCode.NONE
        self.messages: List[str] = []
        self._counts = {}

    def record(self, code: ErrorCode, message: str):
        self.code |= code
        # Dedup with counts like the reference message queue
        # (ref: src/internal/error.c message chain).
        if message in self._counts:
            self._counts[message] += 1
        else:
            self._counts[message] = 1
            self.messages.append(message)

    def clear(self):
        self.code = ErrorCode.NONE
        self.messages.clear()
        self._counts.clear()

    def describe(self) -> str:
        lines = [error_code_describe(self.code)]
        for msg in self.messages:
            n = self._counts.get(msg, 1)
            suffix = f" (x{n})" if n > 1 else ""
            lines.append(f"  - {msg}{suffix}")
        return "\n".join(lines)


_global_state = _ErrorState()


def error_code_get() -> ErrorCode:
    return _global_state.code


def error_code_clear():
    """Mirror of HYPREDRV_ErrorCodeClear (ref: include/HYPREDRV.h:187)."""
    _global_state.clear()


def error_state_describe() -> str:
    return _global_state.describe()


def distributed_error_sync(code: Optional[int] = None) -> ErrorCode:
    """Fold ``code`` into the sticky state and return it.

    Mirrors hypredrv_DistributedErrorStateSync (ref: src/internal/error.c:802)
    for the single process this package runs in (rank 0).
    """
    local = int(_global_state.code if code is None else code)
    _global_state.code |= ErrorCode(local)
    return ErrorCode(local)
