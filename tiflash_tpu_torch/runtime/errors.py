"""Error-code registry and the runtime error channel.

Counterpart of ``tiflash_tpu/runtime/errors.py``.  Codes are stable
integers (append only); ``EngineError`` carries one.  ``EvalError`` is
the sentinel a host LUT function returns for a per-row runtime error;
the fragment compiler reduces such rows to scalar flags under
``RTERR_PREFIX`` beside the capacity-overflow flags, and the host raises
after execution.  The producers of per-row errors are the string and
JSON tables of ``expr/``; the drain is ``plan/compiler.py``'s and the
raise ``runtime/executor.py``'s.  ``classify`` maps any exception to a
code and ``error_payload`` makes the JSON error body.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# stable numeric registry (never renumber; append only)
OK = 0
UNKNOWN = 1
BAD_PLAN = 10            # malformed / unsupported plan json
UNKNOWN_TABLE = 11
UNKNOWN_COLUMN = 12
TYPE_MISMATCH = 13
UNSUPPORTED = 14         # feature combination not implemented
CAPACITY_OVERFLOW = 20   # bounded-output overflow after max retries
MEMORY_LIMIT = 21
CANCELLED = 30
FAILPOINT = 40
RESOURCE_EXHAUSTED = 41  # RU admission rejected
LIMIT_EXCEEDED = 42      # max_rows_to_* / max_result_rows breached
RUNTIME_EVAL = 43        # per-row evaluation error (invalid JSON, ...)
INTERNAL = 50

_NAMES: Dict[int, str] = {
    OK: "OK",
    UNKNOWN: "UNKNOWN",
    BAD_PLAN: "BAD_PLAN",
    UNKNOWN_TABLE: "UNKNOWN_TABLE",
    UNKNOWN_COLUMN: "UNKNOWN_COLUMN",
    TYPE_MISMATCH: "TYPE_MISMATCH",
    UNSUPPORTED: "UNSUPPORTED",
    CAPACITY_OVERFLOW: "CAPACITY_OVERFLOW",
    MEMORY_LIMIT: "MEMORY_LIMIT",
    CANCELLED: "CANCELLED",
    FAILPOINT: "FAILPOINT",
    RESOURCE_EXHAUSTED: "RESOURCE_EXHAUSTED",
    LIMIT_EXCEEDED: "LIMIT_EXCEEDED",
    RUNTIME_EVAL: "RUNTIME_EVAL",
    INTERNAL: "INTERNAL",
}


def error_name(code: int) -> str:
    return _NAMES.get(code, f"CODE_{code}")


class EngineError(RuntimeError):
    """Base for typed engine errors; carries a stable code."""

    code: int = UNKNOWN

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class EvalError:
    """Sentinel a host LUT function returns for a per-row runtime error
    (the reference engine throws mid-column).  Nothing throws inside a
    device program, so rows holding it become a boolean error lane that
    the host turns into ``EngineError`` after execution."""

    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


# reserved key prefix carrying runtime-error flags through the
# (block, overflows) fragment return contract
RTERR_PREFIX = "__rterr__"


def split_runtime_errors(flags: Dict) -> tuple:
    """Split a fragment's flag dict into (capacity_overflows,
    {message: scalar_flag}): the latter is the runtime error channel."""
    cap = {k: v for k, v in flags.items() if not k.startswith(RTERR_PREFIX)}
    err = {k[len(RTERR_PREFIX):]: v for k, v in flags.items()
           if k.startswith(RTERR_PREFIX)}
    return cap, err


def raise_runtime_errors(err_flags: Dict) -> None:
    """Raise EngineError for any set runtime-error flag (host side, after
    execution: the analog of the reference engine's per-row throw)."""
    for msg, v in err_flags.items():
        if bool(torch.as_tensor(v).max()):
            raise EngineError(msg, RUNTIME_EVAL)


def classify(exc: BaseException) -> int:
    """Map any exception to a registry code (the gRPC-status analog)."""
    from .cancel import QueryCancelled
    from .failpoint import FailPointError
    from .memory import MemoryLimitError

    if isinstance(exc, EngineError):
        return exc.code
    if isinstance(exc, QueryCancelled):
        return CANCELLED
    if isinstance(exc, MemoryLimitError):
        return MEMORY_LIMIT
    if isinstance(exc, FailPointError):
        return FAILPOINT
    if isinstance(exc, KeyError):
        return UNKNOWN_COLUMN
    if isinstance(exc, NotImplementedError):
        return UNSUPPORTED
    if isinstance(exc, (TypeError, ValueError)):
        return BAD_PLAN
    msg = str(exc)
    if "capacity" in msg and "overflow" in msg:
        return CAPACITY_OVERFLOW
    if "resource group" in msg:
        return RESOURCE_EXHAUSTED
    return INTERNAL


def error_payload(exc: BaseException) -> Dict:
    """JSON error body: message + stable code + name."""
    code = classify(exc)
    from .metrics import METRICS

    METRICS.counter(f"errors_total_code_{code}").inc()
    return {
        "error": f"{type(exc).__name__}: {exc}",
        "code": code,
        "code_name": error_name(code),
    }


__all__ = ["EngineError", "EvalError", "classify", "error_payload",
           "error_name", "split_runtime_errors", "raise_runtime_errors",
           "RTERR_PREFIX"]
