"""Structured engine logging with per-query tracing context.

Counterpart of ``tiflash_tpu/runtime/logging.py``.  Loggers live under
``tiflash_tpu_torch``; the console level and ring size read the
reference's variables (``TIFLASH_TPU_LOG``,
``TIFLASH_TPU_LOG_RING_CAPACITY``), so one deployment steers both alike.

Role analog: the Poco logger stack + per-MPP-task tracing logger
(``Flash/Mpp/getMPPTaskTracingLog.h``) — here a stdlib logging wrapper
whose records carry the active query id from a contextvar, so service
logs interleave cleanly under concurrency.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os

_query_id: contextvars.ContextVar = contextvars.ContextVar("tfl_torch_query_id",
                                                          default=None)


class _QueryIdFilter(logging.Filter):
    def filter(self, record):
        qid = _query_id.get()
        record.query = f"q{qid}" if qid is not None else "-"
        return True


class RingLogHandler(logging.Handler):
    """In-memory ring of recent records, searchable via the service's
    /logs endpoint (the ``Flash/LogSearch.cpp`` analog: TiDB's dashboard
    greps server logs; here the ring IS the searchable store)."""

    def __init__(self, capacity: int = 4096):
        super().__init__()
        from collections import deque

        self.records = deque(maxlen=capacity)

    def emit(self, record):
        try:
            self.records.append({
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "query": getattr(record, "query", "-"),
                "message": record.getMessage(),
            })
        except Exception:  # never let logging break the engine
            pass

    def search(self, pattern: str = "", level: str = "",
               limit: int = 200) -> list:
        import re as _re

        rx = _re.compile(pattern) if pattern else None
        lv = level.upper()
        out = []
        for r in reversed(self.records):
            if lv and r["level"] != lv:
                continue
            if rx and not rx.search(r["message"]):
                continue
            out.append(r)
            if len(out) >= limit:
                break
        return out


RING = RingLogHandler(
    capacity=int(__import__("os").environ.get("TIFLASH_TPU_LOG_RING_CAPACITY",
                                              4096))
)
_configured = False


def get_logger(name: str = "tiflash_tpu_torch") -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        root = logging.getLogger("tiflash_tpu_torch")
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] [%(query)s] %(name)s: %(message)s"
        ))
        handler.addFilter(_QueryIdFilter())
        level = os.environ.get("TIFLASH_TPU_LOG", "WARNING").upper()
        lv = getattr(logging, level, logging.WARNING)
        handler.setLevel(lv)  # console obeys TIFLASH_TPU_LOG
        root.addHandler(handler)
        RING.addFilter(_QueryIdFilter())
        RING.setLevel(logging.INFO)
        root.addHandler(RING)
        # the ring captures INFO+ regardless of console verbosity so
        # /logs can answer after the fact (LogSearch greps server logs)
        root.setLevel(min(lv, logging.INFO))
        root.propagate = False
        _configured = True
    return logger


@contextlib.contextmanager
def query_context(qid):
    token = _query_id.set(qid)
    try:
        yield
    finally:
        _query_id.reset(token)


__all__ = ["get_logger", "query_context", "RING", "RingLogHandler"]
