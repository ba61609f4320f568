"""klog-analog structured logger (the port's copy of
``mpi_operator_tpu/utils/logging.py``: ``get_logger`` and ``emit_json``).

Lines look like ``I0805 14:03:22.123456 train] msg k="v"`` on stderr.
Every record carries ``trace_id`` when the process adopted a trace
context (``utils/trace.adopt_from_environ``). ``emit_json`` writes the
machine-readable lines, such as the training telemetry JSONL.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional, TextIO

from . import trace

DEBUG = 10
INFO = 20
WARNING = 30
ERROR = 40

_SEVERITY_CHAR = {DEBUG: "D", INFO: "I", WARNING: "W", ERROR: "E"}
_LEVEL = INFO
_lock = threading.Lock()  # one line per write, across threads


def emit_json(record: dict, stream: Optional[TextIO] = None) -> None:
    """Write one JSON object as a single sorted-keys line (stderr by
    default) -- the path for machine-readable line protocols such as the
    training telemetry JSONL."""
    out = sys.stderr if stream is None else stream
    line = json.dumps(record, sort_keys=True)
    with _lock:
        out.write(line + "\n")
        try:
            out.flush()
        except (ValueError, OSError):
            pass  # closed/pipeless stream: the write already landed or never will


def _format_field(value) -> str:
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


class Logger:
    """A component-bound handle onto the process-global sink."""

    __slots__ = ("component", "_fields")

    def __init__(self, component: str, fields: Optional[dict] = None):
        self.component = component
        self._fields = dict(fields or {})

    def debug(self, msg: str, *args, **fields) -> None:
        self._emit(DEBUG, msg, args, fields)

    def info(self, msg: str, *args, **fields) -> None:
        self._emit(INFO, msg, args, fields)

    def warning(self, msg: str, *args, **fields) -> None:
        self._emit(WARNING, msg, args, fields)

    def error(self, msg: str, *args, **fields) -> None:
        self._emit(ERROR, msg, args, fields)

    def _emit(self, severity: int, msg: str, args: tuple, fields: dict) -> None:
        if severity < _LEVEL:
            return
        if args:
            msg = msg % args
        merged = dict(self._fields)
        merged.update(fields)
        ctx = trace.current_context()
        if ctx is not None and "trace_id" not in merged:
            merged["trace_id"] = ctx.trace_id
        now = time.time()
        lt = time.localtime(now)
        stamp = (
            f"{_SEVERITY_CHAR[severity]}{lt.tm_mon:02d}{lt.tm_mday:02d} "
            f"{lt.tm_hour:02d}:{lt.tm_min:02d}:{lt.tm_sec:02d}"
            f".{int((now % 1) * 1e6):06d}"
        )
        parts = [f"{stamp} {self.component}] {msg}"]
        parts.extend(f"{k}={_format_field(v)}" for k, v in merged.items())
        out = sys.stderr
        with _lock:
            out.write(" ".join(parts) + "\n")
            try:
                out.flush()
            except (ValueError, OSError):
                pass


def get_logger(component: str, **fields) -> Logger:
    """The one sanctioned logger constructor: ``log = get_logger("train")``."""
    return Logger(component, fields or None)
