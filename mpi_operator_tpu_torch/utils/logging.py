"""klog-analog structured logger (no external dependency; the port's copy
of ``mpi_operator_tpu/utils/logging.py``, except that the default sink is
``sys.stderr`` as it is at each write, not at import).

Reference analog: the klog.Infof/klog.Errorf call sites threaded through
/root/reference/v2/pkg/controller/mpi_job_controller.go (e.g. :262-267,
:475, :1565) plus klog's severity-prefixed line format.  Like klog, this
is a process-global sink configured once from flags (``--log-level`` /
``--log-format`` on cmd/operator.py) and consumed through cheap per-
component logger handles.

Two output formats:

- ``text`` — klog-style single line, severity char + timestamp +
  component: ``I0805 14:03:22.123456 controller] synced job key="a/b"``;
- ``json`` — one JSON object per line (``ts``, ``level``, ``component``,
  ``msg``, plus structured fields), the machine-scrapeable form.

Every record automatically carries ``trace_id`` when a span is open on
the calling thread (or the process adopted a cross-process context, see
utils/trace.TraceContext) — the join key between logs and
``/debug/trace``.

:func:`emit_json` is the raw line emitter underneath the JSON format,
exported for call sites whose *output itself* is the product (training
telemetry JSONL, healthcheck result on stdout): they keep their exact
stream contract while sharing the single-line, single-write discipline.
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

_LEVELS = {"debug": DEBUG, "info": INFO, "warning": WARNING, "error": ERROR}
_SEVERITY_NAME = {DEBUG: "debug", INFO: "info", WARNING: "warning", ERROR: "error"}
_SEVERITY_CHAR = {DEBUG: "D", INFO: "I", WARNING: "W", ERROR: "E"}

FORMAT_TEXT = "text"
FORMAT_JSON = "json"


class _Config:
    def __init__(self):
        self.level = INFO
        self.format = FORMAT_TEXT
        # None: sys.stderr as it is at each write (so a test's capture
        # of stderr sees the records).
        self.stream: Optional[TextIO] = None
        self.clock = time.time
        self.lock = threading.Lock()


_config = _Config()


def parse_level(level) -> int:
    if isinstance(level, int):
        return level
    try:
        return _LEVELS[str(level).lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {level!r} (want one of {sorted(_LEVELS)})"
        ) from None


def configure(
    level=None,
    format: Optional[str] = None,
    stream: Optional[TextIO] = None,
    clock=None,
) -> dict:
    """Set the process-global sink; only passed settings change.  Returns
    the previous values of the settings that changed, as kwargs suitable
    for a restoring ``configure(**prev)`` (test hygiene)."""
    prev: dict = {}
    if level is not None:
        prev["level"] = _config.level
        _config.level = parse_level(level)
    if format is not None:
        if format not in (FORMAT_TEXT, FORMAT_JSON):
            raise ValueError(f"unknown log format {format!r}")
        prev["format"] = _config.format
        _config.format = format
    if stream is not None:
        prev["stream"] = _config.stream
        _config.stream = stream
    if clock is not None:
        prev["clock"] = _config.clock
        _config.clock = clock
    return prev


def emit_json(record: dict, stream: Optional[TextIO] = None) -> None:
    """Write one JSON object as a single sorted-keys line (atomic under
    the sink lock).  The emitter behind the ``json`` format, and the
    sanctioned path for machine-readable line protocols (telemetry JSONL,
    healthcheck stdout result)."""
    out = stream or _config.stream or sys.stderr
    line = json.dumps(record, sort_keys=True)
    with _config.lock:
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
    """A component-bound handle onto the process-global sink.  Immutable;
    ``with_fields`` returns a child carrying extra structured fields
    (job namespace/name, typically) on every record."""

    __slots__ = ("component", "_fields")

    def __init__(self, component: str, fields: Optional[dict] = None):
        self.component = component
        self._fields = dict(fields or {})

    def with_fields(self, **fields) -> "Logger":
        merged = dict(self._fields)
        merged.update(fields)
        return Logger(self.component, merged)

    def for_job(self, namespace: str, name: str) -> "Logger":
        """The klog job-identity convention: every record about a job
        carries its namespace/name as structured fields."""
        return self.with_fields(namespace=namespace, tpujob=name)

    def enabled_for(self, level) -> bool:
        return parse_level(level) >= _config.level

    # -- severity methods (printf-style, klog.Infof analog) --------------

    def debug(self, msg: str, *args, **fields) -> None:
        self._emit(DEBUG, msg, args, fields)

    def info(self, msg: str, *args, **fields) -> None:
        self._emit(INFO, msg, args, fields)

    def warning(self, msg: str, *args, **fields) -> None:
        self._emit(WARNING, msg, args, fields)

    def error(self, msg: str, *args, **fields) -> None:
        self._emit(ERROR, msg, args, fields)

    def _emit(self, severity: int, msg: str, args: tuple, fields: dict) -> None:
        cfg = _config
        if severity < cfg.level:
            return
        if args:
            msg = msg % args
        merged = dict(self._fields)
        merged.update(fields)
        ctx = trace.current_context()
        if ctx is not None and "trace_id" not in merged:
            merged["trace_id"] = ctx.trace_id
        now = cfg.clock()
        if cfg.format == FORMAT_JSON:
            record = {
                "ts": round(now, 6),
                "level": _SEVERITY_NAME[severity],
                "component": self.component,
                "msg": msg,
            }
            for k, v in merged.items():
                record.setdefault(k, v)
            emit_json(record, stream=cfg.stream)
            return
        # klog-style text: I0805 14:03:22.123456 component] msg k="v"
        lt = time.localtime(now)
        stamp = (
            f"{_SEVERITY_CHAR[severity]}{lt.tm_mon:02d}{lt.tm_mday:02d} "
            f"{lt.tm_hour:02d}:{lt.tm_min:02d}:{lt.tm_sec:02d}"
            f".{int((now % 1) * 1e6):06d}"
        )
        parts = [f"{stamp} {self.component}] {msg}"]
        parts.extend(f"{k}={_format_field(v)}" for k, v in merged.items())
        line = " ".join(parts)
        out = cfg.stream or sys.stderr
        with cfg.lock:
            out.write(line + "\n")
            try:
                out.flush()
            except (ValueError, OSError):
                pass


def get_logger(component: str, **fields) -> Logger:
    """The one sanctioned logger constructor (enforced by
    tests/test_lint.py): ``log = get_logger("controller")``."""
    return Logger(component, fields or None)
