"""Lightweight span tracer: context-manager spans into a JSONL ring buffer.

The operator's answer to "where did that reconcile spend its time" without
an OpenTelemetry dependency: every instrumented section opens a span
(``with trace.span("reconcile", key=key):``), child spans started on the
same thread inherit the parent/trace ids, and completed spans land in a
bounded ring buffer that the monitoring server serves verbatim at
``/debug/trace`` (one JSON object per line, newest last).

Design points:

- **Thread-local span stack** — parentage needs no plumbing through call
  signatures, so builders/bootstrap/barrier code just opens spans.
- **Ring buffer** — ``maxlen`` bounds memory; a hot controller keeps the
  most recent few thousand spans, which is exactly the window a human
  debugging a live incident wants.
- **Spans record on exit** — an abandoned span (crashed thread) never
  corrupts the buffer; errors are captured on the span before re-raise.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, Optional

DEFAULT_CAPACITY = 2048


class TraceContext:
    """Serializable (trace id, parent span id) pair — the W3C traceparent
    analog that crosses process boundaries in ``TPU_TRACE_CONTEXT``.

    The controller encodes the context of its open builder span into pod
    env; launcher/train parse it back and :func:`adopt_context` it, after
    which every *root* span the process opens inherits the trace id and
    parents under the stamping span.  Span ids stay process-local (they
    are per-tracer counters); the trace id is the cross-process join key.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def encode(self) -> str:
        return f"{self.trace_id}-{self.span_id}"

    def __repr__(self) -> str:
        return f"TraceContext({self.encode()!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and other.trace_id == self.trace_id
            and other.span_id == self.span_id
        )

    @classmethod
    def parse(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Decode ``"<trace_id>-<span_id>"``; None on anything malformed
        (propagation is best-effort — a garbled env var must never break
        worker startup)."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return cls(parts[0], parts[1])

    @classmethod
    def from_environ(cls, environ=None) -> Optional["TraceContext"]:
        """Read the propagation env var (``constants.ENV_TRACE_CONTEXT``)."""
        import os

        from ..api.v2beta1 import constants

        env = os.environ if environ is None else environ
        return cls.parse(env.get(constants.ENV_TRACE_CONTEXT))


# Process-level inherited context (set once on startup from the pod env).
# Root spans opened while this is set parent under the stamping process's
# span instead of starting a fresh trace.
_propagated: Optional[TraceContext] = None


def adopt_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the process-level inherited trace context and
    return the previous one (so tests can restore; pass None to clear)."""
    global _propagated
    prev = _propagated
    _propagated = ctx
    return prev


def adopt_from_environ(environ=None) -> Optional[TraceContext]:
    """Adopt the trace context from the environment if one is present —
    the launcher/train startup hook.  Returns the adopted context."""
    ctx = TraceContext.from_environ(environ)
    if ctx is not None:
        adopt_context(ctx)
    return ctx


def propagated_context() -> Optional[TraceContext]:
    return _propagated


class Span:
    """One timed section. Mutable while open: ``span.annotate(k=v)`` adds
    attributes mid-flight (e.g. how many workers a reconcile created)."""

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "start", "end",
        "attrs", "error",
    )

    def __init__(
        self,
        name: str,
        span_id: str,
        parent_id: Optional[str],
        trace_id: str,
        start: float,
        attrs: dict,
    ):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs
        self.error: Optional[str] = None

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def duration_ms(self) -> Optional[float]:
        if self.end is None:
            return None
        return (self.end - self.start) * 1000.0

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start": round(self.start, 6),
            "duration_ms": (
                round(self.duration_ms, 3) if self.end is not None else None
            ),
        }
        if self.attrs:
            # Attributes stay JSON-safe: repr anything exotic.
            out["attrs"] = {
                k: v if isinstance(v, (str, int, float, bool, type(None)))
                else repr(v)
                for k, v in self.attrs.items()
            }
        if self.error is not None:
            out["error"] = self.error
        return out


class Tracer:
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock=time.time,
    ):
        self._buf: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._clock = clock

    def _next_id(self) -> str:
        return f"{next(self._ids):08x}"

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = self._next_id()
        if parent is not None:
            parent_id, trace_id = parent.span_id, parent.trace_id
        elif _propagated is not None:
            # Root span in a process that adopted a cross-process context:
            # continue the inherited trace instead of starting a new one.
            parent_id, trace_id = _propagated.span_id, _propagated.trace_id
        else:
            parent_id, trace_id = None, sid
        sp = Span(name, sid, parent_id, trace_id, self._clock(), attrs)
        stack.append(sp)
        # While this span is open, module-level trace.span() calls on this
        # thread record into THIS tracer — library code (builders,
        # launcher) nests under whichever tracer its caller opened,
        # without threading a tracer through every signature.
        prev_active = getattr(_active, "tracer", None)
        _active.tracer = self
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _active.tracer = prev_active
            sp.end = self._clock()
            # Pop by identity: a mismatched pop (exotic generator abuse)
            # must not unwind someone else's span.
            if stack and stack[-1] is sp:
                stack.pop()
            elif sp in stack:
                stack.remove(sp)
            with self._lock:
                self._buf.append(sp.to_dict())

    def spans(self) -> list[dict]:
        """Completed spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(s, sort_keys=True) for s in self.spans())

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


DEFAULT_TRACER = Tracer()

# The innermost tracer with an open span on this thread (see Tracer.span).
_active = threading.local()


def current_tracer() -> Tracer:
    """The tracer library code should record into: the one whose span is
    open on this thread, else the process default."""
    # Explicit None check: Tracer defines __len__, so an empty tracer is
    # falsy and ``tracer or DEFAULT_TRACER`` would wrongly discard it.
    tracer = getattr(_active, "tracer", None)
    return DEFAULT_TRACER if tracer is None else tracer


def span(name: str, **attrs):
    """Open a span on the active tracer (nests under the caller's open
    span when there is one; the process-default tracer otherwise)."""
    return current_tracer().span(name, **attrs)


def current_context() -> Optional[TraceContext]:
    """The context to propagate (or log) right now: the innermost open
    span on this thread, else the process-level adopted context, else
    None.  Builders call this to stamp pod env; the structured logger
    calls it to attach ``trace_id`` to every record."""
    sp = current_tracer().current()
    if sp is not None:
        return TraceContext(sp.trace_id, sp.span_id)
    return _propagated
