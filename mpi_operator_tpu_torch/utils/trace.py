"""Cross-process trace context (the part of
``mpi_operator_tpu/utils/trace.py`` that a worker needs on startup).

The controller stamps the reconcile's (trace id, span id) into the pod
env as ``TPU_TRACE_CONTEXT``; the trainer adopts it on startup so its
log records carry the operator's trace id.
"""

from __future__ import annotations

import os
from typing import Optional

from ..api.v2beta1 import constants


class TraceContext:
    """Serializable (trace id, parent span id) pair."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def parse(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Decode ``"<trace_id>-<span_id>"``; None on anything malformed
        (propagation is best-effort -- a garbled env var must never break
        worker startup)."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split("-")
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return cls(parts[0], parts[1])

    @classmethod
    def from_environ(cls, environ=None) -> Optional["TraceContext"]:
        env = os.environ if environ is None else environ
        return cls.parse(env.get(constants.ENV_TRACE_CONTEXT))


# Process-level inherited context (set once on startup from the pod env).
_propagated: Optional[TraceContext] = None


def adopt_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the process-level trace context and return the
    previous one (so tests can restore; pass None to clear)."""
    global _propagated
    prev = _propagated
    _propagated = ctx
    return prev


def adopt_from_environ(environ=None) -> Optional[TraceContext]:
    """Adopt the trace context from the environment if one is present --
    the launcher/train startup hook. Returns the adopted context."""
    ctx = TraceContext.from_environ(environ)
    if ctx is not None:
        adopt_context(ctx)
    return ctx


def current_context() -> Optional[TraceContext]:
    """The context to log right now: the adopted one, else None (the
    port opens no spans of its own yet)."""
    return _propagated
