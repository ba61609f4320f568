"""Attention dispatch for model code (port of the dispatch half of
``mpi_operator_tpu/ops/ring_attention.py``).

One device, no sequence parallelism: ``flash`` runs the projection-layout
kernels; ``flash-bhsd`` (the layout A/B) and ``dense`` (the plain oracle)
run on the [B, H, S, D] path, through the [B*H, S, D] kernels and the
plain attention respectively. The sequence-parallel and pipeline-shard
implementations are later slices of the port; asking for one raises
``NotImplementedError`` naming its ROADMAP.md item instead of quietly
training something else.
"""

from __future__ import annotations

import torch

from .attention import (attention_reference, flash_attention,
                        flash_attention_bshd)

# impl -> the ROADMAP.md port-queue item that brings it.
_LATER = {
    "ring": "queue (a) item 15: ring attention over torch.distributed",
    "ulysses": "queue (a) item 15: Ulysses all-to-all attention",
    "ring-shard": "queue (a) item 16: pipeline-shard attention",
    "ulysses-shard": "queue (a) item 16: pipeline-shard attention",
}


def _not_ported(impl: str):
    return NotImplementedError(
        f"attention_impl={impl!r} is not ported yet (ROADMAP.md {_LATER[impl]})"
    )


def sp_attention_bshd(q, k, v, impl: str, *, causal: bool):
    """Projection-layout dispatch on the raw [B, S, H, D] projections.

    'flash' runs the flat kernel. Returns ``None`` for the impls that
    live on the [B, H, S, D] path ('flash-bhsd', 'dense'): the caller then
    transposes and falls through to :func:`sp_attention`, which raises on
    unknown names."""
    if impl == "flash":
        return flash_attention_bshd(q, k, v, causal=causal)
    if impl in _LATER:
        raise _not_ported(impl)
    return None


def sp_attention(q, k, v, impl: str, *, causal: bool):
    """The [B, H, S, D] dispatch: 'flash'/'flash-bhsd' (the [B*H, S, D]
    kernels through :func:`flash_attention`; model code routes 'flash' to
    the projection-layout kernels before transposing, 'flash-bhsd' is the
    layout A/B), 'dense' (the plain oracle; GQA kv heads are expanded here
    since the reference has no grouped path). Unknown names raise: a typo
    must not silently train the dense path."""
    if impl in ("flash", "flash-bhsd"):
        return flash_attention(q, k, v, causal=causal)
    if impl == "dense":
        groups = q.shape[1] // k.shape[1]
        if groups > 1:
            k = torch.repeat_interleave(k, groups, dim=1)
            v = torch.repeat_interleave(v, groups, dim=1)
        return attention_reference(q, k, v, causal=causal)
    if impl in _LATER:
        raise _not_ported(impl)
    raise ValueError(
        f"unknown attention impl {impl!r}; want "
        f"flash|flash-bhsd|dense|ring|ulysses"
    )
