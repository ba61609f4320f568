"""Ulysses attention: all-to-all sequence parallelism (port of
``mpi_operator_tpu/ops/ulysses.py``).

The second of the two long-context strategies (the first is the ring,
``ops/ring_attention.py``). Activations arrive sequence-sharded over the
sp process group; an all-to-all re-shards them by head (each rank gets
H/n heads over the whole sequence), each rank runs one ordinary flash
call over its heads, and a second all-to-all restores the sequence
sharding. Two collectives a call, each moving 1/n of the activations
(``parallel.sharding.all_to_all``, whose gradient is the reverse
all-to-all).

Against the ring: one flash call a rank, no per-hop launches, no lse
merges and the standard aligned causal mask, so no zigzag layout. But
``n`` must divide H (GQA kv heads are repeated up to ``lcm(Hkv, n)``
before the exchange, in JAX's head order), and every rank holds a
full-length row of its heads during the call; the ring's O(S/n)
residency is what scales further.
"""

from __future__ import annotations

import math
from typing import Optional

from ..parallel.sharding import all_to_all
from .attention import attention_reference, flash_attention, flash_attention_bshd


def _replicate_kv_for(h_kv: int, n: int) -> int:
    """Smallest per-head repeat factor r such that n divides h_kv * r."""
    return n // math.gcd(h_kv, n)


def _check(h: int, h_kv: int, n: int) -> int:
    """The kv repeat factor, after JAX's head checks."""
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if h % n:
        raise ValueError(
            f"ulysses needs the sp size ({n}) to divide the query head "
            f"count ({h}); use ring attention for sp > heads"
        )
    return _replicate_kv_for(h_kv, n) if h_kv % n else 1


def ulysses_attention(q, k, v, group, *, causal: bool = False,
                      sm_scale: Optional[float] = None, impl: str = "flash"):
    """Ulysses attention on this rank's shards over the process ``group``:
    q [B, H, S_local, D]; k, v [B, Hkv, S_local, D], sequence-sharded
    contiguously (rank i holds rows [i*S_local, (i+1)*S_local)). Returns
    this rank's output shard, like q. ``impl='dense'`` runs the plain
    oracle between the all-to-alls instead of the [B*H, S, D] kernels."""
    import torch
    import torch.distributed as dist

    if impl not in ("flash", "dense"):
        raise ValueError(f"impl must be 'flash' or 'dense', got {impl!r}")
    n = dist.get_world_size(group)
    rep = _check(q.shape[1], k.shape[1], n)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if n > 1:
        # [B, H, S/n, D] -> [B, H/n, S, D]: rank j's rows land at offset
        # j * S_local, the contiguous sequence order.
        q, k, v = (all_to_all(x, group, 1, 2) for x in (q, k, v))
    if impl == "flash":
        out = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    else:
        groups = q.shape[1] // k.shape[1]
        if groups > 1:
            k = torch.repeat_interleave(k, groups, dim=1)
            v = torch.repeat_interleave(v, groups, dim=1)
        out = attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return all_to_all(out, group, 2, 1) if n > 1 else out


def ulysses_attention_bshd(q, k, v, group, *, causal: bool = False,
                           sm_scale: Optional[float] = None):
    """Ulysses attention over the PROJECTION layout, the sequence-parallel
    twin of ``attention.flash_attention_bshd``: q [B, S_local, H, D];
    k, v [B, S_local, Hkv, D], sequence-sharded contiguously over
    ``group``. The all-to-alls re-shard [B, S/n, H, D] -> [B, S, H/n, D]
    and back around one flat kernel call: no transposes on the path."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    rep = _check(q.shape[2], k.shape[2], n)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if n > 1:
        q, k, v = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = flash_attention_bshd(q, k, v, causal=causal, sm_scale=sm_scale)
    return all_to_all(out, group, 1, 2) if n > 1 else out
