"""The work a flash attention launch needs, whatever implements it
(``chip_smoke.py:bound``'s arithmetic): the operations at the chip's
peak for the type, or each input read once and each output written once
at its memory rate, whichever takes longer.

A shape is ``dict(b, sq, sk, h, hkv, d, causal)``; a causal head sees
sq (sq + 1) / 2 of its (query, key) pairs (sq = sk), else all of them."""

from __future__ import annotations

from . import peaks

KINDS = ("fwd", "dq", "dkv")


def kind(kernel: str):
    """The flash kernel kind of a device kernel's name, or None: the
    forward, the dq and the dk/dv bodies of ``csrc/flash_*.cuh``."""
    if "flash::" not in kernel:
        return None
    if "bwd_dkv" in kernel:
        return "dkv"
    if "bwd_dq" in kernel:
        return "dq"
    return "fwd" if "fwd" in kernel else None


def pairs(shape: dict) -> int:
    sq, sk = shape["sq"], shape["sk"]
    return sq * (sq + 1) // 2 if shape["causal"] else sq * sk


def bound_s(kind_: str, shape: dict, dtype: str = "bf16") -> float:
    """The least seconds one launch of ``kind_`` at ``shape`` can take."""
    b, sq, sk = shape["b"], shape["sq"], shape["sk"]
    h, hkv, d = shape["h"], shape["hkv"], shape["d"]
    es = 2 if dtype in ("bf16", "fp16") else 4
    q_bytes, kv_bytes = b * sq * h * d * es, b * sk * hkv * d * es
    stat_bytes = b * sq * h * 4
    macs_per_pair = {"fwd": 2, "dq": 3, "dkv": 4}[kind_]
    flops = 2 * macs_per_pair * d * pairs(shape) * b * h
    if kind_ == "fwd":   # q, k, v in; out, lse out
        nbytes = 2 * q_bytes + 2 * kv_bytes + stat_bytes
    elif kind_ == "dq":  # q, k, v, do, lse, delta in; dq out
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * stat_bytes
    else:                # q, k, v, do, lse, delta in; dk, dv out
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * stat_bytes
    return max(flops / peaks.FLOPS[dtype], nbytes / peaks.BYTES_PER_S)
