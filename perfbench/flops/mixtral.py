"""Mixtral's model FLOPs a token and its attention launch shape."""

from __future__ import annotations


def flops_per_token(config: dict, traffic: dict) -> float:
    """Routed training FLOPs a token (``chip_smoke.py:
    _moe_flops_per_token``; PaLM's appendix, 2 x MAC, backward = 2 x
    forward): 6 x the matmul parameters one token passes through
    (attention, the router, k of the E experts' SwiGLU, the head) plus
    6 L d S for causal attention. GShard's dispatch and combine products,
    the remat recompute and slots left empty by dropped choices are not
    counted."""
    d, f = config["hidden_size"], config["intermediate_size"]
    h, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, layers = config["head_dim"], config["num_hidden_layers"]
    e, k = config["num_local_experts"], config["num_experts_per_tok"]
    attn = d * (h + 2 * hkv) * hd + h * hd * d
    routed = k * 3 * d * f + d * e
    n = layers * (attn + routed) + d * config["vocab_size"]
    return 6 * n + 6 * layers * d * traffic["seq_len"]


def attention_shape(config: dict, traffic: dict) -> dict:
    """One flash launch: a microbatch's rows, causal."""
    s = traffic["seq_len"]
    return dict(b=traffic["global_batch"] // traffic["grad_accum"], sq=s,
                sk=s, h=config["num_attention_heads"],
                hkv=config["num_key_value_heads"], d=config["head_dim"],
                causal=True)
