"""BERT's model FLOPs a token and its attention launch shape."""

from __future__ import annotations


def _params(config: dict) -> int:
    d, f, layers = (config["hidden_size"], config["intermediate_size"],
                    config["num_hidden_layers"])
    embed = (config["vocab_size"] + config["max_position_embeddings"]
             + config["type_vocab_size"]) * d + 2 * d
    layer = 4 * (d * d + d) + (d * f + f) + (f * d + d) + 4 * d
    return embed + layers * layer + (d * d + d) + 2 * d


def flops_per_token(config: dict, traffic: dict) -> float:
    """``bench.py``'s head-aware count (PaLM's appendix, fwd + bwd = 3 x
    fwd): the encoder's parameters on all S tokens, the MLM head (the
    d x d transform and the tied d x V decoder) on the n_pred gathered
    slots only, and 12 L d S a token for bidirectional attention."""
    d, layers = config["hidden_size"], config["num_hidden_layers"]
    s = traffic["seq_len"]
    n_pred = max(int(s * 0.15), 1)
    n_head = d * config["vocab_size"] + d * d
    per_seq = ((6 * (_params(config) - n_head) + 12 * layers * d * s) * s
               + 6 * n_head * n_pred)
    return per_seq / s


def attention_shape(config: dict, traffic: dict) -> dict:
    s = traffic["seq_len"]
    h = config["num_attention_heads"]
    return dict(b=traffic["global_batch"] // traffic["grad_accum"], sq=s,
                sk=s, h=h, hkv=h, d=config["hidden_size"] // h, causal=False)
