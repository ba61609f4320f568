"""BERT's masked-LM pretraining loss in plain PyTorch: token and learned
position embeddings, post-LN encoder layers (biased q/k/v/o, a GELU FFN,
tanh approximation as the configuration states), bidirectional attention,
and the MLM head (dense, GELU, LayerNorm, the tied token table as the
decoder, no bias) on the gathered masked slots only; the loss is the
weighted mean cross-entropy over those slots."""

from __future__ import annotations

import torch

from . import common


def sizes(config: dict) -> dict:
    return dict(d=config["hidden_size"], f=config["intermediate_size"],
                h=config["num_attention_heads"],
                layers=config["num_hidden_layers"], v=config["vocab_size"],
                pos=config["max_position_embeddings"],
                types=config["type_vocab_size"], eps=config["layer_norm_eps"])


def leaves(config: dict) -> list:
    """(name, shape, rule) of every parameter, as the program names and
    lays them out: dense weights [out, in] normal with std 1/sqrt(fan
    in) and zero biases, tables normal with std 1/sqrt(D), LayerNorms
    scale 1 and bias 0. The token-type table exists and is never read
    (no token types), as in the program."""
    s = sizes(config)
    d, f = s["d"], s["f"]
    std = ("normal", d ** -0.5)
    zero, one = ("const", 0.0), ("const", 1.0)

    def dense(name, n_in, n_out):
        return [(name + ".weight", (n_out, n_in), ("normal", n_in ** -0.5)),
                (name + ".bias", (n_out,), zero)]

    def norm(name):
        return [(name + ".scale", (d,), one), (name + ".bias", (d,), zero)]

    out = [("tok_embed.weight", (s["v"], d), std),
           ("pos_embed.weight", (s["pos"], d), std),
           ("type_embed.weight", (s["types"], d), std)] + norm("embed_norm")
    for i in range(s["layers"]):
        p = f"layer_{i}."
        for name in ("wq", "wk", "wv", "wo"):
            out += dense(p + name, d, d)
        out += dense(p + "ffn_in", d, f) + dense(p + "ffn_out", f, d)
        out += norm(p + "attn_norm") + norm(p + "ffn_norm")
    return out + dense("mlm_dense", d, d) + norm("mlm_norm")


def loss(w: dict, batch: tuple, config: dict, precision: str = "f32"):
    inputs, positions, targets, weights = batch
    s = sizes(config)
    b, n = inputs.shape
    eps = s["eps"]

    def ln(x, name):
        return common.layer_norm(x, w[name + ".scale"], w[name + ".bias"],
                                 eps)

    def dense(x, name):
        return common.linear(x, w[name + ".weight"], precision,
                             w[name + ".bias"])

    table = w["tok_embed.weight"]
    h = table[inputs] + w["pos_embed.weight"][:n]
    h = ln(h, "embed_norm")
    for i in range(s["layers"]):
        p = f"layer_{i}."
        q, k, v = (dense(h, p + name).reshape(b, n, s["h"], -1).transpose(1, 2)
                   for name in ("wq", "wk", "wv"))
        att = common.attention(q, k, v, False, precision, heads_at_once=4)
        att = att.transpose(1, 2).reshape(b, n, s["d"])
        x = ln(h + dense(att, p + "wo"), p + "attn_norm")
        hid = common.gelu_tanh(dense(x, p + "ffn_in"))
        h = ln(x + dense(hid, p + "ffn_out"), p + "ffn_norm")
    picked = torch.gather(h, 1, positions[..., None].expand(-1, -1, s["d"]))
    m = ln(common.gelu_tanh(dense(picked, "mlm_dense")), "mlm_norm")
    logits = common.matmul(m.reshape(-1, s["d"]), table.t(), precision)
    ce = torch.logsumexp(logits, -1) - logits.gather(
        1, targets.reshape(-1, 1))[:, 0]
    wt = weights.reshape(-1)
    return (ce * wt).sum() / torch.clamp(wt.sum(), min=1.0)


def batch(path, traffic: dict, config: dict, step: int, data_seed: int,
          device) -> tuple:
    rows = common.batch_rows(path, traffic["seq_len"],
                             traffic["global_batch"], step, data_seed,
                             config["vocab_size"])
    arrays = common.mlm_batch(rows, data_seed, step)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)
