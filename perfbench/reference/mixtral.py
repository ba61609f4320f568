"""Mixtral (a Llama decoder whose every FFN is a sparse mixture of
experts), its training loss in plain PyTorch: RMSNorm, RoPE, causal
grouped-query attention, a softmax router over E experts with the top-k
gates renormalized (Mixtral's convention), SwiGLU experts, and the
next-token cross-entropy plus the router's load-balance loss.

Routing under a capacity, as the configuration states it: each batch row
is a group of S tokens; each expert takes at most C = ceil(k S / E x
capacity_factor) (token, choice) pairs of a group, first choices before
second choices and in token order within each; the pairs past C are
dropped (the residual carries the token on). Here the experts gather
their tokens by index and scatter their weighted outputs back.

The load-balance loss is Switch's E sum_e f_e p_e (f_e: the share of a
group's tokens whose first choice is e, p_e: the group's mean router
probability), averaged over the groups and summed over the layers."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common


def sizes(config: dict) -> dict:
    return dict(
        d=config["hidden_size"], f=config["intermediate_size"],
        h=config["num_attention_heads"], hkv=config["num_key_value_heads"],
        dh=config["head_dim"], layers=config["num_hidden_layers"],
        e=config["num_local_experts"], k=config["num_experts_per_tok"],
        v=config["vocab_size"], theta=config["rope_theta"],
        eps=config["rms_norm_eps"],
        aux=config["router_aux_loss_coef"],
        cf=config["assumed"]["capacity_factor"])


def leaves(config: dict) -> list:
    """(name, shape, rule) of every parameter: weights [out, in] as the
    program lays them out, the router [D, E], the experts [E, in, out];
    matrices normal with std 1/sqrt(fan in), norms' scales 1."""
    s = sizes(config)
    d, f, dh, e = s["d"], s["f"], s["dh"], s["e"]
    out = [("embed.weight", (s["v"], d), ("normal", d ** -0.5))]
    for i in range(s["layers"]):
        p = f"layer_{i}."
        out += [
            (p + "attn_norm.scale", (d,), ("const", 1.0)),
            (p + "attn.wq.weight", (s["h"] * dh, d), ("normal", d ** -0.5)),
            (p + "attn.wk.weight", (s["hkv"] * dh, d), ("normal", d ** -0.5)),
            (p + "attn.wv.weight", (s["hkv"] * dh, d), ("normal", d ** -0.5)),
            (p + "attn.wo.weight", (d, s["h"] * dh),
             ("normal", (s["h"] * dh) ** -0.5)),
            (p + "mlp_norm.scale", (d,), ("const", 1.0)),
            (p + "moe.router", (d, e), ("normal", d ** -0.5)),
            (p + "moe.expert_wg", (e, d, f), ("normal", d ** -0.5)),
            (p + "moe.expert_wu", (e, d, f), ("normal", d ** -0.5)),
            (p + "moe.expert_wd", (e, f, d), ("normal", f ** -0.5)),
        ]
    out += [("final_norm.scale", (d,), ("const", 1.0)),
            ("lm_head.weight", (s["v"], d), ("normal", d ** -0.5))]
    return out


def capacity(config: dict, tokens_per_group: int) -> int:
    s = sizes(config)
    return max(1, math.ceil(s["k"] * tokens_per_group / s["e"] * s["cf"]))


def _moe(x, w: dict, p: str, s: dict, cap: int, precision: str):
    """The expert layer on x [G, S, D]: (output [G, S, D], aux)."""
    g, n, d = x.shape
    probs = torch.softmax(x @ w[p + "moe.router"], dim=-1)  # [G, S, E]
    gates, idx = torch.topk(probs, s["k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    first = F.one_hot(idx[..., 0], s["e"]).float().mean(1)
    aux = s["e"] * (first * probs.mean(1)).sum(-1).mean()
    out = []
    for grp in range(g):
        # The group's (choice, token) pairs, first choices first.
        expert = idx[grp].t().reshape(-1)  # [k S]
        token = torch.arange(n, device=x.device).repeat(s["k"])
        gate = gates[grp].t().reshape(-1)
        y = torch.zeros(n, d, dtype=x.dtype, device=x.device)
        for e in range(s["e"]):
            chosen = torch.nonzero(expert == e)[:, 0][:cap]
            if chosen.numel() == 0:
                continue
            rows = token[chosen]
            xe = x[grp, rows]
            hid = (F.silu(common.matmul(xe, w[p + "moe.expert_wg"][e],
                                        precision))
                   * common.matmul(xe, w[p + "moe.expert_wu"][e], precision))
            ye = common.matmul(hid, w[p + "moe.expert_wd"][e], precision)
            y = y.index_add(0, rows, ye * gate[chosen, None])
        out.append(y)
    return torch.stack(out), aux


def loss(w: dict, batch: tuple, config: dict, precision: str = "f32"):
    """Mean next-token cross-entropy of the rows ``batch[0]`` [G, S] plus
    the router loss times its coefficient."""
    (tokens,) = batch
    s = sizes(config)
    g, n = tokens.shape
    cap = capacity(config, n)
    h = w["embed.weight"][tokens]
    aux_total = 0.0
    for i in range(s["layers"]):
        p = f"layer_{i}."
        a = common.rms_norm(h, w[p + "attn_norm.scale"], s["eps"])
        q = common.linear(a, w[p + "attn.wq.weight"], precision)
        k = common.linear(a, w[p + "attn.wk.weight"], precision)
        v = common.linear(a, w[p + "attn.wv.weight"], precision)
        q, k, v = (t.reshape(g, n, -1, s["dh"]).transpose(1, 2)
                   for t in (q, k, v))
        q, k = common.rope(q, s["theta"]), common.rope(k, s["theta"])
        att = common.attention(q, k, v, True, precision, heads_at_once=8)
        att = att.transpose(1, 2).reshape(g, n, -1)
        h = h + common.linear(att, w[p + "attn.wo.weight"], precision)
        m = common.rms_norm(h, w[p + "mlp_norm.scale"], s["eps"])
        y, aux = _moe(m, w, p, s, cap, precision)
        h = h + y
        aux_total = aux_total + aux
    h = common.rms_norm(h, w["final_norm.scale"], s["eps"])
    hs = h[:, :-1].reshape(-1, s["d"])
    targets = tokens[:, 1:].reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, hs.shape[0], 1024):
        logits = common.linear(hs[lo:lo + 1024], w["lm_head.weight"],
                               precision)
        total = total + common.cross_entropy_sum(logits, targets[lo:lo + 1024])
    return total / targets.numel() + s["aux"] * aux_total


def batch(path, traffic: dict, config: dict, step: int, data_seed: int,
          device) -> tuple:
    rows = common.batch_rows(path, traffic["seq_len"],
                             traffic["global_batch"], step, data_seed,
                             config["vocab_size"])
    return (torch.as_tensor(rows, device=device),)
