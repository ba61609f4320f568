"""A few training steps of a reference family, AdamW written out, from
the benchmark's weights and batches; returns what the check compares
(``check.Signature``): each step's loss, each leaf's gradient norm at the
first step, each leaf's change after the last.

The gradient of a step is the mean of its microbatches' gradients
(microbatch i: rows [i B / A, (i + 1) B / A)), its loss their losses'
mean. AdamW: decoupled weight decay, then the bias-corrected moments;
a leaf that gets no gradient is left alone."""

from __future__ import annotations

import torch

from .. import weights as weights_lib
from ..check import Signature, gradient_readings


def _adamw(w: dict, state: dict, step: int, opt: dict) -> None:
    b1, b2 = opt["betas"]
    lr, eps, wd = opt["lr"], opt["eps"], opt["weight_decay"]
    with torch.no_grad():
        for name, p in w.items():
            if p.grad is None:
                continue
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            p.mul_(1 - lr * wd)
            denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def microbatches(batch: tuple, accum: int, half: bool = False) -> list:
    """The step's microbatches; ``half`` keeps the first half of the rows
    (a planted fault: half the batch left out, the mean over the rest)."""
    if half:
        rows = batch[0].shape[0] // 2
        batch = tuple(t[:rows] for t in batch)
        accum = max(accum // 2, 1)
    n = batch[0].shape[0] // accum
    return [tuple(t[i * n:(i + 1) * n] for t in batch) for i in range(accum)]


def run(family, config: dict, traffic: dict, batches: list, seed: int,
        device, precision: str = "f32", fault: str = "") -> Signature:
    """``len(batches)`` AdamW steps of ``family`` from the seed's weights.
    ``fault="half"`` plants one in the reference put in the program's
    place: each step on half its rows."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(family, config, traffic, batches, seed, device,
                    precision, fault)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _run(family, config, traffic, batches, seed, device, precision, fault):
    leaves = family.leaves(config)
    shapes = {name: shape for name, shape, _ in leaves}
    w = {name: flat.reshape(shapes[name]).requires_grad_()
         for name, flat in weights_lib.draw(leaves, seed, device)}
    accum = int(traffic["grad_accum"])
    state, losses, grads, sample = {}, [], {}, {}
    for step, batch in enumerate(batches, start=1):
        for p in w.values():
            p.grad = None
        total = 0.0
        parts = microbatches(batch, accum, half=fault == "half")
        for mb in parts:
            micro = family.loss(w, mb, config, precision)
            (micro / len(parts)).backward()
            total += float(micro.detach())
        loss = total / len(parts)
        losses.append(loss)
        if step == 1:
            grads, sample = gradient_readings(
                {n: p.grad for n, p in w.items() if p.grad is not None},
                leaves, seed, device)
        _adamw(w, state, step, config["optimizer"])
    del state
    change = {}
    with torch.no_grad():
        for name, first in weights_lib.draw(leaves, seed, device):
            change[name] = float((w[name].reshape(-1) - first).norm())
    return Signature(losses, grads, change, sample)
