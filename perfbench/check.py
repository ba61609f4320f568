"""How ``correct`` is decided: the program's first steps against the
plain reference's, from the same weights and batches.

Both sides give a ``Signature``: each step's loss, each leaf's gradient
norm at the first step (the program's as its optimizer got it: AdamW's
first moment after one step is (1 - beta1) g) and each leaf's change
after the last step (the program's read as step 4 starts from it). The
compared numbers:

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps;
- ``grad_gap``: over the leaves, the largest gap between the two norms of
  a leaf's gradient, against the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same of each leaf's change, leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's
  (they move by round-off alone, as a key's bias under softmax);
- ``grad_err``: over the same leaves, the median of |g - reference g| /
  |reference g|, the first step's gradient on a sample of each leaf's
  elements drawn from the seed. A norm is blind to unbiased rounding
  (errors spread over a leaf's elements hardly move its norm), so the
  norm gaps of a product computed in fp8 read no higher than bf16's;
  the elements' own error does. The median, not the worst leaf: the
  last layers' query and key gradients are small at initialization
  beside the rounding of the flash backward's rowsum(dO * O), so their
  elements read a relative error of 1-2.4 on every seed in bf16."""

from __future__ import annotations

import dataclasses
import statistics

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_err")
NOUGHT = 1e-3
SAMPLE = 4096  # elements of each leaf whose gradient is compared


@dataclasses.dataclass
class Signature:
    losses: list
    grad: dict
    change: dict
    grad_sample: dict


def sample_index(numel: int, leaf_no: int, seed: int, device):
    """SAMPLE positions (with repeats) of a leaf's flattened elements,
    drawn from the seed and the leaf's place in the benchmark's list."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + 104_729 * (leaf_no + 1)) % (1 << 63))
    return torch.randint(numel, (min(numel, SAMPLE),), generator=g,
                         device=device)


def gradient_readings(grads: dict, leaves: list, seed: int, device,
                      scale: float = 1.0) -> tuple:
    """(name -> norm, name -> the sampled elements on the host) of each
    leaf's gradient ``grads[name] * scale``; 0 and zeros for a leaf
    without one."""
    norms, samples = {}, {}
    for i, (name, shape, _) in enumerate(leaves):
        numel = 1
        for s in shape:
            numel *= s
        idx = sample_index(numel, i, seed, device)
        g = grads.get(name)
        if g is None:
            norms[name], samples[name] = 0.0, torch.zeros(idx.numel())
            continue
        g = g.detach().reshape(-1)
        norms[name] = float(g.norm()) * scale
        samples[name] = g[idx].float().cpu() * scale
    return norms, samples


def _gap_by_leaf(got: dict, want: dict, names: list) -> dict:
    med = statistics.median(want[n] for n in names)
    return {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-30)
            for n in names}


def element_errs(got: dict, want: dict, names) -> dict:
    """name -> |got - want| / |want| over the leaf's sampled elements."""
    return {n: float((got[n] - want[n]).norm())
            / max(float(want[n].norm()), 1e-30) for n in names}


def per_leaf(got: Signature, want: Signature) -> dict:
    """Each leaf measure's reading of every leaf it counts (the look
    behind a number)."""
    med = statistics.median(want.grad.values())
    moved = [n for n, g in want.grad.items() if g >= NOUGHT * med]
    return {"grad_gap": _gap_by_leaf(got.grad, want.grad, list(want.grad)),
            "change_gap": _gap_by_leaf(got.change, want.change, moved),
            "grad_err": element_errs(got.grad_sample, want.grad_sample,
                                     moved)}


def gaps(got: Signature, want: Signature) -> dict:
    """The compared numbers of ``got`` against the reference ``want``."""
    if len(got.losses) != len(want.losses):
        raise ValueError(f"{len(got.losses)} steps against "
                         f"{len(want.losses)}")
    leaf = per_leaf(got, want)
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(got.losses, want.losses)),
            "grad_gap": max(leaf["grad_gap"].values()),
            "change_gap": max(leaf["change_gap"].values()),
            "grad_err": statistics.median(leaf["grad_err"].values())}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): each number beside its limit, one line each;
    correct when every number is finite and at most its limit."""
    ok, lines = True, []
    for name in NUMBERS:
        value, limit = numbers[name], limits[name]
        good = value == value and value <= limit
        ok = ok and good
        lines.append(f"{name} {value!r} limit {limit!r}"
                     f"{'' if good else ' FAILED'}")
    return ok, lines


def first_moments(model, optimizer) -> dict:
    """name -> AdamW's first moment of each leaf it holds state for; after
    one step it is (1 - beta1) times that step's gradient, as the
    optimizer got it."""
    out = {}
    for name, p in model.named_parameters():
        m = optimizer.state.get(p, {}).get("exp_avg")
        if m is not None:
            out[name] = m
    return out


def changes(model, leaves: list, seed: int) -> dict:
    """Each leaf's change from the seed's weights (drawn again here, a
    leaf at a time)."""
    from . import weights

    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    out = {}
    with torch.no_grad():
        for name, first in weights.draw(leaves, seed, device):
            out[name] = float((params[name].detach().reshape(-1)
                               - first).norm())
    return out
