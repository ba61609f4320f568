"""The weights both sides start from, drawn on the device from the seed.

Every leaf that is drawn (``("normal", std)``) takes its slice of one
flat stream of standard normals, made in chunks of ``CHUNK`` values, each
chunk one ``torch.randn`` call on its own generator seeded from (seed,
chunk). So the whole model is a few large calls, and the same seed gives
the same weights on the same kind of device: the program's, the check's
parameter change and the reference's. Constant leaves (``("const",
c)``) take no part of the stream."""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 27


def _generator(seed: int, chunk: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + chunk * 7919 + 1) % (1 << 63))
    return g


def draw(leaves: list, seed: int, device, into=None):
    """Yield ``(name, flat f32 values on device)`` of every leaf, the
    drawn ones as their last chunk is drawn. With ``into`` (name ->
    tensor), copy each leaf into it in place instead, chunk by chunk, and
    yield nothing."""
    lay, end = {}, 0
    for name, shape, rule in leaves:
        if rule[0] == "const":
            if into is not None:
                into[name].data.fill_(rule[1])
            else:
                yield name, torch.full((math.prod(shape),), float(rule[1]),
                                       device=device)
        else:
            lay[name] = (end, math.prod(shape), rule[1])
            end += math.prod(shape)
    pending = {name: [] for name in lay}
    for c in range(-(-end // CHUNK)):
        a, b = c * CHUNK, min(end, (c + 1) * CHUNK)
        z = torch.randn(b - a, generator=_generator(seed, c, device),
                        device=device, dtype=torch.float32)
        for name, (off, numel, std) in lay.items():
            s, e = max(off, a), min(off + numel, b)
            if s >= e:
                continue
            part = z[s - a:e - a] * std
            if into is not None:
                into[name].data.view(-1)[s - off:e - off].copy_(part)
                continue
            pending[name].append(part)
            if e == off + numel:
                yield name, torch.cat(pending.pop(name))
        del z


def load(model: torch.nn.Module, leaves: list, seed: int) -> None:
    """Overwrite ``model``'s parameters with the seed's weights. The
    model's parameters must be exactly ``leaves``, by name and shape."""
    params = dict(model.named_parameters())
    want = {name: tuple(shape) for name, shape, _ in leaves}
    got = {name: tuple(p.shape) for name, p in params.items()}
    if want != got:
        names = sorted(set(want) ^ set(got))
        shapes = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's leaves: names {names[:6]}, shapes "
                         f"{shapes[:6]}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for _ in draw(leaves, seed, device, into=params):
            pass
