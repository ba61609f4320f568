"""The port's Ulysses attention against the JAX package's, op by op.

The same numpy inputs go through JAX's ``ulysses_attention_bshd`` and
``ulysses_attention`` inside a ``shard_map`` over the sp axis of the
8-device CPU mesh (the Pallas kernels in interpret mode, as
``tests/test_ulysses.py`` runs them) and through the port's on 2 and 4
gloo processes (``tests.test_torch_world.run_gang``; each rank holds its
contiguous positions and takes the kernels' plain versions). 4 q heads
on 2 kv heads: on 2 ranks the kv heads split as they are, on 4 they are
repeated to 4 before the all-to-all, in JAX's head order. The output and
dq, dk, dv of ``sum(out * g)`` at f32, at ``test_torch_ring_attention``'s
tolerances; the head checks and the kv repeat factor against JAX's.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_operator_tpu.parallel import create_mesh as jax_mesh
from mpi_operator_tpu_torch.ops import ulysses as tuly
from mpi_operator_tpu.ops import attention as jattn
from tests.test_torch_ring_attention import (GRAD_ATOL, OUT_ATOL, S, _arrays,
                                             _impl, _seq_dim)
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel
torch.set_num_threads(1)
# The package exports a function of the module's name: import the module.
jully = importlib.import_module("mpi_operator_tpu.ops.ulysses")

# (layout, causal) on n ranks; "bhsd-dense": ulysses_attention with
# impl="dense" (the oracle between the all-to-alls).
CASES = {
    2: [("bshd", False), ("bshd", True), ("bhsd", True)],
    4: [("bshd", True), ("bhsd", False), ("bhsd-dense", True)],
}


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os`` (``tests/test_torch_attention.py``): supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def port_shard(layout: str, causal: bool) -> dict:
    """One rank's part of the port's Ulysses (an op job of
    ``run_gang``): its output shard and the gradients of ``sum(out * g)``
    at its positions, as lists."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    dim, per = _seq_dim(layout), S // n
    q, k, v, g = (torch.from_numpy(x).narrow(dim, rank * per, per)
                  for x in _arrays(layout))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fn = (tuly.ulysses_attention_bshd if layout == "bshd"
          else tuly.ulysses_attention)
    out = fn(q, k, v, dist.group.WORLD, causal=causal, **_impl(layout))
    (out * g).sum().backward()
    return {name: x.detach().tolist() for name, x in
            (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


def jax_ulysses(n: int, layout: str, causal: bool) -> dict:
    from jax import shard_map

    mesh = jax_mesh(devices=jax.devices()[:n], sp=n)
    dim = _seq_dim(layout)
    q, k, v, g = (jnp.asarray(x) for x in _arrays(layout))
    spec = P(*[("sp" if i == dim else None) for i in range(4)])
    per_shard = (jully.ulysses_attention_bshd if layout == "bshd"
                 else jully.ulysses_attention)
    fn = shard_map(lambda a, b, c: per_shard(a, b, c, "sp", causal=causal,
                                             **_impl(layout)),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                   check_vma=False)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


@pytest.fixture(scope="module")
def gangs():
    """n -> (case -> each rank's result), one gang per n on first use."""
    runs = {}

    def on(n: int) -> dict:
        if n not in runs:
            jobs = [{"cmd": "op", "fn": "tests.test_torch_ulysses:port_shard",
                     "args": {"layout": layout, "causal": causal}}
                    for layout, causal in CASES[n]]
            ranks = run_gang(n, jobs)
            runs[n] = {case: [r[i]["line"] for r in ranks]
                       for i, case in enumerate(CASES[n])}
        return runs[n]

    return on


@pytest.mark.parametrize("n,layout,causal", [
    (n, *case) for n in sorted(CASES) for case in CASES[n]])
def test_ulysses_matches_the_jax_ulysses(gangs, n, layout, causal):
    results = gangs(n)[layout, causal]
    dim = _seq_dim(layout)
    for name, ref in jax_ulysses(n, layout, causal).items():
        got = np.concatenate([np.asarray(r[name], np.float32)
                              for r in results], axis=dim)
        np.testing.assert_allclose(
            got, np.asarray(ref),
            atol=OUT_ATOL if name == "out" else GRAD_ATOL, rtol=0,
            err_msg=f"{name} n={n} {layout} causal={causal}")


def test_head_checks_are_the_jax_packages():
    for h_kv in (1, 2, 3, 4, 6, 8):
        for n in (1, 2, 4, 8):
            assert tuly._replicate_kv_for(h_kv, n) == \
                jully._replicate_kv_for(h_kv, n)
    with pytest.raises(ValueError, match=r"ulysses needs the sp size \(4\) "
                                         r"to divide the query head count "
                                         r"\(6\); use ring attention"):
        tuly._check(6, 2, 4)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tuly._check(4, 3, 2)
    assert tuly._check(4, 2, 4) == 2 and tuly._check(4, 2, 2) == 1
