"""The port's ring attention against the JAX package's, op by op.

The same numpy inputs go through the JAX ring (``ring_attention_bshd``
and ``ring_attention`` inside a ``shard_map`` over the sp axis of the
8-device CPU mesh, the Pallas kernels in interpret mode, as
``tests/test_ops.py`` runs them) and through the port's ring on 2 and 4
gloo processes (``tests.test_torch_world.run_gang``; each rank holds its
positions of the sequence and takes the kernels' plain versions).
Cases: causal and not, the contiguous and the zigzag layout, GQA (4 q
heads on 2 kv heads). The output and dq, dk, dv of ``sum(out * g)`` at
f32: out atol 2e-5, gradients atol 1e-4 (``test_torch_attention.py``'s
tolerances: sums over a few hundred products in another order, here
merged over the hops in another order as well).

Also on one process: ``flash_attention_bshd_lse`` with ids and a
nonzero lse cotangent against JAX's, and the zigzag permutations and
per-rank ids against JAX's integers.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu.parallel import create_mesh as jax_mesh
from mpi_operator_tpu_torch.ops import attention as tattn
from mpi_operator_tpu_torch.ops import ring_attention as tring
from tests.test_torch_world import run_gang

# The package exports a function of the module's name: import the module.
jring = importlib.import_module("mpi_operator_tpu.ops.ring_attention")

pytestmark = pytest.mark.kernel
torch.set_num_threads(1)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4
B, S, H, H_KV, D = 2, 32, 4, 2, 8
# (layout, causal, zigzag) on n ranks.
# "bhsd-dense": ring_attention with impl="dense" (the oracle's hops).
CASES = {
    2: [("bshd", False, False), ("bshd", True, False), ("bshd", True, True),
        ("bhsd", False, False), ("bhsd", True, False), ("bhsd", True, True),
        ("bhsd-dense", True, True)],
    4: [("bshd", True, False), ("bshd", True, True)],
}


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os`` (``tests/test_torch_attention.py``): supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _arrays(layout: str, seed: int = 0):
    """q, k, v and the output cotangent g, global, in ``layout``."""
    rng = np.random.RandomState(seed)
    shapes = [(B, S, H, D), (B, S, H_KV, D), (B, S, H_KV, D), (B, S, H, D)]
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return out if layout == "bshd" else [x.transpose(0, 2, 1, 3) for x in out]


def _seq_dim(layout: str) -> int:
    return 1 if layout == "bshd" else 2


def _impl(layout: str) -> dict:
    return {"impl": "dense"} if layout.endswith("-dense") else {}


def port_shard(layout: str, causal: bool, zigzag: bool) -> dict:
    """One rank's part of the port's ring (an op job of ``run_gang``):
    its output shard and the gradients of ``sum(out * g)`` at its
    positions, as lists."""
    import torch.distributed as dist

    group = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    dim = _seq_dim(layout)
    pos = tring._shard_ids(rank, n, S // n, zigzag).long()
    q, k, v, g = (torch.from_numpy(x).index_select(dim, pos)
                  for x in _arrays(layout))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fn = tring.ring_attention_bshd if layout == "bshd" else tring.ring_attention
    out = fn(q, k, v, group, causal=causal, zigzag=zigzag, **_impl(layout))
    (out * g).sum().backward()
    return {name: x.detach().tolist() for name, x in
            (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


def jax_ring(n: int, layout: str, causal: bool, zigzag: bool) -> dict:
    """JAX's ring on an sp=n mesh: the output and gradients in the global
    zigzag order when ``zigzag`` (the layout its ranks hold)."""
    from jax import shard_map

    mesh = jax_mesh(devices=jax.devices()[:n], sp=n)
    dim = _seq_dim(layout)
    arrays = [jnp.asarray(x) for x in _arrays(layout)]
    if zigzag:
        perm = jnp.asarray(jring.zigzag_indices(S, n))
        arrays = [jnp.take(x, perm, axis=dim) for x in arrays]
    q, k, v, g = arrays
    spec = P(*[("sp" if i == dim else None) for i in range(4)])
    per_shard = (jring.ring_attention_bshd if layout == "bshd"
                 else jring.ring_attention)
    fn = shard_map(
        lambda a, b, c: per_shard(a, b, c, "sp", causal=causal,
                                  zigzag=zigzag, **_impl(layout)),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


@pytest.fixture(scope="module")
def gangs():
    """n -> (case -> each rank's result): every case on n ranks in one
    gang, run when a test first asks for n."""
    runs = {}

    def on(n: int) -> dict:
        if n not in runs:
            jobs = [{"cmd": "op",
                     "fn": "tests.test_torch_ring_attention:port_shard",
                     "args": {"layout": layout, "causal": causal,
                              "zigzag": zigzag}}
                    for layout, causal, zigzag in CASES[n]]
            ranks = run_gang(n, jobs)
            runs[n] = {case: [r[i]["line"] for r in ranks]
                       for i, case in enumerate(CASES[n])}
        return runs[n]

    return on


@pytest.mark.parametrize("n,layout,causal,zigzag", [
    (n, *case) for n in sorted(CASES) for case in CASES[n]])
def test_ring_matches_the_jax_ring(gangs, n, layout, causal, zigzag):
    results = gangs(n)[layout, causal, zigzag]
    want = jax_ring(n, layout, causal, zigzag)
    dim = _seq_dim(layout)
    for name, ref in want.items():
        # The ranks' shards in rank order: JAX's global array in the
        # layout its ranks hold (contiguous, or zigzag order).
        got = np.concatenate([np.asarray(r[name], np.float32)
                              for r in results], axis=dim)
        np.testing.assert_allclose(
            got, np.asarray(ref),
            atol=OUT_ATOL if name == "out" else GRAD_ATOL, rtol=0,
            err_msg=f"{name} n={n} {layout} causal={causal} zigzag={zigzag}")


def test_flat_lse_with_ids_and_an_lse_cotangent_matches_jax():
    """A zigzag hop of the flat kernels, by id: out and lse, and the
    gradients of ``sum(out * g) + sum(lse * g_lse)``, the lse cotangent
    folded into delta."""
    rng = np.random.RandomState(5)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((2, 24, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8),
                   (2, 24, 4, 8)))
    g_lse = rng.standard_normal((2, 24, 4)).astype(np.float32)
    # Rows 0-11 see no column of chunk 2's first half: their out is 0,
    # their lse NEG_INF, their gradient 0.
    row = np.concatenate([np.arange(0, 12), np.arange(60, 72)]).astype(np.int32)
    col = np.concatenate([np.arange(20, 30), np.arange(40, 50)]).astype(np.int32)

    def jloss(q, k, v):
        out, lse = jattn.flash_attention_bshd_lse(
            q, k, v, row_ids=jnp.asarray(row), col_ids=jnp.asarray(col))
        live = lse > jattn.NEG_INF / 2
        return (jnp.sum(out * g) + jnp.sum(jnp.where(live, lse, 0.0) * g_lse),
                (out, lse))

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tattn.flash_attention_bshd_lse(
        tq, tk, tv, row_ids=torch.from_numpy(row), col_ids=torch.from_numpy(col))
    live = lse > tattn.NEG_INF / 2
    assert not bool(live.all()) and bool(live.any())
    assert bool((out.reshape(2, 24, 4, 8)[~live] == 0).all())
    assert bool((lse[~live] == tattn.NEG_INF).all())
    ((out * torch.from_numpy(g)).sum()
     + (torch.where(live, lse, 0.0) * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy()[live.numpy()],
                               np.asarray(jlse)[live.numpy()], atol=OUT_ATOL,
                               rtol=0)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=GRAD_ATOL,
                                   rtol=0)
    assert bool((tq.grad.reshape(2, 24, 4, 8)[~live] == 0).all())


@pytest.mark.parametrize("causal", [False, True])
def test_hop_partials_match_jax_and_each_other(causal):
    """One zigzag hop (rank 0 of 2 on rank 1's shard: rows 0-7 see
    nothing) on [B, H, S, D]: the oracle partial against JAX's, and the
    flash partial (the [B*H, S, D] kernels' plain versions) against the
    oracle; a row that sees nothing gives 0 and NEG_INF in both."""
    q, k, v, _ = _arrays("bhsd", seed=2)
    q, k, v = (x[:, :, :16] for x in (q, k, v))
    row, col = (tring._shard_ids(i, 2, 16, True) for i in (0, 1))
    jo, jl = jring._dense_partial(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(row.numpy()),
                                  jnp.asarray(col.numpy()), causal, D ** -0.5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    do, dl = tring._dense_partial(tq, tk, tv, row, col, causal, D ** -0.5)
    fo, fl = tring._flash_partial(tq, tk, tv, row, col, causal, D ** -0.5)
    np.testing.assert_allclose(do.numpy(), jo, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(dl.numpy(), jl, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(fo.numpy(), do.numpy(), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(fl.numpy(), dl.numpy(), atol=OUT_ATOL, rtol=0)
    if causal:
        assert bool((fl[:, :, :8] == tattn.NEG_INF).all())
        assert bool((fo[:, :, :8] == 0).all())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zigzag_layout_is_the_jax_packages(n):
    seq = 8 * n
    np.testing.assert_array_equal(tring.zigzag_indices(seq, n),
                                  jring.zigzag_indices(seq, n))
    np.testing.assert_array_equal(tring.zigzag_inverse(seq, n),
                                  jring.zigzag_inverse(seq, n))
    for zigzag in (False, True):
        for idx in range(n):
            np.testing.assert_array_equal(
                tring._shard_ids(idx, n, seq // n, zigzag).numpy(),
                np.asarray(jring._shard_ids(idx, n, seq // n, zigzag)))
    with pytest.raises(ValueError, match="not divisible"):
        tring.zigzag_indices(seq + 1, n)
