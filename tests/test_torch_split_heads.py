"""The flash kernels past head dim 256, where each head's columns split
across a thread-block cluster on the card: the plain versions against
the JAX package, and the split plan.

Same seeded numpy inputs through ``mpi_operator_tpu.ops.attention`` (the
Pallas kernels in interpret mode, as the JAX tests run them on the CPU)
and ``mpi_operator_tpu_torch.ops.attention`` (on the CPU its wrappers
take the kernels' plain versions), at D in {384, 512, 576, 1024}: out,
lse, dq, dk and dv of the flat layout (GQA, causal, the first rows seeing
nothing), of the [B*H, S, D] layout, and with ids whose first rows see
nothing; a tiny Llama with heads of 512 against the JAX model through
``interop``; then ``flash_split_plan`` at every head dim from 1 to 1025,
and the plan's arithmetic (partial products over each block's columns,
summed in cluster-rank order) against the whole product.

Tolerances, f32 (sums of a few hundred products in another order): out
and lse atol 2e-5, dq, dk and dv atol 1e-4, as
``tests/test_torch_wide_heads.py``; the Llama's loss rtol 1e-5 and every
gradient atol 2e-5, as ``tests/test_torch_llama.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jllama
from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import llama as tllama
from mpi_operator_tpu_torch.ops import _common
from mpi_operator_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4
B, SQ, SK, H, H_KV = 1, 80, 72, 4, 2  # ragged against every tiling
SPLIT_DIMS = [384, 512, 576, 1024]


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os`` (``tests/test_torch_attention.py``): supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _draw(shapes: dict, seed: int):
    rng = np.random.RandomState(seed)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}


def _chunk_ids():
    """Ids from two chunks each, as a zigzag ring hop holds them: q rows
    0..7 (ids 16..23) see no column (the first column id is 24)."""
    row = np.concatenate([np.arange(16, 56), np.arange(160, 200)])
    col = np.concatenate([np.arange(24, 60), np.arange(120, 156)])
    return row.astype(np.int32), col.astype(np.int32)


def _compare(jfn, tfn, x: dict, kw: dict, lse_out: bool):
    """out (and lse) of ``jfn`` and ``tfn`` on the same inputs, and the
    gradients of ``sum(out * g) + sum(lse * g_lse)`` over the rows that see
    something; returns the port's (out, lse, dq) for further checks."""
    def jloss(q, k, v):
        res = jfn(q, k, v, **{n: jnp.asarray(a) for n, a in kw.items()})
        out, lse = res if lse_out else (res, None)
        loss = jnp.sum(out * x["g"])
        if lse_out:
            live = lse > jattn.NEG_INF / 2
            loss = loss + jnp.sum(jnp.where(live, lse, 0.0) * x["g_lse"])
        return loss, (out, lse)

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(x[n]) for n in "qkv"))
    tq, tk, tv = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    res = tfn(tq, tk, tv, **{n: torch.from_numpy(a) for n, a in kw.items()})
    out, lse = res if lse_out else (res, None)
    loss = (out * torch.from_numpy(x["g"])).sum()
    if lse_out:
        live = lse > tattn.NEG_INF / 2
        loss = loss + (torch.where(live, lse, 0.0)
                       * torch.from_numpy(x["g_lse"])).sum()
        np.testing.assert_allclose(lse.detach().numpy()[live.numpy()],
                                   np.asarray(jlse)[live.numpy()],
                                   atol=OUT_ATOL, rtol=0)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=OUT_ATOL,
                               rtol=0)
    for got, want, name in zip((tq, tk, tv), jgrads, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")
    return out.detach(), lse, tq.grad


@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_flat_gqa_causal_matches_jax(d):
    """``flash_attention_bshd_lse``, causal (bottom-right aligned, Sq > Sk
    so the first rows see nothing) with GQA: out, lse, dq, dk, dv."""
    x = _draw({"q": (B, SQ, H, d), "k": (B, SK, H_KV, d),
               "v": (B, SK, H_KV, d), "g": (B, SQ, H, d),
               "g_lse": (B, SQ, H)}, seed=d)
    out, lse, dq = _compare(
        lambda q, k, v: jattn.flash_attention_bshd_lse(q, k, v, causal=True),
        lambda q, k, v: tattn.flash_attention_bshd_lse(q, k, v, causal=True),
        x, {}, lse_out=True)
    dead = SQ - SK
    assert bool((out[:, :dead] == 0).all())
    assert bool((lse[:, :dead] == tattn.NEG_INF).all())
    assert bool((dq[:, :dead] == 0).all())


@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_bhsd_matches_jax(d):
    """``flash_attention`` over [B, H, S, D] with GQA, causal."""
    x = _draw({"q": (B, H, SQ, d), "k": (B, H_KV, SQ, d),
               "v": (B, H_KV, SQ, d), "g": (B, H, SQ, d)}, seed=d + 1)
    _compare(lambda q, k, v: jattn.flash_attention(q, k, v, causal=True),
             lambda q, k, v: tattn.flash_attention(q, k, v, causal=True),
             x, {}, lse_out=False)


@pytest.mark.parametrize("d,layout", [(384, "flat"), (512, "bhsd"),
                                      (576, "flat"), (1024, "bhsd")])
def test_ids_with_dead_rows_match_jax(d, layout):
    """Row/col ids (two chunks each) with rows that see nothing: out 0,
    lse NEG_INF and dq 0 exactly on those rows."""
    row, col = _chunk_ids()
    sq, sk = len(row), len(col)
    if layout == "flat":
        shapes = {"q": (B, sq, H, d), "k": (B, sk, H_KV, d), "s": (B, sq, H)}
        jfn, tfn = jattn.flash_attention_bshd_lse, tattn.flash_attention_bshd_lse
    else:
        shapes = {"q": (B, H, sq, d), "k": (B, H_KV, sk, d), "s": (B, H, sq)}
        jfn, tfn = jattn.flash_attention_lse, tattn.flash_attention_lse
    x = _draw({"q": shapes["q"], "k": shapes["k"], "v": shapes["k"],
               "g": shapes["q"], "g_lse": shapes["s"]}, seed=d + 2)
    out, lse, dq = _compare(jfn, tfn, x, {"row_ids": row, "col_ids": col},
                            lse_out=True)
    dead = row < col.min()
    assert dead.any() and not dead.all()
    rows = (slice(None), dead) if layout == "flat" else (
        slice(None), slice(None), dead)
    assert bool((out[rows] == 0).all())
    assert bool((lse[rows] == tattn.NEG_INF).all())
    assert bool((dq[rows] == 0).all())


def test_tiny_llama_with_heads_of_512_matches_jax():
    """``tiny(dim=1024, n_layers=1, n_heads=2, n_kv_heads=1)``: heads of
    512 (one kv head, as DeepSeek-V4-Flash's) through the flash route on
    both sides, weights carried across by ``interop``: the loss and every
    gradient."""
    kw = dict(attention_impl="flash", dim=1024, n_layers=1, n_heads=2,
              n_kv_heads=1)
    jmodel = jllama.Llama(jllama.tiny(**kw))
    params = jllama.init_params(jmodel, jax.random.PRNGKey(0))
    tmodel = tllama.Llama(tllama.tiny(**kw), device="cpu")
    assert tmodel.config.head_dim == 512
    assert _common.flash_split_plan(tmodel.config.head_dim) == (2, 256)
    tmodel.load_state_dict(interop.llama_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tokens = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(jmodel, p, jnp.asarray(tokens))))(params)
    got_loss = tllama.loss_fn(tmodel, torch.tensor(tokens))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = interop.llama_params_to_jax(
        {n: p.grad for n, p in tmodel.named_parameters()})
    want_leaves = jax.tree_util.tree_leaves_with_path(want_grads)
    got_leaves = dict(
        ("/".join(str(getattr(k, "key", k)) for k in path), np.asarray(leaf))
        for path, leaf in jax.tree_util.tree_leaves_with_path(got))
    assert len(got_leaves) == len(want_leaves)
    for path, want in want_leaves:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(got_leaves[name], np.asarray(want),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_split_plan_at_every_head_dim():
    """``flash_split_plan(d)`` for every d from 1 to 1025: up to 256 one
    block at the bf16 body that covers d (today's launch); past it
    ceil(d / 256) blocks of 256 columns that cover d, the last holding at
    least one of its columns; 1025 and 0 refused, naming the limit."""
    widths = _common.FLASH_TC_HEAD_DIMS
    for d in range(1, 1026):
        if d > _common.FLASH_MAX_HEAD_DIM:
            with pytest.raises(ValueError, match="between 1 and 1024"):
                _common.flash_split_plan(d)
            continue
        n, w = _common.flash_split_plan(d)
        if d <= 256:
            assert n == 1 and w == min(x for x in widths if x >= d), d
        else:
            assert w == _common.FLASH_SPLIT_WIDTH == 256, d
            assert n == -(-d // 256) and (n - 1) * w < d <= n * w, d
            assert 2 <= n <= 4, d
        assert _common.flash_tc_head_dim(d) == w
        # The bf16 launch's padded width runs on the same plan.
        assert _common.flash_split_plan(
            _common.flash_padded_head_dim(d)) == (n, w), d
    with pytest.raises(ValueError, match="between 1 and 1024"):
        _common.flash_split_plan(0)


@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_partials_summed_in_rank_order_give_the_scores(d):
    """The split's arithmetic on the CPU: q k^T over each block's columns
    (zero-filled past d, as the loaders fill them), summed in cluster-rank
    order, equals the whole product to f32 summation order (atol 1e-4 on
    products of 1024 unit normals), and every block's sum is the same
    bits (one order for all)."""
    n, w = _common.flash_split_plan(d)
    gen = torch.Generator().manual_seed(d)
    q, k = (torch.randn(64, d, generator=gen) for _ in range(2))
    pad = n * w - d
    qp, kp = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k))
    partials = [qp[:, r * w:(r + 1) * w] @ kp[:, r * w:(r + 1) * w].T
                for r in range(n)]
    sums = []
    for _ in range(n):  # each block adds the same partials in rank order
        s = partials[0].clone()
        for p in partials[1:]:
            s = s + p
        sums.append(s)
    torch.testing.assert_close(sums[0], q @ k.T, atol=1e-4, rtol=0)
    assert all(torch.equal(s, sums[0]) for s in sums)
