"""The port's [B, H, S, D] flash attention (``flash_attention``,
``flash_attention_lse``) against the JAX package's.

Same numpy inputs through ``mpi_operator_tpu.ops.attention`` (the Pallas
``_fwd_kernel`` / ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` in interpret
mode, as the JAX tests run them on the CPU) and
``mpi_operator_tpu_torch.ops.attention`` (on the CPU its wrappers take the
kernels' plain versions). The cases mirror ``tests/test_ops.py``'s
``TestFlashAttention`` and ``TestFlashAttentionLse``. Tolerances, f32:
out and lse atol 2e-5; dq, dk, dv atol 2e-5 (sums of at most a few
hundred products, taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

ATOL = 2e-5


def _inputs(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, ct):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jax.tree_util.tree_map(jnp.asarray, ct))
    return jax.tree_util.tree_map(np.asarray, out), [np.asarray(g) for g in grads]


def _torch_vjp(fn, q, k, v, ct):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    outs = out if isinstance(out, tuple) else (out,)
    cts = ct if isinstance(ct, tuple) else (ct,)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
    got = tuple(o.detach().numpy() for o in outs)
    return (got if isinstance(out, tuple) else got[0],
            [t.grad.numpy() for t in (qt, kt, vt)])


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


# (b, h, hkv, sq, sk, d, causal)
CASES = {
    "mha-full": (1, 2, 2, 128, 128, 32, False),
    "mha-causal": (1, 2, 2, 128, 128, 32, True),
    # unpadded 200 with 128 tiles: the JAX side pads, the port masks
    "s200-full": (1, 2, 2, 200, 200, 16, False),
    "s200-causal": (1, 2, 2, 200, 200, 16, True),
    "cross-full": (1, 2, 2, 64, 192, 16, False),
    # bottom-right-aligned causal mask (kv_len - q_len != 0)
    "cross-causal": (1, 2, 2, 64, 192, 16, True),
    "gqa-full": (2, 4, 2, 128, 128, 16, False),
    "gqa-causal": (2, 4, 2, 128, 128, 16, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    b, h, hkv, sq, sk, d, causal = CASES[case]
    q, k, v, do = _inputs(b, h, hkv, sq, sk, d)
    want, want_grads = _jax_vjp(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal=causal),
        q, k, v, do)
    got, got_grads = _torch_vjp(
        lambda q, k, v: tattn.flash_attention(q, k, v, causal=causal),
        q, k, v, do)
    _assert_close(got, want, "out")
    for g, w, name in zip(got_grads, want_grads, "qkv"):
        assert g.shape == w.shape  # GQA: kv grads in the kv-head shape
        _assert_close(g, w, f"d{name}")


def test_lse_matches_jax_and_the_dense_logsumexp():
    q, k, v, _ = _inputs(1, 2, 2, 128, 128, 32, seed=1)
    want_out, want_lse = jattn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = tattn.flash_attention_lse(*(torch.tensor(x) for x in (q, k, v)))
    assert lse.shape == (1, 2, 128) and lse.dtype == torch.float32
    _assert_close(out.numpy(), np.asarray(want_out), "out")
    _assert_close(lse.numpy(), np.asarray(want_lse), "lse")
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * 32 ** -0.5
    dense = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    _assert_close(lse.numpy(), dense, "lse vs dense logsumexp")


def test_explicit_ids_reproduce_causal():
    q, k, v, do = _inputs(1, 2, 2, 128, 128, 16, seed=2)
    ids = np.arange(128, dtype=np.int32)
    tid = torch.tensor(ids)
    with_ids, g_ids = _torch_vjp(
        lambda q, k, v: tattn.flash_attention_lse(
            q, k, v, row_ids=tid, col_ids=tid)[0], q, k, v, do)
    causal, g_causal = _torch_vjp(
        lambda q, k, v: tattn.flash_attention(q, k, v, causal=True),
        q, k, v, do)
    want, _ = _jax_vjp(
        lambda q, k, v: jattn.flash_attention_lse(
            q, k, v, row_ids=jnp.asarray(ids), col_ids=jnp.asarray(ids))[0],
        q, k, v, do)
    _assert_close(with_ids, want, "out vs JAX")
    _assert_close(with_ids, causal, "out vs causal")
    for g, w in zip(g_ids, g_causal):
        _assert_close(g, w, "grads vs causal")


def test_zigzag_ids_with_masked_rows_match_jax():
    """Ids from two chunks (as a zigzag ring hop holds them), GQA, with
    rows that see no column: out = 0 and lse = NEG_INF exactly there, and
    out, lse and every gradient (with an lse cotangent) as JAX's."""
    q, k, v, do = _inputs(1, 4, 2, 96, 80, 16, seed=3)
    row_ids = np.concatenate([np.arange(16, 64), np.arange(160, 208)])
    col_ids = np.concatenate([np.arange(40, 80), np.arange(120, 160)])
    dlse = np.random.RandomState(4).standard_normal((1, 4, 96)).astype(
        np.float32)
    dead = row_ids < col_ids.min()  # rows 16..39 see nothing
    assert dead.any() and not dead.all()

    def jfn(q, k, v):
        return jattn.flash_attention_lse(
            q, k, v, row_ids=jnp.asarray(row_ids, jnp.int32),
            col_ids=jnp.asarray(col_ids, jnp.int32))

    def tfn(q, k, v):
        return tattn.flash_attention_lse(
            q, k, v, row_ids=torch.tensor(row_ids),
            col_ids=torch.tensor(col_ids))

    (want_out, want_lse), want_grads = _jax_vjp(jfn, q, k, v, (do, dlse))
    (out, lse), grads = _torch_vjp(tfn, q, k, v, (do, dlse))
    assert np.all(out[:, :, dead] == 0.0)
    assert np.all(lse[:, :, dead] == tattn.NEG_INF)
    assert np.all(grads[0][:, :, dead] == 0.0)
    _assert_close(out, want_out, "out")
    _assert_close(lse[:, :, ~dead], want_lse[:, :, ~dead], "lse")
    for g, w, name in zip(grads, want_grads, "qkv"):
        _assert_close(g, w, f"d{name}")


def test_fully_masked_rows_are_zero_weight():
    q, k, v, _ = _inputs(1, 1, 1, 64, 64, 32, seed=5)
    ids = torch.arange(64, dtype=torch.int32)
    out, lse = tattn.flash_attention_lse(
        *(torch.tensor(x) for x in (q, k, v)), row_ids=ids, col_ids=ids + 64)
    assert float(out.abs().max()) == 0.0
    assert bool(torch.all(lse == tattn.NEG_INF))


def test_split_kv_merge_equals_full_attention():
    """The merge ring attention performs, two hops' worth."""
    q, k, v, _ = _inputs(1, 2, 2, 128, 128, 32, seed=6)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    o1, l1 = tattn.flash_attention_lse(qt, kt[:, :, :64], vt[:, :, :64])
    o2, l2 = tattn.flash_attention_lse(qt, kt[:, :, 64:], vt[:, :, 64:])
    lt = torch.logaddexp(l1, l2)
    merged = (o1 * torch.exp(l1 - lt)[..., None]
              + o2 * torch.exp(l2 - lt)[..., None])
    want = jattn.attention_reference(*(jnp.asarray(x) for x in (q, k, v)))
    _assert_close(merged.numpy(), np.asarray(want), "merged")


def test_lse_cotangent_flows_through_a_merge():
    """Gradients through a two-hop merge use d(lse): the port's equal the
    JAX package's for the same split loss, and the dense causal ones."""
    q, k, v, _ = _inputs(1, 1, 1, 64, 64, 32, seed=7)
    ids = np.arange(64, dtype=np.int32)

    def split_loss(lib, xp, ids, q, k, v):
        o1, l1 = lib.flash_attention_lse(
            q, k[:, :, :32], v[:, :, :32], row_ids=ids, col_ids=ids[:32])
        o2, l2 = lib.flash_attention_lse(
            q, k[:, :, 32:], v[:, :, 32:], row_ids=ids, col_ids=ids[32:])
        lt = xp.logaddexp(l1, l2)
        o = (o1 * xp.exp(l1 - lt)[..., None]
             + o2 * xp.exp(l2 - lt)[..., None])
        return (o ** 2).sum()

    want = jax.grad(
        lambda q, k, v: split_loss(jattn, jnp, jnp.asarray(ids), q, k, v),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    split_loss(tattn, torch, torch.tensor(ids), qt, kt, vt).backward()
    qr, kr, vr = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tattn.attention_reference(qr, kr, vr, causal=True) ** 2).sum().backward()
    for t, w, r, name in zip((qt, kt, vt), want, (qr, kr, vr), "qkv"):
        _assert_close(t.grad.numpy(), np.asarray(w), f"d{name} vs JAX")
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=1e-4,
                                   rtol=0, err_msg=f"d{name} vs dense")


def test_cpu_calls_take_the_plain_versions_and_launch_nothing():
    tattn.reset_launch_counts()
    q, k, v, do = _inputs(1, 2, 1, 32, 32, 8)
    _torch_vjp(lambda q, k, v: tattn.flash_attention(q, k, v, causal=True),
               q, k, v, do)
    assert set(tattn.LAUNCHES.values()) == {0}


def test_rejects_bad_operands():
    q = torch.zeros(1, 3, 16, 8)
    k = v = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        tattn.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="rank"):
        tattn.flash_attention(q[0], k[0], v[0])
    q = torch.zeros(1, 2, 16, 8)
    ids = torch.arange(16)
    with pytest.raises(ValueError, match="given together"):
        tattn.flash_attention_lse(q, k, v, row_ids=ids)
    with pytest.raises(ValueError, match="row_ids shape"):
        tattn.flash_attention_lse(q, k, v, row_ids=ids[:8], col_ids=ids)
    with pytest.raises(ValueError, match="col_ids shape"):
        tattn.flash_attention_lse(q, k, v, row_ids=ids, col_ids=ids[:8])
    # No H <= 128 limit here, unlike flash_attention_bshd.
    wide = torch.zeros(1, 130, 4, 8)
    assert tattn.flash_attention(wide, wide, wide).shape == wide.shape
    # A device that is neither the CPU nor CUDA gets no fallback.
    meta = torch.zeros(4, 16, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_bhsd_fwd(meta, meta, meta, 0.25, True)
