"""The port's flat flash attention against the JAX package's.

Same numpy inputs through ``mpi_operator_tpu.ops.attention`` (the Pallas
kernels in interpret mode, as the JAX tests run them on the CPU) and
``mpi_operator_tpu_torch.ops.attention`` (on the CPU its wrappers take
the kernels' plain versions). Tolerances, f32: out atol 2e-5; dq, dk, dv
atol 1e-4 (sums of a few hundred products in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch.ops import attention as tattn
from mpi_operator_tpu_torch.ops import ring_attention as tring

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os``, so its flat path raises NameError (its own
    TestFlashAttentionBshd fails the same way). Supply the missing
    module global for the duration of a test; nothing else changes."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_out_and_grads(q, k, v, do, causal):
    out, vjp = jax.vjp(
        lambda q, k, v: jattn.flash_attention_bshd(q, k, v, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_out_and_grads(q, k, v, do, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tattn.flash_attention_bshd(qt, kt, vt, causal=causal)
    out.backward(torch.tensor(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


# (b, sq, sk, h, hkv, d, causal)
CASES = {
    "mha-causal": (2, 128, 128, 2, 2, 32, True),
    "mha-full": (2, 128, 128, 2, 2, 32, False),
    "gqa-causal": (2, 128, 128, 4, 2, 32, True),
    "gqa-full": (2, 128, 128, 4, 2, 32, False),
    # unpadded 200 with 128 tiles: the JAX side pads, the port masks
    "gqa-s200-causal": (1, 200, 200, 4, 2, 16, True),
    "mha-s200-full": (1, 200, 200, 2, 2, 16, False),
    # causal cross lengths (bottom-right offset kv_len - q_len != 0)
    "gqa-cross-causal": (1, 64, 192, 4, 2, 16, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    b, sq, sk, h, hkv, d, causal = CASES[case]
    q, k, v, do = _inputs(b, sq, sk, h, hkv, d)
    want_out, want_grads = _jax_out_and_grads(q, k, v, do, causal)
    got_out, got_grads = _torch_out_and_grads(q, k, v, do, causal)
    np.testing.assert_allclose(got_out, want_out, atol=OUT_ATOL, rtol=0)
    for got, want, name in zip(got_grads, want_grads, "qkv"):
        assert got.shape == want.shape
        np.testing.assert_allclose(
            got, want, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name} mismatch"
        )


def test_masked_rows_give_zero_out_and_neg_inf_lse():
    """Causal with q_len > kv_len: the first q_len - kv_len rows see no
    key. Kernel convention (and the JAX kernels'): out = 0, lse = NEG_INF;
    the gradients of those rows are 0 too."""
    b, sq, sk, h, hkv, d = 1, 80, 48, 4, 2, 16
    q, k, v, do = _inputs(b, sq, sk, h, hkv, d, seed=3)
    want_out, want_lse = jattn.flash_attention_bshd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True
    )
    flat = [torch.tensor(x).reshape(x.shape[0], x.shape[1], -1)
            for x in (q, k, v)]
    out, lse = tattn.flash_fwd(*flat, h, d ** -0.5, True)
    out = out.reshape(b, sq, h, d).numpy()
    dead = sq - sk
    assert np.all(out[:, :dead] == 0.0)
    assert np.all(lse.numpy()[:, :dead] == tattn.NEG_INF)
    np.testing.assert_allclose(out, np.asarray(want_out), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(
        lse.numpy()[:, dead:], np.asarray(want_lse)[:, dead:], atol=OUT_ATOL,
        rtol=0,
    )
    _, want_grads = _jax_out_and_grads(q, k, v, do, True)
    _, got_grads = _torch_out_and_grads(q, k, v, do, True)
    assert np.all(got_grads[0][:, :dead] == 0.0)
    for got, want in zip(got_grads, want_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    rng = np.random.RandomState(5)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal
    )
    got = tattn.attention_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)


def test_cpu_calls_take_the_plain_versions_and_launch_nothing():
    tattn.reset_launch_counts()
    q, k, v, do = _inputs(1, 32, 32, 2, 1, 8)
    _torch_out_and_grads(q, k, v, do, True)
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(tattn.LAUNCHES)
    assert set(tattn.LAUNCHES.values()) == {0}


def test_rejects_bad_operands():
    q = torch.zeros(1, 16, 3, 8)
    k = v = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        tattn.flash_attention_bshd(q, k, v)
    with pytest.raises(ValueError, match="rank"):
        tattn.flash_attention_bshd(q[0], k[0], v[0])
    # A device that is neither the CPU nor CUDA gets no fallback.
    meta = torch.zeros(1, 16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_fwd(meta, meta, meta, 2, 0.25, True)


def test_dispatch_routes_and_refuses():
    q, k, v, _ = _inputs(1, 24, 24, 4, 2, 8, seed=7)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    flash = tring.sp_attention_bshd(qt, kt, vt, "flash", causal=True)
    assert tring.sp_attention_bshd(qt, kt, vt, "dense", causal=True) is None
    dense = tring.sp_attention(
        *(t.transpose(1, 2) for t in (qt, kt, vt)), "dense", causal=True
    ).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=OUT_ATOL,
                               rtol=0)
    # The sequence-parallel impls need the sp process group; the JAX
    # pipeline's in-stage names are the same ring and Ulysses.
    for impl in ("ring", "ulysses", "ring-shard", "ulysses-shard"):
        for dispatch in (tring.sp_attention_bshd, tring.sp_attention):
            with pytest.raises(ValueError, match="needs a mesh with an sp"):
                dispatch(qt, kt, vt, impl, causal=True)
    # flash-bhsd lives on the [B, H, S, D] path: flash_attention, which
    # matches the dense oracle.
    assert tring.sp_attention_bshd(qt, kt, vt, "flash-bhsd",
                                   causal=True) is None
    bhsd = tring.sp_attention(
        *(t.transpose(1, 2) for t in (qt, kt, vt)), "flash-bhsd", causal=True
    ).transpose(1, 2)
    np.testing.assert_allclose(bhsd.numpy(), dense.numpy(), atol=OUT_ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tring.sp_attention(qt, kt, vt, "flsh", causal=True)
