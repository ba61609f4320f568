"""The port's bf16 flash dq against the JAX package's, both layouts.

Same bf16 inputs (drawn with numpy from a seed, rounded to bf16 once)
through ``mpi_operator_tpu.ops.attention`` (the Pallas kernels in
interpret mode, which round dS to bf16 before its product with k, as the
card's tensor-core dq body does) and ``mpi_operator_tpu_torch.ops.attention``
(on the CPU its wrappers take the kernels' plain versions, which keep dS
in f32). Tolerance: dq norm-relative 1e-2, the one ``chip_smoke.py`` holds
the bf16 kernels to; the two sides differ by the reference's bf16 rounding
of dS and of its outputs (out, dq), ~2^-9 relative per term. Rows that
see no column get dq exactly 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.ops import attention as jattn
from mpi_operator_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

DQ_NORM_REL_TOL = 1e-2


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's flat path reads ``os.environ`` without importing
    ``os`` (see tests/test_torch_attention.py); supply the module global
    for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _bf16_inputs(shapes, seed):
    """f32 draws rounded to bf16: the same values on both sides."""
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in shapes]


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _norm_rel(got, want) -> float:
    got, want = (np.asarray(x).astype(np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _dq_jax(fn, q, k, v, cts):
    _, vjp = jax.vjp(fn, *(_to_jax(t) for t in (q, k, v)))
    return np.asarray(vjp(cts)[0])


def _dq_torch(fn, q, k, v, cts):
    q = q.clone().requires_grad_()
    out = fn(q, k, v)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, list(cts))
    assert q.grad.dtype == torch.bfloat16
    return q.grad.float().numpy()


# (b, sq, sk, h, hkv, d, causal); the head dims are multiples of 8, as the
# bf16 kernels take them.
FLAT_CASES = {
    "gqa-causal": (1, 128, 128, 4, 2, 32, True),
    # unpadded 200 with 128 tiles: the JAX side pads, the port masks
    "s200-full": (1, 200, 200, 2, 2, 16, False),
    # bottom-right-aligned causal mask (kv_len - q_len != 0)
    "gqa-cross-causal": (1, 64, 192, 4, 2, 16, True),
    # q_len > kv_len: the first 32 rows see no column
    "gqa-masked-rows": (1, 80, 48, 4, 2, 16, True),
}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_bf16_dq_matches_jax(case):
    b, sq, sk, h, hkv, d, causal = FLAT_CASES[case]
    q, k, v, do = _bf16_inputs(
        [(b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)],
        seed=11)
    want = _dq_jax(
        lambda q, k, v: jattn.flash_attention_bshd(q, k, v, causal=causal),
        q, k, v, _to_jax(do))
    got = _dq_torch(
        lambda q, k, v: tattn.flash_attention_bshd(q, k, v, causal=causal),
        q, k, v, (do,))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert _norm_rel(got, want) <= DQ_NORM_REL_TOL
    dead = max(sq - sk, 0) if causal else 0
    assert np.all(got[:, :dead] == 0.0)


def test_bhsd_bf16_dq_with_zigzag_ids_and_dead_rows_matches_jax():
    """Ids from two chunks (as a zigzag ring hop holds them), GQA, an lse
    cotangent, and rows 16..39 that see no column: their dq is exactly 0,
    and every row's dq is within the tolerance of JAX's."""
    b, h, hkv, sq, sk, d = 1, 4, 2, 96, 80, 16
    q, k, v, do = _bf16_inputs(
        [(b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, h, sq, d)],
        seed=12)
    dlse = torch.tensor(np.random.RandomState(13).standard_normal(
        (b, h, sq)).astype(np.float32))
    row_ids = np.concatenate([np.arange(16, 64), np.arange(160, 208)])
    col_ids = np.concatenate([np.arange(40, 80), np.arange(120, 160)])
    dead = row_ids < col_ids.min()
    assert dead.any() and not dead.all()

    def jfn(q, k, v):
        return jattn.flash_attention_lse(
            q, k, v, row_ids=jnp.asarray(row_ids, jnp.int32),
            col_ids=jnp.asarray(col_ids, jnp.int32))

    def tfn(q, k, v):
        return tattn.flash_attention_lse(
            q, k, v, row_ids=torch.tensor(row_ids),
            col_ids=torch.tensor(col_ids))

    want = _dq_jax(jfn, q, k, v, (_to_jax(do), jnp.asarray(dlse.numpy())))
    got = _dq_torch(tfn, q, k, v, (do, dlse))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.all(got[:, :, dead] == 0.0)
    assert _norm_rel(got, want) <= DQ_NORM_REL_TOL
