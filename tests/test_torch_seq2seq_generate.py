"""The port's seq2seq decoding (``models/seq2seq_generate.py``) against the
JAX package's (``tests/test_seq2seq.py:TestSeq2SeqDecode``), on
carried-across ``seq2seq-tiny`` weights, f32 and the dense attention
oracle on both sides.

``encode`` and the teacher-forced decode logits at atol 1e-5 rtol 1e-5
against JAX's functions, and the logits against the port's training
forward at JAX's own bound (atol 1e-4 rtol 1e-4); greedy tokens equal
JAX's ``generate`` list for list and are the training forward's argmax
over the generated prefix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import seq2seq as js2s
from mpi_operator_tpu.models import seq2seq_generate as jgen
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import seq2seq as ts2s
from mpi_operator_tpu_torch.models import seq2seq_generate as tgen

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)


def _pair(seed=0):
    cfg = js2s.tiny()
    params = js2s.init_params(js2s.Seq2Seq(cfg), jax.random.PRNGKey(seed))
    tmodel = ts2s.Seq2Seq(ts2s.tiny(), device="cpu")
    tmodel.load_state_dict(interop.seq2seq_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, tmodel


def _batch(b=2, src=16, dec=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, 128, (b, src)).astype(np.int32),
            rng.randint(1, 128, (b, dec)).astype(np.int32))


def test_encode_matches_jax():
    cfg, params, tmodel = _pair()
    src, _ = _batch()
    want = jgen.encode(params, cfg, jnp.asarray(src))
    got = tgen.encode(tmodel, torch.tensor(src))
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_logits_match_jax_and_the_forward(seed):
    cfg, params, tmodel = _pair(seed)
    src, dec = _batch(seed=seed)
    want = jgen.decode_logits_teacher_forced(params, cfg, jnp.asarray(src),
                                             jnp.asarray(dec))
    got = tgen.decode_logits_teacher_forced(tmodel, torch.tensor(src),
                                            torch.tensor(dec))
    assert got.shape == (2, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with torch.no_grad():
        fwd = tmodel(torch.tensor(src), torch.tensor(dec))
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("b,src_len,max_new", [(2, 12, 5), (3, 7, 9)])
def test_greedy_tokens_equal_jax(b, src_len, max_new):
    cfg, params, tmodel = _pair(3)
    src, _ = _batch(b=b, src=src_len, seed=5)
    want = np.asarray(jgen.generate(params, jnp.asarray(src), cfg,
                                    max_new=max_new))
    got = tgen.generate(tmodel, torch.tensor(src), max_new)
    assert got.tolist() == want.tolist()
    # The training forward over the generated prefix agrees: each token
    # is its argmax.
    dec_in = torch.cat([torch.zeros(b, 1, dtype=torch.long), got[:, :-1]],
                       dim=1)
    with torch.no_grad():
        logits = tmodel(torch.tensor(src), dec_in)
    assert torch.equal(logits.argmax(-1), got)


def test_cross_kv_is_computed_once_per_layer():
    cfg, _, tmodel = _pair()
    src, _ = _batch()
    enc = tgen.encode(tmodel, torch.tensor(src))
    self_caches, cross = tgen.init_caches(tmodel, enc, 2, 6)
    assert len(self_caches) == len(cross) == cfg.n_dec_layers
    assert self_caches[0][0].shape == (2, 6, cfg.n_heads, cfg.head_dim)
    assert cross[0][0].shape == (2, 16, cfg.n_heads, cfg.head_dim)
