"""The flash kernels' id path: tiles classified by id range, and the
kernels' plain versions with unsorted ids against the JAX package.

- ``tile_classes`` (``ops/attention.py``), the plain version of the
  classification the CUDA bodies make (``csrc/flash_common.cuh:
  live_tiles``), against the brute-force mask ``_mask`` at every tiling
  the bodies walk (128 x 64 forward and dq, 64 x 128 dk/dv, 64 x 64 f32)
  and a small one: a dead tile pair has no visible pair, a full one no
  masked pair and lies inside both sequences, a mixed one is neither.
  Ids: the contiguous and the zigzag ring's hops (``_shard_ids``, and the
  zigzag positions from ``zigzag_indices``), random unsorted ids, ±2^30
  padding ids, and a hop in which nothing is visible.
- The kernels' walk, emulated in PyTorch on those classes (only live
  tiles visited, the mask only on mixed ones), against the plain
  versions: the forward's out and lse, dq, and dk/dv at f32, atol 2e-5
  (sums in another order).
- The flat (``flash_attention_bshd_lse``) and ``[B, H, S, D]``
  (``flash_attention_lse``) paths with unsorted ids, padding ids and an
  all-dead hop, and an lse cotangent, against JAX's in interpret mode:
  out and lse atol 2e-5, gradients atol 1e-4, the tolerances of
  ``tests/test_torch_ring_attention.py``.
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
PAD = 2 ** 30  # the JAX package's _ID_PAD
# (q rows, k rows) of the tiles the bodies classify on, and a small one.
TILINGS = [(128, 64), (64, 128), (64, 64), (16, 8)]


@pytest.fixture(autouse=True)
def _reference_flat_path(monkeypatch):
    """The reference's ``_flat_pack`` reads ``os.environ`` but its module
    never imports ``os`` (``tests/test_torch_attention.py``): supply the
    missing module global for the duration of a test."""
    monkeypatch.setattr(jattn, "os", os, raising=False)


def _random_ids(n, seed, pad=0):
    """n unsorted ids from a permutation of 0..2n-1 (seeded), the last
    three ``pad`` when given."""
    ids = np.random.RandomState(seed).permutation(2 * n)[:n].astype(np.int32)
    if pad:
        ids[-3:] = pad
    return torch.from_numpy(ids)


def _id_cases():
    """name -> (row_ids, col_ids) over 256 rows and 200 columns at most."""
    cases = {}
    for n in (2, 4):
        s_loc = 512 // n
        for layout in ("contiguous", "zigzag"):
            for rank in range(n):
                for src in range(n):
                    cases[f"{layout}-n{n}-r{rank}-s{src}"] = tuple(
                        tring._shard_ids(i, n, s_loc, layout == "zigzag")
                        for i in (rank, src))
    cases["random"] = (_random_ids(256, 1), _random_ids(200, 2))
    cases["random-padded"] = (_random_ids(256, 3, -PAD),
                              _random_ids(200, 4, PAD))
    # Row blocks of 64 shuffled within, ordered across: every class.
    blocks = torch.cat([i * 1000 + torch.from_numpy(
        np.random.RandomState(i).permutation(64)) for i in range(4)])
    cases["blocks"] = (blocks.int(), (blocks[:200] + 5).int())
    cases["all-dead"] = (torch.arange(256, dtype=torch.int32),
                         torch.arange(1000, 1200, dtype=torch.int32))
    return cases


CASES = _id_cases()


@pytest.mark.parametrize("tiling", TILINGS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_classes_are_exact(case, tiling):
    row, col = CASES[case]
    tq, tk = tiling
    q_len, kv_len = len(row), len(col)
    mask = tattn._mask(torch.zeros(1, q_len), torch.zeros(1, kv_len), False,
                       row, col)
    cls = tattn.tile_classes(row, col, q_len, kv_len, tq, tk)
    assert cls.shape == (-(-q_len // tq), -(-kv_len // tk))
    for i in range(cls.shape[0]):
        for j in range(cls.shape[1]):
            tile = mask[i * tq:(i + 1) * tq, j * tk:(j + 1) * tk]
            inside = (i + 1) * tq <= q_len and (j + 1) * tk <= kv_len
            want = (tattn.TILE_DEAD if not bool(tile.any()) else
                    tattn.TILE_FULL if inside and bool(tile.all()) else
                    tattn.TILE_MIXED)
            assert int(cls[i, j]) == want, (case, tiling, i, j)


def test_zigzag_ids_are_the_zigzag_permutation():
    """``_shard_ids`` with zigzag gives rank r the positions that
    ``zigzag_indices`` puts in its shard."""
    for n in (2, 4):
        perm = tring.zigzag_indices(512, n).reshape(n, -1)
        for rank in range(n):
            np.testing.assert_array_equal(
                tring._shard_ids(rank, n, 512 // n, True).numpy(), perm[rank])


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_hops_mix_only_the_diagonal(layout):
    """On a ring's ids, with tiles that divide a half chunk, a hop on its
    own shard mixes only the diagonal tiles and every other hop none."""
    n, s_loc = 4, 256
    for tq, tk in [(64, 64), (128, 64), (64, 128)]:
        for rank in range(n):
            for src in range(n):
                row, col = (tring._shard_ids(i, n, s_loc, layout == "zigzag")
                            for i in (rank, src))
                cls = tattn.tile_classes(row, col, s_loc, s_loc, tq, tk)
                mixed = int((cls == tattn.TILE_MIXED).sum())
                want = s_loc // min(tq, tk) if rank == src else 0
                assert mixed == want, (layout, tq, tk, rank, src)


# --- The kernels' walk, emulated ----------------------------------------


def _walk_forward(q, k, v, row, col, scale, tq, tk):
    """The forward bodies' loop on one head (q [Sq, D], k, v [Sk, D]):
    per q tile, an online softmax over its live k tiles only, the mask on
    mixed tiles only. (out, lse)."""
    cls = tattn.tile_classes(row, col, len(row), len(col), tq, tk)
    out = torch.zeros_like(q)
    lse = torch.full((q.shape[0],), tattn.NEG_INF, dtype=q.dtype)
    for i in range(cls.shape[0]):
        rows = slice(i * tq, (i + 1) * tq)
        qi = q[rows]
        m = torch.full((qi.shape[0], 1), tattn.NEG_INF, dtype=q.dtype)
        l = torch.zeros(qi.shape[0], 1, dtype=q.dtype)
        acc = torch.zeros_like(qi)
        for j in range(cls.shape[1]):
            if cls[i, j] == tattn.TILE_DEAD:
                continue
            cols = slice(j * tk, (j + 1) * tk)
            s = qi @ k[cols].T * scale
            vis = torch.ones_like(s, dtype=torch.bool)
            if cls[i, j] == tattn.TILE_MIXED:
                vis = col[cols][None, :] <= row[rows][:, None]
            m_new = torch.maximum(
                m, torch.where(vis, s, tattn.NEG_INF).amax(1, keepdim=True))
            p = torch.where(vis, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(1, keepdim=True)
            acc = corr * acc + p @ v[cols]
            m = m_new
        live = l[:, 0] > 0
        out[rows] = torch.where(live[:, None], acc / torch.where(
            live[:, None], l, 1.0), 0.0)
        lse[rows] = torch.where(live, m[:, 0] + torch.log(
            torch.where(live, l[:, 0], 1.0)), tattn.NEG_INF)
    return out, lse


def _walk_grads(q, k, v, do, lse, delta, row, col, scale):
    """dq by the dq bodies' walk (q tiles of 128 over their live k tiles
    of 64) and dk, dv by the dk/dv bodies' (k tiles of 128 over their live
    q tiles of 64), on one head."""
    def probs(rows, cols, full):
        s = q[rows] @ k[cols].T * scale
        p = torch.exp(s - lse[rows][:, None])
        if not full:
            p = torch.where(col[cols][None, :] <= row[rows][:, None], p, 0.0)
        ds = p * (do[rows] @ v[cols].T - delta[rows][:, None])
        return p, ds

    dq = torch.zeros_like(q)
    cls = tattn.tile_classes(row, col, len(row), len(col), 128, 64)
    for i, j in zip(*torch.nonzero(cls != tattn.TILE_DEAD, as_tuple=True)):
        rows, cols = slice(i * 128, (i + 1) * 128), slice(j * 64, (j + 1) * 64)
        _, ds = probs(rows, cols, bool(cls[i, j] == tattn.TILE_FULL))
        dq[rows] += scale * ds @ k[cols]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    cls = tattn.tile_classes(row, col, len(row), len(col), 64, 128)
    for i, j in zip(*torch.nonzero(cls != tattn.TILE_DEAD, as_tuple=True)):
        rows, cols = slice(i * 64, (i + 1) * 64), slice(j * 128, (j + 1) * 128)
        p, ds = probs(rows, cols, bool(cls[i, j] == tattn.TILE_FULL))
        dv[cols] += p.T @ do[rows]
        dk[cols] += scale * ds.T @ q[rows]
    return dq, dk, dv


@pytest.mark.parametrize("case", ["zigzag-n2-r0-s0", "zigzag-n2-r0-s1",
                                  "contiguous-n4-r2-s1", "random-padded",
                                  "blocks", "all-dead"])
def test_kernel_walk_matches_the_plain_versions(case):
    row, col = CASES[case]
    q_len, kv_len, d = len(row), len(col), 16
    rng = np.random.RandomState(7)
    q, do = (torch.from_numpy(rng.standard_normal((1, q_len, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, kv_len, d))
                             .astype(np.float32)) for _ in range(2))
    scale = d ** -0.5
    out, lse = tattn.flash_fwd_plain(q, k, v, 1, scale, False, row, col)
    delta = tattn.flat_delta(do, out, 1)
    dq = tattn.flash_bwd_dq_plain(q, k, v, do, lse, delta, 1, scale, False,
                                  row, col)
    dk, dv = tattn.flash_bwd_dkv_plain(q, k, v, do, lse, delta, 1, scale,
                                       False, row, col)
    for tq, tk in [(128, 64), (64, 64)]:
        w_out, w_lse = _walk_forward(q[0], k[0], v[0], row, col, scale, tq,
                                     tk)
        np.testing.assert_allclose(w_out.numpy(), out[0].numpy(),
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(w_lse.numpy(), lse[0, :, 0].numpy(),
                                   atol=OUT_ATOL, rtol=0)
    got = _walk_grads(q[0], k[0], v[0], do[0], lse[0, :, 0], delta[0, :, 0],
                      row, col, scale)
    for name, g, want in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), want[0].numpy(),
                                   atol=OUT_ATOL, rtol=0, err_msg=name)
    dead = lse[0, :, 0] == tattn.NEG_INF
    assert bool((out[0][dead] == 0).all()) and bool((dq[0][dead] == 0).all())


# --- The plain versions with unsorted ids against JAX ----------------------

B, SQ, SK, H, H_KV, D = 2, 40, 36, 4, 2, 8


def _unsorted_ids(kind):
    """(row_ids, col_ids) int32 numpy: a random permutation of positions
    each, the columns' from 5 so that row 0 (id 0) sees nothing; with
    -2^30 / +2^30 padding ids among them ("padded"), or every column
    after every row ("all-dead")."""
    rng = np.random.RandomState(11)
    row = rng.permutation(60)[:SQ].astype(np.int32)
    row[0] = 0
    col = rng.permutation(60)[:SK].astype(np.int32) + 5
    if kind == "padded":
        row[[3, 17, 30]] = -PAD
        col[[5, 20, 35]] = PAD
    elif kind == "all-dead":
        col = col + 100
    return row, col


@pytest.mark.parametrize("kind", ["random", "padded", "all-dead"])
@pytest.mark.parametrize("layout", ["flat", "bhsd"])
def test_unsorted_ids_match_jax(layout, kind):
    """out, lse and the gradients of ``sum(out * g) + sum(lse * g_lse)``
    (over the rows that see something) with unsorted ids."""
    rng = np.random.RandomState(5)
    shapes = ({"q": (B, SQ, H, D), "k": (B, SK, H_KV, D), "s": (B, SQ, H)}
              if layout == "flat" else
              {"q": (B, H, SQ, D), "k": (B, H_KV, SK, D), "s": (B, H, SQ)})
    q, k, v, g = (rng.standard_normal(shapes[n]).astype(np.float32)
                  for n in ("q", "k", "k", "q"))
    g_lse = rng.standard_normal(shapes["s"]).astype(np.float32)
    row, col = _unsorted_ids(kind)
    jfn, tfn = ((jattn.flash_attention_bshd_lse, tattn.flash_attention_bshd_lse)
                if layout == "flat" else
                (jattn.flash_attention_lse, tattn.flash_attention_lse))

    def jloss(q, k, v):
        out, lse = jfn(q, k, v, row_ids=jnp.asarray(row),
                       col_ids=jnp.asarray(col))
        live = lse > jattn.NEG_INF / 2
        return (jnp.sum(out * g) + jnp.sum(jnp.where(live, lse, 0.0) * g_lse),
                (out, lse))

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfn(tq, tk, tv, row_ids=torch.from_numpy(row),
                   col_ids=torch.from_numpy(col))
    live = lse > tattn.NEG_INF / 2
    if kind == "all-dead":
        assert not bool(live.any())
    else:
        assert bool(live.any()) and not bool(live.all())
    assert bool((lse[~live] == tattn.NEG_INF).all())
    ((out * torch.from_numpy(g)).sum()
     + (torch.where(live, lse, 0.0) * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.detach().numpy()[live.numpy()],
                               np.asarray(jlse)[live.numpy()], atol=OUT_ATOL,
                               rtol=0)
    for got, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=GRAD_ATOL,
                                   rtol=0)
