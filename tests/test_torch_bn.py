"""The port's batch norm (``mpi_operator_tpu_torch/ops/bn.py``) against the
JAX package's (``mpi_operator_tpu/ops/bn.py``) on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, with
``pallas_min_elems=0`` where the kernel path is meant; the port's
wrappers take their plain versions for CPU tensors. Tolerances:

- ``Σx`` of zero-mean data cancels, so its error is measured against
  ``Σ|x|`` (relative 1e-5: f32 summation order over ~1e3 terms);
  ``Σx²``, ``Σdy`` and ``Σdy·x̂`` against their own norm (1e-5);
- module outputs, moments and gradients in f32: rtol 1e-4 and atol 1e-5
  (the two frameworks order the f32 reductions differently, and dx
  subtracts near-equal terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mpi_operator_tpu.ops import bn as jbn
from mpi_operator_tpu_torch.ops import _common
from mpi_operator_tpu_torch.ops import bn as tbn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

SUM_REL_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5

# (rows, channels): a ragged M (not a multiple of the JAX 512-row tile or
# of the port's row step) and C=130 (not a multiple of any vector width).
SHAPES = [(777, 130), (1024, 64), (300, 24)]
DTYPES = ["float32", "bfloat16"]


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``
    (bf16 rounded once, by torch, then carried across exactly)."""
    t = torch.tensor(arr).to(getattr(torch, dtype))
    exact = t.float().numpy()
    return t, jnp.asarray(exact).astype(getattr(jnp, dtype))


def _close_sum(got, want, absx):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= SUM_REL_TOL * float(np.asarray(absx).max()) + 1e-6, err


def _close_norm(got, want, tol=SUM_REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want) + 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stats_plain_matches_jax(shape, dtype):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    xt, xj = _pair(x, dtype)
    s, q = tbn.bn_stats(xt)
    js, jq = jbn.bn_stats(xj, tile_m=256)
    assert s.dtype == q.dtype == torch.float32 and s.shape == (shape[1],)
    _close_sum(s, js, np.abs(xt.float().numpy()).sum(0))
    _close_norm(q, jq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grads_plain_matches_jax(shape, dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    xt, xj = _pair(x, dtype)
    dyt, dyj = _pair(dy, dtype)
    mean = xt.float().mean(0)
    inv = torch.rsqrt(xt.float().var(0, unbiased=False) + 1e-5)
    db, dg = tbn.bn_grads(dyt, xt, mean, inv)
    jdb, jdg = jbn.bn_grads(dyj, xj, jnp.asarray(mean.numpy()),
                            jnp.asarray(inv.numpy()), tile_m=256)
    _close_sum(db, jdb, np.abs(dyt.float().numpy()).sum(0))
    _close_norm(dg, jdg)


def test_stats_bf16_accumulates_in_f32():
    # 20k rows of ones in bf16: a bf16 accumulator would stop at 256.
    s, q = tbn.bn_stats(torch.ones(20000, 8, dtype=torch.bfloat16))
    assert s.dtype == torch.float32
    assert torch.all(s == 20000.0) and torch.all(q == 20000.0)


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    tbn.reset_launch_counts()
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    s, q = tbn.bn_stats(x)
    db, dg = tbn.bn_grads(x, x, s / 64, torch.ones(16))
    for got, want in zip((s, q, db, dg),
                         (*tbn.bn_stats_plain(x),
                          *tbn.bn_grads_plain(x, x, s / 64, torch.ones(16)))):
        assert torch.equal(got, want)
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_grads": 0}


@pytest.mark.parametrize("bad", ["rank", "mismatch", "empty", "mean"])
def test_wrappers_refuse_bad_operands(bad):
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        if bad == "rank":
            tbn.bn_stats(torch.zeros(2, 4, 4))
        elif bad == "mismatch":
            tbn.bn_grads(torch.zeros(8, 5), x, torch.zeros(4), torch.ones(4))
        elif bad == "empty":
            tbn.bn_stats(torch.zeros(0, 4))
        else:
            tbn.bn_grads(x, x, torch.zeros(5), torch.ones(4))


def _emulate_kernel_sums(x: np.ndarray, vec, lanes, rows_per_chunk, n_chunks):
    """The CUDA stats kernel's work split, in numpy: which rows and
    channels each (chunk, channel tile, lane, row group) thread reads,
    and the fixed order the partials fold in. Returns (Σx, reads)."""
    m, c = x.shape
    row_step = _common.BN_THREADS // lanes
    tiles = -(-(c // vec) // lanes)
    reads = np.zeros((m, c), np.int64)
    part = np.zeros((n_chunks, c))
    for chunk in range(n_chunks):
        for tile in range(tiles):
            for t in range(_common.BN_THREADS):
                c0 = (tile * lanes + t % lanes) * vec
                if c0 >= c:
                    continue
                end = min(m, (chunk + 1) * rows_per_chunk)
                rows = range(chunk * rows_per_chunk + t // lanes, end, row_step)
                for r in rows:
                    reads[r, c0:c0 + vec] += 1
                    part[chunk, c0:c0 + vec] += x[r, c0:c0 + vec]
    return part.sum(0), reads


@pytest.mark.parametrize("shape,elem", [((777, 130), 4), ((777, 130), 2),
                                        ((3000, 64), 2), ((200, 2048), 2)])
def test_geometry_reads_every_element_once(shape, elem):
    m, c = shape
    vec, lanes, rows, chunks = _common.bn_geometry(m, c, elem)
    assert c % vec == 0 and vec * elem <= 16 and lanes & (lanes - 1) == 0
    assert (chunks - 1) * rows < m <= chunks * rows
    x = np.random.RandomState(2).randn(m, c)
    s, reads = _emulate_kernel_sums(x, vec, lanes, rows, chunks)
    assert np.all(reads == 1)
    np.testing.assert_allclose(s, x.sum(0), rtol=1e-12, atol=1e-9)


def test_geometry_at_the_resnet101_shapes():
    # B=64, 224x224: the stem fills the card along the rows; stage 3's
    # widest layer along both rows and channel tiles; a misaligned
    # pointer drops to narrower loads.
    assert _common.bn_geometry(802816, 64, 2) == (8, 8, 1536, 523)
    assert _common.bn_geometry(3136, 2048, 2) == (8, 32, 64, 49)
    assert _common.bn_geometry(1000, 130, 4) == (2, 32, 64, 16)
    assert _common.bn_geometry(3136, 2048, 2, ((1 << 20) + 4,))[0] == 2


def _x(n=4, h=7, w=7, c=24, seed=0):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32) * 1.5 + 0.3


@pytest.mark.parametrize("c", [24, 130])
def test_fused_batch_norm_forward_and_vjp_match_jax(c):
    rng = np.random.RandomState(3)
    x = _x(c=c)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)

    (jy, jmean, jvar), vjp = jax.vjp(
        lambda x, g, b: jbn.fused_batch_norm(x, g, b, 1e-5),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))

    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, gamma, beta))
    y, mean, var = tbn.fused_batch_norm(xt, gt, bt, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    y.backward(torch.tensor(dy))
    for got, want in ((y, jy), (mean, jmean), (var, jvar), (xt.grad, jdx),
                      (gt.grad, jdg), (bt.grad, jdb)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _flax_kw(**kw):
    return dict(momentum=0.9, epsilon=1e-5, dtype=jnp.float32,
                param_dtype=jnp.float32, **kw)


def _port_module(cls, variables, **kw):
    c = variables["params"]["scale"].shape[0]
    mod = cls(c, momentum=0.9, epsilon=1e-5, dtype=torch.float32, **kw)
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(mod, name).copy_(torch.tensor(np.asarray(variables["params"][name])))
        for name in ("mean", "var"):
            getattr(mod, name).copy_(torch.tensor(np.asarray(variables["batch_stats"][name])))
    return mod


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x).permute(0, 3, 1, 2)  # channels_last memory


MODULE_PAIRS = {
    "pallas": (lambda: jbn.TpuBatchNorm(use_running_average=False,
                                        pallas_min_elems=0, **_flax_kw()),
               lambda v: _port_module(tbn.TpuBatchNorm, v, pallas_min_elems=0)),
    "xla": (lambda: nn.BatchNorm(use_running_average=False, **_flax_kw()),
            lambda v: _port_module(tbn.BatchNorm, v)),
}


@pytest.mark.parametrize("route", sorted(MODULE_PAIRS))
def test_module_train_mode_matches_jax(route):
    """Output, running-stat update, parameter and input gradients."""
    make_jax, make_port = MODULE_PAIRS[route]
    x = _x()
    dy = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jmod = make_jax()
    v = {"params": {"scale": jnp.asarray(np.random.RandomState(5).rand(24) + 0.5,
                                         jnp.float32),
                    "bias": jnp.asarray(np.random.RandomState(6).randn(24),
                                        jnp.float32)},
         "batch_stats": {"mean": jnp.full((24,), 0.25), "var": jnp.full((24,), 2.0)}}

    def fwd(params, xx):
        y, upd = jmod.apply({**v, "params": params}, xx, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    jy, jstats = fwd(v["params"], jnp.asarray(x))
    gp, gx = jax.vjp(lambda p, xx: fwd(p, xx)[0], v["params"],
                     jnp.asarray(x))[1](jnp.asarray(dy))

    mod = make_port(v)
    xt = _nchw(x).requires_grad_()
    y = mod(xt)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y.backward(_nchw(dy))
    to_nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(to_nhwc(y), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(),
                                   np.asarray(gp[name]), rtol=RTOL, atol=ATOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod, name).numpy(),
                                   np.asarray(jstats[name]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", sorted(MODULE_PAIRS))
def test_module_eval_mode_uses_running_stats(route):
    x = _x(seed=7)
    make_jax, make_port = MODULE_PAIRS[route]
    jmod = make_jax().clone(use_running_average=True)
    v = {"params": {"scale": jnp.linspace(0.5, 1.5, 24), "bias": jnp.linspace(-1, 1, 24)},
         "batch_stats": {"mean": jnp.linspace(-0.2, 0.2, 24),
                         "var": jnp.linspace(0.5, 3.0, 24)}}
    want = jmod.apply(v, jnp.asarray(x))
    mod = make_port(v).eval()
    before = (mod.mean.clone(), mod.var.clone())
    with torch.no_grad():
        got = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(mod.mean, before[0]) and torch.equal(mod.var, before[1])


@pytest.mark.parametrize("min_elems", [0, 10**9])
def test_batch_norm_train_routing(monkeypatch, min_elems):
    """pallas_min_elems routes statically: at or above it through the
    kernels' wrappers, below it through plain reductions; both agree
    with the JAX function under the same threshold."""
    calls = []
    real = tbn.bn_stats
    monkeypatch.setattr(tbn, "bn_stats", lambda x2d: calls.append(1) or real(x2d))
    x = _x(seed=8)
    g = np.linspace(0.5, 1.5, 24).astype(np.float32)
    b = np.linspace(-1, 1, 24).astype(np.float32)
    y, mean, var = tbn.batch_norm_train(torch.tensor(x), torch.tensor(g),
                                        torch.tensor(b), 1e-5,
                                        pallas_min_elems=min_elems)
    assert len(calls) == (1 if min_elems == 0 else 0)
    jy, jmean, jvar = jbn.batch_norm_train(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b), 1e-5,
                                           pallas_min_elems=min_elems)
    for got, want in ((y, jy), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_port_default_sends_every_layer_through_the_kernels():
    assert tbn.PALLAS_MIN_ELEMS == 0
    assert tbn.TpuBatchNorm(8).pallas_min_elems == 0


def test_rows_operand_is_a_view_under_channels_last():
    x = torch.randn(2, 16, 5, 5).to(memory_format=torch.channels_last)
    rows = tbn._rows(x.movedim(1, -1))
    assert rows.shape == (50, 16) and rows.data_ptr() == x.data_ptr()


def test_require_single_device():
    tbn.require_single_device(1)
    with pytest.raises(SystemExit, match="single-device"):
        tbn.require_single_device(2)
