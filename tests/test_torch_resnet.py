"""The port's ResNet (``mpi_operator_tpu_torch/models/resnet.py``) against
the JAX package's, on weights carried across through ``interop``.

Two small models at 32x32, batch 4, f32: a bottleneck
``ResNet(stage_sizes=(1,1,1,1), num_filters=8, num_classes=10)`` (17 BN
layers, every one with a projection-free or projected shortcut, the
stride-2 (0, 1)-padded 3x3s) and its ``BasicBlock`` twin, each on both BN
routes (``pallas``: the JAX kernels in interpret mode against the port's
plain versions, every layer through them; ``xla``: ``nn.BatchNorm``
against the port's plain-op module). Every BN scale is redrawn away from
its init (Flax zeroes each block's last one, which would zero most
gradients) before the weights cross.

Tolerances, f32 (convolutions and reductions over ~1e2-1e3 terms
summed in another order, through ~10 layers): logits norm-relative
1e-4, loss rtol 1e-5; per-leaf gradients and new batch stats
norm-relative 2e-4 (a BN bias gradient is a Σdy that cancels to ~1e-2 of
its terms); the 3-step SGD-nesterov loss curve (lr 0.01) rtol 1e-3: the
bottleneck model amplifies f32 rounding step by step, so that the JAX
package's own two BN routes differ by 3.3e-4 at step 3 on the same
weights. bf16 forward: bf16 rounds every activation at different points
in the two frameworks, and either run's logits land 3-6% (norm-relative)
from the f32 logits; the port's may lie at most 2x as far from the JAX
f32 logits as the JAX bf16 run does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_operator_tpu.models import resnet as jresnet
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import resnet as tresnet
from mpi_operator_tpu_torch.ops import bn as tbn

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

LOGIT_NORM_REL_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_NORM_REL_TOL = 2e-4
CURVE_RTOL = 1e-3
BF16_ERROR_RATIO = 2.0

CASES = [(bottleneck, route) for bottleneck in (True, False)
         for route in ("xla", "pallas")]
CASE_IDS = [f"{'bottleneck' if b else 'basic'}-{r}" for b, r in CASES]


def _jax_model(bottleneck, route, dtype=jnp.float32):
    return jresnet.ResNet(stage_sizes=(1, 1, 1, 1), bottleneck=bottleneck,
                          num_filters=8, num_classes=10, dtype=dtype,
                          bn_impl=route, bn_pallas_min_elems=0)


def _port_model(bottleneck, route, dtype=torch.float32):
    return tresnet.ResNet((1, 1, 1, 1), bottleneck=bottleneck, num_filters=8,
                          num_classes=10, dtype=dtype, bn_impl=route,
                          bn_pallas_min_elems=0, device="cpu")


@functools.lru_cache(maxsize=None)
def _variables(bottleneck, route):
    """(params, batch_stats) as numpy trees in Flax's layout: the port's
    init_params from a seeded generator, every BN scale then redrawn from
    U(0.5, 1.5), carried across by ``interop``. Cached: read only."""
    model = _port_model(bottleneck, route)
    tresnet.init_params(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for mod in tresnet.bn_layers(model):
            mod.scale.uniform_(0.5, 1.5, generator=gen)
    return interop.resnet_params_to_jax(model.state_dict(), bn_impl=route)


@functools.lru_cache(maxsize=None)
def _jax_loss(bottleneck, route, dtype="float32"):
    """Jitted (loss, (logits, new batch_stats)), grads of the JAX model."""
    model = _jax_model(bottleneck, route, getattr(jnp, dtype))

    def loss_fn(params, stats, images, labels):
        logits, upd = model.apply({"params": params, "batch_stats": stats},
                                  images, train=True, mutable=["batch_stats"])
        one_hot = jax.nn.one_hot(labels, logits.shape[-1])
        loss = -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), -1))
        return loss, (logits, upd["batch_stats"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    return images, rng.randint(0, 10, (b,))


def _loaded(bottleneck, route, params, stats, **kw):
    model = _port_model(bottleneck, route, **kw)
    model.load_state_dict(interop.resnet_params_from_jax(params, stats))
    return model


def _images(images):
    return torch.tensor(images).permute(0, 3, 1, 2)  # channels_last memory


def _leaves(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_interop_round_trip_is_bit_for_bit(route):
    """The port's names carry across to the Flax tree the JAX model
    initializes (both spellings of the block norms, every leaf's shape
    and type), and back, bit for bit."""
    want = jax.eval_shape(
        lambda: jresnet.create_train_state(
            _jax_model(True, route), jax.random.PRNGKey(0), image_size=32,
            batch=4))
    params, stats = _variables(True, route)
    for got, ref in ((params, want[0]), (stats, want[1])):
        got = {k: (v.shape, v.dtype) for k, v in _leaves(got).items()}
        ref = {
            "/".join(str(getattr(k, "key", k)) for k in path): (a.shape, a.dtype)
            for path, a in jax.tree_util.tree_leaves_with_path(ref)
        }
        assert got == ref
    model = _loaded(True, route, params, stats)  # strict: names and shapes
    back = interop.resnet_params_to_jax(model.state_dict(), bn_impl=route)
    for got, ref in zip(back, (params, stats)):
        got, ref = _leaves(got), _leaves(ref)
        assert sorted(got) == sorted(ref)
        for name, arr in ref.items():
            assert got[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
    kernel = params["stage1_block0"]["Conv_1"]["kernel"]   # [kh, kw, in, out]
    assert model.stage1_block0.Conv_1.weight.shape == (
        kernel.shape[3], kernel.shape[2], *kernel.shape[:2])
    assert any(k.startswith("TpuBatchNorm_") == (route == "pallas")
               for k in params["stage0_block0"])


def _port_step(model, images, labels):
    logits = model(_images(images))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(labels))
    loss.backward()
    return logits, loss


@pytest.mark.parametrize("bottleneck,route", CASES, ids=CASE_IDS)
def test_logits_loss_gradients_and_batch_stats_match_jax(bottleneck, route):
    params, stats = _variables(bottleneck, route)
    images, labels = _batch()
    (want_loss, (want_logits, want_stats)), want_grads = _jax_loss(
        bottleneck, route)(params, stats, jnp.asarray(images),
                           jnp.asarray(labels))

    model = _loaded(bottleneck, route, params, stats).train()
    logits, loss = _port_step(model, images, labels)

    assert logits.shape == want_logits.shape
    assert _norm_rel(logits.detach().numpy(), want_logits) <= LOGIT_NORM_REL_TOL
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    got_grads, _ = interop.resnet_params_to_jax(
        {n: p.grad for n, p in model.named_parameters()}, bn_impl=route)
    _, got_stats = interop.resnet_params_to_jax(dict(model.named_buffers()),
                                                bn_impl=route)
    for got, want in ((got_grads, want_grads), (got_stats, want_stats)):
        got, want = _leaves(got), _leaves(want)
        assert sorted(got) == sorted(want)
        worst = max((_norm_rel(got[k], want[k]), k) for k in want)
        assert worst[0] <= GRAD_NORM_REL_TOL, worst


@pytest.mark.parametrize("bottleneck,route", CASES, ids=CASE_IDS)
def test_three_sgd_nesterov_steps_match_jax(bottleneck, route):
    """``optax.sgd(lr, momentum=0.9, nesterov=True)`` on the JAX model's
    gradients (the update ``jresnet.make_train_step`` makes, here around
    the one compiled loss-and-gradient function) against
    ``torch.optim.SGD(momentum=0.9, nesterov=True)`` through the port's
    ``make_train_step``."""
    lr = 0.01
    params, stats = _variables(bottleneck, route)
    images, labels = _batch(seed=1)
    model = _loaded(bottleneck, route, params, stats).train()

    value_and_grad = _jax_loss(bottleneck, route)
    optimizer = optax.sgd(lr, momentum=0.9, nesterov=True)
    opt_state = optimizer.init(params)
    want = []
    for _ in range(3):
        (loss, (_, stats)), grads = value_and_grad(
            params, stats, jnp.asarray(images), jnp.asarray(labels))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    topt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                           nesterov=True, dampening=0, weight_decay=0)
    tstep = tresnet.make_train_step(model, topt)
    got = [float(tstep(_images(images), torch.tensor(labels)))
           for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bf16_forward_matches_jax(route):
    params, stats = _variables(True, route)
    images, labels = _batch(seed=2)
    args = (params, stats, jnp.asarray(images), jnp.asarray(labels))
    (_, (want, _)), _ = _jax_loss(True, route, "bfloat16")(*args)
    (_, (exact, _)), _ = _jax_loss(True, route)(*args)
    model = _loaded(True, route, params, stats, dtype=torch.bfloat16).train()
    with torch.no_grad():
        got = model(_images(images))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # As close to the f32 logits as the JAX package's own bf16 run is.
    assert _norm_rel(got.numpy(), exact) <= (
        BF16_ERROR_RATIO * _norm_rel(want, exact))


def test_bn_operands_are_views_under_channels_last():
    """Every BN layer's input is channels_last, so its [M, C] operand is
    the activation itself (same data_ptr, no copy)."""
    model = _port_model(True, "pallas").to(memory_format=torch.channels_last)
    seen = []

    def hook(mod, args):
        x = args[0]
        rows = tbn._rows(x.movedim(1, -1))
        seen.append(x.is_contiguous(memory_format=torch.channels_last)
                    and rows.data_ptr() == x.data_ptr())

    for mod in tresnet.bn_layers(model):
        mod.register_forward_pre_hook(hook)
    model(_images(_batch()[0]))
    assert len(seen) == 17 and all(seen)


def test_unported_options_raise():
    for kw in ({"space_to_depth": True}, {"scan_stages": True}):
        with pytest.raises(NotImplementedError, match="queue \\(a\\) item 18"):
            tresnet.resnet(18, device="meta", **kw)
    with pytest.raises(ValueError, match="unknown bn_impl"):
        tresnet.resnet(18, bn_impl="cuda", device="meta")


def test_resnet101_has_104_bn_layers_and_the_jax_flops():
    model = tresnet.resnet101(device="meta")
    assert len(tresnet.bn_layers(model)) == 104
    assert sum(p.numel() for p in model.parameters()) == 44_549_160
    for depth in (18, 50, 101):
        assert tresnet.flops_per_image(depth, 160) == jresnet.flops_per_image(
            depth, 160)


@pytest.mark.parametrize("size,k,stride", [(56, 3, 2), (28, 3, 2), (14, 3, 2),
                                           (7, 3, 1), (56, 1, 2), (9, 3, 2)])
def test_same_padding_is_flax_s(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert tresnet._same_pads(size, k, stride) == tuple(want)


def test_init_params_follows_flax_distributions_and_seed():
    def init(seed):
        model = tresnet.ResNet((1, 1, 1, 1), bottleneck=False,
                               num_filters=32, num_classes=100,
                               dtype=torch.float32, device="cpu")
        return tresnet.init_params(model, torch.Generator().manual_seed(seed))

    a, b, c = init(0), init(0), init(1)
    last = {f"stage{i}_block0.BatchNorm_1.scale" for i in range(4)}
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        if name.endswith(("mean", "var")):
            continue
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):
            assert torch.all(pa == (0.0 if name in last else 1.0)), name
            continue
        if name.endswith("bias"):
            assert torch.all(pa == 0.0), name
            continue
        assert not torch.equal(pa, pc), name
        fan_in = pa[0].numel()
        np.testing.assert_allclose(float(pa.std()), fan_in ** -0.5, rtol=0.1,
                                   err_msg=name)
        limit = 2 * fan_in ** -0.5 / 0.87962566103423978
        assert float(pa.abs().max()) <= limit + 1e-6, name
    for mod in tresnet.bn_layers(a):
        assert torch.all(mod.mean == 0) and torch.all(mod.var == 1)
