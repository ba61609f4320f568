"""The port's ResNet ``space_to_depth`` stem
(``mpi_operator_tpu_torch/models/resnet.py``) against the JAX package's.

- ``s2d_stem_kernel``, the port's own numpy copy, equals JAX's exactly,
  and ``s2d_stem_weight`` is the same map in the port's [O, C, kh, kw]
  layout (bit for bit against JAX's kernel carried across by
  ``interop``);
- the regroup (``space_to_depth``, on the channels-last view of
  ``[N, C, H, W]``) equals JAX's NHWC regroup exactly, channel order
  ``(dy, dx, c)``; odd spatial dims raise JAX's ``ValueError``;
- the port's s2d model with the mapped stem is the port's plain model
  (as ``tests/test_models.py`` holds it for JAX): f32 logits at rtol
  1e-5, atol 1e-5, the same 147 nonzero taps summed in another order;
- resnet18 with ``space_to_depth=True``, f32, on both BN routes, from
  the port's init carried to JAX's tree by ``interop`` (its leaves and
  shapes those JAX's init makes) and back: the train-mode logits and
  the updated batch statistics at rtol 2e-5, atol 2e-5 (the tolerance of
  ``tests/test_models.py``'s scanned test); on the ``xla`` route also
  the loss at rtol 1e-5 and the parameters after one ``optax.sgd(0.1)``
  step against ``torch.optim.SGD(lr=0.1)`` at rtol 2e-5, atol 2e-5.
  64x64 images, batch 4: at 32x32 and batch 2 the last stage's BN sees
  two values a channel, which spreads f32 rounding past 2e-5 in the
  plain model already.
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

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

RTOL = ATOL = 2e-5
LOSS_RTOL = 1e-5
MAPPED_TOL = 1e-5
IMAGE, BATCH, CLASSES, LR = 64, 4, 10, 0.1


def _images(seed=0, b=BATCH, h=IMAGE, w=IMAGE):
    return np.random.RandomState(seed).standard_normal(
        (b, h, w, 3)).astype(np.float32)


def _nchw(images):
    return torch.tensor(images).permute(0, 3, 1, 2)  # channels_last memory


def _leaves(tree, value=np.asarray):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): value(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _shapes(tree):
    return _leaves(tree, lambda leaf: tuple(leaf.shape))


def test_stem_kernel_is_jaxs_exactly():
    k7 = np.random.RandomState(0).standard_normal((7, 7, 3, 8)).astype(
        np.float32)
    got, want = tresnet.s2d_stem_kernel(k7), jresnet.s2d_stem_kernel(k7)
    assert got.shape == (4, 4, 12, 8) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # The port's layout: [O, C, 7, 7] -> [O, 12, 4, 4], as interop
    # carries JAX's [4, 4, 12, O] kernel across.
    w7 = torch.tensor(k7).permute(3, 2, 0, 1)
    weight = tresnet.s2d_stem_weight(w7)
    carried = interop.resnet_params_from_jax(
        {"conv_init": {"kernel": want}})["conv_init.weight"]
    assert weight.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(weight, carried)


def test_regroup_is_jaxs_exactly():
    x = _images(b=2, h=8, w=6)
    b, h, w, c = x.shape
    # mpi_operator_tpu/models/resnet.py's NHWC regroup.
    want = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    got = tresnet.space_to_depth(_nchw(x))
    assert got.shape == (b, 4 * c, h // 2, w // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_odd_spatial_dims_raise_jaxs_error():
    x = _images(b=1, h=34, w=33)
    jm = jresnet.resnet(18, num_classes=CLASSES, space_to_depth=True)
    with pytest.raises(ValueError) as want:
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = tresnet.resnet(18, num_classes=CLASSES, space_to_depth=True,
                           dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as got:
        model(_nchw(x))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mapped_stem_is_the_plain_model(train):
    plain = tresnet.resnet(18, num_classes=CLASSES, dtype=torch.float32,
                           device="cpu")
    tresnet.init_params(plain, torch.Generator().manual_seed(0))
    state = plain.state_dict()
    state["conv_init.weight"] = tresnet.s2d_stem_weight(
        state["conv_init.weight"])
    s2d = tresnet.resnet(18, num_classes=CLASSES, dtype=torch.float32,
                         space_to_depth=True, device="cpu")
    s2d.load_state_dict(state)
    x = _nchw(_images(seed=1))
    with torch.no_grad():
        want = plain.train(train)(x)
        got = s2d.train(train)(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MAPPED_TOL,
                               atol=MAPPED_TOL)
    for name, buf in plain.named_buffers():
        np.testing.assert_allclose(s2d.get_buffer(name).numpy(), buf.numpy(),
                                   rtol=MAPPED_TOL, atol=MAPPED_TOL,
                                   err_msg=name)


def _port_model(route):
    return tresnet.resnet(18, num_classes=CLASSES, dtype=torch.float32,
                          space_to_depth=True, bn_impl=route,
                          bn_pallas_min_elems=0, device="cpu")


@functools.lru_cache(maxsize=None)
def _variables(route):
    """(params, batch_stats) numpy trees in Flax's layout from the port's
    init; cached, read only."""
    model = _port_model(route)
    tresnet.init_params(model, torch.Generator().manual_seed(0))
    return interop.resnet_params_to_jax(model.state_dict(), bn_impl=route)


def _jax_value_and_grad(route):
    model = jresnet.resnet(18, num_classes=CLASSES, dtype=jnp.float32,
                           space_to_depth=True, bn_impl=route,
                           bn_pallas_min_elems=0)

    def loss_fn(params, stats, images, labels):
        logits, upd = model.apply({"params": params, "batch_stats": stats},
                                  images, train=True, mutable=["batch_stats"])
        one_hot = jax.nn.one_hot(labels, logits.shape[-1])
        loss = -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), -1))
        return loss, (logits, upd["batch_stats"])
    return model, jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_forward_stats_and_sgd_step_match_jax(route):
    params, stats = _variables(route)
    jm, value_and_grad = _jax_value_and_grad(route)
    shapes = jax.eval_shape(lambda: jresnet.create_train_state(
        jm, jax.random.PRNGKey(0), image_size=IMAGE, batch=BATCH))
    for got, want in zip((params, stats), shapes):
        assert _shapes(got) == _shapes(want)
    assert params["conv_init"]["kernel"].shape == (4, 4, 12, 64)

    images = _images(seed=2)
    labels = np.random.RandomState(3).randint(0, CLASSES, BATCH)
    (want_loss, (want_logits, want_stats)), grads = value_and_grad(
        params, stats, jnp.asarray(images), jnp.asarray(labels))

    model = _port_model(route)
    model.load_state_dict(interop.resnet_params_from_jax(params, stats))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    logits = model.train()(_nchw(images))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(labels))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    _, got_stats = interop.resnet_params_to_jax(dict(model.named_buffers()),
                                                bn_impl=route)
    got_stats, want_stats = _leaves(got_stats), _leaves(want_stats)
    assert sorted(got_stats) == sorted(want_stats)
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    if route != "xla":
        return
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    optimizer = optax.sgd(LR)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    want_params = _leaves(optax.apply_updates(params, updates))
    loss.backward()
    opt.step()
    got_params, _ = interop.resnet_params_to_jax(model.state_dict(),
                                                 bn_impl=route)
    got_params = _leaves(got_params)
    assert sorted(got_params) == sorted(want_params)
    for name, want in want_params.items():
        np.testing.assert_allclose(got_params[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
