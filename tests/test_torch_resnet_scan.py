"""The port's ResNet ``scan_stages`` layout
(``mpi_operator_tpu_torch/models/resnet.py``: ``ScannedBlocks``,
``stack_stages``, ``unstack_stages``) against the port's plain model and
the JAX package's scanned model.

- ``stack_stages`` and ``unstack_stages`` are exact inverses, and the
  stacked state dict is the scanned model's (names and shapes);
- the scanned model on the plain model's stacked weights is the plain
  model, bit for bit on the CPU (the same operations in the same order):
  the train-mode logits of two passes, the running statistics each pass
  writes through its slice of the stacked buffers (``ops/bn.py``
  updates them in place), every gradient, and the state after one SGD
  step, on both BN routes; so a scanned checkpoint trains in the plain
  model and the reverse;
- for depth 18 and 50 (their stages and blocks at a quarter of the
  width) on both BN routes (every layer through the
  kernels' plain versions and JAX's Pallas kernels in interpret mode):
  the port's scanned state carried to JAX's tree by ``interop`` has the
  leaves and shapes JAX's scanned init makes (5-D stacked kernels, the
  ``TpuBatchNorm_k`` names inside ``stage{i}_rest``), comes back bit for
  bit, and JAX's scanned model on it gives the port's train-mode logits
  and stacked statistics at rtol 2e-5, atol 2e-5 (the tolerance of
  ``tests/test_models.py``'s scanned test). 64x64 images, batch 4: at
  32x32 and batch 2 the last stage's BN sees two values a channel, which
  spreads f32 rounding past 2e-5 in the plain model already.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import resnet as jresnet
from mpi_operator_tpu_torch import interop
from mpi_operator_tpu_torch.models import resnet as tresnet

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

RTOL = ATOL = 2e-5
IMAGE, BATCH, CLASSES, WIDTH = 64, 4, 10, 16
# A small bottleneck model with every kind of stage: 2 and 3 blocks
# (1 and 2 stacked) and a stage of one block (nothing stacked).
SMALL = dict(stage_sizes=(2, 3, 1, 2), bottleneck=True, num_filters=8,
             num_classes=CLASSES, dtype=torch.float32, device="cpu")


def _images(seed=0, b=BATCH, size=IMAGE):
    x = np.random.RandomState(seed).standard_normal((b, size, size, 3))
    return x.astype(np.float32)


def _nchw(images):
    return torch.tensor(images).permute(0, 3, 1, 2)  # channels_last memory


def _leaves(tree, value=np.asarray):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): value(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _plain_and_scanned(route, **kw):
    """The plain model from a seeded init with every BN scale redrawn
    from U(0.5, 1.5) (the init zeroes each block's last one), and the
    scanned model on its stacked state."""
    plain = tresnet.ResNet(bn_impl=route, bn_pallas_min_elems=0, **kw)
    tresnet.init_params(plain, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in tresnet.bn_layers(plain):
            mod.scale.uniform_(0.5, 1.5, generator=gen)
    scanned = tresnet.ResNet(bn_impl=route, bn_pallas_min_elems=0,
                             scan_stages=True, **kw)
    scanned.load_state_dict(tresnet.stack_stages(plain.state_dict()))
    return plain, scanned


def _depth(depth: int, **kw) -> dict:
    """ResNet-``depth``'s stages and blocks at a quarter of its width."""
    return dict(stage_sizes=tresnet.STAGE_SIZES[depth],
                bottleneck=tresnet.BOTTLENECK[depth], num_filters=WIDTH,
                num_classes=CLASSES, **kw)


@pytest.mark.parametrize("depth", [18, 50])
def test_stack_and_unstack_are_exact_inverses(depth):
    plain = tresnet.ResNet(**_depth(depth, device="cpu"))
    tresnet.init_params(plain, torch.Generator().manual_seed(0))
    state = plain.state_dict()
    stacked = tresnet.stack_stages(state)
    scanned = tresnet.ResNet(**_depth(depth, device="cpu"),
                             scan_stages=True).state_dict()
    assert {k: v.shape for k, v in stacked.items()} == {
        k: v.shape for k, v in scanned.items()}
    inner = "BottleneckBlock_0" if depth == 50 else "BasicBlock_0"
    n_rest = tresnet.STAGE_SIZES[depth][2] - 1
    assert stacked[f"stage2_rest.{inner}.Conv_0.weight"].shape[0] == n_rest
    # The running statistics alone stack under the same names.
    stats = tresnet.stack_stages(dict(plain.named_buffers()))
    assert {k: stacked[k].shape for k in stats} == {
        k: v.shape for k, v in stats.items()}
    back = tresnet.unstack_stages(stacked)
    assert list(back) == list(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_scanned_is_the_plain_model_bit_for_bit(route):
    plain, scanned = _plain_and_scanned(route, **SMALL)
    rest = scanned.get_submodule("stage1_rest.BottleneckBlock_0.Conv_1")
    assert rest.weight.shape[0] == 2
    assert rest.weight[0].is_contiguous(memory_format=torch.channels_last)
    labels = torch.tensor(np.random.RandomState(2).randint(0, CLASSES, BATCH))
    opts = [torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
            for m in (plain, scanned)]
    for seed in (3, 4):  # the second pass reads the stats the first wrote
        x = _nchw(_images(seed))
        want, got = (m.train()(x) for m in (plain, scanned))
        assert torch.equal(got, want)
        for m in (plain, scanned):
            torch.nn.functional.cross_entropy(m(x), labels).backward()
        grads = tresnet.unstack_stages(
            {n: p.grad for n, p in scanned.named_parameters()})
        for name, p in plain.named_parameters():
            assert torch.equal(grads[name], p.grad), name
        for opt in opts:
            opt.step()
            opt.zero_grad()
        moved = tresnet.unstack_stages(scanned.state_dict())
        for name, value in plain.state_dict().items():
            assert torch.equal(moved[name], value), name


@pytest.mark.parametrize("depth,route", [(18, "xla"), (18, "pallas"),
                                         (50, "xla"), (50, "pallas")])
def test_scanned_matches_jax(depth, route):
    model = tresnet.ResNet(**_depth(depth, device="cpu"),
                           dtype=torch.float32, bn_impl=route,
                           bn_pallas_min_elems=0, scan_stages=True)
    tresnet.init_params(model, torch.Generator().manual_seed(0))
    params, stats = interop.resnet_params_to_jax(model.state_dict(),
                                                 bn_impl=route)
    jm = jresnet.ResNet(**_depth(depth), dtype=jnp.float32, bn_impl=route,
                        bn_pallas_min_elems=0, scan_stages=True)
    shapes = jax.eval_shape(lambda: jresnet.create_train_state(
        jm, jax.random.PRNGKey(0), image_size=IMAGE, batch=BATCH))
    for got, want in zip((params, stats), shapes):
        got = _leaves(got, lambda a: (a.shape, a.dtype))
        assert got == _leaves(want, lambda a: (a.shape, a.dtype))
    inner = "BottleneckBlock_0" if depth == 50 else "BasicBlock_0"
    bn = "TpuBatchNorm_0" if route == "pallas" else "BatchNorm_0"
    assert params["stage2_rest"][inner]["Conv_0"]["kernel"].ndim == 5
    assert bn in params["stage2_rest"][inner]
    back = interop.resnet_params_from_jax(params, stats)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for name, value in state.items():
        assert torch.equal(back[name], value), name

    images = _images(seed=5)
    want_logits, want_stats = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(images))
    model.load_state_dict(back)
    with torch.no_grad():
        logits = model.train()(_nchw(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    _, got_stats = interop.resnet_params_to_jax(dict(model.named_buffers()),
                                                bn_impl=route)
    got_stats = _leaves(got_stats)
    want_stats = _leaves(want_stats["batch_stats"])
    assert sorted(got_stats) == sorted(want_stats)
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
