"""The port's row normalisation (``mpi_operator_tpu_torch/ops/norm.py``):
LayerNorm and RMSNorm, their plain versions and the kernels.

On the CPU: the plain forwards give bit for bit what the models'
expressions gave before the kernels (copied below as ``_old_*``), through
the functions and through ``bert.LayerNorm`` / ``llama.RMSNorm``; the
explicit plain backward formulas match autograd of the plain forwards
(f32 arithmetic in another order: rtol 1e-4 of each row's largest term);
the CPU wrappers launch nothing and count nothing; the kernels' launch
geometry, computed once for each width, types and alignment; the
backward's partial rows from the card's SM count; a DTensor parameter
refused; the first missing library building every missing one.

On the card (``card``; ``python3 -m pytest tests/test_torch_norm.py -m
card --confcutdir=tests``, which keeps the root conftest and its JAX
away): the kernels against the plain versions. Tolerances: y within 1e-5
of its terms' magnitudes (|x rstd scale| + |mean rstd scale| + |bias|:
f32 sums in another order), plus one ulp in bf16 (the kernel rounds once, from its own f32
value); the f32 statistics within 1e-5 of their scale (mean: of mean|x|;
rstd: relative); dscale and dbias within 1e-5 of the sum of their terms'
magnitudes; dx within 1e-5 of its terms' magnitudes, plus one ulp in
bf16. Two backward runs give equal bits.
"""

import re

import pytest
import torch

from mpi_operator_tpu_torch.models import bert, llama
from mpi_operator_tpu_torch.ops import _common, norm
from mpi_operator_tpu_torch.utils import torchtrace

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

WIDTHS = [32, 100, 768, 4096]
EPS = [1e-12, 1e-5]
DTYPES = [torch.float32, torch.float64]
# Constant rows: at each width one of the two has E[x²] − E[x]² < 0 in
# f32, so the clamp cuts its variance out of the gradient.
CONSTANTS = (0.1, 2.9)


def _old_layer_norm(x, scale, bias, eps, dtype):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min(
        (xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale)
    return (y + bias).to(dtype)


def _old_rms_norm(x, scale, eps):
    xf = x.float()
    norm_ = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm_ * scale).to(x.dtype)


def _inputs(width, dtype, seed=0, rows=5):
    """[2, rows + 2, width] rows of random data (offset, so the mean is
    not 0) with two constant rows, and f32 scale and bias."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, rows + 2, width, generator=gen) * 2 + 0.5
    for i, c in enumerate(CONSTANTS):
        x[1, rows + i] = c
    scale = 1 + 0.1 * torch.randn(width, generator=gen)
    bias = 0.1 * torch.randn(width, generator=gen)
    return x.to(dtype), scale, bias


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_plain_forward_is_the_old_expression(kind, width, eps, dtype):
    x, scale, bias = _inputs(width, dtype)
    if kind == "layer":
        want = _old_layer_norm(x, scale, bias, eps, torch.bfloat16)
        got = norm.layer_norm_plain(x, scale, bias, eps, torch.bfloat16)
        module = bert.LayerNorm(width, eps, torch.bfloat16)
        with torch.no_grad():
            module.scale.copy_(scale)
            module.bias.copy_(bias)
    else:
        want = _old_rms_norm(x, scale, eps)
        got = norm.rms_norm_plain(x, scale, eps)
        module = llama.RMSNorm(width, eps)
        with torch.no_grad():
            module.scale.copy_(scale)
    assert got.dtype == want.dtype and torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(module(x), want)


def _close(got, want, terms, rtol=1e-4):
    """|got − want| <= rtol x the largest term of each row."""
    scale = terms.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    err = float(((got.double() - want.double()).abs() / scale).max())
    assert err <= rtol, err


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_plain_backward_matches_autograd(kind, width, eps, dtype):
    x, scale, bias = _inputs(width, dtype, seed=1)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    x.requires_grad_(True)
    scale.requires_grad_(True)
    bias.requires_grad_(True)
    if kind == "layer":
        y = norm.layer_norm_plain(x, scale, bias, eps, torch.float32)
        params = (scale, bias)
    else:
        y = norm.rms_norm_plain(x, scale, eps)
        params = (scale,)
    grads = torch.autograd.grad(y, (x, *params), dy.to(y.dtype))
    with torch.no_grad():
        if kind == "layer":
            mean, rstd = norm.layer_norm_stats_plain(x, eps)
            assert bool((rstd < 0).any())  # a constant row was clamped
            got = norm.layer_norm_bwd_plain(x, dy, mean, rstd, scale)
            xhat = (x.float() - mean[..., None]) * rstd.abs()[..., None]
        else:
            rstd = norm.rms_norm_stats_plain(x, eps)
            got = norm.rms_norm_bwd_plain(x, dy, rstd, scale)
            xhat = x.float() * rstd[..., None]
        g = dy * scale
        assert got[0].dtype == x.dtype
        _close(got[0], grads[0], rstd.abs()[..., None] * g)
        _close(got[1], grads[1], (dy * xhat).abs().sum((0, 1)))
        if kind == "layer":
            _close(got[2], grads[2], dy.abs().sum((0, 1)))


def test_cpu_wrappers_take_the_plain_path_and_count_calls():
    x, scale, bias = _inputs(64, torch.float32)
    norm.reset_launch_counts()
    torchtrace.arm_ranges(True)
    try:
        y = norm.layer_norm(x, scale, bias, 1e-12, torch.bfloat16)
        z = norm.rms_norm(x, scale, 1e-5)
        counts = torchtrace.counts()
    finally:
        torchtrace.arm_ranges(False)
    assert torch.equal(y, norm.layer_norm_plain(x, scale, bias, 1e-12,
                                                torch.bfloat16))
    assert torch.equal(z, norm.rms_norm_plain(x, scale, 1e-5))
    assert norm.LAUNCHES == {"norm_fwd": 0, "norm_bwd": 0}
    assert counts == {}


@pytest.mark.parametrize("d,elem,aligned,want", [
    (768, 2, [(0, 2), (256, 4)], (8, 32)),      # BERT: a warp a row
    (4096, 2, [(0, 2), (256, 4)], (8, 128)),    # Mixtral: four warps
    (768, 4, [(0, 4)], (4, 32)),                # f32 rows
    (100, 2, [(0, 2)], (4, 4)),                 # not a multiple of 8
    (4097, 2, [(0, 2)], (1, 256)),              # odd: one element a load
    (16384, 4, [(0, 4)], (4, 512)),             # the widest row
    (768, 2, [(0, 2), (8, 4)], (2, 32)),        # scale aligned to 8 bytes
    (1, 2, [(0, 2)], (1, 1)),
])
def test_norm_geometry(d, elem, aligned, want):
    vec, tpr = _common.norm_geometry(d, elem, aligned)
    assert (vec, tpr) == want
    assert d % vec == 0 and d <= tpr * _common.NORM_ITEMS
    assert tpr <= _common.NORM_MAX_TPR


@pytest.mark.parametrize("d,operands", [
    (768, [((4, 768), torch.bfloat16, 0), ((768,), torch.float32, 0)]),
    (100, [((7, 100), torch.bfloat16, 0), ((100,), torch.float32, 2)]),
    (768, [((4, 768), torch.float32, 0), ((768,), torch.float32, 1)]),
])
def test_geometry_is_computed_once_a_key(monkeypatch, d, operands):
    """The wrapper's cached geometry is norm_geometry's for the operands'
    own addresses, and a second call with the same width, types and
    alignment computes nothing."""
    tensors = []
    for shape, dtype, offset in operands:
        whole = torch.empty(offset + int(torch.tensor(shape).prod()),
                            dtype=dtype)
        tensors.append(whole[offset:].view(shape))
    widest = tensors[0].element_size()
    want = _common.norm_geometry(
        d, widest, [(t.data_ptr(), t.element_size()) for t in tensors])
    monkeypatch.setattr(norm, "_GEOMETRY", {})
    assert norm._geometry(d, widest, tensors) == want
    monkeypatch.setattr(norm, "norm_geometry", None)  # a second computation
    assert norm._geometry(d, widest, tensors) == want  # would raise
    assert len(norm._GEOMETRY) == 1


@pytest.mark.parametrize("m,tpr,sms,want", [
    (32768, 32, 132, 528),   # BERT's rows on an H100: 4 blocks an SM
    (4096, 128, 132, 528),   # Mixtral's: 2 rows a block, 2048 blocks
    (4096, 128, 78, 312),    # a card of 78 SMs
    (3000, 512, 132, 528),
    (100, 512, 132, 100),    # one row a block, fewer rows than blocks
    (7, 32, 132, 1),         # 8 rows a block
])
def test_backward_partials_follow_the_sm_count(m, tpr, sms, want):
    assert _common.norm_bwd_blocks(m, tpr, sms) == want


def test_a_dtensor_parameter_is_refused():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                                rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        scale = distribute_tensor(torch.ones(8), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            norm._vector("norm", scale, 8, torch.device("cpu"))
    finally:
        if owned:
            dist.destroy_process_group()


def test_the_first_missing_library_builds_every_missing_one(monkeypatch,
                                                            tmp_path):
    built, loaded = [], []

    class _Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(norm._build, "_entry_points", {})
    monkeypatch.setattr(norm._build, "library_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(norm._build, "build",
                        lambda names=None: built.append(names))
    monkeypatch.setattr(norm._build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or _Lib())
    norm._build.kernel("norm_fwd")
    assert built == [None] and len(loaded) == 1  # None: every kernel


@pytest.mark.parametrize("name,value", [
    ("MAX_TPR", _common.NORM_MAX_TPR), ("NORM_ITEMS", _common.NORM_ITEMS),
    ("NORM_BLOCK", _common.NORM_BLOCK)])
def test_the_header_holds_the_python_geometry(name, value):
    """The kernels' defaults are the wrapper's (the build passes the two
    -D values too; MAX_TPR is the header's alone)."""
    header = (norm._build.CSRC / "norm_common.cuh").read_text()
    assert re.search(rf"\b{name}\b\D*{value}\b", header), name


def test_wrappers_refuse_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="unsupported device"):
        norm.rms_norm(torch.zeros(2, 8, device="meta"), torch.ones(8), 1e-5)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        norm._rows("norm", torch.zeros(2, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="rows of 1 to 16384"):
        norm._rows("norm", torch.zeros(2, 16385))
    with pytest.raises(ValueError, match="float32"):
        norm._vector("norm", torch.ones(8, dtype=torch.float64), 8,
                     torch.device("cpu"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

card = pytest.mark.card


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _ulp_bf16(v):
    """One bf16 ulp at |v| (8 bits of mantissa)."""
    mag = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# (rows, width, x dtype, y dtype): BERT's and Mixtral's rows, widths that
# are not a multiple of 8, f32 rows and f32 rows out to bf16.
CARD_SHAPES = [
    (4096, 768, torch.bfloat16, torch.bfloat16),
    (512, 4096, torch.bfloat16, torch.bfloat16),
    (1000, 100, torch.bfloat16, torch.bfloat16),
    (300, 4097, torch.bfloat16, torch.bfloat16),
    (64, 16384, torch.float32, torch.float32),
    (777, 768, torch.float32, torch.bfloat16),
]


def _card_inputs(rows, width, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, width, generator=gen, device=device) * 2 + 0.5
    x[-1] = 0.1  # a constant row
    dy = torch.randn(rows, width, generator=gen, device=device)
    scale = 1 + 0.1 * torch.randn(width, generator=gen, device=device)
    bias = 0.1 * torch.randn(width, generator=gen, device=device)
    return x.to(dtype), dy, scale, bias


def _within(got, want, tol):
    err = (got.double() - want.double()).abs() - tol.double()
    assert float(err.max()) <= 0, float(err.max())


@card
@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("rows,width,xdt,ydt", CARD_SHAPES)
def test_kernels_match_plain_on_the_card(gpu, kind, rows, width, xdt, ydt):
    layer = kind == "layer"
    eps = 1e-12 if layer else 1e-5
    x, dy, scale, bias = _card_inputs(rows, width, xdt, gpu)
    if not layer:
        ydt = xdt
    dy = dy.to(ydt)
    y, mean, rstd = norm.norm_fwd(x, scale, bias if layer else None, eps,
                                  ydt)
    if layer:
        want = norm.layer_norm_plain(x, scale, bias, eps, ydt)
        mean_p, rstd_p = norm.layer_norm_stats_plain(x, eps)
    else:
        want = norm.rms_norm_plain(x, scale, eps)
        rstd_p = norm.rms_norm_stats_plain(x, eps)
    live = slice(0, rows - 1)  # the constant row's statistics are noise
    terms = x.float().abs() * rstd_p.abs()[:, None] * scale.abs()
    if layer:
        terms = terms + ((mean_p * rstd_p).abs()[:, None] * scale.abs()
                         + bias.abs())
    tol = 1e-5 * terms
    if ydt == torch.bfloat16:
        tol = tol + _ulp_bf16(torch.maximum(want.float().abs(),
                                            y.float().abs()))
    _within(y[live], want[live], tol[live])
    _within(rstd[live], rstd_p[live], 1e-5 * rstd_p[live].abs())
    if layer:
        _within(mean[live], mean_p[live],
                1e-5 * x[live].float().abs().mean(dim=-1))

    got = norm.norm_bwd(x, dy, mean, rstd, scale)
    if layer:
        want = norm.layer_norm_bwd_plain(x, dy, mean, rstd, scale)
        xhat = (x.float() - mean[:, None]) * rstd.abs()[:, None]
    else:
        want = norm.rms_norm_bwd_plain(x, dy, rstd, scale)
        xhat = x.float() * rstd[:, None]
    r = rstd.abs()[:, None]
    g = dy.float() * scale
    terms = r * (g.abs() + g.abs().mean(dim=-1, keepdim=True)
                 + xhat.abs() * (g * xhat).abs().mean(dim=-1, keepdim=True))
    tol = 1e-5 * terms
    if xdt == torch.bfloat16:
        tol = tol + _ulp_bf16(want[0])
    assert got[0].dtype == xdt
    _within(got[0], want[0], tol)
    _within(got[1], want[1], 1e-5 * (dy.float() * xhat).abs().sum(0))
    if layer:
        _within(got[2], want[2], 1e-5 * dy.float().abs().sum(0))
    else:
        assert got[2] is None
    again = norm.norm_bwd(x, dy, mean, rstd, scale)
    for a, b in zip(got, again):
        assert a is b is None or torch.equal(a, b)


@card
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_modules_launch_the_kernels_on_the_card(gpu, kind):
    x, dy, scale, bias = _card_inputs(256, 768, torch.bfloat16, gpu)
    if kind == "layer":
        module = bert.LayerNorm(768, 1e-12, torch.bfloat16, device=gpu)
        with torch.no_grad():
            module.bias.copy_(bias)
    else:
        module = llama.RMSNorm(768, 1e-5, device=gpu)
    with torch.no_grad():
        module.scale.copy_(scale)
    norm.reset_launch_counts()
    x.requires_grad_(True)
    y = module(x)
    y.backward(dy.to(y.dtype))
    assert norm.LAUNCHES == {"norm_fwd": 1, "norm_bwd": 1}
    if kind == "layer":
        mean, rstd = norm.layer_norm_stats_plain(x.detach(), 1e-12)
        grads = norm.layer_norm_bwd_plain(x.detach(), dy.to(y.dtype), mean,
                                          rstd, scale)
        assert float((module.bias.grad - grads[2]).abs().max()) <= (
            1e-5 * float(dy.abs().sum(0).max()))
    assert module.scale.grad is not None and x.grad.dtype == x.dtype


@card
def test_the_card_refuses_what_the_kernels_cannot_take(gpu):
    scale = torch.ones(8, device=gpu)
    norm.reset_launch_counts()
    for x in (torch.zeros(2, 8, device=gpu, dtype=torch.float16),
              torch.zeros(2, 8, device=gpu, dtype=torch.float64)):
        with pytest.raises(TypeError):
            norm.rms_norm(x, scale, 1e-5)
    with pytest.raises(ValueError):
        norm.rms_norm(torch.zeros(2, 16385, device=gpu),
                      torch.ones(16385, device=gpu), 1e-5)
    with pytest.raises(ValueError):
        norm.rms_norm(torch.zeros(2, 8, device=gpu), torch.ones(8), 1e-5)
    with pytest.raises(TypeError):
        norm.layer_norm(torch.zeros(2, 8, device=gpu), scale, scale, 1e-5,
                        torch.float16)
    assert norm.LAUNCHES == {"norm_fwd": 0, "norm_bwd": 0}
