"""The layers a tensor-parallel plan splits, each held to its whole self,
on two processes over gloo (``--mesh tp=2``), from one seed:

- a row-parallel ``Dense`` with a nonzero bias (``RowwiseParallel``:
  each rank's product over its half of the input features, summed across
  tp, the bias added once) against the whole layer at rtol 1e-6;
- vit-tiny, seq2seq-tiny (f32, dense attention), llama-moe-tiny with
  remat and the chunked loss (as Mixtral trains on the card) and a Llama
  MoE layer under their plans (``models/*.py:tensor_parallel_plan``; the
  experts on their hidden dim, ``parallel/sharding.py:shard_experts``):
  the loss
  and the gradient of every parameter, gathered whole, against the whole
  model on the same inputs, at rtol 1e-5 in the 2-norm (plus f32's noise
  of 1e-7 an element, which the keys' bias needs: its gradient is 0). Under
  the 2-way column split each rank's q/k/v have half the features; an
  attention that reshapes them by the config's head count instead of
  its head dim (``n_heads`` heads of ``head_dim / 2``) computes another
  function without an error, and fails here;
- llama-moe-tiny in bf16: on ep=2 its loss is one process's bit for bit,
  on tp=2 within bf16's rounding (the row-parallel partial products are
  summed across the ranks in bf16).

The spawn helper is ``tests/test_torch_world.py``'s (its op jobs).
"""

import copy

import pytest
import torch

from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel
RTOL = 1e-5
ATOL = 1e-7


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def _excess(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The excess of ``|got - want|`` over ``rtol |want|`` plus f32's
    noise (``ATOL`` an element), in the 2-norm: <= 0 where they agree. A
    bias of the keys has a gradient of 0 up to that noise (softmax
    ignores a shift of a row's scores), which no relative error can
    hold."""
    return float((got - want).norm() - rtol * want.norm()
                 - ATOL * want.numel() ** 0.5)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _against_whole(model, shard, batch, loss_fn) -> dict:
    """``loss_fn`` on ``model`` (whole) and on its copy laid out by
    ``shard``: the loss's relative error, and each parameter's gradient,
    gathered whole, as its excess over RTOL (:func:`_excess`)."""
    local = copy.deepcopy(model)
    shard(local)
    errors = {}
    losses = []
    for m in (model, local):
        loss = loss_fn(m, *batch)
        loss.backward()
        losses.append(loss.detach())
    errors["loss"] = _rel(losses[1], losses[0])
    grads = dict(model.named_parameters())
    for name, p in local.named_parameters():
        if p.grad is not None:
            errors[name] = _excess(_whole(p.grad), grads[name].grad, RTOL)
    return errors


def layers_against_whole() -> dict:
    """An op job: each case's errors (see the module doc)."""
    from torch.distributed.tensor.parallel import (
        RowwiseParallel,
        parallelize_module,
    )

    from mpi_operator_tpu_torch.models import llama, moe, seq2seq, vit
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh
    from mpi_operator_tpu_torch.parallel.sharding import shard_params

    torch.set_num_threads(1)
    mesh = create_mesh(device="cpu", tp=2)
    tp_mesh = mesh.submesh("tp")
    rank = mesh.coordinate("tp")
    gen = torch.Generator().manual_seed(0)
    out = {}

    dense = llama.Dense(16, 8, dtype=torch.float32, bias=True)
    with torch.no_grad():
        dense.weight.normal_(generator=gen)
        dense.bias.uniform_(1.0, 2.0, generator=gen)
    x = torch.randn(3, 5, 16, generator=gen)
    row = copy.deepcopy(dense)
    style = RowwiseParallel()
    style.src_data_rank = None
    parallelize_module(row, tp_mesh, style)
    got = row(x[..., rank * 8:(rank + 1) * 8])
    out["row-parallel dense"] = {"output": _rel(got, dense(x))}

    def plan_of(lib):
        return lambda m: shard_params(
            m, mesh, tp_plan=lambda: lib.tensor_parallel_plan(m, 2))

    v = vit.ViT(vit.tiny())
    vit.init_params(v, gen)
    images = torch.randn(2, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 16, (2,), generator=gen)
    out["vit-tiny"] = _against_whole(v, plan_of(vit), (images, labels),
                                     vit.loss_fn)

    s = seq2seq.Seq2Seq(seq2seq.tiny())
    seq2seq.init_params(s, gen)
    src = torch.randint(1, 128, (2, 12), generator=gen)
    out["seq2seq-tiny"] = _against_whole(s, plan_of(seq2seq),
                                         (src, src[:, :6]), seq2seq.loss_fn)

    lm = llama.Llama(llama.tiny_moe(remat=True, xent_chunk=8))
    llama.init_params(lm, gen)
    tokens = torch.randint(0, 256, (2, 16), generator=gen)
    out["llama-moe-tiny remat"] = _against_whole(lm, plan_of(llama),
                                                 (tokens,), llama.loss_fn)

    m = moe.MoEMLP(32, 64, 4, dtype=torch.float32)
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.2, generator=gen)
    h = torch.randn(2, 8, 32, generator=gen)
    out["moe experts"] = _against_whole(
        m, lambda mod: shard_params(mod, mesh, tp_plan=dict), (h,),
        lambda mod, x: mod(x)[0].square().mean())
    return out


def moe_bf16_first_loss() -> dict:
    """An op job: llama-moe-tiny in bf16 (remat, chunked loss), its loss on
    one batch whole and with the experts on ep=2 and on tp=2, as relative
    errors. ep's partial outputs are exact (each element has one nonzero
    part); tp adds two bf16-rounded partial products, one rounding more
    than one process's f32 sum (as GSPMD's bf16 products would)."""
    from mpi_operator_tpu_torch.models import llama
    from mpi_operator_tpu_torch.parallel.mesh import create_mesh
    from mpi_operator_tpu_torch.parallel.sharding import shard_params

    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(1)
    model = llama.Llama(llama.tiny_moe(remat=True, xent_chunk=8,
                                       dtype=torch.bfloat16))
    llama.init_params(model, gen)
    tokens = torch.randint(0, 256, (2, 16), generator=gen)
    with torch.no_grad():
        want = llama.loss_fn(model, tokens)
        out = {}
        for axis in ("ep", "tp"):
            mesh = create_mesh(device="cpu", **{axis: 2})
            local = copy.deepcopy(model)
            shard_params(local, mesh, tp_plan=lambda m=local:
                         llama.tensor_parallel_plan(m, 2))
            out[axis] = _rel(llama.loss_fn(local, tokens), want)
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_gang(2, [{"cmd": "op", "fn": f"tests.test_torch_tp_local_heads:"
                                            f"{fn}", "args": {}}
                        for fn in ("layers_against_whole",
                                   "moe_bf16_first_loss")])


@pytest.fixture(scope="module")
def errors(ranks):
    return [r[0]["line"] for r in ranks]


def test_row_parallel_dense_adds_its_bias_once(errors):
    for rank in errors:
        case = rank["row-parallel dense"]
        assert case["output"] <= 1e-6, case


@pytest.mark.parametrize("model", ["vit-tiny", "seq2seq-tiny",
                                   "llama-moe-tiny remat", "moe experts"])
def test_plan_on_local_heads_matches_the_whole_model(errors, model):
    for rank in errors:
        case = dict(rank[model])
        assert case.pop("loss") <= RTOL
        assert len(case) >= 4, case  # a gradient for every parameter
        bad = {k: v for k, v in case.items() if not v <= 0}
        assert not bad, bad
    assert sorted(errors[0][model]) == sorted(errors[1][model])


def test_bf16_moe_layouts_round_where_their_sums_do(ranks):
    """ep=2 gives one process's bf16 loss bit for bit; tp=2 within bf16's
    rounding (2^-8 a rounding), not further."""
    for rank in ranks:
        errors = rank[1]["line"]
        assert errors["ep"] == 0.0, errors
        assert errors["tp"] <= 1e-2, errors


def test_launches_are_counted_by_their_head_counts(monkeypatch):
    """The flat wrappers count each launch also under the q/kv heads it
    was given (``ops/attention.py:LAUNCH_HEADS``, which the card's tp
    phase holds to a rank's local heads); a reset clears both. The launch
    itself is a stand-in here: no kernel runs on the CPU."""
    import contextlib
    import types

    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as attn

    monkeypatch.setattr(_build, "kernel", lambda name: lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    attn.reset_launch_counts()
    for heads in ((16, 4), (16, 4), (32, 8)):
        attn._launch("flash_fwd", "cuda", heads=heads)
    attn._launch("flash_bhsd_fwd", "cuda")
    assert attn.LAUNCHES["flash_fwd"] == 3
    assert attn.LAUNCHES["flash_bhsd_fwd"] == 1
    assert attn.LAUNCH_HEADS == {"flash_fwd 16/4": 2, "flash_fwd 32/8": 1}
    attn.reset_launch_counts()
    assert attn.LAUNCH_HEADS == {} and set(attn.LAUNCHES.values()) == {0}
