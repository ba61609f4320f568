"""The port's GPipe schedule (``parallel/pipeline.py``) on 2 and 4 gloo
processes against the JAX package's ``pipeline`` on the CPU mesh, as
``tests/test_pipeline.py`` holds the JAX one against its sequential
oracle.

A toy stage (``tanh(h @ w + b)``, and with ``with_aux`` the sum of its
input's squares as the aux) at M = P, 2P and 3P microbatches: the last
stage's outputs, every stage's parameter gradients and stage 0's input
gradient of ``sum(y^2) (+ aux)`` against JAX's, rows over dp (each dp
rank its share of every microbatch, JAX's ``state_spec=P("dp")``), the
aux sum, the sequential fallback of a mesh without pp, the refusals and
the microbatch round trip. One gang a pp size runs every case, one op
job each (``tests.test_torch_world.run_gang``, which fails a hung rank
after its own timeout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi_operator_tpu.parallel import create_mesh as jax_mesh
from mpi_operator_tpu.parallel import pipeline as jpipe
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_world import run_gang

pytestmark = pytest.mark.kernel

D = 16
MB = 4  # rows a microbatch
ATOL = 1e-5
# (microbatches, dp, with_aux) a case, on a pp of 2 or 4.
CASES = {
    2: [(2, 1, False), (4, 1, False), (6, 1, False), (4, 2, False),
        (4, 1, True), (4, 2, True)],
    4: [(4, 1, False), (8, 1, False), (12, 1, False), (8, 1, True)],
}


def _arrays(n_stages: int, m: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((n_stages, D, D)) / np.sqrt(D)).astype(
        np.float32)
    b = (rng.standard_normal((n_stages, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, MB, D)).astype(np.float32)
    return w, b, x


def _stage_fn(lib, with_aux: bool):
    def fn(params, h):
        y = lib.tanh(h @ params["w"] + params["b"])
        return (y, (h * h).sum()) if with_aux else y

    return fn


def port_case(m: int, dp: int, with_aux: bool) -> dict:
    """One rank's part of the port's pipeline (an op job): the outputs on
    the last stage, its stage's gradients and stage 0's input gradient
    of ``sum(y^2)`` (+ the aux), on its dp rows of every microbatch."""
    import torch.distributed as dist

    n = dist.get_world_size() // dp
    mesh = tmesh.create_mesh(device="cpu", dp=dp, pp=n)
    stage, row = mesh.coordinate("pp"), mesh.coordinate("dp")
    w, b, x = _arrays(n, m)
    per = MB // dp
    x = torch.from_numpy(x[:, row * per:(row + 1) * per]).requires_grad_()
    params = [None] * n
    params[stage] = {"w": torch.from_numpy(w[stage]).requires_grad_(),
                     "b": torch.from_numpy(b[stage]).requires_grad_()}
    out = tpipe.pipeline(_stage_fn(torch, with_aux), params, x, mesh,
                         with_aux=with_aux)
    y, aux = out if with_aux else (out, torch.zeros(()))
    # Only the last stage's outputs are real: every rank backpropagates
    # its own loss of them, the others' cotangent being ignored.
    ((y * y).sum() + aux).backward()
    mine = params[stage]
    return {"stage": stage, "row": row, "y": y.detach().tolist(),
            "aux": float(aux), "dw": mine["w"].grad.tolist(),
            "db": mine["b"].grad.tolist(), "dx": x.grad.tolist()}


def jax_case(n: int, m: int, dp: int, with_aux: bool) -> dict:
    mesh = jax_mesh(devices=jax.devices()[:n * dp], dp=dp, pp=n)
    w, b, x = (jnp.asarray(a) for a in _arrays(n, m))
    fn = _stage_fn(jnp, with_aux)

    def loss(params, x):
        out = jpipe.pipeline(fn, params, x, mesh,
                             state_spec=P("dp") if dp > 1 else None,
                             with_aux=with_aux)
        y, aux = out if with_aux else (out, 0.0)
        return jnp.sum(y ** 2) + aux, (y, aux)

    with mesh:
        (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))({"w": w, "b": b}, x)
    return {"y": np.asarray(y), "aux": float(aux), "dw": np.asarray(g["w"]),
            "db": np.asarray(g["b"]), "dx": np.asarray(gx)}


@pytest.fixture(scope="module")
def gangs():
    """P -> (case -> each rank's result), every case of P in one gang."""
    runs = {}

    def on(n: int, dp: int) -> dict:
        key = (n, dp)
        if key not in runs:
            cases = [c for c in CASES[n] if c[1] == dp]
            jobs = [{"cmd": "op", "fn": "tests.test_torch_pipeline:port_case",
                     "args": {"m": m, "dp": dp, "with_aux": aux}}
                    for m, dp, aux in cases]
            ranks = run_gang(n * dp, jobs)
            runs[key] = {case: [r[i]["line"] for r in ranks]
                         for i, case in enumerate(cases)}
        return runs[key]

    return on


@pytest.mark.parametrize("n,m,dp,with_aux", [
    (n, *case) for n in sorted(CASES) for case in CASES[n]])
def test_pipeline_matches_the_jax_pipeline(gangs, n, m, dp, with_aux):
    ranks = gangs(n, dp)[m, dp, with_aux]
    want = jax_case(n, m, dp, with_aux)
    per = MB // dp
    for r in ranks:
        stage, row = r["stage"], r["row"]
        rows = slice(row * per, (row + 1) * per)
        if stage == n - 1:
            np.testing.assert_allclose(r["y"], want["y"][:, rows], atol=ATOL,
                                       rtol=0)
        else:
            assert not np.any(r["y"])  # zeros off the last stage
        if stage == 0:
            np.testing.assert_allclose(r["dx"], want["dx"][:, rows],
                                       atol=ATOL, rtol=1e-5)
    for stage in range(n):
        # JAX's gradient is the sum over the dp rows.
        mine = [r for r in ranks if r["stage"] == stage]
        for name in ("dw", "db"):
            got = np.sum([np.asarray(r[name]) for r in mine], axis=0)
            np.testing.assert_allclose(got, want[name][stage], atol=ATOL,
                                       rtol=1e-5, err_msg=f"{name} {stage}")
    if with_aux:
        # The port sums over pp; JAX over pp and the dp rows.
        by_row = {r["row"]: r["aux"] for r in ranks}
        np.testing.assert_allclose(sum(by_row.values()), want["aux"],
                                   rtol=1e-5)


@pytest.mark.parametrize("with_aux", [False, True])
def test_mesh_without_pp_runs_sequentially(with_aux):
    mesh = tmesh.create_mesh(device="cpu", dp=1)
    w, b, x = _arrays(3, 2, seed=6)
    params = [{"w": torch.from_numpy(w[i]).requires_grad_(),
               "b": torch.from_numpy(b[i]).requires_grad_()}
              for i in range(3)]
    got = tpipe.pipeline(_stage_fn(torch, with_aux), params,
                         torch.from_numpy(x), mesh, with_aux=with_aux)
    jmesh = jax_mesh(dp=8)
    want = jpipe.pipeline(_stage_fn(jnp, with_aux),
                          {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), jmesh, with_aux=with_aux)
    got, want = (got, want) if with_aux else ((got, 0.0), (want, 0.0))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(torch.as_tensor(got[1]).detach()),
                               float(want[1]), rtol=1e-5)
    # The fallback differentiates as plain autograd.
    (got[0] ** 2).sum().backward()
    assert all(p["w"].grad is not None for p in params)


def _pp_mesh(n: int) -> tmesh.Mesh:
    """A pp mesh of ``n`` without a world: enough for the refusals, which
    come before any collective."""
    return tmesh.Mesh(("pp",), (n,), torch.device("cpu"))


def test_too_few_microbatches_rejected():
    params = [{"w": torch.zeros(D, D), "b": torch.zeros(D)}] * 8
    with pytest.raises(ValueError, match="at least 8 microbatches"):
        tpipe.pipeline(_stage_fn(torch, False), params, torch.zeros(4, 2, D),
                       _pp_mesh(8))
    with pytest.raises(ValueError, match="at least 8 microbatches"):
        jpipe.pipeline(_stage_fn(jnp, False),
                       {"w": jnp.zeros((8, D, D)), "b": jnp.zeros((8, D))},
                       jnp.zeros((4, 2, D)), jax_mesh(pp=8))


def test_stage_count_must_match_pp_axis():
    params = [{"w": torch.zeros(D, D), "b": torch.zeros(D)}] * 8
    with pytest.raises(ValueError, match="must match"):
        tpipe.pipeline(_stage_fn(torch, False), params, torch.zeros(8, 2, D),
                       _pp_mesh(4))


class TestMicrobatchHelpers:
    def test_roundtrip(self):
        x = torch.arange(24.0).reshape(12, 2)
        mb = tpipe.microbatch(x, 3)
        assert mb.shape == (4, 3, 2)
        np.testing.assert_array_equal(
            mb.numpy(), np.asarray(jpipe.microbatch(jnp.asarray(x.numpy()),
                                                    3)))
        torch.testing.assert_close(tpipe.unmicrobatch(mb), x)

    def test_indivisible_rejected(self):
        with pytest.raises(ValueError, match="not divisible"):
            tpipe.num_microbatches(10, 4)
        assert tpipe.num_microbatches(12, 4) == jpipe.num_microbatches(12, 4)
