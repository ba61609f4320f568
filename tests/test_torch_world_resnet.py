"""ResNet-18 across two processes with ``--mesh dp=2`` on the CPU over
gloo. On the ``xla`` BN route each process sums its BN moments with its
peer's, so every layer normalises by the global batch's moments, as
GSPMD takes them.

The trainer's ResNet computes in bf16, which rounds activations at
different points in the two frameworks (``tests/test_torch_resnet.py``),
so the run is held, from the JAX init, to two references:

- the port's own one-process run at the same global batch: the first
  step's loss (a forward through 20 BN layers on the global moments) at
  rtol 1e-5 (it lands bit for bit); the third step's at rtol 2e-3: the
  bf16 gradients, summed in two halves and averaged instead of in one
  sum, are amplified by two SGD-nesterov steps at lr 1e-2 (8.9e-4 apart
  here; the JAX package's own two f32 BN routes sit 3.3e-4 apart at step
  3 of ``tests/test_torch_resnet.py``'s curve);
- the JAX trainer on the 8-device CPU mesh (``dp=-1``): the first loss at
  rtol 2e-4 and the third at 1e-2, the distances the bf16 rounding
  alone puts between the one-process port and JAX (7.8e-5 and 5.6e-3).

The ``pallas`` route keeps JAX's single-device refusal, with JAX's
message, on dp and on tp. The spawn helper is
``tests/test_torch_world.py``'s.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_world import (
    BASE,
    RTOL,
    _run_job,
    compare_to_jax,
    run_gang,
)

pytestmark = pytest.mark.kernel
torch.set_num_threads(2)

RESNET = ["--model", "resnet18", "--image-size", "16", "--bn-kernel", "xla"]
# (first step, third step) tolerances, as the docstring argues.
ONE_PROCESS_RTOL = (RTOL, 2e-3)
JAX_RTOL = (2e-4, 1e-2)


def test_resnet_dp2_xla_route_normalises_by_the_global_moments(tmp_path):
    got = compare_to_jax(tmp_path, "dp=2", "dp=-1", 2,
                         models={"resnet18": RESNET})
    want, lines = got["resnet18"]
    one = _run_job({"argv": ["--device", "cpu", *RESNET, *BASE],
                    "weights": str(tmp_path / "resnet18.pt")})["line"]
    for line in lines:
        assert line["devices"] == 2 and line["final_step"] == 3
        for i, (key, step) in enumerate((("first_loss", 0), ("loss", -1))):
            np.testing.assert_allclose(line[key], one[key],
                                       rtol=ONE_PROCESS_RTOL[i])
            np.testing.assert_allclose(line[key], want[step],
                                       rtol=JAX_RTOL[i])
    assert want[-1] < want[0]


def test_unported_layouts_refuse_on_two_processes():
    """The ``pallas`` BN route refuses any multi-device mesh with JAX's
    message: dp=2, and tp=2, whose replicated layout runs the ``xla``
    route (``tests/test_torch_world_tp_models.py``)."""
    cpu = ["--device", "cpu", *BASE]
    jobs = [{"argv": [*cpu, "--mesh", mesh, *RESNET[:-1], "pallas"]}
            for mesh in ("dp=2", "tp=2")]
    for rank in run_gang(2, jobs):
        for record in rank:
            assert record["exit"] == ("--bn-kernel pallas runs the "
                                      "single-device path only; this mesh "
                                      "has 2 devices")
