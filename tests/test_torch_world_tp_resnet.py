"""ResNet on ``--mesh tp=2``, two processes on the CPU over gloo: resnet18
on the ``xla`` BN route, whose plan is the replicated layout (JAX has no
rule for it; GSPMD replicates its work over tp). Each tp rank computes
the whole batch, so the run equals the port's own one-process run at
rtol 1e-5. The trainer's ResNet computes in bf16, which rounds at other
points in the two frameworks (``tests/test_torch_world_resnet.py``), so
against the JAX trainer on the 8-device CPU mesh with ``dp=-1,tp=2`` it
is held at that file's distances (2e-4 and 1e-2). The ``pallas`` BN
route refuses tp, as every multi-device mesh, with JAX's message
(``tests/test_torch_world_resnet.py``). The spawn helper is
``tests/test_torch_world.py``'s.
"""

import numpy as np
import pytest

from tests.test_torch_world import BASE, RTOL, _run_job, compare_to_jax
from tests.test_torch_world_resnet import JAX_RTOL, RESNET

pytestmark = pytest.mark.kernel


def test_resnet_tp2_is_the_replicated_layout(tmp_path):
    want, lines = compare_to_jax(tmp_path, "tp=2", "dp=-1,tp=2", 2,
                                 models={"resnet18": RESNET})["resnet18"]
    one = _run_job({"argv": ["--device", "cpu", *RESNET, *BASE],
                    "weights": str(tmp_path / "resnet18.pt")})["line"]
    for line in lines:
        assert line["devices"] == 2 and line["final_step"] == 3
        for i, (key, step) in enumerate((("first_loss", 0), ("loss", -1))):
            np.testing.assert_allclose(line[key], one[key], rtol=RTOL)
            np.testing.assert_allclose(line[key], want[step],
                                       rtol=JAX_RTOL[i])
    assert len({line["loss"] for line in lines}) == 1
    assert want[-1] < want[0]
