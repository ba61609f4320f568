"""The port's build stamp: ``mpi_operator_tpu_torch/cmd/stamp_version.py``
writes ``mpi_operator_tpu_torch/_build_info.py``, which ``version.py`` reads,
so ``cmd.operator --version`` names the stamped version and SHA; and the
port's images run the stamp with their ``GIT_SHA`` build argument, as
``build/base/Dockerfile`` runs ``hack/stamp_version.py`` for the JAX
package's.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mpi_operator_tpu_torch"
STAMP_MODULE = "mpi_operator_tpu_torch.cmd.stamp_version"


def test_stamp_script_generates_build_info():
    """``tests/test_operator_cli.py:test_stamp_script_generates_build_info``
    on the port's stamper; the operator's ``--version`` then reports it."""
    out = PKG / "_build_info.py"
    prior = out.read_text() if out.exists() else None
    try:
        rc = subprocess.run(
            [sys.executable, "-m", STAMP_MODULE, "--version", "9.9.9-test",
             "--git-sha", "cafe123"],
            cwd=ROOT, capture_output=True, text=True,
        )
        assert rc.returncode == 0, rc.stderr
        text = out.read_text()
        assert "VERSION = '9.9.9-test'" in text
        assert "GIT_SHA = 'cafe123'" in text and "BUILT" in text
        version = subprocess.run(
            [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.operator",
             "--version"],
            cwd=ROOT, capture_output=True, text=True,
        )
        assert version.returncode == 0, version.stderr
        assert "9.9.9-test (git cafe123, built " in version.stdout
    finally:
        # Restore whatever stamp existed before; never leave test residue.
        if prior is None:
            out.unlink(missing_ok=True)
        else:
            out.write_text(prior)


@pytest.mark.parametrize("image", ["operator", "worker"])
def test_image_runs_the_stamp(image):
    """The operator and worker images take ``GIT_SHA`` and stamp with it,
    after the package is copied in and before the image drops root."""
    text = (PKG / "build" / image / "Dockerfile").read_text()
    assert re.search(r"^ARG GIT_SHA=", text, re.M), image
    runs = [line for line in text.splitlines()
            if line.startswith("RUN ") and STAMP_MODULE in line]
    assert len(runs) == 1, image
    assert '--git-sha "${GIT_SHA}"' in runs[0]
    at = text.index(runs[0])
    assert text.index("COPY mpi_operator_tpu_torch") < at < text.index("USER ")


def test_pi_image_is_built_on_the_stamped_worker():
    text = (PKG / "build" / "pi" / "Dockerfile").read_text()
    assert re.search(r"^FROM tpu-job-operator/gpu-worker:", text, re.M)
