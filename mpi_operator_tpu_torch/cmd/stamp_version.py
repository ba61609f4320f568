"""Write ``mpi_operator_tpu_torch/_build_info.py``, the port's build stamp.

The port's counterpart of ``hack/stamp_version.py`` (which stamps the JAX
package): ``version.py`` reads the generated file, so ``python -m
mpi_operator_tpu_torch.cmd.operator --version`` names the build's
version, git SHA and time. The port's operator and worker images run it
at build time with the SHA passed in, as the JAX base image does:

    python -m mpi_operator_tpu_torch.cmd.stamp_version [--version vX.Y.Z] \\
        [--git-sha SHA]

Without ``--git-sha`` it asks git, and writes "unknown" where there is no
repository or no git (an image build has neither).
"""

from __future__ import annotations

import argparse
import datetime
import pathlib
import subprocess

PKG = pathlib.Path(__file__).resolve().parent.parent
OUT = PKG / "_build_info.py"


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "-C", str(PKG.parent), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip() or "unknown"
    except (subprocess.CalledProcessError, FileNotFoundError):
        return "unknown"


def package_version() -> str:
    """``__version__`` of the port, read from its ``__init__.py`` (so the
    stamp imports nothing of the package)."""
    for line in (PKG / "__init__.py").read_text().splitlines():
        if line.startswith("__version__"):
            return line.split("=")[1].strip().strip("\"'")
    return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--version", default="")
    parser.add_argument("--git-sha", default="",
                        help="the build's commit, passed in where the build "
                             "has no git (the images' GIT_SHA argument)")
    args = parser.parse_args(argv)
    version = args.version or package_version()
    sha = args.git_sha or git_sha()
    built = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    # repr() so that no --version value can write a file that fails to
    # import, which would break every later import of version.py.
    OUT.write_text(
        "# Generated by mpi_operator_tpu_torch/cmd/stamp_version.py; do not "
        "edit or commit.\n"
        f"VERSION = {version!r}\n"
        f"GIT_SHA = {sha!r}\n"
        f"BUILT = {built!r}\n"
    )
    print(f"stamped {OUT}: {version} {sha} {built}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
