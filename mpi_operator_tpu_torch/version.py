"""Build/version stamp.

Reference analog: /root/reference/v2/pkg/version/version.go, whose
Version/GitSHA/Built fields are injected by ldflags (Makefile:10-17).
Python has no ldflags; the equivalent is a generated ``_build_info.py``
written at image-build time by ``mpi_operator_tpu_torch/cmd/
stamp_version.py`` (the port's images run it with the build's
``GIT_SHA``). Without a stamp (editable installs, source checkouts) the
fields fall back to the package version and "unknown".
"""

from __future__ import annotations

from . import __version__

VERSION = __version__
GIT_SHA = "unknown"
BUILT = "unknown"

try:  # generated by cmd/stamp_version.py at build time
    from ._build_info import BUILT, GIT_SHA, VERSION  # type: ignore # noqa: F401
except Exception:  # a corrupt stamp must never break startup
    pass


def version_string() -> str:
    return f"tpu-operator {VERSION} (git {GIT_SHA}, built {BUILT})"
