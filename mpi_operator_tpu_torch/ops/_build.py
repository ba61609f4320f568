"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Each kernel source under ``csrc/`` becomes its own library, built at
first use (or all at once by :func:`build`, one ``nvcc`` process per
source, all started together) into the git-ignored ``_build/``
directory. The file name carries a hash of the source, of every header
under ``csrc/`` and of the flags, so an edited, added or renamed source
or header is rebuilt and a stale library is never loaded. Nothing
here runs at import time: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ._common import BN_THREADS, DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> (source, argtypes). Every pointer and the stream are
# c_void_p: a bare Python int would be cut to 32 bits.
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
    "flash_bwd_dq": ("flash_bwd_dq.cu", [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu",
                      [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P]),
    "flash_bhsd_fwd": ("flash_bhsd_fwd.cu",
                       [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]),
    "flash_bhsd_bwd_dq": ("flash_bhsd_bwd_dq.cu",
                          [_P] * 9 + [_I] * 5 + [_F, _I, _I, _P]),
    "flash_bhsd_bwd_dkv": ("flash_bhsd_bwd_dkv.cu",
                           [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P]),
    "bn_stats": ("bn_stats.cu", [_P] * 3 + [_I] * 7 + [_P]),
    "bn_grads": ("bn_grads.cu", [_P] * 6 + [_I] * 8 + [_P]),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build only where the CUDA toolkit is "
        "installed"
    )


NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
    f"-DFLASH_BLOCK_Q={DEFAULT_BLOCK_Q}", f"-DFLASH_BLOCK_K={DEFAULT_BLOCK_K}",
    f"-DBN_THREADS={BN_THREADS}",
]


def headers() -> list:
    """Every header under ``csrc/``, sorted: each one feeds every
    library's hash, whichever sources include it."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / KERNELS[name][0]).read_bytes())
    for header in headers():
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel (all by default) that is not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (absent for libraries that were already built);
    raises with nvcc's output if any build fails."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(text)
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
            _report("build", name, seconds[name])
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / shared-memory / spill report) from
    the build of ``name``, or '' when it was not built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_entry_points: dict = {}
_lock = threading.Lock()
# Called as ``load_hook(kind, name, seconds)`` for each library built
# ("build") or loaded ("load") in this process; None unless a tracer
# (utils/torchtrace.py) armed it. Never reached on the launch path once a
# kernel is loaded.
load_hook = None


def _report(kind: str, name: str, seconds: float) -> None:
    hook = load_hook
    if hook is not None:
        hook(kind, name, seconds)


def kernel(name: str):
    """The C entry point ``name`` of its library, building it first if
    needed. Returns a ctypes function whose result is a cudaError_t."""
    with _lock:
        fn = _entry_points.get(name)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            t0 = time.perf_counter()
            fn = getattr(ctypes.CDLL(str(path)), name)
            fn.argtypes = KERNELS[name][1]
            fn.restype = ctypes.c_int
            _entry_points[name] = fn
            _report("load", name, time.perf_counter() - t0)
    return fn


def loaded_kernels() -> list:
    """Names of the kernels :func:`kernel` has loaded in this process."""
    with _lock:
        return sorted(_entry_points)


def check(name: str, rc: int) -> None:
    """Raise when a kernel's C entry point reports an error."""
    if rc:
        raise RuntimeError(
            f"{name}: CUDA error {rc} at launch (cudaError_t; the launch "
            f"was refused or a prior asynchronous fault surfaced)"
        )
