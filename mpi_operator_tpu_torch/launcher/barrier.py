"""Gang rendezvous barrier: coordinator-readiness gating (the port's copy
of ``mpi_operator_tpu/launcher/barrier.py``, wire for wire).

``torch.distributed.init_process_group`` waits on a TCP store that worker
0 hosts; a rank that dials it before worker 0 exists burns its timeout
or fails. So worker 0 first serves a barrier on the coordinator port
+ 1, every rank (0 included) checks in, and nobody forms the process
group until the whole gang is present.

Two interchangeable engines, same wire protocol
(``"TPUB" u32(rank)`` in, ``"GO!!"`` out), so a port worker and a JAX
worker can meet at one barrier:

- **native**: ``native/barrier.cpp`` -> ``libtpujob_barrier.so`` via
  ctypes: poll-based C++, no Python threads on the serve path (built by
  ``make -C native``);
- **pure Python**: socket/threading engine used when the shared library
  is absent.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import pathlib
import socket
import struct
import threading
import time
from typing import Optional

from ..utils.logging import get_logger

log = get_logger("launcher.barrier")

MAGIC = b"TPUB"
GO = b"GO!!"
ENV_NATIVE_LIB = "TPUJOB_BARRIER_LIB"

_REPO_NATIVE = pathlib.Path(__file__).resolve().parents[2] / "native"
_SEARCH_PATHS = (
    os.environ.get(ENV_NATIVE_LIB, ""),
    str(_REPO_NATIVE / "libtpujob_barrier.so"),
    "libtpujob_barrier.so",
)


def _load_native() -> Optional[ctypes.CDLL]:
    for path in _SEARCH_PATHS:
        if not path:
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.tpujob_barrier_serve.argtypes = [ctypes.c_int] * 3
        lib.tpujob_barrier_serve.restype = ctypes.c_int
        lib.tpujob_barrier_wait.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tpujob_barrier_wait.restype = ctypes.c_int
        return lib
    return None


_native = _load_native()


def native_available() -> bool:
    return _native is not None


# ---------------------------------------------------------------------------
# Pure-Python engine (wire-compatible with barrier.cpp)
# ---------------------------------------------------------------------------


_HEADER_TIMEOUT_S = 3.0  # per-connection budget for the 8-byte header


def _py_serve(port: int, world_size: int, timeout_ms: int) -> int:
    import selectors

    deadline = time.monotonic() + timeout_ms / 1000.0
    # conn per rank; a re-check-in (client retry after a dropped connection)
    # replaces the stale conn so the retrying rank still gets its GO.
    conn_by_rank: dict[int, socket.socket] = {}
    # Half-read headers get their own short deadline: a silent connection
    # (port scanner, health probe) is dropped alone instead of serializing
    # the accept loop until the gang deadline (same design as
    # barrier.cpp's PendingConn poll set).
    pending: dict[socket.socket, tuple[bytes, float]] = {}
    sel = selectors.DefaultSelector()
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", port))
            srv.listen(world_size + 8)
            srv.setblocking(False)
            sel.register(srv, selectors.EVENT_READ)
            while len(conn_by_rank) < world_size:
                now = time.monotonic()
                if now >= deadline:
                    return -1
                for conn, (buf, conn_deadline) in list(pending.items()):
                    if now >= conn_deadline:
                        sel.unregister(conn)
                        del pending[conn]
                        conn.close()
                for key, _ in sel.select(timeout=0.2):
                    sock = key.fileobj
                    if sock is srv:
                        while True:
                            try:
                                conn, _ = srv.accept()
                            except (BlockingIOError, InterruptedError,
                                    ConnectionAbortedError):
                                break  # drained for now
                            # Hard errors (EMFILE under a flood) propagate
                            # to the outer handler -> rc=-1, not a silent
                            # spin to the gang deadline.
                            conn.setblocking(False)
                            pending[conn] = (
                                b"", time.monotonic() + _HEADER_TIMEOUT_S
                            )
                            sel.register(conn, selectors.EVENT_READ)
                        continue
                    buf, conn_deadline = pending[sock]
                    try:
                        chunk = sock.recv(8 - len(buf))
                    except BlockingIOError:
                        continue
                    except OSError:
                        chunk = b""
                    if not chunk:  # closed before full header
                        sel.unregister(sock)
                        del pending[sock]
                        sock.close()
                        continue
                    buf += chunk
                    if len(buf) < 8:
                        pending[sock] = (buf, conn_deadline)
                        continue
                    sel.unregister(sock)
                    del pending[sock]
                    if buf[:4] != MAGIC:
                        sock.close()
                        continue
                    (rank,) = struct.unpack("<I", buf[4:])
                    if rank >= world_size:
                        sock.close()
                        continue
                    old = conn_by_rank.pop(rank, None)
                    if old is not None:
                        old.close()
                    conn_by_rank[rank] = sock
            for conn in conn_by_rank.values():
                try:
                    # Back to blocking for the 4-byte release write.
                    conn.settimeout(max(deadline - time.monotonic(), 0.01))
                    conn.sendall(GO)
                except OSError:
                    pass  # rank died post-check-in; the group will see it
            return 0
    except OSError:
        return -1
    finally:
        sel.close()
        for conn in list(conn_by_rank.values()) + list(pending):
            try:
                conn.close()
            except OSError:
                pass


def _py_wait(host: str, port: int, rank: int, timeout_ms: int) -> int:
    deadline = time.monotonic() + timeout_ms / 1000.0
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(
                (host, port), timeout=max(deadline - time.monotonic(), 0.01)
            ) as conn:
                conn.sendall(MAGIC + struct.pack("<I", rank))
                conn.settimeout(max(deadline - time.monotonic(), 0.01))
                go = b""
                while len(go) < 4:
                    chunk = conn.recv(4 - len(go))
                    if not chunk:
                        break
                    go += chunk
                if go == GO:
                    return 0
        except OSError:
            pass
        time.sleep(0.2)
    return -1


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def serve(port: int, world_size: int, timeout_s: float = 300.0) -> int:
    """Serve one barrier round (blocking). 0 on success."""
    timeout_ms = int(timeout_s * 1000)
    if _native is not None:
        return _native.tpujob_barrier_serve(port, world_size, timeout_ms)
    return _py_serve(port, world_size, timeout_ms)


def wait(host: str, port: int, rank: int, timeout_s: float = 300.0) -> int:
    """Check in and block until the gang is complete. 0 on success."""
    timeout_ms = int(timeout_s * 1000)
    if _native is not None:
        return _native.tpujob_barrier_wait(
            host.encode(), port, rank, timeout_ms
        )
    return _py_wait(host, port, rank, timeout_ms)


def gang_barrier(
    *,
    coordinator_host: str,
    port: int,
    rank: int,
    world_size: int,
    timeout_s: float = 300.0,
) -> None:
    """Full gang readiness barrier: rank 0 serves (in a thread) and also
    checks in; everyone returns only when all ranks arrived.

    Raises TimeoutError if the gang does not assemble in time.
    """
    engine = "native" if _native is not None else "python"
    server: Optional[threading.Thread] = None
    serve_rc: list[int] = [0]
    if rank == 0:
        def _run():
            serve_rc[0] = serve(port, world_size, timeout_s)

        server = threading.Thread(target=_run, daemon=True,
                                  name="tpujob-barrier")
        server.start()
        host = "127.0.0.1"  # rank 0 dials its own server locally
    else:
        host = coordinator_host

    log.info("gang barrier (%s): rank %d/%d via %s:%d", engine, rank,
             world_size, host, port)
    rc = wait(host, port, rank, timeout_s)
    if server is not None:
        server.join(timeout=timeout_s)
        if serve_rc[0] != 0:
            raise TimeoutError(
                f"barrier server on rank 0 failed (rc={serve_rc[0]}): "
                f"{world_size - 1} peer(s) missing after {timeout_s:.0f}s"
            )
    if rc != 0:
        raise TimeoutError(
            f"rank {rank} gang barrier timed out after {timeout_s:.0f}s "
            f"(rc={rc})"
        )
