"""Checkpoint/resume for the port's trainer, on
``torch.distributed.checkpoint`` (DCP) (port of
``mpi_operator_tpu/utils/checkpoint.py``).

One DCP checkpoint per step directory ``<directory>/<step>``: the state
is ``{"params": ..., "opt_state": ...}`` as the JAX trainer saves it, with
the port's module names as leaf names (``get_state_dict`` /
``set_state_dict`` of ``torch.distributed.checkpoint.state_dict``). DCP's
format is not orbax's: neither package reads the other's checkpoints
(``interop`` converts parameters where both sides are needed).

Durable-commit contract, unchanged from the JAX package: a step is
written into a temporary directory and renamed into place, then its
*commit marker* (``<directory>/.commits/<step>``, temp -> fsync -> atomic
rename) is published. ``restore_latest`` skips a step without a marker
(a writer killed between the data write and the marker) and falls back
past a step it cannot read, down to a cold start, logging each skip. A
layout with no ``.commits`` directory predates markers and is trusted.

``AsyncCheckpointManager`` moves the write off the step path: ``save``
blocks only on the device-to-host snapshot, and a background thread
lands the DCP write and then the marker. Unlike a JAX array, a torch
parameter or optimizer moment is updated in place by the next step, so
``save`` returns only once a complete host copy exists (non-blocking
copies into reused pinned buffers, then a wait on an event); the writer
thread touches only those host tensors and launches no CUDA work.
``drain_final_save`` is the SIGTERM path: one forced save, drained inside
the termination grace budget.

Across processes (``process_group``, a gloo group of its own): every
rank writes its shards of the state, DTensors as such, so the checkpoint
is sharded and DCP reshards it on restore onto another mesh or world
size; process 0 renames the step into place and publishes the marker
once every rank's write has finished (``dcp.save`` returns on process 0
only then), and a barrier closes the save, so every rank lists the same
steps. The async manager agrees on each save over ``control_group``: a
write still in flight on any rank skips the save on every rank.
"""

from __future__ import annotations

import copy
import os
import shutil
import threading
import time
from typing import Any, Callable, Optional, Union

from ..api.v2beta1 import constants as api_constants
from . import metrics
from .logging import get_logger
from .telemetry import FinalOnce

log = get_logger("checkpoint")

# Subdirectory holding one marker file per durably-committed step. Its
# name is not a step number, so the step listing ignores it.
COMMITS_DIRNAME = ".commits"

# Default grace budget for the preempted final save: under the 30s
# kube default terminationGracePeriodSeconds with headroom for the
# process to exit before SIGKILL.
DEFAULT_FINAL_GRACE_S = 25.0

checkpoint_snapshot_seconds = metrics.new_histogram(
    "tpu_operator_job_checkpoint_snapshot_seconds",
    "Device-to-host state snapshot time per checkpoint save -- the only "
    "checkpoint cost on the training step path for the async manager.",
)
checkpoint_write_seconds = metrics.new_histogram(
    "tpu_operator_job_checkpoint_write_seconds",
    "Durable checkpoint write time (DCP write + commit-marker publish), "
    "off the step path for the async manager.",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             120.0, 300.0),
)
checkpoint_commits_total = metrics.new_counter(
    "tpu_operator_job_checkpoint_commits_total",
    "Checkpoint steps durably committed (commit marker published).",
)

# A state mapping, or a function that builds one (called only once a
# step is to be saved: building the trainer's state dict costs host time).
State = Union[dict, Callable[[], dict]]


def _write_commit_marker(directory: str, step: int) -> None:
    """Publish ``step`` torn-write-safely: write a temp file, fsync it,
    then atomically rename into place. A reader never sees a partial
    marker: either the rename happened (step is durable) or the marker
    does not exist (step is skipped on restore)."""
    commits = os.path.join(directory, COMMITS_DIRNAME)
    os.makedirs(commits, exist_ok=True)
    tmp = os.path.join(commits, f".{step}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(commits, str(step)))
    # Make the rename itself durable where the platform allows it.
    try:
        dir_fd = os.open(commits, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dir_fd)
    except OSError:
        pass
    finally:
        os.close(dir_fd)


def committed_steps(directory: str) -> Optional[set[int]]:
    """The set of durably-committed steps, or ``None`` when the layout
    predates commit markers (no ``.commits`` directory) -- legacy
    checkpoints stay restorable without markers."""
    commits = os.path.join(directory, COMMITS_DIRNAME)
    try:
        names = os.listdir(commits)
    except FileNotFoundError:
        return None
    out: set[int] = set()
    for name in names:
        try:
            out.add(int(name))
        except ValueError:
            continue  # in-flight temp files
    return out


def _errors() -> tuple:
    """What a failed DCP read or write raises: its ``CheckpointException``
    derives from ``BaseException``, so ``except Exception`` alone misses
    it."""
    from torch.distributed.checkpoint.api import CheckpointException

    return (Exception, CheckpointException)


def _map_tree(fn, tree, path: tuple = ()):
    """Rebuild a nest of dicts, lists and tuples with ``fn(leaf, path)``
    at each leaf."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tree(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, path)


def _with_local(dtensor, local):
    """A DTensor of ``dtensor``'s mesh, placements and global shape over
    the tensor ``local`` as this rank's shard (wherever ``local`` lives:
    DCP reads and writes the shard through it)."""
    from torch.distributed.tensor import DTensor

    return DTensor(local, dtensor._spec, requires_grad=False)


def _host_copy(state: dict, buffers: dict) -> dict:
    """A complete host copy of ``state``, finished when this returns.

    CUDA tensors go into pinned buffers kept in ``buffers`` (by path,
    reused across saves: only one write is ever in flight, and the next
    snapshot starts after it landed) by non-blocking copies on the
    current stream, which follow the step that wrote the tensors; one
    event wait at the end covers them all. CPU tensors (the CPU path, and
    AdamW's step counts on the card) are cloned: the optimizer updates
    them in place too. A DTensor's local shard is copied so, and stays a
    DTensor with its placements, so that DCP writes it as a shard."""
    import torch
    from torch.distributed.tensor import DTensor

    devices = set()

    def copy_tensor(leaf, path):
        if not leaf.is_cuda:
            return leaf.clone()
        buf = buffers.get(path)
        if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            buffers[path] = buf
        buf.copy_(leaf, non_blocking=True)
        devices.add(leaf.device)
        return buf

    def copy_leaf(leaf, path):
        if not isinstance(leaf, torch.Tensor):
            return copy.deepcopy(leaf)
        leaf = leaf.detach()
        if isinstance(leaf, DTensor):
            return _with_local(leaf, copy_tensor(leaf.to_local(), path))
        return copy_tensor(leaf, path)

    host = _map_tree(copy_leaf, state)
    for device in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return host


def _host_template(like: dict) -> dict:
    """``like``'s structure with an empty CPU tensor of each tensor
    leaf's shape and dtype (for a DTensor, an empty CPU shard under its
    placements): what a restore loads into before anything of the
    caller's state is touched."""
    import torch
    from torch.distributed.tensor import DTensor

    def empty(leaf, path):
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            return _with_local(leaf, torch.empty(local.shape,
                                                 dtype=local.dtype))
        if isinstance(leaf, torch.Tensor):
            return torch.empty(leaf.shape, dtype=leaf.dtype)
        return copy.deepcopy(leaf)

    return _map_tree(empty, like)


class CheckpointManager:
    """save-every-N / keep-K / resume-latest, DCP-backed and synchronous:
    ``save`` returns once the step and its marker are on disk.

    ``process_group``: the gloo group a world of several processes saves
    and restores over (every rank calls ``save`` and ``restore_latest``
    at the same steps); None for one process. ``control_group``: the
    group the async manager agrees on each save over."""

    def __init__(self, directory: str, *, save_interval_steps: int = 100,
                 max_to_keep: Optional[int] = 3, process_group=None,
                 control_group=None):
        if save_interval_steps < 1:
            raise ValueError(
                f"save_interval_steps must be >= 1, got {save_interval_steps}")
        self.directory = directory
        self._interval = int(save_interval_steps)
        self.max_to_keep = max_to_keep
        self._buffers: dict = {}
        self._group = process_group
        self._control = control_group
        self._rank = 0
        if process_group is not None:
            import torch.distributed as dist

            self._rank = dist.get_rank()
        # One-shot latch for the preempted final save: however many
        # paths race to save-on-SIGTERM, exactly one drains and records
        # (see drain_final_save).
        self.final_latch = FinalOnce()

    # -- steps on disk ----------------------------------------------------

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        """Every step directory, ascending (committed or not)."""
        try:
            names = os.listdir(self.directory)
        except (FileNotFoundError, NotADirectoryError):
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """orbax's default decision (``CheckpointManager.should_save``
        with ``save_interval_steps``): never at or below the newest step
        on disk; otherwise on the interval, or when no checkpoint exists
        yet (its ``InitialSavePolicy``)."""
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self._interval == 0 or not steps

    # -- save -------------------------------------------------------------

    def save(self, step: int, state: State, *, force: bool = False) -> bool:
        """Save if the interval policy says so (or ``force``). A step that
        already exists is never re-saved."""
        if step in self.all_steps():
            return False
        if not force and not self.should_save(step):
            return False
        t0 = time.perf_counter()
        host = _host_copy(state() if callable(state) else state,
                          self._buffers)
        t1 = time.perf_counter()
        checkpoint_snapshot_seconds.observe(t1 - t0)
        try:
            self._write_step(step, host)
            if self._rank == 0:  # process 0 publishes the marker and prunes
                _write_commit_marker(self.directory, step)
                checkpoint_commits_total.inc()
                self._prune()
        finally:
            self._barrier()
        checkpoint_write_seconds.observe(time.perf_counter() - t1)
        log.info("checkpoint saved at step %d -> %s", step, self.directory)
        return True

    def _dcp_args(self) -> dict:
        return ({"no_dist": True} if self._group is None
                else {"process_group": self._group})

    def _barrier(self) -> None:
        """Every rank of the save's group, here (a no-op alone)."""
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def _write_step(self, step: int, host_state: dict) -> None:
        """The DCP write into ``.<step>.tmp``, renamed to ``<step>`` once
        complete (by process 0, once every rank's shards are written), so
        a step directory is never half written."""
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f".{step}.tmp")
        if self._rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        dcp.save(host_state, checkpoint_id=tmp, **self._dcp_args())
        if self._rank == 0:
            os.replace(tmp, self._step_path(step))

    def _prune(self) -> None:
        """Keep the newest ``max_to_keep`` steps (orbax's ``LatestN``); a
        pruned step loses its marker first, then its data."""
        if not self.max_to_keep:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            try:
                os.unlink(os.path.join(self.directory, COMMITS_DIRNAME,
                                       str(step)))
            except FileNotFoundError:
                pass
            shutil.rmtree(self._step_path(step), ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def restore_latest(self, like: dict, *, optional: tuple = ()
                       ) -> tuple[Optional[int], Any]:
        """Read the newest committed, readable step shaped like ``like``
        (the freshly built state: its keys, shapes and dtypes). Returns
        ``(step, state)`` with the state in host tensors, or
        ``(None, like)`` when nothing is readable.

        ``optional`` is the key path of a mapping in ``like`` whose
        entries a step may lack (the optimizer's per-parameter state,
        which exists only for parameters that got a gradient): such an
        entry is left out of that step's read. Every other key must be
        stored.

        A step with no commit marker (the writer died between the data
        write and the marker publish) is skipped before any read; an
        unreadable step (truncated, or of another shape) is skipped after
        its read fails; each skip is logged. ``like`` itself is never
        written, so a failed read leaves the caller's state as it was."""
        import torch.distributed.checkpoint as dcp

        steps = sorted(self.all_steps(), reverse=True)
        committed = committed_steps(self.directory)
        for step in steps:
            if committed is not None and step not in committed:
                log.warning(
                    "checkpoint at step %d has no commit marker (torn "
                    "write); falling back to an older step", step,
                )
                continue
            state = _host_template(like)
            try:
                if optional:
                    self._drop_unstored(step, state, optional)
                dcp.load(state, checkpoint_id=self._step_path(step),
                         **self._dcp_args())
            except _errors() as e:
                log.warning(
                    "checkpoint at step %d is unreadable (%s: %s); "
                    "falling back to an older step",
                    step, type(e).__name__, e,
                )
                continue
            log.info("resumed from checkpoint step %d (%s)", step,
                     self.directory)
            return step, state
        if steps:
            log.warning("no readable checkpoint among steps %s; starting "
                        "cold", steps)
        return None, like

    def _stored(self, step: int) -> dict:
        """Step ``step``'s DCP metadata: flattened key -> what is stored."""
        import torch.distributed.checkpoint as dcp

        reader = dcp.FileSystemReader(self._step_path(step))
        return reader.read_metadata().state_dict_metadata

    def _drop_unstored(self, step: int, state: dict, path: tuple) -> None:
        """Remove each entry of ``state[path...]`` with no stored key."""
        entries = state
        for key in path:
            entries = entries[key]
        stored = self._stored(step)
        prefix = ".".join(path)
        for name in list(entries):
            head = f"{prefix}.{name}."
            if not any(k.startswith(head) for k in stored):
                del entries[name]

    def read_step(self, step: int, prefix: str = "") -> dict:
        """Every tensor of step ``step`` whose flattened name (DCP's
        dotted keys, e.g. ``params.layer_0.attn.wq.weight``) starts with
        ``prefix``, as host tensors keyed by that name. DCP reads only
        these keys."""
        import torch
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata,
        )

        flat = {
            k: torch.empty(m.size, dtype=m.properties.dtype)
            for k, m in self._stored(step).items()
            if isinstance(m, TensorStorageMetadata) and k.startswith(prefix)
        }
        if flat:
            dcp.load(flat, checkpoint_id=self._step_path(step), no_dist=True)
        return flat

    def read_latest(self) -> tuple[Optional[int], Any]:
        """Inspection/tooling path: the newest step's tensors as host
        tensors, ``{"params": {name: t}, "opt_state": {name: t}}``, with
        no template. NOT for training resume -- use
        :meth:`restore_latest` there."""
        step = self.latest_step()
        if step is None:
            return None, None
        state: dict = {}
        for key, t in self.read_step(step).items():
            top, _, rest = key.partition(".")
            state.setdefault(top, {})[rest] = t
        return step, state

    # -- lifetime ---------------------------------------------------------

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for any in-flight write to land; True when nothing is
        left in flight. The synchronous manager has no background writer,
        so this is trivially true -- the async subclass joins its
        writer."""
        return True

    def close(self) -> None:
        self.drain(None)
        self._buffers.clear()


class AsyncCheckpointManager(CheckpointManager):
    """Checkpointing off the training step path.

    ``save`` blocks only on the device-to-host snapshot (timed into
    ``checkpoint_snapshot_seconds``); a background thread lands the DCP
    write and then publishes the commit marker (timed into
    ``checkpoint_write_seconds``). At most one write is in flight: a save
    arriving while the writer is busy is *skipped* (a forced one drains
    first), which keeps the step-path cost flat however aggressive the
    save interval. A failed write is logged, never raised into the
    trainer.

    Chaos hook: ``TPUJOB_CHAOS_TORN_WRITE`` in the environment tears the
    next commit -- the step data is written but the marker is withheld,
    the exact on-disk state a writer killed between data write and
    marker publish leaves behind.
    """

    def __init__(self, directory: str, *, save_interval_steps: int = 100,
                 max_to_keep: Optional[int] = 3, process_group=None,
                 control_group=None):
        super().__init__(directory, save_interval_steps=save_interval_steps,
                         max_to_keep=max_to_keep, process_group=process_group,
                         control_group=control_group)
        self._writer: Optional[threading.Thread] = None
        self._tear_next = os.environ.get(
            api_constants.ENV_TORN_WRITE, "") not in ("", "0")
        self.torn_writes = 0  # commits torn by the chaos hook

    def save(self, step: int, state: State, *, force: bool = False) -> bool:
        """Snapshot to host and hand the write to the background thread.
        Blocking cost: the device-to-host copy only."""
        if not force and step % self._interval != 0:
            return False
        if force:
            # A forced save waits for the write in flight (which may be
            # this very step): after it every rank lists the same steps.
            self.drain(None)
        if step in self.all_steps():
            return False
        if self._busy():
            # One write in flight at a time: skipping (rather than
            # queueing) bounds the step-path cost and the host memory
            # footprint regardless of save frequency.
            log.info("checkpoint write still in flight; skipping save "
                     "at step %d", step)
            return False
        t0 = time.perf_counter()
        host = _host_copy(state() if callable(state) else state,
                          self._buffers)
        checkpoint_snapshot_seconds.observe(time.perf_counter() - t0)
        writer = threading.Thread(target=self._write, args=(step, host),
                                  name=f"ckpt-write-{step}", daemon=True)
        self._writer = writer
        writer.start()
        return True

    def _busy(self) -> bool:
        """A write in flight here, or (across processes) on any rank."""
        busy = self._writer is not None and self._writer.is_alive()
        if self._control is None:
            return busy
        from ..parallel.sharding import any_process

        return any_process(busy, self._control)

    def _write(self, step: int, host_state: dict) -> None:
        t0 = time.perf_counter()
        try:
            self._write_step(step, host_state)
            if self._rank != 0:
                return  # process 0 publishes the marker and prunes
            if self._tear_next:
                # Chaos: die "mid-commit" -- data on disk, no marker.
                self._tear_next = False
                self.torn_writes += 1
                log.warning(
                    "chaos: tore checkpoint commit at step %d (step data "
                    "written, commit marker withheld)", step,
                )
            else:
                _write_commit_marker(self.directory, step)
                checkpoint_commits_total.inc()
                log.info("checkpoint committed at step %d -> %s", step,
                         self.directory)
            self._prune()
        except _errors() as e:
            # The writer thread must never take the trainer down: a
            # failed background save costs one interval, nothing more.
            log.warning(
                "background checkpoint write at step %d failed (%s: %s)",
                step, type(e).__name__, e,
            )
        finally:
            self._barrier()
            checkpoint_write_seconds.observe(time.perf_counter() - t0)

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Join the in-flight write (bounded when ``timeout_s`` is set);
        True when nothing is left in flight afterwards."""
        writer = self._writer
        if writer is None or not writer.is_alive():
            return True
        writer.join(timeout_s)
        return not writer.is_alive()


def drain_final_save(
    ckpt: CheckpointManager,
    step: int,
    state: State,
    telem=None,
    *,
    grace_s: float = DEFAULT_FINAL_GRACE_S,
    clock=time.perf_counter,
) -> bool:
    """The preempted final save: force-save ``state`` and drain the
    write inside the termination grace budget.

    Guarded by the manager's ``final_latch`` (``FinalOnce``): however
    many paths race here on SIGTERM, exactly one performs the save --
    later calls are no-ops returning False, so telemetry never records
    the final checkpoint twice. The drain budget is ``grace_s`` minus
    whatever the save itself spent (measured on ``clock`` so tests can
    drive it on a fake clock). Returns True when the checkpoint fully
    drained within the budget; the wall time spent is recorded into
    ``telem`` (``record_checkpoint``) either way.
    """
    if not ckpt.final_latch.claim():
        return False
    t0 = clock()
    drained = False
    try:
        ckpt.save(step, state, force=True)
        remaining = max(0.0, grace_s - (clock() - t0))
        drained = ckpt.drain(remaining)
        if not drained:
            log.warning(
                "final checkpoint at step %d still in flight after the "
                "%.1fs grace budget; exiting without it", step, grace_s,
            )
    except _errors() as e:
        log.warning(
            "final checkpoint save at step %d failed (%s: %s)",
            step, type(e).__name__, e,
        )
    finally:
        if telem is not None:
            telem.record_checkpoint(max(0.0, clock() - t0))
    return drained


def read_llama_params(checkpoint_dir: str, model_name: str):
    """cmd.eval's checkpoint loader: the newest step's ``params`` as host
    tensors keyed by the port's module names; DCP reads no other entry.
    Raises ``SystemExit`` with operator-facing messages (this serves a
    CLI). Returns ``(step, params)``."""
    ckpt = CheckpointManager(checkpoint_dir)
    step = ckpt.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint found under {checkpoint_dir}")
    flat = ckpt.read_step(step, prefix="params.")
    if not flat:
        raise SystemExit(
            f"checkpoint at step {step} has no 'params' entry -- was it "
            f"written by cmd.train?"
        )
    params = {k[len("params."):]: v for k, v in flat.items()}
    if any(k.startswith("blocks.") for k in params):
        raise SystemExit(
            f"checkpoint at step {step} holds a stage-stacked 'blocks' "
            f"layout (a pipelined run); reading it for {model_name} is not "
            f"ported yet (ROADMAP.md queue (a) item 16)"
        )
    return step, params
