"""The port's checkpoint layer (``mpi_operator_tpu_torch/utils/checkpoint.py``,
on ``torch.distributed.checkpoint``) held to the scenarios of
``tests/test_checkpoint.py``: the torn-write-safe commit marker, restore's
fallback past a step with no marker or an unreadable one down to a cold
start, the ``AsyncCheckpointManager`` (background commit, interval, one
write in flight, the torn-write chaos hook, a snapshot that later
in-place updates cannot reach), ``drain_final_save`` on a fake clock,
and the saved-step set of the synchronous manager against orbax's.
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from mpi_operator_tpu.utils.checkpoint import (
    CheckpointManager as OrbaxCheckpointManager,
)
from mpi_operator_tpu_torch.api.v2beta1 import constants
from mpi_operator_tpu_torch.utils import checkpoint as ckptlib
from mpi_operator_tpu_torch.utils import metrics
from mpi_operator_tpu_torch.utils.checkpoint import (
    COMMITS_DIRNAME,
    AsyncCheckpointManager,
    CheckpointManager,
    committed_steps,
    drain_final_save,
    read_llama_params,
)
from mpi_operator_tpu_torch.utils.telemetry import FinalOnce, TrainingTelemetry

pytestmark = pytest.mark.kernel


def tiny_state(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 2, generator=g),
                   "b.bias": torch.randn(2, generator=g)},
        "opt_state": {"step": torch.tensor(float(seed))},
    }


def like_state() -> dict:
    return {
        "params": {"w": torch.zeros(4, 2), "b.bias": torch.zeros(2)},
        "opt_state": {"step": torch.zeros(())},
    }


def assert_state_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for top in want:
        assert got[top].keys() == want[top].keys()
        for k in want[top]:
            torch.testing.assert_close(got[top][k], want[top][k], rtol=0,
                                       atol=0)


def marker_path(directory, step: int) -> str:
    return os.path.join(str(directory), COMMITS_DIRNAME, str(step))


def corrupt(directory, step: int):
    """Truncate every data file of a step: the read fails."""
    step_dir = os.path.join(str(directory), str(step))
    for name in os.listdir(step_dir):
        if name.endswith(".distcp"):
            with open(os.path.join(step_dir, name), "r+b") as f:
                f.truncate(3)


class TestCommitMarkers:
    def test_sync_save_publishes_marker(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        assert mgr.save(1, tiny_state(1), force=True)
        mgr.close()
        assert committed_steps(str(tmp_path)) == {1}
        with open(marker_path(tmp_path, 1)) as f:
            assert f.read() == "1"

    def test_committed_steps_none_for_legacy_layout(self, tmp_path):
        assert committed_steps(str(tmp_path)) is None

    def test_committed_steps_ignores_inflight_temp_files(self, tmp_path):
        commits = tmp_path / COMMITS_DIRNAME
        commits.mkdir()
        (commits / "3").write_text("3")
        (commits / ".7.tmp").write_text("7")  # writer died pre-rename
        assert committed_steps(str(tmp_path)) == {3}

    def test_restore_skips_step_without_marker(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(1, tiny_state(1), force=True)
        mgr.save(2, tiny_state(2), force=True)
        mgr.close()
        os.unlink(marker_path(tmp_path, 2))  # torn after the fact

        step, state = CheckpointManager(str(tmp_path)).restore_latest(
            like_state())
        assert step == 1
        assert_state_equal(state, tiny_state(1))

    def test_restore_trusts_legacy_checkpoints_without_markers(
            self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(5, tiny_state(5), force=True)
        mgr.close()
        shutil.rmtree(tmp_path / COMMITS_DIRNAME)
        step, state = CheckpointManager(str(tmp_path)).restore_latest(
            like_state())
        assert step == 5
        assert_state_equal(state, tiny_state(5))

    def test_unreadable_step_falls_back_then_cold_start(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        for s in (1, 2, 3):
            mgr.save(s, tiny_state(s), force=True)
        corrupt(tmp_path, 3)
        step, state = mgr.restore_latest(like_state())
        assert step == 2
        assert_state_equal(state, tiny_state(2))

        corrupt(tmp_path, 2)
        corrupt(tmp_path, 1)
        like = like_state()
        step, state = mgr.restore_latest(like)
        assert step is None and state is like
        assert_state_equal(like, like_state())  # the template is untouched

    def test_a_step_of_another_shape_is_unreadable(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(1, tiny_state(1), force=True)
        like = like_state()
        like["params"]["w"] = torch.zeros(3, 2)
        assert mgr.restore_latest(like)[0] is None

    def test_empty_directory_is_a_cold_start(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "none"))
        assert mgr.latest_step() is None
        assert mgr.restore_latest(like_state())[0] is None
        assert mgr.read_latest() == (None, None)
        assert not (tmp_path / "none").exists()  # reading creates nothing


class TestSaveDecision:
    @pytest.mark.parametrize("interval", [1, 2, 3])
    def test_saved_steps_match_orbax(self, tmp_path, interval):
        """Steps 1..7, max_to_keep 2: the same save decisions and the
        same steps on disk after every save as the JAX package's orbax
        manager -- including orbax's initial save at step 1 whatever the
        interval."""
        ours = CheckpointManager(str(tmp_path / "t"),
                                 save_interval_steps=interval, max_to_keep=2)
        theirs = OrbaxCheckpointManager(str(tmp_path / "j"),
                                        save_interval_steps=interval,
                                        max_to_keep=2)
        try:
            for step in range(1, 8):
                state = tiny_state(step)
                saved = ours.save(step, state)
                want = theirs.save(step, {
                    "params": {k: v.numpy()
                               for k, v in state["params"].items()},
                    "step": np.asarray(step, np.int32)})
                assert saved == want, step
                assert ours.all_steps() == list(theirs._mgr.all_steps()), step
        finally:
            theirs.close()
        assert committed_steps(str(tmp_path / "t")) == set(ours.all_steps())

    def test_existing_step_is_never_resaved(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        assert mgr.save(2, tiny_state(2))
        assert not mgr.save(2, tiny_state(9), force=True)
        assert not mgr.save(1, tiny_state(1))  # below the newest step
        assert_state_equal(mgr.restore_latest(like_state())[1],
                           tiny_state(2))

    def test_state_function_is_called_only_for_a_saved_step(self, tmp_path):
        calls = []

        def state_fn():
            calls.append(1)
            return tiny_state(4)

        mgr = CheckpointManager(str(tmp_path), save_interval_steps=4)
        assert mgr.save(1, state_fn)  # orbax's initial save
        assert not mgr.save(2, state_fn) and not mgr.save(3, state_fn)
        assert mgr.save(4, state_fn)
        assert len(calls) == 2

    def test_interval_below_one_is_refused(self, tmp_path):
        with pytest.raises(ValueError, match="save_interval_steps"):
            CheckpointManager(str(tmp_path), save_interval_steps=0)


class TestReaders:
    def test_read_latest_returns_host_tensors_by_entry(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(3, tiny_state(3), force=True)
        step, state = mgr.read_latest()
        assert step == 3
        assert_state_equal(state, tiny_state(3))

    def test_read_llama_params_reads_params_only(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(2, tiny_state(2), force=True)
        step, params = read_llama_params(str(tmp_path), "llama-tiny")
        assert step == 2 and params.keys() == {"w", "b.bias"}
        torch.testing.assert_close(params["w"], tiny_state(2)["params"]["w"])

    def test_read_llama_params_refusals(self, tmp_path):
        with pytest.raises(SystemExit, match="no checkpoint found"):
            read_llama_params(str(tmp_path / "none"), "llama-tiny")
        mgr = CheckpointManager(str(tmp_path / "a"), save_interval_steps=1)
        mgr.save(1, {"opt_state": {"x": torch.zeros(2)}}, force=True)
        with pytest.raises(SystemExit, match="no 'params' entry"):
            read_llama_params(str(tmp_path / "a"), "llama-tiny")
        mgr = CheckpointManager(str(tmp_path / "b"), save_interval_steps=1)
        mgr.save(1, {"params": {"blocks.wq": torch.zeros(2, 1, 3)}},
                 force=True)
        with pytest.raises(SystemExit, match=r"queue \(a\) item 16"):
            read_llama_params(str(tmp_path / "b"), "llama-tiny")


class TestAsyncCheckpointManager:
    def test_save_commits_in_background(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        assert mgr.save(1, tiny_state(1)) is True
        assert mgr.drain(10.0) is True
        mgr.close()
        assert committed_steps(str(tmp_path)) == {1}
        step, state = CheckpointManager(str(tmp_path)).restore_latest(
            like_state())
        assert step == 1
        assert_state_equal(state, tiny_state(1))

    def test_snapshot_is_complete_when_save_returns(self, tmp_path):
        """An optimizer updates parameters and moments in place: what the
        writer lands is the state at ``save``, not after the next step."""
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        live = tiny_state(1)
        assert mgr.save(1, live)
        for part in live.values():
            for t in part.values():
                t.add_(100.0)  # the next step, while the write may run
        assert mgr.drain(10.0)
        assert_state_equal(mgr.restore_latest(like_state())[1],
                           tiny_state(1))

    def test_save_interval_policy(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=2)
        assert mgr.save(1, tiny_state(1)) is False  # off-interval
        assert mgr.save(2, tiny_state(2)) is True
        assert mgr.drain(10.0)
        assert mgr.save(2, tiny_state(2)) is False  # already saved
        mgr.close()

    def test_write_in_flight_skips_save(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        gate = threading.Event()
        busy = threading.Thread(target=gate.wait, name="fake-writer")
        busy.start()
        mgr._writer = busy
        try:
            assert mgr.save(3, tiny_state(3)) is False
        finally:
            gate.set()
            busy.join(10)
        assert not busy.is_alive()
        mgr.close()
        assert committed_steps(str(tmp_path)) in (None, set())

    def test_forced_save_drains_the_write_in_flight(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        gate = threading.Event()
        busy = threading.Thread(target=gate.wait, name="fake-writer")
        busy.start()
        mgr._writer = busy
        threading.Timer(0.2, gate.set).start()
        assert mgr.save(4, tiny_state(4), force=True) is True
        assert mgr.drain(10.0)
        assert committed_steps(str(tmp_path)) == {4}

    def test_env_torn_write_tears_exactly_one_commit(self, tmp_path,
                                                     monkeypatch):
        mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(1, tiny_state(1), force=True)

        monkeypatch.setenv(constants.ENV_TORN_WRITE, "1")
        torn = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        assert torn.save(2, tiny_state(2)) is True
        assert torn.drain(10.0)
        assert torn.torn_writes == 1
        assert committed_steps(str(tmp_path)) == {1}
        assert 2 in torn.all_steps()  # the data is on disk, uncommitted
        assert torn.save(3, tiny_state(3)) is True
        assert torn.drain(10.0)
        assert torn.torn_writes == 1
        torn.close()
        assert committed_steps(str(tmp_path)) == {1, 3}
        step, _ = CheckpointManager(str(tmp_path)).restore_latest(
            like_state())
        assert step == 3

    def test_failed_write_is_logged_not_raised(self, tmp_path, capsys):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        mgr = AsyncCheckpointManager(str(blocker / "ckpt"),
                                     save_interval_steps=1)
        assert mgr.save(1, tiny_state(1)) is True
        assert mgr.drain(10.0)
        assert "background checkpoint write at step 1 failed" in (
            capsys.readouterr().err)

    def test_snapshot_and_write_times_reach_the_histograms(self, tmp_path):
        before = [h.sample_count() for h in (
            ckptlib.checkpoint_snapshot_seconds,
            ckptlib.checkpoint_write_seconds)]
        commits = ckptlib.checkpoint_commits_total.value()
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=1)
        mgr.save(1, tiny_state(1))
        assert mgr.drain(10.0)
        after = [h.sample_count() for h in (
            ckptlib.checkpoint_snapshot_seconds,
            ckptlib.checkpoint_write_seconds)]
        assert [a - b for a, b in zip(after, before)] == [1, 1]
        assert ckptlib.checkpoint_commits_total.value() == commits + 1


class FakeClock:
    def __init__(self, now: float = 100.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


class StubManager:
    """drain_final_save's contract surface, with scripted timing."""

    def __init__(self, clock: FakeClock, *, save_cost_s: float = 0.0,
                 drain_cost_s: float = 0.0, fail_save: bool = False):
        self.final_latch = FinalOnce()
        self._clock = clock
        self._save_cost = save_cost_s
        self._drain_cost = drain_cost_s
        self._fail_save = fail_save
        self.saves: list[int] = []
        self.drain_budgets: list[float] = []

    def save(self, step, state, *, force=False):
        if self._fail_save:
            raise RuntimeError("disk gone")
        self.saves.append(step)
        self._clock.now += self._save_cost
        return True

    def drain(self, timeout_s=None):
        self.drain_budgets.append(timeout_s)
        spent = self._drain_cost
        if timeout_s is not None and spent > timeout_s:
            self._clock.now += timeout_s
            return False
        self._clock.now += spent
        return True


def _telemetry(clock):
    return TrainingTelemetry(clock=clock, registry=metrics.Registry())


class TestDrainFinalSave:
    def test_drains_within_grace_and_records_telemetry(self):
        clock = FakeClock()
        mgr = StubManager(clock, save_cost_s=3.0, drain_cost_s=4.0)
        telem = _telemetry(clock)
        assert drain_final_save(mgr, 7, {"x": 1}, telem, grace_s=10.0,
                                clock=clock) is True
        assert mgr.saves == [7]
        assert mgr.drain_budgets == [pytest.approx(7.0)]
        assert telem._checkpoint_s == pytest.approx(7.0)

    def test_grace_budget_exhausted_returns_false(self):
        clock = FakeClock()
        mgr = StubManager(clock, save_cost_s=2.0, drain_cost_s=60.0)
        telem = _telemetry(clock)
        assert drain_final_save(mgr, 7, {"x": 1}, telem, grace_s=5.0,
                                clock=clock) is False
        assert telem._checkpoint_s == pytest.approx(5.0)

    def test_final_latch_claims_exactly_once(self):
        clock = FakeClock()
        mgr = StubManager(clock, save_cost_s=1.0)
        telem = _telemetry(clock)
        assert drain_final_save(mgr, 7, {"x": 1}, telem, grace_s=10.0,
                                clock=clock) is True
        assert drain_final_save(mgr, 8, {"x": 1}, telem, grace_s=10.0,
                                clock=clock) is False
        assert mgr.saves == [7]
        assert telem._checkpoint_s == pytest.approx(1.0)

    def test_save_failure_still_records_and_releases(self):
        clock = FakeClock()
        mgr = StubManager(clock, fail_save=True)
        telem = _telemetry(clock)
        assert drain_final_save(mgr, 7, {"x": 1}, telem, grace_s=10.0,
                                clock=clock) is False
        assert telem._checkpoint_s == pytest.approx(0.0)

    def test_real_async_manager_lands_the_final_step(self, tmp_path):
        mgr = AsyncCheckpointManager(str(tmp_path), save_interval_steps=100)
        assert drain_final_save(mgr, 7, lambda: tiny_state(7), None,
                                grace_s=30.0) is True
        assert committed_steps(str(tmp_path)) == {7}

    def test_grace_default_matches_kube_termination_window(self):
        assert ckptlib.DEFAULT_FINAL_GRACE_S < 30.0


def test_checkpoint_seconds_reach_the_telemetry_record(tmp_path):
    path = tmp_path / "t.jsonl"
    telem = TrainingTelemetry(registry=metrics.Registry(), interval=1,
                              jsonl_path=str(path))
    telem.start()
    telem.record_step(1, 0.01)
    telem.record_checkpoint(0.25)
    telem.record_checkpoint(-1.0)  # never negative
    telem.close(2, final=True)
    import json

    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert "checkpoint_s" not in recs[0]
    assert recs[-1]["checkpoint_s"] == 0.25
