"""A run whose timed path is broken underneath comes out not correct:
the step that leaves its state unchanged, the step that leaves out half
its batch (the mean over the rest), and the step whose answer (its loss)
is altered where it is produced. Tiny cells on the CPU, under each real
cell's limits; everything but the look for a chip is the run's."""

import pytest
import torch

from perfbench import run, trainer
from perfbench.tests import tiny


def _unchanged(work):
    work.optimizer.step = lambda *a, **k: None


def _half(work):
    step = work.step_fn

    def half(*batch):
        return step(*(t[:t.shape[0] // 2] for t in batch))

    work.step_fn = half


def _answer(work):
    step = work.step_fn
    work.step_fn = lambda *batch: step(*batch) * 1.02


@pytest.mark.parametrize("fault", [_unchanged, _half, _answer],
                         ids=["unchanged", "half", "answer"])
@pytest.mark.parametrize("family,cell", [
    ("mixtral", "mixtral-2l.pretrain-s4096"),
    ("bert", "bert-base.phase2-s512"),
    ("bert", "bert-base.phase1-s128")])
def test_fault_is_not_correct(monkeypatch, fault, family, cell):
    build = trainer.build

    def broken(*a, **k):
        args, work = build(*a, **k)
        fault(work)
        return args, work

    monkeypatch.setattr(trainer, "build", broken)
    r = run.execute(tiny.cell(family, cell), 4242, 0.3, False,
                    torch.device("cpu"))
    assert r["correct"] is False
