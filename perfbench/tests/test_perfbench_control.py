"""The control (the reference computed in fp8 in the program's place)
comes out not correct under each cell's limits; at tiny size on the CPU
here, at the cell's own size on the card."""

import pytest
import torch

from perfbench import check, run, spec
from perfbench.tests import tiny


def _control(cell, seed, device, tmp_path):
    prog = run.Program(cell, seed, device, str(tmp_path))
    prog.free()
    ref = prog.reference()
    sound = check.verdict(check.gaps(prog.signature, ref),
                          cell.workload["check"]["limits"])[0]
    control = check.verdict(check.gaps(prog.reference(precision="fp8"), ref),
                            cell.workload["check"]["limits"])[0]
    return sound, control


@pytest.mark.parametrize("family,cell", [
    ("mixtral", "mixtral-2l.pretrain-s4096"),
    ("bert", "bert-base.phase2-s512"),
    ("bert", "bert-base.phase1-s128")])
def test_control_fails_tiny(family, cell, tmp_path):
    sound, control = _control(tiny.cell(family, cell), 31337,
                              torch.device("cpu"), tmp_path)
    assert sound and not control


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mixtral-2l.pretrain-s4096",
                                  "bert-base.phase2-s512",
                                  "bert-base.phase1-s128"])
def test_control_fails_on_card(card, cell, tmp_path):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        sound, control = _control(spec.load(cell), seed, card, tmp_path)
        assert sound and not control, seed
