"""The model's FLOPs a token (``flops/<family>.py``: no remat recompute,
no GShard dispatch or combine) times the traced run's tokens a second,
over the chips' bf16 peak, in %."""

from perfbench import spec
from perfbench.flops import peaks


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    flops = spec.family_module("flops", run.cell.family).flops_per_token(
        run.cell.config, run.cell.traffic)
    return 100.0 * flops * run.tokens / run.window_s / (
        peaks.FLOPS["bf16"] * run.cell.chips)
