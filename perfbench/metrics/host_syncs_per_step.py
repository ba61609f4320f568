"""Device-to-host syncs an optimizer step over the traced window, as the
program notes them while its ranges are armed (``utils/torchtrace.py``),
the harness's own reads left out: 0 where the step has none."""

from perfbench import spans


def read(run):
    p = spans.program(run)
    if p is None or not run.steps:
        return None
    return p.syncs / run.steps
