"""Device ms an optimizer step spent in the program's ``step.forward``
ranges (``parallel/accum.py``: each microbatch's loss), timed by the
program's CUDA events at the ranges' edges (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "step.forward")
