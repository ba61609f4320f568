"""Device ms an optimizer step spent in the program's ``moe.experts``
ranges: the three expert products and SiLU; forward, recompute,
backward; timed by the program's CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "moe.experts")
