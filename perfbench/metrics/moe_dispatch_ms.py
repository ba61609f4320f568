"""Device ms an optimizer step spent in the program's ``moe.dispatch``
and ``moe.combine`` ranges: the GShard products that move tokens into
expert slots and back; forward, recompute, backward; timed by the
program's CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "moe.dispatch", "moe.combine")
