"""Device ms an optimizer step spent in the program's ``moe.route``
ranges: the router product, softmax, GShard routing and the dispatch
and combine tensors' casts; forward, recompute, backward; timed by the
program's CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "moe.route")
