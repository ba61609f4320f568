"""Device ms an optimizer step spent in the program's ``step.backward``
ranges (each microbatch's ``.backward()``: the calling thread waits
there while autograd's thread runs the backward, the remat recompute
included), timed by the program's CUDA events at the ranges' edges."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "step.backward")
