"""Device ms an optimizer step spent in the program's ``cast`` ranges:
every f32 parameter's cast to the compute dtype (``Dense``, the MoE
expert weights) in the forward and the remat recompute, and the
gradients' cast back to f32 in ``cast.bwd``; timed by the program's
CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "cast")
