"""The flash kernels' summed bound time (``flops/attention.py``, at the
cell's launch shape) over their device time in the trace, in %."""

from perfbench import spec
from perfbench.flops import attention


def read(run):
    if run.trace is None:
        return None
    shape = spec.family_module("flops", run.cell.family).attention_shape(
        run.cell.config, run.cell.traffic)
    bound = spent = 0.0
    for name, (launches, seconds) in run.trace.kernels.items():
        kind = attention.kind(name)
        if kind is None:
            continue
        bound += launches * attention.bound_s(kind, shape)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
