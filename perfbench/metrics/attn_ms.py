"""Device ms an optimizer step in the flash kernels (``flash::``)."""

from perfbench.flops import attention


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = sum(sec for name, (_, sec) in run.trace.kernels.items()
            if attention.kind(name) is not None)
    return 1e3 * s / run.steps if s > 0 else None
