"""Device ms an optimizer step launched under the MoE blocks: their
forward, remat recompute and backward (router, dispatch, experts,
combine), from the ranges the harness opens around each ``MoEMLP``."""

RANGES = {"moe": "MoEMLP"}


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = run.trace.ranges.get("moe", 0.0)
    return 1e3 * s / run.steps if s > 0 else None
