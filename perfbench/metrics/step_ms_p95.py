"""The 95th percentile of the optimizer steps' times in the window, each
the time between CUDA events recorded at its two boundaries."""

import statistics


def read(run):
    if len(run.step_ms) < 20:
        return None
    return statistics.quantiles(run.step_ms, n=20, method="inclusive")[18]
