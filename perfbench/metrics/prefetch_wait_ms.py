"""Host ms an optimizer step waited for its batch inside the program's
``data.wait`` ranges (``data/loader.py:Prefetcher``) over the traced
window."""

from perfbench import spans


def read(run):
    p = spans.program(run)
    if p is None or not run.steps or "data.wait" not in p.host:
        return None
    return 1e3 * p.host["data.wait"] / run.steps
