"""The top-k choices the GShard capacity dropped over the choices made,
in %, from the two device counters ``models/moe.py:routing`` keeps while
the program's ranges are armed (read once, after the window; the remat
recompute counts both again)."""

from perfbench import spans


def read(run):
    p = spans.program(run)
    made = p.counts.get("moe.choices", 0) if p is not None else 0
    if not made:
        return None
    return 100.0 * p.counts.get("moe.dropped", 0) / made
