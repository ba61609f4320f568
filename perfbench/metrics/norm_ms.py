"""Device ms an optimizer step spent in the program's ``norm`` ranges
(``RMSNorm``, BERT's ``LayerNorm``), forward, recompute and backward,
timed by the program's CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "norm")
