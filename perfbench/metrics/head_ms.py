"""Device ms an optimizer step spent in the program's ``head`` ranges:
the LM head and its chunked cross-entropy (Llama, Mixtral), or BERT's
slot gather through the MLM head's logits and the weighted
cross-entropy; forward and backward, the casts inside included; timed
by the program's CUDA events (``spans.py``)."""

from perfbench import spans


def read(run):
    return spans.range_ms(run, "head")
