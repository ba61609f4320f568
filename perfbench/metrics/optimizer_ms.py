"""Device ms an optimizer step in the AdamW kernels (torch's multi-tensor
``multi_tensor_apply`` kernels, which ``optimizer.step`` launches)."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    s = sum(sec for name, (_, sec) in run.trace.kernels.items()
            if "multi_tensor_apply" in name)
    return 1e3 * s / run.steps if s > 0 else None
