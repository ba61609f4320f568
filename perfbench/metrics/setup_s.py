"""From the harness's start to the first timed step: imports, the
kernels built or loaded, the token file written, the workload built and
its weights drawn, the checked steps and the warm-up."""


def read(run):
    return run.setup_s
