"""Every token the job trained in the window over the window's seconds
(device synchronized at both ends)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
