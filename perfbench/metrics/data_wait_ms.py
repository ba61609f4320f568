"""Host ms an optimizer step waited for its batch from the Prefetcher."""


def read(run):
    if not run.waits:
        return None
    return 1e3 * sum(run.waits) / len(run.waits)
