"""The most device memory allocated at once in the window, in GiB."""


def value(run) -> float:
    return run.peak_bytes / 2**30
