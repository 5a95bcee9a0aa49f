"""Pixel-samples differentiated (forward and reverse) in the window, per second, in millions."""


def value(run) -> float:
    return run.samples / run.window_s / 1e6
