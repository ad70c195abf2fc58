"""Trainer: the share of the window outside the Trainer's phase spans
(ROLL, TRAIN, REFRESH and HOST, each a pair of CUDA events on the
stream that runs the cycle), in %: the time the card waits for the host
between phases (the presample, the Python loop, the log flush).

A profiler trace cannot give this on the captured path: tracing every
kernel of the graph replays slows the host below the card's pace (a
traced cycle of vracer_cartpole.fused took 1.69 s against 0.83 s on an
NVIDIA H100 80GB HBM3, and read 48% idle)."""


def read(ctx):
    w = ctx["window_s"]
    if not w:
        return None
    busy = sum(total for total, _ in ctx["spans"].values())
    return 100.0 * (1.0 - busy / w)
