"""Conv stack: ms of the conv stack's forward and backward in one traced
replay of the captured grad step: the median conv_forward phase plus the
median conv_backward phase (stamped on the card's timer inside the
traced step graph, Profiler.summary); None where the program stamps no
conv phases."""


def read(ctx):
    ph = (ctx.get("phases") or {}).get("phases_ms", {})
    if "conv_forward" not in ph or "conv_backward" not in ph:
        return None
    return ph["conv_forward"] + ph["conv_backward"]
