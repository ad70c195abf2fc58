"""Recurrent window: ms of a recurrent net's truncated-BPTT window in one
traced replay of the captured grad step: the median bptt_forward phase
(the window's forward to the output at t, with the no-grad step to
t+1) plus the median bptt_backward phase (the pullback through the
window), stamped on the card's timer inside the traced step graph
(Profiler.summary); None where the program stamps no such phases."""


def read(ctx):
    ph = (ctx.get("phases") or {}).get("phases_ms", {})
    if "bptt_forward" not in ph or "bptt_backward" not in ph:
        return None
    return ph["bptt_forward"] + ph["bptt_backward"]
