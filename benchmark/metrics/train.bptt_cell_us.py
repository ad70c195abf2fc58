"""Recurrent window: µs of one serial cell application, the window's
time (train.step_bptt_ms: the median bptt_forward plus bptt_backward
phase of a traced replay) over the cell applications a replay runs
(the program's bptt_cells counter, counted from the shapes: (W + 1)
positions x layers forward, W x layers backward); None without the
phases or the counter."""


def read(ctx):
    phases = ctx.get("phases") or {}
    ph, cells = phases.get("phases_ms", {}), phases.get("bptt_cells")
    if "bptt_forward" not in ph or "bptt_backward" not in ph or not cells:
        return None
    return (ph["bptt_forward"] + ph["bptt_backward"]) * 1e3 / cells
