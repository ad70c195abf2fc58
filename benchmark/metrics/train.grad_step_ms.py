"""Learner / compiled programs: ms of device time per grad step in the
window, from the Trainer's TRAIN spans (pairs of CUDA events around each
chunk of captured grad steps), over the grad steps they ran."""


def read(ctx):
    total, n = ctx["spans"].get("TRAIN", (0.0, 0))
    if not n or not ctx["grad_steps"]:
        return None
    return total * 1e3 / ctx["grad_steps"]
