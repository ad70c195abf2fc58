"""Learner: the share of the card's FP32 peak (the configurations
compute in float32 with TF32 off) that the window's grad-step FLOPs,
counted from the shapes (yardstick.step_flops), make over the window's
time, in %."""


def read(ctx):
    peaks = ctx.get("peaks")
    if not peaks or not ctx["window_s"]:
        return None
    rate = ctx["grad_steps"] * ctx["flops_per_step"] / ctx["window_s"]
    return 100.0 * rate / peaks["fp32"]
