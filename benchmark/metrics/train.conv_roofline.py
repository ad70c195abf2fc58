"""Conv stack: the share of the card's FP32 peak (the configuration
computes in float32 with TF32 off) that the conv stack's FLOPs of one
grad step (benchmark/conv_flops.py, from the shapes) make over its
stamped phases (train.step_conv_ms), in %; None without them."""


def read(ctx):
    ph = (ctx.get("phases") or {}).get("phases_ms", {})
    peaks, flops = ctx.get("peaks"), ctx.get("conv_flops_per_step")
    if "conv_forward" not in ph or "conv_backward" not in ph \
            or not peaks or not flops:
        return None
    s = (ph["conv_forward"] + ph["conv_backward"]) / 1e3
    return 100.0 * flops / s / peaks["fp32"] if s > 0 else None
