"""Kernel K1: the least time for the bytes that K1's calls in the traced
cycle must move (yardstick.k1_sweep_bytes at each call's slots, over the
card's HBM rate) over K1's device time there (its kernels by name in
the profiler's trace), in %."""


def read(ctx):
    tr, peaks = ctx.get("trace"), ctx.get("peaks")
    if not tr or not peaks or not ctx.get("k1_bytes"):
        return None
    us = sum(b - a for name, a, b in tr["kernels"] if "retrace" in name)
    if us <= 0:
        return None
    return 100.0 * (ctx["k1_bytes"] / peaks["hbm"]) / (us * 1e-6)
