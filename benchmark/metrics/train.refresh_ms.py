"""Replay: ms per 1000-step refresh (returns recomputed by K1 over every
slot, statistics updated), from the Trainer's REFRESH spans."""


def read(ctx):
    total, n = ctx["spans"].get("REFRESH", (0.0, 0))
    return total * 1e3 / n if n else None
