"""Rollout: ms per env sweep (the captured sweep of every env with its
commit and K1's at-ingest Retrace), from the Trainer's ROLL spans."""


def read(ctx):
    total, n = ctx["spans"].get("ROLL", (0.0, 0))
    return total * 1e3 / n if n else None
