"""Weights / Adam-moment viewer over the port's checkpoint.pt files: the
twin of bin/smarties_tpu_plot_weights.py, which reads the JAX package's
checkpoint.pkl.

    python -m smarties_tpu_torch.tools.plot_weights runs/run00/checkpoint.pt
    python -m smarties_tpu_torch.tools.plot_weights checkpoint.pt --plot

Loads a checkpoint written by Trainer.save or the Engine's
save_checkpoint (torch.load with weights_only=True, onto the CPU),
flattens each learner's parameter tree and prints per-leaf statistics
(|w| max and rms, then the Adam moments' extremes), or with --plot draws
the weights against the Adam moments (matplotlib, imported there only).
"""
import argparse

import numpy as np


def _leaves(tree, prefix=""):
    """(name, np.ndarray) pairs of a tree of CPU tensors, stable order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), np.asarray(tree)


def _flat(tree):
    return np.concatenate([v.ravel() for _, v in _leaves(tree)]) \
        if tree is not None else None


def show_learner(tag, params, opt_state, do_plot):
    print(f"== learner {tag} ==")
    print(f"{'leaf':<28s} {'shape':>14s} {'|w|max':>10s} {'rms':>10s}")
    for name, v in _leaves(params):
        print(f"{name:<28s} {str(v.shape):>14s} "
              f"{np.abs(v).max():>10.4f} "
              f"{np.sqrt(np.mean(v * v)):>10.5f}")
    w = _flat(params)
    if np.isnan(w).any():
        raise ValueError("NaN weights in checkpoint")
    m1 = m2 = None
    # Adam's state: a dict with the moment trees m1 and m2 (checkpoints
    # store named tuples as dicts)
    if isinstance(opt_state, dict) and "m1" in opt_state:
        m1, m2 = _flat(opt_state["m1"]), _flat(opt_state["m2"])
        # flat-Adam states store moments as one vector already
        if m1.shape != w.shape:
            m1 = m1[:w.size]
            m2 = m2[:w.size]
        print(f"n={w.size}  |w|max={np.abs(w).max():.4f}  "
              f"|m1|max={np.abs(m1).max():.3g}  "
              f"m2max={m2.max():.3g}")
    if do_plot:
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3 if m1 is not None else 1,
                                 figsize=(12, 4))
        axes = np.atleast_1d(axes)
        axes[0].plot(w, "o", ms=1)
        axes[0].set_title(f"weights ({tag})")
        if m1 is not None:
            axes[1].plot(m1, "o", ms=1)
            axes[1].set_title("1st moment")
            axes[2].semilogy(np.maximum(m2, 1e-20), "o", ms=1)
            axes[2].set_title("2nd moment")
        plt.tight_layout()
        plt.show()


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.plot_weights")
    ap.add_argument("checkpoint", help="checkpoint.pt path")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)

    snap = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    if "learners" in snap:          # an Engine's checkpoint
        for i, s in enumerate(snap["learners"]):
            show_learner(str(i), s["params"], s.get("opt_state"),
                         args.plot)
    else:
        show_learner("0", snap["params"], snap.get("opt_state"),
                     args.plot)


if __name__ == "__main__":
    main()
