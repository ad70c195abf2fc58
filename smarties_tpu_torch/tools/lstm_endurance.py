"""LSTM POMDP endurance run: the twin of tools/lstm_endurance.py.

    LSTM_BUDGET=6000000 python -m smarties_tpu_torch.tools.lstm_endurance \\
        [--device cuda] [--out DIR]

The RACER_RNN recipe (LSTM [32, 32], BPTT 16) on the no-velocity
cart-pole at 1024 envs, minTotObsNum 65536 and maxTotObsNum 262144 (the
learning_curves combo racer_rnn_cartpole) for LSTM_BUDGET grad steps
(default 6M) with no wall cap, unattended; then the deterministic eval.
Writes the rewards file and summary.json into
docs/curves_torch/racer_rnn_endurance/.

The JAX tool's worker_crash_retries key counts the TPU-worker crash
retries of its train_fused, which the port leaves out (a TPU-only path):
the summary has no such key.
"""
import argparse
import os

from smarties_tpu_torch.tools import learning_curves as lc

BUDGET = int(os.environ.get("LSTM_BUDGET", 6_000_000))
OUT = os.path.join(lc.OUT, "racer_rnn_endurance")


def run(device="cuda", out=OUT, **cuts):
    """Train and evaluate; `cuts` go to learning_curves.train_combo
    (n_envs, n_slots, max_len, settings). Returns the summary."""
    tr = lc.train_combo("racer_rnn_cartpole", device, run_dir=out,
                        budget=BUDGET, wall=float("inf"), **cuts)
    return lc.finish_combo("racer_rnn_cartpole", tr, {
        "name": "racer_rnn_endurance", "completed_unattended": True})


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.lstm_endurance",
        description="RACER_RNN on cartpole.pomdp for LSTM_BUDGET steps.")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    run(args.device, args.out)


if __name__ == "__main__":
    main()
