"""Learning-curve records of the port: the twin of tools/learning_curves.py.

    python -m smarties_tpu_torch.tools.learning_curves run NAME ... \\
        [--device cuda] [--budget N] [--wall S] [--out DIR]
    python -m smarties_tpu_torch.tools.learning_curves compare NAME ...
    python -m smarties_tpu_torch.tools.learning_curves render

`run` trains each named recipe x env combo of COMBOS (all of them when
none is named) one after the other in this process: build, warmup, train
to the combo's grad-step budget or its wall cap, whichever comes first,
then flush the episode logs and evaluate 16 deterministic episodes. Each
run writes the reference-format agent_00_rank00_cumulative_rewards.dat
(rows [grad-step env-step agentID ep-length return],
MemoryBuffer.cpp:491-513) and summary.json into docs/curves_torch/<name>/.
`--device` defaults to the card and raises where there is none; a combo
that raises stops the run with a non-zero exit.

`compare` holds a port trace against the reference trace tracked under
docs/curves/runs/<name>/: the trailing mean return of the last
COMPARE_WINDOW episodes of each, the reference's taken among its episodes
that ended by the port's last env-step count. For a run cut by its wall
cap this is the comparison that means something.

`render` draws each trace (raw returns and trailing mean) with the
reference's trailing mean beside it into docs/curves_torch/<name>.png and
docs/curves_torch/summary.png. It needs matplotlib, which only it imports.

Differences from the JAX tool:
- The wall cap is passed to train_fused / train (max_wall_s), which check
  it every cycle: an eager cycle here takes seconds, so the JAX tool's
  slices of up to 131,072 grad steps would overrun every cap.
- The episode logs stay on the device for LOG_FLUSH_CYCLES cycles (the
  JAX tool never reads them before the end): each pending entry is a
  cycle's [sweeps, lanes] done / length / return tensors, so the bound
  keeps that memory small (under 10 MB at 1024 lanes), and one read every
  256 cycles costs the host loop nothing measurable.
- summary.json adds the card's name and power limit, the budget and wall
  cap, what stopped the run, the cuts asked for, the deviations from the
  combo's settings (none: every combo runs its settings as they are) and
  K1's launches by site and by entry point.
"""
import argparse
import importlib
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "docs", "curves_torch")
REF = os.path.join(ROOT, "docs", "curves", "runs")
REWARDS = "agent_00_rank00_cumulative_rewards.dat"
# episodes in the trailing means of `compare`
COMPARE_WINDOW = 100
LOG_FLUSH_CYCLES = 256
# grad steps between two progress lines (16 fused cycles at 1024 envs)
PROGRESS_STEPS = 16384

# name -> dict(env, recipe, overrides, budget (grad steps), wall (s),
#              n_envs, [uint8] for pixel replays, [n_slots]).
# The entries are tools/learning_curves.py's, copied verbatim with their
# comments, which speak of the JAX package's runs on its TPU
# (tests/test_torch_curves.py holds the two tables equal).
COMBOS = {
    "vracer_pendulum": dict(
        env="pendulum", recipe="VRACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=2_000_000, wall=900, n_envs=1024),
    # DPG.json keeps lr 1e-5: pendulum needs a long horizon at that rate
    # (r3's 2M-step run plateaued at -574; solved needs ~3x the budget)
    "dpg_pendulum": dict(
        env="pendulum", recipe="DPG",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=6_000_000, wall=1800, n_envs=1024),
    # PPO.json horizon (maxTotObsNum) is 2048: min must come down with it.
    # Honest r4 note: the reference-faithful PPO (surrogate quirks of
    # PPO_train.cpp kept, see algos/ppo.py docstring) does NOT solve
    # pendulum at this budget (~-950 after 4M env steps; the r3 RESULTS
    # table's -479 was a stale row, its committed artifact said -982);
    # ppo_cartpole below is the implementation's solved record.
    "ppo_pendulum": dict(
        env="pendulum", recipe="PPO",
        over={"gamma": 0.99, "minTotObsNum": 2048},
        budget=120_000, wall=1800, n_envs=64),
    "ppo_cartpole": dict(
        env="cartpole", recipe="PPO",
        over={"minTotObsNum": 2048},
        budget=60_000, wall=1800, n_envs=64),
    # r5: faithful glider (ground-contact termination, goal |x-100|,
    # terminal bump reward — envs/glider.py). Episodes run ~120-500
    # steps; 4M grad steps = ~3900 env steps/lane = ~20+ episodes/lane
    "racer_glider": dict(
        env="glider", recipe="RACER_glider",
        over={"minTotObsNum": 65536},
        budget=4_000_000, wall=1800, n_envs=1024),
    # ---- r3: solved-threshold records for the weak algos (VERDICT #7) --
    "dqn_cartpole": dict(
        env="cartpole.discrete", recipe="DQN",
        over={"clipImpWeight": 4.0, "returnsEstimator": "retrace",
              "minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    # ACER's whole-episode window step costs ~100x a 1-step algo's
    # (~4+ ms/step measured r4): budget sized so the run fits ~20 min
    # of real device time; solves cart-pole well within it
    "acer_cartpole": dict(
        env="cartpole", recipe="ACER",
        over={"minTotObsNum": 65536, "maxTotObsNum": 131072},
        budget=250_000, wall=900, n_envs=1024),
    # NAF's quadratic advantage is a weak fit for bang-bang cart-pole
    # (reference-known); r3 at explNoise 0.4 / 3M steps evaluated 101.
    # r4 retune: milder OU noise so the greedy mean can stabilize, and
    # double the budget.
    "naf_cartpole": dict(
        env="cartpole", recipe="NAF",
        over={"explNoise": 0.2, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=6_000_000, wall=1800, n_envs=1024),
    # ---- r5: NAF Gaussian-advantage cross-check (VERDICT r4 #9): if
    # the bump advantage clears the quadratic variant's ~217 cap on
    # bang-bang cart-pole, the unimodal-advantage explanation holds ----
    "naf_gauss_cartpole": dict(
        env="cartpole", recipe="NAF",
        over={"nafAdvGaussian": True, "explNoise": 0.2,
              "minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=6_000_000, wall=1800, n_envs=1024),
    # ---- r5: standard-PPO mode records (VERDICT r4 #5): symmetric
    # advantage-sign clip + batch advantage normalization (ppoStandard;
    # the reference-faithful surrogate stays the default and its honest
    # non-learning records above stay committed) ----
    "ppo_std_cartpole": dict(
        env="cartpole", recipe="PPO",
        over={"minTotObsNum": 2048, "ppoStandard": True},
        budget=60_000, wall=1800, n_envs=64),
    "ppo_std_pendulum": dict(
        env="pendulum", recipe="PPO",
        over={"gamma": 0.99, "minTotObsNum": 2048,
              "ppoStandard": True},
        budget=240_000, wall=1800, n_envs=64),
    # ---- r5: second ACER record (VERDICT r4 #7) ----
    "acer_pendulum": dict(
        env="pendulum", recipe="ACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=250_000, wall=1200, n_envs=1024),
    "mixedpg_pendulum": dict(
        env="pendulum", recipe="VRACER",
        over={"learner": "MixedPG", "gamma": 0.99,
              "minTotObsNum": 65536, "maxTotObsNum": 131072},
        budget=2_000_000, wall=900, n_envs=1024),
    # ---- r3: classic-control coverage (VERDICT #8), 2 algos per env ----
    "vracer_acrobot": dict(
        env="acrobot", recipe="VRACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=1_000_000, wall=900, n_envs=1024),
    # acrobot is exploration-bound and defeats the reference's COMPILED
    # DQN default (Boltzmann softmax-over-Q: exploration collapses as
    # |Q| grows — training episodes do reach the goal, the near-greedy
    # policy never consolidates; r3+r4 runs at temperatures 1.0/2.0 all
    # evaluated -500). The reference's OTHER compile branch (the paper's
    # eps-greedy, DQN.cpp:71-81) solves it: constant eps = 0.3 with the
    # classic double-Q greedy bootstrap (dqnEpsGreedy).
    "dqn_acrobot": dict(
        env="acrobot", recipe="DQN",
        over={"dqnEpsGreedy": True, "explNoise": 0.3,
              "clipImpWeight": 0.0, "returnsEstimator": "none",
              "gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=2_000_000, wall=1200, n_envs=1024),
    "vracer_mountaincar": dict(
        env="mountaincar", recipe="VRACER",
        over={"gamma": 0.995, "explNoise": 0.8, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    "dpg_mountaincar": dict(
        env="mountaincar", recipe="DPG",
        over={"gamma": 0.995, "explNoise": 0.6, "minTotObsNum": 65536,
              "maxTotObsNum": 262144},
        budget=1_500_000, wall=900, n_envs=1024),
    # ---- r3: conv learning proof (VERDICT #5): pixel Catch with the
    # RACER_atari-style recipe (Mnih conv stack, uint8 replay, bf16) ----
    "racer_catch": dict(
        env="catch", recipe="RACER_atari",
        over={"minTotObsNum": 8192, "maxTotObsNum": 65536,
              "nnBf16": True},
        budget=120_000, wall=900, n_envs=256, uint8=True,
        n_slots=2048),
    # ---- r4: recurrent POMDP record (VERDICT r3 #5): LSTM V-RACER on
    # no-velocity cart-pole under the reference RNN recipe
    # (settings/RACER_RNN.json: LSTM [32,32], nnBPTTseq 16) ----
    "racer_rnn_cartpole": dict(
        env="cartpole.pomdp", recipe="RACER_RNN",
        over={"minTotObsNum": 65536, "maxTotObsNum": 262144},
        budget=800_000, wall=1200, n_envs=1024),
    # ---- r4: RACER with Gaussian advantage (the full-RACER
    # instantiation, VERDICT r3 #7) ----
    "racer_pendulum": dict(
        env="pendulum", recipe="RACER",
        over={"gamma": 0.99, "minTotObsNum": 65536,
              "maxTotObsNum": 131072},
        budget=2_000_000, wall=1200, n_envs=1024),
    # ---- r4: RACER-ES (derivative-free VRACER_CMA path, VERDICT r3 #7;
    # population forwards make each grad step ~popsize x costlier) ----
    "vracer_cma_cartpole": dict(
        env="cartpole", recipe="VRACER_CMA",
        over={"minTotObsNum": 16384, "maxTotObsNum": 65536},
        budget=250_000, wall=1800, n_envs=1024),
}


def _import_env(name):
    if "." in name:
        mod, attr = name.split(".", 1)
        return getattr(importlib.import_module(
            f"smarties_tpu_torch.envs.{mod}"), attr)
    return importlib.import_module(f"smarties_tpu_torch.envs.{name}")


def card(device) -> dict:
    """The device's name and power limit as nvidia-smi gives them
    ("NVIDIA H100 80GB HBM3", "700.00 W"); the CPU has neither."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = (s.strip() for s in smi.stdout.strip().split(","))
    return {"device": name, "power_limit": limit}


class SiteLaunches:
    """K1's launches and calls at the trainer's three return-sweep sites
    (the ingest sweep, initialize_stats, the refresh), by diffing the
    kernel wrapper's launch counters around each call; `by_entry()`: the
    launches of each entry point since construction (ACER's
    affine_suffix_scan runs inside its grad step, at no site)."""

    def __init__(self, trainer):
        from smarties_tpu_torch.ops import retrace_kernel
        self.rk = retrace_kernel
        self.start = dict(retrace_kernel.launches)
        self.launches, self.calls = {}, {}
        for attr, site in (("_fix_returns", "ingest"),
                           ("_init_stats", "initialize_stats"),
                           ("_refresh", "refresh")):
            setattr(trainer, attr, self._wrap(getattr(trainer, attr), site))

    def _wrap(self, fn, site):
        def counted(*a, **kw):
            n0 = sum(self.rk.launches.values())
            out = fn(*a, **kw)
            self.launches[site] = (self.launches.get(site, 0)
                                   + sum(self.rk.launches.values()) - n0)
            self.calls[site] = self.calls.get(site, 0) + 1
            return out
        return counted

    def by_entry(self) -> dict:
        return {k: n - self.start[k] for k, n in self.rk.launches.items()}


def train_combo(name, device="cuda", *, out=OUT, run_dir=None, budget=None,
                wall=None, n_envs=None, n_slots=None, max_len=None,
                settings=None):
    """Build and train one combo on `device` into run_dir (default
    out/<name>); returns the Trainer, with the run's record in
    `tr.record` for finish_combo.

    budget, wall: cut the combo's grad-step budget and wall cap (s).
    n_envs, n_slots, max_len, settings (a dict applied over the combo's
    settings): cut its size. Every cut is written into the summary;
    COMBOS is never changed."""
    import torch
    from smarties_tpu_torch.runtime.trainer import Trainer, checked_device
    from smarties_tpu_torch.utils import recipes

    dev = checked_device(device)
    c = COMBOS[name]
    env = _import_env(c["env"])
    d = dict(recipes.RECIPES[c["recipe"]])
    d.update(c["over"])
    cuts = {k: v for k, v in (("budget", budget),
                              ("wall", None if wall == float("inf")
                               else wall),
                              ("n_envs", n_envs), ("n_slots", n_slots),
                              ("max_len", max_len), ("settings", settings))
            if v is not None}
    d.update(settings or {})
    cfg = recipes.HyperParameters.from_dict(d)
    budget = c["budget"] if budget is None else budget
    wall = c["wall"] if wall is None else wall
    n_envs = n_envs or c["n_envs"]
    run_dir = run_dir or os.path.join(out, name)
    os.makedirs(run_dir, exist_ok=True)
    # truncate a previous run's rewards file (Trainer appends)
    rew = os.path.join(run_dir, REWARDS)
    if os.path.exists(rew):
        os.remove(rew)
    tr = Trainer(env, env.MDP, cfg, n_envs=n_envs,
                 n_slots=n_slots or c.get("n_slots"),
                 max_len=max_len or env.MAX_STEPS, device=dev,
                 run_dir=run_dir,
                 state_dtype=torch.uint8 if c.get("uint8") else None)
    tr.log_flush_threshold = LOG_FLUSH_CYCLES
    sites = SiteLaunches(tr)
    device_info = card(dev)
    print(f"  [{name}] built on {dev} ({time.strftime('%H:%M:%S')})",
          flush=True)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    t0 = clock()
    if tr.on_policy:        # the horizon cycle, with no warmup
        step = tr.train
    else:
        tr.warmup(chunk=16,
                  blind_sweeps=max(16, cfg.minTotObsNum // n_envs))
        step = tr.train_fused
    # slices for the progress lines; each call checks the wall cap every
    # cycle on the host clock (the host runs at most a cycle ahead)
    while (tr.n_grad_steps < budget
           and (left := wall - (time.time() - t0)) > 0):
        step(min(budget - tr.n_grad_steps, PROGRESS_STEPS),
             log_every=10 ** 9, max_wall_s=left)
        print(f"  [{name}] {tr.n_grad_steps}/{budget} "
              f"({time.time() - t0:.0f}s)", flush=True)
    wall_s = clock() - t0
    tr.record = {
        "budget": budget, "wall_cap_s": None if wall == float("inf")
        else wall, "wall_s": wall_s,
        "stopped_by": "budget" if tr.n_grad_steps >= budget else "wall",
        "cuts": cuts, "deviations": [],
        "k1_launches": sites.launches, "k1_calls": sites.calls,
        "k1_launches_by_entry": sites.by_entry(),
        "replay": [tr.n_slots, tr.max_len + 1], **device_info}
    print(f"  [{name}] trained {tr.n_grad_steps} of {budget} grad steps "
          f"in {wall_s:.1f}s ({tr.record['stopped_by']})", flush=True)
    return tr


def finish_combo(name, tr, extra=None):
    """Flush the deferred logs, evaluate 16 deterministic episodes and
    write summary.json into the run directory: the JAX tool's keys, then
    the port's, then `extra`."""
    import numpy as np
    c = COMBOS[name]
    rew = os.path.join(tr.run_dir, REWARDS)
    rec = tr.record
    tr._flush_logs()
    tr._rew_file.flush()
    ev = tr.evaluate(16, max_steps=tr.max_len)
    summary = {
        "name": name, "recipe": c["recipe"], "env": c["env"],
        "grad_steps": tr.n_grad_steps, "env_steps": tr.n_env_steps,
        "episodes": sum(1 for _ in open(rew)) if os.path.exists(rew)
        else 0,
        "wall_s": round(rec["wall_s"], 1),
        "eval_mean": round(float(np.mean(ev)), 2),
        "eval_std": round(float(np.std(ev)), 2),
        **{k: rec[k] for k in ("device", "power_limit", "budget",
                               "wall_cap_s", "stopped_by", "cuts",
                               "deviations", "k1_launches", "k1_calls",
                               "k1_launches_by_entry", "replay")},
        **(extra or {}),
    }
    with open(os.path.join(tr.run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


def _returns_by_env_step(path):
    """(env steps, returns) of a rewards file, in env-step order."""
    import numpy as np
    dat = np.loadtxt(path, ndmin=2)
    if dat.size == 0:
        return np.zeros(0), np.zeros(0)
    o = np.argsort(dat[:, 1], kind="stable")
    return dat[o, 1], dat[o, 4]


def compare(name, *, out=OUT, ref=REF, window=COMPARE_WINDOW, at=None):
    """The trailing mean return of the port's last `window` episodes and
    of the reference's last `window` episodes that ended by the port's
    last env-step count (by `at` env steps in both traces, if given)."""
    import numpy as np
    x, r = _returns_by_env_step(os.path.join(out, name, REWARDS))
    if at is not None:
        x, r = x[x <= at], r[x <= at]
    if not len(r):
        raise ValueError(f"{name}: the port's trace has no episode")
    env_steps = int(x[-1]) if at is None else at
    xr, rr = _returns_by_env_step(os.path.join(ref, name, REWARDS))
    rr = rr[xr <= env_steps][-window:]
    res = {"name": name, "env_steps": env_steps, "window": window,
           "port_mean": float(np.mean(r[-window:])),
           "port_episodes": int(min(window, len(r))),
           "reference_mean": float(np.mean(rr)) if len(rr) else None,
           "reference_episodes": int(len(rr))}
    print(f"{name}: at {env_steps} env steps, trailing mean of the last "
          f"{window} episodes: port {res['port_mean']:.2f} "
          f"({res['port_episodes']} episodes), reference "
          + (f"{res['reference_mean']:.2f}" if len(rr) else "-")
          + f" ({len(rr)} episodes)", flush=True)
    return res


def render(*, out=OUT, ref=REF):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    HUE, REF_HUE = "#3056d3", "#888888"

    def trailing(path):
        x, r = _returns_by_env_step(path)
        w = max(1, len(r) // 200)
        return x, r, x[w - 1:], np.convolve(r, np.ones(w) / w, "valid")

    runs = [n for n in COMBOS if os.path.exists(os.path.join(out, n, REWARDS))
            and os.path.getsize(os.path.join(out, n, REWARDS)) > 0]
    if not runs:
        print("no runs to render")
        return
    ncol = min(4, len(runs))
    nrow = (len(runs) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 3.4 * nrow),
                             squeeze=False)
    for k, name in enumerate(runs):
        x, r, xm, mean = trailing(os.path.join(out, name, REWARDS))
        s = json.load(open(os.path.join(out, name, "summary.json")))
        ref_path = os.path.join(ref, name, REWARDS)
        has_ref = (os.path.exists(ref_path)
                   and os.path.getsize(ref_path) > 0)
        one, ax2 = plt.subplots(figsize=(4.6, 3.4))
        for ax in (axes[k // ncol][k % ncol], ax2):
            ax.plot(x, r, ".", ms=2, color=HUE, alpha=0.12,
                    rasterized=True)
            ax.plot(xm, mean, color=HUE, lw=2, label="port")
            if has_ref:
                _, _, xr, mr = trailing(ref_path)
                keep = xr <= x[-1]
                ax.plot(xr[keep], mr[keep], color=REF_HUE, lw=1.5,
                        label="reference")
            ax.set_title(f"{name}  (eval {s['eval_mean']:+.0f}"
                         f"±{s['eval_std']:.0f})", fontsize=10)
            ax.set_xlabel("env steps")
            ax.grid(alpha=0.25, lw=0.5)
            ax.spines[["top", "right"]].set_visible(False)
        ax2.set_ylabel("episode return")
        ax2.legend(fontsize=8, frameon=False)
        one.tight_layout()
        one.savefig(os.path.join(out, f"{name}.png"), dpi=130)
        plt.close(one)
    for k in range(len(runs), nrow * ncol):
        axes[k // ncol][k % ncol].axis("off")
    axes[0][0].set_ylabel("episode return")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "summary.png"), dpi=130)
    print("rendered", [f"{n}.png" for n in runs], "+ summary.png")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.learning_curves",
        description="Learning-curve records of the port.")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="train combos and write their records")
    r.add_argument("names", nargs="*",
                   help="combos to run (all when none is named)")
    r.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    r.add_argument("--budget", type=int,
                   help="grad steps, in place of each combo's budget")
    r.add_argument("--wall", type=float,
                   help="wall cap in s, in place of each combo's")
    r.add_argument("--out", default=OUT,
                   help="directory of the run directories (default "
                        "docs/curves_torch)")
    c = sub.add_parser("compare", help="trailing means, port vs reference")
    c.add_argument("names", nargs="+")
    c.add_argument("--at", type=int, nargs="+",
                   help="env-step counts to compare at (default: the "
                        "port's last)")
    sub.add_parser("render", help="draw the port's traces")
    args = p.parse_args(argv)
    unknown = sorted(set(getattr(args, "names", ())) - set(COMBOS))
    if unknown:
        p.error(f"unknown combos {unknown}; COMBOS has {sorted(COMBOS)}")
    if args.cmd == "render":
        render()
    elif args.cmd == "compare":
        for name in args.names:
            for at in args.at or [None]:
                compare(name, at=at)
    else:
        for name in args.names or list(COMBOS):
            print(f"=== {name} ===", flush=True)
            tr = train_combo(name, args.device, out=args.out,
                             budget=args.budget, wall=args.wall)
            finish_combo(name, tr)
            del tr


if __name__ == "__main__":
    main()
