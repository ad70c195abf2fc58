"""CMA convergence record on the func_maximization app: the twin of
tools/cma_func_max_record.py.

    python -m smarties_tpu_torch.tools.cma_func_max_record [--device cuda]
        [--generations 60] [--out DIR]

CMA over 8 forked external apps (apps/func_maximization: the
Communicator's optimization-interface sugar turns the objective into
1-step episodes) with the JAX tool's configuration: population 8, 4
episodes per member a generation, a [8] net, learnrate 0.05, randSeed 1,
no exploration noise. Writes summary.json and curve.json ([generation,
avgR] rows) into docs/curves_torch/cma_func_max/. Solved = the mean
policy's proposed x within 1e-3 of the optimum in the objective.

`--device` defaults to the card and raises where there is none. The
app's script is loaded with runpy, so its `__main__` block (which uses the
JAX package) does not run; the forked apps run its numpy code only.
"""
import argparse
import json
import os
import runpy
import time

from smarties_tpu_torch.tools.learning_curves import OUT as CURVES
from smarties_tpu_torch.tools.learning_curves import ROOT, card

APP = os.path.join(ROOT, "apps", "func_maximization", "exec.py")
OUT = os.path.join(CURVES, "cma_func_max")


def record(device="cuda", generations=60, out=OUT):
    """Run CMA for `generations` over the forked apps, then evaluate the
    mean policy's deterministic action on the objective. Returns the
    summary."""
    import numpy as np
    import torch
    from smarties_tpu_torch.algos.cma import CMAES
    from smarties_tpu_torch.models.net import apply_net
    from smarties_tpu_torch.runtime.env_pool import EnvPool
    from smarties_tpu_torch.runtime.trainer import checked_device
    from smarties_tpu_torch.utils.config import HyperParameters

    dev = checked_device(device)
    app = runpy.run_path(APP)
    cfg = HyperParameters(learner="CMA", ESpopSize=8, batchSize=4,
                          explNoise=0.0, nnLayerSizes=[8], learnrate=0.05,
                          randSeed=1)
    # the apps fork before this process touches the card
    pool = EnvPool(app["app_main"], n_envs=8)
    try:
        mdp = pool.probe_spec()
        cma = CMAES(None, mdp, cfg, n_envs=8, max_len=4, device=dev)
        t0 = time.time()
        cma.run_external(pool, n_generations=generations, log_every=10)
        wall_s = time.time() - t0
    finally:
        pool.kill()
    curve = [[g + 1, h["avgR"]] for g, h in enumerate(cma.history)]

    # the converged mean policy's action for the dummy state: with no
    # exploration noise `_sample` returns the bounded mean (eff_mean)
    st = cma.state
    obs = torch.zeros((1, mdp.dim_state_observed), device=dev)
    out_net, _ = apply_net(cma.unravel(st.mean), cma.spec,
                           (obs - st.state_mean) * st.state_scale)
    a = cma._sample(out_net)
    x = np.asarray(mdp.learner_to_env_action(a).cpu(), np.float64)[0]
    final_obj = app["objective"](x)

    os.makedirs(out, exist_ok=True)
    summary = {
        "name": "cma_func_max", "recipe": "CMA",
        "app": "apps/func_maximization", "dim": app["DIM"],
        "generations": len(curve),
        "final_avg_return": curve[-1][1] if curve else None,
        "final_objective": round(final_obj, 6),
        "proposed_x": [round(float(v), 4) for v in x],
        "optimum_x": app["OPT"],
        "solved": bool(final_obj < 1e-3),
        "wall_s": round(wall_s, 1), **card(dev),
    }
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(out, "curve.json"), "w") as f:
        json.dump(curve, f)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.cma_func_max_record",
        description="CMA record on apps/func_maximization.")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--generations", type=int, default=60)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    record(args.device, args.generations, args.out)


if __name__ == "__main__":
    main()
