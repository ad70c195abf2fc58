"""External-env serving throughput (states served per second): the twin
of tools/serving_bench.py.

    python -m smarties_tpu_torch.tools.serving_bench [n_envs] [seconds]
        [--device cuda]

Measures the Engine-side serving stack alone: the port's EnvPool worker
processes, the event-driven poll_states, one batched act and the partial
replies (None for the lanes that are not ready), with trivially fast env
apps, so the number is the serving ceiling (the reference's hot loop is
Master::waitForStateActionCallers, Core/Master.cpp:118-144). The act is
a VRacer [128, 128] forward on the device, with one read of the actions
to the host per round; no learner step and no commit. The pool forks its
apps before this process first touches the card (an app forked beside a
CUDA learner is safe while it runs numpy only).

Prints the card's name and power limit on a card, then
`served N states in S s with E envs -> R states/s`.
`--device` defaults to the card and raises where there is none.
"""
import argparse
import time

import numpy as np


def fast_app(comm):
    comm.setStateActionDims(6, 1)
    comm.setActionScales([1.0], [-1.0], True)
    t = 0
    state = np.zeros(6)
    comm.sendInitState(state)
    while True:
        comm.recvAction()
        t += 1
        if t % 200 == 0:
            comm.sendTermState(state, 1.0)
            comm.sendInitState(state)
        else:
            comm.sendState(state, 0.1)


def serve(n_envs: int = 16, seconds: float = 5.0, device="cuda") -> dict:
    """Serve the fast apps for `seconds` -> {"served", "seconds",
    "n_envs", "states_per_s", "rounds"}."""
    import torch
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.runtime.env_pool import EnvPool
    from smarties_tpu_torch.runtime.trainer import checked_device
    from smarties_tpu_torch.utils.config import HyperParameters

    dev = checked_device(device)
    pool = EnvPool(fast_app, n_envs, seed=0)      # forks before CUDA
    try:
        mdp = pool.probe_spec()
        algo = VRacer(mdp, HyperParameters(nnLayerSizes=[128, 128],
                                           minTotObsNum=64,
                                           maxTotObsNum=1024))
        params, _ = algo.init(torch.Generator().manual_seed(0), dev)
        act = algo.make_act_fn(True)
        gen = torch.Generator(device=dev).manual_seed(1)
        obs = torch.zeros((pool.n_lanes, mdp.dim_net_input), device=dev)
        act(params, obs, gen, ())                 # the first call's set-up
        served = rounds = 0
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            events, ready = pool.poll_states(timeout=0.05)
            served += len(events)
            if not ready:
                continue
            a, _, _, _, _ = act(params, obs, gen, ())
            acts = np.asarray(mdp.learner_to_env_action(a).cpu().numpy(),
                              np.float64)
            ready = set(ready)
            pool.send_actions([acts[lane] if lane in ready else None
                               for lane in range(pool.n_lanes)])
            rounds += 1
        dt = time.monotonic() - t0
    finally:
        pool.kill()
    return {"served": served, "seconds": dt, "n_envs": n_envs,
            "states_per_s": served / dt, "rounds": rounds}


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.serving_bench")
    p.add_argument("n_envs", type=int, nargs="?", default=16)
    p.add_argument("seconds", type=float, nargs="?", default=5.0)
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    args = p.parse_args(argv)
    res = serve(args.n_envs, args.seconds, args.device)
    if args.device != "cpu":
        from smarties_tpu_torch.runtime.bench_retrace import card_line
        print(card_line(), flush=True)
    print(f"served {res['served']} states in {res['seconds']:.1f}s with "
          f"{res['n_envs']} envs -> {res['states_per_s']:,.0f} states/s",
          flush=True)
    return res


if __name__ == "__main__":
    main()
