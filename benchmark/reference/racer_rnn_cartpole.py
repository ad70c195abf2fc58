"""Plain reference of the configuration racer_rnn_cartpole: cselab/smarties'
RACER_RNN recipe (settings/RACER_RNN.json: V-RACER, an LSTM [32, 32],
nnBPTTseq 16, batch 128, C = 4; the rest settings/default.json) on the
partially observed cart-pole that README.rst:352 names for it: the
velocities hidden, [x, cos(angle), sin(angle)] observed. V-RACER's
objective and Adam are benchmark/reference/racer.py's, the LSTM and its
window benchmark/reference/lstm.py's, the dynamics benchmark/reference/
cartpole.py's.

The checks this module gives the driver:
- the grad steps: each sampled step's window of stored states
  [t-W+1, t+1], standardised, with each position's active flag as the
  last input column (net_input, forward);
- the env: stored episodes hide the velocities, so they are held on
  their rewards and ends, which follow from the observed x and angle
  (env_gaps); the dynamics are held on the program's full lane states
  [x, v, angle, omega] before and after one sweep, one step of each lane
  that did not end in it (lane_gaps). That leaves out the last step of
  an episode and every step that no checked sweep made;
- mu: the behaviour policy stored with each warmup step, against this
  LSTM acting over the stored episode from a zero carry (behaviour_gap).

Departures from the published description: the env is the port's
vectorised cart-pole (apps/cart_pole_py's dynamics, RK4 with 4
substeps), not a forked app; an episode's carry starts at zero and is
zeroed where the episode ends, as smarties' per-agent contexts are.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cartpole, lstm, racer

KIND = "continuous"
ENV_GAP = "env_state"
N_ACT = 1
# [x, cos(angle), sin(angle)] of the full state [x, v, angle, omega,
# cos, sin]
OBSERVED = [0, 4, 5]


def arch(config: dict) -> dict:
    s = config["settings"]
    return {"n_in": len(OBSERVED), "hidden": s["nnLayerSizes"],
            "n_out": 1 + N_ACT, "n_param": N_ACT,
            "act": s.get("nnFunc", "SoftSign"),
            "out_prefac": s.get("outWeightsPrefac", 0.1)}


def param_init(config: dict) -> float:
    return racer.softplus_inv(config["settings"]["explNoise"])


draw_weights = lstm.draw_weights


def net_input(frames, mean, scale):
    """frames [B, W+1, 3 + 1]: the window's raw stored states and each
    position's active flag -> standardised states, zero where inactive,
    with the flag kept as the last column."""
    active = frames[..., -1:]
    x = (frames[..., :-1].to(mean.dtype) - mean) * scale
    return torch.cat([x * active.to(x.dtype), active.to(x.dtype)], -1)


def forward(w: dict, arch: dict, x):
    """The net's output at the sampled step t of windows x [B, W+1, 3 +
    1] (net_input's)."""
    out_t, _ = lstm.window(w, arch, x[..., :-1], x[..., -1] > 0)
    return out_t


def batch_extras(mb: dict) -> dict:
    return {"bounded": torch.ones(N_ACT, dtype=torch.bool,
                                  device=mb["qret"].device)}


def _failed(obs):
    """The failure of observed states [..., 3]: |x| > 2.4 or |angle| >
    pi / 15, the angle recovered as atan2(sin, cos)."""
    obs = np.asarray(obs, np.float64)
    angle = np.arctan2(obs[..., 2], obs[..., 1])
    return (np.abs(obs[..., 0]) > 2.4) | (np.abs(angle) > np.pi / 15)


def env_gaps(cols: dict):
    """(0.0: no state gap can be read from observations without the
    velocities, wrong rewards or ends) of stored episodes: each reward
    1 - failed of the state it leads to; an episode ends at its first
    failure or at 500 steps, and only there; terminal where it failed.
    states [E, L1, 3], rewards [E, L1], float64."""
    wrong = 0
    states, rewards = cols["states"], cols["rewards"]
    for e in range(states.shape[0]):
        T = int(cols["length"][e])
        fail = _failed(states[e, 1:T + 1])
        wrong += int(np.sum((1.0 - fail) != rewards[e, 1:T + 1]))
        over = fail | (np.arange(1, T + 1) >= cartpole.MAX_STEPS)
        wrong += int(np.sum(over[:-1])) + int(not over[-1])
        wrong += int(bool(cols["terminal"][e]) != bool(fail[-1]))
    return 0.0, wrong


def lane_gaps(lanes: dict) -> float:
    """The largest gap of one env step of the lanes that did not end in
    a sweep: u0, u1 [V, 4] the program's full states [x, v, angle,
    omega] before and after it, action [V, 1] the learner's stored
    action (force 10 tanh(a)), served [V, 3] the observation stored for
    u0; the next state against the dynamics' step from u0, the served
    observation against u0's."""
    u0, u1 = lanes["u0"], lanes["u1"]
    u_ref = cartpole.advance(u0, 10.0 * np.tanh(lanes["action"][:, 0]))
    obs0 = cartpole.full_state(u0)[:, OBSERVED]
    return max(float(np.max(np.abs(u_ref - u1), initial=0.0)),
               float(np.max(np.abs(obs0 - lanes["served"]), initial=0.0)))


def behaviour(w: dict, arch: dict, states, mean, scale):
    """The behaviour policy [mean, stdev] [E, L1, 2] of episodes states
    [E, L1, 3] (raw), each acted from a zero carry with the weights w
    and the statistics (mean, scale) it was acted under; the mean
    clamped where the tanh saturates (racer.MEAN_MAX)."""
    xs = (states - mean) * scale
    P = xs.shape[1]
    active = torch.ones(xs.shape[:2], dtype=torch.bool, device=xs.device)
    out = lstm.run(w, arch, xs, active, range(P))
    y = torch.stack([out[p] for p in range(P)], 1)
    m = torch.clamp(y[..., 1:1 + N_ACT], -racer.MEAN_MAX, racer.MEAN_MAX)
    return torch.cat([m, racer.softplus(y[..., 1 + N_ACT:])], -1)


def behaviour_gap(w: dict, arch: dict, cols: dict, mean, scale) -> float:
    """The largest gap of a stored behaviour policy (cols["mus"] [E, L1,
    2] at t < length) from `behaviour`'s, over the largest |mean| and
    the largest stdev of the reference's, the larger of the two."""
    P = int(np.max(cols["length"]))           # acted at t < length
    states = torch.as_tensor(cols["states"][:, :P], dtype=mean.dtype,
                             device=mean.device)
    ref = behaviour(w, arch, states, mean, scale).cpu().numpy()
    mus = cols["mus"][:, :P]
    t = np.arange(mus.shape[1])[None, :]
    acted = (t < cols["length"][:, None])[..., None]
    gap = np.abs(np.where(acted, mus - ref, 0.0))
    scale_ = np.max(np.abs(np.where(acted, ref, 0.0)), axis=(0, 1))
    return float(np.max(gap.max(axis=(0, 1)) / np.maximum(scale_, 1e-30)))
