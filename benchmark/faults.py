"""Faults planted in the program under test, for the readings that set
the limits (python -m benchmark.readings --fault NAME) and for the tests
that see `correct` come out false: each breaks the timed path where it
produces its answer.

- state_unchanged: the grad step computes, then puts params and
  optimiser state back as they were;
- half_batch: the grad step uses the first half of its rows, the mean
  taken over them;
- reward_altered: the env step returns every reward + 0.25;
- state_altered: the env step's next cart position moves by 1e-3;
- returns_altered: K1's sweep scales every Qret it writes by 1.001;
- stats_altered: the state and reward statistics come out 0.1% high;
- draw_altered: a prioritized draw answers with the step after the one
  its uniform falls on.
"""
from __future__ import annotations

import torch

NAMES = ("state_unchanged", "half_batch", "reward_altered", "state_altered",
         "returns_altered", "stats_altered", "draw_altered")


def _leaves(tree):
    from smarties_tpu_torch.models.net import tree_leaves
    if hasattr(tree, "_fields"):
        return [x for f in tree
                for x in (tree_leaves(f) if isinstance(f, dict) else [f])]
    return tree_leaves(tree)


def plant(name: str, setattr_=setattr):
    """Plant fault `name`; setattr_ (a pytest monkeypatch's setattr in
    the tests) does the replacing."""
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.replay import buffer as rb
    step = VRacer.train_step
    if name == "state_unchanged":
        def train_step(self, params, opt, rs, **kw):
            keep = [x.detach().clone()
                    for x in (*_leaves(params), *_leaves(opt))]
            out = step(self, params, opt, rs, **kw)
            with torch.no_grad():
                for x, k in zip((*_leaves(params), *_leaves(opt)), keep):
                    x.copy_(k)
            return (params, opt) + tuple(out[2:])
        setattr_(VRacer, "train_step", train_step)
    elif name == "half_batch":
        def train_step(self, params, opt, rs, gen=None, sample_override=None,
                       mesh=None):
            if sample_override is None:
                sample_override = rb.sample(gen, rs, self.cfg.batchSize,
                                            self.cfg.dataSamplingAlgo)
            ep, t = sample_override
            n = ep.shape[0] // 2
            B = self.cfg.batchSize
            self.cfg.batchSize = n
            try:
                return step(self, params, opt, rs, gen=gen,
                            sample_override=(ep[:n], t[:n]), mesh=mesh)
            finally:
                self.cfg.batchSize = B
        setattr_(VRacer, "train_step", train_step)
    elif name in ("reward_altered", "state_altered"):
        env_step = cartpole.step

        def altered(state, action):
            s, r, d, term = env_step(state, action)
            if name == "reward_altered":
                return s, r + 0.25, d, term
            u = s.u.clone()
            u[:, 0] += 1e-3
            return s._replace(u=u), r, d, term
        setattr_(cartpole, "step", altered)
    elif name == "returns_altered":
        sweep = rk.retrace_sweep_

        def altered(qret_tm, *a, **k):
            out = sweep(qret_tm, *a, **k)
            qret_tm.mul_(1.001)
            return out
        setattr_(rk, "retrace_sweep_", altered)
    elif name == "stats_altered":
        stats = rb.update_state_rew_stats

        def altered(rs, *a, **k):
            rs = stats(rs, *a, **k)
            for x in (rs.state_mean, rs.state_std, rs.rew_mean, rs.rew_std):
                x.mul_(1.001)
            return rs
        setattr_(rb, "update_state_rew_stats", altered)
    elif name == "draw_altered":
        draw = rb.draw_from_probs

        def altered(p, u):
            return torch.clamp(draw(p, u) + 1, max=p.shape[0] - 1)
        setattr_(rb, "draw_from_probs", altered)
    else:
        raise ValueError(f"no fault {name!r}; the faults: {NAMES}")
