"""Faults planted in a recurrent program under test (the configuration
racer_rnn_cartpole), for its readings (python -m benchmark.readings_bptt
--fault NAME) and for the tests that see `correct` come out false:
benchmark/faults.py's that act on the recurrent step as they act on the
feed-forward one, the no-velocity cart-pole's own env faults (its class
holds its own reference to the env step, which faults.py's replace
leaves untouched), and two of the recurrent path:

- short_window: the grad step's BPTT window one position short
  (nnBPTTseq - 1);
- carry_unreset: the sweep leaves an env lane's acting carry as it is
  where the lane's episode ends, so the next episode starts from it;
- pomdp_reward_altered: the env step returns every reward + 0.25;
- pomdp_state_altered: the env step's next cart position moves by 1e-3.
"""
from __future__ import annotations

from benchmark import faults

NAMES = ("state_unchanged", "half_batch", "returns_altered", "stats_altered",
         "short_window", "carry_unreset", "pomdp_reward_altered",
         "pomdp_state_altered")


def plant(name: str, setattr_=setattr):
    """Plant fault `name`; setattr_ (a pytest monkeypatch's setattr in
    the tests) does the replacing."""
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.replay import collector
    if name in ("state_unchanged", "half_batch", "returns_altered",
                "stats_altered"):
        faults.plant(name, setattr_)
    elif name == "short_window":
        step = VRacer.train_step

        def train_step(self, *a, **k):
            W = self.cfg.nnBPTTseq
            self.cfg.nnBPTTseq = W - 1
            try:
                return step(self, *a, **k)
            finally:
                self.cfg.nnBPTTseq = W
        setattr_(VRacer, "train_step", train_step)
    elif name == "carry_unreset":
        # the sweep's only tree_map is the reset of the acting carry
        setattr_(collector, "tree_map", lambda fn, tree, *rest: tree)
    elif name in ("pomdp_reward_altered", "pomdp_state_altered"):
        env_step = cartpole.step

        def altered(state, action):
            s, r, d, term = env_step(state, action)
            if name == "pomdp_reward_altered":
                return s, r + 0.25, d, term
            u = s.u.clone()
            u[:, 0] += 1e-3
            return s._replace(u=u), r, d, term
        setattr_(cartpole.pomdp, "step", staticmethod(altered))
    else:
        raise ValueError(f"no fault {name!r}; the faults: {NAMES}")
