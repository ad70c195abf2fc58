"""Conversion between the JAX package's numpy state and the port's tensors.

The JAX package checkpoints numpy trees (Trainer.save pickles
jax.device_get(...) of params, Adam state and replay;
smarties_tpu/runtime/trainer.py:750-771). These functions take and
return numpy dicts and never import jax, so a JAX-trained state moves
into the port (and parameters back) without the JAX runtime.

- params: the same nested dict on both sides ({"layers": [layer, ...],
  "out": {"W", "b"}, "param"}; a layer is {"W", "b"}, with "R" for an
  RNN, the twelve per-gate leaves of an LSTM or the six of a GRU, see
  models/net.py), every weight as [in, out] in both, so conversion is a
  leaf-wise copy. A conv stack adds "conv": [{"W": [K, K, Cin, O], "b":
  [O]}, ...], HWIO on both sides, copied the same way (the Adam moments
  too). The learners nest these: {"net", "tgt"} (DQN, NAF,
  DPG; the target leaves come out without grad) and {"actor", "critic",
  "enc"} (DPG, MixedPG, PPO).
- optimiser state: Adam's m1/m2 trees plus beta_t_1, beta_t_2 and step;
  MixedPG's adds dpg_factor and err_q_factor around it, PPO's penal_coef
  and dkl_target.
- acting carries: tuples of arrays, an LSTM layer's entry the pair
  (h, c); `carry_from_numpy` / `carry_to_numpy` keep that nesting.
- replay: built from the JAX ReplayState's FIELD VIEWS (not its packed
  record): `REPLAY_FIELDS` lists the keys, each an array in the JAX
  orientation ([E, L+1, ...] per step, [E] per slot, scalars). A uint8
  `states` array (pixel replays) stays uint8.
  `replay_to_numpy` gives the port's replay under the same keys.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.models.optim import AdamState
from smarties_tpu_torch.replay import buffer as rb

# per-step views [E, L+1(, d)] -> time-major storage
_STEP_FIELDS = {"states": "states_tm", "rewards": "rewards_tm",
                "actions": "actions_tm", "mus": "mus_tm",
                "qret": "qret_tm", "rho": "rho_tm", "kl": "kl_tm",
                "delta": "delta_tm", "value": "value_tm",
                "advantage": "advantage_tm"}
# per-slot views [E]
_SLOT_FIELDS = {"length": ("slot_len", torch.int32),
                "ep_id": ("slot_id", torch.int32),
                "terminal": ("slot_term", torch.bool),
                "far_count": ("far_count", torch.float32),
                "qret_stale": ("qret_stale", torch.bool),
                "v_trunc": ("v_trunc", torch.float32)}
# scalars and per-dim statistics, same names on both sides
_SCALAR_FIELDS = {"beta": torch.float32, "alpha": torch.float32,
                  "cmax_ret": torch.float32, "cinv_ret": torch.float32,
                  "state_mean": torch.float32, "state_std": torch.float32,
                  "state_scale": torch.float32, "rew_mean": torch.float32,
                  "rew_std": torch.float32, "rew_scale": torch.float32,
                  "n_seen_eps": torch.int32, "n_seen_steps": torch.int32,
                  "n_pruned_eps": torch.int32,
                  "max_abs_error": torch.float32}
REPLAY_FIELDS = (tuple(_STEP_FIELDS) + tuple(_SLOT_FIELDS)
                 + tuple(_SCALAR_FIELDS))


def _copy(x, dtype, device):
    """A tensor that owns a copy of numpy `x` (the port updates in place,
    so it must never share the caller's buffer)."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_jax(params_np, device=None):
    """numpy param tree -> the port's leaf tensors: trained leaves require
    grad, the target weights under a top-level "tgt" key do not."""
    if isinstance(params_np, dict) and "tgt" in params_np:
        return {k: (tree_map(lambda x: _copy(x, torch.float32, device), v)
                    if k == "tgt" else params_from_jax(v, device))
                for k, v in params_np.items()}
    return tree_map(lambda x: _copy(x, torch.float32, device
                                    ).requires_grad_(True), params_np)


def _to_numpy(x):
    """A numpy copy (never a view of a tensor the port updates in place)."""
    return np.array(x.detach().cpu())


def params_to_jax(params):
    """The port's param tree -> numpy (the JAX package's structure)."""
    return tree_map(_to_numpy, params)


def adam_state_from_jax(opt_np, device=None) -> AdamState:
    """numpy Adam state (an AdamState namedtuple or a dict with m1, m2,
    beta_t_1, beta_t_2, step) -> the port's AdamState."""
    moment = lambda t: tree_map(lambda x: _copy(x, torch.float32, device),
                                t)
    scalar = lambda k, dt: _copy(_get(opt_np, k), dt, device)
    return AdamState(m1=moment(_get(opt_np, "m1")),
                     m2=moment(_get(opt_np, "m2")),
                     beta_t_1=scalar("beta_t_1", torch.float32),
                     beta_t_2=scalar("beta_t_2", torch.float32),
                     step=scalar("step", torch.int32))


def _get(obj, k):
    return obj[k] if isinstance(obj, dict) else getattr(obj, k)


def opt_state_from_jax(opt_np, device=None):
    """numpy optimiser state -> the port's: an AdamState, MixedPG's
    MixedPGOptState(adam, dpg_factor, err_q_factor) or PPO's
    PPOOptState(adam, penal_coef, dkl_target) (namedtuples or dicts with
    those keys)."""
    has = (lambda k: k in opt_np) if isinstance(opt_np, dict) \
        else (lambda k: hasattr(opt_np, k))
    if not has("adam"):
        return adam_state_from_jax(opt_np, device)
    if has("penal_coef"):
        from smarties_tpu_torch.algos.ppo import PPOOptState as cls
        extra = ("penal_coef", "dkl_target")
    else:
        from smarties_tpu_torch.algos.mixedpg import MixedPGOptState as cls
        extra = ("dpg_factor", "err_q_factor")
    return cls(adam=adam_state_from_jax(_get(opt_np, "adam"), device),
               **{k: _copy(_get(opt_np, k), torch.float32, device)
                  for k in extra})


def opt_state_to_numpy(opt) -> dict:
    """The port's optimiser state as nested dicts of numpy copies under
    the JAX package's field names (the input of opt_state_from_jax)."""
    if hasattr(opt, "_fields"):
        return {k: opt_state_to_numpy(getattr(opt, k)) for k in opt._fields}
    if isinstance(opt, (dict, list, tuple)):
        return tree_map(_to_numpy, opt)
    return _to_numpy(opt)


def carry_from_numpy(carry_np, device=None) -> tuple:
    """An acting carry (nested tuples of numpy arrays: one entry per
    recurrent layer, (h, c) pairs for LSTM layers, the OU state first for
    NAF and DPG) -> the same nesting of tensors."""
    return tree_map(lambda x: _copy(x, torch.float32, device),
                    tuple(carry_np))


def carry_to_numpy(carry) -> tuple:
    """The port's acting carry as nested tuples of numpy copies."""
    return tree_map(_to_numpy, tuple(carry))


def replay_from_jax(rs_np, device=None) -> rb.ReplayState:
    """The port's replay from a dict of the JAX replay's field views
    (keys REPLAY_FIELDS, numpy arrays). The `value` view already holds
    v_trunc at t == length, so the stored field takes it as is."""
    kw = {}
    for name, dst in _STEP_FIELDS.items():
        x = np.swapaxes(np.asarray(rs_np[name]), 0, 1)
        dt = (torch.uint8 if name == "states" and x.dtype == np.uint8
              else torch.float32)
        kw[dst] = _copy(x, dt, device).contiguous()
    for name, (dst, dt) in _SLOT_FIELDS.items():
        kw[dst] = _copy(rs_np[name], dt, device)
    for name, dt in _SCALAR_FIELDS.items():
        kw[name] = _copy(rs_np[name], dt, device)
    E = kw["slot_len"].shape[0]
    kw["samp_csum"] = torch.zeros((E,), dtype=torch.int32, device=device)
    kw["samp_start"] = torch.zeros((E,), dtype=torch.int32, device=device)
    return rb.rebuild_sample_cache(rb.ReplayState(**kw))


def replay_to_numpy(rs: rb.ReplayState) -> dict:
    """The port's replay as numpy copies of its field views, under
    REPLAY_FIELDS."""
    return {k: _to_numpy(getattr(rs, k)) for k in REPLAY_FIELDS}
