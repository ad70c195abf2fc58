"""Conversion between the JAX package's numpy state and the port's tensors.

The JAX package checkpoints numpy trees (Trainer.save pickles
jax.device_get(...) of params, Adam state and replay;
smarties_tpu/runtime/trainer.py:750-771). These functions take and
return numpy dicts and never import jax, so a JAX-trained state moves
into the port (and parameters back) without the JAX runtime.

- params: the same nested dict on both sides ({"layers": [{"W", "b"}],
  "out": {"W", "b"}, "param"}), W as [in, out] in both, so conversion is
  a leaf-wise copy.
- Adam state: m1/m2 trees plus beta_t_1, beta_t_2 and step.
- replay: built from the JAX ReplayState's FIELD VIEWS (not its packed
  record): `REPLAY_FIELDS` lists the keys, each an array in the JAX
  orientation ([E, L+1, ...] per step, [E] per slot, scalars).
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
    """numpy param tree -> the port's leaf tensors (requiring grad)."""
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
    get = (opt_np.get if isinstance(opt_np, dict)
           else lambda k: getattr(opt_np, k))
    moment = lambda t: tree_map(lambda x: _copy(x, torch.float32, device),
                                t)
    scalar = lambda k, dt: _copy(get(k), dt, device)
    return AdamState(m1=moment(get("m1")), m2=moment(get("m2")),
                     beta_t_1=scalar("beta_t_1", torch.float32),
                     beta_t_2=scalar("beta_t_2", torch.float32),
                     step=scalar("step", torch.int32))


def replay_from_jax(rs_np, device=None) -> rb.ReplayState:
    """The port's replay from a dict of the JAX replay's field views
    (keys REPLAY_FIELDS, numpy arrays). The `value` view already holds
    v_trunc at t == length, so the stored field takes it as is."""
    kw = {}
    for name, dst in _STEP_FIELDS.items():
        kw[dst] = _copy(np.swapaxes(np.asarray(rs_np[name]), 0, 1),
                        torch.float32, device).contiguous()
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
