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
  and dkl_target. ACER's params nest {"net": {"actor", "value", "advtg"
  [, "enc"]}, "tgt_actor"} and its split Adam is one state over "net".
  RACER-ES's params are {"pop": [P, n]}, flat vectors in ravel_pytree's
  order (algos/cma.py), with ESOptState; CMA-ES's CMAState crosses the
  same way (opt_state_from_jax).
- acting carries: tuples of arrays, an LSTM layer's entry the pair
  (h, c); `carry_from_numpy` / `carry_to_numpy` keep that nesting.
- replay: built from the JAX ReplayState's FIELD VIEWS (not its packed
  record): `REPLAY_FIELDS` lists the keys, each an array in the JAX
  orientation ([E, L+1, ...] per step, [E] per slot, scalars). A uint8
  `states` array (pixel replays) stays uint8.
  `replay_to_numpy` gives the port's replay under the same keys.
  `replay_shards_from_jax` splits a JAX replay into the K shards of a
  K-rank learner mesh, `gather_replay` joins shards into one replay.
- an Engine learner's snapshot (`engine_snapshot_from_jax`): what the
  JAX package's `_LearnerBundle.snapshot()` holds, as numpy, in the
  form of the port's `_LearnerBundle.snapshot()`, for checkpoint.pt.
- a MultiTrainer's state (`multitrainer_from_jax`): per learner the
  params, optimiser state and replay views of the JAX MultiTrainer (the
  fields its save() pickles), in the form of the port's
  `MultiTrainer.state()`, which `MultiTrainer.load` takes.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.models.optim import AdamState
from smarties_tpu_torch.parallel.mesh import shard_fields
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


# top-level param keys whose leaves take no gradient: the target weights
# ("tgt"; ACER's "tgt_actor") and the flat population matrix of RACER-ES
_NO_GRAD_KEYS = ("tgt", "tgt_actor", "pop")


def params_from_jax(params_np, device=None):
    """numpy param tree -> the port's leaf tensors: trained leaves require
    grad, those under a top-level "tgt", "tgt_actor" or "pop" key do not
    (ACER's nested {"net": {...}, "tgt_actor"}; RACER-ES's {"pop": [P,
    n]}, which no autograd step touches)."""
    if isinstance(params_np, dict) and set(_NO_GRAD_KEYS) & set(params_np):
        return {k: (tree_map(lambda x: _copy(x, torch.float32, device), v)
                    if k in _NO_GRAD_KEYS else params_from_jax(v, device))
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
    """numpy optimiser state -> the port's: an AdamState (ACER's split
    Adam is one AdamState over its nested net), MixedPG's
    MixedPGOptState(adam, dpg_factor, err_q_factor), PPO's
    PPOOptState(adam, penal_coef, dkl_target), RACER-ES's
    ESOptState(diag_cov, path_cov, noise, step) or CMA-ES's CMAState
    (namedtuples or dicts with those keys; the flat vectors are in the
    same order on both sides)."""
    has = (lambda k: k in opt_np) if isinstance(opt_np, dict) \
        else (lambda k: hasattr(opt_np, k))
    if has("diag_cov"):
        from smarties_tpu_torch.algos.cma import CMAState
        from smarties_tpu_torch.algos.racer_es import ESOptState
        cls = CMAState if has("mean") else ESOptState
        return cls(**{k: _copy(_get(opt_np, k), torch.int32 if k in (
            "step", "gen") else torch.float32, device) for k in cls._fields})
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


def split_replay(rs: rb.ReplayState, K: int) -> list:
    """K replay shards of one replay, for K learner ranks: rank r holds
    slots [r E/K, (r+1) E/K) and a copy of the replicated fields, with
    its own sampling cache (parallel/mesh.py::shard_fields)."""
    dims = shard_fields(rs)
    if rs.n_slots % K:
        raise ValueError(f"{K} ranks must divide the {rs.n_slots} slots")
    return [rb.rebuild_sample_cache(rb.ReplayState(**{
        f: (getattr(rs, f).chunk(K, dims[f])[r].clone() if f in dims
            else getattr(rs, f).clone())
        for f in rs.__dataclass_fields__})) for r in range(K)]


def gather_replay(shards) -> rb.ReplayState:
    """One replay of K ranks' shards (the inverse of split_replay): the
    per-slot fields concatenated in rank order, the replicated fields
    those of rank 0, as the JAX package's host reads a sharded replay."""
    dims = shard_fields(shards[0])
    return rb.rebuild_sample_cache(rb.ReplayState(**{
        f: (torch.cat([getattr(x, f) for x in shards], dims[f])
            if f in dims else getattr(shards[0], f).clone())
        for f in shards[0].__dataclass_fields__}))


def replay_shards_from_jax(rs_np, K: int, device=None) -> list:
    """K port replays from a dict of the JAX replay's field views: the
    shards a K-rank mesh holds where the JAX package's "learners" axis
    shards the slots (replay_pspec)."""
    return split_replay(replay_from_jax(rs_np, device), K)


def replay_to_numpy(rs: rb.ReplayState) -> dict:
    """The port's replay as numpy copies of its field views, under
    REPLAY_FIELDS."""
    return {k: _to_numpy(getattr(rs, k)) for k in REPLAY_FIELDS}


def engine_snapshot_from_jax(snap_np) -> dict:
    """A JAX Engine learner's snapshot as numpy -> the port's snapshot
    (runtime/engine.py:_LearnerBundle.snapshot: CPU tensors, named tuples
    as plain dicts), which `_LearnerBundle.restore` and checkpoint.pt take.

    snap_np: {"params": numpy tree, "opt_state": numpy optimiser state,
    "replay": the JAX replay's field views under REPLAY_FIELDS, and the
    counters "n_grad_steps", "n_env_steps", "initialized",
    "start_env_steps"} (the JAX snapshot with its replay given as views,
    since the JAX ReplayState computes them with jax)."""
    from smarties_tpu_torch.runtime.trainer import _plain
    rs = replay_from_jax(snap_np["replay"], "cpu")
    out = {"params": tree_map(lambda x: x.detach(),
                              params_from_jax(snap_np["params"], "cpu")),
           "opt_state": _plain(opt_state_from_jax(snap_np["opt_state"],
                                                  "cpu")),
           "replay": {f: getattr(rs, f) for f in rs.__dataclass_fields__}}
    for k, cast in (("n_grad_steps", int), ("n_env_steps", int),
                    ("initialized", bool), ("start_env_steps", int)):
        if k in snap_np:
            out[k] = cast(snap_np[k])
    return out


def multitrainer_from_jax(snap_np) -> dict:
    """A JAX MultiTrainer's state as numpy -> the port's
    `MultiTrainer.state()` form (CPU tensors, named tuples as dicts).

    snap_np: {"learners": [{"params", "opt_state", "replay" (the JAX
    replay's field views under REPLAY_FIELDS), "n_grad_steps"}, ...],
    "n_env_steps", "initialized"[, "start_env_steps"]}."""
    from smarties_tpu_torch.runtime.trainer import _plain
    learners = []
    for ls in snap_np["learners"]:
        rs = replay_from_jax(ls["replay"], "cpu")
        learners.append({
            "params": tree_map(lambda x: x.detach(),
                               params_from_jax(ls["params"], "cpu")),
            "opt_state": _plain(opt_state_from_jax(ls["opt_state"], "cpu")),
            "replay": {f: getattr(rs, f) for f in rs.__dataclass_fields__},
            "n_grad_steps": int(ls["n_grad_steps"])})
    out = {"learners": learners, "n_env_steps": int(snap_np["n_env_steps"]),
           "initialized": [bool(x) for x in snap_np["initialized"]]}
    if "start_env_steps" in snap_np:
        out["start_env_steps"] = int(snap_np["start_env_steps"])
    return out
