"""The rank side of tests/test_torch_multichip.py: K learner ranks of the
port, one spawned process each, joined by gloo through a file store.

`spawn(case, K, tmp)` runs CASES[case](mesh, inputs, meta) on every rank.
The inputs come from the test process as numpy files (tmp/in.npz, with
tmp/meta.json for the settings) and each rank's results go back the
same way (tmp/out<rank>.npz). Trees cross flattened: a key is the path
of a leaf, its components joined by "/", a list index written as its
digits. This module imports torch and the port only, never jax, so a
rank starts without the JAX runtime.

Every process group gets a timeout: a rank that waits on a collective
its peers never issue fails in that time, and mp.spawn raises.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smarties_tpu_torch.models import convert
from smarties_tpu_torch.parallel.mesh import make_mesh
from smarties_tpu_torch.parallel.multihost import init_multihost
from smarties_tpu_torch.replay import buffer as rb

TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# trees <-> flat dicts of numpy
# ---------------------------------------------------------------------------

def to_plain(x):
    """Named tuples and dicts -> dicts, tuples -> lists, arrays and
    tensors -> numpy, recursively."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


EMPTY = {dict: "{}", list: "[]"}


def flatten(tree, prefix: str) -> dict:
    out = {}

    def walk(x, path):
        if isinstance(x, (dict, list)) and not x:
            # an empty container (a net with no hidden layers) keeps a key
            out["/".join(path + [EMPTY[type(x)]])] = np.zeros(0)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + [str(k)])
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, path + [str(i)])
        else:
            out["/".join(path)] = np.asarray(x)

    walk(to_plain(tree), [prefix])
    return out


def unflatten(flat: dict, prefix: str):
    """The tree under `prefix` of a flat dict (lists where every key of a
    level is digits)."""
    root = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(x):
        if not isinstance(x, dict):
            return x
        for cls, mark in EMPTY.items():
            if list(x) == [mark]:
                return cls()
        x = {k: fix(v) for k, v in x.items()}
        if x and all(k.isdigit() for k in x):
            return [x[str(i)] for i in range(len(x))]
        return x

    return fix(root)


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def spawn(case: str, K: int, tmp, inputs=None, meta=None) -> list:
    """Run CASES[case] on K ranks -> the K ranks' result dicts."""
    tmp = os.path.abspath(str(tmp))
    np.savez(os.path.join(tmp, "in.npz"), **(inputs or {}))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    store = "file://" + os.path.join(tmp, f"store_{case}")
    mp.spawn(_rank, args=(K, case, tmp, store), nprocs=K, join=True)
    out = []
    for r in range(K):
        with np.load(os.path.join(tmp, f"out{r}.npz")) as f:
            out.append(dict(f))
    return out


def _rank(rank, K, case, tmp, store):
    torch.set_num_threads(1)
    init_multihost(store, K, rank, backend="gloo", timeout_s=TIMEOUT_S)
    try:
        with np.load(os.path.join(tmp, "in.npz")) as f:
            inputs = dict(f)
        with open(os.path.join(tmp, "meta.json")) as f:
            meta = json.load(f)
        out = CASES[case](make_mesh("cpu"), inputs, meta, tmp)
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _shard(inputs, mesh, prefix="rs"):
    return convert.replay_shards_from_jax(unflatten(inputs, prefix),
                                          mesh.size)[mesh.rank]


def _replay_out(rs, prefix="rs"):
    return flatten(convert.replay_to_numpy(rs), prefix)


def _learner(meta):
    from smarties_tpu_torch.algos.registry import make_learner
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.utils.config import HyperParameters
    mdp = cartpole.discrete.MDP if meta["discrete"] else cartpole.MDP
    return make_learner(mdp, HyperParameters.from_dict(meta["cfg"]))


def _pinned_steps(mesh, inputs, meta, prefix="", algo=None, rs=None):
    """meta["n_steps"] train steps of one learner on this rank's shard
    with its pinned samples (and ACER's noise, RACER-ES's normals)."""
    algo = algo or _learner(meta)
    params = convert.params_from_jax(unflatten(inputs, prefix + "p"))
    opt = convert.opt_state_from_jax(unflatten(inputs, prefix + "o"))
    rs = rs if rs is not None else _shard(inputs, mesh, prefix + "rs")
    r = mesh.rank
    metrics = []
    for i in range(meta["n_steps"]):
        kw = {}
        if prefix + f"noise_pol/{i}" in inputs:
            kw["noise"] = (torch.tensor(inputs[prefix + f"noise_pol/{i}"][r]),
                           torch.tensor(inputs[prefix + f"noise_ext/{i}"][r]))
        if prefix + f"z/{i}" in inputs:
            kw["z"] = torch.tensor(inputs[prefix + f"z/{i}"])
        params, opt, rs, m = algo.train_step(
            params, opt, rs, sample_override=(
                torch.tensor(inputs[prefix + f"ep/{i}"][r]),
                torch.tensor(inputs[prefix + f"t/{i}"][r])),
            mesh=mesh, **kw)
        metrics.append(m)
    out = flatten(convert.params_to_jax(params), "p")
    out.update(flatten(convert.opt_state_to_numpy(opt), "o"))
    out.update(_replay_out(rs))
    out.update(flatten({k: [m[k] for m in metrics] for k in metrics[0]},
                       "m"))
    return out


def case_pinned_steps(mesh, inputs, meta, tmp):
    return _pinned_steps(mesh, inputs, meta)


def case_learners(mesh, inputs, meta, tmp):
    """case_pinned_steps for each learner of meta["learners"]."""
    out = {}
    for name, m in meta["learners"].items():
        res = _pinned_steps(mesh, inputs, m, prefix=name + ":")
        out.update({name + ":" + k: v for k, v in res.items()})
    return out


def case_rebalance(mesh, inputs, meta, tmp):
    rs = _shard(inputs, mesh)
    out = {}
    for i in range(meta["rounds"]):
        rs = rb.rebalance_shards(rs, mesh, k_max=meta["k_max"],
                                 max_tot_obs=meta["max_tot_obs"])
        out.update(_replay_out(rs, f"round{i}"))
    return out


def case_stats(mesh, inputs, meta, tmp):
    """The replay statistics and the per-step bookkeeping under the mesh,
    each on a fresh copy of this rank's shard."""
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.utils.config import HyperParameters
    cfg = HyperParameters.from_dict(meta["cfg"])
    r = mesh.rank
    out = {}
    rs, frac = rb.update_beta_alpha(_shard(inputs, mesh), cfg.batchSize,
                                    cfg.maxTotObsNum, cfg.penalTol, mesh)
    out.update({"beta_alpha/beta": rs.beta, "beta_alpha/alpha": rs.alpha,
                "beta_alpha/frac_off": frac})
    for name, chunk in (("stats", rb.STATS_CHUNK_ELEMS),
                        ("stats_chunked", meta["chunk_elems"])):
        old, rb.STATS_CHUNK_ELEMS = rb.STATS_CHUNK_ELEMS, chunk
        try:
            for tag, kw in (("lr", dict(learn_rate=meta["lr"])),
                            ("init", dict(learn_rate=1.0, b_init=True))):
                rs = rb.update_state_rew_stats(_shard(inputs, mesh),
                                               mesh=mesh, **kw)
                for f in ("state_mean", "state_std", "state_scale",
                          "rew_mean", "rew_std", "rew_scale"):
                    out[f"{name}/{tag}/{f}"] = getattr(rs, f)
        finally:
            rb.STATS_CHUNK_ELEMS = old
    rs, frac = base.post_step_processing(
        _shard(inputs, mesh), cfg, torch.tensor(meta["opt_step"]),
        torch.tensor(inputs["delta_q"][r]), mesh)
    for f in ("beta", "alpha", "cmax_ret", "cinv_ret", "max_abs_error"):
        out["post_step/" + f] = getattr(rs, f)
    out["post_step/frac_off"] = frac
    m = base.default_metrics(*(torch.tensor(inputs[k][r]) for k in (
        "dkl", "rho", "is_far")), frac, rs.beta,
        *(torch.tensor(inputs[k][r]) for k in ("delta_q", "v_val")),
        mesh)
    out.update({"metrics/" + k: v for k, v in m.items()})
    return {k: np.asarray(v) for k, v in to_plain(out).items()}


def _trainer(mesh, meta, run_dir=None):
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters
    return Trainer(cartpole, cartpole.MDP,
                   HyperParameters.from_dict(meta["cfg"]),
                   n_envs=meta["n_envs"], n_slots=meta["n_slots"],
                   max_len=meta["max_len"], device="cpu", mesh=mesh,
                   run_dir=run_dir)


def _trainer_out(tr):
    stored, = tr._global_counts(tr.replay.n_stored_steps())
    out = flatten(convert.params_to_jax(tr.params), "p")
    out.update(flatten(convert.opt_state_to_numpy(tr.opt_state), "o"))
    out.update(_replay_out(tr.replay))
    out.update({"n_grad_steps": np.asarray(tr.n_grad_steps),
                "n_env_steps": np.asarray(tr.n_env_steps),
                "global_stored": np.asarray(stored)})
    return out


def case_trainer(mesh, inputs, meta, tmp):
    """The sharded Trainer: warmup, then meta["steps"] grad steps (and
    the log cadence on its run directory)."""
    tr = _trainer(mesh, meta, os.path.join(tmp, "run"))
    if meta.get("warmup_chunk"):
        tr.warmup(chunk=meta["warmup_chunk"])
    tr.train(meta["steps"], log_every=meta.get("log_every", 10 ** 9))
    tr.log_status()
    return _trainer_out(tr)


def case_save(mesh, inputs, meta, tmp):
    tr = _trainer(mesh, meta, os.path.join(tmp, "run"))
    tr.warmup(chunk=meta["warmup_chunk"])
    tr.train(meta["steps"], log_every=10 ** 9)
    tr.save(os.path.join(tmp, meta["save"]))
    return _trainer_out(tr)


def case_restore(mesh, inputs, meta, tmp):
    """Restore a checkpoint, report the state, then train on: the ranks'
    collectives must still pair up."""
    tr = _trainer(mesh, meta)
    tr.restore(os.path.join(tmp, meta["restore"]))
    out = {"restored/" + k: v for k, v in _trainer_out(tr).items()}
    tr.train(meta["steps"], log_every=10 ** 9)
    out.update(_trainer_out(tr))
    return out


CASES = {"pinned_steps": case_pinned_steps, "learners": case_learners,
         "rebalance": case_rebalance, "stats": case_stats,
         "trainer": case_trainer, "save": case_save,
         "restore": case_restore}
