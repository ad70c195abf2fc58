"""CMA-ES learner: gradient-free policy search, diagonal covariance.

Port of smarties_tpu/algos/cma.py (reference: Learners/CMALearner.cpp,
Network/CMA_Optimizer.{h,cpp}): a population of ESpopSize weight vectors
(member 0 == the mean, odd members fresh Gaussian samples, even members
the mirror of the one before, CMA_Optimizer.cpp:158-178); each env lane
runs episodes under one member's weights (lane v under member v % P, the
static form of CMALearner's round-robin weightID); a generation ends
after batchSize * ESpopSize episodes (CMALearner.cpp:154-165); member
losses are negative average returns (prepareCMALoss, CMALearner.cpp:72-
90); the rank-weighted mean / path / diagonal-sigma update follows
CMA_Optimizer::apply_update (:66-140): c1cov = 1e-5, c_sig = 1e-3, sigma
clamped to [0.01, 10].

The flat weight vector is the one jax.flatten_util.ravel_pytree makes of
the JAX package's param dict — dict keys sorted ("layers" < "out" <
"param"; in a layer "R" < "W" < "b"), list entries in order, each leaf
row-major — so a JAX CMAState carries over as it is (`ravel`,
`Unravel`). The JAX rollout gathers a full weight copy per lane; here the
lanes are laid out [P, V/P] and every layer is one batched product
against the [P, in, out] weights that `Unravel` views out of the
population matrix without a copy.

`run_external` serves user applications through an env pool, as the
JAX package's does: members assigned round-robin at episode start, a
generation every batchSize * ESpopSize episodes.

The rollout loop keeps the JAX package's accounting: episode returns and
step counts start from zero in every rollout chunk (its scan carry), and
the episode count is read back once per chunk.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (NetSpec, apply_net, init_params,
                                           tree_leaves, tree_map)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.utils.config import HyperParameters, anneal_rate

F32 = torch.float32
C1COV, C_SIG = 1e-5, 1e-3


def pop_weights(pop_size: int) -> np.ndarray:
    """log-rank recombination weights (initializePopWeights,
    CMA_Optimizer.h:61-72): normalized by the sum of positive parts."""
    w = np.log(0.5 * (pop_size + 1)) - np.log(np.arange(1, pop_size + 1))
    return (w / np.maximum(w, 0).sum()).astype(np.float32)


def pop_constants(pop_size: int):
    """(weights, mu_eff, sum of weights) of a population, the f32
    reductions of the JAX package's."""
    w = pop_weights(pop_size)
    w_pos = np.maximum(w, 0.0)
    mu_eff = float(np.float32(w_pos.sum()) ** 2
                   / np.float32((w_pos * w_pos).sum()))
    return w, mu_eff, float(np.float32(w.sum()))


def ravel(params) -> torch.Tensor:
    """A param tree -> its flat vector in ravel_pytree's order."""
    return torch.cat([x.detach().reshape(-1) for x in tree_leaves(params)])


class Unravel:
    """Flat vectors -> param trees shaped like `template`. A [..., n]
    input gives leaves with the leading axes in front, as views. With
    `members`, one-dimensional leaves (biases, the param head) get a
    singleton axis after the leading ones, so that apply_net computes
    [P, K, in] @ [P, in, out] + [P, 1, out] member by member."""

    def __init__(self, template):
        # the leaves' shapes, kept as storage-free tensors
        self.template = tree_map(lambda x: torch.empty(x.shape,
                                                       device="meta"),
                                 template)
        self.sizes = [x.numel() for x in tree_leaves(self.template)]
        self.n = sum(self.sizes)

    def __call__(self, flat: torch.Tensor, members: bool = False):
        parts = iter(torch.split(flat, self.sizes, dim=-1))

        def leaf(t):
            x = next(parts).unflatten(-1, t.shape)
            if members and t.dim() == 1:
                x = x.unsqueeze(-2)
            return x

        return tree_map(leaf, self.template)


def cma_update(pop, noise, losses, path_cov, diag_cov, w_pop, mu_eff: float,
               sum_w: float):
    """apply_update (CMA_Optimizer.cpp:66-140) -> (mean, path, sigma).
    The ranking is a stable sort of the losses, as jnp.argsort's: members
    whose episodes all reach max_len tie."""
    order = torch.argsort(losses, stable=True)    # ascending: best first
    x_sorted, y_sorted = pop[order], noise[order]
    w = w_pop[:, None]
    w_pos = torch.clamp(w, min=0.0)
    new_mean = torch.sum(w_pos * x_sorted, dim=0)
    avg_noise = torch.sum(w_pos * y_sorted, dim=0)
    mom_noise = torch.sum(w * y_sorted * y_sorted, dim=0)
    alpha = 1 - C1COV - sum_w * mu_eff * C1COV
    upd_sig = float(np.sqrt(C_SIG * (2 - C_SIG) * mu_eff))
    path = (1 - C_SIG) * path_cov + upd_sig * avg_noise
    s2 = alpha * diag_cov ** 2 + C1COV * path ** 2 + mu_eff * C1COV * mom_noise
    sig = torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)), 0.01, 10.0)
    return new_mean, path, sig


def mirrored_sample(mean, diag_cov, eta, P: int, gen, z=None):
    """Mirrored population sampling (CMA_Optimizer.cpp:158-178) ->
    (pop [P, n], noise [P, n]): member 0 = mean, odd members fresh, even
    members the mirror of the one before. z: the [P, n] standard normals
    (drawn from `gen` when None)."""
    if z is None:
        z = torch.randn((P, mean.shape[0]), generator=gen, dtype=F32,
                        device=mean.device)
    y = z * diag_cov[None, :]
    idx = torch.arange(P, device=mean.device)
    mirror = ((idx % 2 == 0) & (idx > 0))[:, None]
    y = torch.where(mirror, -torch.roll(y, 1, dims=0), y)
    y[0] = 0.0
    return mean[None, :] + eta * y, y


class CMAState(NamedTuple):
    mean: torch.Tensor        # flat weight vector (member 0)
    diag_cov: torch.Tensor    # per-weight sigma S
    path_cov: torch.Tensor    # evolution path P
    pop: torch.Tensor         # [P, n] sampled weight vectors
    noise: torch.Tensor       # [P, n] noise vectors Y
    gen: torch.Tensor         # 0-d i32 generation counter
    # running state standardization (generation-cadence updateRewardsStats)
    state_mean: torch.Tensor
    state_scale: torch.Tensor


class CMAES:
    """Standalone CMA trainer: it drives its own rollouts (CMA needs no
    replay and no gradients, only per-member returns).

    device: where every tensor lives; required. Randomness: a CPU
    generator for the initial weights, device generators for the env
    resets (and the evaluation starts), the acting noise and the
    population draws, all from cfg.randSeed."""

    def __init__(self, env_module, mdp: MDPSpec, cfg: HyperParameters,
                 n_envs: int = 48, max_len: int = 512, *, device):
        if device is None:
            raise ValueError("CMAES needs an explicit device")
        self.P = cfg.ESpopSize
        if n_envs % self.P:
            raise ValueError(f"CMA: nEnvironments {n_envs} must be divisible "
                             f"by ESpopSize {self.P} (each lane runs one "
                             f"member's weights)")
        self.env = env_module
        self.mdp = mdp
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_envs = n_envs
        self.max_len = max_len
        nA = mdp.dim_action
        self.discrete = mdp.is_discrete
        if self.discrete:
            n_out, bias = mdp.max_action_label, ()
        else:
            n_out = 2 * nA
            bias = tuple([0.0] * nA
                         + [float(cp.initial_sigma_raw(cfg.explNoise))] * nA)
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            n_out=n_out, kind="FFNN", act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac, out_bias_init=bias)
        w, self.mu_eff, self.sum_w = pop_constants(self.P)
        self.w_pop = torch.as_tensor(w, device=self.device)
        self.eps_per_gen = cfg.batchSize * self.P
        self.n_env_steps = 0
        self.n_generations = 0
        self._ep_returns = []
        # per generation: avgR, best (-min loss), wall s, env steps
        self.history = []
        # the flat layout: a throwaway draw of the weights' shapes
        self.unravel = Unravel(init_params(torch.Generator(), self.spec))
        from smarties_tpu_torch.runtime.trainer import _seeds
        s_init, s_env, s_act, s_pop = _seeds(cfg.randSeed, 4)
        self.gen_init = torch.Generator().manual_seed(s_init)
        self.gen_env, self.gen_act, self.gen_pop = (
            torch.Generator(device=self.device).manual_seed(s)
            for s in (s_env, s_act, s_pop))

    # ------------------------------------------------------------------
    def init(self, z=None) -> CMAState:
        """The initial weights (member 0), unit sigmas and the first
        population. z: its [P, n] normals (drawn when None)."""
        flat = ravel(init_params(self.gen_init, self.spec, self.device))
        n, dimS = flat.shape[0], self.mdp.dim_state_observed
        kw = dict(dtype=F32, device=self.device)
        st = CMAState(
            mean=flat, diag_cov=torch.ones((n,), **kw),
            path_cov=torch.zeros((n,), **kw),
            pop=flat[None].repeat(self.P, 1),
            noise=torch.zeros((self.P, n), **kw),
            gen=torch.zeros((), dtype=torch.int32, device=self.device),
            state_mean=torch.zeros((dimS,), **kw),
            state_scale=torch.ones((dimS,), **kw))
        return self._sample_pop(st, z)

    def _sample_pop(self, st: CMAState, z=None) -> CMAState:
        eta = anneal_rate(self.cfg.learnrate, st.gen.to(F32),
                          self.cfg.epsAnneal)
        pop, y = mirrored_sample(st.mean, st.diag_cov, eta, self.P,
                                 self.gen_pop, z)
        return st._replace(pop=pop, noise=y)

    def _cma_update(self, st: CMAState, losses, z=None) -> CMAState:
        mean, path, sig = cma_update(st.pop, st.noise, losses, st.path_cov,
                                     st.diag_cov, self.w_pop, self.mu_eff,
                                     self.sum_w)
        st = st._replace(mean=mean, path_cov=path, diag_cov=sig,
                         gen=st.gen + 1)
        return self._sample_pop(st, z)

    # ------------------------------------------------------------------
    def _actions(self, pop_tree, obs_std, noise=None):
        """Every lane's action under its member: obs_std [V, in] laid out
        [P, V/P, in] (lane k P + p under member p), one batched forward.
        noise: as in `_sample`."""
        V, P = obs_std.shape[0], self.P
        x = obs_std.reshape(V // P, P, -1).transpose(0, 1)
        out, _ = apply_net(pop_tree, self.spec, x)         # [P, V/P, out]
        return self._sample(out.transpose(0, 1).reshape(V, -1), noise)

    def _sample(self, out, noise=None):
        """Actions from the lanes' net outputs [V, out]. noise: the lanes'
        clipped normals [V, nA] (continuous) or uniforms [V] (discrete),
        drawn from gen_act when None."""
        train = self.cfg.explNoise > 0
        if self.discrete:
            _, _, probs = dpol.probs_of(out)
            opt = dpol.select(self.gen_act, probs, train, u=noise)
            return opt[..., None].to(F32)
        nA = self.mdp.dim_action
        mean = out[..., :nA]
        bounded = self.mdp.consts(mean)[1]
        if not train:
            return cp.eff_mean(mean, bounded)
        if noise is None:
            noise = cp.clipped_normal(self.gen_act, tuple(mean.shape), mean)
        return cp.sample_with_noise(noise, mean, cp.sigma_of(out[..., nA:]),
                                    bounded)

    @torch.no_grad()
    def _generation_rollout(self, st: CMAState, env_state, n_steps: int,
                            noise=None):
        """n_steps env sweeps -> (env_state, rsum [P], rcnt [P], (ssum,
        ssq, scnt)): the returns and counts of the episodes that ended,
        per member, and the observation moments. noise: [n_steps, ...]
        acting draws (see _actions)."""
        V, P = self.n_envs, self.P
        pop_tree = self.unravel(st.pop, members=True)
        dimS = self.mdp.dim_state_observed
        kw = dict(dtype=F32, device=self.device)
        cum_r, steps = torch.zeros(V, **kw), torch.zeros(
            V, dtype=torch.int32, device=self.device)
        rsum, rcnt = torch.zeros(P, **kw), torch.zeros(
            P, dtype=torch.int32, device=self.device)
        ssum, ssq = torch.zeros(dimS, **kw), torch.zeros(dimS, **kw)
        es = env_state
        for i in range(n_steps):
            obs = self.mdp.observed(self.env.observe(es))
            obs_std = (obs - st.state_mean) * st.state_scale
            a = self._actions(pop_tree, obs_std,
                              None if noise is None else noise[i])
            es, r, done, _ = self.env.step(
                es, self.mdp.learner_to_env_action(a))
            cum_r = cum_r + r
            steps = steps + 1
            done = done | (steps >= self.max_len)
            rsum += torch.where(done, cum_r, torch.zeros_like(cum_r)
                                ).reshape(V // P, P).sum(0)
            rcnt += done.to(torch.int32).reshape(V // P, P).sum(0,
                                                              dtype=torch.int32)
            ssum += torch.sum(obs, dim=0)
            ssq += torch.sum(obs * obs, dim=0)
            cum_r = torch.where(done, torch.zeros_like(cum_r), cum_r)
            steps = torch.where(done, torch.zeros_like(steps), steps)
            es = self.env.reset_where(es, done, self.gen_env)
        return es, rsum, rcnt, (ssum, ssq, n_steps * V)

    # ------------------------------------------------------------------
    def train(self, n_generations: int, log_every: int = 5,
              chunk: int = 128) -> CMAState:
        """Generations of (rollout chunks until batchSize * P episodes
        ended; one read-back of the count per chunk) -> CMA update ->
        the state statistics of the generation's observations. Returns
        the CMAState."""
        if not hasattr(self, "state"):
            self.state = self.init()
            self.env_state = self.env.init(self.gen_env, self.n_envs,
                                           self.device)
        st = self.state
        dimS = self.mdp.dim_state_observed
        kw = dict(dtype=F32, device=self.device)
        for g in range(n_generations):
            t0 = time.perf_counter()
            rsum, rcnt = torch.zeros(self.P, **kw), torch.zeros(
                self.P, dtype=torch.int32, device=self.device)
            ssum, ssq, scnt = torch.zeros(dimS, **kw), torch.zeros(
                dimS, **kw), 0
            while int(torch.sum(rcnt)) < self.eps_per_gen:
                self.env_state, rs_, rc_, (s1, s2, sc) = \
                    self._generation_rollout(st, self.env_state, chunk)
                rsum, rcnt = rsum + rs_, rcnt + rc_
                ssum, ssq, scnt = ssum + s1, ssq + s2, scnt + sc
                self.n_env_steps += chunk * self.n_envs
            losses = -rsum / torch.clamp(rcnt, min=1).to(F32)
            st = self._cma_update(st, losses)
            m = ssum / max(scnt, 1)
            var = torch.clamp(ssq / max(scnt, 1) - m * m, min=1e-8)
            st = st._replace(state_mean=m, state_scale=1.0 / torch.sqrt(var))
            self.n_generations += 1
            avg_ret = float(torch.sum(rsum) / torch.clamp(torch.sum(rcnt),
                                                          min=1))
            best = -float(torch.min(losses))
            self._ep_returns.append(avg_ret)
            self.history.append({"avgR": avg_ret, "best": best,
                                 "wall_s": time.perf_counter() - t0,
                                 "env_steps": self.n_env_steps})
            if (g + 1) % log_every == 0:
                print(f"gen {self.n_generations:4d} | envstep "
                      f"{self.n_env_steps:9d} | avgR {avg_ret:8.2f} | "
                      f"best {best:8.2f}", flush=True)
        self.state = st
        return st

    @torch.no_grad()
    def run_external(self, pool, n_generations: int, log_every: int = 1,
                     max_wall_s: float = float("inf"), z=None) -> CMAState:
        """Drive EXTERNAL (Communicator-API) envs with CMA.

        The reference's primary CMA use: user applications (e.g. CFD
        solvers) evaluated under population members
        (CMALearner::assignWeightID round-robin at episode start,
        CMALearner.cpp:29-52; generation barrier == batchSize * ESpopSize
        episodes, :154-165). `pool` is an EnvPool/SocketEnvPool whose
        spec must already be probed (pool.probe_spec()); it is served in
        lockstep rounds, each lane acting under its member's weights in
        one batched forward. z: the [P, n] population normals of each
        generation's update, in order (drawn from gen_pop when None)."""
        from smarties_tpu_torch.runtime.communicator import INIT, LAST, TERM
        if not hasattr(self, "state"):
            self.state = self.init()
        st = self.state
        mdp = pool.mdp
        n_lanes = pool.n_lanes
        lane_member = np.zeros(n_lanes, np.int64)
        work_counter = 0
        rsum = np.zeros(self.P)
        rcnt = np.zeros(self.P, np.int64)
        lane_ret = np.zeros(n_lanes)
        gen_done = 0
        t0 = t_gen = time.time()
        obs_idx = np.nonzero(mdp.observable_mask)[0]
        while gen_done < n_generations and time.time() - t0 < max_wall_s:
            events, states, rewards, statuses = pool.gather_states()
            for lane, status, state, reward in events:
                if status == INIT:
                    lane_member[lane] = work_counter % self.P
                    work_counter += 1
                    lane_ret[lane] = 0.0
                else:
                    lane_ret[lane] += reward
                if status in (TERM, LAST):
                    m = lane_member[lane]
                    rsum[m] += lane_ret[lane]
                    rcnt[m] += 1
            obs = torch.as_tensor(states[:, obs_idx], dtype=F32,
                                  device=self.device)
            obs_std = (obs - st.state_mean) * st.state_scale
            lanes_w = st.pop[torch.as_tensor(lane_member,
                                             device=self.device)]
            out, _ = apply_net(self.unravel(lanes_w, members=True),
                               self.spec, obs_std[:, None, :])
            a = self._sample(out[:, 0])
            pool.send_actions(np.asarray(
                mdp.learner_to_env_action(a).cpu(), np.float64))
            self.n_env_steps += n_lanes
            if int(rcnt.sum()) >= self.eps_per_gen:
                losses = torch.as_tensor(-rsum / np.maximum(rcnt, 1),
                                         dtype=F32, device=self.device)
                st = self._cma_update(st, losses,
                                      None if z is None else z[gen_done])
                self.n_generations += 1
                gen_done += 1
                avg_ret = float(rsum.sum() / max(rcnt.sum(), 1))
                best = -float(torch.min(losses))
                self._ep_returns.append(avg_ret)
                self.history.append({"avgR": avg_ret, "best": best,
                                     "wall_s": time.time() - t_gen,
                                     "env_steps": self.n_env_steps})
                t_gen = time.time()
                if gen_done % log_every == 0:
                    print(f"gen {self.n_generations:4d} | avgR "
                          f"{avg_ret:9.3f} | best {best:9.3f}", flush=True)
                rsum[:] = 0
                rcnt[:] = 0
        self.state = st
        return st

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, n_episodes: int = 8, max_steps=None, start=None):
        """Roll the MEAN member deterministically -> returns [n] (numpy).
        start: the env state to start from (drawn by a generator seeded
        123, as the JAX package's default key, when None)."""
        max_steps = max_steps or self.max_len
        params = self.unravel(self.state.mean)
        if start is None:
            start = self.env.init(
                torch.Generator(device=self.device).manual_seed(123),
                n_episodes, self.device)
        es, st = start, self.state
        done = torch.zeros(n_episodes, dtype=torch.bool, device=self.device)
        rets = torch.zeros(n_episodes, dtype=F32, device=self.device)
        for _ in range(max_steps):
            obs = self.mdp.observed(self.env.observe(es))
            out, _ = apply_net(params, self.spec,
                               (obs - st.state_mean) * st.state_scale)
            if self.discrete:
                a = torch.argmax(dpol.probs_of(out)[2], dim=-1
                                 )[..., None].to(F32)
            else:
                nA = self.mdp.dim_action
                a = cp.eff_mean(out[..., :nA], self.mdp.consts(out)[1])
            es, r, d, _ = self.env.step(es, self.mdp.learner_to_env_action(a))
            rets = rets + r * (~done).to(F32)
            done = done | d
            if bool(done.all()):
                break
        return rets.cpu().numpy()
