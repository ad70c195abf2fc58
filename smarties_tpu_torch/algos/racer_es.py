"""RACER / V-RACER with CMA-ES optimization (ESpopSize > 1).

Port of smarties_tpu/algos/racer_es.py (the reference's derivative-free
RACER path, settings/VRACER_CMA.json): Learner_approximator::
spawnTrainTasks runs the Train kernel for every population member, giving
per-member rho, A_RET and DKL (RACER_train.cpp:62-66); RACER::
prepareCMALoss mixes them into per-member costs

    cost(w) = alpha (costAdv + costDkl) + (1 - alpha) costVal
    costAdv = -beta clip(rho_w) avgAdv     (minus: minimize)
    costVal =  beta (min(1, avgRho) clipAdv)^2
    costDkl = (1 - beta) dkl_w

(RACER_common.cpp:35-68, averages over the members, a far-policy sample's
advantage replaced by the average), and CMA_Optimizer::apply_update makes
the rank-weighted diagonal-covariance update (algos/cma.py).

params == {"pop": [P, n]}, the flat weight vectors of algos/cma.py's
layout (member 0 = the mean). The members' forwards on a minibatch are
ONE batched forward: the [P, in, out] weights viewed out of the matrix,
[1, B, in] @ [P, in, out]. Acting uses member 0. The step draws its own
minibatch (`presample = False`, as in the JAX package, whose key chain
split(key) -> (sample, resample) differs from the presampled one) and
takes no gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smarties_tpu_torch.algos.base import (default_metrics,
                                           post_step_processing, write_back)
from smarties_tpu_torch.algos.cma import (Unravel, cma_update,
                                          mirrored_sample, pop_constants,
                                          ravel)
from smarties_tpu_torch.algos.vracer import VRacer
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import apply_net, init_params
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.ops.value_scale import scale_net2v
from smarties_tpu_torch.parallel.mesh import broadcast_, psum_
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters, anneal_rate

F32 = torch.float32


class ESOptState(NamedTuple):
    diag_cov: torch.Tensor   # [n]
    path_cov: torch.Tensor   # [n]
    noise: torch.Tensor      # [P, n]
    step: torch.Tensor       # 0-d i32


class RacerES(VRacer):
    """params == {"pop": [P, n] flat weight vectors} (member 0 = mean)."""
    presample = False
    # its population draw inside the step runs eagerly (not held under
    # capture)
    capturable = False

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters,
                 adv_kind: str | None = None):
        super().__init__(mdp, cfg, adv_kind)
        if cfg.ESpopSize <= 1:
            raise ValueError("RacerES requires ESpopSize > 1")
        if self.spec.is_recurrent or self.spec.conv:
            raise ValueError(
                f"RACER-ES (ESpopSize {cfg.ESpopSize}) evaluates its members "
                f"with a dense feed-forward net only, not nnType "
                f"{cfg.nnType!r} or a conv stack")
        self.P = cfg.ESpopSize
        w, self.mu_eff, self.sum_w = pop_constants(self.P)
        self._w_pop = torch.as_tensor(w)
        self.unravel = Unravel(init_params(torch.Generator(), self.spec))

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        """Member 0 from init_params, unit sigmas, the first population
        (its normals from the same CPU generator)."""
        flat = ravel(init_params(gen, self.spec))
        n = flat.shape[0]
        opt = ESOptState(diag_cov=torch.ones((n,), dtype=F32),
                         path_cov=torch.zeros((n,), dtype=F32),
                         noise=torch.zeros((self.P, n), dtype=F32),
                         step=torch.zeros((), dtype=torch.int32))
        pop, opt = self._resample(flat, opt, gen)
        return ({"pop": pop.to(device)},
                ESOptState(*(x.to(device) for x in opt)))

    def _resample(self, mean, opt: ESOptState, gen, z=None):
        """Mirrored population sampling (CMA_Optimizer.cpp:158-178) at the
        annealed rate of opt.step -> (pop, opt with the new noise)."""
        eta = anneal_rate(self.cfg.learnrate, opt.step.to(F32),
                          self.cfg.epsAnneal)
        pop, y = mirrored_sample(mean, opt.diag_cov, eta, self.P, gen, z)
        return pop, opt._replace(noise=y)

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        base_act = super().make_act_fn(train)

        def act(params, obs_std, gen, rnn=(), noise=None):
            return base_act(self.unravel(params["pop"][0]), obs_std, gen,
                            rnn, noise)

        return act

    # ------------------------------------------------------------------
    def _members(self, pop, mb):
        """Every member on the minibatch -> (rho, a_ret, dkl, a_val, v)
        [P, B] each, one batched forward."""
        out, _ = apply_net(self.unravel(pop, members=True), self.spec,
                           mb.s_t[None])                      # [P, B, out]
        v_raw, adv_out, pol, sraw = self._split_out(out)
        v_val = scale_net2v(v_raw)
        if self.discrete:
            shape = (self.P,) + tuple(mb.ep.shape)
            opt_a = mb.action[..., 0].long().expand(shape)
            mu = mb.mu.expand(shape + (mb.mu.shape[-1],))
            _, _, probs = dpol.probs_of(pol)
            rho = dpol.imp_weight(opt_a, probs, mu)
            dkl = dpol.kl_mu_pi(mu, probs)
            a_val = self._advantage(adv_out, opt_a, pol, probs=probs)
        else:
            sigma = cp.sigma_of(sraw)
            bounded = self.mdp.consts(pol)[1]
            rho = cp.imp_weight(mb.action, pol, sigma, mb.mu, bounded)
            dkl = cp.kl_div(mb.mu, pol, sigma)
            a_val = self._advantage(adv_out, mb.action, pol, sigma)
        return rho, mb.qret - v_val, dkl, a_val, v_val

    @torch.no_grad()
    def train_step(self, params, opt_state: ESOptState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   z=None, mesh=None):
        """One CMA step on a minibatch (RACER::prepareCMALoss +
        CMA_Optimizer::apply_update) -> (params, opt_state, rs, metrics);
        the replay's write-backs take member 0's statistics.

        sample_override: pinned (ep, t) [B]; z: the [P, n] normals of the
        resample; otherwise `gen` draws both.

        mesh: each rank draws batchSize samples from its shard (the JAX
        package's sharded step does not split this learner's batch), the
        members' losses are summed across ranks, and the resample takes
        rank 0's normals, so that the population stays the same on every
        rank (each JAX shard resamples from its own key)."""
        cfg = self.cfg
        mb = self.sample_minibatch(rs, gen, sample_override)
        rhos, advs, dkls, avals, vvals = self._members(params["pop"], mb)

        beta, alpha = rs.beta, rs.alpha
        cmax, cinv = rs.cmax_ret, rs.cinv_ret
        avg_rho = torch.mean(rhos, dim=0)                     # [B]
        avg_adv = torch.mean(advs, dim=0)
        is_far = (rhos >= cmax) | (rhos <= cinv)              # [P, B]
        clip_rho = torch.minimum(torch.maximum(rhos, cinv), cmax)
        clip_adv = torch.where(is_far, avg_adv[None, :], advs)
        critic_err = torch.clamp(avg_rho, max=1.0)[None, :] * clip_adv
        cost_adv = -beta * clip_rho * avg_adv[None, :]
        cost_val = beta * critic_err ** 2
        cost_dkl = (1 - beta) * dkls
        losses = torch.sum(alpha * (cost_adv + cost_dkl)
                           + (1 - alpha) * cost_val, dim=1)   # [P]
        if mesh is not None:
            psum_(mesh, losses)
            if z is None:
                z = broadcast_(mesh, torch.randn(
                    tuple(opt_state.noise.shape), generator=gen, dtype=F32,
                    device=losses.device))

        if self._w_pop.device != losses.device:
            # once: a copy from host memory inside the step would wait
            self._w_pop = self._w_pop.to(losses.device)
        new_mean, path, sig = cma_update(
            params["pop"], opt_state.noise, losses, opt_state.path_cov,
            opt_state.diag_cov, self._w_pop, self.mu_eff, self.sum_w)
        new_opt = ESOptState(diag_cov=sig, path_cov=path,
                             noise=opt_state.noise, step=opt_state.step + 1)
        new_pop, new_opt = self._resample(new_mean, new_opt, gen, z)

        # write-backs with the MEAN member's statistics; the batch's
        # far-policy flags against the Cmax of this step, which
        # post_step_processing anneals in place
        far0 = rb.is_far_policy(rhos[0], cmax, cinv)
        delta = advs[0] - avals[0]
        rs = write_back(rs, mb, rhos[0], dkls[0], delta, vvals[0], avals[0])
        rs, frac_off = post_step_processing(rs, cfg, new_opt.step, delta,
                                            mesh)
        metrics = default_metrics(dkls[0], rhos[0], far0, frac_off, rs.beta,
                                  delta, vvals[0], mesh)
        return {"pop": new_pop}, new_opt, rs, metrics
