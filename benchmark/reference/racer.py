"""RACER and V-RACER grad steps with ReF-ER in plain PyTorch
(Novati & Koumoutsakos 2019, "Remember and Forget for Experience
Replay"; cselab/smarties Learners/RACER_train.cpp, Optimizer.cpp).

A step, for a minibatch of B stored transitions (s_t, a_t, mu_t,
Qret_t):
- the net gives V = h^-1(v_raw) (the R2D2 value rescaling of
  RACER_common.cpp), the policy pi, and for RACER-discrete the advantage
  A(a) = adv[a] - sum_j pi_j adv_j;
- rho = pi(a) / mu(a) (continuous: the log-ratio clipped to +-7), the
  sample is far-policy when rho is outside [1/C, C] (C > 1);
- delta = Qret - V - A; the ascent objective per near-policy sample is
  beta (min(1, rho) delta V + min(C, rho) delta A + (Qret - V) min(C,
  rho) log pi(a)), the coefficients held constant, minus (1 - beta)
  KL(pi || mu) on every sample;
- its gradient (autograd here; the program sets it analytically on the
  output layer), summed over the batch and divided by B, takes an Adam
  ascent step with smarties' compile-time options: the second moment
  floored at the first's square, a Nesterov numerator, decoupled weight
  decay, and the step size annealed as eta / (1 + step epsAnneal);
- then C = 1 + clipImpWeight / (1 + step epsAnneal) and the ReF-ER
  beta moves towards 0 while the far-policy share of the replay exceeds
  penalTol, else towards 1, at rate 0.1 B / max(maxTotObsNum, stored).

The policy is a diagonal Gaussian squashed by tanh into the action box
(stdev = (x + sqrt(1 + x^2)) / 2 of a raw head), or for discrete actions
p_i = f(o_i) / sum_j f(o_j) with the same f. Means beyond the tanh
saturation (|mean| >= 8.3178) are clamped as in the program only where
the program stores them; this reference does not model the program's
gate on their gradient.
"""
from __future__ import annotations

import math

import torch

MEAN_MAX = 8.31776613503286
LOG_SQRT_2PI = 0.9189385332046727
F32_EPS = 1.1920928955078125e-07
F32_TINY = 1.1754943508222875e-38


def softplus(x):
    return (x + torch.sqrt(1 + x * x)) / 2


def softplus_inv(y: float) -> float:
    return (y * y - 0.25) / y


def net2v(x):
    """Inverse of the value compression h(V) = sign(V)(sqrt(1+|V|)-1)
    + 0.01 V."""
    pos = 100 * (x + 51) - 100 * torch.sqrt(2601 + 100 * x)
    neg = 100 * (x - 51) + 100 * torch.sqrt(2601 - 100 * x)
    return torch.where(x > 0, pos, torch.where(x < 0, neg,
                                               torch.zeros_like(x)))


def _gauss_logp(a, m, s, bounded):
    """log N(a; m, s) per dim, with the tanh change of variables on
    bounded dims."""
    lp = -torch.square((a - m) / s) / 2 - torch.log(s) - LOG_SQRT_2PI
    jac = torch.clamp(1 - torch.tanh(a) ** 2, min=F32_TINY)
    return torch.where(bounded, lp - torch.log(jac), lp)


def objective(out, mb, sc, cfg, kind, n_act):
    """(ascent objective summed over the batch, per-sample delta) for
    outputs `out` [B, n_out]. mb: action (continuous [B, nA] or option
    [B]), mu [B, P], qret [B], valid [B]; sc: beta, cmax."""
    beta, cmax = sc["beta"], sc["cmax"]
    v_raw = out[:, 0]
    V = net2v(v_raw)
    qret, mu, valid = mb["qret"], mb["mu"], mb["valid"]
    # rows that hold no stored transition (an empty or finished slot's
    # padding) take a harmless behaviour policy and give nothing
    v2 = valid[:, None]
    if kind == "discrete":
        mu = torch.where(v2, mu, torch.full_like(mu, 1.0 / n_act))
    else:
        mu = torch.where(v2, mu, torch.cat([torch.zeros_like(
            mu[:, :n_act]), torch.ones_like(mu[:, n_act:])], 1))
    if kind == "discrete":
        n = n_act
        adv = out[:, 1:1 + n]
        f = softplus(out[:, 1 + n:1 + 2 * n])
        p = f / torch.clamp(f.sum(-1, keepdim=True), min=F32_EPS)
        opt = mb["action"].long()
        p_a = p.gather(1, opt[:, None])[:, 0]
        rho = p_a / mu.gather(1, opt[:, None])[:, 0]
        kl = torch.sum(p * torch.log(p / torch.clamp(mu, min=F32_EPS)), -1)
        A = adv.gather(1, opt[:, None])[:, 0] - torch.sum(
            p.detach() * adv, -1)
        logp = torch.log(p_a)
    else:
        mean = out[:, 1:1 + n_act]
        s = softplus(out[:, 1 + n_act:1 + 2 * n_act])
        a, bounded = mb["action"], mb["bounded"]
        m_eff = torch.where(bounded, torch.clamp(mean, -MEAN_MAX,
                                                 MEAN_MAX), mean)
        logp = _gauss_logp(a, m_eff, s, bounded).sum(-1)
        logmu = _gauss_logp(a, mu[:, :n_act], mu[:, n_act:], bounded).sum(-1)
        rho = torch.exp(torch.clamp(logp - logmu, -7.0, 7.0))
        s_mu = mu[:, n_act:]
        c = torch.square(s / s_mu)
        kl = torch.sum((c - 1 + torch.square((mean - mu[:, :n_act]) / s_mu)
                        - torch.log(c)) / 2, -1)
        A = torch.zeros_like(V)
    far = (cmax > 1) & ((rho > cmax) | (rho < 1 / cmax))
    near = (~far).to(out.dtype)
    a_ret = (qret - V).detach()
    delta = (qret - V - A).detach()
    rho_c = rho.detach()
    obj = beta * near * (torch.clamp(rho_c, max=1.0) * delta * V
                         + torch.minimum(cmax, rho_c) * delta * A
                         + a_ret * torch.minimum(cmax, rho_c) * logp)
    obj = torch.where(valid, obj - (1 - beta) * kl, torch.zeros_like(obj))
    return obj.sum(), delta, rho_c, far


def adam_init(w):
    z = {k: torch.zeros_like(v) for k, v in w.items()}
    return {"m1": z, "m2": {k: v.clone() for k, v in z.items()},
            "bt1": 0.9, "bt2": 0.999, "step": 0}


def adam_ascent(w, grads, st, cfg, B):
    """smarties' Adam with SAFE_ADAM, NESTEROV_ADAM and ADAMW, an ascent
    step on the batch-mean gradient; in place on w and st."""
    b1, b2 = 0.9, 0.999
    eta = cfg["learnrate"] / (1 + st["step"] * cfg["epsAnneal"])
    eta_t = eta * math.sqrt(1 - st["bt2"]) / (1 - st["bt1"])
    with torch.no_grad():
        for k in w:
            dw = grads[k] / B
            m1 = st["m1"][k] = b1 * st["m1"][k] + (1 - b1) * dw
            m2 = st["m2"][k] = torch.maximum(
                b2 * st["m2"][k] + (1 - b2) * dw * dw, m1 * m1)
            ret = (b1 * m1 + (1 - b1) * dw) / (F32_EPS + torch.sqrt(m2))
            w[k] = w[k] + eta_t * (ret - cfg["nnLambda"] * w[k])
    st["bt1"] = 0.0 if st["bt1"] * b1 < F32_EPS else st["bt1"] * b1
    st["bt2"] = 0.0 if st["bt2"] * b2 < F32_EPS else st["bt2"] * b2
    st["step"] += 1


def grad_steps(w0, batches, sc0, cfg, kind, n_act, forward):
    """Follow len(batches) grad steps from weights w0 (a dict of
    tensors, copied) -> per step {"loss": rms of delta, "grad":
    {leaf: batch-mean gradient} (first step)}, and the final weights.
    batches[k]: the step's inputs (see `objective`, plus "x": the
    standardized net inputs, and "rho_old", "key" for the far-policy
    count); sc0: beta, alpha, cmax, n_stored, n_far at the start."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    st = adam_init(w)
    sc = dict(sc0)
    rho_seen = {}
    out_steps = []
    for mb in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        out = forward(leaves, mb["x"])
        obj, delta, rho, far = objective(out, mb, sc, cfg, kind, n_act)
        names = list(leaves)
        gs = torch.autograd.grad(obj, [leaves[k] for k in names],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, gs)}
        B = delta.shape[0]
        out_steps.append({"loss": float(torch.sqrt(torch.mean(delta ** 2))),
                          "rho": rho,
                          "qret_rms": float(torch.sqrt(torch.mean(
                              mb["qret"] ** 2))),
                          "grad": {k: g / B for k, g in grads.items()}})
        adam_ascent(w, grads, st, cfg, B)
        # the far-policy count of the replay, row by row
        cmax = sc["cmax"]
        keys = mb["key"].tolist()
        old = torch.stack([rho_seen.get(k, r) for k, r in
                           zip(keys, mb["rho_old"])])
        was = (cmax > 1) & ((old > cmax) | (old < 1 / cmax))
        valid = mb["valid"]
        sc["n_far"] = sc["n_far"] + float(
            (far.to(torch.float64) - was.to(torch.float64))[valid].sum())
        for k, r, v in zip(keys, rho, valid.tolist()):
            if v:
                rho_seen[k] = r
        c = 1.0 + cfg["clipImpWeight"] / (1.0 + st["step"] * cfg["epsAnneal"])
        sc["cmax"] = torch.tensor(c, dtype=out.dtype, device=out.device)
        frac = sc["n_far"] / max(sc["n_stored"], 1.0)
        lr = 0.1 * cfg["batchSize"] / max(sc["n_stored"],
                                          float(cfg["maxTotObsNum"]))
        b = float(sc["beta"])
        step = min(lr, b)
        b = (1 - step) * b if frac > cfg["penalTol"] else \
            (1 - step) * b + min(lr, 1 - b)
        sc["beta"] = torch.tensor(b, dtype=out.dtype, device=out.device)
    return out_steps, w
