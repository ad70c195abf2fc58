"""Return estimators: Retrace, Retrace+exploration-bonus, GAE.

Port of smarties_tpu/ops/returns.py (reference recursions:
MemoryProcessing.cpp:391-458):

  Retrace:  Qret[t] = rr[t+1] + g*( V[t+1]
                      + lam * min(1, rho[t+1]) * (Qret[t+1]-A[t+1]-V[t+1]) )
  GAE:      Qret[t] = rr[t+1] + g*( V[t+1] + lam * (Qret[t+1]-V[t+1]) )

with Qret[T] = 0 for terminal episodes and V[T] for truncated ones.

Retrace and GAE are affine in Qret[t+1]: q[t] = a[t] + b[t] * q[t+1]. This
module holds the PLAIN torch form of that sweep (`retrace_coeffs`,
`affine_suffix_scan_plain`, `batched_retrace_plain`): the CPU tests run
it, `chip_smoke.py` holds the CUDA kernel against it, and
`ops/retrace_kernel.py` calls it for tensors on the CPU.
`batched_return_estimate` dispatches retrace/GAE to that wrapper, which
launches the CUDA kernel for CUDA tensors. retraceExplore is not affine
and keeps the sequential recursion (`sequential_returns`).

Array layout (state-indexed, length L+1 along time), public orientation
[E, L+1] as in the JAX package:
  r[t]   : reward received on arriving at state t (r[0] == 0)
  V[t]   : V(s_t)
  A[t]   : advantage of the taken action; == 0 at t == T
  rho[t] : importance weight pi/mu; == 0 at t == T
"""
from __future__ import annotations

import torch


def retrace_coeffs(r_scaled, value, advantage, rho, length, terminal,
                   gamma, lam, mode="retrace"):
    """Affine coefficients (a, b) [E, L1] of the backward recursion,
    shifted by one step so that element t maps q[t+1] to q[t].

    Mirrors smarties_tpu/ops/pallas_retrace.py::retrace_coeffs exactly:
    the roll by -1 wraps the t == 0 entry to t == L1-1, which is only
    ever read when length > L1-1 (never for a stored episode); at
    t == length the map is (bootstrap, 0) — including length == L1-1 —
    and beyond it (0, 0)."""
    E, L1 = r_scaled.shape
    idx = torch.arange(L1, device=r_scaled.device)[None, :]
    ln = length.long()[:, None]
    v_at_T = torch.gather(value, 1, ln)[:, 0]
    bootstrap = torch.where(terminal, torch.zeros_like(v_at_T), v_at_T)
    if mode == "GAE":
        a = r_scaled + gamma * (1 - lam) * value
        b = torch.full((E, L1), gamma * lam, dtype=r_scaled.dtype,
                       device=r_scaled.device)
    else:
        c_w = torch.clamp(rho, max=1.0)
        a = r_scaled + gamma * (value - lam * c_w * (advantage + value))
        b = gamma * lam * c_w
    a = torch.roll(a, -1, dims=1)
    b = torch.roll(b, -1, dims=1)
    a = torch.where(idx < ln, a,
                    torch.where(idx == ln, bootstrap[:, None],
                                torch.zeros_like(a)))
    b = torch.where(idx < ln, b, torch.zeros_like(b))
    return a, b


def affine_suffix_scan_plain(a, b):
    """q[e, t] = a[e, t] + b[e, t] * q[e, t+1], q beyond L1-1 is 0.

    The plain version of kernel K1 (smarties_tpu/ops/pallas_retrace.py::
    affine_suffix_scan): a sequential backward loop over t on [E] rows.
    a, b: [E, L1] float32 -> q [E, L1]."""
    E, L1 = a.shape
    q = torch.empty((E, L1), dtype=a.dtype, device=a.device)
    acc = torch.zeros((E,), dtype=a.dtype, device=a.device)
    for t in range(L1 - 1, -1, -1):
        acc = a[:, t] + b[:, t] * acc
        q[:, t] = acc
    return q


def batched_retrace_plain(r_scaled, value, advantage, rho, length,
                          terminal, gamma, lam, mode="retrace"):
    """Coefficients, suffix scan and the t > length mask: the plain
    version of what the fused CUDA entry point computes
    (smarties_tpu/ops/pallas_retrace.py::batched_retrace_pallas)."""
    a, b = retrace_coeffs(r_scaled, value, advantage, rho, length,
                          terminal, gamma, lam, mode)
    q = affine_suffix_scan_plain(a, b)
    idx = torch.arange(r_scaled.shape[1], device=q.device)[None, :]
    return torch.where(idx <= length.long()[:, None], q, torch.zeros_like(q))


def sequential_returns(r_scaled, value, advantage, rho, length, terminal,
                       gamma, lam, mode="retrace", err_baseline=0.0):
    """The reference's sequential recursion batched over [E, L1] rows
    (smarties_tpu/ops/returns.py:94-119). The only path for the
    non-affine retraceExplore; exact for retrace and GAE too."""
    E, L1 = r_scaled.shape
    L = L1 - 1
    ln = length.long()
    v_at_T = torch.gather(value, 1, ln[:, None])[:, 0]
    bootstrap = torch.where(terminal, torch.zeros_like(v_at_T), v_at_T)
    qret = torch.zeros((E, L1), dtype=r_scaled.dtype, device=r_scaled.device)
    carry = torch.zeros((E,), dtype=r_scaled.dtype, device=r_scaled.device)
    for t in range(L - 1, -1, -1):
        q_tp1 = torch.where(ln == t + 1, bootstrap, carry)
        c_w = torch.clamp(rho[:, t + 1], max=1.0)
        v1, a1 = value[:, t + 1], advantage[:, t + 1]
        if mode == "GAE":
            q = r_scaled[:, t + 1] + gamma * (v1 + lam * (q_tp1 - v1))
        else:
            q = r_scaled[:, t + 1] + gamma * (
                v1 + lam * c_w * (q_tp1 - a1 - v1))
            if mode == "retraceExplore":
                # MemoryProcessing.cpp:402-408
                e = torch.abs(q_tp1 - a1 - v1) - err_baseline
                q = (1 - gamma) * e + q
        q = torch.where(ln > t, q, torch.zeros_like(q))
        carry = q
        qret[:, t] = q
    idx = torch.arange(L1, device=qret.device)[None, :]
    return torch.where(idx == ln[:, None], bootstrap[:, None], qret)


def episode_return_estimate(r_scaled, value, advantage, rho, length,
                            terminal, gamma, lam, mode="retrace",
                            err_baseline=0.0):
    """Backward return recursion for ONE episode slot ([L+1] arrays,
    scalar length/terminal tensors). Returns qret [L+1], 0 beyond T."""
    rows = [x[None] for x in (r_scaled, value, advantage, rho)]
    ln = torch.as_tensor(length, device=r_scaled.device).reshape(1)
    term = torch.as_tensor(terminal, device=r_scaled.device).reshape(1)
    if mode in ("retrace", "GAE"):
        return batched_retrace_plain(*rows, ln, term, gamma, lam, mode)[0]
    return sequential_returns(*rows, ln, term, gamma, lam, mode,
                              err_baseline)[0]


def batched_return_estimate(r_scaled, value, advantage, rho, length,
                            terminal, gamma, lam, mode="retrace",
                            err_baseline=0.0):
    """Batched backward recursion over the episode-slot axis ([E, L+1]).

    retrace/GAE go through `ops/retrace_kernel.batched_retrace`: the CUDA
    kernel for CUDA tensors, `batched_retrace_plain` for CPU tensors.
    Unlike the JAX package (prefer_pallas, returns.py:122-141) there is
    no second route: nothing here forbids the kernel inside the fused
    cycle. retraceExplore keeps the sequential recursion."""
    if mode in ("retrace", "GAE"):
        from smarties_tpu_torch.ops.retrace_kernel import batched_retrace
        return batched_retrace(r_scaled, value, advantage, rho, length,
                               terminal, gamma, lam, mode)
    return sequential_returns(r_scaled, value, advantage, rho, length,
                              terminal, gamma, lam, mode, err_baseline)
