"""The port's recurrent V-RACER against the benchmark's plain reference
(benchmark/reference/lstm.py, racer.py, racer_rnn_cartpole.py: plain
PyTorch from smarties' description, independent of the port), at a
small size (LSTM [8, 8], W = 4, B = 6) on seeded random weights:

- `apply_net` one step from a random carry against the reference cell;
- `bptt_window`, `seq_outputs` and `seq_forward_vjp` against the
  reference's window in float64, on windows that cross an episode's
  start: the outputs at t and t+1 and every leaf's gradient;
- `bptt_counts` against benchmark/bptt_flops.py's count from the shapes;
- four pinned V-RACER steps of the LSTM (the Trainer's eager chunk on
  the no-velocity cart-pole) against reference/racer.py's grad_steps
  with the reference's LSTM forward: each step's rms TD error, the
  first step's gradient and the weights after the four steps.

This file imports neither jax nor the JAX package.
"""
import pytest
import torch

from benchmark import bptt_flops
from benchmark.drivers import train_bptt, train_fused
from benchmark.reference import lstm
from benchmark.reference import racer_rnn_cartpole as rref
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.envs import cartpole
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

torch.set_num_threads(1)

HIDDEN, W, B, N_IN = (8, 8), 4, 6, 3
ARCH = {"n_in": N_IN, "hidden": list(HIDDEN), "n_out": 2, "n_param": 1,
        "act": "SoftSign", "out_prefac": 0.1}
SPEC = tnet.NetSpec(n_in=N_IN, hidden=HIDDEN, n_out=2, kind="LSTM",
                    n_param_out=1, param_init=(0.3,))


def _weights(seed):
    """Reference weights with every bias moved off its start, f32."""
    g = torch.Generator().manual_seed(seed)
    w = lstm.draw_weights(g, ARCH, 0.3)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g)
            if k.split(".")[-1].startswith("b") or k == "param" else v
            for k, v in w.items()}


def _program(w):
    params = tnet.init_params(torch.Generator().manual_seed(0), SPEC)
    train_bptt.write_weights(params, w)
    return params


def test_apply_net_is_the_reference_cell():
    w = _weights(1)
    params = _program(w)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((B, N_IN), generator=g)
    carry = tuple((torch.randn((B, h), generator=g),
                   torch.randn((B, h), generator=g)) for h in HIDDEN)
    y, new = tnet.apply_net(params, SPEC, x, carry)
    w64 = {k: v.double() for k, v in w.items()}
    h = x.double()
    for i, (hp, cp) in enumerate(carry):
        h, c = lstm.cell(w64, i, h, hp.double(), cp.double())
        torch.testing.assert_close(new[i][0].double(), h, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(new[i][1].double(), c, rtol=1e-5,
                                   atol=1e-6)
    torch.testing.assert_close(y.double(), lstm.head(w64, h), rtol=1e-5,
                               atol=1e-6)


def _replay(seed):
    """A replay of 4 slots of random states with lengths 3, 9, 12, 20,
    and samples at t = 0, 1, W - 1, W, and later, crossing the start."""
    g = torch.Generator().manual_seed(seed)
    rs = rb.init_replay(4, 24, N_IN, 1, 2, 4.0)
    lens = torch.tensor([3, 9, 12, 20], dtype=torch.int32)
    rs.states_tm.copy_(torch.randn(rs.states_tm.shape, generator=g))
    rs.slot_len.copy_(lens)
    rs.slot_id.copy_(torch.arange(4))
    rs.state_mean.copy_(torch.randn((N_IN,), generator=g) * 0.1)
    rs.state_scale.copy_(1 + 0.2 * torch.rand((N_IN,), generator=g))
    ep = torch.tensor([0, 1, 1, 2, 3, 3], dtype=torch.int32)
    t = torch.tensor([0, 1, W - 1, W, 11, 19], dtype=torch.int32)
    return rs, ep, t


@pytest.mark.parametrize("seed", [3, 4])
def test_window_outputs_and_gradients_are_the_reference(seed):
    w = _weights(seed)
    params = _program(w)
    rs, ep, t = _replay(seed)
    xs, active = base.bptt_window(rs, ep, t, W)
    assert xs.shape == (B, W + 1, N_IN)
    # the reference's window from the benchmark's gather
    frames = train_bptt.window_batch(rs, ep, t, W, rs.rho_tm)["frames"]
    assert torch.equal(frames[..., -1] > 0, active)
    assert not bool(active[0, :W - 1].any()) and bool(active[-1].all())
    x64 = rref.net_input(frames, rs.state_mean.double(),
                         rs.state_scale.double())
    torch.testing.assert_close(x64[..., :-1], xs.double(), rtol=1e-6,
                               atol=1e-7)
    w64 = {k: v.double().requires_grad_(True) for k, v in w.items()}
    r_t, r_t1 = lstm.window(w64, ARCH, x64[..., :-1], active)

    p_t, p_t1 = base.seq_outputs(params, SPEC, xs, active)
    torch.testing.assert_close(p_t.double(), r_t, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p_t1.double(), r_t1, rtol=1e-5, atol=1e-6)
    assert p_t.requires_grad and not p_t1.requires_grad

    cot = torch.randn(p_t.shape, generator=torch.Generator().manual_seed(9))
    o, o1, pull = base.seq_forward_vjp(params, SPEC, xs, active)
    assert torch.equal(o, p_t.detach()) and torch.equal(o1, p_t1)
    grads = train_bptt.program_leaves(pull(cot))
    ref = dict(zip(w64, torch.autograd.grad((r_t * cot.double()).sum(),
                                            list(w64.values()))))
    assert set(grads) == set(ref)
    for k in ref:
        torch.testing.assert_close(grads[k].double(), ref[k], rtol=1e-4,
                                   atol=1e-6, msg=k)


def test_bptt_counts_are_the_shapes():
    xs = torch.zeros((B, W + 1, N_IN))
    c = base.bptt_counts(SPEC, xs)
    assert c["bptt_cells"] == (2 * W + 1) * 2
    assert c["bptt_macs"] == (B * (W + 1) * 4 * (N_IN * 8 + 64),
                              B * (W + 1) * 4 * (8 * 8 + 64))
    # the FLOPs' forward cells are these multiply-adds
    fwd_cells = sum(c["bptt_macs"])
    total = bptt_flops.step_flops("LSTM", N_IN, HIDDEN, 2, B, W)
    assert total == 2 * (fwd_cells + B * (W + 1) * 16
                         + B * W * (fwd_cells // (B * (W + 1))
                                    + 2 * 4 * 64 + 4 * 64)
                         + B * 2 * 16)


def test_four_pinned_steps_are_the_reference():
    """The eager chunk of the Trainer, step by step on pinned rows,
    against the reference's four steps in float64 from the same replay,
    weights and ReF-ER scalars."""
    settings = dict(learner="VRACER", nnType="LSTM", nnLayerSizes=[8, 8],
                    nnBPTTseq=W, batchSize=16, minTotObsNum=256,
                    maxTotObsNum=1024, randSeed=5)
    env = cartpole.pomdp
    tr = Trainer(env, env.MDP, HyperParameters(**settings), n_envs=8,
                 n_slots=48, max_len=64, device="cpu", graphs=False)
    tr.warmup(chunk=16)
    arch = rref.arch({"settings": settings})
    w0 = lstm.draw_weights(torch.Generator().manual_seed(6), arch,
                           rref.param_init({"settings": {
                               "explNoise": tr.cfg.explNoise}}))
    train_bptt.write_weights(tr.params, w0)
    train_bptt.reset_adam(tr.opt_state)
    rs = tr.replay
    rho0 = rs.rho_tm.clone()
    sc0 = {"beta": rs.beta.clone(), "alpha": rs.alpha.clone(),
           "cmax": rs.cmax_ret.clone(),
           "n_stored": float(rs.n_stored_steps()),
           "n_far": float(rs.far_count.sum())}
    mean, scale = rs.state_mean.clone(), rs.state_scale.clone()
    ep, t = base.presample_uniform(tr.gen_batch, rs, 16, 4)
    losses, g1 = [], None
    for k in range(4):
        m = tr._train_chunk(1, pre=(ep[k:k + 1], t[k:k + 1]))
        losses.append(float(m["rmse"][0]))
        if k == 0:
            g1 = train_bptt.read_tree(tr.opt_state.m1, 1 / 0.1)
            rho1 = train_fused._written_rho(rs, ep[0], t[0])
    snap = {"steps": {
        "batches": [train_bptt.window_batch(rs, ep[k], t[k], W, rho0)
                    for k in range(4)],
        "sc0": sc0, "mean": mean, "scale": scale, "w1": w0}}
    ref = train_fused.reference_steps(snap, rref, arch,
                                      tr.cfg.to_dict(), torch.float64,
                                      False)
    gaps = train_fused.step_gaps(
        {"losses": losses, "grad": g1, "w3": train_bptt.read_tree(tr.params),
         "rho": rho1}, ref, w0)
    # float32 against float64, in the cell's measures (train_fused.
    # step_gaps): each step's rms TD error over the batch's rms Qret (the
    # TD error cancels), the worst leaf's first gradient and change after
    # four steps over its norm, each written-back importance weight; each
    # gap under the cell's limit (benchmark/limits/racer_rnn_cartpole.
    # fused.json) at an eighth of its rows
    assert gaps["loss"] < 2e-4 and gaps["rho"] < 1e-5, gaps
    assert gaps["grad"] < 2e-3 and gaps["change"] < 1e-3, gaps
