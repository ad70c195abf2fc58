"""Port parity: the replay's fused in-place return sweep.

`ops/returns.retrace_sweep_plain_` is the plain version of the CUDA entry
point `ops/retrace_kernel.retrace_sweep_`: reward scaling, the v_trunc
substitution, the Retrace/GAE recursion and the per-slot select in one
function, written into qret in place. Here, on the CPU:

- it is held bit for bit (torch.equal) against the composition it
  replaced in the replay: `scaled_rewards_tm`, `value_with_trunc_tm`,
  `batched_retrace_plain` and a `where` over the selected slots. Both
  run the same f32 operations in the same order;
- `refresh_new_returns` and `recompute_returns`, which now go through
  it, are held against the JAX package's (whose sweep reaches
  `batched_retrace_pallas`; on the CPU that is its plain jnp recursion)
  at rtol 1e-5 / atol 1e-5: the two frameworks round the same products
  of b <= gamma < 1 in another order over at most 40 steps.

The replays hold truncated and terminal slots, empty slots, slots of
length L and of length 1, stale and fresh rows, and reward statistics
other than (0, 1). The kernel itself is checked on the card
(chip_smoke.py and the cuda-marked tests/test_torch_kernel_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.replay import buffer as jrb
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.ops import returns as tret
from smarties_tpu_torch.replay import buffer as trb

from _torch_parity import assert_replay_close, jax_replay_views, np32, tn

TOL = dict(rtol=1e-5, atol=1e-5)
GAMMA, LAM = 0.995, 0.95
# (slots, max_len, committed episodes): the last leaves slots empty
SIZES = [(8, 10, 8), (24, 30, 17), (64, 40, 50)]


def _replays(seed, E, L, n_eps):
    """The same replay in both frameworks: n_eps episodes of seeded
    lengths (L and 1 among them) in seeded slots, the others empty;
    random fields everywhere, so that a sweep that read beyond a slot's
    length, or an empty slot, would show."""
    rng = np.random.RandomState(seed)
    L1 = L + 1
    length = rng.randint(1, L + 1, E).astype(np.int32)
    length[:2] = [L, 1]
    ep_id = np.full(E, -1, np.int32)
    ep_id[rng.permutation(E)[:n_eps]] = np.arange(n_eps)
    rj = jrb.init_replay(E, L, 3, 2, 4, 4.0)._replace(
        rewards=jnp.asarray(np32(rng.randn(E, L1))),
        value=jnp.asarray(np32(rng.randn(E, L1))),
        advantage=jnp.asarray(np32(rng.randn(E, L1) * 0.3)),
        rho=jnp.asarray(np32(np.exp(rng.randn(E, L1)))),
        qret=jnp.asarray(np32(rng.randn(E, L1))),
        length=jnp.asarray(length), ep_id=jnp.asarray(ep_id),
        terminal=jnp.asarray(rng.rand(E) > 0.5),
        v_trunc=jnp.asarray(np32(rng.randn(E))),
        qret_stale=jnp.asarray(rng.rand(E) > 0.4),
        rew_mean=jnp.float32(0.2), rew_scale=jnp.float32(1.7),
        max_abs_error=jnp.float32(0.3))
    rt = convert.replay_from_jax(jax_replay_views(rj))
    # the stored value at t == length is stale by design in both
    # packages: only v_trunc may be read there
    rt.value_tm[rt.slot_len.long(), torch.arange(E)] = 1e6
    return rj, rt


def _composition(rt, select, mode, zero_unselected):
    """What the replay's sweeps computed before the fused entry point."""
    q = tret.batched_retrace_plain(
        rt.scaled_rewards_tm().t(), rt.value_with_trunc_tm().t(),
        rt.advantage_tm.t(), rt.rho_tm.t(), rt.slot_len, rt.slot_term,
        GAMMA, LAM, mode).t()
    other = torch.zeros_like(rt.qret_tm) if zero_unselected else rt.qret_tm
    return torch.where(select[None, :], q, other)


@pytest.mark.parametrize("zero_unselected", [False, True])
@pytest.mark.parametrize("mode", ["retrace", "GAE"])
@pytest.mark.parametrize("size", SIZES)
def test_sweep_plain_equals_the_composition(size, mode, zero_unselected):
    _, rt = _replays(0, *size)
    valid = rt.valid_slots()
    for select in (rt.qret_stale & valid, valid, torch.zeros_like(valid)):
        want = _composition(rt, select, mode, zero_unselected)
        qret = rt.qret_tm.clone()
        out = tret.retrace_sweep_plain_(
            qret, rt.rewards_tm, rt.value_tm, rt.advantage_tm, rt.rho_tm,
            rt.v_trunc, rt.slot_len, rt.slot_term, select, rt.rew_mean,
            rt.rew_scale, GAMMA, LAM, mode, zero_unselected)
        assert out is qret
        assert torch.equal(qret, want)
        keep = ~select
        if zero_unselected:
            assert not qret[:, keep].any()
        else:
            assert torch.equal(qret[:, keep], rt.qret_tm[:, keep])


def test_sweep_takes_v_trunc_at_length_and_nothing_beyond():
    """A slot's result depends on v_trunc where the stored value at
    t == length would be read, and on no entry at t > length."""
    _, rt = _replays(1, 24, 30, 24)
    select = rt.valid_slots()
    args = lambda q, v, r: (q, r, v, rt.advantage_tm, rt.rho_tm, rt.v_trunc,
                            rt.slot_len, rt.slot_term, select, rt.rew_mean,
                            rt.rew_scale, GAMMA, LAM, "retrace", True)
    base = tret.retrace_sweep_plain_(*args(rt.qret_tm.clone(), rt.value_tm,
                                           rt.rewards_tm))
    t = torch.arange(rt.max_len + 1)[:, None]
    at_or_past = t >= rt.slot_len[None, :]
    junk = torch.full_like(rt.value_tm, 1e6)
    v2 = torch.where(at_or_past, junk, rt.value_tm)
    r2 = torch.where(t > rt.slot_len[None, :], junk, rt.rewards_tm)
    again = tret.retrace_sweep_plain_(*args(rt.qret_tm.clone(), v2, r2))
    assert torch.equal(base, again)
    # q[length] is the bootstrap: v_trunc, or 0 at a true terminal
    e = torch.arange(rt.n_slots)
    want = torch.where(rt.slot_term, torch.zeros(()), rt.v_trunc)
    assert torch.equal(base[rt.slot_len.long(), e], want)


def test_sweep_wrapper_on_cpu_is_the_plain_version():
    _, rt = _replays(2, 24, 30, 17)
    select = rt.qret_stale & rt.valid_slots()
    cuda_lib.reset_launches()
    got, want = rt.qret_tm.clone(), rt.qret_tm.clone()
    for fn, q in ((rk.retrace_sweep_, got), (tret.retrace_sweep_plain_, want)):
        fn(q, rt.rewards_tm, rt.value_tm, rt.advantage_tm, rt.rho_tm,
           rt.v_trunc, rt.slot_len, rt.slot_term, select, rt.rew_mean,
           rt.rew_scale, GAMMA, LAM, "GAE", False)
    assert torch.equal(got, want)
    assert rk.launches["retrace_sweep"] == 0 and not rk.LIB.loaded
    with pytest.raises(ValueError):
        rk.retrace_sweep_(got, rt.rewards_tm, rt.value_tm, rt.advantage_tm,
                          rt.rho_tm, rt.v_trunc, rt.slot_len, rt.slot_term,
                          select, rt.rew_mean, rt.rew_scale, GAMMA, LAM,
                          "retraceExplore", False)
    with pytest.raises(ValueError):
        rk.retrace_sweep_(got.to("meta"), rt.rewards_tm, rt.value_tm,
                          rt.advantage_tm, rt.rho_tm, rt.v_trunc,
                          rt.slot_len, rt.slot_term, select, rt.rew_mean,
                          rt.rew_scale, GAMMA, LAM, "retrace", False)


@pytest.mark.parametrize("mode", ["retrace", "GAE", "retraceExplore"])
@pytest.mark.parametrize("size", SIZES)
def test_refresh_new_returns_vs_jax(size, mode):
    """Stale valid slots get their returns; every other row, empty slots
    included, stays as it was; qret_stale is cleared."""
    rj, rt = _replays(3, *size)
    before = rt.qret_tm.clone()
    fresh = ~(rt.qret_stale & rt.valid_slots())
    want = None if mode == "retraceExplore" else _composition(
        rt, ~fresh, mode, False)
    rj = jrb.refresh_new_returns(rj, GAMMA, LAM, mode)
    rt = trb.refresh_new_returns(rt, GAMMA, LAM, mode)
    assert_replay_close(rj, rt, fields=("qret", "qret_stale"), **TOL)
    assert torch.equal(rt.qret_tm[:, fresh], before[:, fresh])
    assert not tn(rt.qret_stale).any()
    if want is not None:
        assert torch.equal(rt.qret_tm, want)


@pytest.mark.parametrize("mode", ["retrace", "GAE", "retraceExplore"])
@pytest.mark.parametrize("size", SIZES)
def test_recompute_returns_vs_jax(size, mode):
    """Every valid slot recomputed, empty slots zeroed, far_count exact."""
    rj, rt = _replays(4, *size)
    empty = ~rt.valid_slots()
    want = None if mode == "retraceExplore" else _composition(
        rt, ~empty, mode, True)
    rj = jrb.recompute_returns(rj, GAMMA, LAM, mode)
    rt = trb.recompute_returns(rt, GAMMA, LAM, mode)
    assert_replay_close(rj, rt, fields=("qret", "far_count", "qret_stale"),
                        **TOL)
    assert not rt.qret_tm[:, empty].any()
    if want is not None:
        assert torch.equal(rt.qret_tm, want)
