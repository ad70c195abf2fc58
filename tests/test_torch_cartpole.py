"""Port parity: the vectorized cart-pole env.

The same start states and actions go through smarties_tpu.envs.cartpole
and smarties_tpu_torch.envs.cartpole. One step is an f32 RK4 in the same
operation order in both: agreement to a few ulps, growing slowly over a
rollout; 200 steps stay within rtol 1e-4 / atol 1e-5 on the state.
Rewards, done and terminal flags must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from smarties_tpu.envs import cartpole as jc
from smarties_tpu_torch.envs import cartpole as tc

from _torch_parity import np32, tn, tt

STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _start(seed, n):
    return np32(np.random.RandomState(seed).uniform(-0.05, 0.05, (n, 4)))


def test_mdp_and_constants():
    assert tc.MDP.dim_state_observed == jc.MDP.dim_state_observed == 5
    assert (tc.DT, tc.MAX_STEPS) == (jc.DT, jc.MAX_STEPS)


def test_observe_and_step_once():
    u0 = _start(0, 64)
    js = jc.CartPoleState(u=jnp.asarray(u0), step=jnp.zeros(64, jnp.int32))
    ts = tc.init(None, 64, u_new=tt(u0))
    np.testing.assert_allclose(tn(tc.observe(ts)),
                               np.asarray(jc.observe(js)), rtol=1e-6,
                               atol=1e-7)
    act = np32(np.random.RandomState(1).uniform(-10, 10, (64, 1)))
    js2, jr, jd, jt = jc.step(js, jnp.asarray(act))
    ts2, tr, td, tterm = tc.step(ts, tt(act))
    np.testing.assert_allclose(tn(ts2.u), np.asarray(js2.u), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tn(tr), np.asarray(jr))


def test_200_steps_fixed_actions():
    """200 steps with fixed random forces from a seed, no resets: states,
    step counters and reward/done/terminal streams agree."""
    n = 32
    u0 = _start(2, n)
    acts = np32(np.random.RandomState(3).uniform(-10, 10, (200, n, 1)))
    js = jc.CartPoleState(u=jnp.asarray(u0), step=jnp.zeros(n, jnp.int32))
    ts = tc.init(None, n, u_new=tt(u0))
    for k in range(200):
        js, jr, jd, jt = jc.step(js, jnp.asarray(acts[k]))
        ts, tr, td, tterm = tc.step(ts, tt(acts[k]))
        np.testing.assert_array_equal(tn(tr), np.asarray(jr))
        np.testing.assert_array_equal(tn(td), np.asarray(jd))
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        # compare while the pole is in range: after a failure the free
        # dynamics run away and only the flags matter
        live = ~np.asarray(jc._failed(js.u))
        np.testing.assert_allclose(tn(ts.u)[live], np.asarray(js.u)[live],
                                   err_msg=f"step {k}", **STATE_TOL)
    np.testing.assert_array_equal(tn(ts.step), np.asarray(js.step))


def test_truncation_at_max_steps():
    """A lane at step MAX_STEPS-1 that does not fail ends truncated
    (done, not terminal)."""
    u0 = np.zeros((2, 4), np.float32)
    ts = tc.CartPoleState(u=tt(u0), step=torch.tensor(
        [tc.MAX_STEPS - 1, 0], dtype=torch.int32))
    _, r, d, term = tc.step(ts, torch.zeros(2, 1))
    assert tn(d).tolist() == [True, False]
    assert tn(term).tolist() == [False, False]
    assert tn(r).tolist() == [1.0, 1.0]


def test_reset_where_injected():
    u_old = _start(4, 16)
    u_new = _start(5, 16)
    mask = np.random.RandomState(6).rand(16) > 0.5
    steps = np.arange(16, dtype=np.int32)
    js = jc.CartPoleState(u=jnp.asarray(u_old), step=jnp.asarray(steps))
    # the JAX env draws its own uniforms: apply its masking to ours
    want_u = np.where(mask[:, None], u_new, u_old)
    want_step = np.where(mask, 0, steps)
    ts = tc.reset_where(tc.CartPoleState(u=tt(u_old), step=tt(steps,
                                                               torch.int32)),
                        torch.as_tensor(mask), u_new=tt(u_new))
    np.testing.assert_array_equal(tn(ts.u), want_u)
    np.testing.assert_array_equal(tn(ts.step), want_step)
    jr = jc.reset_where(js, jnp.asarray(mask), jnp.asarray([0, 1], jnp.uint32))
    np.testing.assert_array_equal(np.asarray(jr.u)[~mask], want_u[~mask])
    np.testing.assert_array_equal(np.asarray(jr.step), want_step)


def test_generator_draws_in_range():
    g = torch.Generator().manual_seed(0)
    s = tc.init(g, 256)
    assert s.u.shape == (256, 4) and float(s.u.abs().max()) <= 0.05
    s2 = tc.reset_where(s, torch.ones(256, dtype=torch.bool), g)
    assert not torch.equal(s.u, s2.u) and float(s2.u.abs().max()) <= 0.05


def test_500_steps_1024_lanes():
    """The main path's width over a whole episode's length: 1024 lanes,
    500 steps of fixed random forces, finished lanes reset to start
    states drawn once from a seed and given to both, each side otherwise
    going on from its own state; 8 lanes balanced at rest reach the
    truncation at MAX_STEPS. Flags equal; the state within STATE_TOL
    while its pole is up."""
    n, steps = 1024, tc.MAX_STEPS
    rng = np.random.RandomState(6)
    u0 = _start(7, n)
    acts = np32(rng.uniform(-1, 1, (steps, n, 1)))
    news = np32(rng.uniform(-0.05, 0.05, (steps, n, 4)))
    # 8 lanes rest upright with no force: they run to the truncation
    u0[:8], acts[:, :8], news[:, :8] = 0.0, 0.0, 0.0
    js = jc.CartPoleState(u=jnp.asarray(u0), step=jnp.zeros(n, jnp.int32))
    ts = tc.init(None, n, u_new=tt(u0))
    n_done = n_trunc = 0
    jstep = jax.jit(jc.step)
    for k in range(steps):
        js, jr, jd, jt = jstep(js, jnp.asarray(acts[k]))
        ts, tr, td, tterm = tc.step(ts, tt(acts[k]))
        np.testing.assert_array_equal(tn(td), np.asarray(jd), f"step {k}")
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        np.testing.assert_array_equal(tn(tr), np.asarray(jr))
        live = ~np.asarray(jc._failed(js.u))
        np.testing.assert_allclose(tn(ts.u)[live], np.asarray(js.u)[live],
                                   err_msg=f"step {k}", **STATE_TOL)
        d = np.array(jd)
        n_done += int(d.sum())
        n_trunc += int((d & ~np.asarray(jt)).sum())
        # finished lanes restart from the same start state on both sides;
        # the others go on from each side's own state
        step = np.where(d, 0, np.asarray(js.step)).astype(np.int32)
        js = jc.CartPoleState(
            u=jnp.asarray(np.where(d[:, None], news[k], np.asarray(js.u))),
            step=jnp.asarray(step))
        ts = tc.CartPoleState(
            u=torch.where(torch.as_tensor(d)[:, None], tt(news[k]), ts.u),
            step=torch.as_tensor(step))
    assert n_done > n and n_trunc == 8, (n_done, n_trunc)
