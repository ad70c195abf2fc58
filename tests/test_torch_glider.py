"""Port parity: the glider (smarties_tpu_torch/envs/glider.py against
smarties_tpu/envs/glider.py).

Each env step integrates 100 rk46_nl substeps of 6 stages (600
derivative evaluations), freezing a lane's integration after the
substep in which it touches the ground or leaves the field. The same
states and torques go through both envs:

- one step from 256 states of three kinds: the start draw, states just
  above the ground and falling (most freeze part-way through the step),
  and states already over (frozen from the first substep). done and
  terminal must be equal; states and rewards agree to rtol 1e-5 / atol
  1e-5 (measured: 3.8e-6 on states up to x ~ 200, 7.6e-6 on rewards;
  XLA's and torch's sin / cos / sqrt differ in the last ulp, and 600
  evaluations carry it);
- a short trajectory of 30 steps at 32 lanes from the start draw with
  random torques and pinned resets after 10, 20 or 30 steps: done and
  terminal equal at every step, observations and rewards within rtol
  1e-4 / atol 1e-4 (measured: obs 2.4e-6, rewards 7.6e-6;
  the flow is sensitive, and the difference grows to ~1e-2 by the
  landings near step 100, which the test does not reach);
- the terminal reward at landing and non-landing states: rtol 1e-6 /
  atol 1e-5 (one f32 exp / mod each).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from smarties_tpu.envs import glider as jg
from smarties_tpu_torch.envs import glider as tg

from _torch_parity import np32, tn, tt

N = 256


def _mixed_states(rng, n):
    """[n, 6]: the start draw; a quarter just above the ground, falling;
    an eighth already over (under the ground, or past x = 200)."""
    q = np.zeros((n, 6), np.float32)
    q[:, 0:2] = rng.uniform(-0.1, 0.1, (n, 2))
    q[:, 3] = rng.uniform(-10.0, 10.0, n)
    q[:, 5] = rng.uniform(-np.pi, np.pi, n)
    near = np.arange(n) % 8 < 2
    k = int(near.sum())
    q[near, 0] = rng.uniform(0.0, 0.6, k)
    q[near, 1] = -np.sign(np.cos(q[near, 5])) * rng.uniform(0.6, 1.2, k)
    q[near, 2] = rng.uniform(-0.5, 0.5, k)
    q[near, 4] = rng.uniform(-49.95, -49.7, k)
    over = np.flatnonzero(np.arange(n) % 8 == 2)
    q[over[0::2], 4] = -50.5
    q[over[1::2], 3] = 201.0
    return q


def _u_start(rng, n):
    """The start draw as the port's u_new: u, v, x, a."""
    return np32(np.stack([rng.uniform(-0.1, 0.1, n),
                          rng.uniform(-0.1, 0.1, n),
                          rng.uniform(-10, 10, n),
                          rng.uniform(-np.pi, np.pi, n)], -1))


def _jax_state(q, step):
    return jg.GliderState(q=jnp.asarray(q), step=jnp.asarray(step,
                                                              jnp.int32))


_jstep = jax.jit(jg.step)


def test_constants_and_mdp():
    for k in ("MAX_STEPS", "DT_SUB", "N_SUB", "DT", "CT", "AA", "BB", "MUT",
              "NUT", "CR", "II", "BETA", "FACT1", "FACT2", "FACT3", "GOAL_X",
              "TERM_REW_FAC"):
        assert getattr(tg, k) == getattr(jg, k), k
    np.testing.assert_array_equal(np.asarray(tg.RK_A), jg.RK_A)
    np.testing.assert_array_equal(np.asarray(tg.RK_B), jg.RK_B)
    for k in ("dim_state", "dim_action", "bounded", "upper_action",
              "lower_action", "observable", "dim_state_observed"):
        assert getattr(tg.MDP, k) == getattr(jg.MDP, k), k


def test_one_step_with_mid_step_freezes():
    rng = np.random.RandomState(0)
    q = _mixed_states(rng, N)
    step = rng.randint(0, jg.MAX_STEPS, N).astype(np.int32)
    step[:4] = jg.MAX_STEPS - 1            # the step limit too
    act = np32(rng.uniform(-1, 1, (N, 1)))
    js, jr, jd, jt = _jstep(_jax_state(q, step), jnp.asarray(act))
    ts, tr_, td, tterm = tg.step(
        tg.GliderState(q=tt(q), step=tt(step, torch.int32)), tt(act))
    np.testing.assert_array_equal(tn(td), np.asarray(jd))
    np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
    np.testing.assert_array_equal(tn(ts.step), np.asarray(js.step))
    np.testing.assert_allclose(tn(ts.q), np.asarray(js.q), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tn(tr_), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)
    done = tn(td)
    start_over = tn(tg._is_over_space(tt(q)))
    near = np.arange(N) % 8 < 2
    # most near-ground lanes froze part-way through the step; the lanes
    # over from the start did not move
    assert (done & near & ~start_over).sum() > near.sum() // 2
    assert start_over.sum() == N // 8 and done[start_over].all()
    np.testing.assert_array_equal(tn(ts.q)[start_over], q[start_over])
    assert done[:4].all()


def test_short_trajectory_with_pinned_resets():
    rng = np.random.RandomState(1)
    n, steps = 32, 30
    u0 = _u_start(rng, n)
    ts = tg.init(None, n, u_new=tt(u0))
    js = _jax_state(tn(ts.q), np.zeros(n, np.int32))
    for k in range(steps):
        np.testing.assert_allclose(tn(tg.observe(ts)),
                                   np.asarray(jg.observe(js)), rtol=1e-4,
                                   atol=1e-4, err_msg=f"obs at step {k}")
        act = np32(rng.uniform(-1, 1, (n, 1)))
        js, jr, jd, jt = _jstep(js, jnp.asarray(act))
        ts, tr_, td, tterm = tg.step(ts, tt(act))
        np.testing.assert_array_equal(tn(td), np.asarray(jd))
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        np.testing.assert_allclose(tn(tr_), np.asarray(jr), rtol=1e-4,
                                   atol=1e-4, err_msg=f"reward at {k}")
        # pinned resets: a lane's episode lasts 10, 20 or 30 steps
        mask = np.asarray(js.step) == 10 * (1 + np.arange(n) % 3)
        u_new = _u_start(rng, n)
        ts = tg.reset_where(ts, tt(mask, torch.bool), u_new=tt(u_new))
        fresh = tn(tg.init(None, n, u_new=tt(u_new)).q)
        js = _jax_state(np.where(mask[:, None], fresh, np.asarray(js.q)),
                        np.where(mask, 0, np.asarray(js.step)))
        np.testing.assert_array_equal(tn(ts.step), np.asarray(js.step))


def test_terminal_reward_landing_and_not():
    rng = np.random.RandomState(2)
    n = 64
    q = np.zeros((n, 6), np.float32)
    q[:, 4] = -50.0
    # landings within 5 of the goal, some at angles near pi/4 (a bump),
    # some with a multiple of 2 pi added; then misses
    q[:32, 3] = 100.0 + rng.uniform(-5, 5, 32)
    q[:32, 5] = (0.25 * np.pi + rng.uniform(-0.9, 0.9, 32)
                 + 2 * np.pi * rng.randint(-2, 3, 32))
    q[32:, 3] = rng.choice([-60.0, 20.0, 94.0, 106.0, 250.0], 32)
    q[32:, 5] = rng.uniform(-np.pi, np.pi, 32)
    want = np.asarray(jg._terminal_reward(jnp.asarray(q)))
    got = tn(tg._terminal_reward(tt(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # a bump only where it landed near the goal
    dist = np.abs(q[:, 3] - 100.0)
    np.testing.assert_allclose(got[dist > 5], -dist[dist > 5], rtol=1e-6)
    assert (got[:32] > -dist[:32]).any()


def test_reset_masking_and_generator():
    rng = np.random.RandomState(3)
    n = 16
    q = _mixed_states(rng, n)
    st = tg.GliderState(q=tt(q), step=torch.full((n,), 5, dtype=torch.int32))
    mask = torch.arange(n) % 2 == 0
    gen = torch.Generator().manual_seed(0)
    st2 = tg.reset_where(st, mask, gen)
    np.testing.assert_array_equal(tn(st2.q)[1::2], q[1::2])
    assert (tn(st2.step)[::2] == 0).all() and (tn(st2.step)[1::2] == 5).all()
    fresh = tn(st2.q)[::2]
    assert (fresh[:, [2, 4]] == 0).all()
    # the start draw's ranges, as the JAX init's
    big = tn(tg.init(gen, 4096).q)
    jbig = np.asarray(jg.init(jax.random.PRNGKey(0), 4096).q)
    np.testing.assert_allclose(big.min(0), jbig.min(0), atol=0.05)
    np.testing.assert_allclose(big.max(0), jbig.max(0), atol=0.05)
