"""Port parity: the discrete and the no-velocity (pomdp) cart-pole,
pendulum, acrobot and mountain-car.

The same start states and action sequences (from a seed) go through the
JAX envs and the port's for 200 steps at 32 lanes. Lanes that finish
are reset with the same pinned draw in both (the port through
reset_where(u_new=...), the JAX state through the masking of its own
reset_where); the JAX reset_where's masking is checked on its own.

Tolerances: one step is f32 arithmetic in the same order, but XLA's and
torch's sin/cos differ in the last ulp, and that grows over 200 steps of
the pendulum and acrobot dynamics to ~1e-4 (measured 6e-5 / 7.5e-5):
observations and rewards rtol 1e-4 / atol 5e-4. The observation (cos,
sin of the angles) is compared rather than the wrapped angles
themselves. Done and terminal flags and step counters must match
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.envs import acrobot as ja
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.envs import mountaincar as jm
from smarties_tpu.envs import pendulum as jp
from smarties_tpu_torch.envs import acrobot as ta
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.envs import mountaincar as tm
from smarties_tpu_torch.envs import pendulum as tp

from _torch_parity import np32, tn, tt

N, STEPS = 32, 200
TOL = dict(rtol=1e-4, atol=5e-4)


def _u_cartpole(rng, n):
    return np32(rng.uniform(-0.05, 0.05, (n, 4)))


def _u_acrobot(rng, n):
    return np32(rng.uniform(-0.1, 0.1, (n, 4)))


def _u_pendulum(rng, n):
    return np32(np.stack([rng.uniform(-np.pi, np.pi, n),
                          rng.uniform(-1, 1, n)], -1))


def _u_mountaincar(rng, n):
    return np32(np.stack([rng.uniform(-0.6, -0.4, n), np.zeros(n)], -1))


def _jax_set_u(js, mask, u):
    """The JAX state with lanes `mask` set to u (reset_where's masking
    with a pinned draw)."""
    m = jnp.asarray(mask)
    step = jnp.where(m, 0, js.step)
    if hasattr(js, "th"):
        return js._replace(th=jnp.where(m, u[:, 0], js.th),
                           thdot=jnp.where(m, u[:, 1], js.thdot), step=step)
    return js._replace(u=jnp.where(m[:, None], jnp.asarray(u), js.u),
                       step=step)


# name: (JAX module, port module, start/reset draw, action draw)
ENVS = {
    "cartpole_pomdp": (
        jc.pomdp, tc.pomdp, _u_cartpole,
        lambda rng: np32(rng.uniform(-10, 10, (STEPS, N, 1)))),
    "cartpole_discrete": (
        jc.discrete, tc.discrete, _u_cartpole,
        lambda rng: np32(rng.randint(0, 2, (STEPS, N, 1)))),
    "pendulum": (
        jp, tp, _u_pendulum,
        lambda rng: np32(rng.uniform(-2.5, 2.5, (STEPS, N, 1)))),
    "acrobot": (
        ja, ta, _u_acrobot,
        lambda rng: np32(rng.randint(0, 3, (STEPS, N, 1)))),
    "mountaincar": (
        jm, tm, _u_mountaincar,
        lambda rng: np32(rng.uniform(-1.2, 1.2, (STEPS, N, 1)))),
}


def _fields(state):
    """[n, d] numpy view of an env state's float fields."""
    if hasattr(state, "th"):
        return np.stack([np.asarray(tn(x) if isinstance(x, torch.Tensor)
                                    else x) for x in (state.th, state.thdot)],
                        -1)
    return tn(state.u) if isinstance(state.u, torch.Tensor) \
        else np.asarray(state.u)


def _jax_init(jmod, u):
    js = jmod.init(jnp.asarray([0, 0], jnp.uint32), N)
    return _jax_set_u(js, np.ones(N, bool), u)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_200_steps_with_pinned_resets(name):
    jmod, tmod, draw, actions = ENVS[name]
    rng = np.random.RandomState(sorted(ENVS).index(name))
    for k in ("dim_state", "dim_action", "bounded", "upper_action",
              "lower_action", "discrete_values", "observable"):
        assert getattr(tmod.MDP, k) == getattr(jmod.MDP, k), k
    assert tmod.MAX_STEPS == jmod.MAX_STEPS
    u0 = draw(rng, N)
    acts = actions(rng)
    js = _jax_init(jmod, u0)
    ts = tmod.init(None, N, u_new=tt(u0))
    n_done = 0
    for k in range(STEPS):
        np.testing.assert_allclose(tn(tmod.observe(ts)),
                                   np.asarray(jmod.observe(js)),
                                   err_msg=f"obs at step {k}", **TOL)
        seen = tmod.MDP.observed(tmod.observe(ts))
        assert seen.shape == (N, tmod.MDP.dim_state_observed)
        np.testing.assert_allclose(
            tn(seen), np.asarray(jmod.MDP.observed(jmod.observe(js))),
            err_msg=f"observed dims at step {k}", **TOL)
        js, jr, jd, jt = jmod.step(js, jnp.asarray(acts[k]))
        ts, tr, td, tterm = tmod.step(ts, tt(acts[k]))
        np.testing.assert_allclose(tn(tr), np.asarray(jr),
                                   err_msg=f"reward at step {k}", **TOL)
        np.testing.assert_array_equal(tn(td), np.asarray(jd))
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        np.testing.assert_array_equal(tn(ts.step), np.asarray(js.step))
        done = np.asarray(jd)
        n_done += int(done.sum())
        u_new = draw(rng, N)
        js = _jax_set_u(js, done, u_new)
        ts = tmod.reset_where(ts, tt(done, torch.bool), u_new=tt(u_new))
    if name.startswith("cartpole"):
        assert n_done > 0      # the resets ran
    if name == "cartpole_pomdp":
        # only x, cos(angle) and sin(angle) are observable
        assert tmod.MDP.dim_state_observed == 3
        np.testing.assert_array_equal(
            tn(tmod.MDP.observed(tmod.observe(ts))),
            tn(tmod.observe(ts))[:, [0, 4, 5]])


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_masking_and_generator(name):
    """The port's reset_where changes only the masked lanes, as the JAX
    one does, and its generator draws lie in the JAX draw's range."""
    jmod, tmod, draw, _ = ENVS[name]
    rng = np.random.RandomState(7)
    u_old = draw(rng, N)
    mask = rng.rand(N) > 0.5
    js = _jax_set_u(_jax_init(jmod, u_old), ~mask, u_old)
    jr = jmod.reset_where(js, jnp.asarray(mask),
                          jnp.asarray([0, 1], jnp.uint32))
    gen = torch.Generator().manual_seed(0)
    ts = tmod.reset_where(tmod.init(None, N, u_new=tt(u_old)),
                          tt(mask, torch.bool), gen)
    np.testing.assert_array_equal(_fields(ts)[~mask], _fields(jr)[~mask])
    assert not np.isclose(_fields(ts)[mask], u_old[mask]).all(axis=-1).any()
    np.testing.assert_array_equal(tn(ts.step), np.asarray(jr.step))
    # fresh draws: within the bounds of the JAX init's draws
    big = 4096
    jo = np.asarray(jmod.observe(jmod.init(jnp.asarray([0, 3], jnp.uint32),
                                           big)))
    to = tn(tmod.observe(tmod.init(gen, big)))
    assert (to.min(0) >= jo.min(0) - 0.05).all()
    assert (to.max(0) <= jo.max(0) + 0.05).all()
