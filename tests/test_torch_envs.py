"""Port parity: the discrete and the no-velocity (pomdp) cart-pole,
pendulum, acrobot, mountain-car and the pixel env catch (at the end of
the file: integer dynamics and pixels in {0, 255}, held exactly).

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


# ---------------------------------------------------------------------
# catch: the 84x84 pixel env of the conv path. Integer dynamics and
# pixels in {0, 255}: everything is exact.

def _catch_mods():
    from smarties_tpu.envs import catch as jcatch
    from smarties_tpu_torch.envs import catch as tcatch
    return jcatch, tcatch


def _catch_cols(rng, n, tcatch):
    return np.stack([rng.randint(0, tcatch.W - tcatch.BALL + 1, n),
                     rng.randint(0, tcatch.W - tcatch.PADDLE + 1, n)],
                    -1).astype(np.int32)


def _jax_catch_state(jcatch, cols, like=None, mask=None):
    """A JAX CatchState from pinned spawn columns (reset_where's masking
    when `like` and `mask` are given)."""
    z = jnp.zeros((len(cols),), jnp.int32)
    new = jcatch.CatchState(ball_col=jnp.asarray(cols[:, 0]), ball_row=z,
                            paddle_col=jnp.asarray(cols[:, 1]), step=z)
    if like is None:
        return new
    m = jnp.asarray(mask)
    return jcatch.CatchState(*(jnp.where(m, a, b)
                               for a, b in zip(new, like)))


def test_catch_constants_and_mdp():
    jcatch, tcatch = _catch_mods()
    for k in ("H", "W", "BALL", "PADDLE", "PADDLE_H", "FALL", "MOVE",
              "MAX_STEPS", "CONV_STACK"):
        assert getattr(tcatch, k) == getattr(jcatch, k), k
    jm_, tm_ = jcatch.MDP, tcatch.MDP
    for k in ("dim_state", "dim_action", "discrete_values", "n_appended_obs",
              "conv_layers", "dim_net_input", "dim_policy",
              "max_action_label", "dim_state_observed"):
        assert getattr(tm_, k) == getattr(jm_, k), k
    assert tm_.dim_net_input == 4 * 84 * 84 and tm_.max_action_label == 3
    # the label codec at discrete_values=(3,)
    lab = np.arange(3, dtype=np.int32)
    comps = tm_.label_to_components(tt(lab, torch.int32))
    np.testing.assert_array_equal(
        tn(comps), np.asarray(jm_.label_to_components(jnp.asarray(lab))))
    np.testing.assert_array_equal(tn(tm_.components_to_label(comps)), lab)
    x = np32(np.random.RandomState(0).rand(2, 84 * 84))
    np.testing.assert_array_equal(tn(tm_.observed(tt(x))),
                                  np.asarray(jm_.observed(jnp.asarray(x))))


def test_catch_whole_episodes_with_pinned_spawns():
    """Two and a half episodes at 16 lanes under random actions: pixels,
    rewards, done and terminal flags and the state fields equal the JAX
    env's at every step, resets included."""
    jcatch, tcatch = _catch_mods()
    rng = np.random.RandomState(0)
    n = 16
    cols = _catch_cols(rng, n, tcatch)
    js = _jax_catch_state(jcatch, cols)
    ts = tcatch.init(None, n, cols=tt(cols, torch.int32))
    n_done = 0
    for _ in range(int(2.5 * tcatch.MAX_STEPS)):
        jo, to = jcatch.observe(js), tcatch.observe(ts)
        assert to.dtype == torch.float32 and to.shape == (n, 84 * 84)
        np.testing.assert_array_equal(tn(to), np.asarray(jo))
        assert set(np.unique(tn(to))) <= {0.0, 255.0}
        a = rng.randint(0, 3, (n, 1)).astype(np.float32)
        js, jr, jd, jt = jcatch.step(js, jnp.asarray(a))
        ts, tr_, td, tterm = tcatch.step(ts, tt(a))
        np.testing.assert_array_equal(tn(tr_), np.asarray(jr))
        np.testing.assert_array_equal(tn(td), np.asarray(jd))
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        for f in jcatch.CatchState._fields:
            np.testing.assert_array_equal(tn(getattr(ts, f)),
                                          np.asarray(getattr(js, f)), f)
        n_done += int(tn(td).sum())
        cols = _catch_cols(rng, n, tcatch)
        js = _jax_catch_state(jcatch, cols, like=js, mask=np.asarray(jd))
        ts = tcatch.reset_where(ts, td, cols=tt(cols, torch.int32))
    assert n_done == 2 * n
    # episodes last MAX_STEPS steps
    assert int(tn(ts.step).max()) < tcatch.MAX_STEPS


def test_catch_optimal_policy_scores_one():
    """Moving the paddle towards the ball always catches it
    (tests/test_new_envs.py::TestCatch)."""
    _, tcatch = _catch_mods()
    s = tcatch.init(torch.Generator().manual_seed(1), 8)
    ret = np.zeros(8)
    for _ in range(tcatch.MAX_STEPS + 1):
        d = np.sign((tn(s.ball_col) + tcatch.BALL // 2)
                    - (tn(s.paddle_col) + tcatch.PADDLE // 2))
        s, r, done, term = tcatch.step(s, tt((d + 1).reshape(8, 1)))
        ret += tn(r)
        if bool(done.all()):
            break
    assert (ret == 1.0).all() and bool(term.all())


def test_catch_generator_spawns_and_reset_masking():
    _, tcatch = _catch_mods()
    g = torch.Generator().manual_seed(0)
    s = tcatch.init(g, 4096)
    b, p = tn(s.ball_col), tn(s.paddle_col)
    assert b.min() == 0 and b.max() == tcatch.W - tcatch.BALL
    assert p.min() == 0 and p.max() == tcatch.W - tcatch.PADDLE
    assert s.ball_col.dtype == torch.int32 and not tn(s.ball_row).any()
    s2, _, _, _ = tcatch.step(s, torch.ones((4096, 1)))
    mask = torch.arange(4096) % 2 == 0
    s3 = tcatch.reset_where(s2, mask, g)
    assert (tn(s3.step)[::2] == 0).all() and (tn(s3.step)[1::2] == 1).all()
    np.testing.assert_array_equal(tn(s3.ball_col)[1::2], tn(s2.ball_col)[1::2])
    assert (tn(s3.ball_col)[::2] != tn(s2.ball_col)[::2]).any()


def test_catch_small_board():
    """The 20x20 variant: 7-step episodes, the same rules, its own MDP;
    the full board's functions are its functions at another size."""
    _, tcatch = _catch_mods()
    small = tcatch.small
    assert small.MAX_STEPS == 7 and small.MDP.dim_state == 400
    assert small.MDP.dim_net_input == 3 * 400
    assert small.MDP.conv_layers[0][:3] == (20, 20, 3)
    s = small.init(torch.Generator().manual_seed(2), 64)
    assert int(s.ball_col.max()) <= 20 - tcatch.BALL
    assert int(s.paddle_col.max()) <= 20 - tcatch.PADDLE
    ret = np.zeros(64)
    for k in range(small.MAX_STEPS):
        o = small.observe(s)
        assert o.shape == (64, 400)
        # a 4x4 ball and an 8x3 paddle are lit
        assert (tn(o).sum(1) == 255.0 * (16 + 24)).all()
        d = np.sign((tn(s.ball_col) + tcatch.BALL // 2)
                    - (tn(s.paddle_col) + tcatch.PADDLE // 2))
        s, r, done, term = small.step(s, tt((d + 1).reshape(64, 1)))
        ret += tn(r)
        assert bool(done.all()) == (k == small.MAX_STEPS - 1)
    assert (ret == 1.0).all()
    s = small.reset_where(s, done, torch.Generator().manual_seed(3))
    assert not tn(s.step).any() and not tn(s.ball_row).any()
