"""Port parity: frame stacking (appended past observations) on a uint8
replay, in the gather, while acting and in evaluation.

A uint8 replay of 6x6 images with episodes of 1..10 steps (shorter than
the window of 1 + 3 appended frames, so the clamp at the episode start
works) is committed by the JAX package and carried into the port.
`stacked_states` and the union-window `gather_minibatch` are compared
with the JAX functions at pinned (ep, t) covering t = 0, t below the
window, t + 1 == length and t + 1 == max_len. Standardization is
(uint8 -> f32 - mean) * scale with the same f32 operands in both: exact.
The acting input over episode starts is held through the collectors of
both packages on a deterministic image env whose value head is a fixed
projection of the stacked input: the committed `value` field then shows
any frame out of place (rtol 1e-5 / atol 1e-5: a 144-term f32 dot
product of pixel values up to 200, summed in another order). evaluate()'s
history is held by the returns of the deterministic policy with the same
parameters in both Trainers: exact (rewards are 0 or 1 and follow the
chosen option).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos import base as jbase
from smarties_tpu.core.mdp import MDPSpec as JMDP
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.replay import collector as jcol
from smarties_tpu.runtime.trainer import Trainer as JTrainer
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos import base as tbase
from smarties_tpu_torch.core.mdp import MDPSpec as TMDP
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.replay import buffer as trb
from smarties_tpu_torch.replay import collector as tcol
from smarties_tpu_torch.runtime.trainer import Trainer as TTrainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, jax_replay_views, np32, tn,
                           tt)

E, L, DS, K = 12, 10, 36, 3


def _replay():
    """(JAX replay, port replay): uint8 states, lengths 1..L, non-trivial
    state statistics."""
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = np.asarray([1, 2, 3, L, L, 4, 7, 1, 5, L, 2, 6], np.int32)
    rho = np.zeros((V, L1), np.float32)
    rew = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rho[v, :n] = 1.0
        rew[v, 1:n + 1] = rng.randn(n)
    p = np32(0.2 + rng.rand(V, L1, 3))
    rs = jrb.init_replay(E, L, DS, 1, 3, 4.0, state_dtype=jnp.uint8)
    rs = jrb.commit_episodes(
        rs, jnp.asarray(rng.randint(0, 256, (V, L1, DS)).astype(np.uint8)),
        jnp.asarray(np32(rng.randint(0, 3, (V, L1, 1)))),
        jnp.asarray(p / p.sum(-1, keepdims=True)), jnp.asarray(rew),
        jnp.asarray(np32(rng.randn(V, L1))), jnp.zeros((V, L1)),
        jnp.asarray(np32(rng.randn(V, L1))), jnp.asarray(rho),
        jnp.asarray(lens), jnp.asarray(rng.rand(V) > 0.5),
        jnp.ones(V, bool), 10 ** 6, "oldest")
    rs = rs._replace(state_mean=jnp.asarray(np32(rng.rand(DS) * 100)),
                     state_scale=jnp.asarray(np32(0.01 + rng.rand(DS) * .02)),
                     rew_mean=jnp.float32(0.1), rew_scale=jnp.float32(1.3))
    return rs, convert.replay_from_jax(jax_replay_views(rs))


def _pinned(rs):
    """Every (ep, t) of the stored steps: t = 0, inside the window, at
    t + 1 == length and at t + 1 == max_len all occur."""
    lens = np.asarray(rs.length)
    pairs = [(e, t) for e in range(E) for t in range(lens[e])]
    ep, t = (np.asarray(x, np.int32) for x in zip(*pairs))
    return ep, t


def test_uint8_replay_round_trip():
    rj, rt = _replay()
    assert rt.states_tm.dtype == torch.uint8
    assert rt.states_tm.shape == (L + 1, E, DS)
    assert_replay_close(rj, rt, rtol=0, atol=0)
    assert convert.replay_to_numpy(rt)["states"].dtype == np.uint8


@pytest.mark.parametrize("k", [0, 1, K])
def test_stacked_states(k):
    rj, rt = _replay()
    ep, t = _pinned(rj)
    want = jbase.stacked_states(rj, jnp.asarray(ep), jnp.asarray(t), k)
    got = tbase.stacked_states(rt, tt(ep, torch.int32), tt(t, torch.int32),
                               k)
    assert got.dtype == torch.float32 and got.shape == (len(ep),
                                                        (k + 1) * DS)
    np.testing.assert_array_equal(tn(got), np.asarray(want))
    # frame j of the stack is the observation at max(t - j, 0)
    raw = (np.asarray(rj.states).astype(np.float32)
           - np.asarray(rj.state_mean)) * np.asarray(rj.state_scale)
    for j in range(k + 1):
        np.testing.assert_array_equal(
            tn(got)[:, j * DS:(j + 1) * DS],
            raw[ep, np.maximum(t - j, 0)])


@pytest.mark.parametrize("k", [0, 1, K])
def test_gather_minibatch_union_window(k):
    rj, rt = _replay()
    ep, t = _pinned(rj)
    jm = jbase.gather_minibatch(rj, jnp.asarray(ep), jnp.asarray(t),
                                n_appended=k)
    tep, ttt = tt(ep, torch.int32), tt(t, torch.int32)
    tm = tbase.gather_minibatch(rt, tep, ttt, n_appended=k)
    for f in ("s_t", "s_t1", "action", "mu", "qret", "reward_next",
              "terminal_next", "truncated_next", "per_w", "valid",
              "rho_old", "value_old"):
        np.testing.assert_array_equal(tn(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.s_t.shape == (len(ep), (k + 1) * DS)
    assert bool(tm.truncated_next.any()) and bool(tm.terminal_next.any())
    # s_t1 is the stack at t + 1 (the stored final state when t + 1 == T)
    t1 = torch.clamp(ttt + 1, max=L)
    assert torch.equal(tm.s_t1, tbase.stacked_states(rt, tep, t1, k))
    assert torch.equal(tm.s_t, tbase.stacked_states(rt, tep, ttt, k))


# ---------------------------------------------------------------------
# a deterministic image env, written once per framework

W = 6


class _State(NamedTuple):
    lane: object
    step: object


def _pixels(xp, lane, step):
    px = xp.arange(W * W)[None, :]
    return ((lane[:, None] * 7 + step[:, None] * 3 + px) % 5) * 50


def _make_env(xp, mdp_cls):
    """xp: jnp or torch. Lane v runs episodes of 4 + v % 3 steps, even
    lanes end in a terminal state; reward 1 when the option equals
    step % 2; reset restarts the lane's own sequence."""
    is_jax = xp is jnp
    i32 = jnp.int32 if is_jax else torch.int32
    f32 = jnp.float32 if is_jax else torch.float32

    def cast(x, dt):
        return x.astype(dt) if is_jax else x.to(dt)

    class env:
        MDP = mdp_cls(dim_state=W * W, dim_action=1, discrete_values=(2,),
                      n_appended_obs=K,
                      conv_layers=((W, W, K + 1, 3, 3, 1),))
        MAX_STEPS = 8

        @staticmethod
        def init(key, n, device=None):
            lane = cast(xp.arange(n), i32)
            return _State(lane=lane, step=xp.zeros_like(lane))

        @staticmethod
        def observe(st):
            return cast(_pixels(xp, st.lane, st.step), f32)

        @staticmethod
        def step(st, env_act):
            a = cast(env_act[..., 0], i32)
            reward = cast(a == st.step % 2, f32)
            nstep = st.step + 1
            done = nstep >= 4 + st.lane % 3
            return (_State(st.lane, nstep), reward, done,
                    done & (st.lane % 2 == 0))

        @staticmethod
        def reset_where(st, mask, key):
            return _State(st.lane, xp.where(mask, xp.zeros_like(st.step),
                                            st.step))

    return env


JENV, TENV = _make_env(jnp, JMDP), _make_env(torch, TMDP)


def test_collector_acting_input_over_episode_starts():
    """Both collectors step 8 lanes 20 times (3-4 episodes per lane) with
    an act function whose value is a fixed projection of the stacked,
    standardized input; states, lengths and the committed values agree."""
    V, n_slots, max_len, n_steps = 8, 64, 8, 20
    rng = np.random.RandomState(4)
    w = np32(rng.randn((K + 1) * W * W) * 0.01)
    mean = np32(rng.rand(W * W) * 100)
    scale = np32(0.01 + rng.rand(W * W) * 0.02)
    probs = np32([[0.25, 0.75]])

    def jact(params, obs_std, key, rnn):
        n = obs_std.shape[0]
        val = obs_std @ jnp.asarray(w)
        act = (jnp.floor(val * 10) % 2).astype(jnp.float32)[:, None]
        return act, jnp.tile(jnp.asarray(probs), (n, 1)), val, 0.5 * val, rnn

    def tact(params, obs_std, gen, rnn):
        n = obs_std.shape[0]
        val = obs_std @ tt(w)
        act = (torch.floor(val * 10) % 2)[:, None]
        return act, tt(probs).repeat(n, 1), val, 0.5 * val, rnn

    jr = jrb.init_replay(n_slots, max_len, W * W, 1, 2, 4.0,
                         state_dtype=jnp.uint8)._replace(
        state_mean=jnp.asarray(mean), state_scale=jnp.asarray(scale))
    jip = jcol.init_inprogress(V, max_len, W * W, 1, 2,
                               state_dtype=jnp.uint8)
    jroll = jcol.make_rollout_chunk(JENV, JENV.MDP, jact, 10 ** 6, 0.99,
                                    0.95, "none")
    jcarry, jlogs = jroll(None, jcol.RolloutCarry(
        jr, jip, JENV.init(None, V), jax.random.PRNGKey(0), ()), n_steps)

    tr = trb.init_replay(n_slots, max_len, W * W, 1, 2, 4.0,
                         state_dtype=torch.uint8)
    tr.state_mean, tr.state_scale = tt(mean), tt(scale)
    tip = tcol.init_inprogress(V, max_len, W * W, 1, 2,
                               state_dtype=torch.uint8)
    assert tip.states.dtype == torch.uint8
    troll = tcol.make_rollout_chunk(TENV, TENV.MDP, tact, 10 ** 6)
    tcarry, tlogs = troll(None, tcol.RolloutCarry(
        tr, tip, TENV.init(None, V), tcol.RolloutGens(None, None), ()),
        n_steps)

    assert int(tcarry.replay.n_stored_eps()) >= 3 * V
    for got, want in zip(tlogs, jlogs[:3]):
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-6)
    assert_replay_close(jcarry.replay, tcarry.replay, rtol=0, atol=0,
                        fields=("states", "actions", "length", "ep_id",
                                "terminal", "rewards"))
    assert_replay_close(jcarry.replay, tcarry.replay, rtol=1e-5, atol=1e-5,
                        fields=("value", "advantage"))
    # the in-progress episodes too (uint8 frames and the lane cursors)
    np.testing.assert_array_equal(
        tn(tcarry.inprog.states.transpose(0, 1)),
        np.asarray(jcarry.inprog.states))
    np.testing.assert_array_equal(tn(tcarry.inprog.t),
                                  np.asarray(jcarry.inprog.t))


@pytest.mark.parametrize("learner", ["RACER", "DQN"])
def test_evaluate_history(learner):
    """The deterministic policy sees [obs_t, obs_t-1, ...] tiled from the
    first observation: same parameters, same returns."""
    d = dict(learner=learner, nnLayerSizes=[8], batchSize=8,
             minTotObsNum=32, maxTotObsNum=256, randSeed=1)
    size = dict(n_envs=4, n_slots=32, max_len=8)
    jt = JTrainer(JENV, JENV.MDP, JHP(**d), state_dtype=jnp.uint8, **size)
    tr = TTrainer(TENV, TENV.MDP, THP(**d), device="cpu",
                  state_dtype=torch.uint8, **size)
    tr.params = convert.params_from_jax(jax.device_get(jt.params))
    assert tr.replay.states_tm.dtype == torch.uint8
    assert tr.carry.inprog.states.dtype == torch.uint8
    want = jt.evaluate(6, max_steps=6)
    got = tr.evaluate(6, max_steps=6)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 6 * 6     # the policy is neither always right
