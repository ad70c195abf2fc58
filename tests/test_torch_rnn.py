"""Port parity: the recurrent nets and the truncated-BPTT machinery.

The JAX package initialises the parameters (smarties_tpu.models.net.
init_params); they cross into the port through models/convert.py, and
the same numpy inputs go through both:

- `apply_net` with a carry and `apply_net_seq` for RNN, LSTM and GRU
  stacks of 1 and 2 layers, with and without the param head; `init_carry`;
  `residual` and `join`; the round trip of every leaf. Outputs and
  carries agree at rtol 1e-5 / atol 1e-6 (a sequence of 6 steps of 24-wide
  f32 matmuls in another summation order);
- the port's own init: leaf names, shapes, init ranges, forget bias 1;
- `bptt_window` over a replay with samples at t = 0, t < W and
  t = length - 1 (exact: a gather and the same f32 standardisation);
- `seq_outputs` and `seq_forward_vjp`: the outputs at t and t+1 (rtol
  1e-5 / atol 1e-6) and the parameter gradient pulled back from a
  cotangent at t (rtol 1e-4 / atol 1e-6: it sums 8 window steps), with
  the carry held where the window starts before the episode;
- a Trainer with an LSTM net: evaluate threads the carry (its returns
  equal a hand-rolled loop that threads it, and differ from one that
  does not), and save / restore keeps the nested (h, c) carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos import base as jbase
from smarties_tpu.models import net as jnet
from smarties_tpu.replay import buffer as jrb
from smarties_tpu_torch.algos import base as tbase
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_tree_close, jax_replay_views, np32, tn,
                           tt)

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
KINDS = ("RNN", "LSTM", "GRU")


def _specs(kind, hidden, n_param):
    kw = dict(n_in=5, hidden=hidden, n_out=3, kind=kind,
              n_param_out=n_param, param_init=(0.3,) * n_param)
    return jnet.NetSpec(**kw), tnet.NetSpec(**kw)


def _params(jspec, seed=0):
    """JAX-initialised params with the biases moved off zero."""
    p = jax.device_get(jnet.init_params(jax.random.PRNGKey(seed), jspec))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np32(x + 0.1 * rng.randn(*x.shape)) if x.ndim == 1 else x,
        p)


def _rand_carry(jspec, n, rng):
    return jax.tree_util.tree_map(
        lambda x: np32(rng.randn(*x.shape) * 0.5),
        jax.device_get(jnet.init_carry(jspec, (n,))))


@pytest.mark.parametrize("n_param", [0, 2])
@pytest.mark.parametrize("hidden", [(24,), (16, 24)])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_net_and_seq(kind, hidden, n_param):
    jspec, tspec = _specs(kind, hidden, n_param)
    assert tspec.is_recurrent and tspec.total_out == jspec.total_out
    p = _params(jspec)
    tp = convert.params_from_jax(p)
    assert_tree_close(tp, convert.params_to_jax(tp), rtol=0, atol=0)
    assert_tree_close(tp, p, rtol=0, atol=0)
    rng = np.random.RandomState(1)
    n, T = 7, 6
    carry = _rand_carry(jspec, n, rng)
    x = np32(rng.randn(n, 5))
    jy, jc = jnet.apply_net(p, jspec, jnp.asarray(x),
                            jax.tree_util.tree_map(jnp.asarray, carry))
    ty, tcar = tnet.apply_net(tp, tspec, tt(x),
                              convert.carry_from_numpy(carry))
    np.testing.assert_allclose(tn(ty), np.asarray(jy), **OUT_TOL)
    assert_tree_close(tcar, jax.device_get(jc), **OUT_TOL)

    xs = np32(rng.randn(T, n, 5))
    jys, jfin = jnet.apply_net_seq(p, jspec, jnp.asarray(xs),
                                   jnet.init_carry(jspec, (n,)))
    zero = tnet.init_carry(tspec, (n,))
    assert_tree_close(zero, jax.device_get(jnet.init_carry(jspec, (n,))),
                      rtol=0, atol=0)
    tys, tfin = tnet.apply_net_seq(tp, tspec, tt(xs), zero)
    assert tys.shape == (T, n, tspec.total_out)
    np.testing.assert_allclose(tn(tys), np.asarray(jys), **OUT_TOL)
    assert_tree_close(tfin, jax.device_get(jfin), **OUT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_port_init(kind):
    """The port's own init: the JAX leaf names and shapes, weights inside
    their U(-f, f) range, zero biases but the LSTM forget bias of 1."""
    jspec, tspec = _specs(kind, (16, 24), 2)
    want = jax.device_get(jnet.init_params(jax.random.PRNGKey(0), jspec))
    got = tnet.init_params(torch.Generator().manual_seed(0), tspec)
    shapes = lambda t, f: jax.tree_util.tree_map(f, t)
    assert shapes(convert.params_to_jax(got), np.shape) == shapes(want,
                                                                  np.shape)
    for li, (nin, nout) in enumerate(((5, 16), (16, 24))):
        layer = got["layers"][li]
        for k, w in layer.items():
            if k[0] == "b":
                assert torch.equal(w.detach(), torch.full(
                    (nout,), 1.0 if (kind, k) == ("LSTM", "bf") else 0.0))
                continue
            act = (jspec.act if kind == "RNN"
                   else "Tanh" if k[1] in "ch" else "Sigm")
            fac = float(jnet._INIT_FACTOR[act](nin, nout))
            w = w.detach()
            assert float(w.abs().max()) <= fac
            assert float(w.abs().max()) > 0.8 * fac
            assert all(x.requires_grad for x in layer.values())
    assert tnet.init_carry(tnet.NetSpec(n_in=5, hidden=(8,)), (3,)) == ()


def test_residual_and_join():
    kw = dict(n_in=6, hidden=(6, 6, 8), n_out=2, residual=True)
    jspec, tspec = jnet.NetSpec(**kw), tnet.NetSpec(**kw)
    p = _params(jspec)
    x = np32(np.random.RandomState(2).randn(9, 6))
    jy, _ = jnet.apply_net(p, jspec, jnp.asarray(x))
    ty, tcar = tnet.apply_net(convert.params_from_jax(p), tspec, tt(x))
    assert tcar == ()
    np.testing.assert_allclose(tn(ty), np.asarray(jy), **OUT_TOL)
    plain, _ = jnet.apply_net(p, jnet.NetSpec(**dict(kw, residual=False)),
                              jnp.asarray(x))
    assert np.abs(np.asarray(jy) - np.asarray(plain)).max() > 1e-3
    np.testing.assert_array_equal(
        tn(tnet.join(tt(x), tt(x[:, :2]))),
        np.asarray(jnet.join(jnp.asarray(x), jnp.asarray(x[:, :2]))))
    with pytest.raises(ValueError, match="nnType"):
        tnet.NetSpec(n_in=3, kind="Transformer")


# ---------------- the BPTT window ----------------

E, L, W = 12, 20, 8


def _replay():
    """E slots of synthetic episodes of 2..L steps committed by the JAX
    package, with exact state statistics; its port twin."""
    rng = np.random.RandomState(0)
    L1 = L + 1
    lens = rng.randint(2, L + 1, E).astype(np.int32)
    lens[:2] = [L, 3]
    rs = jrb.init_replay(E, L, 5, 1, 2, 4.0)
    z = jnp.zeros((E, L1))
    rs = jrb.commit_episodes(
        rs, jnp.asarray(np32(rng.randn(E, L1, 5) + 0.5)),
        jnp.zeros((E, L1, 1)), jnp.ones((E, L1, 2)), z, z, z, z, z,
        jnp.asarray(lens), jnp.zeros(E, bool), jnp.ones(E, bool), 10 ** 6,
        "oldest")
    rs = jrb.update_state_rew_stats(rs, 1.0, b_init=True)
    return rs, convert.replay_from_jax(jax_replay_views(rs)), lens


def _samples(rs, lens):
    """(ep, t) with t = 0, t < W, t >= W and t = length - 1 (so t + 1 is
    the stored terminal row) among them."""
    slot = {int(i): s for s, i in enumerate(np.asarray(rs.ep_id))}
    ep = np.asarray([slot[i] for i in (0, 0, 0, 0, 1, 1, 2, 3, 4)], np.int32)
    n = np.asarray(rs.length)[ep]
    t = np.asarray([0, 3, W + 2, n[0] - 1, 0, n[4] - 1, n[6] - 1, 1,
                    n[8] // 2], np.int32)
    assert (t < n).all() and (t == 0).any() and (t == n - 1).any()
    return ep, t


def test_bptt_window():
    jrs, trs, lens = _replay()
    ep, t = _samples(jrs, lens)
    jx, ja = jbase.bptt_window(jrs, jnp.asarray(ep), jnp.asarray(t), W)
    tx, ta = tbase.bptt_window(trs, tt(ep, torch.int32), tt(t, torch.int32),
                               W)
    assert tx.shape == (len(ep), W + 1, 5) and ta.shape == (len(ep), W + 1)
    np.testing.assert_array_equal(tn(ta), np.asarray(ja))
    np.testing.assert_allclose(tn(tx), np.asarray(jx), rtol=1e-6, atol=1e-7)
    assert not tn(ta)[0, :-2].any() and tn(ta)[0, -2:].all()
    # the last position is the stored row at t + 1, the terminal state's
    # where t + 1 == length
    raw = np.asarray(jrs.states)[ep, t + 1]
    want = (raw - np.asarray(jrs.state_mean)) * np.asarray(jrs.state_scale)
    np.testing.assert_allclose(tn(tx)[:, -1], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_param", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_seq_outputs_and_vjp(kind, n_param):
    jrs, trs, lens = _replay()
    ep, t = _samples(jrs, lens)
    jspec, tspec = _specs(kind, (16, 12), n_param)
    p = _params(jspec, 3)
    tp = convert.params_from_jax(p)
    jx, ja = jbase.bptt_window(jrs, jnp.asarray(ep), jnp.asarray(t), W)
    tx, ta = tbase.bptt_window(trs, tt(ep, torch.int32), tt(t, torch.int32),
                               W)
    j0, j1 = jbase.seq_outputs(p, jspec, jx, ja)
    t0, t1 = tbase.seq_outputs(tp, tspec, tx, ta)
    np.testing.assert_allclose(tn(t0), np.asarray(j0), **OUT_TOL)
    np.testing.assert_allclose(tn(t1), np.asarray(j1), **OUT_TOL)
    assert t0.requires_grad and not t1.requires_grad

    g = np32(np.random.RandomState(4).randn(*j0.shape))
    jo, jn, jpull = jbase.seq_forward_vjp(p, jspec, jx, ja)
    to, tnx, tpull = tbase.seq_forward_vjp(tp, tspec, tx, ta)
    assert not to.requires_grad and not tnx.requires_grad
    np.testing.assert_allclose(tn(to), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(tn(tnx), np.asarray(jn), **OUT_TOL)
    assert_tree_close(tpull(tt(g)), jax.device_get(jpull(jnp.asarray(g))),
                      **GRAD_TOL)

    # the carry is held over the inactive prefix: a window that starts
    # before the episode gives what the episode's own steps give
    first = int(np.nonzero(t == 3)[0][0])
    sx, sa = tx[first:first + 1, -5:], ta[first:first + 1, -5:]
    assert bool(sa.all()) and not bool(ta[first, :-5].any())
    s0, s1 = tbase.seq_outputs(tp, tspec, sx, sa)
    np.testing.assert_allclose(tn(s0), tn(t0[first:first + 1]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tn(s1), tn(t1[first:first + 1]), rtol=1e-6,
                               atol=1e-7)


# ---------------- the trainer with a recurrent learner ----------------

def _lstm_trainer(tmp_path=None, seed=0):
    cfg = THP(learner="VRACER", nnType="LSTM", nnLayerSizes=[8, 8],
              nnBPTTseq=4, batchSize=8, minTotObsNum=64, maxTotObsNum=512,
              randSeed=seed)
    return Trainer(tc.pomdp, tc.pomdp.MDP, cfg, n_envs=4, n_slots=32,
                   max_len=32, device="cpu",
                   run_dir=str(tmp_path) if tmp_path else None)


def _eval_by_hand(tr, n, steps, thread: bool):
    act = tr.algo.make_act_fn(False)
    rs = tr.replay
    es = tc.pomdp.init(tr.gen_env, n, tr.device)
    rets, done = torch.zeros(n), torch.zeros(n, dtype=torch.bool)
    rnn = tr._init_rnn(n)
    for _ in range(steps):
        obs = tr.mdp.observed(tc.pomdp.observe(es))
        a, _, _, _, new = act(tr.params,
                              (obs - rs.state_mean) * rs.state_scale, None,
                              rnn)
        rnn = new if thread else rnn
        es, r, d, _ = tc.pomdp.step(es, tr.mdp.learner_to_env_action(a))
        rets = rets + r * (~done).to(r.dtype)
        done = done | d
    return rets.numpy()


def test_recurrent_trainer_evaluate_and_restore(tmp_path):
    tr = _lstm_trainer(tmp_path)
    assert tr.algo_is_recurrent and not tr.on_policy
    assert tr.mdp.dim_state_observed == 3
    tr.train(12)
    assert tr.n_grad_steps >= 12
    # sharpen the recurrence so that dropping the carry changes actions
    with torch.no_grad():
        for layer in tr.params["layers"]:
            for k in ("Rc", "Ri", "Rf", "Ro"):
                layer[k].mul_(40.0)
        tr.params["out"]["W"].mul_(200.0)
    state = tr.gen_env.get_state()
    got = tr.evaluate(6, max_steps=40)
    tr.gen_env.set_state(state)
    threaded = _eval_by_hand(tr, 6, 40, True)
    tr.gen_env.set_state(state)
    dropped = _eval_by_hand(tr, 6, 40, False)
    np.testing.assert_array_equal(got, threaded)
    assert (got != dropped).any()

    # the acting carry is nested (h, c) pairs and survives a checkpoint
    assert len(tr.carry.rnn) == 2 and len(tr.carry.rnn[0]) == 2
    assert any(bool(x.abs().sum() > 0) for x in tnet.tree_leaves(tr.carry.rnn))
    path = str(tmp_path / "ck.pt")
    tr.save(path)
    fresh = _lstm_trainer(seed=5)
    fresh.restore(path)
    for a, b in zip(tnet.tree_leaves(fresh.carry.rnn),
                    tnet.tree_leaves(tr.carry.rnn), strict=True):
        assert torch.equal(a, b)
    assert isinstance(fresh.carry.rnn[0], tuple)
    for a, b in zip(tnet.tree_leaves(fresh.params),
                    tnet.tree_leaves(tr.params), strict=True):
        assert torch.equal(a, b.detach())
    # both go on identically: one more chunk of steps and rollouts
    for x in (tr, fresh):
        x.train(4)
    for a, b in zip(tnet.tree_leaves(fresh.params),
                    tnet.tree_leaves(tr.params), strict=True):
        assert torch.equal(a, b.detach())
