"""Port parity: the replay buffer, through its field views.

The same episodes, made from a seed with numpy, are committed into the
JAX package's packed replay and the port's per-field time-major replay;
every field view (rewards, actions, mus, qret, rho, kl, delta, value with
the v_trunc substitution, advantage, length, ep_id, terminal, far_count,
qret_stale, v_trunc and the scalars) must agree. Commits and pruning
move values without arithmetic: exact. Return sweeps and statistics run
f32 reductions in another order: rtol 1e-5 / atol 1e-5 (returns 1e-4 as
tests/test_pallas_retrace.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.replay import buffer as jrb
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.replay import buffer as trb

from _torch_parity import (assert_replay_close, jax_replay_views, np32, tn,
                           tt)

E, L, DS, DA, DP = 8, 10, 3, 2, 4
EXACT = dict(rtol=0, atol=0)
STATS = dict(rtol=1e-5, atol=1e-5)
RETURNS = dict(rtol=1e-4, atol=1e-4)


def _batch(seed, done, lengths, terminal):
    """Per-lane episode arrays [V, L+1, ...] as the collector hands them."""
    rng = np.random.RandomState(seed)
    V, L1 = len(done), L + 1
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lengths):
        rew[v, 1:n + 1] = rng.randn(n)
        rho[v, :n] = 1.0
    return dict(states=np32(rng.randn(V, L1, DS)),
                actions=np32(rng.randn(V, L1, DA)),
                mus=np32(rng.randn(V, L1, DP)), rewards=rew,
                value=np32(rng.randn(V, L1)),
                advantage=np32(rng.randn(V, L1) * 0.1),
                qret=np.zeros((V, L1), np.float32), rho=rho,
                length=np.asarray(lengths, np.int32),
                terminal=np.asarray(terminal), done=np.asarray(done))


def _commit_both(rj, rt, b, cap):
    order = ("states", "actions", "mus", "rewards", "value", "advantage",
             "qret", "rho", "length", "terminal", "done")
    rj = jrb.commit_episodes(rj, *(jnp.asarray(b[k]) for k in order), cap,
                             "oldest")
    targs = [tt(b[k]) for k in order[:8]] + [
        tt(b["length"], torch.int32), tt(b["terminal"], torch.bool),
        tt(b["done"], torch.bool)]
    rt = trb.commit_episodes(rt, *targs, cap, "oldest")
    return rj, rt


def _fresh():
    return (jrb.init_replay(E, L, DS, DA, DP, 4.0),
            trb.init_replay(E, L, DS, DA, DP, 4.0))


BATCHES = [
    # several lanes finishing on the same step, one lane not done
    ([True, False, True, True], [5, 7, 3, 9], [False, True, True, False]),
    ([True, True, False, True], [10, 2, 4, 6], [True, False, False, True]),
    ([False, True, True, True], [1, 8, 10, 4], [False, False, True, True]),
]


def _filled(cap):
    rj, rt = _fresh()
    for i, (d, n, term) in enumerate(BATCHES):
        rj, rt = _commit_both(rj, rt, _batch(i, d, n, term), cap)
    return rj, rt


def test_init_replay_matches():
    rj, rt = _fresh()
    assert_replay_close(rj, rt, **EXACT)


@pytest.mark.parametrize("n_batches", [1, 2, 3])
def test_commit_episodes(n_batches):
    """Slot choice (stable sort over the -inf ties of empty slots), ids,
    lengths, v_trunc and every per-step field after 1..3 commits."""
    rj, rt = _fresh()
    for i, (d, n, term) in enumerate(BATCHES[:n_batches]):
        rj, rt = _commit_both(rj, rt, _batch(i, d, n, term), 10 ** 6)
    assert_replay_close(rj, rt, **EXACT)
    np.testing.assert_array_equal(tn(rt.samp_csum),
                                  np.asarray(rj.samp_cl)[:, 0])
    np.testing.assert_array_equal(tn(rt.samp_start),
                                  np.asarray(rj.samp_cl)[:, 1])


def test_prune_to_capacity():
    """Over capacity: the oldest episodes are invalidated first, the
    pruned counter and the sampling cache follow."""
    rj, rt = _filled(cap=20)
    assert int(rt.n_pruned_eps) > 0
    assert_replay_close(rj, rt, **EXACT)
    np.testing.assert_array_equal(tn(rt.samp_csum),
                                  np.asarray(rj.samp_cl)[:, 0])
    rj2 = jrb.prune_to_capacity(rj, 9, "oldest")
    rt2 = trb.prune_to_capacity(rt, 9, "oldest")
    assert_replay_close(rj2, rt2, **EXACT)


def test_clear_all():
    """PPO's epoch-end clear: every slot invalid, the sampling cache
    empty, the counters kept; then commits fill the same slots with the
    same ids in both frameworks and sampling works again."""
    rj, rt = _filled(cap=10 ** 6)
    assert int(rt.n_stored_steps()) > 0
    rj, rt = jrb.clear_all(rj), trb.clear_all(rt)
    assert int(rt.n_stored_steps()) == 0 == int(rt.n_stored_eps())
    assert not bool(rt.valid_slots().any())
    assert int(rt.n_seen_eps) == int(rj.n_seen_eps) > 0
    assert_replay_close(rj, rt, **EXACT)
    np.testing.assert_array_equal(tn(rt.samp_csum), 0)
    np.testing.assert_array_equal(tn(rt.samp_csum),
                                  np.asarray(rj.samp_cl)[:, 0])
    for i, (d, n, term) in enumerate(BATCHES[:2]):
        rj, rt = _commit_both(rj, rt, _batch(7 + i, d, n, term), 10 ** 6)
    assert_replay_close(rj, rt, **EXACT)
    np.testing.assert_array_equal(tn(rt.samp_csum),
                                  np.asarray(rj.samp_cl)[:, 0])
    np.testing.assert_array_equal(tn(rt.samp_start),
                                  np.asarray(rj.samp_cl)[:, 1])
    total = int(rt.n_stored_steps())
    assert total == sum(n for d, ns, _ in BATCHES[:2]
                        for n, dd in zip(ns, d) if dd)
    ep, t = trb.sample_uniform_from_flat(
        rt, torch.arange(total, dtype=torch.int32))
    assert (tn(rt.ep_id)[tn(ep)] >= 0).all()
    assert (tn(t) < tn(rt.length)[tn(ep)]).all()


def test_sample_uniform_on_fixed_draw():
    """(ep, t) of the same flat integer draw: searchsorted side="right"."""
    rj, rt = _filled(cap=10 ** 6)
    key = jax.random.PRNGKey(3)
    ep_j, t_j = jrb.sample_uniform(key, rj, 64)
    flat = jax.random.randint(key, (64,), 0,
                              jnp.maximum(rj.samp_cl[-1, 0], 1))
    ep_t, t_t = trb.sample_uniform_from_flat(rt, tt(flat, torch.int32))
    np.testing.assert_array_equal(tn(ep_t), np.asarray(ep_j))
    np.testing.assert_array_equal(tn(t_t), np.asarray(t_j))
    # every boundary of the cumulative lengths maps to the next episode
    csum = tn(rt.samp_csum)
    ep_b, t_b = trb.sample_uniform_from_flat(
        rt, torch.as_tensor(csum[csum < csum[-1]], dtype=torch.int32))
    assert (tn(t_b) == 0).all()


def test_sample_uniform_draws_valid_transitions():
    rj, rt = _filled(cap=10 ** 6)
    ep, t = trb.sample_uniform(torch.Generator().manual_seed(0), rt, 4096)
    assert (tn(rt.ep_id)[tn(ep)] >= 0).all()
    assert (tn(t) < tn(rt.length)[tn(ep)]).all() and (tn(t) >= 0).all()
    counts = np.bincount(tn(ep), minlength=E)
    lens = np.where(tn(rt.ep_id) >= 0, tn(rt.length), 0)
    np.testing.assert_allclose(counts / 4096, lens / lens.sum(), atol=0.03)


def _perturbed(cap=10 ** 6):
    """A filled replay with non-trivial rho/value/advantage, reward stats
    and a partly stale qret, set identically in both frameworks."""
    rj, _ = _filled(cap)
    rng = np.random.RandomState(9)
    rho = np32(np.exp(rng.randn(E, L + 1)))
    rj = rj._replace(rho=jnp.asarray(rho),
                     value=jnp.asarray(np32(rng.randn(E, L + 1))),
                     advantage=jnp.asarray(np32(rng.randn(E, L + 1) * .1)),
                     rew_mean=jnp.float32(0.2), rew_scale=jnp.float32(1.7),
                     max_abs_error=jnp.float32(0.3),
                     qret_stale=jnp.asarray(rng.rand(E) > 0.4),
                     cmax_ret=jnp.float32(2.0), cinv_ret=jnp.float32(0.5),
                     far_count=jnp.asarray(np32(rng.randint(0, 3, E))))
    rj = jrb.rebuild_sample_cache(rj)
    return rj, convert.replay_from_jax(jax_replay_views(rj))


def test_replay_from_jax_round_trip():
    rj, rt = _perturbed()
    assert_replay_close(rj, rt, **EXACT)
    np.testing.assert_array_equal(tn(rt.samp_csum),
                                  np.asarray(rj.samp_cl)[:, 0])


@pytest.mark.parametrize("mode", ["retrace", "GAE"])
def test_refresh_new_returns(mode):
    """Only stale valid slots get new qret (through K1's CPU branch vs the
    Pallas kernel in interpret mode); qret_stale is cleared."""
    rj, rt = _perturbed()
    rj = jrb.refresh_new_returns(rj, 0.995, 0.95, mode)
    rt = trb.refresh_new_returns(rt, 0.995, 0.95, mode)
    assert_replay_close(rj, rt, fields=("qret",), **RETURNS)
    assert not tn(rt.qret_stale).any()


@pytest.mark.parametrize("mode", ["retrace", "GAE", "none"])
def test_recompute_returns(mode):
    """All valid slots recomputed, invalid zeroed, far_count exact."""
    rj, rt = _perturbed(cap=25)
    rj = jrb.recompute_returns(rj, 0.995, 0.95, mode)
    rt = trb.recompute_returns(rt, 0.995, 0.95, mode)
    assert_replay_close(rj, rt, fields=("qret", "far_count", "qret_stale"),
                        **RETURNS)


def test_far_count_and_beta_alpha_and_cmax():
    rj, rt = _perturbed()
    np.testing.assert_array_equal(tn(trb.far_count_exact(rt)),
                                  np.asarray(jrb.far_count_exact(rj)))
    for _ in range(3):
        rj, fj = jrb.update_beta_alpha(rj, 32, 40, 0.1)
        rt, ft = trb.update_beta_alpha(rt, 32, 40, 0.1)
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-6)
    rj = jrb.update_cmax(rj, jnp.float32(1234.0), 4.0, 5e-4)
    rt = trb.update_cmax(rt, torch.tensor(1234.0), 4.0, 5e-4)
    assert_replay_close(rj, rt, fields=("beta", "alpha", "cmax_ret",
                                        "cinv_ret"), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b_init,lr", [(True, 1.0), (False, 0.05)])
def test_update_state_rew_stats(b_init, lr):
    rj, rt = _perturbed(cap=25)
    rj = jrb.update_state_rew_stats(rj, lr, b_init=b_init)
    rt = trb.update_state_rew_stats(rt, lr, b_init=b_init)
    assert_replay_close(rj, rt, fields=("state_mean", "state_std",
                                        "state_scale", "rew_mean", "rew_std",
                                        "rew_scale"), **STATS)
