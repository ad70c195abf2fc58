"""Port parity: the replay buffer, through its field views.

The same episodes, made from a seed with numpy, are committed into the
JAX package's packed replay and the port's per-field time-major replay;
every field view (rewards, actions, mus, qret, rho, kl, delta, value with
the v_trunc substitution, advantage, length, ep_id, terminal, far_count,
qret_stale, v_trunc and the scalars) must agree. Commits and pruning
move values without arithmetic: exact. Return sweeps and statistics run
f32 reductions in another order: rtol 1e-5 / atol 1e-5 (returns 1e-4 as
tests/test_pallas_retrace.py).

A uint8 replay (image observations) goes through the same commits, the
pruning and the statistics; the port reduces the states in chunks of the
time axis, here 3 and 4 rows of 11 (neither divides it), f32 partial
sums added in f64: state_mean / state_std / state_scale keep rtol 1e-5 /
atol 1e-5 against the JAX package's one fused reduction.

The prioritized samplers are held in two parts: each sampler's
probability vector against the JAX formula evaluated on the same replay
(rtol 1e-6 / atol 1e-9: normalised f32 vectors, the sums in another
order; the ranks of PERrank must match exactly, ties in delta included),
and the inverse-CDF draw against numpy's searchsorted on the f64
cumulative sum for the same uniforms (exact). The three filters are held
by the slots that commits overwrite and that pruning invalidates.
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


# ---------------------------------------------------------------------
# uint8 states

def _commit_both_u8(rj, rt, b, cap, filt="oldest"):
    order = ("states", "actions", "mus", "rewards", "value", "advantage",
             "qret", "rho", "length", "terminal", "done")
    rj = jrb.commit_episodes(rj, *(jnp.asarray(b[k]) for k in order), cap,
                             filt)
    targs = [tt(b["states"], torch.uint8)] + [tt(b[k]) for k in order[1:8]] \
        + [tt(b["length"], torch.int32), tt(b["terminal"], torch.bool),
           tt(b["done"], torch.bool)]
    return rj, trb.commit_episodes(rt, *targs, cap, filt)


def _filled_u8(cap):
    rj = jrb.init_replay(E, L, DS, DA, DP, 4.0, state_dtype=jnp.uint8)
    rt = trb.init_replay(E, L, DS, DA, DP, 4.0, state_dtype=torch.uint8)
    for i, (d, n, term) in enumerate(BATCHES):
        b = _batch(i, d, n, term)
        b["states"] = np.random.RandomState(50 + i).randint(
            0, 256, b["states"].shape).astype(np.uint8)
        rj, rt = _commit_both_u8(rj, rt, b, cap)
    return rj, rt


@pytest.mark.parametrize("cap", [10 ** 6, 20])
def test_uint8_commit_and_prune(cap):
    rj, rt = _filled_u8(cap)
    assert rt.states_tm.dtype == torch.uint8
    assert np.asarray(rj.states).dtype == np.uint8
    assert (int(rt.n_pruned_eps) > 0) == (cap == 20)
    assert_replay_close(rj, rt, **EXACT)
    assert tn(rt.states).max() > 200


def _chunk_rows(monkeypatch, rows):
    """Make the statistics pass reduce `rows` time rows at a time."""
    if rows is not None:
        monkeypatch.setattr(trb, "STATS_CHUNK_ELEMS", rows * E * DS)


@pytest.mark.parametrize("chunk_rows", [None, 3, 4])
@pytest.mark.parametrize("b_init,lr", [(True, 1.0), (False, 0.05)])
def test_uint8_chunked_stats(monkeypatch, b_init, lr, chunk_rows):
    rj, rt = _filled_u8(25)
    rj = jrb.update_state_rew_stats(rj, lr, b_init=b_init)
    before = rt.states_tm.clone()
    _chunk_rows(monkeypatch, chunk_rows)
    rt = trb.update_state_rew_stats(rt, lr, b_init=b_init)
    assert torch.equal(rt.states_tm, before)
    assert float(rt.state_mean.abs().max()) > 1.0
    assert_replay_close(rj, rt, fields=("state_mean", "state_std",
                                        "state_scale", "rew_mean", "rew_std",
                                        "rew_scale"), **STATS)


@pytest.mark.parametrize("chunk_rows", [1, 3, 4, 11, 64])
def test_chunked_stats_f32_states(monkeypatch, chunk_rows):
    """The f32 replay: any chunking against the JAX package within the
    tolerance of test_update_state_rew_stats, and the stored states are
    not touched (the chunk is a copy)."""
    rj, rt = _perturbed(cap=25)
    rj = jrb.update_state_rew_stats(rj, 0.05)
    before = rt.states_tm.clone()
    _chunk_rows(monkeypatch, chunk_rows)
    rt = trb.update_state_rew_stats(rt, 0.05)
    assert torch.equal(rt.states_tm, before)
    assert_replay_close(rj, rt, fields=("state_mean", "state_std",
                                        "state_scale"), **STATS)


def test_stats_chunk_budget_bounds_the_temporary(monkeypatch):
    """The default chunk holds at most STATS_CHUNK_ELEMS f32 elements
    (at least one row): the rows per chunk follow the budget."""
    _, rt = _filled_u8(10 ** 6)
    seen = []
    real = torch.Tensor.to

    def spy(self, *a, **kw):
        if self.dtype == torch.uint8 and self.dim() == 3:
            seen.append(self.shape[0])
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    monkeypatch.setattr(trb, "STATS_CHUNK_ELEMS", 2 * E * DS)
    trb.update_state_rew_stats(rt, 1.0, b_init=True)
    assert seen == [2, 2, 2, 2, 2, 1]
    seen.clear()
    monkeypatch.setattr(trb, "STATS_CHUNK_ELEMS", 1)
    trb.update_state_rew_stats(rt, 1.0, b_init=True)
    assert seen == [1] * (L + 1)


# ---------------------------------------------------------------------
# prioritized samplers and the filters

def _with_errors(ties=False):
    """_perturbed() with TD errors and KL set; with `ties`, most errors
    are 0 (fresh steps) and a few values repeat."""
    rj, _ = _perturbed()
    rng = np.random.RandomState(11)
    delta = np32(rng.randn(E, L + 1))
    if ties:
        delta = np32(rng.choice([0.0, 0.0, 0.0, 0.5, -0.5, 1.25],
                                (E, L + 1)))
    rj = rj._replace(delta=jnp.asarray(delta),
                     kl=jnp.asarray(np32(np.abs(rng.randn(E, L + 1)) * .1)))
    return rj, convert.replay_from_jax(jax_replay_views(rj))


def _jax_per_rank_probs(rs):
    """The probability vector inside jrb.sample_per_rank
    (smarties_tpu/replay/buffer.py:634-641)."""
    mask = rs.valid_steps()
    err = jnp.where(mask, jnp.abs(rs.delta), -1.0).reshape(-1)
    n = err.shape[0]
    order = jnp.argsort(-err)
    rank = jnp.zeros((n,), jnp.float32).at[order].set(
        jnp.arange(1, n + 1, dtype=jnp.float32))
    p = jnp.where(mask.reshape(-1), 1.0 / rank, 0.0)
    return p / jnp.sum(p)


def _jax_per_err_probs(rs):
    mask = rs.valid_steps()
    p = jnp.where(mask, jnp.abs(rs.delta) + 1e-3, 0.0).reshape(-1)
    return p / jnp.maximum(jnp.sum(p), 1e-9)


def _jax_per_seq_probs(rs):
    mask = rs.valid_steps().astype(jnp.float32)
    n = jnp.maximum(jnp.sum(mask, axis=1), 1.0)
    avg_err = jnp.sum(rs.delta * rs.delta * mask, axis=1) / n
    p = jnp.where(rs.valid_slots(), avg_err + 1e-3, 0.0)
    return p / jnp.maximum(jnp.sum(p), 1e-9)


def _jax_episode_probs(rs):
    p = rs.valid_slots().astype(jnp.float32)
    return p / jnp.maximum(jnp.sum(p), 1.0)


PROBS = {"PERrank": (_jax_per_rank_probs, trb.per_rank_probs),
         "PERerr": (_jax_per_err_probs, trb.per_err_probs),
         "PERseq": (_jax_per_seq_probs, trb.per_seq_probs),
         "episodes": (_jax_episode_probs, trb.episode_probs)}
PROB_TOL = dict(rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("algo", sorted(PROBS))
def test_sampler_probabilities(algo, ties):
    rj, rt = _with_errors(ties)
    jfn, tfn = PROBS[algo]
    want, got = np.asarray(jfn(rj)), tn(tfn(rt))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **PROB_TOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)
    if algo == "PERrank":
        # the same ranks, tie by tie: 1/p orders the steps alike
        nz = want > 0
        np.testing.assert_array_equal(np.argsort(-got[nz], kind="stable"),
                                      np.argsort(-want[nz], kind="stable"))


def test_episode_aggregates():
    rj, rt = _with_errors()
    for got, want in zip(trb.episode_aggregates(rt),
                         jrb.episode_aggregates(rj)):
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_draw_from_probs_is_the_inverse_cdf():
    """Against numpy on the f64 cumulative sum; zero-probability entries
    (leading, inner, trailing) are never drawn; u = 0 and u just below 1
    land on the first and last positive entry."""
    rng = np.random.RandomState(5)
    p = np32(rng.rand(4001))
    p[rng.rand(4001) < 0.3] = 0.0
    p[:3] = 0.0
    p[-4:] = 0.0
    p /= p.sum()
    u = np32(np.concatenate([[0.0, np.nextafter(np.float32(1), 0)],
                             rng.rand(5000)]))
    cdf = np.cumsum(p.astype(np.float64))
    want = np.searchsorted(cdf, u.astype(np.float64) * cdf[-1],
                           side="right")
    got = tn(trb.draw_from_probs(tt(p), tt(u)))
    np.testing.assert_array_equal(got, want)
    assert (p[got] > 0).all()
    pos = np.nonzero(p)[0]
    assert got[0] == pos[0] and got[1] == pos[-1]
    freq = np.bincount(got[2:], minlength=len(p)) / 5000.0
    assert abs(freq[pos[:2000]].sum() - p[pos[:2000]].sum()) < 0.03


def test_draw_keeps_small_probabilities():
    """2^21 entries, one of them 2^20 times likelier than each other: an
    f32 cumulative sum would stall (1 + 2^-24 == 1 in f32); the f64 one
    still reaches every entry."""
    n = 1 << 21
    p = torch.full((n,), 2.0 ** -45)
    p[0] = 1.0
    total = 1.0 + (n - 1) * 2.0 ** -45
    u = torch.tensor([(1.0 + 2.0 ** -45 * 12345.5) / total,
                      (1.0 + 2.0 ** -45 * (n - 1.5)) / total],
                     dtype=torch.float64)
    got = tn(trb.draw_from_probs(p, u))
    np.testing.assert_array_equal(got, [12346, n - 1])


@pytest.mark.parametrize("algo", ["PERrank", "PERerr", "PERseq"])
def test_samplers_draw_stored_steps(algo):
    """The dispatch with injected uniforms and with a generator: valid
    (ep, t) only, reproducible from the uniforms, the empirical episode
    frequencies near the probabilities."""
    rj, rt = _with_errors()
    n = 4096
    rng = np.random.RandomState(2)
    u = tt(np32(rng.rand(2, n))) if algo == "PERseq" else tt(np32(rng.rand(n)))
    ep, t = trb.sample(None, rt, n, algo, u=u)
    ep2, t2 = trb.sample(None, rt, n, algo, u=u)
    assert torch.equal(ep, ep2) and torch.equal(t, t2)
    assert ep.dtype == torch.int32 and t.dtype == torch.int32
    e, tq = tn(ep), tn(t)
    assert (tn(rt.ep_id)[e] >= 0).all()
    assert (tq >= 0).all() and (tq < tn(rt.length)[e]).all()
    if algo == "PERseq":
        p_ep = tn(trb.per_seq_probs(rt))
    else:
        p_flat = tn(PROBS[algo][1](rt))
        p_ep = p_flat.reshape(E, L + 1).sum(1)
        want_flat = np.searchsorted(
            np.cumsum(p_flat.astype(np.float64)),
            tn(u).astype(np.float64)
            * np.cumsum(p_flat.astype(np.float64))[-1], side="right")
        np.testing.assert_array_equal(e * (L + 1) + tq, want_flat)
    np.testing.assert_allclose(np.bincount(e, minlength=E) / n, p_ep,
                               atol=0.03)
    g = torch.Generator().manual_seed(0)
    ep3, t3 = trb.sample(g, rt, 256, algo)
    assert (tn(t3) < tn(rt.length)[tn(ep3)]).all()
    assert (tn(rt.ep_id)[tn(ep3)] >= 0).all()


def test_sample_per_rank_weight_and_episodes():
    """The PER weight (computed, never applied): (1 / (N p)) ** beta over
    its max; sample_episodes draws valid slots only."""
    rj, rt = _with_errors()
    u = tt(np32(np.random.RandomState(3).rand(64)))
    ep, t, w = trb.sample_per_rank(None, rt, 64, beta_annealed=0.6, u=u)
    p = tn(trb.per_rank_probs(rt))[tn(ep) * (L + 1) + tn(t)]
    want = (1.0 / (float(rt.n_stored_steps()) * p)) ** 0.6
    np.testing.assert_allclose(tn(w), want / want.max(), rtol=1e-5)
    assert float(w.max()) == 1.0
    eps = trb.sample_episodes(None, rt, 64, u=u)
    assert eps.dtype == torch.int32
    assert (tn(rt.ep_id)[tn(eps)] >= 0).all()
    assert len(np.unique(tn(eps))) > 1
    with pytest.raises(ValueError, match="dataSamplingAlgo"):
        trb.sample(None, rt, 4, "nope")


FILTERS = ["oldest", "farpolfrac", "maxkldiv", "minerror"]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("filt", FILTERS)
def test_filter_keep_priority_and_prune(filt, ties):
    """_keep_priority and the slots prune_to_capacity invalidates, at two
    capacities; with ties the stable sort keeps slot order, as jnp's."""
    rj, rt = _with_errors(ties)
    if ties:
        # whole episodes with equal aggregates
        z = jnp.zeros_like(rj.kl)
        rj = rj._replace(kl=z, delta=z, rho=jnp.ones_like(rj.rho))
        rt = convert.replay_from_jax(jax_replay_views(rj))
    np.testing.assert_allclose(tn(trb._keep_priority(rt, filt)),
                               np.asarray(jrb._keep_priority(rj, filt)),
                               rtol=1e-6, atol=1e-7)
    for cap in (30, 9):
        rj = jrb.prune_to_capacity(rj, cap, filt)
        rt = trb.prune_to_capacity(rt, cap, filt)
        assert_replay_close(rj, rt, fields=("length", "ep_id", "far_count",
                                            "n_pruned_eps"), **EXACT)
    assert int(rt.n_pruned_eps) > 0
    with pytest.raises(ValueError, match="ERoldSeqFilter"):
        trb._keep_priority(rt, "nope")


@pytest.mark.parametrize("filt", FILTERS[1:])
def test_filter_victim_slots_on_commit(filt):
    """A full replay: the arriving episodes overwrite the slots the
    filter ranks worst, and the pruning that follows uses it too."""
    rj, rt = _with_errors()
    assert int(rt.n_stored_eps()) == E
    b = _batch(21, [True, True, False, True], [4, 6, 3, 2],
               [True, False, False, True])
    before = tn(rt.ep_id).copy()
    rj = jrb.commit_episodes(rj, *(jnp.asarray(b[k]) for k in (
        "states", "actions", "mus", "rewards", "value", "advantage", "qret",
        "rho", "length", "terminal", "done")), 40, filt)
    targs = [tt(b[k]) for k in ("states", "actions", "mus", "rewards",
                                "value", "advantage", "qret", "rho")] + [
        tt(b["length"], torch.int32), tt(b["terminal"], torch.bool),
        tt(b["done"], torch.bool)]
    rt = trb.commit_episodes(rt, *targs, 40, filt)
    assert_replay_close(rj, rt, **EXACT)
    assert (tn(rt.ep_id) != before).sum() >= 3
