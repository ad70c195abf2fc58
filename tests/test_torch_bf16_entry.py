"""nnBf16 through the port's entry points: the Trainer, the Engine's
learner bundle and the MultiTrainer build their learners with the bf16
compute type, train with it, and set the contractions' precision
(runtime/trainer.py::set_precision: no TF32, f32 accumulation in
cuBLAS's bf16 split-K reductions).

The Engine's bundle is held against the JAX package's on the same
committed episodes and 4 pinned train steps through `train_to_pace`,
with tests/test_torch_bf16.py's tolerances (params rtol 1e-5 / atol
1e-6, rho and KL rtol 1e-4 / atol 1e-5, values atol 2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.runtime import communicator as jcomm
from smarties_tpu.runtime import engine as jeng
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.envs import cartpole, catch, predator_prey
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime import communicator as tcomm
from smarties_tpu_torch.runtime import engine as teng
from smarties_tpu_torch.runtime.multitrainer import MultiTrainer
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_engine_pools import cart_pole_spec
from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32)

SMALL = dict(nnLayerSizes=[16], batchSize=16, minTotObsNum=128,
             maxTotObsNum=512, randSeed=0)
# name: (env module, settings, replay storage type)
TRAINER_CASES = {
    "racer_catch_small": (catch.small, dict(learner="RACER"), torch.uint8),
    "vracer": (cartpole, dict(learner="VRACER"), None),
    "dqn": (cartpole.discrete, dict(learner="DQN"), None),
    "racer_es": (cartpole, dict(learner="VRACER", ESpopSize=4), None),
}
PRECISION_FLAGS = ((torch.backends.cuda.matmul, "allow_tf32"),
                   (torch.backends.cudnn, "allow_tf32"),
                   (torch.backends.cuda.matmul,
                    "allow_bf16_reduced_precision_reduction"))


def _trainer(name, bf16):
    env, extra, state_dtype = TRAINER_CASES[name]
    cfg = THP(**dict(SMALL, nnBf16=bf16, **extra))
    return Trainer(env, env.MDP, cfg, n_envs=8, n_slots=64,
                   max_len=min(env.MAX_STEPS, 64), device="cpu",
                   state_dtype=state_dtype)


@pytest.mark.parametrize("name", sorted(TRAINER_CASES))
def test_trainer_trains_in_bf16(name):
    """Warmup and two fused cycles (8 grad steps each); the same run in
    f32 ends elsewhere."""
    params = {}
    for bf16 in (True, False):
        tr = _trainer(name, bf16)
        assert tr.algo.spec.compute_dtype == ("bfloat16" if bf16
                                              else "float32")
        tr.warmup(chunk=16)
        cycles = []
        fused = tr._fused_cycle
        tr._fused_cycle = lambda *a: cycles.append(a) or fused(*a)
        tr.train_fused(16, log_every=10 ** 9)
        assert cycles == [(1, 8)] * 2 and tr.n_grad_steps == 16
        params[bf16] = [x.detach().clone() for x in tree_leaves(tr.params)]
        assert all(torch.isfinite(x).all() for x in params[bf16])
        assert all(x.dtype == torch.float32 for x in params[bf16])
    assert not all(torch.equal(a, b)
                   for a, b in zip(params[True], params[False]))


def _set_flags(values):
    for (obj, attr), v in zip(PRECISION_FLAGS, values):
        setattr(obj, attr, v)


@pytest.mark.parametrize("entry", ["engine", "multitrainer", "trainer"])
def test_entry_point_sets_precision(entry):
    """Each entry point turns TF32 off and keeps f32 accumulation in the
    bf16 GEMMs' reductions, whatever the process had set."""
    saved = [getattr(obj, attr) for obj, attr in PRECISION_FLAGS]
    try:
        _set_flags([True] * len(PRECISION_FLAGS))
        if entry == "engine":
            teng._LearnerBundle(
                0, tcomm.spec_to_mdp(cart_pole_spec(tcomm.Communicator)),
                THP(**SMALL), [0], 16, device="cpu")
        elif entry == "multitrainer":
            _multitrainer(True)
        else:
            _trainer("vracer", True)
        assert [getattr(obj, attr) for obj, attr in PRECISION_FLAGS] \
            == [False] * len(PRECISION_FLAGS)
    finally:
        _set_flags(saved)


# ---------------------------------------------------------------------
# the Engine's learner bundle

MAX_LEN, B = 32, 16
ENGINE_CFG = dict(minTotObsNum=48, maxTotObsNum=512, batchSize=B,
                  nnLayerSizes=[16, 16], randSeed=0, nnBf16=True)
_DISCRETE = dict(cart_pole_spec(tcomm.Communicator), discrete_values=(2,),
                 bounded=(False,))
# name: (settings, app spec)
BUNDLE_CASES = {
    "vracer": (dict(learner="VRACER"), None),
    "racer": (dict(learner="RACER"), None),
    "dqn": (dict(learner="DQN"), _DISCRETE),
    "racer_es": (dict(learner="VRACER", ESpopSize=4), None),
}


@pytest.mark.parametrize("name", sorted(BUNDLE_CASES))
def test_engine_bundle_is_bf16(name):
    extra, spec = BUNDLE_CASES[name]
    spec = spec or cart_pole_spec(tcomm.Communicator)
    b = teng._LearnerBundle(0, tcomm.spec_to_mdp(spec),
                            THP(**dict(ENGINE_CFG, **extra)), [0], MAX_LEN,
                            device="cpu")
    assert b.algo.spec.compute_dtype == "bfloat16"


def _episodes(seed, lengths, terminals, mdp):
    """Assembled episodes (ep_arrays, T, terminal) of seeded streams, the
    Gaussian policy vectors valid."""
    rng = np.random.RandomState(seed)
    out = []
    for T, term in zip(lengths, terminals):
        asm = teng._EpisodeAssembler()
        asm.add_state(np32(rng.randn(mdp.dim_state_observed)), 0.0)
        for _ in range(T):
            mu = np32(rng.rand(mdp.dim_policy))
            mu[1:] += 0.3
            asm.add_action(np32(rng.randn(mdp.dim_action)), mu,
                           float(rng.randn()), float(rng.randn()))
            asm.add_state(np32(rng.randn(mdp.dim_state_observed)),
                          float(rng.randn()))
        *arrs, T_, term_, _ = asm.finalize(term, MAX_LEN)
        out.append((arrs, T_, term_))
    return out


@pytest.mark.parametrize("learner", ["RACER", "VRACER"])
def test_engine_bundle_trains_as_jax(learner):
    """Both packages' bundles in bf16 commit the same episodes, start
    their statistics, and take 4 pinned grad steps (the port's through
    train_to_pace, as the Engine paces them)."""
    cfg = dict(ENGINE_CFG, learner=learner)
    spec = cart_pole_spec(jcomm.Communicator)
    jb = jeng._LearnerBundle(0, jcomm.spec_to_mdp(spec), JHP(**cfg), [0],
                             MAX_LEN)
    tb = teng._LearnerBundle(0, tcomm.spec_to_mdp(spec), THP(**cfg), [0],
                             MAX_LEN, device="cpu")
    assert jb.algo.spec.compute_dtype == tb.algo.spec.compute_dtype \
        == "bfloat16"
    tb.restore(convert.engine_snapshot_from_jax(
        dict(jb.snapshot(), replay=jax_replay_views(jb.rs))))
    for arrs, T, term in _episodes(0, (23, 9, MAX_LEN, 17, 30),
                                   (True, False, False, False, True),
                                   tb.mdp):
        for b in (jb, tb):
            b.commit(arrs, T, term)
            b.n_env_steps += T
    for b in (jb, tb):
        b.maybe_init_stats()
        assert b.initialized
    views = jax_replay_views(jb.rs)
    rng = np.random.RandomState(4)
    valid = np.nonzero(views["ep_id"] >= 0)[0]
    ep, t = [], []
    for _ in range(4):
        pairs = set()
        while len(pairs) < B:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, views["length"][e]))))
        e_, t_ = zip(*sorted(pairs))
        ep.append(e_)
        t.append(t_)
    ep, t = np.asarray(ep, np.int32), np.asarray(t, np.int32)
    tb.sample_indices = lambda n: (torch.as_tensor(ep[:n]),
                                   torch.as_tensor(t[:n]))
    tb.start_env_steps = tb.n_env_steps - 4      # four steps owed
    tb.train_to_pace(10 ** 6)
    assert tb.n_grad == 4
    # op by op: under jax.jit the contractions' outputs stay unrounded
    # (tests/test_torch_bf16.py::test_jit_skips_the_output_rounding)
    p, o, r = jb.params, jb.opt_state, jb.rs
    for i in range(4):
        p, o, r, _ = jb.algo.train_step(
            p, o, r, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep[i]), jnp.asarray(t[i])))
    assert_tree_close(tb.params, jax.device_get(p), rtol=1e-5, atol=1e-6)
    assert_replay_close(r, tb.rs, fields=("rho", "kl"), rtol=1e-4,
                        atol=1e-5)
    assert_replay_close(r, tb.rs, fields=("delta", "value"), rtol=1e-4,
                        atol=2e-3)


# ---------------------------------------------------------------------
# the MultiTrainer

_PP_KW = dict(dim_state=4, dim_action=2, bounded=(True, True),
              upper_action=(1.0, 1.0), lower_action=(-1.0, -1.0),
              n_agents_per_env=2)


def _multitrainer(bf16):
    from smarties_tpu_torch.core.mdp import MDPSpec
    mdps = [MDPSpec(**_PP_KW), MDPSpec(**_PP_KW, observable=(True,) * 4)]
    cfg = dict(SMALL, minTotObsNum=256, nnBf16=bf16)
    return MultiTrainer(predator_prey, mdps, [THP(**cfg), THP(**cfg)],
                        n_envs=8, n_slots=64, max_len=predator_prey.MAX_STEPS,
                        device="cpu")


def test_multitrainer_trains_in_bf16():
    """Both learners in bf16: warmup and 8 grad steps each, finite and
    apart from the same run in f32."""
    params = {}
    for bf16 in (True, False):
        mt = _multitrainer(bf16)
        assert [a.spec.compute_dtype for a in mt.algos] \
            == ["bfloat16" if bf16 else "float32"] * 2
        mt.warmup()
        mt.train(8)
        params[bf16] = [x.detach().clone() for p in mt.params
                        for x in tree_leaves(p)]
        assert all(torch.isfinite(x).all() for x in params[bf16])
    assert not all(torch.equal(a, b)
                   for a, b in zip(params[True], params[False]))
