"""An evaluation between fused cycles leaves training as it was.

The JAX Trainer's evaluate draws from a split of its host key, and its
fused cycle only from the carried key, so fused training with an
evaluate(4, 50) between cycles equals fused training without it. The
port's evaluate draws its start states and acting from a generator of
its own (`gen_eval`), so the same holds there: parameters, optimiser
state and every replay field equal, bit for bit. Both sides at 16 envs
and 64 slots on the CPU, 2 + 2 fused cycles against 4.
"""
import jax
import numpy as np
import pytest
import torch

from smarties_tpu.envs import cartpole as jc
from smarties_tpu.runtime.trainer import Trainer as JTrainer
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime.trainer import Trainer as TTrainer, _plain
from smarties_tpu_torch.utils.config import HyperParameters as THP

N_ENVS, N_SLOTS, MAX_LEN = 16, 64, 64
CFG = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
           nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=3)
CYCLE = N_ENVS          # grad steps of one fused cycle at obsPerStep 1


def _jax_run(with_eval: bool):
    tr = JTrainer(jc, jc.MDP, JHP(**CFG), n_envs=N_ENVS, n_slots=N_SLOTS,
                  max_len=MAX_LEN)
    tr.warmup(chunk=16)
    tr.train_fused(2 * CYCLE, log_every=10 ** 9)
    if with_eval:
        assert np.isfinite(tr.evaluate(4, 50)).all()
    tr.train_fused(2 * CYCLE, log_every=10 ** 9)
    assert tr.n_grad_steps == 4 * CYCLE
    return jax.device_get((tr.params, tr.opt_state, tr.carry.replay))


def _port_run(with_eval: bool):
    tr = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=N_ENVS, n_slots=N_SLOTS,
                  max_len=MAX_LEN, device="cpu")
    tr.warmup(chunk=16)
    tr.train_fused(2 * CYCLE, log_every=10 ** 9)
    if with_eval:
        streams = [g.get_state() for g in (tr.gen_env, tr.gen_act,
                                           tr.gen_batch)]
        assert np.isfinite(tr.evaluate(4, 50)).all()
        for g, st in zip((tr.gen_env, tr.gen_act, tr.gen_batch), streams):
            assert torch.equal(g.get_state(), st)
    tr.train_fused(2 * CYCLE, log_every=10 ** 9)
    assert tr.n_grad_steps == 4 * CYCLE
    return tr


def test_jax_fused_training_ignores_an_evaluation():
    a, b = _jax_run(True), _jax_run(False)
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_port_fused_training_ignores_an_evaluation():
    a, b = _port_run(True), _port_run(False)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params),
                    strict=True):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(_plain(a.opt_state)),
                    tree_leaves(_plain(b.opt_state)), strict=True):
        assert torch.equal(x, y)
    ra, rb_ = a.replay, b.replay
    for f in ra.__dataclass_fields__:
        assert torch.equal(getattr(ra, f), getattr(rb_, f)), f
    assert torch.equal(a.carry.inprog.t, b.carry.inprog.t)


@pytest.mark.parametrize("n_eval", [1, 2])
def test_port_evaluations_repeat_from_their_own_stream(n_eval):
    """Two trainers of one seed give the same evaluations in turn, and
    those draw nothing from the env, acting or batch generators."""
    a = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=N_ENVS, n_slots=N_SLOTS,
                 max_len=MAX_LEN, device="cpu")
    b = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=N_ENVS, n_slots=N_SLOTS,
                 max_len=MAX_LEN, device="cpu")
    env0 = a.gen_env.get_state()
    for _ in range(n_eval):
        np.testing.assert_array_equal(a.evaluate(4, 30), b.evaluate(4, 30))
    assert torch.equal(a.gen_env.get_state(), env0)
    assert not torch.equal(a.gen_eval.get_state(), b.gen_env.get_state())


def test_port_eval_stream_survives_a_checkpoint(tmp_path):
    """The evaluation's generator is saved and restored with the others:
    a restored trainer's next evaluation equals the saved one's."""
    a = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=N_ENVS, n_slots=N_SLOTS,
                 max_len=MAX_LEN, device="cpu")
    a.evaluate(4, 30)                       # move the stream on
    path = str(tmp_path / "ck.pt")
    a.save(path)
    b = TTrainer(tc, tc.MDP, THP(**dict(CFG, randSeed=9)), n_envs=N_ENVS,
                 n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu")
    b.restore(path)
    assert torch.equal(a.gen_eval.get_state(), b.gen_eval.get_state())
    np.testing.assert_array_equal(a.evaluate(4, 30), b.evaluate(4, 30))
