"""Port parity: the feed-forward off-policy learners beyond V-RACER.

Ten configurations of RACER (Gaussian and discrete advantage), DQN, NAF,
DPG and MixedPG: 4 pinned train steps and the act function against the
JAX package. The setup, the checks and their tolerances are in
_torch_learner_cases.py.
"""
import jax
import pytest

from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves

from _torch_learner_cases import (FF_CASES, _setup, assert_tree_close,
                                  check_act, check_four_train_steps)


@pytest.mark.parametrize("name", FF_CASES)
def test_four_train_steps(name):
    check_four_train_steps(name)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", FF_CASES)
def test_act(name, train):
    check_act(name, train)


def test_optimiser_state_round_trip():
    """MixedPG's optimiser state and DQN's {"net", "tgt"} params cross
    both ways."""
    jl, _, params, opt, _ = _setup("mixedpg")
    to = convert.opt_state_from_jax(jax.device_get(opt))
    back = convert.opt_state_to_numpy(to)
    assert sorted(back) == ["adam", "dpg_factor", "err_q_factor"]
    again = convert.opt_state_from_jax(back)
    assert_tree_close(again.adam.m1, back["adam"]["m1"], rtol=0, atol=0)
    assert int(again.step) == int(opt.adam.step)
    _, _, dparams, _, _ = _setup("dqn_refer_retrace")
    tp = convert.params_from_jax(jax.device_get(dparams))
    assert all(x.requires_grad for x in tree_leaves(tp["net"]))
    assert not any(x.requires_grad for x in tree_leaves(tp["tgt"]))
    assert_tree_close(tp, convert.params_to_jax(tp), rtol=0, atol=0)
