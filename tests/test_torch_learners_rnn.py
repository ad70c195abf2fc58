"""Port parity: every off-policy learner with a recurrent net.

Ten recurrent configurations (BPTT window 8 over episodes of 3..20 steps,
so windows start before, at and after the episode start): V-RACER with
LSTM, GRU and RNN layers, RACER Gaussian and discrete with an LSTM, DQN
with an LSTM (Retrace-free with a target net, and ReF-ER), NAF with a
GRU, DPG with an LSTM encoder (Retrace and 1-step with the target nets):
4 pinned train steps and the act function, with a random acting carry,
against the JAX package. The setup, the checks and their tolerances are
in _torch_learner_cases.py.
"""
import pytest

from _torch_learner_cases import RNN_CASES, check_act, check_four_train_steps


@pytest.mark.parametrize("name", RNN_CASES)
def test_four_train_steps(name):
    check_four_train_steps(name)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", RNN_CASES)
def test_act(name, train):
    check_act(name, train)
