"""The captured form of the learners' grad step against the JAX package.

For each feed-forward configuration of _torch_learner_cases.py (RACER
Gaussian and discrete, the three DQN cases, the two NAF and the two DPG
cases, MixedPG) the JAX package builds the learner, its params and
optimiser state and a replay of synthetic episodes; they are copied into
the storage of a Trainer(graphs=True) (models/net.py::tree_copy_), and
the four pinned (ep, t) steps of check_four_train_steps run through the
trainer's step program (`_train_chunk(4, pre=...)`: on the CPU the
static-buffer form of the graph a card captures). Params, optimiser
state (MixedPG's adaptive factors included), the replay's write-backs
and the last step's metrics are held against the JAX steps at that
file's tolerances. For PERrank the port's draw from pinned uniforms
equals the JAX sampler's from its key, and one captured-form step on
that draw is held the same way. The JAX side runs op by op, as its own
tests run it on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from smarties_tpu.replay import buffer as jrb
from smarties_tpu_torch import launch
from smarties_tpu_torch.models.net import tree_copy_
from smarties_tpu_torch.replay import buffer as trb
from smarties_tpu_torch.runtime.trainer import Trainer

from _torch_learner_cases import (B, E, FF_CASES, L, check_four_train_steps,
                                  tn, tt)

torch.set_num_threads(1)


def captured_form(tl, tp, to, trs, pinned, **settings):
    """The pinned steps through a Trainer(graphs=True)'s step program, from
    the converted state copied into its storage -> (params, opt state,
    replay, last step's metrics). `settings` override the learner's."""
    cfg = dataclasses.replace(tl.cfg, **settings)
    env = launch.env_module("cartpole_discrete" if tl.mdp.is_discrete
                            else "cartpole")
    tr = Trainer(env, env.MDP, cfg, n_envs=8, n_slots=E, max_len=L,
                 device="cpu", graphs=True)
    tree_copy_(tr.params, tp)
    tree_copy_(tr.opt_state, to)
    tree_copy_(tr.carry.replay, trs)
    ep, t = (torch.stack([tt(x[i], torch.int32) for x in pinned])
             for i in (0, 1))
    m = tr._train_chunk(len(pinned), pre=(ep, t))
    assert list(tr._step_graphs) == [True]
    return tr.params, tr.opt_state, tr.replay, {k: v[-1] for k, v in
                                                m.items()}


@pytest.mark.parametrize("name", FF_CASES)
def test_captured_four_train_steps(name):
    check_four_train_steps(name, port_steps=captured_form)


def test_captured_step_on_the_perrank_draw():
    key = jax.random.PRNGKey(3)
    drawn = {}

    def draw(rs):
        ep, t, _ = jrb.sample_per_rank(key, rs, B)
        # jax.random.choice's inverse CDF takes 1 - its uniform
        u = 1.0 - np.asarray(jax.random.uniform(key, (B,)))
        drawn["jax"] = (np.asarray(ep), np.asarray(t))
        drawn["u"] = u
        return [drawn["jax"]]

    def port_steps(tl, tp, to, trs, pinned):
        ep, t = trb.sample(None, trs, B, "PERrank", u=tt(drawn["u"]))
        np.testing.assert_array_equal(tn(ep), drawn["jax"][0])
        np.testing.assert_array_equal(tn(t), drawn["jax"][1])
        return captured_form(tl, tp, to, trs, [(tn(ep), tn(t))],
                             dataSamplingAlgo="PERrank")

    check_four_train_steps("racer_gaussian", port_steps=port_steps,
                           draw=draw)
