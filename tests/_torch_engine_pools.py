"""In-process lockstep env pools for the Engine and CMA parity tests.

Each pool drives its env objects in the test's own process, with no fork
and no pipe, through the interface the Engine and CMAES.run_external use
(probe_spec, gather_states, send_actions, kill; no poll_states, so the
Engine serves it in lockstep). The problem description comes from a
Communicator of the package under test, set up as the app would set it
up, and the MDP from that package's spec_to_mdp(s): the same pool class
serves the JAX Engine and the port's.
"""
import importlib.util
import os

import numpy as np

APPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "apps")
INIT, CONT, TERM, LAST = 0, 1, 2, 3


def load_app(name):
    """apps/<name>/exec.py as a module (its __main__ block does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_exec_torch_tests", os.path.join(APPS, name, "exec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SpecOnly:
    """A Communicator transport that only keeps the problem description."""

    def send(self, msg):
        pass


def app_spec(communicator_cls, describe):
    """The spec dict an app declares: `describe(comm)` makes the app's
    setter calls on a Communicator of the package under test."""
    comm = communicator_cls(_SpecOnly())
    describe(comm)
    return comm._spec


class LockstepPool:
    """envs: one object per lane with reset() -> state and
    step(action) -> (state, reward, status) (status CONT, TERM or LAST)."""

    def __init__(self, spec, envs, spec_to_mdp, spec_to_mdps):
        self.spec = spec
        self.envs = envs
        self.n_envs = len(envs)
        self._mdps = (spec_to_mdp, spec_to_mdps)
        self._state = [None] * len(envs)
        self._next = [None] * len(envs)
        self.n_agents = 1
        self.killed = False

    def probe_spec(self):
        to_mdp, to_mdps = self._mdps
        self.mdp = to_mdp(self.spec)
        self.mdps = to_mdps(self.spec)
        return self.mdp

    @property
    def n_lanes(self):
        return len(self.envs)

    def gather_states(self):
        n = self.n_lanes
        states = np.zeros((n, self.spec["dim_state"]))
        rewards, statuses = np.zeros(n), np.full(n, -1, np.int64)
        events = []
        for lane, env in enumerate(self.envs):
            pending = self._next[lane]
            if pending is not None:
                events.append((lane,) + pending)
                self._next[lane] = None
            if pending is None or pending[0] in (TERM, LAST):
                s = np.asarray(env.reset(), np.float64)
                events.append((lane, INIT, s, 0.0))
                states[lane], statuses[lane] = s, INIT
            else:
                states[lane], statuses[lane] = pending[1], pending[0]
                rewards[lane] = pending[2]
        return events, states, rewards, statuses

    def send_actions(self, actions):
        for lane, env in enumerate(self.envs):
            s, r, status = env.step(np.asarray(actions[lane]))
            self._next[lane] = (status, np.asarray(s, np.float64), float(r))

    def kill(self):
        self.killed = True


class PinnedCartPole:
    """apps/cart_pole_py's CartPole with its resets drawn from a seeded
    RandomState, truncated at `max_steps` (LAST)."""

    def __init__(self, seed, max_steps=64):
        self.env = load_app("cart_pole_py").CartPole()
        self.rng = np.random.RandomState(seed)
        self.max_steps = max_steps

    def reset(self):
        self.env.u = self.rng.uniform(-0.05, 0.05, 4)
        self.env.step_id = 0
        return self.env.get_state()

    def step(self, action):
        over = self.env.advance(action)
        s, r = self.env.get_state(), self.env.get_reward()
        if self.env.is_failed():
            return s, r, TERM
        if over or self.env.step_id >= self.max_steps:
            return s, r, LAST
        return s, r, CONT


def cart_pole_spec(communicator_cls):
    """What apps/cart_pole_py's app_main declares."""
    def describe(comm):
        comm.setStateActionDims(6, 1)
        comm.setActionScales([10.0], [-10.0], areBounds=True)
        comm.setStateObservable([True, True, False, True, True, True])
    return app_spec(communicator_cls, describe)


class FuncMaximization:
    """apps/func_maximization's one-step episodes: the parameters come
    as the action, the episode ends with reward -objective(action)."""

    def __init__(self):
        self.objective = load_app("func_maximization").objective

    def reset(self):
        return np.zeros(1)

    def step(self, action):
        return np.zeros(1), -self.objective(action), TERM


def func_maximization_spec(communicator_cls):
    app = load_app("func_maximization")

    def describe(comm):
        comm.setStateActionDims(1, app.DIM)
        comm.setActionScales([1.0] * app.DIM, [-1.0] * app.DIM,
                             areBounds=True)
    return app_spec(communicator_cls, describe)
