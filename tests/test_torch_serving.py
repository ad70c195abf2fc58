"""The port's serving transports and multi-process env teams, on the CPU.

Twins of tests/test_distributed_envs.py (TeamComm collectives, the
distributed-env and distributed-agent cart-pole apps, the competing
predator/prey demo, cart_pole_many's per-agent MDPs, the
domain-decomposed diffusion_control team), of the untimed
parts of tests/test_shm_serving.py (the shared-memory channel round
trip, a crashing shm worker respawned, the socket pool's serving-mode
guard) and of tests/test_event_serving.py::
test_partial_rounds_keep_episode_streams_consistent, on the port's
copies of runtime/{communicator,env_pool,socket_pool,team}.py. The
timed serving tests (test_slow_env_does_not_block_fast_envs and the
transports' equivalence under a 1 s poll) have no twin: each test here
asserts counts, streams and files, never a rate or a wall-clock bound.
"""
import multiprocessing as mp
import os

import numpy as np
import pytest

import smarties_tpu_torch
from smarties_tpu_torch.runtime.communicator import CONT, ShmChannel
from smarties_tpu_torch.runtime.env_pool import EnvPool
from smarties_tpu_torch.runtime.team import TeamComm, make_team_pipes
from smarties_tpu_torch.utils.config import HyperParameters

# torch at 1 thread beside the other test workers (tests/_torch_parity.py)
import _torch_parity  # noqa: F401
from _torch_engine_pools import load_app


def cfg(**kw):
    d = dict(minTotObsNum=64, maxTotObsNum=512, batchSize=32,
             nnLayerSizes=[16, 16])
    d.update(kw)
    return HyperParameters(**d)


def _engine(n_envs, steps, run_dir, workers=1):
    e = smarties_tpu_torch.Engine([], device="cpu")
    e.setNEnvironments(n_envs)
    if workers > 1:
        e.setNworkersPerEnvironment(workers)
    e.setSettings(cfg())
    e.setNTrainSteps(steps)
    e.setMaxEpisodeLength(512)
    e.run_dir = str(run_dir)
    return e


def _reward_lanes(run_dir):
    rows = open(os.path.join(str(run_dir),
                             "agent_00_rank00_cumulative_rewards.dat")
                ).read().split("\n")
    return {int(r.split()[2]) for r in rows if r.strip()}


# ---------------------------------------------------------------------
def _team_member(rank, size, conns, out_q):
    team = TeamComm(rank, size, conns)
    g = team.allgather(rank * 10)
    s = team.allreduce(rank + 1.0)
    b = team.bcast("hello" if rank == 0 else None)
    team.barrier()
    arr = team.allgather_array(np.full(2, float(rank)))
    out_q.put((rank, g, s, b, arr.tolist()))


def test_team_collectives_3way():
    ctx = mp.get_context("fork")
    size = 3
    root_ends, member_ends = make_team_pipes(ctx, size)
    q = ctx.Queue()
    procs = []
    for r in range(size):
        conns = root_ends if r == 0 else member_ends[r - 1]
        p = ctx.Process(target=_team_member, args=(r, size, conns, q))
        p.start()
        procs.append(p)
    results = {}
    for _ in range(size):
        r, g, s, b, arr = q.get(timeout=60)
        results[r] = (g, s, b, arr)
    for p in procs:
        p.join(timeout=10)
    for r in range(size):
        assert results[r] == ([0, 10, 20], 6.0, "hello",
                              [0.0, 0.0, 1.0, 1.0, 2.0, 2.0])


def test_team_single_member():
    team = TeamComm(0, 1, [])
    assert team.allgather(7) == [7]
    assert team.allreduce(3) == 3
    team.barrier()


# ---------------------------------------------------------------------
def test_cartpole_distrib_env_trains(tmp_path):
    """Both team members are full agent channels: 1 env x 2 members."""
    e = _engine(1, 20, tmp_path, workers=2)
    e.run(load_app("cart_pole_distribEnv").app_main, max_wall_s=180)
    b = e.learners[0]
    assert b.n_env_steps > 0 and b.n_grad >= 20
    # episodes from BOTH lanes were committed (team termination works)
    assert _reward_lanes(tmp_path) == {0, 1}


def test_cartpole_distrib_agent_trains(tmp_path):
    """ONE logical agent spans the team: a single lane, joint MDP."""
    e = _engine(1, 20, tmp_path, workers=2)
    e.run(load_app("cart_pole_distribAgent").app_main, max_wall_s=180)
    b = e.learners[0]
    assert b.mdp.dim_state == 8 and b.mdp.dim_action == 2
    assert b.n_env_steps > 0 and b.n_grad >= 20
    assert _reward_lanes(tmp_path) == {0}


def test_competing_demo_trains(tmp_path):
    """apps/predator_prey: two per-agent MDPs -> two learners."""
    e = _engine(2, 10, tmp_path)
    e.run(load_app("predator_prey").app_main, max_wall_s=240)
    assert len(e.learners) == 2
    for b in e.learners:
        assert b.n_grad >= 10 and int(b.rs.n_stored_eps()) > 0


def test_per_agent_mdps_two_learners(tmp_path):
    """apps/cart_pole_many: agent 1 sees 3 of the 6 state variables."""
    e = _engine(2, 15, tmp_path)
    e.run(load_app("cart_pole_many").app_main, max_wall_s=180)
    assert len(e.learners) == 2
    b0, b1 = e.learners
    assert b0.mdp.dim_state_observed > b1.mdp.dim_state_observed == 3
    for b in e.learners:
        assert b.n_grad >= 15 and int(b.rs.n_stored_eps()) > 0


def test_diffusion_control_team_app():
    """apps/diffusion_control: a 1-D heat rod domain-decomposed across a
    2-process env team (halo exchange through TeamComm), one logical
    agent, rank-0 ingest and identical replies."""
    import runpy
    mod = runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                      "apps", "diffusion_control",
                                      "exec.py"))
    e = smarties_tpu_torch.Engine([], device="cpu")
    e.setNEnvironments(2)
    e.setNworkersPerEnvironment(2)
    e.setSettings(cfg(minTotObsNum=128, maxTotObsNum=1024))
    e.setNTrainSteps(30)
    e.setMaxEpisodeLength(mod["EP_LEN"] + 1)
    e.run(mod["app_main"], max_wall_s=240)
    assert e.n_grad_steps >= 30
    assert int(e.replay.n_stored_steps()) > 0


# ---------------------------------------------------------------------
def test_shm_channel_roundtrip():
    ch = ShmChannel.create(n_agents=2, dim_state=3, dim_action=2)
    try:
        peer = ShmChannel.attach(ch.name, 2, 3, 2, ch.ring_len)
        ch.push_state(0, 1, np.asarray([1.0, 2.0, 3.0]), 0.25)
        ch.push_state(1, 2, np.asarray([4.0, 5.0, 6.0]), -1.0)
        entries, seq = peer.read_new(0)
        assert seq == 2 and len(entries) == 2
        kind, agent, status, state, reward = entries[0]
        assert (kind, agent, status, reward) == ("state", 0, 1, 0.25)
        np.testing.assert_allclose(state, [1.0, 2.0, 3.0])
        _, agent1, status1, state1, reward1 = entries[1]
        assert (agent1, status1, reward1) == (1, 2, -1.0)
        # wrap the ring
        for i in range(ch.ring_len + 3):
            ch.push_state(0, 1, np.asarray([float(i), 0, 0]), 0.0)
        entries, seq = peer.read_new(seq)
        assert len(entries) == ch.ring_len + 3
        assert entries[-1][3][0] == float(ch.ring_len + 2)
        # action rows
        peer.write_action(1, np.asarray([7.0, 8.0]))
        peer.publish_round()
        assert int(ch.hdr[1]) == 1
        np.testing.assert_allclose(ch.acts[1], [7.0, 8.0])
        peer.close()
    finally:
        ch.close(unlink=True)


def _crashy(comm):
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)
    comm.sendInitState(np.zeros(1))
    comm.recvAction()
    os._exit(1)


def test_env_pool_shm_respawn():
    """A crashing shm worker surfaces FAIL and re-attaches a new slab; the
    loop ends on the FAIL, not on a clock."""
    pool = EnvPool(_crashy, 1, seed=0, max_respawns=2, use_shm=True)
    try:
        pool.probe_spec()
        fails = 0
        rounds = 0
        while fails < 1 and rounds < 2000:
            events, ready = pool.poll_states(timeout=0.05)
            fails += sum(1 for _, s, _, _ in events if s == 4)
            if ready:
                pool.send_actions([np.asarray([0.0])])
            rounds += 1
    finally:
        pool.kill()
    assert fails >= 1 and pool._respawns[0] >= 1


_FRESH_POOL = """
import os
import numpy as np
from smarties_tpu_torch.runtime.env_pool import EnvPool

def app(comm):
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)
    comm.sendInitState(np.zeros(1))
    while True:
        comm.recvAction()
        comm.sendState(np.zeros(1), 0.0)

def children(pids):
    out = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = open(f"/proc/{d}/stat").read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) in pids:
            out.append(int(d))
    return out

pool = EnvPool(app, 3, seed=0, use_shm=True)
pool.probe_spec()
for _ in range(4):
    pool.gather_states()
    pool.send_actions([np.zeros(1)] * 3)
print(len(pool._shm), len(children({p.pid for p in pool._procs})))
pool.kill()
"""


def test_env_pool_workers_share_the_resource_tracker():
    """In a fresh process, shm workers register their slabs with the
    pool's resource tracker: none starts a tracker of its own (which
    would outlive it as an orphan), and no slab is reported leaked."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", _FRESH_POOL], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["3", "0"], (r.stdout, r.stderr)
    assert "resource_tracker" not in r.stderr, r.stderr


def test_socket_pool_mode_guard():
    """gather_states after poll_states buffering must raise (one serving
    mode per pool instance)."""
    from smarties_tpu_torch.runtime.socket_pool import SocketEnvPool
    pool = SocketEnvPool.__new__(SocketEnvPool)
    pool._rbuf = [b"\x01"]          # a parked partial frame
    pool._chan_events = {}
    with pytest.raises(RuntimeError, match="ONE serving mode"):
        pool.gather_states()


def _echo_app(comm):
    """Echoes its step index; env 1 is slower than the others."""
    import time
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)
    t = 0
    comm.sendInitState(np.array([0.0]))
    while True:
        a = comm.recvAction()
        t += 1
        if comm.env_id == 1:
            time.sleep(0.005)
        comm.sendState(np.array([float(t)]), float(a[0]))


def test_partial_rounds_keep_episode_streams_consistent():
    """Served-step streams stay per-lane-consistent across partial
    rounds: every lane alternates state -> action with no skips. Serves
    until every lane has sent 20 states (or 5000 polls)."""
    pool = EnvPool(_echo_app, n_envs=3, seed=0)
    seen = {lane: [] for lane in range(3)}
    try:
        pool.probe_spec()
        polls = 0
        while min(len(v) for v in seen.values()) < 20 and polls < 5000:
            events, ready = pool.poll_states(timeout=0.05)
            for lane, status, s, _r in events:
                if status == CONT:
                    seen[lane].append(int(s[0]))
            ready = set(ready)
            pool.send_actions([np.zeros(1) if lane in ready else None
                               for lane in range(pool.n_lanes)])
            polls += 1
    finally:
        pool.kill()
    for lane, idxs in seen.items():
        assert len(idxs) >= 20, (lane, len(idxs))
        assert idxs == list(range(1, len(idxs) + 1)), \
            f"lane {lane} stream has gaps: {idxs[:10]}..."
