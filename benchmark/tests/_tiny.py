"""Small sizes at which the benchmark's cells run on the CPU in a test:
the configuration's widths cut, the envs and the replay few; the window
timed by the host's clock in place of the card's events."""
import time

from benchmark import harness

# the prioritized-sampler cell, proven on the card but kept out of
# BENCHMARK.json (its runs spread with the card's slow mode); its mix
# and limits files are in place for the PR that adds it
PERRANK = {"name": "vracer_cartpole.perrank", "config": "vracer_cartpole",
           "traffic": "perrank", "chips": 1,
           "why": "the fused cycle with PERrank draws inside the step"}

SIZES = {
    "vracer_cartpole": {
        "n_envs": 16, "n_slots": 64, "fill_env_steps": 1024,
        "settings": {"minTotObsNum": 512, "maxTotObsNum": 1024,
                     "batchSize": 16, "nnLayerSizes": [16, 16]}},
}


class HostEvent:
    """torch.cuda.Event's timing calls on the host's clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def options(cell: str) -> dict:
    return {"device": "cpu", "graphs": True, "event": HostEvent,
            "warm_s": 0, "sizes": SIZES[cell.split(".")[0]]}


def manifest() -> dict:
    """BENCHMARK.json with the perrank cell added."""
    man = harness.manifest()
    man["workloads"].append(PERRANK)
    return man
