"""The tiny CPU sizes of racer_atari (benchmark/tests/_tiny.py holds
those of the other configurations): catch's 84x84 frames and the
published conv stack and [512] layer, with few envs and slots and a
batch of 32: at 8 rows the rms TD error reads 2.2e-4 from the
reference's on the CPU, above the cell's limit, at 32 rows 2e-5 to
5e-5, as the card's 128 rows read."""
from benchmark.tests import _tiny

RACER_ATARI = {
    "n_envs": 4, "n_slots": 32, "fill_env_steps": 4 * 39 * 3,
    "settings": {"minTotObsNum": 256, "maxTotObsNum": 400, "batchSize": 32}}

_tiny.SIZES.setdefault("racer_atari", RACER_ATARI)
