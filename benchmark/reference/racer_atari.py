"""Plain reference of the configuration racer_atari: cselab/smarties'
RACER_atari recipe (settings/RACER_atari.json with apps/OpenAI_gym_atari:
RACER, batch 128, C = 4, gamma 0.99, lr 1e-4, a [512] layer) over the
conv stack of Mnih et al. 2015 (Nature 518:529) on 4 stacked 84x84
frames: 32 filters 8x8 at stride 4, 64 4x4 at stride 2, 64 3x3 at
stride 1. Discrete actions take RACER's discrete advantage and policy
(benchmark/reference/racer.py).

Departures from the published description:
- the game is catch (benchmark/reference/catch.py), which the program
  ships in place of the ALE (no emulator is in the repository): 84x84
  frames in {0, 255}, 3 actions, 39-step episodes;
- the convs are followed by LRelu (smarties' Conv2D layers; Mnih et al.
  used ReLU), the dense layer by SoftSign (smarties' default nnFunc;
  Mnih et al. used ReLU);
- frames are standardised per pixel by the replay's statistics
  (smarties' state standardisation), not divided by 255;
- the stacked frames are channels newest first, and the last conv's
  output is flattened in (row, column, channel) order, as the program
  holds them; the program's conv weights are HWIO and this reference's
  OIHW (to_program, from_program).
"""
from __future__ import annotations

from benchmark.reference import catch, conv

KIND = "discrete"
ENV_GAP = "env_pixels"
N_ACT = 3


def arch(config: dict) -> dict:
    s = config["settings"]
    stack = [tuple(c) for c in config["conv"]]
    in_w, in_h, in_c, out_c, filt, stride = stack[-1]
    side = (in_w - filt) // stride + 1
    return {"n_in": side * ((in_h - filt) // stride + 1) * out_c,
            "hidden": s["nnLayerSizes"], "n_out": 1 + 2 * N_ACT,
            "n_param": 0, "act": s.get("nnFunc", "SoftSign"),
            "out_prefac": s.get("outWeightsPrefac", 0.1), "conv": stack}


def param_init(config: dict):
    return None                   # a discrete policy has no stdev head


draw_weights = conv.draw_weights


def net_input(frames, mean, scale):
    """frames [B, 4, H * W] stored uint8, newest first -> standardised
    [B, 4 * H * W], the frames as channels."""
    return ((frames.to(mean.dtype) - mean) * scale).reshape(
        frames.shape[0], -1)


def batch_extras(mb: dict) -> dict:
    return {}


def env_gaps(cols: dict):
    """(wrong pixels, wrong rewards or ends) of stored episodes."""
    return catch.transition_gaps(cols["states"], cols["actions"],
                                 cols["rewards"], cols["length"],
                                 cols["terminal"])


def to_program(name, x):
    """A leaf in the program's layout: conv weights OIHW -> HWIO."""
    return x.permute(2, 3, 1, 0) if name.startswith("conv") and \
        name.endswith(".W") else x


def from_program(name, x):
    return x.permute(3, 2, 0, 1) if name.startswith("conv") and \
        name.endswith(".W") else x


forward = conv.forward
