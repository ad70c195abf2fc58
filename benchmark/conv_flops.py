"""The FLOPs of a conv stack in one grad step, from its shapes
(yardstick.dense_macs's conv entries): 2 per multiply-add of the
forward over `rows` rows, of the weight gradients over as many, and of
the input gradients of every conv but the first (the net's input takes
no gradient). Biases and activations are left out."""
from __future__ import annotations

from benchmark import yardstick


def step_conv_flops(conv, rows: int) -> int:
    macs = yardstick.dense_macs(conv, [])
    return 2 * rows * (3 * sum(macs) - macs[0])
