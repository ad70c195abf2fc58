"""The FLOPs of one grad step of a recurrent net over its truncated-BPTT
window, from the shapes: 2 per multiply-add. A window is W + 1
positions (t-W+1 .. t+1) of `batch` rows; a layer of width h over an
input of width a runs gates x (a h + h h) multiply-adds a row and
position (4 gates for LSTM, 2 for GRU, 1 for RNN), and the output layer
h n_out at every position, as the program runs it.

- forward: every layer and the output layer at all W + 1 positions;
- backward: at the W positions up to t, each layer's weight gradients
  (as many multiply-adds as its forward), the gradient into the
  previous carry (gates x h h) and, but for the first layer (the net's
  input takes no gradient), into its input (gates x a h); the output
  layer's weight and input gradients at t alone.

The cells' activations and gate products, the biases and the optimiser
are left out, as yardstick.step_flops leaves them out."""
from __future__ import annotations

GATES = {"LSTM": 4, "GRU": 2, "RNN": 1}


def step_flops(kind: str, n_in: int, hidden, n_out: int, batch: int,
               window: int) -> int:
    g = GATES[kind]
    sizes = [n_in] + list(hidden)
    pairs = list(zip(sizes[:-1], sizes[1:]))
    cells = sum(g * (a * h + h * h) for a, h in pairs)
    out = sizes[-1] * n_out
    forward = batch * (window + 1) * (cells + out)
    backward = (batch * window * (cells + sum(g * h * h for _, h in pairs)
                                  + sum(g * a * h for a, h in pairs[1:]))
                + batch * 2 * out)
    return 2 * (forward + backward)
