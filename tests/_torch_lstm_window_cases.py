"""Shared cases of the LSTM window's tests (test_torch_lstm_window.py on
the CPU, test_torch_lstm_window_cuda.py on the card): nets at three
widths, their leaves moved off the init, and windows whose rows cover
the masks the window must hold. Imports neither jax nor the JAX package.
"""
import torch

from smarties_tpu_torch.algos import base
from smarties_tpu_torch.models import net as tnet

# (hidden, n_in): the benchmark cell's LSTM over cartpole.pomdp's three
# observed inputs, two layers of other widths, one layer
SHAPES = (((32, 32), 3), ((16, 24), 5), ((8,), 2))
WINDOWS = (1, 4, 16)


def spec_of(hidden, n_in):
    return tnet.NetSpec(n_in=n_in, hidden=tuple(hidden), n_out=3,
                        kind="LSTM", n_param_out=2, param_init=(0.3, -0.2))


def params_of(spec, seed, dtype=torch.float64, device="cpu"):
    """init_params with every leaf, biases and the param head included,
    moved by N(0, 0.1^2), as leaves that require grad."""
    g = torch.Generator().manual_seed(seed)
    p = tnet.init_params(g, spec)

    def move(x):
        x = x.detach().double()
        x = x + 0.1 * torch.randn(x.shape, generator=g, dtype=x.dtype)
        return x.to(dtype=dtype, device=device).requires_grad_(True)

    return tnet.tree_map(move, p)


def masks(P: int, B: int, seed: int) -> torch.Tensor:
    """[max(B, P + 1), P] bool: a row with every position active, rows
    with inactive prefixes of 1 to P - 1 positions (P - 2: only t and t+1
    active, P - 1: only t+1, so t itself inactive), a row with holes, then
    random prefixes with holes up to B rows."""
    g = torch.Generator().manual_seed(seed)
    rows = []
    for k in range(P):
        row = torch.ones(P, dtype=torch.bool)
        row[:k] = False
        rows.append(row)
    rows.append(torch.arange(P) % 3 != 1)
    while len(rows) < B:
        row = torch.rand(P, generator=g) > 0.3
        row[:int(torch.randint(0, P, (1,), generator=g))] = False
        rows.append(row)
    return torch.stack(rows)


def window(n_in, W, seed, B=None, dtype=torch.float64, device="cpu"):
    """(xs [B, W + 1, n_in], active [B, W + 1]) with B = W + 2 rows unless
    given more; inactive positions zeroed, as bptt_window zeroes them."""
    P = W + 1
    active = masks(P, B or 0, seed)
    g = torch.Generator().manual_seed(seed + 1)
    xs = torch.randn(active.shape + (n_in,), generator=g,
                     dtype=torch.float64)
    xs = torch.where(active[..., None], xs, torch.zeros_like(xs))
    return xs.to(dtype=dtype, device=device), active.to(device)


def cotangent(spec, B, seed, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(seed + 2)
    return torch.randn((B, spec.total_out), generator=g,
                       dtype=torch.float64).to(dtype=dtype, device=device)


def chain_h(params, spec, xs, active):
    """The top layer's new h at t and t+1 as seq_outputs' loop of
    apply_net computes them (the carry held where inactive)."""
    carry = tnet.init_carry(spec, (xs.shape[0],), xs.device, xs.dtype)
    hs = []
    for p, (x, m) in enumerate(zip(xs.unbind(1), active.unbind(1))):
        _, new = tnet.apply_net(params, spec, x, carry)
        if p >= xs.shape[1] - 2:
            hs.append(new[-1][0])
        carry = tnet.tree_map(lambda a, b: torch.where(m[:, None], a, b),
                              new, carry)
    return hs


def outputs_and_grads(params, spec, xs, active, cot, window_path: bool):
    """(y_t, y_t1, every leaf's gradient in tree order) of the chain
    (base.chain_outputs) or of the window (base.window_outputs)."""
    run = base.window_outputs if window_path else base.chain_outputs
    y_t, y_t1 = run(params, spec, xs, active)
    grads = base.backprop(params, y_t, cot)
    return (y_t.detach(), y_t1,
            [g.clone() for g in tnet.tree_leaves(grads)])
