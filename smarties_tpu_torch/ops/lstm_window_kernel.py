"""The LSTM's truncated-BPTT window as hand-written CUDA: one persistent
forward launch, one persistent backward launch and a fixed-order sum.

`lstm_window(xs, active, layers) -> (h_t, h_t1)` runs a stack of
smarties' LSTM layers (models/net.py: gates c, i, f, o, Layer_LSTM.h)
over the window that algos/base.py::bptt_window gathers, xs [B, P, n_in]
with P = W + 1, from a zero carry that is held where `active` [B, P] is
False, as algos/base.py::seq_outputs holds it (the mask is general, not
a prefix). h_t is the top layer's output at the sampled step (position
P - 2) and takes a gradient; h_t1, its output at t + 1 (P - 1), takes
none. With grad enabled and a leaf that requires it, the window is a
`torch.autograd.Function` whose backward hands every leaf of `layers` its
gradient (xs takes none); otherwise the forward saves nothing.

On the card it runs csrc/lstm_window.cu (its header has the design):
the forward launch writes h_t, h_t1 and, for the backward, the gates and
c of every (row, position, layer) into `saved` [B, P, 5 sum(hidden)]
with the last active position before each (`prev` [B, P]); the backward
launch walks the window in reverse, records each step's gate gradients
and cell inputs (`hist` [B, P - 1, record_floats]) and, after the walk,
sums them into each row's weight gradients (`part` [B, weights]); a
third launch sums those over the rows in row order into the leaves'
gradients, packed in the leaves' order (LEAVES, layer after layer). No
float atomics: two calls are bit-equal, and so are a captured replay and
an eager call.

On the CPU it runs the plain version of the same algorithm
(`forward_plain`, `backward_plain`): the same saved gates and carry
positions, the hand-derived reverse pass, the rows' sums added in row
order; the tests hold it against the autograd chain of seq_outputs in
float64. The CPU takes float32 and float64, the card float32.

`takes(spec)` says whether a net's window comes here (algos/base.py::
seq_outputs dispatches on it and on the tensors' device): an LSTM with
no conv stack, 1 to MAX_LAYERS layers, 4 x its widest layer <= 1024
threads a block, and a backward block's shared memory (`smem_bytes`:
the leaves, padded, and a few vectors) within the card's 227 KB. LSTM
[32, 32] fits over n_in up to 324, [32, 32, 32] up to 228, [48, 48] up
to 116, [64] up to 132, [64, 64] up to 4; [128] does not. The wrapper
raises on what the kernel does not take (`check_inputs`: dtype,
contiguity, devices, shapes, xs requiring grad), before any build;
there is no fallback.
`launches` counts the forward, backward and reduce launches;
runtime/graphs.py counts them over replays.

Build: at first use, never at import, through ops/cuda_lib.py.
"""
from __future__ import annotations

import ctypes

import torch

from smarties_tpu_torch.ops.cuda_lib import Library

launches = {"forward": 0, "backward": 0, "reduce": 0}
# a layer's leaves, in the kernel's packed order
LEAVES = tuple(f"{k}{g}" for k in "WRb" for g in "cifo")
# csrc/lstm_window.cu's kMaxLayers, kMaxThreads; a block's shared memory
# on the H100 (227 KB)
MAX_LAYERS = 8
MAX_THREADS = 1024
SMEM_BYTES = 232448


def _check_library(lib):
    if lib.smt_lstm_window_max_layers() != MAX_LAYERS:
        raise RuntimeError(f"lstm_window_kernel: the library's "
                           f"{lib.smt_lstm_window_max_layers()} layers "
                           f"differ from the wrapper's {MAX_LAYERS}")
    for n_in, hidden in ((3, (32, 32)), (5, (16, 24)), (64, (8,))):
        widths = (ctypes.c_int * len(hidden))(*hidden)
        if lib.smt_lstm_window_record(widths, len(hidden), n_in) != \
                record_floats(n_in, hidden):
            raise RuntimeError(
                f"lstm_window_kernel: the library's step record differs "
                f"from the wrapper's at {hidden} over {n_in}")
        for backward in (False, True):
            got = lib.smt_lstm_window_smem(widths, len(hidden), n_in,
                                           int(backward))
            if got != smem_bytes(n_in, hidden, backward):
                raise RuntimeError(
                    f"lstm_window_kernel: the library's shared memory "
                    f"{got} B differs from the wrapper's "
                    f"{smem_bytes(n_in, hidden, backward)} B at {hidden} "
                    f"over {n_in}")


_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = Library(
    "smt_lstm_window", ("lstm_window.cu",),
    ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
    {"smt_lstm_window_forward": [_P, _P, _I, _I, _I, _I] + [_P] * 7,
     "smt_lstm_window_backward": [_P, _P, _I, _I, _I, _I] + [_P] * 8,
     "smt_lstm_window_smem": [_P, _I, _I, _I],
     "smt_lstm_window_record": [_P, _I, _I],
     "smt_lstm_window_max_layers": []},
    counters=(launches,), check=_check_library)


def n_weights(n_in: int, hidden) -> int:
    """Floats of every layer's leaves: 4 H (in + H + 1) a layer."""
    total, nin = 0, n_in
    for h in hidden:
        total += 4 * h * (nin + h + 1)
        nin = h
    return total


def record_floats(n_in: int, hidden) -> int:
    """Floats of one backward step's record: per layer its 4H gate
    gradients and its cell's in + H inputs, padded to a multiple of 4."""
    total, nin = 0, n_in
    for h in hidden:
        total += -(-(4 * h + nin + h) // 4) * 4
        nin = h
    return total


def smem_bytes(n_in: int, hidden, backward: bool) -> int:
    """Shared memory of one block of the forward or the backward launch
    (csrc/lstm_window.cu's net_of, forward_floats, backward_floats). A
    layer's leaves are 4H rows of in + H words, padded to a stride equal
    to the lanes a unit takes (mod 32), and 4H biases. Forward: the
    leaves, each layer's [input, carry h], the top layer's new h, the
    carry's c, the gates. Backward: the leaves (after the walk, the step
    records), three positions' saved blocks and inputs, a cell's [x,
    h_prev], the gates' and the input's gradients, a partial sum a
    thread, the carry's h and c gradients."""
    h_max, sum_h = max(hidden), sum(hidden)
    lanes = 4 if 16 * h_max <= MAX_THREADS else (
        2 if 8 * h_max <= MAX_THREADS else 1)
    threads = -(-4 * h_max * lanes // 32) * 32
    rows = total_n = n_max = 0
    nin = n_in
    for h in hidden:
        n = nin + h
        rows += 4 * h * (n + (lanes - n) % 32) + 4 * h
        total_n += n
        n_max = max(n_max, n)
        nin = h
    if backward:
        floats = (rows + 3 * (5 * sum_h + n_in) + n_max + 5 * h_max
                  + threads + 2 * sum_h)
    else:
        floats = rows + total_n + hidden[-1] + sum_h + 4 * h_max
    return 4 * floats


def takes(spec) -> bool:
    """Whether the kernel runs this NetSpec's window (the module
    docstring): a pure function of its kind, conv stack, widths and
    n_in."""
    return (spec.kind == "LSTM" and not spec.conv
            and 0 < len(spec.hidden) <= MAX_LAYERS
            and 4 * max(spec.hidden) <= MAX_THREADS
            and smem_bytes(spec.n_in, spec.hidden, True) <= SMEM_BYTES)


def _fail(msg):
    raise ValueError(f"lstm_window_kernel: {msg}")


def check_inputs(xs, active, leaves) -> tuple:
    """Raise where the window does not take these inputs -> the widths.
    leaves: LEAVES of each layer, layer after layer."""
    if xs.dim() != 3 or xs.shape[0] < 1 or xs.shape[1] < 2 \
            or xs.shape[2] < 1:
        _fail(f"xs is a {tuple(xs.shape)}; the window takes [B, P, n_in] "
              f"with B >= 1, P >= 2 positions and n_in >= 1")
    if xs.requires_grad:
        _fail("xs requires grad; the window gives the net's input none")
    B, P, n_in = xs.shape
    dev, dtype = xs.device, xs.dtype
    allowed = (torch.float32,) if dev.type == "cuda" else (torch.float32,
                                                           torch.float64)
    if dtype not in allowed:
        _fail(f"xs is {dtype} on {dev}; the window takes "
              f"{', '.join(map(str, allowed))} there")
    if not len(leaves) or len(leaves) % len(LEAVES) \
            or len(leaves) // len(LEAVES) > MAX_LAYERS:
        _fail(f"{len(leaves)} leaves; the window takes {len(LEAVES)} a "
              f"layer, 1 to {MAX_LAYERS} layers")
    hidden = tuple(int(leaves[i].shape[-1])
                   for i in range(0, len(leaves), len(LEAVES)))
    if 4 * max(hidden) > MAX_THREADS:
        _fail(f"widths {hidden}: 4 x the widest exceeds a block's "
              f"{MAX_THREADS} threads")
    if dev.type == "cuda" and smem_bytes(n_in, hidden, True) > SMEM_BYTES:
        _fail(f"widths {hidden} over {n_in} inputs need "
              f"{smem_bytes(n_in, hidden, True)} B of shared memory a "
              f"block; the card has {SMEM_BYTES}")
    tensors = [("xs", xs, (B, P, n_in), dtype),
               ("active", active, (B, P), torch.bool)]
    nin = n_in
    for li, h in enumerate(hidden):
        for k, name in enumerate(LEAVES):
            shape = ((nin, h),) * 4 + ((h, h),) * 4 + ((h,),) * 4
            tensors.append((f"layer {li} {name}",
                            leaves[li * len(LEAVES) + k], shape[k], dtype))
        nin = h
    for name, x, shape, want in tensors:
        if tuple(x.shape) != shape or x.dtype != want or x.device != dev \
                or not x.is_contiguous():
            _fail(f"{name} is a {tuple(x.shape)} {x.dtype} on {x.device} "
                  f"(contiguous: {x.is_contiguous()}); the window takes a "
                  f"contiguous {want} {shape} on {dev}")
    return hidden


# ---------------- the plain version ----------------

def _layer_leaves(leaves, li):
    k = len(LEAVES)
    ls = leaves[li * k:(li + 1) * k]
    return ls[0:4], ls[4:8], ls[8:12]


def forward_plain(xs, active, leaves, save: bool = True):
    """The kernel's forward over all rows at once -> (h_t, h_t1, saved,
    prev), saved and prev as the kernel writes them (None without
    `save`); every position is computed, and those the kernel skips are
    read by nothing."""
    B, P, _ = xs.shape
    hidden = [int(leaves[i].shape[-1])
              for i in range(0, len(leaves), len(LEAVES))]
    hc = [xs.new_zeros((B, h)) for h in hidden]
    cc = [xs.new_zeros((B, h)) for h in hidden]
    saved = xs.new_zeros((B, P, 5 * sum(hidden))) if save else None
    prev = torch.empty((B, P), dtype=torch.int32, device=xs.device)
    last = torch.full((B,), -1, dtype=torch.int32, device=xs.device)
    outs = []
    for p in range(P):
        on = active[:, p]
        prev[:, p] = last
        x = xs[:, p]
        off = 0
        for li, h in enumerate(hidden):
            W, R, b = _layer_leaves(leaves, li)
            pre = [b[g] + x @ W[g] + hc[li] @ R[g] for g in range(4)]
            z = torch.tanh(pre[0])
            i, f, o = (torch.sigmoid(a) for a in pre[1:])
            c = f * cc[li] + i * z
            x = o * torch.tanh(c)
            if save:
                saved[:, p, 5 * off:5 * (off + h)] = torch.cat(
                    [z, i, f, o, c], dim=1)
            cc[li] = torch.where(on[:, None], c, cc[li])
            hc[li] = torch.where(on[:, None], x, hc[li])
            off += h
        last = torch.where(on, torch.full_like(last, p), last)
        if p >= P - 2:
            outs.append(x)
    return outs[0], outs[1], saved, (prev if save else None)


def backward_plain(xs, active, leaves, saved, prev, g_t) -> list:
    """The kernel's backward and reduce over all rows at once: the
    gradient of <h_t, g_t> for each leaf, in the leaves' order. Each
    row's sums first, then the rows added in row order."""
    B, P, _ = xs.shape
    hidden = [int(leaves[i].shape[-1])
              for i in range(0, len(leaves), len(LEAVES))]
    offs = [sum(hidden[:li]) for li in range(len(hidden))]
    top = len(hidden) - 1
    rows = torch.arange(B, device=xs.device)
    dh = [xs.new_zeros((B, h)) for h in hidden]
    dc = [xs.new_zeros((B, h)) for h in hidden]
    part = [xs.new_zeros((B,) + tuple(leaf.shape)) for leaf in leaves]

    def cell(s, li):
        h = hidden[li]
        return s[:, 5 * offs[li]:5 * (offs[li] + h)].split(h, dim=1)

    for p in range(P - 2, -1, -1):
        on = active[:, p, None]
        q = prev[:, p].long()
        has = (q >= 0)[:, None]
        sp, sq = saved[:, p], saved[rows, q.clamp(min=0)]
        dxup = None
        for li in range(top, -1, -1):
            z, i, f, o, c = cell(sp, li)
            if li == 0:
                x = xs[:, p]
            else:
                below = cell(sp, li - 1)
                x = below[3] * torch.tanh(below[4])
            carry = cell(sq, li)
            zero = torch.zeros_like(c)
            hp = torch.where(has, carry[3] * torch.tanh(carry[4]), zero)
            cp = torch.where(has, carry[4], zero)
            dhn = torch.where(on, dh[li], zero)
            if li < top:
                dhn = dhn + dxup
            elif p == P - 2:
                dhn = dhn + g_t
            dcn = torch.where(on, dc[li], zero)
            tc = torch.tanh(c)
            dct = dcn + dhn * o * (1 - tc * tc)
            dpre = [dct * i * (1 - z * z), dct * z * i * (1 - i),
                    dct * cp * f * (1 - f), dhn * tc * o * (1 - o)]
            dc[li] = torch.where(on, zero, dc[li]) + dct * f
            W, R, _ = _layer_leaves(leaves, li)
            base = li * len(LEAVES)
            for g in range(4):
                part[base + g] += x[:, :, None] * dpre[g][:, None, :]
                part[base + 4 + g] += hp[:, :, None] * dpre[g][:, None, :]
                part[base + 8 + g] += dpre[g]
            if li > 0:
                dxup = sum(dpre[g] @ W[g].T for g in range(4))
            dhp = sum(dpre[g] @ R[g].T for g in range(4))
            dh[li] = torch.where(on, zero, dh[li]) + dhp
    flat = torch.cat([x.reshape(B, -1) for x in part], dim=1)
    total = torch.zeros_like(flat[0])
    for b in range(B):
        total = total + flat[b]
    return _unpack(total, leaves)


def _unpack(flat, leaves) -> list:
    """The packed gradients as one view a leaf, of the leaf's shape."""
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel()
        out.append(flat[off:off + n].view(leaf.shape))
        off += n
    return out


# ---------------- the launches ----------------

def _tables(leaves, hidden):
    return ((ctypes.c_void_p * len(leaves))(*(x.data_ptr() for x in leaves)),
            (ctypes.c_int * len(hidden))(*hidden))


def _forward(xs, active, leaves, hidden, save: bool):
    if xs.device.type != "cuda":
        return forward_plain(xs, active, leaves, save)
    B, P, n_in = xs.shape
    dev = xs.device
    h_t = torch.empty((B, hidden[-1]), dtype=torch.float32, device=dev)
    h_t1 = torch.empty_like(h_t)
    saved = prev = None
    if save:
        saved = torch.empty((B, P, 5 * sum(hidden)), dtype=torch.float32,
                            device=dev)
        prev = torch.empty((B, P), dtype=torch.int32, device=dev)
    ptrs, widths = _tables(leaves, hidden)
    LIB.launch("lstm_window_kernel", dev, "smt_lstm_window_forward", ptrs,
               widths, len(hidden), n_in, B, P, xs.data_ptr(),
               active.data_ptr(), h_t.data_ptr(), h_t1.data_ptr(),
               None if saved is None else saved.data_ptr(),
               None if prev is None else prev.data_ptr())
    launches["forward"] += 1
    return h_t, h_t1, saved, prev


def _backward(xs, active, leaves, hidden, saved, prev, g_t) -> list:
    if xs.device.type != "cuda":
        return backward_plain(xs, active, leaves, saved, prev, g_t)
    B, P, n_in = xs.shape
    dev = xs.device
    if tuple(g_t.shape) != (B, hidden[-1]) or g_t.dtype != torch.float32 \
            or g_t.device != dev:
        _fail(f"the cotangent of h_t is a {tuple(g_t.shape)} {g_t.dtype} "
              f"on {g_t.device}; the window takes a float32 "
              f"{(B, hidden[-1])} on {dev}")
    g_t = g_t.contiguous()
    nw = n_weights(n_in, hidden)
    hist = torch.empty((B, P - 1, record_floats(n_in, hidden)),
                       dtype=torch.float32, device=dev)
    part = torch.empty((B, nw), dtype=torch.float32, device=dev)
    grads = torch.empty((nw,), dtype=torch.float32, device=dev)
    ptrs, widths = _tables(leaves, hidden)
    LIB.launch("lstm_window_kernel", dev, "smt_lstm_window_backward", ptrs,
               widths, len(hidden), n_in, B, P, xs.data_ptr(),
               g_t.data_ptr(), saved.data_ptr(),
               prev.data_ptr(), hist.data_ptr(), part.data_ptr(),
               grads.data_ptr())
    launches["backward"] += 1
    launches["reduce"] += 1
    return _unpack(grads, leaves)


class _Window(torch.autograd.Function):
    """The window with its hand-derived backward (the module docstring)."""

    @staticmethod
    def forward(ctx, xs, active, hidden, *leaves):
        h_t, h_t1, saved, prev = _forward(xs, active, leaves, hidden, True)
        ctx.hidden = hidden
        ctx.save_for_backward(xs, active, saved, prev, *leaves)
        ctx.mark_non_differentiable(h_t1)
        return h_t, h_t1

    @staticmethod
    def backward(ctx, g_t, _g_t1):
        xs, active, saved, prev, *leaves = ctx.saved_tensors
        grads = _backward(xs, active, leaves, ctx.hidden, saved, prev, g_t)
        return (None, None, None, *grads)


def lstm_window(xs, active, layers):
    """(h_t, h_t1) of the LSTM layers `layers` (params["layers"]: dicts of
    LEAVES) over the window xs [B, P, n_in], active [B, P] (the module
    docstring)."""
    leaves = [layer[k] for layer in layers for k in LEAVES]
    hidden = check_inputs(xs, active, leaves)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        return _Window.apply(xs, active, hidden, *leaves)
    return _forward(xs, active, leaves, hidden, False)[:2]
