"""The grad step's tail (algos/base.py::step_tail_) on the CPU, and the
arithmetic of its CUDA kernel (csrc/step_tail.cu) emulated in numpy
float32 against the chain it replaces.

On the card tests/test_torch_step_tail_cuda.py holds the kernel itself
against the chain. Here:

- the kernel's scalar operations (update_cmax, the beta / alpha fixed
  point, the max_abs_error EMA), fed the wrapper's own float32 arguments
  (step_tail_kernel.scalar_args), are array_equal to the chain's
  post_step_processing, and its scale_net2v to ops/value_scale.py's;
- step_tail_ on CPU tensors, with or without a mesh, takes the chain
  and gives what the chain's parts give;
- write_back drops invalid rows, as the kernel and the JAX package do;
- the leaf tables that the kernels' wrappers share;
- the wrapper raises on what the kernel does not take before it builds
  or loads anything.

This file imports neither jax nor the JAX package.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tail_cases as cases
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import step_tail_kernel as stk
from smarties_tpu_torch.ops.leaf_table import LeafTables
from smarties_tpu_torch.ops.value_scale import scale_net2v
from smarties_tpu_torch.parallel.mesh import make_mesh
from smarties_tpu_torch.replay import buffer as rb

torch.set_num_threads(1)
f32 = np.float32


def _torch_cpu_sqrt(x):
    """PyTorch's float32 sqrt on the CPU (not correctly rounded on an
    AVX-512 host, while the card's torch.sqrt and the kernel's __fsqrt_rn
    are): the emulation takes the square root from the chain's device."""
    return torch.sqrt(torch.from_numpy(np.array(x, np.float32))).numpy()


def _emulated_scalars(n_stored, n_far, step, beta, alpha, mae, max_err,
                      args):
    """The kernel's post_step_processing in numpy float32, operation by
    operation -> (cmax, cinv, beta, alpha, max_abs_error, frac_off)."""
    clip, eps_anneal, lr_num, max_obs, penal_tol, tol = args
    n_data, nf = f32(n_stored), f32(n_far)
    den = f32(step) * eps_anneal + f32(1)
    cmax = (f32(1) / den) * clip + f32(1)
    frac = nf / max(n_data, f32(1))
    learn_r = (f32(1) / max(n_data, max_obs)) * lr_num

    def fix_point(val, go_to_0):
        kept = (f32(1) - min(learn_r, val)) * val
        return kept if go_to_0 else kept + min(learn_r, f32(1) - val)

    return (cmax, f32(1) / cmax, fix_point(beta, frac > penal_tol),
            fix_point(alpha, abs(penal_tol - frac) < tol),
            mae + learn_r * (max_err - mae), frac)


def _emulated_net2v(x):
    """The kernel's scale_net2v on a float32 array."""
    x = x.astype(f32)
    sqrt = _torch_cpu_sqrt
    pos = (x + f32(51)) * f32(100) - sqrt(x * f32(100) + f32(2601)) * f32(100)
    neg = (x - f32(51)) * f32(100) + sqrt(f32(2601) - x * f32(100)) * f32(100)
    with np.errstate(invalid="ignore"):
        return np.where(x > 0, pos, np.where(x < 0, neg, f32(0)))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(clipImpWeight=0.0, batchSize=256, maxTotObsNum=2 ** 21,
         epsAnneal=5e-7),
    dict(clipImpWeight=1.0, batchSize=17, maxTotObsNum=1000,
         penalTol=0.05),
    dict(clipImpWeight=0.3, batchSize=128, maxTotObsNum=262144,
         epsAnneal=0.0)],
    ids=["default", "no_clip", "odd_batch", "no_anneal"])
def test_tail_scalar_arithmetic_equals_the_chain(kw):
    """60 states each (stored counts below, at and far above
    maxTotObsNum; far fractions on both sides of penalTol and within
    1e-3 of it; beta and alpha near 0, inside and near 1; steps from 0 to
    2^24): the emulated kernel is array_equal to post_step_processing on
    CPU tensors."""
    c = cases.cfg(**kw)
    args = stk.scalar_args(c)
    assert all(type(a) is np.float32 for a in args)
    rng = np.random.RandomState(21)
    E, L = 64, 8
    for k in range(60):
        rs = rb.init_replay(E, L, 1, 1, 2, clip_imp_weight=c.clipImpWeight)
        lens = rng.randint(0, L + 1, E)
        if k % 3 == 2:
            lens[:] = L
        rs.slot_len.copy_(torch.as_tensor(lens, dtype=torch.int32))
        rs.slot_id.copy_(torch.as_tensor(
            np.where(rng.rand(E) < 0.8, np.arange(E), -1), dtype=torch.int32))
        n_stored = int(rs.n_stored_steps())
        if k % 4 == 0:         # the far fraction at penalTol
            n_far = int(round(c.penalTol * n_stored))
        else:
            n_far = rng.randint(0, max(n_stored, 1))
        far = np.zeros(E, np.float32)
        np.add.at(far, rng.randint(0, E, n_far), 1.0)
        rs.far_count.copy_(torch.as_tensor(far))
        beta, alpha = f32(rng.choice([1e-4, 0.3, 0.999, 1.0])), \
            f32(rng.choice([0.0, 0.5, 0.9995]))
        mae = f32(rng.rand() * 3)
        rs.beta.fill_(float(beta))
        rs.alpha.fill_(float(alpha))
        rs.max_abs_error.fill_(float(mae))
        step = int(rng.choice([0, 1, 1000, 123457, 2 ** 24 - 3]))
        delta = torch.as_tensor(rng.randn(c.batchSize) * 2,
                                dtype=torch.float32)
        _, frac = base.post_step_processing(
            rs, c, torch.full((), step, dtype=torch.int32), delta)
        want = _emulated_scalars(n_stored, n_far, step, beta, alpha, mae,
                                 delta.abs().max().numpy(), args)
        got = [x.numpy() for x in (rs.cmax_ret, rs.cinv_ret, rs.beta,
                                   rs.alpha, rs.max_abs_error, frac)]
        for name, x, y in zip(("cmax", "cinv", "beta", "alpha",
                               "max_abs_error", "frac_off"), got, want):
            np.testing.assert_array_equal(x, y, err_msg=f"{name} at {k}")


def test_net2v_arithmetic_equals_scale_net2v():
    """The kernel's scale_net2v, emulated, is array_equal to the chain's
    on 20,000 outputs from -60 to 60, signed zeros and tiny values."""
    rng = np.random.RandomState(22)
    x = np.concatenate([rng.randn(10000) * 3, rng.uniform(-60, 60, 9990),
                        [0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7, 26.01,
                         -26.01, 1e4, -1e4]]).astype(f32)
    want = scale_net2v(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_emulated_net2v(x), want)


def _chain_parts(rs, mb, c, opt_step, grads, rows, mesh=None, net2v=False):
    """Today's tail, written out from its parts (what the learners
    called before step_tail_)."""
    v_next = scale_net2v(rows["v_next"]) if net2v else rows["v_next"]
    rs = base.write_back_with_next(rs, mb, rows["rho"], rows["dkl"],
                                   rows["delta"], rows["value"],
                                   rows["advantage"], v_next)
    rs, frac = base.post_step_processing(rs, c, opt_step, rows["delta"],
                                         mesh)
    m = base.default_metrics(rows["dkl"], rows["rho"], rows["is_far"], frac,
                             rs.beta, rows["delta"], rows["value"], mesh)
    m.update(base.grad_stats(grads))
    return rs, m


def _assert_tails_equal(a, b):
    (ra, ma), (rb_, mb_) = a, b
    for f in cases.TAIL_FIELDS:
        assert torch.equal(getattr(ra, f), getattr(rb_, f)), f
    assert list(ma) == list(mb_) == list(stk.METRICS)
    for k in ma:
        assert torch.equal(ma[k], mb_[k]), k


@pytest.mark.parametrize("net2v", [False, True])
@pytest.mark.parametrize("rows", ["plain", "invalid_and_dup"])
def test_step_tail_on_cpu_takes_the_chain(net2v, rows):
    """CPU tensors take the chain: the kernel is neither built nor
    launched, no launch is counted, and the result is the chain's parts'
    own (replay fields, ReF-ER scalars, metrics in their order). The
    counter is one that a graph replay advances."""
    kw = dict(invalid=3, shared=1, dup=2) if rows != "plain" else {}
    c = cases.cfg()
    rs, mb, r, grads, step = cases.case("cpu", seed=3, **kw)
    ref = cases.clone_replay(rs)
    cuda_lib.reset_launches()
    got = base.step_tail_(rs, mb, c, step, grads, **r, net2v=net2v)
    want = _chain_parts(ref, mb, c, step, grads, r, net2v=net2v)
    _assert_tails_equal(got, want)
    assert stk.launches == {"step_tail": 0, "grad_stats": 0, "finish": 0}
    assert not stk.LIB.loaded
    assert any(stk.launches is c for c in cuda_lib.COUNTERS)


def test_step_tail_under_a_mesh_takes_the_chain(tmp_path):
    """CPU tensors under a mesh (one gloo rank here) take the chain with
    its three collectives: the counts' sum, the largest error and the
    means (a psum over the ranks)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh("cpu")
        c = cases.cfg()
        rs, mb, r, grads, step = cases.case("cpu", seed=4, invalid=2)
        ref = cases.clone_replay(rs)
        cuda_lib.reset_launches()
        got = base.step_tail_(rs, mb, c, step, grads, **r, mesh=mesh)
        assert dict(mesh.counts) == {"psum": 2, "pmax": 1}
        want = _chain_parts(ref, mb, c, step, grads, r)
        _assert_tails_equal(got, want)
        assert sum(stk.launches.values()) == 0 and not stk.LIB.loaded
    finally:
        dist.destroy_process_group()


def test_step_tail_two_ranks_take_the_chain(tmp_path):
    """Two gloo ranks on the CPU, each with a replay and rows of its own:
    step_tail_ under the mesh is the chain under the mesh (its three
    collectives, no launch), and the global scalars and metrics agree
    across the ranks."""
    for o in cases.two_ranks(tmp_path, "cpu"):
        assert sum(o["launches"].values()) == 0
        (fk, mk), (fc, mc) = o["kernel"], o["chain"]
        for f in cases.TAIL_FIELDS:
            assert torch.equal(fk[f], fc[f]), f
        for k in stk.METRICS:
            assert torch.equal(mk[k], mc[k]), k


@pytest.mark.parametrize("kind", ["shared", "empty_slot", "all_invalid"])
def test_write_back_drops_invalid_rows(kind):
    """An invalid row writes no field, also where it shares its (ep, t)
    with a valid row (`shared`: row 31 at row 0's place, which holds row
    0's values after); a batch with no valid row writes nothing. Every
    valid row's values are stored, and far_count moves by the valid
    rows' far-policy changes alone."""
    kw = {"shared": dict(invalid=3, shared=1), "empty_slot":
          dict(invalid=4), "all_invalid": dict(invalid=4, shared=4)}[kind]
    rs, mb, r, _, _ = cases.case("cpu", seed=6, **kw)
    if kind == "all_invalid":
        mb = mb._replace(valid=torch.zeros_like(mb.valid))
    before = cases.clone_replay(rs)
    base.write_back(rs, mb, r["rho"], r["dkl"], r["delta"], r["value"],
                    r["advantage"])
    valid = mb.valid
    tl, epl = mb.t.long(), mb.ep.long()
    for field, row in (("rho_tm", "rho"), ("kl_tm", "dkl"),
                       ("delta_tm", "delta"), ("value_tm", "value"),
                       ("advantage_tm", "advantage")):
        want = getattr(before, field).clone()
        want[tl[valid], epl[valid]] = r[row][valid]
        assert torch.equal(getattr(rs, field), want), field
    was = rb.is_far_policy(mb.rho_old, before.cmax_ret, before.cinv_ret)
    now = rb.is_far_policy(r["rho"], before.cmax_ret, before.cinv_ret)
    far = before.far_count.clone()
    far.index_add_(0, epl[valid], now[valid].float() - was[valid].float())
    assert torch.equal(rs.far_count, far)
    if kind == "shared":
        assert not valid[-1] and (tl[-1], epl[-1]) == (tl[0], epl[0])
        assert rs.rho_tm[tl[0], epl[0]] == r["rho"][0]
    if kind == "all_invalid":
        for f in cases.TAIL_FIELDS:
            assert torch.equal(getattr(rs, f), getattr(before, f)), f


def test_leaf_tables():
    """A table is made once per set of pointers and sizes, with what
    `derive` adds, and the least recently used set leaves first."""
    made = []

    def derive(sizes):
        made.append(tuple(sizes))
        return (sum(sizes),)

    tables = LeafTables(size=2)
    a = tables.get([16, 32], [3, 4], derive)
    assert list(a[0]) == [16, 32] and list(a[1]) == [3, 4]
    assert a[2:] == (2, 7)
    assert tables.get([16, 32], [3, 4], derive) is a
    tables.get([16, 48], [3, 4], derive)
    tables.get([16, 32], [3, 4], derive)        # a is the newest again
    tables.get([8], [1], derive)                # evicts [16, 48]
    assert len(tables) == 2 and made == [(3, 4), (3, 4), (1,)]
    assert tables.get([16, 32], [3, 4], derive) is a
    tables.get([16, 48], [3, 4], derive)
    assert made[-1] == (3, 4) and len(made) == 4
    empty = tables.get([], [], lambda sizes: (1, 1))
    assert empty[2:] == (0, 1, 1)


def test_grad_parts():
    """grad_stats' partials and launches: a block per STAT_ELEMS elements
    of each leaf, one launch per MAX_LEAVES leaves, each at least one
    block."""
    assert stk.grad_parts([640, 128, 16384, 128, 256, 2, 1]) == (10, 1)
    assert stk.grad_parts([0, 0]) == (1, 1)
    assert stk.grad_parts([]) == (1, 1)
    assert stk.grad_parts([5000] * 150) == (300, 3)
    assert stk.grad_parts([0] * 64 + [1]) == (2, 2)


def _bad(name, rs, mb, r, grads, step):
    """Replace one input by what the kernel does not take."""
    if name == "f64_field":
        rs.kl_tm = rs.kl_tm.double()
    elif name == "non_contiguous_field":
        rs.delta_tm = rs.delta_tm.t().contiguous().t()
    elif name == "two_devices":
        rs.far_count = torch.zeros_like(rs.far_count, device="meta")
    elif name == "i64_slot_len":
        rs.slot_len = rs.slot_len.long()
    elif name == "f64_scalar":
        rs.beta = rs.beta.double()
    elif name == "i64_step":
        step = step.long()
    elif name == "short_row":
        r["dkl"] = r["dkl"][:-1]
    elif name == "f32_valid":
        mb = mb._replace(valid=mb.valid.float())
    elif name == "f32_ep":
        mb = mb._replace(ep=mb.ep.float())
    elif name == "non_contiguous_grad":
        grads["W"] = grads["W"].t()
    return rs, mb, r, grads, step


@pytest.mark.parametrize("bad", [
    "f64_field", "non_contiguous_field", "two_devices", "i64_slot_len",
    "f64_scalar", "i64_step", "short_row", "f32_valid", "f32_ep",
    "non_contiguous_grad", "cpu"])
def test_step_tail_kernel_refuses(bad):
    """The wrapper raises on what the kernel does not take, and on CPU
    tensors, before any build or launch: there is no fallback."""
    rs, mb, r, grads, step = _bad(bad, *cases.case("cpu", seed=5))
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="step_tail_kernel"):
        stk.tail_(rs, mb, cases.cfg(), step, grads, **r)
    assert sum(stk.launches.values()) == 0
    assert not stk.LIB.loaded
