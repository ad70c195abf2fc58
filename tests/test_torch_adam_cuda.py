"""The Adam kernel on the card (csrc/adam.cu via ops/adam_kernel.py)
against the loop it replaces (models/optim.py::adam_update_plain_ and
adam_advance_plain_), run on the same card.

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package; run it on a machine without them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_adam_cuda.py

The kernel keeps the loop's operations in its order and rounding, so
every check is torch.equal: the params, both moments, beta_t_1, beta_t_2
and step after 200 steps at V-RACER cart-pole's 7 leaves, at a leaf set
that takes three update launches (with a misaligned and an empty leaf),
inside a captured graph replayed 50 times, and through DPG's
split_adam_step. The wrapper raises on what the kernel does not take.
"""
import pytest
import torch

from smarties_tpu_torch.algos import dpg
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.models import optim as topt
from smarties_tpu_torch.ops import adam_kernel, cuda_lib
from smarties_tpu_torch.runtime import graphs

# V-RACER on cart-pole: 5 inputs, [128, 128], V and the mean, one stdev
VRACER_SPEC = dict(n_in=5, hidden=(128, 128), n_out=2, n_param_out=1,
                   param_init=(0.3,), out_bias_init=(0.0, 0.25))
CFGS = {"vracer": dict(eta=1e-4, eps_anneal=5e-7),
        "lambda_anneal": dict(eta=1e-3, lambda_=1e-3, eps_anneal=5e-3),
        "anneal_off": dict(eta=3e-3, lambda_=1e-4, anneal_lr=False)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plain_step(params, grads, state, cfg, gf):
    topt.adam_update_plain_(params, grads, state, cfg, gf)
    topt.adam_advance_plain_(state, cfg)


def _grads(params, gen, k):
    """Ascent gradients of params' shapes: every 7th step ten times larger,
    a tenth of the entries zero."""
    def one(p):
        g = torch.randn(p.shape, generator=gen, device=p.device)
        g = g * (10.0 if k % 7 == 3 else 1.0)
        return torch.where(torch.rand(p.shape, generator=gen,
                                      device=p.device) < 0.1,
                           torch.zeros_like(g), g)
    return tnet.tree_map(one, params)


def _vracer_params(dev):
    return tnet.init_params(torch.Generator().manual_seed(0),
                            tnet.NetSpec(**VRACER_SPEC), dev)


def _assert_equal(a, b):
    la, lb = tnet.tree_leaves(a), tnet.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _clone(params):
    return tnet.tree_map(lambda p: p.detach().clone().requires_grad_(), params)


def _run_both(params, cfg, gf, steps, seed=1):
    """`steps` steps through adam_step (the kernel on CUDA leaves) and
    through the plain loop, from one state and on the same gradients ->
    (kernel params, kernel state, loop params, loop state)."""
    kp, lp = params, _clone(params)
    ks, ls = topt.adam_init(kp), topt.adam_init(lp)
    gen = torch.Generator(tnet.tree_leaves(kp)[0].device).manual_seed(seed)
    for k in range(steps):
        g = _grads(kp, gen, k)
        topt.adam_step(kp, g, ks, cfg, gf)
        _plain_step(lp, g, ls, cfg, gf)
    return kp, ks, lp, ls


def _assert_states_equal(kp, ks, lp, ls):
    _assert_equal(kp, lp)
    _assert_equal(ks.m1, ls.m1)
    _assert_equal(ks.m2, ls.m2)
    for name in ("beta_t_1", "beta_t_2", "step"):
        assert torch.equal(getattr(ks, name), getattr(ls, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", list(CFGS))
def test_kernel_equals_loop_at_vracer_leaves(cuda, cfg):
    """200 steps at V-RACER cart-pole's 7 leaves (17,539 parameters): one
    update and one advance launch a step, bit-equal to the loop."""
    params = _vracer_params(cuda)
    assert [p.numel() for p in tnet.tree_leaves(params)] == \
        [640, 128, 16384, 128, 256, 2, 1]
    cuda_lib.reset_launches()
    kp, ks, lp, ls = _run_both(params, topt.AdamConfig(**CFGS[cfg]),
                               1.0 / 256, 200)
    torch.cuda.synchronize()
    assert adam_kernel.launches == {"adam_update": 200, "adam_advance": 200}
    _assert_states_equal(kp, ks, lp, ls)
    assert int(ks.step) == 200 and float(ks.beta_t_1) == 0.0
    assert 0.0 < float(ks.beta_t_2) < 1.0


@pytest.mark.cuda
def test_kernel_equals_loop_over_several_launches(cuda):
    """150 leaves take three update launches of at most 64 leaves; one
    leaf is empty, several start 4 bytes past a 16-byte boundary (the
    scalar path) and the sizes leave every tail length."""
    per = adam_kernel.LIB.load().smt_adam_max_leaves()
    assert per == 64
    gen = torch.Generator().manual_seed(2)
    sizes = torch.randint(1, 3000, (150,), generator=gen).tolist()
    sizes[5] = 0
    base = torch.randn(sum(sizes) + 150, generator=gen).to(cuda)
    params, off = {}, 0
    for i, n in enumerate(sizes):
        if i % 3 == 1:      # a view one float past an aligned start
            params[f"l{i:03d}"] = base[off + 1:off + 1 + n]
            off += n + 1
        else:
            params[f"l{i:03d}"] = torch.randn(n, generator=gen).to(cuda)
    assert sum(p.data_ptr() % 16 != 0 for p in params.values()) > 20
    cuda_lib.reset_launches()
    kp, ks, lp, ls = _run_both(params, topt.AdamConfig(**CFGS[
        "lambda_anneal"]), 1.0 / 32, 200, seed=3)
    torch.cuda.synchronize()
    assert adam_kernel.launches == {"adam_update": 3 * 200,
                                    "adam_advance": 200}
    _assert_states_equal(kp, ks, lp, ls)


@pytest.mark.cuda
def test_captured_kernel_equals_eager_loop(cuda):
    """adam_step captured in a runtime/graphs.Graph (2 eager warm-up calls,
    the capture, 49 more replays), fed new gradients through its static
    buffer before each call, equals the eager loop on the same gradients;
    the launch counters count the replays."""
    cfg = topt.AdamConfig(**CFGS["vracer"])
    params = _vracer_params(cuda)
    lp = _clone(params)
    ls = topt.adam_init(lp)
    state = {"params": params, "opt": topt.adam_init(params),
             "grads": tnet.tree_map(torch.zeros_like, params)}

    def fn(st):
        topt.adam_step(st["params"], st["grads"], st["opt"], cfg, 1.0 / 256)
        return st, None

    graph = graphs.Graph(fn, state, device=cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    cuda_lib.reset_launches()
    for k in range(graphs.WARMUP_CALLS + 50):
        g = _grads(params, gen, k)
        tnet.tree_copy_(state["grads"], g)
        graph()
        _plain_step(lp, g, ls, cfg, 1.0 / 256)
    torch.cuda.synchronize()
    assert graph.graph is not None
    n = graphs.WARMUP_CALLS + 50
    assert adam_kernel.launches == {"adam_update": n, "adam_advance": n}
    _assert_states_equal(params, state["opt"], lp, ls)


@pytest.mark.cuda
def test_split_adam_step_equals_loop(cuda, monkeypatch):
    """DPG's split Adam (the critic at its own config, every part on the
    one shared beta_t / step): one update launch per part and one advance
    a step, bit-equal to the loop."""
    gen = torch.Generator().manual_seed(5)
    net = {"actor": {"W": torch.randn(6, 32, generator=gen),
                     "b": torch.randn(32, generator=gen)},
           "critic": {"W": torch.randn(7, 32, generator=gen),
                      "b": torch.randn(1, generator=gen)},
           "other": torch.randn(3, generator=gen)}
    net = tnet.tree_map(lambda x: x.to(cuda).requires_grad_(), net)
    ref = _clone(net)
    parts = {None: topt.AdamConfig(eta=1e-3, lambda_=1e-4, eps_anneal=5e-3),
             "critic": topt.AdamConfig(eta=1e-2, lambda_=1e-4,
                                       eps_anneal=5e-3)}
    ko, ro = topt.adam_init(net), topt.adam_init(ref)
    g_gen = torch.Generator(cuda).manual_seed(6)
    grads = [_grads(net, g_gen, k) for k in range(200)]
    cuda_lib.reset_launches()
    for g in grads:
        dpg.split_adam_step(net, g, ko, parts, 1.0 / 64)
    assert adam_kernel.launches == {"adam_update": 400, "adam_advance": 200}
    monkeypatch.setattr(dpg, "adam_update_", topt.adam_update_plain_)
    monkeypatch.setattr(dpg, "adam_advance_", topt.adam_advance_plain_)
    for g in grads:
        dpg.split_adam_step(ref, g, ro, parts, 1.0 / 64)
    torch.cuda.synchronize()
    assert adam_kernel.launches == {"adam_update": 400, "adam_advance": 200}
    _assert_states_equal(net, ko, ref, ro)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "f64", "mixed_device"])
def test_wrapper_raises(cuda, bad):
    params = {"a": torch.zeros(4, 3, device=cuda),
              "b": torch.zeros(5, device=cuda)}
    state = topt.adam_init(params)
    grads = tnet.tree_map(torch.ones_like, params)
    if bad == "non_contiguous":
        grads["a"] = torch.ones(3, 4, device=cuda).t()
    elif bad == "f64":
        params["b"] = params["b"].double()
    else:
        grads["b"] = grads["b"].cpu()
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="adam_kernel"):
        topt.adam_update_(params, grads, state, topt.AdamConfig(), 1.0)
    assert adam_kernel.launches["adam_update"] == 0
