"""The one-pass AdamW kernel (``ops/cuda_adamw.py``, ``csrc/fused_adamw.cu``)
against the plain loop of ops it replaces on the card.

On the card (marker ``cuda``; each test skips without a GPU): over 3
updates, with the clip engaged and not, for leaves in f32 and in bf16
(g, p, mu and nu of one dtype), on leaves of 1, 7, 4,095, 4,097 and
2**20 + 3 elements and on leaves whose storage offset breaks 16-byte
alignment, p, mu and nu equal the plain loop's bit for bit: the kernel
repeats the loop's ops and roundings (no tolerance). One launch a leaf an
update; a non-contiguous g is taken, a float64 leaf, a g of another dtype
than its leaf or a non-contiguous state raises. The file imports no JAX, so it runs on the card as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_adamw.py

On the CPU: leaves on the CPU take the plain loop and launch nothing, and
the plain loop equals, bit for bit, the loop inside ``default_optimizer``
that it was moved from (kept below as ``_loop_before``); the wrapper
refuses what the kernel does not take before any launch, and an empty
leaf launches nothing (fake CUDA tensors).
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ray_tpu_torch import parallel
from ray_tpu_torch.ops import cuda_adamw

F32, BF16 = torch.float32, torch.bfloat16
SIZES = (1, 7, 4095, 4097, 2**20 + 3)
UNALIGNED = 4097     # this leaf's g and state start 1 element into their buffers


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _hp(count: int, lr: float = 1e-2) -> cuda_adamw.AdamWStep:
    """The numbers ``default_optimizer``'s update hands over at ``count``."""
    b1, b2 = 0.9, 0.95
    bc1 = 1.0 - float(torch.tensor(b1, dtype=F32) ** count)
    bc2 = 1.0 - float(torch.tensor(b2, dtype=F32) ** count)
    return cuda_adamw.AdamWStep(1.0, b1, b2, 1e-8, 0.1, lr, bc1, bc2)


def _offset(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous view one element into a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


def _leaves(sizes, dtype, gen, dev, unaligned=()):
    """Random p, mu and nu (nu > 0) for each size, as lists."""
    def make(n, pos):
        t = torch.randn(n, generator=gen, device=dev)
        t = (t.abs() * 1e-3 if pos else t).to(dtype)
        return _offset(t) if n in unaligned else t
    return ([make(n, False) for n in sizes], [make(n, False) for n in sizes],
            [make(n, True) for n in sizes])


def _grads(sizes, dtype, gen, dev, scale, unaligned=()):
    gs = [(torch.randn(n, generator=gen, device=dev) * scale).to(dtype) for n in sizes]
    return [_offset(g) if g.numel() in unaligned else g for g in gs]


def _first_difference(a: torch.Tensor, b: torch.Tensor) -> str:
    i = int((a != b).nonzero()[0, 0])
    return f"element {i} of {a.numel()}: {a[i].item()!r} against {b[i].item()!r}"


@pytest.mark.cuda
@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_kernel_equals_the_plain_loop_bit_for_bit(dev, dtype, clipped):
    gen = torch.Generator(device=dev).manual_seed(21)
    ps, mus, nus = _leaves(SIZES, dtype, gen, dev, unaligned=(UNALIGNED,))
    assert ps[SIZES.index(UNALIGNED)].data_ptr() % 16 != 0
    ref = [[t.clone() for t in ts] for ts in (ps, mus, nus)]
    p0 = ps[-1].clone()
    for count in (1, 2, 3):
        gs = _grads(SIZES, dtype, gen, dev, 1.0 if clipped else 1e-4, unaligned=(UNALIGNED,))
        gnorm = parallel.global_norm(gs)
        assert bool(gnorm >= 1.0) == clipped
        before = cuda_adamw.fused_adamw.launches
        cuda_adamw.adamw_update(gs, ps, mus, nus, gnorm, _hp(count))
        assert cuda_adamw.fused_adamw.launches - before == len(SIZES)
        cuda_adamw.adamw_update_plain(gs, *ref, gnorm, _hp(count))
    torch.cuda.synchronize()
    for name, got, want in zip(("p", "mu", "nu"), (ps, mus, nus), ref):
        for n, a, b in zip(SIZES, got, want):
            assert a.dtype == dtype
            assert torch.equal(a, b), f"{name} of the {n}-element leaf: {_first_difference(a, b)}"
    assert not torch.equal(ps[-1], p0)


@pytest.mark.cuda
def test_default_optimizer_launches_once_a_leaf_an_update(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    params = {"w": torch.randn(64, 48, generator=gen, device=dev),
              "blocks": [torch.randn(4097, generator=gen, device=dev).bfloat16(),
                         torch.randn(3, generator=gen, device=dev)]}
    leaves = parallel.tree_leaves(params)
    opt = parallel.default_optimizer(1e-2, warmup_steps=0)
    state = opt.init(params)
    before = cuda_adamw.fused_adamw.launches
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype) for p in leaves]
        state, gnorm = opt.update(grads, state, params)
    assert cuda_adamw.fused_adamw.launches - before == 3 * len(leaves)
    assert state.count == 3 and gnorm.device.type == "cuda"


@pytest.mark.cuda
def test_a_non_contiguous_g_is_taken(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    ps, mus, nus = _leaves((64 * 48,), F32, gen, dev)
    ps, mus, nus = ([t.view(48, 64)] for t in (ps[0], mus[0], nus[0]))
    ref = [[t.clone()] for t in (ps[0], mus[0], nus[0])]
    gs = [torch.randn(64, 48, generator=gen, device=dev).T]
    assert not gs[0].is_contiguous()
    gnorm = parallel.global_norm(gs)
    cuda_adamw.adamw_update(gs, ps, mus, nus, gnorm, _hp(1))
    cuda_adamw.adamw_update_plain(gs, *ref, gnorm, _hp(1))
    for got, want in zip((ps, mus, nus), ref):
        assert torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_what_the_kernel_does_not_take_raises_on_the_card(dev):
    gnorm = torch.ones((), device=dev)
    d = [torch.zeros(8, dtype=torch.float64, device=dev) for _ in range(4)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_adamw.adamw_update(d[:1], d[1:2], d[2:3], d[3:], gnorm, _hp(1))
    g16 = torch.zeros(8, 8, dtype=BF16, device=dev)
    with pytest.raises(ValueError, match="one dtype a leaf"):
        cuda_adamw.adamw_update([g16], *([torch.zeros(8, 8, device=dev)] for _ in range(3)),
                                gnorm, _hp(1))
    p = torch.zeros(8, 8, device=dev)
    for bad in ("p", "mu", "nu"):
        leaf = {k: torch.zeros(8, 8, device=dev) for k in ("p", "mu", "nu")}
        leaf[bad] = leaf[bad].T
        with pytest.raises(ValueError, match=f"{bad} must be contiguous"):
            cuda_adamw.adamw_update([p], [leaf["p"]], [leaf["mu"]], [leaf["nu"]], gnorm,
                                    _hp(1))


# ------------------------------------------------------------------- the CPU


def _scalar(x, dtype):
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def _loop_before(gs, ps, mus, nus, gnorm, hp):
    """The per-leaf loop as ``default_optimizer.update`` ran it before the
    kernel, each scalar rounded inside the loop."""
    keep = gnorm < hp.grad_clip
    one = torch.ones((), device=gnorm.device)
    for g, p, mu, nu in zip(gs, ps, mus, nus):
        dt = p.dtype
        g = (g / torch.where(keep, one, gnorm).to(dt)
             * torch.where(keep, one, _scalar(hp.grad_clip, dt)).to(dt))
        mu.mul_(_scalar(hp.b1, dt)).add_(g * _scalar(1 - hp.b1, dt))
        nu.mul_(_scalar(hp.b2, dt)).add_(g.square().mul_(_scalar(1 - hp.b2, dt)))
        u = mu / _scalar(hp.bc1, dt)
        u /= (nu / _scalar(hp.bc2, dt)).sqrt_().add_(_scalar(hp.eps, dt))
        u.add_(p * _scalar(hp.weight_decay, dt))
        p.add_(u.mul_(_scalar(-hp.lr, dt)))


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_cpu_leaves_take_the_plain_loop_and_launch_nothing(dtype, clipped):
    gen = torch.Generator().manual_seed(7)
    sizes = (1, 7, 4097)
    params = {str(n): t for n, t in zip(sizes, _leaves(sizes, dtype, gen, "cpu")[0])}
    opt = parallel.default_optimizer(1e-2, warmup_steps=0)
    state = opt.init(params)
    ref = [[t.clone() for t in parallel.tree_leaves(tree)]
           for tree in (params, state.mu, state.nu)]
    before = cuda_adamw.fused_adamw.launches
    for count in (1, 2, 3):
        gs = _grads(sizes, dtype, gen, "cpu", 1.0 if clipped else 1e-4)
        state, gnorm = opt.update(gs, state, params)
        assert bool(gnorm >= 1.0) == clipped
        _loop_before(gs, *ref, gnorm, _hp(count, lr=opt.learning_rate(count - 1)))
    assert cuda_adamw.fused_adamw.launches == before
    for tree, want in zip((params, state.mu, state.nu), ref):
        for a, b in zip(parallel.tree_leaves(tree), want):
            assert a.dtype == dtype and torch.equal(a, b)


def _fake_cuda(*specs):
    """Fake CUDA tensors (no card needed): (shape, dtype, strides or None)."""
    with FakeTensorMode():
        return [torch.empty_strided(shape, strides, dtype=dt, device="cuda") if strides
                else torch.empty(shape, dtype=dt, device="cuda") for shape, dt, strides in specs]


@pytest.mark.parametrize("case,match", [
    ("f64 leaf", "float32 or bfloat16"),
    ("f16 leaf", "float32 or bfloat16"),
    ("f64 grads", "one dtype a leaf"),
    ("bf16 grads, f32 leaf", "one dtype a leaf"),
    ("mixed state", "one dtype a leaf"),
    ("p non-contiguous", "p must be contiguous"),
    ("mu non-contiguous", "mu must be contiguous"),
    ("nu non-contiguous", "nu must be contiguous"),
    ("norm not 0-d", "0-d float32"),
    ("norm in bf16", "0-d float32"),
    ("norm on the CPU", "the global norm on cpu"),
    ("sizes differ", "has 12 elements"),
])
def test_the_wrapper_refuses_before_any_launch(case, match):
    leaf = {"g": ((4, 4), F32, None), "p": ((4, 4), F32, None), "mu": ((4, 4), F32, None),
            "nu": ((4, 4), F32, None), "norm": ((), F32, None)}
    change = {"f64 leaf": {k: ((4, 4), torch.float64, None) for k in ("p", "mu", "nu")},
              "f16 leaf": {k: ((4, 4), torch.float16, None) for k in ("p", "mu", "nu")},
              "f64 grads": {"g": ((4, 4), torch.float64, None)},
              "bf16 grads, f32 leaf": {"g": ((4, 4), BF16, None)},
              "mixed state": {"mu": ((4, 4), BF16, None)},
              "p non-contiguous": {"p": ((4, 4), F32, (1, 4))},
              "mu non-contiguous": {"mu": ((4, 4), F32, (1, 4))},
              "nu non-contiguous": {"nu": ((4, 4), F32, (1, 4))},
              "norm not 0-d": {"norm": ((1,), F32, None)},
              "norm in bf16": {"norm": ((), BF16, None)},
              "sizes differ": {"g": ((3, 4), F32, None)}}.get(case, {})
    leaf.update(change)
    g, p, mu, nu, norm = _fake_cuda(*(leaf[k] for k in ("g", "p", "mu", "nu", "norm")))
    if case == "norm on the CPU":
        norm = torch.ones(())
    before = cuda_adamw.fused_adamw.launches
    with pytest.raises(ValueError, match=match):
        cuda_adamw.adamw_update([g], [p], [mu], [nu], norm, _hp(1))
    assert cuda_adamw.fused_adamw.launches == before


def test_an_empty_leaf_launches_nothing():
    g, p, mu, nu, norm = _fake_cuda(*(((0,), F32, None),) * 4, ((), F32, None))
    before = cuda_adamw.fused_adamw.launches
    cuda_adamw.adamw_update([g], [p], [mu], [nu], norm, _hp(1))
    assert cuda_adamw.fused_adamw.launches == before
