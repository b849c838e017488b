"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the kernels take bf16 inputs and accumulate in f32; the plain
versions run in f32 on the same bf16 values with TF32 off. Attention
rounds P to bf16 before the P.V product (as the reference kernel does)
and writes o in bf16, hence atol 2e-2 on o for unit-variance inputs, and
1e-2 on each row's error relative to the row's norm (late causal rows
average many values and are small); lse and the CE outputs differ only by
the order of f32 sums, hence 1e-3. The attention forward and backward and
the CE backward are held bit for bit over two runs (no atomics). The backward
kernels round p and dS (attention) or dlog (CE) to bf16 where the reference does and write bf16;
their plain versions run in f32 from the same bf16 values, so each output
row (dq, dk, dv, dlog, dx and dW along their last axis) is held at 1e-2
relative to its norm (floored at 1e-3 of the largest row norm, for rows
that cancel to ~0). The dK/dV kernel sums the GQA group in f32 and
rounds once, as its plain version does (the reference rounds per head).
The LLAMA_TINY training path in bf16, kernels against the plain paths,
is held per parameter tensor at ||g_k - g_p|| / ||g_p|| <= 5e-2, and so
is a 2-layer MoE at hd 128 with its routing pinned to the plain path's
(``chip_smoke.moe_routing``): top-k routing is discontinuous, and
without the pin the bf16 differences of the two attention paths send
some tokens to other experts (PERF.md). moe_ffn in f32 on the card
against itself on the CPU: the same dispatch, outputs within atol 1e-4
(f32 products, TF32 off). A one-trial Tuner pinned to the card trains
through every kernel, its losses within 1e-4 of the same steps in this
process, and an "nccl" group's ops on the card match its plain path (f32
rtol 1e-6, bf16 1e-2: sums over the cards in another order). RLlib: two
same-seed Anakin runs on the card are bitwise equal, and every learner's
update on the card matches the CPU's (losses 1e-5 relative, each updated
tensor 1e-5 relative in norm). Meshes: a sharded checkpoint of LLAMA_BENCH
at 2 layers restored onto another mesh shape by 4 gloo ranks on the card
(every shard bit-equal, the step after it within chip_smoke's
MESH_LOSS_RTOL); with four cards, the op-level mesh paths over NCCL, one
rank a card (skipped with fewer). A Train checkpoint directory loads
through ``LLMConfig.load_params`` onto the card in the config's dtype,
bit-equal to the CPU's cast, and a checkpoint of another depth raises.
"""

import dataclasses

import pytest
import torch

from chip_smoke import moe_routing
from ray_tpu_torch.llm import GenRequest, LlamaEngine
from ray_tpu_torch import parallel
from ray_tpu_torch.models import llama, moe_llama, params_from_numpy
from ray_tpu_torch.ops import attention, cuda_attention, cuda_ce, moe

pytestmark = pytest.mark.cuda

ATTN_ATOL = 2e-2
ATTN_ROW_RTOL = 1e-2
STAT_ATOL = 1e-3
GRAD_ROW_RTOL = 1e-2
MODEL_GRAD_RTOL = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _row_rel_err(out, ref):
    """max over rows (last axis) of ||out - ref|| / ||ref||, the norm
    floored at 1e-3 of the largest row's: a row whose reference cancels
    to ~0 (causal dq row 0, where dS = p (dP - delta) is 0) is held to an
    absolute error at that floor."""
    ref = ref.float()
    norms = ref.norm(dim=-1)
    return ((out.float() - ref).norm(dim=-1) / norms.clamp_min(1e-3 * norms.max())).max().item()


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).bfloat16()


ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 128, True),
    (1, 200, 200, 4, 4, 64, True),      # ragged S = T
    (2, 130, 333, 4, 1, 128, False),    # T != S, both ragged
    (1, 100, 300, 2, 2, 128, True),     # causal, T > S (top-left aligned)
    (1, 300, 100, 2, 1, 64, True),      # causal, T < S
]


# S and T around the forward kernel's 128-row q and kv tiles, causal with
# T > S and T < S, hd 64 and 128, GQA groups of 1, 2 and 4
ATTN_TILE_EDGES = [
    (1, 127, 127, 4, 4, 128, True),
    (1, 128, 128, 4, 2, 64, True),
    (1, 129, 129, 4, 1, 128, True),
    (1, 257, 257, 8, 2, 128, True),
    (1, 127, 257, 2, 1, 128, True),
    (1, 128, 257, 4, 4, 64, True),
    (1, 129, 128, 4, 1, 64, True),
    (1, 257, 129, 2, 2, 128, True),
    (2, 257, 127, 4, 2, 128, False),
    (1, 129, 257, 4, 1, 64, False),
]


@pytest.mark.parametrize("B,S,T,H,KVH,hd,causal", ATTN_SHAPES + ATTN_TILE_EDGES)
def test_flash_attention_kernel_matches_plain(dev, B, S, T, H, KVH, hd, causal):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, B, S, H, hd)
    k = _randn(gen, B, T, KVH, hd)
    v = _randn(gen, B, T, KVH, hd)
    o, lse = cuda_attention.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = cuda_attention.flash_attention_plain(q.float(), k.float(), v.float(),
                                               causal=causal)
    torch.cuda.synchronize()
    assert o.shape == (B, S, H, hd) and lse.shape == (B, H, S)
    assert (o.float() - ro).abs().max().item() <= ATTN_ATOL
    assert _row_rel_err(o, ro) <= ATTN_ROW_RTOL
    assert (lse - rlse).abs().max().item() <= STAT_ATOL


def test_flash_attention_kernel_is_deterministic(dev):
    """Two runs of the forward kernel give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q = _randn(gen, 2, 300, 4, 128)
    k = _randn(gen, 2, 300, 2, 128)
    v = _randn(gen, 2, 300, 2, 128)
    o1, lse1 = cuda_attention.flash_attention_fwd(q, k, v, causal=True)
    o2, lse2 = cuda_attention.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_attention_kernel_reads_strided_layout(dev):
    """q/k/v as views into a fused qkv buffer, as a model might hold them."""
    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, H, KVH, hd = 2, 192, 4, 2, 128
    qkv = _randn(gen, B, S, H + 2 * KVH, hd)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KVH], qkv[:, :, H + KVH:]
    o, _ = cuda_attention.flash_attention_fwd(q, k, v, causal=True)
    ro, _ = cuda_attention.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert (o.float() - ro).abs().max().item() <= ATTN_ATOL
    assert _row_rel_err(o, ro) <= ATTN_ROW_RTOL


def test_flash_attention_dispatch_counts_and_rejects(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, 1, 64, 2, 128)
    before = cuda_attention.flash_attention_fwd.launches
    attention.flash_attention(q, q, q, causal=True)
    assert cuda_attention.flash_attention_fwd.launches == before + 1
    with pytest.raises(ValueError):
        attention.flash_attention(q.float(), q.float(), q.float())   # f32: no kernel
    bad = _randn(gen, 1, 64, 2, 96)
    with pytest.raises(ValueError):
        attention.flash_attention(bad, bad, bad)                      # hd 96


def _bwd_problem(seed, B, S, T, H, KVH, hd, causal, dev):
    """Random q, k, v, dO and the forward kernel's o and lse."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(gen, B, S, H, hd)
    k = _randn(gen, B, T, KVH, hd)
    v = _randn(gen, B, T, KVH, hd)
    do = _randn(gen, B, S, H, hd)
    o, lse = cuda_attention.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, do, o, lse


# The backward kernels' tiles are 128 rows owned by a CTA and 64 rows
# streamed; the tile edges above cover both. One GQA group of 8 besides.
ATTN_BWD_SHAPES = ATTN_SHAPES + ATTN_TILE_EDGES + [(1, 257, 200, 8, 1, 128, True)]


@pytest.mark.parametrize("B,S,T,H,KVH,hd,causal", ATTN_BWD_SHAPES)
def test_flash_attention_bwd_kernels_match_plain(dev, B, S, T, H, KVH, hd, causal):
    q, k, v, do, o, lse = _bwd_problem(7, B, S, T, H, KVH, hd, causal, dev)
    before = (cuda_attention.flash_attention_bwd_dkv.launches,
              cuda_attention.flash_attention_bwd_dq.launches)
    dq, dk, dv = cuda_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert (cuda_attention.flash_attention_bwd_dkv.launches,
            cuda_attention.flash_attention_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    refs = cuda_attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal=causal)
    torch.cuda.synchronize()
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert out.shape == ref.shape and out.dtype == torch.bfloat16, name
        assert _row_rel_err(out, ref) <= GRAD_ROW_RTOL, name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernels_are_deterministic(dev, causal):
    """Two runs of the dK/dV and dQ kernels give the same bits: every
    output element has one owner and no atomics are used."""
    q, k, v, do, o, lse = _bwd_problem(17, 2, 300, 257, 8, 2, 128, causal, dev)
    first = cuda_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    second = cuda_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_attention_bwd_reads_strided_dout(dev):
    """dO as a view with padded head stride, as autograd may hand it over."""
    gen = torch.Generator(device=dev).manual_seed(8)
    B, S, H, KVH, hd = 1, 192, 4, 2, 128
    q = _randn(gen, B, S, H, hd)
    k = _randn(gen, B, S, KVH, hd)
    v = _randn(gen, B, S, KVH, hd)
    do = _randn(gen, B, S, H + 2, hd)[:, :, :H]
    o, lse = cuda_attention.flash_attention_fwd(q, k, v, causal=True)
    out = cuda_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    refs = cuda_attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal=True)
    for name, a, r in zip(("dq", "dk", "dv"), out, refs):
        assert _row_rel_err(a, r) <= GRAD_ROW_RTOL, name


def test_flash_attention_takes_any_stride_on_a_size1_dim(dev):
    """A one-row batch whose batch stride is 1 (autograd handed one such dO
    to a pipeline stage): the stride is never stepped along, so the kernels
    take it, forward and backward, and agree with the contiguous call bit
    for bit."""
    gen = torch.Generator(device=dev).manual_seed(9)
    B, S, H, KVH, hd = 1, 256, 4, 2, 128
    q, k, v, do = (_randn(gen, B, S, n, hd) for n in (H, KVH, KVH, H))
    odd = [torch.empty_strided(t.shape, (1,) + t.stride()[1:], dtype=t.dtype,
                               device=dev).copy_(t) for t in (q, k, v, do)]
    o, lse = cuda_attention.flash_attention_fwd(q, k, v, causal=True)
    o2, lse2 = cuda_attention.flash_attention_fwd(*odd[:3], causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(cuda_attention.flash_attention_bwd(q, k, v, o, lse, do, causal=True),
                    cuda_attention.flash_attention_bwd(*odd[:3], o, lse, odd[3], causal=True)):
        assert torch.equal(a, b)


CE_SHAPES = [
    (256, 128, 1024),
    (200, 136, 1000),                   # ragged N, a K tail, a ragged vocab tile
    (128, 64, 384),
]


CE_BWD_KERNELS = (cuda_ce.fused_ce_bwd_dlog, cuda_ce.fused_ce_bwd_dx, cuda_ce.fused_ce_bwd_dw)


def _ce_bwd_problem(seed, N, D, V, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(gen, N, D, scale=0.5)
    w = _randn(gen, D, V, scale=0.05)
    t = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    lse, _ = cuda_ce.fused_ce_fwd(x, w, t)
    g = torch.rand(N, generator=gen, device=dev) / N
    return x, w, t, lse, g


def _check_ce_bwd(x, w, t, lse, g):
    N, D = x.shape
    V = w.shape[1]
    n_chunks = -(-N // cuda_ce.chunk_rows(N, V, 2))
    before = [k.launches for k in CE_BWD_KERNELS]
    dx, dw = cuda_ce.fused_ce_bwd(x, w, t, lse, g)
    assert [k.launches - b for k, b in zip(CE_BWD_KERNELS, before)] == [n_chunks] * 3
    rx, rw = cuda_ce.fused_ce_bwd_plain(x.float(), w.float(), t, lse, g)
    torch.cuda.synchronize()
    assert dx.shape == (N, D) and dw.shape == (D, V) and dx.dtype == dw.dtype == torch.bfloat16
    assert _row_rel_err(dx, rx) <= GRAD_ROW_RTOL
    assert _row_rel_err(dw, rw) <= GRAD_ROW_RTOL


@pytest.mark.parametrize("N,D,V", CE_SHAPES + [(700, 264, 2104)])  # several tiles each way
def test_fused_ce_bwd_kernels_match_plain(dev, N, D, V):
    _check_ce_bwd(*_ce_bwd_problem(9, N, D, V, dev))


def test_fused_ce_bwd_kernels_chunked_match_plain(dev, monkeypatch):
    """A budget of 256 rows of dlog: chunks of 256, 256 and a ragged 188."""
    monkeypatch.setattr(cuda_ce, "_DLOG_BUDGET", 256 * 2104 * 2)
    assert cuda_ce.chunk_rows(700, 2104, 2) == 256
    _check_ce_bwd(*_ce_bwd_problem(13, 700, 264, 2104, dev))


def test_fused_ce_bwd_is_deterministic(dev, monkeypatch):
    """Two runs of the chunked backward give the same bits."""
    monkeypatch.setattr(cuda_ce, "_DLOG_BUDGET", 256 * 2104 * 2)
    args = _ce_bwd_problem(14, 700, 264, 2104, dev)
    dx1, dw1 = cuda_ce.fused_ce_bwd(*args)
    dx2, dw2 = cuda_ce.fused_ce_bwd(*args)
    assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)


@pytest.mark.parametrize("kernel", ["dlog", "dx", "dw"])
def test_fused_ce_bwd_kernel_alone_one_tile(dev, kernel):
    """Each CE backward kernel alone on one 128 x 256 output tile with two
    K stages, against its plain version: the dlog kernel reads x K-major
    and w MN-major, the dx kernel dlog and w K-major, the dW kernel x and
    dlog MN-major. The dW kernel's three modes: start the f32 sum, add to
    it, and round the last sum to bf16."""
    gen = torch.Generator(device=dev).manual_seed(15)
    if kernel == "dlog":
        x = _randn(gen, 128, 128, scale=0.5)
        w = _randn(gen, 128, 256, scale=0.05)
        t = torch.randint(0, 256, (128,), generator=gen, device=dev, dtype=torch.int32)
        lse, _ = cuda_ce.fused_ce_fwd_plain(x.float(), w.float(), t)
        g = torch.rand(128, generator=gen, device=dev)
        out = cuda_ce.fused_ce_bwd_dlog(x, w, t, lse, g)
        ref = cuda_ce.fused_ce_bwd_dlog_plain(x.float(), w.float(), t, lse, g)
        assert out.shape == (128, 256) and _row_rel_err(out, ref) <= GRAD_ROW_RTOL
    elif kernel == "dx":
        dlog = _randn(gen, 128, 128)
        w = _randn(gen, 256, 128)
        out = cuda_ce.fused_ce_bwd_dx(dlog, w)
        ref = cuda_ce.fused_ce_bwd_dx_plain(dlog.float(), w.float())
        assert out.shape == (128, 256) and _row_rel_err(out, ref) <= GRAD_ROW_RTOL
    else:
        x = _randn(gen, 128, 128)
        dlog = _randn(gen, 128, 256)
        acc = cuda_ce.fused_ce_bwd_dw(x, dlog, None, last=False)
        ref = cuda_ce.fused_ce_bwd_dw_plain(x.float(), dlog.float(), None, last=False)
        assert acc.dtype == torch.float32 and (acc - ref).abs().max().item() <= STAT_ATOL
        assert cuda_ce.fused_ce_bwd_dw(x, dlog, acc, last=False) is acc
        assert (acc - 2 * ref).abs().max().item() <= 2 * STAT_ATOL
        out = cuda_ce.fused_ce_bwd_dw(x, dlog, acc, last=True)
        assert out.shape == (128, 256) and out.dtype == torch.bfloat16
        assert _row_rel_err(out, 3 * ref) <= GRAD_ROW_RTOL


# N below one 128-row tile, N = 700, V not a multiple of the 256-column
# vocab tile, and 33 row tiles, past one group of the kernel's raster order
CE_FWD_EDGES = [
    (100, 128, 512),
    (700, 264, 2104),
    (33 * 128 + 5, 64, 2104),
]


@pytest.mark.parametrize("N,D,V", CE_SHAPES + CE_FWD_EDGES)
def test_fused_ce_kernel_matches_plain(dev, N, D, V):
    """The forward kernel, with targets on the vocab tiles' edges."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _randn(gen, N, D, scale=0.5)
    w = _randn(gen, D, V, scale=0.05)
    t = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    t[:4] = torch.tensor([0, 255, 256, V - 1], dtype=torch.int32)
    lse, tgt = cuda_ce.fused_ce_fwd(x, w, t)
    rl, rt = cuda_ce.fused_ce_fwd_plain(x.float(), w.float(), t)
    torch.cuda.synchronize()
    assert (lse - rl).abs().max().item() <= STAT_ATOL
    assert (tgt - rt).abs().max().item() <= STAT_ATOL


@pytest.mark.parametrize("n_vt", [8, 10])
def test_fused_ce_fwd_refuses_a_wrong_tile_count(dev, n_vt):
    """The forward's entry point takes the caller's count of vocab tiles
    (the rows of its partials buffer) and refuses one that is not
    ceil(V / 256), before it launches anything."""
    from ray_tpu_torch._native import build
    N, D, V = 128, 64, 2104                       # 9 vocab tiles
    x = torch.zeros(N, D, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(D, V, dtype=torch.bfloat16, device=dev)
    t = torch.zeros(N, dtype=torch.int32, device=dev)
    part = torch.empty(3 * 10 * N, dtype=torch.float32, device=dev)
    out = torch.empty(2, N, dtype=torch.float32, device=dev)
    err = build.library().rtt_fused_ce_fwd(
        x.data_ptr(), w.data_ptr(), t.data_ptr(), part.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), N, D, V, n_vt, torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0


def test_fused_cross_entropy_clamps_and_counts(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    N, D, V = 128, 64, 256
    x = _randn(gen, N, D)
    w = _randn(gen, D, V, scale=0.1)
    t = torch.randint(-50, V + 50, (N,), generator=gen, device=dev)
    before = cuda_ce.fused_ce_fwd.launches
    loss = cuda_ce.fused_cross_entropy(x, w, t)
    assert cuda_ce.fused_ce_fwd.launches == before + 1
    ref = cuda_ce.xla_cross_entropy(x.float(), w.float(), t.clamp(0, V - 1))
    assert (loss - ref).abs().max().item() <= STAT_ATOL


def test_engine_on_card_matches_cpu(dev):
    """The serving engine gives the same greedy tokens on the card as on
    the CPU (f32, TF32 off), from the same weights."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    cpu_params = llama.init_params(torch.Generator().manual_seed(6), cfg, "cpu")
    tree = {k: ({k2: t.numpy() for k2, t in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in cpu_params.items()}
    card_params = params_from_numpy(tree, dev)
    prompts = [[5, 17, 99, 3], list(range(1, 40))]
    for device, params in (("cpu", cpu_params), (dev, card_params)):
        eng = LlamaEngine(cfg, params, max_batch=2, max_seq=64, prefill_chunk=16,
                          device=device)
        reqs = [GenRequest(request_id=str(i), prompt_ids=p, max_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.add_request(r)
        while any(not r.done for r in reqs):
            eng.step()
        if device == "cpu":
            expected = [r.generated for r in reqs]
    assert [r.generated for r in reqs] == expected


def test_llama_flash_fused_matches_plain_paths(dev):
    """LLAMA_TINY in bf16 on the card: the kernel paths against the einsum
    attention and materialized-logits CE (bf16 through two layers). The
    loss of random weights sits near ln V whatever attention does, so the
    final hidden states are held too."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=2, n_kv_heads=1)  # hd 64
    gen = torch.Generator(device=dev).manual_seed(5)
    params = llama.init_params(gen, cfg, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen, device=dev)
    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    with torch.inference_mode():
        lf = llama.loss_fn(params, {"tokens": tokens}, fast).item()
        lx = llama.loss_fn(params, {"tokens": tokens}, cfg).item()
        hf = llama.forward_hidden(params, tokens[:, :-1], fast)
        hx = llama.forward_hidden(params, tokens[:, :-1], cfg)
    assert abs(lf - lx) <= 1e-3 * abs(lx)
    assert _row_rel_err(hf, hx.float()) <= 5e-2


def _grads(params, loss):
    leaves = parallel.tree_leaves(params)
    return torch.autograd.grad(loss, leaves)


def test_llama_training_grads_kernel_paths_match_plain(dev):
    """LLAMA_TINY (hd 64) in bf16 with remat: gradients of the kernel paths
    (flash + fused) against the plain paths (einsum attention and
    materialized-logits CE), per parameter tensor."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=2, n_kv_heads=1, remat=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    params = parallel.tree_map(lambda t: t.requires_grad_(True), llama.init_params(gen, cfg, dev))
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen, device=dev)
    fast = dataclasses.replace(cfg, attention_impl="flash", ce_impl="fused")
    gk = _grads(params, llama.loss_fn(params, {"tokens": tokens}, fast))
    gp = _grads(params, llama.loss_fn(params, {"tokens": tokens}, cfg))
    for i, (a, b) in enumerate(zip(gk, gp)):
        err = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert err <= MODEL_GRAD_RTOL, (i, err)


def test_train_steps_on_card(dev):
    """Three train steps of LLAMA_TINY (bf16 params, remat, flash + fused)
    through create_train_state / make_train_step: step 0 has lr 0 and
    changes nothing, step 1 does; every kernel launches as counted."""
    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=2, n_kv_heads=1, remat=True,
                              param_dtype=torch.bfloat16, attention_impl="flash",
                              ce_impl="fused")
    opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    state = parallel.create_train_state(torch.Generator(device=dev).manual_seed(11),
                                        lambda g: llama.init_params(g, cfg, dev), opt)
    step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 129), generator=gen, device=dev)}
    kernels = (cuda_attention.flash_attention_fwd, cuda_attention.flash_attention_bwd_dkv,
               cuda_attention.flash_attention_bwd_dq, cuda_ce.fused_ce_fwd, *CE_BWD_KERNELS)
    for k in kernels:
        k.launches = 0
    first = [t.detach().clone() for t in parallel.tree_leaves(state.params)]
    state, m0 = step(state, batch)
    after0 = [t.detach().clone() for t in parallel.tree_leaves(state.params)]
    assert all(torch.equal(a, b) for a, b in zip(first, after0))
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    torch.cuda.synchronize()
    # 2 x 128 rows: one chunk of the CE backward per step
    assert [k.launches for k in kernels] == [3 * 2 * cfg.n_layers] + [3 * cfg.n_layers] * 2 + [3] * 4
    assert not all(torch.equal(a, b.detach()) for a, b in
                   zip(after0, parallel.tree_leaves(state.params)))
    losses = [m["loss"].item() for m in (m0, m1, m2)]
    assert all(torch.isfinite(torch.tensor(losses))) and m2["step"] == 3
    assert losses[2] < losses[0]
    assert all(torch.isfinite(m["grad_norm"]).item() for m in (m0, m1, m2))


def test_moe_flash_matches_xla_on_card(dev):
    """A 2-layer MoE Llama at hd 128 with 4 experts (bf16, remat): the
    flash path (the attention kernels) against the einsum path on the same
    weights and batch, with the routing pinned to the einsum path's:
    loss, aux loss and every parameter's gradient; each kernel launches
    once per layer and pass (the forward twice: remat's recompute)."""
    cfg = moe_llama.MoELlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                                   n_kv_heads=1, ffn_dim=256, max_seq_len=256,
                                   rope_theta=10000.0, remat=True, n_experts=4)
    gen = torch.Generator(device=dev).manual_seed(13)
    params = parallel.tree_map(lambda t: t.requires_grad_(True),
                               moe_llama.init_params(gen, cfg, dev))
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen, device=dev)
    mask = torch.ones_like(tokens, dtype=torch.float32)
    mask[1, -20:] = 0.0
    batch = {"tokens": tokens, "input_mask": mask}
    fast = dataclasses.replace(cfg, attention_impl="flash")
    plain_calls, fast_calls = [], []
    with moe_routing(moe, record=plain_calls):
        gp = _grads(params, moe_llama.loss_fn(params, batch, cfg))
    kernels = (cuda_attention.flash_attention_fwd, cuda_attention.flash_attention_bwd_dkv,
               cuda_attention.flash_attention_bwd_dq)
    for k in kernels:
        k.launches = 0
    with moe_routing(moe, record=fast_calls, replay=[c[0] for c in plain_calls]):
        loss_f = moe_llama.loss_fn(params, batch, fast)
        gk = _grads(params, loss_f)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    assert len(fast_calls) == len(plain_calls) == 2 * cfg.n_layers
    for (_, a), (_, b) in zip(fast_calls, plain_calls):
        assert torch.equal(a.dispatch, b.dispatch)
    aux = [sum(c[1].aux_loss.item() for c in calls[:cfg.n_layers])
           for calls in (fast_calls, plain_calls)]
    assert abs(aux[0] - aux[1]) <= 1e-3 * abs(aux[1])
    with moe_routing(moe, replay=[c[0] for c in plain_calls]), torch.no_grad():
        loss_p = moe_llama.loss_fn(params, batch, cfg)
    assert abs(loss_f.item() - loss_p.item()) <= 1e-3 * abs(loss_p.item())
    for i, (a, b) in enumerate(zip(gk, gp)):
        err = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert err <= MODEL_GRAD_RTOL, (i, err)


@pytest.mark.parametrize("tied", [False, True])
def test_moe_ffn_on_card_matches_cpu(dev, tied):
    """moe_ffn in f32 on the card and on the CPU from the same values:
    the same routing (ties included: a zero router sends every token to
    experts 0 and 1, in order, past their capacity) and the same output."""
    cfg = moe.MoEConfig(d_model=128, d_ff=256, n_experts=8, k=2, capacity_factor=1.0)
    params = moe.init_moe_params(torch.Generator().manual_seed(14), cfg, torch.float32, "cpu")
    if tied:
        params["router"].zero_()
    x = torch.randn(4, 64, 128, generator=torch.Generator().manual_seed(15))
    mask = (torch.rand(4, 64, generator=torch.Generator().manual_seed(16)) > 0.2).float()
    out_c, aux_c = moe.moe_ffn(params, x, cfg, mask)
    gate_c = moe.top_k_gating(x.reshape(-1, 128) @ params["router"], k=2, capacity_factor=1.0)
    on = {k: v.to(dev) for k, v in params.items()}
    out_g, aux_g = moe.moe_ffn(on, x.to(dev), cfg, mask.to(dev))
    gate_g = moe.top_k_gating(x.reshape(-1, 128).to(dev) @ on["router"], k=2,
                              capacity_factor=1.0)
    assert torch.equal(gate_g.dispatch.cpu(), gate_c.dispatch)
    assert (out_g.cpu() - out_c).abs().max().item() <= 1e-4
    assert abs(aux_g.item() - aux_c.item()) <= 1e-5 * abs(aux_c.item())


def test_gpu_actor_pins_its_card_and_takes_a_cuda_tensor(dev):
    """The port's runtime on the card: a num_gpus=1 actor sees one card
    (the driver's, by UUID) through CUDA_VISIBLE_DEVICES; a CUDA tensor
    put by the driver arrives on the actor's card and comes back equal;
    a task without a GPU that gets it raises."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2, max_workers=2)
    try:
        assert rt.cluster_resources().get("GPU") == torch.cuda.device_count()

        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                import os

                props = torch.cuda.get_device_properties(0)
                return os.environ["CUDA_VISIBLE_DEVICES"], torch.cuda.device_count(), str(props.uuid)

            def echo(self, t):
                return str(t.device), t

        @rt.remote
        def fetch(refs):
            return rt.get(refs[0], timeout=60)

        a = OnCard.remote()
        visible, count, uuid = rt.get(a.where.remote(), timeout=120)
        assert count == 1
        assert uuid == str(torch.cuda.get_device_properties(int(visible)).uuid)
        t = torch.randn(513, 1024, device=dev).to(torch.bfloat16)
        ref = rt.put(t)
        where, back = rt.get(a.echo.remote(ref), timeout=120)
        assert where == "cuda:0"
        assert back.device.type == "cuda" and back.dtype == torch.bfloat16
        assert torch.equal(back, t)
        with pytest.raises(rt.exceptions.TaskError, match="CUDA tensor"):
            rt.get(fetch.remote([ref]), timeout=120)
        rt.kill(a)
    finally:
        rt.shutdown()


def test_torch_trainer_trains_on_the_card_through_every_kernel(dev, tmp_path):
    """A one-GPU TorchTrainer gang (nccl by default) trains LLAMA_TINY at
    hd 64 (bf16 params, remat, flash + fused) for two steps: the worker
    is pinned one card, the driver's; each step's loss equals the same
    step in this process (relative 1e-4, chip_smoke's TRAIN_LOSS_RTOL);
    and each step, counted in the worker, launches all seven kernels."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train

    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=2, n_kv_heads=1, remat=True,
                              param_dtype=torch.bfloat16, attention_impl="flash",
                              ce_impl="fused")
    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(12))
    opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
    state = parallel.create_train_state(torch.Generator(device=dev).manual_seed(11),
                                        lambda g: llama.init_params(g, cfg, dev), opt)
    step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    here = []
    for _ in range(2):
        state, m = step(state, {"tokens": tokens.to(dev)})
        here.append(m["loss"].item())
    del state

    def loop(config):
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import parallel
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import cuda_attention, cuda_ce

        kernels = (cuda_attention.flash_attention_fwd, cuda_attention.flash_attention_bwd_dkv,
                   cuda_attention.flash_attention_bwd_dq, cuda_ce.fused_ce_fwd,
                   cuda_ce.fused_ce_bwd_dlog, cuda_ce.fused_ce_bwd_dx, cuda_ce.fused_ce_bwd_dw)
        cfg, dev = config["cfg"], torch.device("cuda", 0)
        opt = parallel.default_optimizer(1e-3, warmup_steps=1, total_steps=10)
        state = parallel.create_train_state(torch.Generator(device=dev).manual_seed(11),
                                            lambda g: llama.init_params(g, cfg, dev), opt)
        step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
        batch = {"tokens": config["tokens"].to(dev)}
        for _ in range(2):
            for k in kernels:
                k.launches = 0
            state, m = step(state, batch)
            loss = m["loss"].item()
            train.report({"loss": loss, "launches": [k.launches for k in kernels],
                          "backend": dist.get_backend(),
                          "visible": os.environ["CUDA_VISIBLE_DEVICES"],
                          "uuid": str(torch.cuda.get_device_properties(0).uuid)})

    class Collect:
        def __init__(self):
            self.rows = []

        def on_result(self, metrics):
            self.rows.append(metrics)

    collect = Collect()
    rt.init(num_cpus=2, max_workers=2)
    try:
        result = train.TorchTrainer(
            loop, train_loop_config={"cfg": cfg, "tokens": tokens},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(storage_path=str(tmp_path), callbacks=[collect]),
        ).fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    assert [r["training_iteration"] for r in collect.rows] == [1, 2]
    for row, want in zip(collect.rows, here):
        assert row["backend"] == "nccl" and len(row["visible"].split(",")) == 1
        assert row["uuid"] == str(torch.cuda.get_device_properties(dev).uuid)
        assert abs(row["loss"] - want) <= 1e-4 * abs(want), (row["loss"], want)
        # 2 layers, remat: the flash forward twice a layer; 2 x 128 rows: one CE chunk
        assert row["launches"] == [4, 2, 2, 1, 1, 1, 1]


def test_gpu_deployment_sees_the_drivers_card_and_computes(dev):
    """Serve on the card: a num_gpus=1 deployment's replica sees one card,
    the driver's by UUID, through CUDA_VISIBLE_DEVICES, and answers a
    product of two CPU tensors (1 MiB each, so they ride Serve's payload
    plane) computed on its card, equal to the same product here within
    f32 rounding (TF32 off on both sides)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    @serve.deployment(ray_actor_options={"num_gpus": 1})
    class OnCard:
        def where(self):
            import os

            props = torch.cuda.get_device_properties(0)
            return os.environ["CUDA_VISIBLE_DEVICES"], torch.cuda.device_count(), str(props.uuid)

        def __call__(self, a, b):
            import torch as th  # a local name: cloudpickle cannot pickle torch.backends.cuda

            th.backends.cuda.matmul.allow_tf32 = False
            return str(a.device), (a.cuda() @ b.cuda()).cpu()

    rt.init(num_cpus=2, max_workers=2)
    try:
        handle = serve.run(OnCard.bind())
        visible, count, uuid = handle.where.remote().result(timeout_s=120)
        assert count == 1
        assert uuid == str(torch.cuda.get_device_properties(int(visible)).uuid)
        gen = torch.Generator().manual_seed(13)
        a, b = torch.randn(512, 512, generator=gen), torch.randn(512, 512, generator=gen)
        arrived_on, got = handle.remote(a, b).result(timeout_s=120)
        assert arrived_on == "cpu" and got.device.type == "cpu"
        torch.testing.assert_close(got, (a.to(dev) @ b.to(dev)).cpu(), rtol=1e-5, atol=1e-4)
    finally:
        serve.shutdown()
        rt.shutdown()


def test_cluster_agent_node_holds_the_card_and_runs_the_kernel(dev):
    """A Cluster whose head has no GPU (``RAY_TPU_TORCH_NUM_GPUS=0`` while
    it starts) and one added node whose agent holds the card: a one-GPU
    actor lands on that node, sees the driver's card by UUID, and runs
    the flash-attention forward once at a small shape; its output is held
    against the plain version (ATTN_ATOL, ATTN_ROW_RTOL, STAT_ATOL) and
    the actor's launch counter reads 1."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    os.environ["RAY_TPU_TORCH_NUM_GPUS"] = "0"
    try:
        c = Cluster(head_num_cpus=1)
    finally:
        del os.environ["RAY_TPU_TORCH_NUM_GPUS"]
    try:
        node = c.add_node(num_cpus=1, num_gpus=1)
        gpus = {n["node_id"]: n["resources"].get("GPU", 0) for n in rt.nodes() if n["alive"]}
        assert gpus == {"node0": 0, node.node_id: 1.0}

        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                import os

                props = torch.cuda.get_device_properties(0)
                return os.environ["RAY_TPU_TORCH_NODE_ID"], str(props.uuid)

            def flash(self, q, k, v):
                from ray_tpu_torch.ops import cuda_attention as ca

                ca.flash_attention_fwd.launches = 0
                o, lse = ca.flash_attention_fwd(q.cuda(), k.cuda(), v.cuda(), causal=True)
                return o.cpu(), lse.cpu(), ca.flash_attention_fwd.launches

        a = OnCard.remote()
        where, uuid = rt.get(a.where.remote(), timeout=120)
        assert where == node.node_id
        assert uuid == str(torch.cuda.get_device_properties(dev).uuid)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (_randn(gen, 1, 256, h, 128).cpu() for h in (4, 2, 2))
        o, lse, launches = rt.get(a.flash.remote(q, k, v), timeout=120)
        ro, rlse = cuda_attention.flash_attention_plain(q.float(), k.float(), v.float(),
                                                        causal=True)
        assert launches == 1
        assert (o.float() - ro).abs().max().item() <= ATTN_ATOL
        assert _row_rel_err(o, ro) <= ATTN_ROW_RTOL
        assert (lse - rlse).abs().max().item() <= STAT_ATOL
    finally:
        c.shutdown()


def test_iter_batches_stages_each_batch_on_the_card(dev):
    """``iter_batches(device_put="cuda")``: every numeric column arrives as
    a CUDA tensor equal to its rows, with and without prefetch, read on a
    stream of the consumer's own; ``iter_torch_batches`` hands out the same
    tensors; a string column stays numpy."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 257)).astype(np.float32)
    tok = rng.integers(0, 32000, (64, 33)).astype(np.int32)
    rt.init(num_cpus=2, max_workers=2)
    try:
        ds = data.from_items([{"x": x[i], "tok": tok[i], "s": f"r{i}"} for i in range(64)])
        ds = ds.materialize()
        consumer = torch.cuda.Stream()
        for prefetch in (0, 2):
            with torch.cuda.stream(consumer):
                seen = 0
                for b in ds.iter_batches(batch_size=8, device_put="cuda",
                                         prefetch_batches=prefetch):
                    assert b["x"].is_cuda and b["x"].dtype == torch.float32
                    assert b["tok"].dtype == torch.int32 and b["tok"].is_cuda
                    assert torch.equal(b["x"].cpu(), torch.from_numpy(x[seen:seen + 8]))
                    assert torch.equal(b["tok"].cpu(), torch.from_numpy(tok[seen:seen + 8]))
                    assert isinstance(b["s"], np.ndarray)
                    seen += 8
                assert seen == 64
        t = [b["tok"] for b in ds.iter_torch_batches(batch_size=16, device_put="cuda")]
        assert all(v.is_cuda for v in t) and torch.equal(torch.cat(t).cpu(), torch.from_numpy(tok))
    finally:
        rt.shutdown()


def test_compiled_dag_drives_a_gpu_actor_through_channels(dev):
    """A channel-mode compiled DAG on a ``num_gpus=1`` actor: the method
    takes a numpy batch through the C++ ring, computes on the card and
    returns numpy; five pipelined executes equal the driver's product on
    the same card, with no task event between them; after teardown the
    actor answers again."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    rt.init(num_cpus=2, max_workers=2)
    try:
        @rt.remote(num_gpus=1)
        class Proj:
            def __init__(self):
                g = torch.Generator(device="cuda").manual_seed(0)
                self.w = torch.randn(64, 32, generator=g, device="cuda")

            def run(self, x):
                return (torch.from_numpy(x).cuda() @ self.w).cpu().numpy()

            def device(self):
                return torch.cuda.get_device_name(0)

        a = Proj.remote()
        rt.get(a.device.remote(), timeout=120)
        with InputNode() as inp:
            inp.with_shm_channel((4, 64), "float32")
            compiled = a.run.bind(inp).with_shm_channel((4, 32), "float32").experimental_compile(
                max_inflight_executions=5)
        assert compiled._channel_mode
        assert {ch.backend for ch in compiled._edge_chans.values()} == {"native"}
        xs = [np.random.default_rng(i).standard_normal((4, 64)).astype(np.float32)
              for i in range(5)]
        compiled.execute(xs[0]).get(timeout=120)  # warm
        events = len(rt._private.worker.get_client().list_state("tasks"))
        outs = [r.get(timeout=120) for r in [compiled.execute(x) for x in xs]]
        assert len(rt._private.worker.get_client().list_state("tasks")) == events
        compiled.teardown()
        g = torch.Generator(device="cuda").manual_seed(0)
        w = torch.randn(64, 32, generator=g, device="cuda")
        for x, o in zip(xs, outs):
            assert np.array_equal(o, (torch.from_numpy(x).cuda() @ w).cpu().numpy())
        assert rt.get(a.device.remote(), timeout=60) == torch.cuda.get_device_name(0)
        rt.kill(a)
    finally:
        rt.shutdown()


def test_tuner_trial_pinned_to_the_card_trains_through_every_kernel(dev, tmp_path):
    """A one-trial Tuner over a trainable that asks for {"GPU": 1}: the
    trial's actor is pinned one card, the driver's, and trains LLAMA_TINY at
    hd 64 (bf16 params, remat, flash + fused) for two steps whose losses
    equal the same steps in this process (relative 1e-4), each step
    launching all seven kernels, counted in the trial's process."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig

    cfg = dataclasses.replace(llama.LLAMA_TINY, n_heads=2, n_kv_heads=1, remat=True,
                              param_dtype=torch.bfloat16, attention_impl="flash",
                              ce_impl="fused")
    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(12))

    def setup(lr, device):
        opt = parallel.default_optimizer(lr, warmup_steps=1, total_steps=10)
        state = parallel.create_train_state(torch.Generator(device=device).manual_seed(11),
                                            lambda g: llama.init_params(g, cfg, device), opt)
        return state, parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)

    state, step = setup(3e-3, dev)
    here = []
    for _ in range(2):
        state, m = step(state, {"tokens": tokens.to(dev)})
        here.append(m["loss"].item())
    del state

    def trainable(config):
        import os

        device = torch.device("cuda", 0)
        kernels = (cuda_attention.flash_attention_fwd, cuda_attention.flash_attention_bwd_dkv,
                   cuda_attention.flash_attention_bwd_dq, cuda_ce.fused_ce_fwd,
                   cuda_ce.fused_ce_bwd_dlog, cuda_ce.fused_ce_bwd_dx, cuda_ce.fused_ce_bwd_dw)
        state, step = setup(config["lr"], device)
        for _ in range(2):
            for k in kernels:
                k.launches = 0
            state, m = step(state, {"tokens": tokens.to(device)})
            tune.report({"loss": m["loss"].item(), "launches": [k.launches for k in kernels],
                         "visible": os.environ["CUDA_VISIBLE_DEVICES"],
                         "uuid": str(torch.cuda.get_device_properties(0).uuid)})

    rt.init(num_cpus=2, max_workers=2)
    try:
        grid = tune.Tuner(tune.with_resources(trainable, {"GPU": 1}),
                          param_space={"lr": tune.grid_search([3e-3])},
                          tune_config=tune.TuneConfig(metric="loss", mode="min"),
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    finally:
        rt.shutdown()
    assert not grid.errors, grid.errors
    last = grid.get_best_result().metrics
    assert last["training_iteration"] == 2 and len(last["visible"].split(",")) == 1
    assert last["uuid"] == str(torch.cuda.get_device_properties(dev).uuid)
    assert abs(last["loss"] - here[1]) <= 1e-4 * abs(here[1]), (last["loss"], here)
    assert last["launches"] == [4, 2, 2, 1, 1, 1, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nccl_group_on_the_card_matches_the_plain_path(dev, dtype):
    """An "nccl" group over every card of this process: each op, and each
    ReduceOp of allreduce, reduce and reducescatter, through NCCL, against
    the group's plain path on CPU copies of the same tensors (f32 within
    rtol 1e-6, bf16 within 1e-2; MIN, MAX, broadcast and allgather exact)."""
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import types

    n = torch.cuda.device_count()
    g = col.init_collective_group(n, 0, group_name=f"cuda_{dtype}")
    plain = col.init_collective_group(n, 0, group_name=f"plain_{dtype}", devices=["cpu"] * n)
    try:
        gen = torch.Generator().manual_seed(0)
        xs = [torch.rand(4 * n, 33, generator=gen).add(0.5).to(dtype) for _ in range(n)]
        on_card = [x.to(f"cuda:{i}") for i, x in enumerate(xs)]
        rtol = 1e-6 if dtype == torch.float32 else 1e-2

        def same(outs, refs, exact=False):
            assert len(outs) == len(refs) == n
            for i, (o, r) in enumerate(zip(outs, refs)):
                assert o.device == torch.device("cuda", i) and o.dtype == r.dtype
                torch.testing.assert_close(o.cpu(), r, rtol=0 if exact else rtol, atol=0)

        for op in types.ReduceOp:
            exact = op in (types.ReduceOp.MIN, types.ReduceOp.MAX)
            same(g.allreduce(on_card, types.AllReduceOptions(reduceOp=op)),
                 plain.allreduce(xs, types.AllReduceOptions(reduceOp=op)), exact)
            same(g.reduce(on_card, types.ReduceOptions(reduceOp=op, root_rank=n - 1)),
                 plain.reduce(xs, types.ReduceOptions(reduceOp=op, root_rank=n - 1)), exact)
            same(g.reducescatter(on_card, types.ReduceScatterOptions(reduceOp=op)),
                 plain.reducescatter(xs, types.ReduceScatterOptions(reduceOp=op)), exact)
        same(g.broadcast(on_card, types.BroadcastOptions(root_rank=0)),
             plain.broadcast(xs, types.BroadcastOptions(root_rank=0)), exact=True)
        same(g.allgather(on_card), plain.allgather(xs), exact=True)
        g.barrier()
        g.send([on_card[0]], types.SendOptions(dst_rank=n - 1))
        got = g.recv(types.RecvOptions(src_rank=n - 1))
        assert got.device == torch.device("cuda", n - 1) and torch.equal(got.cpu(), xs[0])
        assert all(torch.equal(c.cpu(), x) for c, x in zip(on_card, xs))  # inputs untouched
    finally:
        col.destroy_collective_group(f"cuda_{dtype}")
        col.destroy_collective_group(f"plain_{dtype}")


@pytest.mark.parametrize("op", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_mesh_attention_on_shared_card_matches_one_rank(dev, tmp_path, op, causal):
    """Ring and Ulysses attention on two gloo ranks sharing the card
    (``tests/torch_mesh_ranks.py``; CUDA tensors staged through the host),
    each rank's sequence block through the kernels, against one rank's
    flash_attention on the whole: o and the gradients per row at
    ATTN_ROW_RTOL / GRAD_ROW_RTOL. The ring runs its hop plan: rank r runs
    r + 1 forward and backward hops when causal, 2 otherwise; Ulysses one
    of each kernel a rank."""
    import numpy as np

    import torch_mesh_ranks as ranks
    from ray_tpu_torch.ops import flash_attention

    B, S, H, KVH, hd = 1, 1024, 16, 8, 128
    rng = np.random.default_rng(5)
    arrays = {f"c/{n}": rng.standard_normal(shape).astype(np.float32)
              for n, shape in (("q", (B, S, H, hd)), ("k", (B, S, KVH, hd)),
                               ("v", (B, S, KVH, hd)), ("g", (B, S, H, hd)))}
    np.savez(tmp_path / "qkv.npz", **arrays)
    outs = ranks.launch(op, 2, tmp_path, timeout=300, device="cuda", bf16=True,
                        cases=[{"tag": "c", "causal": causal}])
    q, k, v, g = (torch.from_numpy(arrays[f"c/{n}"]).to(dev).bfloat16() for n in "qkvg")
    whole = [t.requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*whole, causal=causal)
    refs = dict(zip(("o", "dq", "dk", "dv"), (o, *torch.autograd.grad(o, whole, g))))
    for r, out in enumerate(outs):
        got = out["c"]
        assert _row_rel_err(got["o"].to(dev), refs["o"]) <= ATTN_ROW_RTOL, r
        for n in ("dq", "dk", "dv"):
            assert _row_rel_err(got[n].to(dev), refs[n]) <= GRAD_ROW_RTOL, (r, n)
        hops = 1 if op == "ulysses" else (r + 1 if causal else 2)
        assert got["launches"] == {"flash_attention_fwd": hops, "flash_attention_bwd_dkv": hops,
                                   "flash_attention_bwd_dq": hops}, (r, got["launches"])


def test_anakin_on_the_card_is_bitwise_deterministic(dev, monkeypatch):
    """Two same-seed Anakin runs through PodracerConfig.build() (the
    worker pinned to the card, the carry on it, deterministic cuBLAS)
    give bitwise-equal metrics rows."""
    import numpy as np

    import ray_tpu_torch as rt
    from chip_smoke import _anakin_config

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    rt.init(num_cpus=2, max_workers=2)
    try:
        rows = []
        for _ in range(2):
            drv = _anakin_config("vtrace", 64, seed=3).build()
            try:
                assert drv.device == "cuda:0"
                rows.append(drv.train(num_ticks=4)["metrics_rows"])
            finally:
                drv.stop()
    finally:
        rt.shutdown()
    assert np.array_equal(rows[0], rows[1])
    assert rows[0][-1][1] == 4 and rows[0][-1][2] == 4 * 16 * 64


def test_rllib_learner_updates_on_the_card_match_the_cpu(dev):
    """Every learner's update (Anakin's with both losses, PPO, DQN, SAC,
    BC, MARWIL, CQL) at its config's default shapes on the card against
    the CPU: losses at 1e-5 relative (atol 1e-6), each updated tensor at
    1e-5 relative in norm (chip_smoke.rllib_hold)."""
    from chip_smoke import rllib_hold, rllib_learner_cases

    for name, run in rllib_learner_cases().items():
        rllib_hold(name, run(dev), run(torch.device("cpu")))


_KERNEL_NAMES = ["flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                 "fused_ce_fwd", "fused_ce_bwd_dlog", "fused_ce_bwd_dx", "fused_ce_bwd_dw",
                 "fused_adamw"]


def test_mesh_restore_on_the_shared_card(dev):
    """``chip_smoke``'s mesh_restore at 2 layers of LLAMA_BENCH (bf16):
    4 gloo ranks on the card train 2 steps at (fsdp 2, model 2), save the
    sharded state, and restore it at (fsdp 4) in the same ranks: every
    restored shard (parameters, both Adam moments) equals ``shard_params``
    of the tree gathered at the save bit for bit, a step there is within
    ``MESH_LOSS_RTOL`` of the uninterrupted run's third, and it launches
    each kernel as a training step on a quarter of the rows."""
    import os
    import tempfile

    import chip_smoke as cs

    cfg = dataclasses.replace(llama.LLAMA_BENCH, n_layers=2, param_dtype=torch.bfloat16,
                              remat=True, attention_impl="flash", ce_impl="fused")
    tokens, _ = cs.bench_inputs(cfg)
    with tempfile.TemporaryDirectory() as d:
        outs = cs.run_ranks(cs.mesh_train_rank, 4, {
            "cfg": cfg, "tokens": tokens, "steps": 2, "kernel_names": _KERNEL_NAMES,
            "mesh": {"fsdp": 2, "model": 2},
            "restore": {"path": os.path.join(d, "ckpt"), "mesh": {"fsdp": 4}}}, timeout_s=300)
    want = cs.train_step_counts(cfg, tokens[:2])
    for r, o in enumerate(outs):
        x = o["restore"]
        assert x["unequal"] == [] and x["counts"] == (2, 2), (r, x["unequal"][:4], x["counts"])
        assert x["launches"] == want, (r, x["launches"])
        assert x["loss"] == outs[0]["restore"]["loss"], r
        assert x["wq"] == (2, cfg.dim // 4, cfg.n_heads, cfg.head_dim), x["wq"]
    x = outs[0]["restore"]
    assert abs(x["loss"] - x["uninterrupted"]) <= cs.MESH_LOSS_RTOL * abs(x["uninterrupted"])
    assert x["bytes"] > 0


def test_mesh_op_paths_over_nccl_one_rank_a_card(dev):
    """``chip_smoke.mesh_op_paths`` over NCCL on four cards, one rank a
    card, at 4 layers of LLAMA_BENCH: Ulysses and the ring op at seq 4,
    1F1B and GPipe over 4 stages of one block, the expert FFN at expert 4
    (Mixtral's 8 experts, 2 a rank), each rank held against one rank's
    result under the bounds it has on one card (the function raises
    otherwise)."""
    import chip_smoke as cs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    cfg = dataclasses.replace(llama.LLAMA_BENCH, n_layers=4)
    lines = []
    counted = cs.mesh_op_paths(cfg, _KERNEL_NAMES, lines.append, world=4, backend="nccl",
                               timeout_s=240)
    cards = [line for line in lines if "on card 3" in line]
    assert len(cards) == 4, lines     # Ulysses, the ring op, the pipeline, the expert FFN
    assert counted["mesh_ulysses"]["flash_attention_fwd"] == 4
    assert counted["mesh_ring_op"]["flash_attention_fwd"] == 1 + 2 + 3 + 4


def test_load_params_of_a_checkpoint_dir_on_the_card(dev, tmp_path):
    """``LLMConfig.load_params`` of a ``Checkpoint.from_torch`` directory
    of LLAMA_TINY (f32 on the host): every leaf comes back on the card,
    cast to a bf16 config's dtype, equal to the CPU's cast of the same
    tensor; a 1-layer config raises ValueError naming the leaf."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.train import Checkpoint

    params = llama.init_params(torch.Generator().manual_seed(0), llama.LLAMA_TINY, "cpu")
    Checkpoint.from_torch(params, str(tmp_path))
    cfg = dataclasses.replace(llama.LLAMA_TINY, param_dtype=torch.bfloat16)
    got = LLMConfig(model_config=cfg, checkpoint_path=str(tmp_path)).load_params()
    names = ["embed", *(f"blocks.{k}" for k in params["blocks"]), "final_norm", "lm_head"]
    for name, want, out in zip(names, parallel.tree_leaves(params), parallel.tree_leaves(got)):
        assert out.device.type == "cuda" and out.dtype == torch.bfloat16, (name, out.device)
        assert torch.equal(out.cpu(), want.to(torch.bfloat16)), name
    with pytest.raises(ValueError, match=r"\.blocks\.\w+ holds \(2, "):
        LLMConfig(model_config=dataclasses.replace(cfg, n_layers=1),
                  checkpoint_path=str(tmp_path)).load_params()
