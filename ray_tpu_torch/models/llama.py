"""Llama-family decoder-only transformer, PyTorch port of
``ray_tpu/models/llama.py``: forward, the training loss and its
gradients, and the KV-cache path.

Same architecture and the same cast points as the reference:
- parameters are a dict of tensors with **stacked layers** (leading
  ``n_layers`` axis) under the reference's key names, so a JAX tree
  carries over one to one (``models/convert.py``); the layers run as a
  Python loop over the stacked tensors;
- ``rms_norm`` computes in f32, casts to the working dtype, then
  multiplies by the weight in the working dtype;
- ``apply_rope`` rotates the two halves of the head dim (not
  interleaved) in f32;
- attention logits are f32 with a -1e30 mask; GQA query head h reads kv
  head h // (H // KVH);
- ``attention_impl="flash"`` routes attention to the hand-written kernel
  (``ops/attention.py``); ``ce_impl="fused"`` routes the lm-head
  projection and softmax-CE to the fused kernel (``ops/cuda_ce.py``).

``remat``: when set and grad is enabled, each block runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
only the block's input and recomputes the rest in the backward pass: the
counterpart of ``jax.checkpoint(policy=nothing_saveable)`` at
``ray_tpu/models/llama.py:315-319``. Under ``torch.inference_mode``
(scoring, serving) grad is off and nothing changes.

Over a mesh (the ambient one of ``parallel.set_mesh``, more than one
rank) the parameters are this rank's shards of ``param_specs`` and the
forward is sharded as GSPMD shards the reference's:
- each layer's fsdp shards are all-gathered inside the block (so under
  remat one layer at a time, again in the recompute), their gradients
  reduce-scattered;
- heads (wq, wk, wv, wo) and the ffn hidden are split over ``model``
  (Megatron), with an all-reduce after ``wo`` and after ``w_down``;
- ``embed`` and ``lm_head`` are gathered whole before the lookup and
  before the CE, so the fused CE kernels see the whole vocabulary;
- ``loss_fn`` takes the global batch and keeps this rank's rows (dim 0
  over data and fsdp) and, with ``attention_impl="ring"`` and a ``seq``
  axis, its block of the sequence (rope at the block's offset; the ring
  of ``ops/ring_attention.py`` carries K/V round); the loss is the sum
  of the ranks' shares (``parallel/comm.py``).
A mesh of one rank runs the one-device code unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._private.device import DeviceLike, resolve_device
from ..parallel import comm
from ..parallel.mesh import BATCH_AXES, P, axis_index, mesh_axis_size

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attention_impl: str = "xla"  # "xla" | "flash" (hand-written kernel)
    ce_impl: str = "xla"  # "xla" | "fused" (lm-head CE kernel; needs
    # B*S % 128 == 0, vocab % 128 == 0, no logit softcap)
    # logits softcap (Gemma-style) kept for generality; 0 disables.
    logit_softcap: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


# Stock configs, as in the reference (public architecture tables).
LLAMA_3_8B = LlamaConfig(
    vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, max_seq_len=8192, rope_theta=500000.0,
)
LLAMA_3_70B = LlamaConfig(
    vocab_size=128256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
    ffn_dim=28672, max_seq_len=8192, rope_theta=500000.0,
)
LLAMA_2_7B = LlamaConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
    ffn_dim=11008, max_seq_len=4096, rope_theta=10000.0,
)
LLAMA_TINY = LlamaConfig(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=256, max_seq_len=256, rope_theta=10000.0, remat=False,
)
LLAMA_BENCH = LlamaConfig(
    vocab_size=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
    ffn_dim=5632, max_seq_len=2048, rope_theta=10000.0,
)


def param_specs(config: LlamaConfig) -> Dict[str, Any]:
    """The spec of each parameter (``ray_tpu/models/llama.py:92``): fsdp
    splits each matrix's embedding-like dim, model (TP) the heads and the
    ffn hidden (the Megatron split)."""
    return {
        "embed": P("model", "fsdp"),              # (V, D): vocab split on TP
        "blocks": {
            "attn_norm": P(None, None),            # (L, D)
            "wq": P(None, "fsdp", "model", None),  # (L, D, H, hd)
            "wk": P(None, "fsdp", "model", None),  # (L, D, KVH, hd)
            "wv": P(None, "fsdp", "model", None),
            "wo": P(None, "model", None, "fsdp"),  # (L, H, hd, D)
            "mlp_norm": P(None, None),
            "w_gate": P(None, "fsdp", "model"),    # (L, D, F)
            "w_up": P(None, "fsdp", "model"),
            "w_down": P(None, "model", "fsdp"),    # (L, F, D)
        },
        "final_norm": P(None),                     # (D,)
        "lm_head": P("fsdp", "model"),             # (D, V)
    }


def make_dense_init(config: LlamaConfig, device: DeviceLike = None):
    """Scaled-normal initializer in config.param_dtype (shared by the
    dense and MoE model families): ``dense(generator, shape, fan_in)``
    draws a standard normal in f32 on ``device`` (the GPU unless "cpu" is
    asked) from ``generator``, which must live there, and scales it by
    1 / sqrt(fan_in)."""
    dev = resolve_device(device)

    def dense(generator: torch.Generator, shape, fan_in: int) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (x * (1.0 / math.sqrt(fan_in))).to(config.param_dtype)

    return dense


def init_attn_params(config: LlamaConfig, generator: torch.Generator, dense,
                     device: DeviceLike = None) -> Params:
    """Stacked attention sublayer params (norms + qkvo), the shared half
    of both families' block params; wq, wk, wv and wo are drawn from
    ``generator`` in that order."""
    c = config
    dev = resolve_device(device)
    hd, L = c.head_dim, c.n_layers

    def ones(shape):
        return torch.ones(shape, dtype=c.param_dtype, device=dev)

    return {
        "attn_norm": ones((L, c.dim)),
        "wq": dense(generator, (L, c.dim, c.n_heads, hd), c.dim),
        "wk": dense(generator, (L, c.dim, c.n_kv_heads, hd), c.dim),
        "wv": dense(generator, (L, c.dim, c.n_kv_heads, hd), c.dim),
        "wo": dense(generator, (L, c.n_heads, hd, c.dim), c.n_heads * hd),
        "mlp_norm": ones((L, c.dim)),
    }


def attn_param_count(config: LlamaConfig) -> int:
    """Per-layer params of the shared attention sublayer + both norms."""
    c = config
    return (2 * c.dim + c.dim * c.n_heads * c.head_dim
            + 2 * c.dim * c.n_kv_heads * c.head_dim
            + c.n_heads * c.head_dim * c.dim)


def init_params(generator: torch.Generator, config: LlamaConfig,
                device: DeviceLike = None) -> Params:
    """Scaled-normal init in config.param_dtype, stacked-layer layout.
    ``generator`` must live on ``device`` (the GPU unless "cpu" is asked).
    Draw order: embed, wq, wk, wv, wo, w_gate, w_up, w_down, lm_head."""
    c = config
    dev = resolve_device(device)
    dense = make_dense_init(c, dev)
    L = c.n_layers
    return {
        "embed": dense(generator, (c.vocab_size, c.dim), c.dim),
        "blocks": {
            **init_attn_params(c, generator, dense, dev),
            "w_gate": dense(generator, (L, c.dim, c.ffn_dim), c.dim),
            "w_up": dense(generator, (L, c.dim, c.ffn_dim), c.dim),
            "w_down": dense(generator, (L, c.ffn_dim, c.dim), c.ffn_dim),
        },
        "final_norm": torch.ones((c.dim,), dtype=c.param_dtype, device=dev),
        "lm_head": dense(generator, (c.dim, c.vocab_size), c.dim),
    }


def param_count(config: LlamaConfig) -> int:
    c = config
    per_layer = attn_param_count(c) + 3 * c.dim * c.ffn_dim
    return c.vocab_size * c.dim * 2 + c.n_layers * per_layer + c.dim


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def rope_table(config: LlamaConfig, seq_len: int,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # (S, hd/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) (or (B, S, hd/2) for shifted)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention_xla(q, k, v, config: LlamaConfig, *, causal: bool = True):
    """Grouped-query causal attention by einsum. q: (B, S, H, hd); k/v:
    (B, S, KVH, hd). Logits are cast to f32 after the product, as in the
    reference."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    q = q.reshape(B, S, KVH, G, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def _attention_ring(q, k, v, config: LlamaConfig, mesh):
    """Sequence-parallel attention: q, k and v hold this rank's block of
    the sequence (and its heads, when they are split over ``model``); the
    ring of ``ops/ring_attention.py`` carries K/V round the ``seq`` axis.
    Falls back to flash when there is no mesh or the seq axis is 1, as
    the reference's does."""
    from ..ops.attention import flash_attention
    from ..ops.ring_attention import ring_attention

    if mesh is None or mesh_axis_size(mesh, "seq") == 1:
        return flash_attention(q, k, v, causal=True)
    return ring_attention(q, k, v, mesh=mesh, axis_name="seq", causal=True)


def _attention(q, k, v, config: LlamaConfig, mesh=None):
    if config.attention_impl == "flash":
        from ..ops.attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    if config.attention_impl == "ring":
        return _attention_ring(q, k, v, config, mesh)
    if config.attention_impl != "xla":
        raise ValueError(
            f"unknown attention_impl {config.attention_impl!r}; "
            "expected 'xla', 'flash', or 'ring' (sequence parallel)"
        )
    return _attention_xla(q, k, v, config)


def _qkv(config: LlamaConfig, h: torch.Tensor, layer: Dict[str, torch.Tensor]):
    dt = config.dtype
    q = torch.einsum("bsd,dhk->bshk", h, layer["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, layer["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, layer["wv"].to(dt))
    return q, k, v


def _out_proj(config: LlamaConfig, attn: torch.Tensor, layer) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn, layer["wo"].to(config.dtype))


def _mlp_sublayer(config: LlamaConfig, x: torch.Tensor, layer, mesh=None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP + residual; over a mesh the hidden is this
    rank's ``model`` block and the product is summed after ``w_down``."""
    c = config
    h = rms_norm(x, layer["mlp_norm"], c.norm_eps)
    gate = h @ layer["w_gate"].to(c.dtype)
    up = h @ layer["w_up"].to(c.dtype)
    y = (F.silu(gate) * up) @ layer["w_down"].to(c.dtype)
    return x + (comm.psum(y, mesh, ("model",)) if mesh is not None else y)


def attention_sublayer(config: LlamaConfig, x: torch.Tensor,
                       layer: Dict[str, torch.Tensor],
                       cos: torch.Tensor, sin: torch.Tensor, mesh=None) -> torch.Tensor:
    """Pre-norm GQA attention + residual; over a mesh the heads are this
    rank's ``model`` block and the output projection is summed over it."""
    c = config
    h = rms_norm(x, layer["attn_norm"], c.norm_eps)
    q, k, v = _qkv(c, h, layer)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    y = _out_proj(c, _attention(q, k, v, c, mesh), layer)
    return x + (comm.psum(y, mesh, ("model",)) if mesh is not None else y)


def block_fn(config: LlamaConfig, x: torch.Tensor, layer: Dict[str, torch.Tensor],
             cos: torch.Tensor, sin: torch.Tensor, mesh=None) -> torch.Tensor:
    """One transformer block. x: (B, S, D) in config.dtype. Over a mesh,
    ``layer`` holds this rank's shards, gathered over fsdp here."""
    if mesh is not None:
        layer = comm.gather_layer(layer, param_specs(config)["blocks"], mesh, ("fsdp",))
    x = attention_sublayer(config, x, layer, cos, sin, mesh)
    return _mlp_sublayer(config, x, layer, mesh)


def seq_split(config: LlamaConfig, mesh) -> bool:
    """Whether the sequence is split over ``seq`` (ring attention)."""
    return (mesh is not None and config.attention_impl == "ring"
            and mesh_axis_size(mesh, "seq") > 1)


def split_axes(config: LlamaConfig, mesh) -> Tuple[str, ...]:
    """The axes a token's position is split over: the batch axes, and seq
    under ring attention; the other axes compute the same tokens."""
    return BATCH_AXES + (("seq",) if seq_split(config, mesh) else ())


def local_batch(config: LlamaConfig, mesh, inputs, targets, mask):
    """This rank's rows (dim 0 over data, fsdp) and, under ring attention,
    its block of the sequence (dim 1 over seq)."""
    out = [comm.local_part(t, mesh, BATCH_AXES, 0) for t in (inputs, targets, mask)]
    if seq_split(config, mesh):
        out = [comm.local_part(t, mesh, ("seq",), 1) for t in out]
    return out


def rope_for(config: LlamaConfig, seq_len: int, device, mesh):
    """The rope table of this rank's positions: 0..S-1, or its block's
    positions when the sequence is split over seq."""
    if not seq_split(config, mesh):
        return rope_table(config, seq_len, device=device)
    start = axis_index(mesh, "seq") * seq_len
    cos, sin = rope_table(config, start + seq_len, device=device)
    return cos[start:], sin[start:]


def embed_weight(params: Params, config: LlamaConfig, mesh) -> torch.Tensor:
    """``embed`` whole (gathered over every axis it is split on)."""
    w = params["embed"]
    return comm.gather_param(w, param_specs(config)["embed"], mesh) if mesh is not None else w


def head_weight(params: Params, config: LlamaConfig, mesh) -> torch.Tensor:
    """``lm_head`` whole (gathered over fsdp and model), in config.dtype."""
    w = params["lm_head"]
    if mesh is not None:
        w = comm.gather_param(w, param_specs(config)["lm_head"], mesh)
    return w.to(config.dtype)


def mean_loss(nll: torch.Tensor, mask, config: LlamaConfig, mesh) -> torch.Tensor:
    """The masked mean of per-token losses; over a mesh, the sum of the
    ranks' shares of the global mean."""
    if mesh is None:
        return masked_mean(nll, mask)
    return comm.loss_total(comm.mean_share(nll, mask, mesh, split_axes(config, mesh)), mesh)


def _layers(blocks: Dict[str, torch.Tensor]):
    """Every layer's weights as views of the stacked tensors. ``unbind``
    makes one view per layer in one op, so its backward stacks the layer
    gradients once; indexing layer by layer would add a full-size zero
    gradient per layer."""
    names = list(blocks)
    return [dict(zip(names, ws)) for ws in zip(*(blocks[n].unbind(0) for n in names))]


def forward_hidden(params: Params, tokens: torch.Tensor,
                   config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int -> final-norm hidden states (B, S, D) in
    config.dtype (everything except the lm-head projection). Over a mesh,
    ``tokens`` are this rank's rows (and sequence block under ring
    attention), and so are the hidden states."""
    c = config
    mesh = comm.active_mesh()
    S = tokens.shape[1]
    x = embed_weight(params, c, mesh).to(c.dtype)[tokens.long()]
    cos, sin = rope_for(c, S, x.device, mesh)
    remat = c.remat and torch.is_grad_enabled()
    for layer in _layers(params["blocks"]):
        if remat:
            x = checkpoint(block_fn, c, x, layer, cos, sin, mesh, use_reentrant=False)
        else:
            x = block_fn(c, x, layer, cos, sin, mesh)
    return rms_norm(x, params["final_norm"], c.norm_eps)


def _lm_head(config: LlamaConfig, x: torch.Tensor, params: Params) -> torch.Tensor:
    return (x @ head_weight(params, config, comm.active_mesh())).float()


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, V) float32 (over a mesh, this
    rank's rows and sequence block)."""
    c = config
    logits = _lm_head(c, forward_hidden(params, tokens, c), params)
    if c.logit_softcap:
        logits = torch.tanh(logits / c.logit_softcap) * c.logit_softcap
    return logits


def unpack_batch(batch: Dict[str, torch.Tensor]):
    """batch {"tokens": (B, S+1)} or {"inputs","targets"} [+"mask"]
    -> (inputs, targets, mask)."""
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:]
        return inputs, targets, mask
    return batch["inputs"], batch["targets"], batch.get("mask")


def masked_mean(nll: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked-mean reduction shared by every CE path."""
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def masked_ce(logits: torch.Tensor, targets: torch.Tensor, mask) -> torch.Tensor:
    return masked_mean(token_nll(logits, targets), mask)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy. batch: {"tokens": (B, S+1) int} or
    {"inputs": (B,S), "targets": (B,S)} with optional "mask".

    ce_impl="fused" routes the lm-head projection + softmax-CE through
    the fused kernel: f32 logits never reach device memory. Over a mesh
    the batch is the global one; each rank computes its rows (the fused
    CE's shape rule holds for them) and the result is the global loss.
    """
    c = config
    mesh = comm.active_mesh()
    inputs, targets, mask = unpack_batch(batch)
    if mesh is not None:
        inputs, targets, mask = local_batch(c, mesh, inputs, targets, mask)
    B, S = inputs.shape
    if c.ce_impl == "fused":
        # an explicit "fused" request that can't be honored must FAIL,
        # not silently run the plain path
        problems = []
        if c.logit_softcap:
            problems.append("logit_softcap is set")
        if (B * S) % 128 != 0:
            problems.append(f"B*S={B * S} not a multiple of 128")
        if c.vocab_size % 128 != 0:
            problems.append(f"vocab_size={c.vocab_size} not a multiple of 128")
        if problems:
            raise ValueError(
                "ce_impl='fused' not applicable: " + "; ".join(problems)
            )
        from ..ops.cuda_ce import fused_cross_entropy

        x = forward_hidden(params, inputs, c)
        nll = fused_cross_entropy(
            x.reshape(B * S, c.dim),
            head_weight(params, c, mesh),
            targets.reshape(B * S),
        ).reshape(B, S)
        return mean_loss(nll, mask, c, mesh)
    logits = forward(params, inputs, c)
    if mesh is None:
        return masked_ce(logits, targets, mask)
    return mean_loss(token_nll(logits, targets), mask, c, mesh)


# ---------------------------------------------------------------------
# KV-cache inference path (used by ray_tpu_torch.llm). The cache is
# updated IN PLACE (the reference returns a new cache from
# dynamic_update_slice; eager PyTorch saves the copy).
# ---------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch: int, max_seq: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Preallocated cache: k/v (L, B, max_seq, KVH, hd) in config.dtype."""
    c = config
    dev = resolve_device(device)
    shape = (c.n_layers, batch, max_seq, c.n_kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.dtype, device=dev),
        "v": torch.zeros(shape, dtype=c.dtype, device=dev),
    }


def _attention_cached(q, k_cache, v_cache, pos, config: LlamaConfig):
    """q (B, T, H, hd) new queries at absolute positions ``pos`` (B, T);
    k/v_cache (B, S, KVH, hd) hold all tokens written so far (including
    the new ones). Rows attend to cache slots <= their position. Logits
    are f32 products (the reference's preferred_element_type=f32)."""
    B, T, H, hd = q.shape
    S = k_cache.shape[1]
    KVH = k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, T, KVH, G, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("btkgh,bskh->bkgts", qg.float(), k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, None, :] <= pos[:, :, None]  # (B, T, S)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v_cache)
    return out.reshape(B, T, H, hd)


def forward_with_cache(params: Params, tokens: torch.Tensor,
                       cache: Dict[str, torch.Tensor], start_pos,
                       config: LlamaConfig):
    """Incremental forward: tokens (B, T) appended at per-sequence
    offsets ``start_pos`` (B,). Returns (logits (B, T, V) f32, cache);
    the cache is written in place and returned for the reference's
    calling convention.

    Every write must fit: ``start + T <= max_seq``. (The reference's
    dynamic_update_slice clamps a start that runs past the end backward
    over earlier rows; a torch slice would silently cut the write short.
    Neither is allowed here.)
    """
    c = config
    B, T = tokens.shape
    max_seq = cache["k"].shape[2]
    start = torch.as_tensor(start_pos).reshape(B).long()
    lo, hi = int(start.min()), int(start.max())
    if lo < 0 or hi + T > max_seq:
        raise ValueError(
            f"cache write out of range: start in [{lo}, {hi}], T={T}, max_seq={max_seq}")
    dev = tokens.device
    start = start.to(dev)
    x = params["embed"].to(c.dtype)[tokens.long()]
    cos_full, sin_full = rope_table(c, max_seq, device=dev)
    pos = start[:, None] + torch.arange(T, device=dev)[None, :]   # (B, T)
    cos, sin = cos_full[pos], sin_full[pos]                      # (B, T, hd/2)
    rows = torch.arange(B, device=dev)[:, None]

    for i, layer in enumerate(_layers(params["blocks"])):
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, layer)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_c, v_c = cache["k"][i], cache["v"][i]
        # scatter the T new k/v rows into each sequence's slot range
        k_c[rows, pos] = k.to(k_c.dtype)
        v_c[rows, pos] = v.to(v_c.dtype)
        attn = _attention_cached(q, k_c, v_c, pos, c)
        x = x + _out_proj(c, attn, layer)
        x = _mlp_sublayer(c, x, layer)

    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return _lm_head(c, x, params), cache


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Approx training FLOPs/token: 6*N matmul + attention term."""
    n = param_count(config) - config.vocab_size * config.dim  # non-embed approx
    attn = 12 * config.n_layers * config.dim * seq_len  # 2*2*3 * L * D * S
    return 6.0 * n + attn
