"""ViT, the vision transformer family, PyTorch port of
``ray_tpu/models/vit.py``: patchify -> pre-norm encoder (GELU MLP,
learned position embeddings, CLS token) -> classification head.

Same layout and cast points as the reference:
- images come in NHWC; patchify is a reshape and transpose, and the
  projection a matrix product (no convolution);
- parameters are stacked over layers under the reference's key names,
  ``param_dtype`` f32 and the working ``dtype`` bf16 by default;
- layer norm takes the mean and the population variance in x's dtype, as
  ``jnp.mean`` and ``jnp.var`` do (not ``F.layer_norm``, which computes in
  f32 inside);
- GELU is the tanh form (``jax.nn.gelu``'s default ``approximate=True``);
- attention is non-causal einsum attention with an f32 softmax. The
  reference has no kernel for it, and the port adds none.

``remat`` runs each block under ``torch.utils.checkpoint`` when grad is
enabled.

Over a mesh (``param_specs``) the forward is sharded as the Llama
families': each layer's fsdp shards gathered inside the block, heads and
the MLP hidden (with ``b1``) split over ``model`` with an all-reduce after
``wo`` and after ``w2`` (``b2`` added once, after it), the patch
projection, position table and head gathered whole; ``loss_fn`` takes the
global batch and keeps this rank's images (dim 0 over data and fsdp).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._private.device import DeviceLike, resolve_device
from ..parallel import comm
from ..parallel.mesh import BATCH_AXES, P
from .llama import _layers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    channels: int = 3
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


VIT_B_16 = ViTConfig()
VIT_L_16 = ViTConfig(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096)
VIT_TINY = ViTConfig(
    image_size=32, patch_size=8, num_classes=10, dim=64, n_layers=2,
    n_heads=4, mlp_dim=128, remat=False, dtype=torch.float32,
)


def param_specs(config: ViTConfig) -> Dict[str, Any]:
    """The mesh contract shared with the Llama families
    (``ray_tpu/models/vit.py:66``): heads and MLP on ``model``,
    embedding-like dims on ``fsdp``."""
    return {
        "patch_proj": P(None, "fsdp"),            # (patch_dim, D)
        "patch_bias": P(None),
        "cls": P(None),                            # (D,)
        "pos": P(None, "fsdp"),                    # (1+N, D)
        "blocks": {
            "ln1_scale": P(None, None),
            "ln1_bias": P(None, None),
            "wq": P(None, "fsdp", "model", None),  # (L, D, H, hd)
            "wk": P(None, "fsdp", "model", None),
            "wv": P(None, "fsdp", "model", None),
            "wo": P(None, "model", None, "fsdp"),
            "ln2_scale": P(None, None),
            "ln2_bias": P(None, None),
            "w1": P(None, "fsdp", "model"),        # (L, D, M)
            "b1": P(None, "model"),
            "w2": P(None, "model", "fsdp"),        # (L, M, D)
            "b2": P(None, None),
        },
        "head_norm_scale": P(None),
        "head_norm_bias": P(None),
        "head": P("fsdp", None),                   # (D, classes)
        "head_bias": P(None),
    }


def init_params(generator: torch.Generator, config: ViTConfig,
                device: DeviceLike = None) -> Params:
    """Params in ``param_dtype`` on ``device`` (the GPU unless "cpu" is
    asked), ``generator`` living there. Draw order: patch_proj, cls, pos,
    wq, wk, wv, wo, w1, w2, head."""
    c = config
    dev = resolve_device(device)
    hd, L = c.head_dim, c.n_layers

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (x * scale).to(c.param_dtype)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def const(shape, value):
        return torch.full(shape, value, dtype=c.param_dtype, device=dev)

    patch_proj = dense((c.patch_dim, c.dim), c.patch_dim)
    cls = normal((c.dim,), 0.02)
    pos = normal((1 + c.n_patches, c.dim), 0.02)
    wq = dense((L, c.dim, c.n_heads, hd), c.dim)
    wk = dense((L, c.dim, c.n_heads, hd), c.dim)
    wv = dense((L, c.dim, c.n_heads, hd), c.dim)
    wo = dense((L, c.n_heads, hd, c.dim), c.dim)
    w1 = dense((L, c.dim, c.mlp_dim), c.dim)
    w2 = dense((L, c.mlp_dim, c.dim), c.mlp_dim)
    return {
        "patch_proj": patch_proj,
        "patch_bias": const((c.dim,), 0.0),
        "cls": cls,
        "pos": pos,
        "blocks": {
            "ln1_scale": const((L, c.dim), 1.0),
            "ln1_bias": const((L, c.dim), 0.0),
            "wq": wq, "wk": wk, "wv": wv, "wo": wo,
            "ln2_scale": const((L, c.dim), 1.0),
            "ln2_bias": const((L, c.dim), 0.0),
            "w1": w1,
            "b1": const((L, c.mlp_dim), 0.0),
            "w2": w2,
            "b2": const((L, c.dim), 0.0),
        },
        "head_norm_scale": const((c.dim,), 1.0),
        "head_norm_bias": const((c.dim,), 0.0),
        "head": dense((c.dim, c.num_classes), c.dim),
        "head_bias": const((c.num_classes,), 0.0),
    }


def param_count(config: ViTConfig) -> int:
    """The number of elements ``init_params`` makes, from the shapes."""
    c = config
    per_layer = (4 * c.dim                      # two layer norms
                 + 4 * c.dim * c.dim            # wq, wk, wv, wo (H * hd = dim)
                 + 2 * c.dim * c.mlp_dim + c.mlp_dim + c.dim)
    return (c.patch_dim * c.dim + c.dim             # patch projection
            + c.dim + (1 + c.n_patches) * c.dim     # cls, pos
            + c.n_layers * per_layer
            + 2 * c.dim + c.dim * c.num_classes + c.num_classes)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def patchify(images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch_dim), each patch's pixels row-major
    with the channels innermost."""
    c = config
    B, H, W, C = images.shape
    p = c.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, h, w, p, p, C)
    return x.reshape(B, c.n_patches, c.patch_dim)


def block_fn(config: ViTConfig, x: torch.Tensor,
             layer: Dict[str, torch.Tensor], mesh=None) -> torch.Tensor:
    c = config
    dt = c.dtype
    if mesh is not None:
        layer = comm.gather_layer(layer, param_specs(c)["blocks"], mesh, ("fsdp",))
    h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], c.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, layer["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h, layer["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h, layer["wv"].to(dt))
    logits = torch.einsum("bqhk,bthk->bhqt", q, k) / math.sqrt(c.head_dim)
    attn = torch.softmax(logits.float(), dim=-1).to(dt)
    o = torch.einsum("bhqt,bthk->bqhk", attn, v)
    y = torch.einsum("bshk,hkd->bsd", o, layer["wo"].to(dt))
    x = x + (comm.psum(y, mesh, ("model",)) if mesh is not None else y)

    h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], c.norm_eps)
    h = F.gelu(torch.einsum("bsd,dm->bsm", h, layer["w1"].to(dt)) + layer["b1"].to(dt),
               approximate="tanh")
    y = torch.einsum("bsm,md->bsd", h, layer["w2"].to(dt))
    if mesh is not None:
        y = comm.psum(y, mesh, ("model",))
    return x + (y + layer["b2"].to(dt))


def _whole(params: Params, name: str, config: ViTConfig, mesh) -> torch.Tensor:
    w = params[name]
    return comm.gather_param(w, param_specs(config)[name], mesh) if mesh is not None else w


def forward(params: Params, images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """images (B, H, W, C) float -> class logits (B, num_classes) f32 (over
    a mesh, this rank's images)."""
    c = config
    dt = c.dtype
    mesh = comm.active_mesh()
    B = images.shape[0]
    patches = patchify(images.to(dt), c)
    x = (torch.einsum("bnp,pd->bnd", patches, _whole(params, "patch_proj", c, mesh).to(dt))
         + params["patch_bias"].to(dt))
    cls = params["cls"].to(dt).expand(B, 1, c.dim)
    x = torch.cat([cls, x], dim=1) + _whole(params, "pos", c, mesh).to(dt)
    remat = c.remat and torch.is_grad_enabled()
    for layer in _layers(params["blocks"]):
        if remat:
            x = checkpoint(block_fn, c, x, layer, mesh, use_reentrant=False)
        else:
            x = block_fn(c, x, layer, mesh)
    x = _layer_norm(x[:, 0], params["head_norm_scale"], params["head_norm_bias"], c.norm_eps)
    logits = (torch.einsum("bd,dk->bk", x, _whole(params, "head", c, mesh).to(dt))
              + params["head_bias"].to(dt))
    return logits.float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], config: ViTConfig) -> torch.Tensor:
    """Softmax CE over the classes; batch {"image": (B,H,W,C), "label": (B,)}
    (over a mesh the global batch, and the global loss)."""
    mesh = comm.active_mesh()
    images, labels = batch["image"], batch["label"]
    if mesh is not None:
        images, labels = (comm.local_part(t, mesh, BATCH_AXES, 0) for t in (images, labels))
    logits = forward(params, images, config)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mesh is None:
        return torch.mean(nll)
    return comm.loss_total(comm.mean_share(nll, None, mesh, BATCH_AXES), mesh)
