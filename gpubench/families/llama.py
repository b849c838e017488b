"""The Llama block family (``ray_tpu_torch/models/llama.py``): the dense
decoder of the Mistral cells.

Program side: ``model_config`` builds ``llama.LlamaConfig`` from a
configuration file and gives ``llama.loss_fn``; ``param_specs`` is the
program's own ``llama.param_specs``.

Yardstick side (nothing of the program): the leaves of the stacked-layer
tree under the program's key names; the FLOP counts of a training token;
and ``Model``, the plain float32 reference:

- the model as the configuration publishes it: token embedding, per layer
  RMSNorm, grouped-query causal attention with rotary embeddings (the two
  halves of each head rotated, angles in float32 as the published
  implementation computes them), the output projection, RMSNorm and a
  SwiGLU MLP; then the final RMSNorm, the lm head and the mean next-token
  cross entropy;
- gradients by hand, layer by layer: the forward keeps each layer's input,
  the backward runs the layer again under autograd, so the memory holds
  one layer's work at a time; attention and the cross entropy walk blocks
  of rows (``_CausalAttention``, ``_ChunkedCE``).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from gpubench.weights import Leaf

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict):
    """(the program's ``LlamaConfig`` for ``cfg``, ``llama.loss_fn``)."""
    from ray_tpu_torch.models import llama

    run = cfg["program"]
    if cfg["hidden_size"] // cfg["num_attention_heads"] != cfg["head_dim"]:
        raise ValueError("the program derives head_dim as hidden_size / num_attention_heads")
    return llama.LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        ffn_dim=cfg["intermediate_size"], max_seq_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=DTYPES[run["dtype"]], param_dtype=DTYPES[run["param_dtype"]],
        remat=run["remat"], attention_impl=run["attention_impl"],
        ce_impl=run["ce_impl"]), llama.loss_fn


def param_specs(mcfg):
    """The program's partition spec of each leaf (``llama.param_specs``)."""
    from ray_tpu_torch.models import llama

    return llama.param_specs(mcfg)


def leaves(cfg: dict) -> List[Leaf]:
    """The leaves of the tree, in the tree's order: the stacked blocks, then
    the embedding, the final norm and the lm head."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F_, L = cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    return [
        Leaf("blocks.attn_norm", (L, D), None, True),
        Leaf("blocks.wq", (L, D, H, hd), D, True),
        Leaf("blocks.wk", (L, D, KVH, hd), D, True),
        Leaf("blocks.wv", (L, D, KVH, hd), D, True),
        Leaf("blocks.wo", (L, H, hd, D), H * hd, True),
        Leaf("blocks.mlp_norm", (L, D), None, True),
        Leaf("blocks.w_gate", (L, D, F_), D, True),
        Leaf("blocks.w_up", (L, D, F_), D, True),
        Leaf("blocks.w_down", (L, F_, D), F_, True),
        Leaf("embed", (V, D), D, False),
        Leaf("final_norm", (D,), None, False),
        Leaf("lm_head", (D, V), D, False),
    ]


def matmul_params_per_token(cfg: dict) -> int:
    """The matmul parameters a token touches: every layer's projections
    and the lm head (the embedding is a lookup)."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F_, L = cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
    return L * (attn + 3 * D * F_) + D * V


def attention_flops_per_token(cfg: dict, seq_len: int) -> float:
    """6 L S D for causal attention: forward 2 L S D (QK^T and PV over half
    of the S x S square each), backward twice that."""
    return 6.0 * cfg["num_hidden_layers"] * seq_len * cfg["hidden_size"]


def _block_rows(heads: int, seq_len: int) -> int:
    """Query rows per attention block: the scores of a block (heads x rows
    x keys, float32) stay under 2 GiB."""
    rows = seq_len
    while rows > 64 and heads * rows * seq_len > 2 ** 29:
        rows //= 2
    return rows


class _CausalAttention(torch.autograd.Function):
    """Causal GQA attention on q (B, S, H, hd), k/v (B, S, KVH, hd), a
    block of query rows at a time against the keys it sees; the backward
    forms each block's probabilities again from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, num):
        B, S, H, hd = q.shape
        KVH = k.shape[2]
        G = H // KVH
        n = _block_rows(H, S)
        scale = 1.0 / math.sqrt(hd)
        o = torch.empty_like(q)
        lse = torch.empty((B, KVH, G, S), dtype=torch.float32, device=q.device)
        for b in range(B):
            kh, vh = k[b].transpose(0, 1), v[b].transpose(0, 1)          # (KVH, S, hd)
            for s0 in range(0, S, n):
                s1 = min(s0 + n, S)
                qb = _q_block(q, b, s0, s1, KVH, G)                       # (KVH, G*m, hd)
                sc = _scores(qb, kh[:, :s1], num, scale, G, s0, s1)       # (KVH, G*m, s1)
                l = torch.logsumexp(sc, dim=-1)
                p = sc.sub_(l[..., None]).exp_()
                ob = torch.bmm(num.q(p), num.q(vh[:, :s1]))               # (KVH, G*m, hd)
                o[b, s0:s1] = ob.view(KVH, G, s1 - s0, hd).permute(2, 0, 1, 3).reshape(
                    s1 - s0, H, hd)
                lse[b, :, :, s0:s1] = l.view(KVH, G, s1 - s0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num = num
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        num = ctx.num
        B, S, H, hd = q.shape
        KVH = k.shape[2]
        G = H // KVH
        n = _block_rows(H, S)
        scale = 1.0 / math.sqrt(hd)
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for b in range(B):
            kh, vh = k[b].transpose(0, 1), v[b].transpose(0, 1)
            dkh, dvh = dk[b].transpose(0, 1), dv[b].transpose(0, 1)       # views
            for s0 in range(0, S, n):
                s1 = min(s0 + n, S)
                m = s1 - s0
                qb = _q_block(q, b, s0, s1, KVH, G)
                dob = _q_block(do, b, s0, s1, KVH, G)
                ob = _q_block(o, b, s0, s1, KVH, G)
                l = lse[b, :, :, s0:s1].reshape(KVH, G * m)
                p = _scores(qb, kh[:, :s1], num, scale, G, s0, s1).sub_(l[..., None]).exp_()
                dvh[:, :s1] += torch.bmm(num.q(p).transpose(1, 2), num.q(dob))
                dp = torch.bmm(num.q(dob), num.q(vh[:, :s1]).transpose(1, 2))
                delta = (dob * ob).sum(-1, keepdim=True)
                ds = dp.sub_(delta).mul_(p).mul_(scale)
                del p, dp
                dqb = torch.bmm(num.q(ds), num.q(kh[:, :s1]))             # (KVH, G*m, hd)
                dq[b, s0:s1] = dqb.view(KVH, G, m, hd).permute(2, 0, 1, 3).reshape(m, H, hd)
                dkh[:, :s1] += torch.bmm(num.q(ds).transpose(1, 2), num.q(qb))
        return dq, dk, dv, None


def _q_block(t, b, s0, s1, KVH, G):
    """Rows s0:s1 of sequence b of a (B, S, H, hd) tensor as (KVH, G*m, hd),
    query head h = kv head h // G."""
    m, hd = s1 - s0, t.shape[-1]
    return t[b, s0:s1].reshape(m, KVH, G, hd).permute(1, 2, 0, 3).reshape(KVH, G * m, hd)


def _scores(qb, kh, num, scale, G, s0, s1):
    """Scaled scores of a block of queries against keys 0:s1, with the keys
    after each query masked to -inf."""
    sc = torch.bmm(num.q(qb), num.q(kh).transpose(1, 2)).mul_(scale)     # (KVH, G*m, s1)
    m = s1 - s0
    future = torch.ones((m, m), dtype=torch.bool, device=sc.device).triu_(1)
    sc.view(sc.shape[0], G, m, s1)[..., s0:s1].masked_fill_(future, float("-inf"))
    return sc


class _ChunkedCE(torch.autograd.Function):
    """Mean cross entropy of logits x @ w against targets, a chunk of rows
    at a time (logits float32, never whole)."""

    @staticmethod
    def forward(ctx, x, w, targets, num):
        N, V = x.shape[0], w.shape[1]
        rows = max(1, 2 ** 28 // V)
        lse = torch.empty(N, dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for r0 in range(0, N, rows):
            logits = num.q(x[r0:r0 + rows]) @ num.q(w)
            lse[r0:r0 + rows] = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, targets[r0:r0 + rows, None])[:, 0]
            total += (lse[r0:r0 + rows] - picked).sum(dtype=torch.float64)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.num, ctx.rows = num, rows
        return (total / N).float()

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        num, rows = ctx.num, ctx.rows
        N = x.shape[0]
        dx, dw = torch.empty_like(x), torch.zeros_like(w)
        for r0 in range(0, N, rows):
            xc = x[r0:r0 + rows]
            p = (num.q(xc) @ num.q(w)).sub_(lse[r0:r0 + rows, None]).exp_()
            p[torch.arange(p.shape[0], device=p.device), targets[r0:r0 + rows]] -= 1.0
            p.mul_(g / N)
            dx[r0:r0 + rows] = num.q(p) @ num.q(w).T
            dw += num.q(xc).T @ num.q(p)
        return dx, dw, None, None


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(cfg: dict, seq_len: int, device):
    hd = cfg["head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                     device=device) / hd))
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float32, device=device), inv)
    return ang.cos(), ang.sin()


def rope(x, cos, sin):
    """x (B, S, heads, hd): the halves of each head rotated by the angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Model:
    """The configuration's forward and backward, a layer at a time."""

    def __init__(self, cfg: dict, num):
        """``num``: how products are taken (``reference.Numerics``)."""
        self.cfg, self.num = cfg, num
        self.L = cfg["num_hidden_layers"]

    def attention(self, p, x, B, S, cos, sin):
        c, num = self.cfg, self.num
        D, H, KVH, hd = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        h = rms_norm(x, p["attn_norm"], c["rms_norm_eps"])
        q = num.mm(h, p["wq"].reshape(D, H * hd)).view(B, S, H, hd)
        k = num.mm(h, p["wk"].reshape(D, KVH * hd)).view(B, S, KVH, hd)
        v = num.mm(h, p["wv"].reshape(D, KVH * hd)).view(B, S, KVH, hd)
        o = _CausalAttention.apply(rope(q, cos, sin), rope(k, cos, sin), v, num)
        return x + num.mm(o.reshape(B * S, H * hd), p["wo"].reshape(H * hd, D))

    def mlp(self, p, x):
        c, num = self.cfg, self.num
        h = rms_norm(x, p["mlp_norm"], c["rms_norm_eps"])
        a = F.silu(num.mm(h, p["w_gate"])) * num.mm(h, p["w_up"])
        return x + num.mm(a, p["w_down"])

    def block(self, p, x, B, S, cos, sin):
        return self.mlp(p, self.attention(p, x, B, S, cos, sin))

    def loss_and_grads(self, params: dict, tokens: torch.Tensor, grads: dict = None,
                       scale: float = 1.0, pins=None):
        """(mean loss of the rows of ``tokens``, gradient tree): the gradient
        of ``scale`` x that mean, added into ``grads`` when given (a tree of
        ``params``' layout), else into a tree of zeros. The family pins
        nothing: ``pins`` is None."""
        c = self.cfg
        B, S = tokens.shape[0], tokens.shape[1] - 1
        inputs, targets = tokens[:, :-1].reshape(-1), tokens[:, 1:].reshape(-1)
        cos, sin = rope_tables(c, S, tokens.device)
        names = [lf.name.split(".", 1)[1] for lf in leaves(c) if lf.layered]
        blocks = params["blocks"]
        if grads is None:
            grads = {"blocks": {n: torch.zeros_like(blocks[n]) for n in names},
                     **{n: torch.zeros_like(params[n]) for n in ("final_norm", "lm_head", "embed")}}
        xs = []
        with torch.no_grad():
            x = params["embed"][inputs]
            for l in range(self.L):
                xs.append(x)
                x = self.block({n: blocks[n][l] for n in names}, x, B, S, cos, sin)
        with torch.enable_grad():
            xf = x.detach().requires_grad_()
            fn = params["final_norm"].detach().requires_grad_()
            head = params["lm_head"].detach().requires_grad_()
            ce = _ChunkedCE.apply(rms_norm(xf, fn, c["rms_norm_eps"]), head, targets, self.num)
            ce.backward(torch.full_like(ce, scale))
        grads["final_norm"].add_(fn.grad)
        grads["lm_head"].add_(head.grad)
        dy = xf.grad
        del x, xf
        for l in reversed(range(self.L)):
            with torch.enable_grad():
                xl = xs.pop().requires_grad_()
                layer = {n: blocks[n][l].detach().requires_grad_() for n in names}
                y = self.block(layer, xl, B, S, cos, sin)
                torch.autograd.backward(y, dy)
            for n in names:
                grads["blocks"][n][l] += layer[n].grad
            dy = xl.grad
            del xl, layer, y
        grads["embed"].index_add_(0, inputs, dy)
        return float(ce.detach()), grads
