"""Plain float32 reference of the training steps the cells drive.

It imports nothing of the program. From the seed it makes the same
weights (``weights.py``) and batches (``traffic.py``) the program is
given, and works out the first ``check_steps`` steps itself:

- the model as the configuration publishes it: token embedding, per layer
  RMSNorm, grouped-query causal attention with rotary embeddings (the two
  halves of each head rotated, angles in float32 as the published
  implementation computes them), the output projection, RMSNorm and a
  SwiGLU MLP; then the final RMSNorm, the lm head and the mean next-token
  cross entropy;
- gradients by hand, layer by layer: the forward keeps each layer's input,
  the backward runs the layer again under autograd, so the memory holds
  one layer's work at a time; attention and the cross entropy walk blocks
  of rows (``_CausalAttention``, ``_ChunkedCE``);
- clip by global norm, then AdamW (optax's formulas, bias-corrected, the
  weight decay added to the Adam direction, a warmup-cosine schedule read
  before the count is incremented); the moments live on the host between
  steps.

Every product is float32 with TF32 off. ``Numerics(fp8=True)`` rounds both
operands of every product (forward and backward) to float8 e4m3 with one
scale per tensor: the control, one precision below the program's bf16.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import traffic as traffic_gen
from . import weights

F8_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude goes to 448), returned in ``t``'s dtype."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, F8_MAX / amax, torch.ones_like(amax))
    q = (t * scale).clamp_(-F8_MAX, F8_MAX).to(torch.float8_e4m3fn)
    return q.to(t.dtype) / scale


class _MatmulFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_fp8(a) @ to_fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = to_fp8(g)
        return g8 @ to_fp8(b).transpose(-1, -2), to_fp8(a).transpose(-1, -2) @ g8


class Numerics:
    """How the reference multiplies: float32, or float8 operands (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return to_fp8(t) if self.fp8 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (n, k) @ b (k, m), differentiable."""
        return _MatmulFP8.apply(a, b) if self.fp8 else a @ b


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

    def __init__(self, cfg: dict, num: Numerics):
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

    def loss_and_grads(self, params: dict, tokens: torch.Tensor):
        """(mean loss, gradient tree) of one batch."""
        c = self.cfg
        B, S = tokens.shape[0], tokens.shape[1] - 1
        inputs, targets = tokens[:, :-1].reshape(-1), tokens[:, 1:].reshape(-1)
        cos, sin = rope_tables(c, S, tokens.device)
        names = [lf.name.split(".", 1)[1] for lf in weights.leaves(c) if lf.layered]
        blocks = params["blocks"]
        grads = {"blocks": {n: torch.zeros_like(blocks[n]) for n in names}}
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
            ce.backward()
        grads["final_norm"], grads["lm_head"] = fn.grad, head.grad
        dy = xf.grad
        del x, xf
        for l in reversed(range(self.L)):
            with torch.enable_grad():
                xl = xs.pop().requires_grad_()
                leaves = {n: blocks[n][l].detach().requires_grad_() for n in names}
                y = self.block(leaves, xl, B, S, cos, sin)
                torch.autograd.backward(y, dy)
            for n in names:
                grads["blocks"][n][l] = leaves[n].grad
            dy = xl.grad
            del xl, leaves, y
        grads["embed"] = torch.zeros_like(params["embed"]).index_add_(0, inputs, dy)
        return float(ce.detach()), grads


def schedule(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, max(total,
    warmup + 1)) at ``count``."""
    peak, warm = opt.get("learning_rate", 3e-4), opt.get("warmup_steps", 100)
    decay = max(opt.get("total_steps", 10000), warm + 1)
    if count < warm:
        return peak * count / warm
    t = min(count - warm, decay - warm)
    return peak * 0.5 * (1 + math.cos(math.pi * t / (decay - warm)))


def _flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run(cfg: dict, traffic: dict, seed: int, device, num: Numerics = None) -> dict:
    """The reference's readings of the first ``check_steps`` steps: each
    step's loss, each leaf's gradient norm and a seeded sample of its
    elements in the first step (before clipping), and each leaf's change
    after the last, its norm and its elements at the same positions."""
    num = num or Numerics()
    opt = traffic["optimizer"]
    b1, b2, eps = opt.get("b1", 0.9), opt.get("b2", 0.95), 1e-8
    wd, clip = opt.get("weight_decay", 0.1), opt.get("grad_clip", 1.0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = weights.make(cfg, seed, device)
        flat = _flat(params)
        model = Model(cfg, num)
        moments = None
        out = {"losses": []}
        for step in range(1, traffic["check_steps"] + 1):
            tokens = traffic_gen.batch(traffic, cfg["vocab_size"], seed, step, device)["tokens"]
            loss, grads = model.loss_and_grads(params, tokens)
            g = _flat(grads)
            norms = {n: float(torch.linalg.vector_norm(t)) for n, t in g.items()}
            gnorm = math.sqrt(sum(v * v for v in norms.values()))
            out["losses"].append(loss)
            if step == 1:
                out["grad_norms"] = norms
                out["grad_sample"] = weights.sample(cfg, seed, grads)
            factor = 1.0 if gnorm < clip else clip / gnorm
            lr = schedule(opt, step - 1)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            new_moments = {}
            for n, p in flat.items():
                gc = g.pop(n).mul_(factor)
                if moments is None:
                    mu, nu = (1 - b1) * gc, (1 - b2) * gc * gc
                else:
                    mu, nu = (t.to(device) for t in moments.pop(n))
                    mu.mul_(b1).add_((1 - b1) * gc)
                    nu.mul_(b2).add_((1 - b2) * gc * gc)
                del gc
                u = (mu / bc1) / ((nu / bc2).sqrt_() + eps) + wd * p
                p.sub_(lr * u)
                del u
                if step < traffic["check_steps"]:
                    new_moments[n] = (mu.cpu(), nu.cpu())
                del mu, nu
            del grads, g
            moments = new_moments
        del moments
        out["update_norms"], out["update_sample"] = weights.change(cfg, seed, params)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

