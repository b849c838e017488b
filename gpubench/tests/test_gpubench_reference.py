"""The float32 reference against plain runs at tiny sizes: a whole-batch
autograd run of the same model written out flat, and the program's own
float32 paths (einsum attention, full-logit CE) through its train step.
The Llama family's reference (``families/llama.py``) against the same,
and against what it read before it moved there."""

import math

import pytest
import torch
import torch.nn.functional as F

from gpubench import check, program, reference, traffic as traffic_gen, weights
from gpubench.families import llama
from gpubench.tests import tiny


def naive_loss(cfg, params, tokens):
    """The model of reference.py in one autograd graph, with whole
    attention matrices."""
    B, S = tokens.shape[0], tokens.shape[1] - 1
    D, H, KVH, hd = (cfg[k] for k in ("hidden_size", "num_attention_heads",
                                      "num_key_value_heads", "head_dim"))
    G, eps = H // KVH, cfg["rms_norm_eps"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    cos, sin = llama.rope_tables(cfg, S, tokens.device)
    x = params["embed"][inputs]                                   # (B, S, D)
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    bl = params["blocks"]
    for l in range(cfg["num_hidden_layers"]):
        h = llama.rms_norm(x, bl["attn_norm"][l], eps)
        q = llama.rope(torch.einsum("bsd,dhk->bshk", h, bl["wq"][l]), cos, sin)
        k = llama.rope(torch.einsum("bsd,dhk->bshk", h, bl["wk"][l]), cos, sin)
        v = torch.einsum("bsd,dhk->bshk", h, bl["wv"][l])
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhk,bthk->bhqt", q, k) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        x = x + torch.einsum("bhqt,bthk,hkd->bqd", p, v, bl["wo"][l])
        h = llama.rms_norm(x, bl["mlp_norm"][l], eps)
        x = x + (F.silu(h @ bl["w_gate"][l]) * (h @ bl["w_up"][l])) @ bl["w_down"][l]
    h = llama.rms_norm(x, params["final_norm"], eps)
    ce = F.cross_entropy((h @ params["lm_head"]).reshape(B * S, -1), targets.reshape(-1))
    return ce


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def test_reference_gradients_equal_a_whole_graph_run():
    cfg = tiny.LLAMA
    torch.manual_seed(0)
    dev = torch.device("cpu")
    tokens = traffic_gen.batch(tiny.TRAFFIC, cfg["vocab_size"], 5, 1, dev)["tokens"]
    params = weights.make(cfg, 5, dev)
    loss, grads = llama.Model(cfg, reference.Numerics()).loss_and_grads(params, tokens)
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    want = naive_loss(cfg, params, tokens)
    want_grads = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    assert loss == pytest.approx(float(want.detach()), rel=1e-5)
    for name, g in _flat(grads).items():
        torch.testing.assert_close(g, want_grads[name], rtol=1e-4, atol=1e-6, msg=name)


def test_reference_follows_the_programs_float32_paths():
    """Three steps of the program on its plain float32 paths (the same
    train step, optimizer and feed as the cells) read what the reference
    reads, to float32 rounding."""
    cfg, dev = tiny.LLAMA, torch.device("cpu")
    plain = tiny.f32(cfg)
    state, step = program.setup(plain, tiny.TRAFFIC, 11, dev)
    _, prog = program.first_steps(state, step, plain, tiny.TRAFFIC, 11, dev)
    ref = reference.run(cfg, tiny.TRAFFIC, 11, dev)
    gaps = check.gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_norm_gap"] < 1e-5
    assert gaps["update_norm_gap"] < 1e-4 and gaps["update_sample_err"] < 1e-3, gaps


def test_schedule_is_optax_warmup_cosine():
    opt = {"learning_rate": 1.0, "warmup_steps": 4, "total_steps": 12}
    assert [reference.schedule(opt, c) for c in (0, 2, 4)] == [0.0, 0.5, 1.0]
    assert reference.schedule(opt, 8) == pytest.approx(0.5)
    assert reference.schedule(opt, 12) == pytest.approx(0.0)
    assert reference.schedule({"learning_rate": 2.0, "warmup_steps": 0}, 0) == 2.0


def test_weights_remade_slice_by_slice():
    cfg = tiny.LLAMA
    params = weights.make(cfg, 3, torch.device("cpu"))
    for leaf in weights.leaves(cfg):
        t = weights.get(params, leaf.name)
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        for l in range(leaf.shape[0] if leaf.layered else 1):
            again = weights.layer_slice(cfg, 3, leaf, l, torch.device("cpu"))
            assert torch.equal(t[l] if leaf.layered else t, again)
    norms, picked = weights.change(cfg, 3, params)
    assert all(v == 0 for v in norms.values())
    assert all(x == 0 for v in picked.values() for x in v)
    assert list(picked) == list(weights.sample(cfg, 3, params))


def test_change_reads_the_sampled_positions():
    """``change`` picks each leaf's change at the positions ``sample`` reads."""
    cfg, dev = tiny.LLAMA, torch.device("cpu")
    params = weights.make(cfg, 4, dev)
    start = weights.make(cfg, 4, dev)
    for leaf in weights.leaves(cfg):
        weights.get(params, leaf.name).add_(torch.randn(leaf.shape))
    delta = {"blocks": {}}
    for leaf in weights.leaves(cfg):
        weights.put(delta, leaf.name, weights.get(params, leaf.name) - weights.get(start, leaf.name))
    norms, picked = weights.change(cfg, 4, params)
    want = weights.sample(cfg, 4, delta)
    for leaf in weights.leaves(cfg):
        torch.testing.assert_close(torch.tensor(picked[leaf.name]), torch.tensor(want[leaf.name]))
        assert norms[leaf.name] == pytest.approx(float(weights.get(delta, leaf.name).norm()), rel=1e-5)
