"""Frozen counts of model FLOPs and of the work of the two ops whose
rooflines the benchmark reports.

Model FLOPs of a training token: 6 x the matmul parameters a token touches
(the lm head in, the embedding out), plus 6 L S D for causal attention
(forward 2 L S D: QK^T and PV over half of the S x S square each;
backward twice that). Recompute under remat is not counted: it is the
program's choice, not the model's work.
"""

from __future__ import annotations


def matmul_params_per_token(cfg: dict) -> int:
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F, L = cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
    return L * (attn + 3 * D * F) + D * V


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    return 6.0 * matmul_params_per_token(cfg) + 6.0 * cfg["num_hidden_layers"] * seq_len * cfg["hidden_size"]


def attention_call(batch: int, heads: int, seq_len: int, head_dim: int, kv_heads: int,
                   backward: bool) -> tuple:
    """(FLOPs, bytes) of one causal attention call in bf16: forward
    2 B H S^2 hd (QK^T and PV over the causal half), backward 5 B H S^2 hd
    (the scores again, dP, dV, dQ, dK). Bytes: each input read once, each
    output written once (forward q, k, v -> o, lse; backward q, k, v, o,
    dO, lse -> dq, dk, dv)."""
    qo = batch * seq_len * heads * head_dim * 2
    kv = batch * seq_len * kv_heads * head_dim * 2
    lse = batch * heads * seq_len * 4
    if backward:
        return 5.0 * batch * heads * seq_len ** 2 * head_dim, 3 * qo + 2 * kv + lse + qo + 2 * kv
    return 2.0 * batch * heads * seq_len ** 2 * head_dim, qo + 2 * kv + qo + lse


def ce_call(rows: int, dim: int, vocab: int, backward: bool) -> tuple:
    """(FLOPs, bytes) of one fused lm-head cross entropy call in bf16:
    forward 2 N D V (the logits), backward 4 N D V (dx and dW). Bytes:
    forward x, W, targets -> per-row loss; backward x, W, targets, lse,
    dloss -> dx, dW."""
    x, w = rows * dim * 2, dim * vocab * 2
    if backward:
        return 4.0 * rows * dim * vocab, 2 * x + 2 * w + rows * 12
    return 2.0 * rows * dim * vocab, x + w + rows * 8
