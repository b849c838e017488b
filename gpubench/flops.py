"""Frozen counts of model FLOPs and of the work of the two ops whose
rooflines the benchmark reports.

Model FLOPs of a training token: 6 x the matmul parameters a token touches
plus the attention's FLOPs, both as the configuration's family counts them
(``families/<family>.py``). Recompute under remat is not counted: it is
the program's choice, not the model's work.
"""

from __future__ import annotations

from . import registry


def matmul_params_per_token(cfg: dict) -> int:
    return registry.family(cfg["program"]["family"]).matmul_params_per_token(cfg)


def train_flops_per_token(cfg: dict, seq_len: int) -> float:
    fam = registry.family(cfg["program"]["family"])
    return 6.0 * fam.matmul_params_per_token(cfg) + fam.attention_flops_per_token(cfg, seq_len)


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
