"""The attention op's share of its roofline: each forward and backward
call of ``_FlashAttention`` in the traced window is credited with the
causal work of that call at the cell's shapes and a rank's rows
(``flops.attention_call``); its least time, max(FLOPs / bf16 peak, bytes /
HBM peak), summed over the calls, over the device time of the kernels
launched under those calls."""

from gpubench import flops

OPS = ("_FlashAttention",)


def read(run):
    t, peak = run["trace"], run["peaks"]
    if t is None or peak is None:
        return None
    op = t["ops"]["_FlashAttention"]
    seconds = op["kernel_s"] + op["backward_kernel_s"]
    if seconds <= 0:
        return None
    c, tr = run["config"], run["traffic"]
    shape = (run["batch_per_rank"], c["num_attention_heads"], tr["seq_len"], c["head_dim"],
             c["num_key_value_heads"])
    least = 0.0
    for calls, backward in ((op["calls"], False), (op["backward_calls"], True)):
        f, b = flops.attention_call(*shape, backward=backward)
        least += calls * max(f / peak["bf16_flops"], b / peak["hbm_bytes"])
    return 100.0 * least / seconds
