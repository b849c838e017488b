"""The fused lm-head cross entropy's share of its roofline: each forward
and backward call of ``_FusedCrossEntropy`` in the traced window is
credited with 2 N D V (forward) or 4 N D V (backward) at a rank's rows
(``flops.ce_call``); its least time, max(FLOPs / bf16 peak, bytes / HBM
peak), over the device time of the kernels launched under those calls."""

from gpubench import flops

OPS = ("_FusedCrossEntropy",)


def read(run):
    t, peak = run["trace"], run["peaks"]
    if t is None or peak is None:
        return None
    op = t["ops"]["_FusedCrossEntropy"]
    seconds = op["kernel_s"] + op["backward_kernel_s"]
    if seconds <= 0:
        return None
    c, tr = run["config"], run["traffic"]
    rows = run["batch_per_rank"] * tr["seq_len"]
    least = 0.0
    for calls, backward in ((op["calls"], False), (op["backward_calls"], True)):
        f, b = flops.ce_call(rows, c["hidden_size"], c["vocab_size"], backward=backward)
        least += calls * max(f / peak["bf16_flops"], b / peak["hbm_bytes"])
    return 100.0 * least / seconds
