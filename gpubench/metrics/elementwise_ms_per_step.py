"""Device time a step of kernels that are neither GEMMs, nor under the
attention or cross-entropy ops, nor NCCL's: the optimizer, casts, norms,
rotary embeddings, activations and the MoE gating (traced window)."""

OPS = ("_FlashAttention", "_FusedCrossEntropy")


def read(run):
    t = run["trace"]
    if t is None or not t["launches"]:
        return None
    under_ops = sum(o["kernel_s"] + o["backward_kernel_s"] for o in t["ops"].values())
    return 1e3 * (t["kernel_s"] - t["gemm_s"] - under_ops - t["nccl_kernel_s"]) / run["window"]["steps"]
