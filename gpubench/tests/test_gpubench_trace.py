"""The trace reduction on a small hand-made Chrome trace, and the readers
that sit on it."""

import json

import pytest

from gpubench import registry, trace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace(tmp_path):
    events = [
        _ev("user_annotation", "gpubench.window", 0, 1000),
        _ev("cpu_op", "_FlashAttention", 10, 50, **{"External id": 1}),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=100),
        _ev("kernel", "flash_fwd_kernel", 100, 200, tid=7, correlation=100),
        _ev("cpu_op", "autograd::engine::evaluate_function: _FlashAttentionBackward", 400, 100,
            tid=2),
        _ev("cpu_op", "_FlashAttentionBackward", 401, 98, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 410, 5, tid=2, correlation=101),
        _ev("kernel", "flash_bwd_dq_kernel", 500, 100, tid=7, correlation=101),
        _ev("cpu_op", "aten::mm", 600, 20, **{"External id": 9}),
        _ev("kernel", "nvjet_tst_128x256_gemm", 700, 50, tid=7, **{"External id": 9}),
        _ev("cpu_op", "aten::add_", 760, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 765, 2, correlation=103),
        _ev("kernel", "vectorized_elementwise_kernel", 900, 40, tid=7, correlation=103),
        _ev("kernel", "outside_the_window", 2000, 10, tid=7, correlation=104),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_summary(tmp_path):
    s = trace.summarize(_trace(tmp_path), "gpubench.window", ["_FlashAttention"])
    us = 1e-6
    assert s["window_s"] == pytest.approx(1000 * us)
    assert s["busy_s"] == pytest.approx(390 * us) and s["launches"] == 4
    assert s["kernel_s"] == pytest.approx(390 * us) and s["gemm_s"] == pytest.approx(50 * us)
    op = s["ops"]["_FlashAttention"]
    assert (op["calls"], op["backward_calls"]) == (1, 1)
    assert op["kernel_s"] == pytest.approx(200 * us)
    assert op["backward_kernel_s"] == pytest.approx(100 * us)
    assert s["linked"] == {"correlation": 3, "external": 1}
    assert s["device_ops"][0] == ["flash_fwd_kernel", pytest.approx(200 * us)]
    gaps = dict((n, g) for n, g in s["idle_gaps"])
    assert gaps["aten::add_"] == pytest.approx(150 * us)    # 750 -> 900, launched in add_
    assert gaps["_FlashAttention"] == pytest.approx(100 * us)
    assert gaps["(window end)"] == pytest.approx(60 * us)


def test_readers_on_the_summary(tmp_path):
    s = trace.summarize(_trace(tmp_path), "gpubench.window", ["_FlashAttention"])
    run = {"trace": s, "window": {"steps": 2, "seconds": 1.0, "tokens": 10, "peak_bytes": 0},
           "peaks": {"bf16_flops": 1e12, "hbm_bytes": 1e12},
           "config": {"num_attention_heads": 2, "head_dim": 4, "num_key_value_heads": 1},
           "traffic": {"batch": 1, "seq_len": 8}, "batch_per_rank": 1, "chips": 1}
    assert registry.metric("launches_per_step").read(run) == 2.0
    assert registry.metric("device_idle_pct").read(run) == pytest.approx(61.0)
    # 390 us of kernels, 50 of GEMM, 300 under the op: 40 us over 2 steps
    assert registry.metric("elementwise_ms_per_step").read(run) == pytest.approx(0.02)
    # forward 2*1*2*64*4 = 1024 FLOP (448 bytes), backward 2560 FLOP (832 bytes):
    # both bound by operations at 1e12 a second, over 300 us of kernels
    want = 100 * (1024 + 2560) * 1e-12 / 300e-6
    assert registry.metric("attn_roofline_pct").read(run) == pytest.approx(want)
    run["trace"]["ops"]["_FusedCrossEntropy"] = {"calls": 0, "kernel_s": 0.0,
                                                 "backward_calls": 0, "backward_kernel_s": 0.0}
    assert registry.metric("ce_roofline_pct").read(run) is None
    run["trace"] = None
    assert registry.metric("attn_roofline_pct").read(run) is None



def test_nccl_time_that_compute_leaves_bare(tmp_path):
    """An NCCL kernel that overlaps compute only in part: its bare time is
    what the other kernels leave uncovered, and the readers see it."""
    events = [
        _ev("user_annotation", "gpubench.window", 0, 1000),
        _ev("kernel", "nvjet_tst_128x256_gemm", 100, 200, tid=7),
        _ev("kernel", "ncclDevKernel_AllGather_RING_LL", 250, 150, tid=8),     # 300-400 bare
        _ev("kernel", "vectorized_elementwise_kernel", 350, 20, tid=7),        # covers 350-370
        _ev("kernel", "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 500, 40, tid=8),
    ]
    path = tmp_path / "n.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path), "gpubench.window", [])
    us = 1e-6
    assert s["nccl_kernel_s"] == pytest.approx(190 * us)
    assert s["nccl_exposed_s"] == pytest.approx((80 + 40) * us)
    assert [n for n, _ in s["nccl_ops"]] == ["ncclDevKernel_AllGather_RING_LL",
                                             "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL"]
    assert [d for _, d in s["nccl_ops"]] == pytest.approx([150 * us, 40 * us])
    run = {"trace": s, "window": {"steps": 2}}
    assert registry.metric("nccl_exposed_ms_per_step").read(run) == pytest.approx(0.06)
    # NCCL's kernels are not elementwise work
    assert registry.metric("elementwise_ms_per_step").read(run) == pytest.approx(0.01)
    s_bare = trace.summarize(_trace(tmp_path), "gpubench.window", ["_FlashAttention"])
    assert s_bare["nccl_kernel_s"] == 0 and s_bare["nccl_exposed_s"] == 0 and s_bare["nccl_ops"] == []
    assert registry.metric("nccl_exposed_ms_per_step").read({"trace": s_bare}) is None
