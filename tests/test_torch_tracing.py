"""``util.tracing.span`` in the port's train step: one span, two sinks.

With tracing off and no profiler a span builds nothing (no record, no
clock, no ``record_function``); under ``torch.profiler`` the train step's
spans and the Llama block's land in the Chrome trace as
``user_annotation`` ranges (the block's twice under remat: the forward and
the recompute); with tracing on they become records for the hub.
"""

import dataclasses
import json

import pytest
import torch
import torch_mesh_ranks as ranks

from ray_tpu_torch import parallel
from ray_tpu_torch.models import llama
from ray_tpu_torch.util import tracing

STEP_SPANS = ["train_step.forward", "train_step.backward", "train_step.update"]


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"a disabled span read time.{name}")


def _raise(*args, **kwargs):
    raise AssertionError("a disabled span built a record or a range")


def _tiny_step(remat=True):
    cfg = dataclasses.replace(llama.LLAMA_TINY, n_layers=2, remat=remat)
    opt = parallel.default_optimizer(1e-3, warmup_steps=0)
    state = parallel.create_train_state(
        torch.Generator().manual_seed(0), lambda g: llama.init_params(g, cfg, device="cpu"),
        opt, "cpu")
    step = parallel.make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(1))
    return cfg, state, step, {"tokens": tokens}


@pytest.fixture
def tracing_off():
    was = tracing.is_enabled()
    tracing.disable()
    yield
    if was:
        tracing.enable()


def test_disabled_span_builds_nothing(monkeypatch, tracing_off):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(tracing, "time", _NoClock())
    monkeypatch.setattr(tracing, "_emit", _raise)
    monkeypatch.setattr(tracing, "new_span_id", _raise)
    with tracing.span("x", a=1) as s:
        assert s is None
    _, state, step, batch = _tiny_step(remat=True)
    state, m = step(state, batch)      # every span of a step, remat included
    assert torch.isfinite(m["loss"])


def test_spans_land_in_the_profiler_trace(tmp_path, tracing_off):
    cfg, state, step, batch = _tiny_step(remat=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in sorted(spans, key=lambda e: e["ts"])]
    assert [n for n in names if n.startswith("train_step.")] == STEP_SPANS
    assert "train_step.grad_sync" not in names    # one device: no gradient sum
    # each block once in the forward and once more in the recompute
    assert names.count("llama.block") == 2 * cfg.n_layers
    fwd, bwd = (next(e for e in spans if e["name"] == n) for n in STEP_SPANS[:2])
    blocks = [e for e in spans if e["name"] == "llama.block"]
    inside = lambda e, o: o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]  # noqa: E731
    assert sum(inside(b, fwd) for b in blocks) == cfg.n_layers
    assert sum(inside(b, bwd) for b in blocks) == cfg.n_layers


def test_without_remat_the_blocks_run_once(tmp_path, tracing_off):
    cfg, state, step, batch = _tiny_step(remat=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("llama.block") == cfg.n_layers


def test_enabled_spans_emit_the_step_records_in_order(monkeypatch, tracing_off):
    records = []
    monkeypatch.setattr(tracing, "_emit", records.append)
    tracing.enable()
    try:
        cfg, state, step, batch = _tiny_step(remat=True)
        step(state, batch)
    finally:
        tracing.disable()
    steps = [r for r in records if r["name"].startswith("train_step.")]
    assert [r["name"] for r in steps] == STEP_SPANS
    assert all(r["end"] >= r["start"] for r in records)
    assert steps[0]["end"] <= steps[1]["start"] and steps[1]["end"] <= steps[2]["start"]
    assert sum(r["name"] == "llama.block" for r in records) == 2 * cfg.n_layers
    # the forward's blocks are children of train_step.forward
    fwd = steps[0]
    assert sum(r["name"] == "llama.block" and r["parent_id"] == fwd["span_id"]
               for r in records) == cfg.n_layers


def test_mesh_step_spans_add_the_gradient_sum(tmp_path):
    """Over a mesh the same three spans wrap the same calls, and the
    gradients' sum and global norm open ``train_step.grad_sync``."""
    for names in ranks.launch("spans", 2, tmp_path, mesh={"fsdp": 2}):
        steps = [n for n in names if n.startswith("train_step.")]
        assert steps == STEP_SPANS[:2] + ["train_step.grad_sync"] + STEP_SPANS[2:]
        assert names.count("llama.block") == 2 * llama.LLAMA_TINY.n_layers
