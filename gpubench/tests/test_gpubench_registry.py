"""Every configuration, cell, traffic mix, limit and metric of
BENCHMARK.json is found by name in its own file, and the files agree with
BENCHMARK.json and with the contract's shapes."""

import json
import math
import os
import re

import pytest

from gpubench import ROOT, check, registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
          "head_dim")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    cfg = registry.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"gpubench/configs/{entry['name']}.json"
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for key in entry["reduced"]:
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
        assert cfg["reduced"][key]["here"] == cfg[key] != cfg["reduced"][key]["published"]
    assert cfg["hidden_size"] // cfg["num_attention_heads"] == cfg["head_dim"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    cell = registry.workload(entry["name"])
    mesh = cell.pop("mesh", None)      # the card layout lives in the cell's file alone
    assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} == cell
    assert entry["chips"] == (math.prod(mesh.values()) if mesh else 1)
    assert mesh is None or set(mesh) <= {"data", "fsdp", "expert", "seq", "model"}
    registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    assert traffic["kind"] == "train" and traffic["check_steps"] >= 2
    limits = registry.limits(entry["name"])
    assert set(limits) == set(check.NAMES)
    compared = [v for v in limits.values() if v is not None]   # null: not compared
    assert compared and all(0 < v < 1 for v in compared)


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_found_by_name(entry):
    reader = registry.metric(entry["name"])
    assert callable(reader.read)
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")


def test_every_cell_has_its_files():
    """Every cell, configuration and traffic mix of BENCHMARK.json, and only
    those, has its files; every metric has its reader."""
    cells = sorted(w["name"] for w in BENCH["workloads"])
    assert registry.names("workloads") == cells == registry.names("limits")
    assert sorted(c["name"] for c in BENCH["configs"]) == registry.names("configs")
    assert sorted({w["traffic"] for w in BENCH["workloads"]}) == registry.names("traffic")
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} <= set(
        registry.names("metrics"))


def test_benchmark_json_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["gpubench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    json.dumps(BENCH)
