"""BENCHMARK.json against the benchmark's contract, and every cell's files."""

import json
import os
import re

import pytest

from portbench.harness import cell as cell_lib

BENCH = json.load(open(os.path.join(cell_lib.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_allowed_and_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if "bound" in metric:
        assert set(metric) <= METRIC_KEYS
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= PER_LAYER_KEYS
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for cell in metric["workloads"]:  # every listed cell reports what it moves
            assert "workloads" not in moves or cell in moves["workloads"]


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(workload):
    cell = cell_lib.load(workload["name"])
    assert cell.chips in (1, 4)
    assert os.path.exists(os.path.join(cell_lib.BENCH_DIR, "modes", f"{cell.mode}.py"))
    for metric in cell.per_layer:
        reader = cell_lib.load_module("metrics", metric["name"])
        assert reader.read({}) is None  # nothing to read gives nothing
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert len(workload["why"]) <= 200 and NAME.match(workload["traffic"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("portbench/")
    data = json.load(open(os.path.join(cell_lib.ROOT, config["file"])))
    assert data["reduced"] == config["reduced"]
    hp = data["hparams"]
    for key, value in data["assumed"].items():
        assert key == "why" or hp[key] == value
    assert hp["compute_dtype"] == "bfloat16" and hp["use_pallas"] and hp["remat"] is False


def test_each_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
