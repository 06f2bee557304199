"""A cell, a configuration, a model, a traffic mix and a per-layer metric
are added by adding files and entries: in a copy of the benchmark, none of
the files already there is edited."""

import ast
import json
import os
import pathlib
import shutil
import time

import pytest
import torch

from portbench.harness import cell as cell_lib
from portbench.harness import profile
from portbench.tests.tiny import shrink

# appended to a copy of a model file: the harness's calls of the copy's own
# functions, each with what it returned
TWIN_MARKER = """

CALLS = []
_own = (forward_flops, reference_model, reference_pipeline)


def forward_flops(hp, n_nodes, n_edges, n_clusters=0):
    value = _own[0](hp, n_nodes, n_edges, n_clusters)
    CALLS.append(("forward_flops", value))
    return value


def reference_model(hp):
    CALLS.append(("reference_model", None))
    return _own[1](hp)


def reference_pipeline(model, hp):
    CALLS.append(("reference_pipeline", None))
    return _own[2](model, hp)
"""


def _copy(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(cell_lib.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(cell_lib.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    return root, bench, before


def test_added_files_make_a_new_cell(tmp_path):
    root, bench, before = _copy(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration, traffic mix, cell and per-layer metric, as files
    config = json.loads((bench / "configs" / "embedding_in.json").read_text())
    config["hparams"]["knn"] = 50
    (bench / "configs" / "embedding_in_k50.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "train_pool8.json").read_text())
    traffic["pool_events"] = 4
    (bench / "traffic" / "train_pool4.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "embk50_train.json").write_text(json.dumps({"limits": {"loss_gap": 1}}))
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(rec):\n    return float(rec.get('events', 0)) or None\n")
    spec["configs"].append({**spec["configs"][1], "name": "embedding_in_k50",
                            "file": "portbench/configs/embedding_in_k50.json"})
    spec["workloads"].append({"name": "embk50_train", "config": "embedding_in_k50",
                              "traffic": "train_pool4", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "entry",
                              "moves": "train_events_per_s", "workloads": ["embk50_train"]})
    spec["end_to_end"][0]["workloads"].append("embk50_train")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cell_lib.load("embk50_train", root=str(root), bench_dir=str(bench))
    assert cell.hp["knn"] == 50 and cell.traffic["pool_events"] == 4 and cell.mode == "train"
    assert [m["name"] for m in cell.per_layer if m["name"] == "steps_seen.train"]
    reader = cell_lib.load_module("metrics", "steps_seen.train", bench_dir=str(bench))
    assert reader.read({"events": 7}) == 7.0
    # no file the benchmark had was edited
    assert all(p.read_bytes() == data for p, data in before.items())


def test_cells_report_metrics_by_their_lists():
    cell = cell_lib.load("embin_train")
    names = {m["name"] for m in cell.per_layer}
    assert "knn_ms.train" in names and "auction_rounds.train" not in names
    assert {m["name"] for m in cell.end_to_end} == {"train_events_per_s", "peak_gib", "setup_s"}


def _capture_without_a_card(run_device, run_ranged, trace_path):
    """``profile.capture`` reads the card's trace; on the CPU the passes run
    untraced and the reduction is empty."""
    run_device()
    run_ranged()
    return {"busy_s": 0.0, "wall_s": 0.0, "launches": 0, "range_device_s": {},
            "device_ops": [], "idle_gaps": []}


class _HostEvent:
    """``torch.cuda.Event`` on the CPU, where a call's work is done when it
    returns: the host's clock at ``record``."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def test_a_model_added_as_files_runs_through_the_harness(tmp_path, monkeypatch):
    """A twin of Embedding-IN's model file, with its configuration, workload
    and entries, runs as a traced cell through ``modes/train.run``: correct,
    on the twin's own functions, and with no file of the copy edited."""
    root, bench, before = _copy(tmp_path)
    (bench / "models" / "embedding_in_twin.py").write_text(
        (bench / "models" / "embedding_in.py").read_text() + TWIN_MARKER)
    config = json.loads((bench / "configs" / "embedding_in.json").read_text())
    config["model_file"] = "embedding_in_twin"
    (bench / "configs" / "embedding_in_twin.json").write_text(json.dumps(config))
    (bench / "workloads" / "twin_train.json").write_text(
        (bench / "workloads" / "embin_train.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][1], "name": "embedding_in_twin",
                            "file": "portbench/configs/embedding_in_twin.json"})
    spec["workloads"].append({"name": "twin_train", "config": "embedding_in_twin",
                              "traffic": "train_pool8", "chips": 1, "why": "a test cell"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "embin_train" in metric.get("workloads", ()):
            metric["workloads"].append("twin_train")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = shrink(cell_lib.load("twin_train", root=str(root), bench_dir=str(bench)),
                  compute_dtype="float32")
    mode = cell_lib.load_module("modes", cell.mode, bench_dir=str(bench))
    monkeypatch.setattr(profile, "capture", _capture_without_a_card)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    result = mode.run(cell, 2147483690, 4.0, True, time.perf_counter(), device="cpu")

    assert result.correct, result.checks
    called = [name for name, _ in cell.model.CALLS]
    assert {"forward_flops", "reference_model", "reference_pipeline"} <= set(called)
    counters = result.record["counters"]
    assert counters["flops"] == [3 * v for name, v in cell.model.CALLS
                                 if name == "forward_flops"]
    assert len(counters["knn_ms"]) == result.attempted  # the twin's TIMED
    read = {m["name"]: cell_lib.load_module("metrics", m["name"], str(bench)).read(result.record)
            for m in cell.per_layer}
    assert read["sync_wait_ms.train"] > 0 and read["forward_ms.train"] is None  # no card
    assert all(p.read_bytes() == data for p, data in before.items())


REGISTRY_NAMES = ("EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "BC-HGNN-GMM", "gMRT")


def test_no_harness_file_names_a_model():
    from hierarchicalgnn_torch.models.registry import available_models

    assert sorted(REGISTRY_NAMES) == available_models()
    found = []
    for sub in ("harness", "modes"):
        for path in sorted(pathlib.Path(cell_lib.BENCH_DIR, sub).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Constant) and node.value in REGISTRY_NAMES:
                    found.append((str(path), node.lineno, node.value))
    assert not found


@pytest.mark.parametrize("model_file,stages,inner", [
    ("bc_hgnn_gmm", ("clustering", "knn", "matching"), ("auction",)),
    ("embedding_in", ("knn_graph",), ()),
])
def test_model_files_keep_their_stages(model_file, stages, inner):
    model = cell_lib.load_module("models", model_file)
    assert (model.STAGES, model.INNER) == (stages, inner)
