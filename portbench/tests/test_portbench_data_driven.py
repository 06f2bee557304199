"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: in a copy of the benchmark, none of the files
already there is edited."""

import json
import os
import shutil

from portbench.harness import cell as cell_lib


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
