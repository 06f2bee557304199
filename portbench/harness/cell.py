"""A cell: one entry of ``BENCHMARK.json``'s ``workloads``, with the files
the harness finds by its names.

* ``portbench/configs/<config>.json``: the configuration as it is run
  (``hparams``, every key the port's model reads), its source, ``reduced``,
  ``assumed`` and ``model_file``;
* ``portbench/models/<model_file>.py``: what the harness asks of the model
  (``Cell.model``): ``STAGES`` and ``INNER``, its discrete stages
  (``harness/stages.py``); ``reference_model(hp)`` and
  ``reference_pipeline(model, hp)``, the reference's model and loss, built
  from modules of ``portbench/reference/hgnn`` (``drivers.REFERENCE``);
  ``forward_flops(hp, n_nodes, n_edges, n_clusters)``, one forward's model
  FLOPs (``harness/flops.py``); ``TIMED``, the port's functions that a
  traced window times, ``{counter: (module under the port, attribute)}``;
* ``portbench/traffic/<traffic>.json``: the mode (``portbench/modes/<mode>.py``)
  and the traffic's parameters;
* ``portbench/workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``;
* ``portbench/metrics/<metric>.py``: a reader per per-layer metric.

Adding a cell, a configuration, a model, a traffic mix or a metric adds
files and entries; no file of the harness names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic_name: str
    chips: int
    hp: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    model: object             # the configuration's model file, a module

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _json(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, end_to_end_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: those that list their cells,
    there; the others wherever the end-to-end metric they move is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in end_to_end_names


def load(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR,
         entry: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises KeyError
    for a name it does not hold.  ``entry`` (with its ``config``, ``traffic``
    and ``chips``) stands for a cell the file does not list yet."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    if entry is None:
        entry = {w["name"]: w for w in bench["workloads"]}[name]
    config = _json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    traffic = _json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    workload = _json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, config=entry["config"], traffic_name=entry["traffic"],
                chips=int(entry["chips"]), hp=dict(config["hparams"]), traffic=traffic,
                limits=dict(workload["limits"]), end_to_end=e2e, per_layer=per_layer,
                model=load_module("models", config["model_file"], bench_dir))


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
