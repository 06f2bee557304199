"""The port's span recorder (``utils/profiling.py``) in the one-card
training step, on the CPU at tiny shapes.

One traced ``Trainer.train_step`` of BC-HGNN-GMM, gMRT and Embedding-IN gives
the span tree of the step's layers under one step id, with one
``host_read`` span per counted host read.  With tracing off nothing is
recorded and no ``record_function`` range is entered; under
``torch.profiler`` the spans appear as ``hgnn::`` ranges in the exported
trace.
"""

import json
import sys
import threading

import pytest
import torch

from hierarchicalgnn_torch.data.synthetic import generate_dataset
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.train.trainer import Trainer
from hierarchicalgnn_torch.utils import profiling

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = {"n_nodes_max": 512, "n_edges_max": 2048, "max_clusters": 128, "max_particles": 128,
        "latent": 16, "n_interaction_graph_iters": 1, "n_hierarchical_graph_iters": 1,
        "knn": 5, "knn_block_size": 256, "gmm_iters": 10, "train_split": [3, 1, 1],
        "warmup": 2, "use_pallas": False, "compute_dtype": None}

# span -> its parent's name, in every model's step
STEP = {"train_step": None, "forward": "train_step", "loss": "train_step",
        "backward": "train_step", "optimizer": "train_step", "readback": "train_step"}
BIPARTITE = ("BC-HGNN-GMM", "gMRT")
TREES = {**{name: {**STEP, "pool": "forward", "graph": "forward", "match": "loss"}
            for name in BIPARTITE},
         "Embedding-IN": STEP}
TOP = ("forward", "loss", "backward", "optimizer", "readback")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _trainer(name):
    hp, model, pipeline = model_selector(name, TINY)
    trainer = Trainer(hp, model, pipeline, device="cpu")
    trainer.init_state(0)
    batch = trainer.make_datasets(generate_dataset(5, seed=1, n_particles=30))[0][0][2]
    return trainer, batch


def _traced_step(name):
    trainer, batch = _trainer(name)
    profiling.enable()
    trainer.train_step(batch, 0)
    profiling.disable()
    return profiling.drain(), trainer.last_stats


@pytest.mark.parametrize("name", sorted(TREES))
def test_step_span_tree(name):
    """One step id; the layers' spans once each under their parents, each
    child's host interval inside its parent's; host times only on the
    CPU."""
    records, _ = _traced_step(name)
    by_id = {r["id"]: r for r in records}
    layers = [r for r in records if r["name"] != "host_read"]
    assert sorted(r["name"] for r in layers) == sorted(TREES[name])
    assert {r["step"] for r in records} == {records[0]["step"]}
    for rec in records:
        assert rec["device_ms"] is None
        assert rec["host_start_ns"] <= rec["host_end_ns"]
        parent = by_id.get(rec["parent"])
        if rec["name"] == "host_read":
            assert parent is not None
            continue
        assert (parent and parent["name"]) == TREES[name][rec["name"]], rec
        if parent is not None:
            assert parent["host_start_ns"] <= rec["host_start_ns"]
            assert rec["host_end_ns"] <= parent["host_end_ns"]


@pytest.mark.parametrize("name", sorted(TREES))
def test_host_read_spans_equal_host_syncs(name):
    """A ``host_read`` span per read ``last_stats["host_syncs"]`` counts;
    BC's and gMRT's fall in the pooling, the matching and the readback."""
    records, stats = _traced_step(name)
    reads = [r for r in records if r["name"] == "host_read"]
    assert len(reads) == stats["host_syncs"] >= 1
    names = {r["id"]: r["name"] for r in records}
    where = {names[r["parent"]] for r in reads}
    assert where == ({"pool", "match", "readback"} if name in BIPARTITE else {"readback"})


@pytest.mark.parametrize("name", BIPARTITE)
def test_graph_span_beside_pool(name):
    """The graph construction is a ``graph`` span under ``forward``, after
    ``pool``, and ``forward``'s self time (what ``forward_ms.train`` reads)
    leaves both out."""
    from portbench.harness.readers import spans_a_step

    records, _ = _traced_step(name)
    (forward,) = [r for r in records if r["name"] == "forward"]
    (pool,) = [r for r in records if r["name"] == "pool"]
    (graph,) = [r for r in records if r["name"] == "graph"]
    assert pool["parent"] == graph["parent"] == forward["id"]
    assert pool["host_end_ns"] <= graph["host_start_ns"]

    def ms(rec):
        return (rec["host_end_ns"] - rec["host_start_ns"]) / 1e6

    spans = spans_a_step(records, 1)
    children = sum(ms(r) for r in records if r["parent"] == forward["id"])
    assert spans["forward"]["host_self_ms"] == pytest.approx(ms(forward) - children)
    assert spans["forward"]["host_self_ms"] <= ms(forward) - ms(pool) - ms(graph) + 1e-9
    assert spans["graph"]["host_ms"] == pytest.approx(ms(graph)) and ms(graph) > 0


def test_tracing_off_records_nothing(monkeypatch):
    """Off by default: a step enters no ``record_function`` range and
    records nothing, and ``host_syncs`` still counts every read."""
    trainer, batch = _trainer("BC-HGNN-GMM")

    def forbidden(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    trainer.train_step(batch, 0)
    assert trainer.last_stats["host_syncs"] > 1
    assert profiling.drain() == []


def test_spans_in_profiler_trace(tmp_path):
    """Under ``torch.profiler`` the step's spans are ``hgnn::`` ranges of the
    exported trace."""
    from torch.profiler import ProfilerActivity, profile

    trainer, batch = _trainer("Embedding-IN")
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch, 0)
    profiling.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {f"hgnn::{n}" for n in ("train_step",) + TOP} <= names
    assert len(profiling.drain()) == len(STEP) + 1


def test_drain_empties_the_recorder():
    """``drain`` gives the closed spans in opening order, each root a new
    step, and forgets them; ``host_read`` counts with tracing off or on."""
    stats = {}
    profiling.enable()
    with profiling.span("a"):
        with profiling.span("b", device=True), profiling.host_read(stats):
            pass
    with profiling.span("c"):
        pass
    with profiling.host_read(None):
        pass
    profiling.disable()
    with profiling.span("off"), profiling.host_read(stats):
        pass
    records = profiling.drain()
    assert [r["name"] for r in records] == ["a", "b", "host_read", "c", "host_read"]
    a, b, read, c, _ = records
    assert (b["parent"], read["parent"], c["parent"]) == (a["id"], b["id"], None)
    assert a["step"] == b["step"] == read["step"] != c["step"]
    assert stats == {"host_syncs": 2}
    assert profiling.drain() == []


def test_threads_nest_their_own_spans():
    """Threads share the recorder (a shard group's ranks are threads): each
    thread's spans nest under that thread's own, with no record lost."""
    n_threads, rounds = 8, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(t):
        try:
            for _ in range(rounds):
                with profiling.span(f"outer{t}"):
                    with profiling.span(f"inner{t}"):
                        pass
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    try:
        profiling.enable()
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and not errors
    finally:
        sys.setswitchinterval(interval)
        profiling.disable()
    records = profiling.drain()
    assert len(records) == 2 * n_threads * rounds
    assert len({r["id"] for r in records}) == len(records)
    by_id = {r["id"]: r for r in records}
    for rec in records:
        if rec["name"].startswith("inner"):
            parent = by_id[rec["parent"]]
            assert parent["name"] == "outer" + rec["name"][5:]
            assert parent["step"] == rec["step"]
        else:
            assert rec["parent"] is None
    assert len({r["step"] for r in records}) == n_threads * rounds
