"""The port's run utilities and loaders against the JAX package's.

``utils/{logging,sanitize,profiling,phase_probe,device_lock}.py``,
``data/{reader,native_loader}.py`` and ``Trainer.fit_streaming`` of
``hierarchicalgnn_torch``: the logger's records and printed lines equal
JAX's (``time`` excepted), ``finite_report`` equals JAX's on the same
numpy tree, the readers give JAX's dicts (every array exactly, in the same
key order) for the same ``.npz`` and ``.pt`` files, and the native loader,
built here from ``native/hgnn_io.cc``, reads back exactly what was written.
"""

import inspect
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.data import native_loader, reader
from hierarchicalgnn_torch.data.synthetic import generate_dataset, generate_event
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops import grid_knn
from hierarchicalgnn_torch import inference, run
from hierarchicalgnn_torch.train import checkpoint, trainer as trainer_mod
from hierarchicalgnn_torch.train.trainer import Trainer
from hierarchicalgnn_torch.utils import device_lock, logging, phase_probe, profiling, sanitize

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
NEW_MODULES = (grid_knn, checkpoint, trainer_mod, inference, run, logging, sanitize, profiling,
               phase_probe, device_lock, reader, native_loader)

TINY = {"n_nodes_max": 512, "n_edges_max": 2048, "max_clusters": 128, "max_particles": 128,
        "latent": 16, "n_interaction_graph_iters": 1, "n_hierarchical_graph_iters": 1,
        "knn": 5, "knn_block_size": 256, "gmm_iters": 10, "train_split": [3, 1, 1],
        "warmup": 2, "use_pallas": False, "compute_dtype": None}


@pytest.mark.parametrize("module", NEW_MODULES, ids=lambda m: m.__name__)
def test_new_modules_import_no_jax(module):
    """The slice's modules are the port's own: never jax, flax, optax or the
    JAX package in their source."""
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", inspect.getsource(module), re.M)
    assert imports
    for name in imports:
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                          "hierarchicalgnn_tpu"), (module.__name__, name)


# ---------------------------------------------------------------------------
# MetricLogger, finite_report, check_determinism
# ---------------------------------------------------------------------------

def test_metric_logger_matches_jax(tmp_path):
    from hierarchicalgnn_tpu.utils.logging import MetricLogger as JLogger

    calls = [
        ({"val_loss": 0.5, "track_eff": 0.0}, dict(step=0, epoch=-1, prefix="sanity_",
                                                   force_print=True)),
        ({"training_loss": np.float32(0.25), "clusters": 13.0}, dict(step=1, epoch=0)),
        ({"training_loss": 0.125, "tag": "x"}, dict(step=2, epoch=0)),
        ({"val_loss": 0.1, "epoch_time": 1.5}, dict(step=2, epoch=0, force_print=True)),
        ({"track_eff": 0.75}, dict(step=-1, prefix="test_", force_print=True)),
    ]
    outs = {}
    for name, cls in (("jax", JLogger), ("torch", logging.MetricLogger)):
        stream = io.StringIO()
        logger = cls(str(tmp_path / name), log_every_n_steps=2, stream=stream)
        for metrics, kw in calls:
            logger.log(metrics, **kw)
        logger.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        for rec in records:
            assert rec.pop("time") >= 0
        outs[name] = records, stream.getvalue()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1].count("\n") == 4  # steps 0 and 2, and the forced ones


def test_metric_logger_without_a_run_dir_prints_only(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stream = io.StringIO()
    logger = logging.MetricLogger(None, log_every_n_steps=1, stream=stream)
    logger.log({"a": 1.0}, step=3)
    assert stream.getvalue() == "step=3 a=1\n" and os.listdir(tmp_path) == []


def _poisoned_tree():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    a[1, 2] = np.nan
    b = rng.normal(size=5).astype(np.float32)
    b[[0, 3]] = np.inf
    return {"params": {"Dense_0": {"kernel": a, "bias": np.zeros(3, np.float32)},
                       "Dense_1": {"kernel": b}},
            "step": np.int32(3), "buffers": [np.ones(2, np.float32), b.copy()]}


def test_finite_report_matches_jax():
    from hierarchicalgnn_tpu.utils import sanitize as j_sanitize

    tree = _poisoned_tree()
    want = j_sanitize.finite_report(tree)
    assert want and sanitize.finite_report(tree) == want
    assert sanitize.finite_report(tree, max_leaves=1) == j_sanitize.finite_report(
        tree, max_leaves=1)
    as_tensors = {"params": {k: {n: torch.from_numpy(v) for n, v in d.items()}
                             for k, d in tree["params"].items()},
                  "step": torch.tensor(3), "buffers": [torch.from_numpy(v)
                                                       for v in tree["buffers"]]}
    assert sanitize.finite_report(as_tensors) == want
    with pytest.raises(FloatingPointError, match=re.escape("['params']['Dense_1']['kernel']: 2/5")):
        sanitize.assert_all_finite(tree, "params")
    sanitize.assert_all_finite({"x": torch.ones(3, dtype=torch.bfloat16)})


def test_finite_report_of_a_module_names_its_tensors():
    _, model, _ = model_selector("BC-HGNN-GMM", TINY)
    # score_cut starts at +inf by design (no cut learned yet)
    assert sanitize.finite_report(model) == {"['hgnn.score_cut']": (1, 1)}
    with torch.no_grad():
        next(model.parameters())[0] = float("nan")
    name = next(n for n, _ in model.named_parameters())
    report = sanitize.finite_report(model)
    assert set(report) == {f"['{name}']", "['hgnn.score_cut']"} and report[f"['{name}']"][0] >= 1


def test_check_determinism():
    x = torch.arange(6.0)
    out = sanitize.check_determinism(lambda t: {"y": t * 2}, x)
    assert np.array_equal(out["['y']"], np.arange(6.0) * 2)
    draws = iter([torch.zeros(2), torch.ones(2)])
    with pytest.raises(AssertionError, match="nondeterministic at leaf"):
        sanitize.check_determinism(lambda: next(draws))


# ---------------------------------------------------------------------------
# profiling, phase probes
# ---------------------------------------------------------------------------

def test_phase_timer_on_the_cpu(tmp_path):
    timer = profiling.PhaseTimer("cpu")
    with timer.phase("a"):
        time.sleep(0.01)
    out = timer.time_fn("b", lambda v: v + 1, 1)
    with timer.phase("a"):
        pass
    assert out == 2 and timer.counts == {"a": 2, "b": 1}
    assert timer.totals["a"] >= 0.01 and timer.totals["b"] >= 0
    assert set(timer.reset()) == {"a", "b"} and timer.summary() == {}


def test_phase_probes_keys():
    """The JAX keys, in seconds, for the pooling and construction of a
    random embedding over a random graph (clusters formed)."""
    from hierarchicalgnn_torch.ops.graph import Graph

    gen = torch.Generator().manual_seed(0)
    n, e = 256, 1024
    emb = torch.nn.functional.normalize(torch.randn(n, 8, generator=gen), dim=1)
    graph = Graph(torch.randint(0, n, (e,), generator=gen),
                  torch.randint(0, n, (e,), generator=gen), torch.ones(e, dtype=torch.bool))
    hp = model_selector("gMRT", TINY)[0]
    times = phase_probe.PhaseProbes(hp).measure(emb, graph, torch.ones(n, dtype=torch.bool))
    assert set(times) == {"pooling_time", "graph_construct_time"}
    assert all(isinstance(v, float) and v >= 0 for v in times.values())


# ---------------------------------------------------------------------------
# device lock
# ---------------------------------------------------------------------------

def test_device_lock_acquire_and_holder_info(tmp_path):
    path = str(tmp_path / "dev.lock")
    assert device_lock.holder_info(path) is None
    msgs = []
    assert device_lock.acquire(path, wait_s=1.0, status=msgs.append)
    info = device_lock.holder_info(path)
    assert info["pid"] == os.getpid() and isinstance(info["argv"], list)
    assert msgs == ["device lock acquired"]
    assert device_lock.acquire(path, wait_s=0.0)  # held by this process: at once
    probe = ("import sys; sys.path.insert(0, sys.argv[1]);"
             "from hierarchicalgnn_torch.utils import device_lock as d;"
             "print(d.acquire(sys.argv[2], wait_s=0.5, on_timeout='proceed'));"
             "d.acquire(sys.argv[2], wait_s=0.2)")
    out = subprocess.run([sys.executable, "-c", probe, REPO, path], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.split() == ["False"]
    assert "still held" in out.stderr and f"'pid': {os.getpid()}" in out.stderr
    assert device_lock.DEFAULT_PATH.startswith(__import__("tempfile").gettempdir())


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _assert_same_event(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_readers_match_jax_on_npz_and_pt(tmp_path):
    from hierarchicalgnn_tpu.data import reader as j_reader

    sys.path.insert(0, SCRIPTS)
    try:
        from make_pt_fixture import LAYOUTS, make_pt_tree
    finally:
        sys.path.remove(SCRIPTS)
    root = tmp_path / "pt"
    assert make_pt_tree(str(root), n_events=6, seed=4, n_particles=12) == 6
    paths = reader.load_dataset_paths(str(root), ["train", "val", "test"])
    assert paths == j_reader.load_dataset_paths(str(root), ["train", "val", "test"])
    assert {os.path.basename(p).split("_")[-1][:-3] for p in paths} == set(LAYOUTS)
    for p in paths:
        _assert_same_event(reader.load_event_file(p), j_reader.load_event_file(p))
    events = reader.load_event_dir(str(root), ["train", "val", "test"], limit=4)
    assert len(events) == 4
    for got, p in zip(events, paths):
        _assert_same_event(got, j_reader.load_event_file(p))

    ev = generate_event(np.random.default_rng(3), n_particles=8)
    ev["not_an_event_key"] = np.zeros(2)
    reader.save_event_npz(str(tmp_path / "t.npz"), ev)
    j_reader.save_event_npz(str(tmp_path / "j.npz"), ev)
    got = reader.load_event_file(str(tmp_path / "t.npz"))
    _assert_same_event(got, j_reader.load_event_file(str(tmp_path / "j.npz")))
    assert "not_an_event_key" not in got and set(got) <= set(reader.EVENT_KEYS)


def test_load_dataset_paths_order_matches_jax(tmp_path):
    from hierarchicalgnn_tpu.data.reader import load_dataset_paths as j_paths

    for sub in ("train", "val"):
        (tmp_path / sub).mkdir()
        for i in (3, 0, 11, 2):
            (tmp_path / sub / f"e{i}.npz").touch()
    for seed in (42, 7):
        got = reader.load_dataset_paths(str(tmp_path), ["train", "val", "nope"], seed)
        assert got == j_paths(str(tmp_path), ["train", "val", "nope"], seed) and len(got) == 8


# ---------------------------------------------------------------------------
# native loader, fit_streaming
# ---------------------------------------------------------------------------

def _written(tmp_path, n, n_particles, seed=0):
    rng = np.random.default_rng(seed)
    events, paths = [], []
    for i in range(n):
        ev = generate_event(rng, n_particles=n_particles)
        p = str(tmp_path / f"ev{i}.hgnn")
        native_loader.write_event(p, ev)
        events.append(ev)
        paths.append(p)
    return events, paths


def _as_written(ev):
    return {k: np.ascontiguousarray(v).astype(np.uint8) if np.asarray(v).dtype == np.bool_
            else np.ascontiguousarray(v) for k, v in ev.items()}


def test_native_loader_round_trip_and_shuffled_loop(tmp_path):
    """The library builds from native/hgnn_io.cc; one pass in file order
    gives back every array exactly (bool as uint8); a looping shuffled
    stream crosses the epoch boundary with each epoch a permutation of the
    files.  Where the JAX binding's library is built too, it reads the
    same files into the same dicts in the same order."""
    from hierarchicalgnn_tpu.data import native_loader as j_loader

    assert native_loader.library_path().parent == native_loader.BUILD_DIR
    events, paths = _written(tmp_path, 5, 8)
    with native_loader.NativeEventLoader(paths, n_threads=2, shuffle_seed=-1) as loader:
        loaded = list(loader)
    assert len(loaded) == 5
    for src, got in zip(events, loaded):
        _assert_same_event(got, _as_written(src))

    with native_loader.NativeEventLoader(paths[:4], n_threads=2, shuffle_seed=7,
                                         loop=True) as loader:
        stream = [next(loader) for _ in range(10)]
    index = {ev["x"].tobytes(): i for i, ev in enumerate(events[:4])}
    order = [index[ev["x"].tobytes()] for ev in stream]
    assert sorted(order[:4]) == sorted(order[4:8]) == [0, 1, 2, 3]
    if j_loader.available():
        j_stream = j_loader.NativeEventLoader(paths[:4], n_threads=2, shuffle_seed=7,
                                              loop=True)
        try:
            for got in stream:
                _assert_same_event(got, next(j_stream))
        finally:
            j_stream.close()
        j_loaded = list(j_loader.NativeEventLoader(paths, n_threads=2, shuffle_seed=-1))
        for got, want in zip(loaded, j_loaded):
            _assert_same_event(got, want)


def test_fit_streaming_one_tiny_epoch(tmp_path):
    events, paths = _written(tmp_path, 3, 15, seed=1)
    hp, model, pipeline = model_selector("EC-IN", TINY)
    trainer = Trainer(hp, model, pipeline, run_dir=str(tmp_path / "run"),
                      log_every_n_steps=0, device="cpu")
    history = trainer.fit_streaming(paths, generate_dataset(1, seed=5, n_particles=15),
                                    steps_per_epoch=2, max_epochs=1, n_threads=2)
    assert len(history) == 1 and {"val_loss", "track_eff", "epoch_time"} <= set(history[0])
    assert trainer.step == 2
    assert sorted(os.listdir(tmp_path / "run" / "checkpoints")) == [
        "best", "hparams.json", "last"]
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 2]
    assert all(np.isfinite(v) for r in records for v in r.values())
    # a data axis without a graph partition: one event a step, as in the JAX
    # trainer (it raised before the sharded training step was ported)
    data_only = Trainer({**hp, "mesh_shape": {"data": 2}}, model, pipeline, device="cpu")
    data_only.fit_streaming(paths, [], 1, 1)
    assert data_only.step == 1 and data_only._sharded is None
