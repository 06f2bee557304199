"""Device placement of a CLI run and of the processes, on the CPU.

  * ``run.py --devices``: ``train``, ``resume`` and ``test`` of EC-IN at
    TINY with ``mesh_shape {data 1, graph 2}`` and ``--devices cpu,cpu``
    take the placement path (the ``place_inputs`` spy of
    ``tests/test_torch_multicard.py``) and log the same metrics, bit for
    bit, as the same runs without ``--devices``; too few devices raise in
    the words of the JAX ``make_mesh``; with ``graph`` 1 ``--devices``
    changes nothing; a card that does not exist fails before the device
    lock.
  * ``make_global_mesh(g, devices=...)`` has the JAX ``make_global_mesh(g)``'s
    shape on the 8 CPU devices of ``conftest.py``, and refuses what it
    refuses.
  * ``initialize`` binds the process to its card (``torch.cuda.set_device``,
    NCCL's ``device_id``), with the card and the group faked.
  * Two gloo processes (``tests/_torch_devices_worker.py``, 240 s each, their
    group 120 s) whose graph ranks take ``devices=["cpu", "cpu"]`` give the
    same losses and state fingerprints as without ``devices``.
"""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

from hierarchicalgnn_tpu.parallel import distributed as j_distributed
from hierarchicalgnn_tpu.parallel.mesh import make_mesh as j_make_mesh

from hierarchicalgnn_torch import run as cli
from hierarchicalgnn_torch.parallel import comm, distributed, graph_shard as gs
from hierarchicalgnn_torch.utils import device_lock

from _torch_parity import one_thread  # noqa: F401  (fixture)
from test_torch_cli import COMMON, TINY_SETS

pytestmark = pytest.mark.usefixtures("one_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_devices_worker.py")
REPO = os.path.dirname(HERE)
NPROC = 2
GRAPH_2 = ["--set", 'mesh_shape={"data":1,"graph":2}']
CPU = torch.device("cpu")


@pytest.fixture
def placed(monkeypatch):
    """The ``devices`` of every ``place_inputs`` call of the sharded forward:
    None on the default path, the named devices on the placement path."""
    seen = []

    def spy(inputs, devices, buffers=()):
        seen.append(None if devices is None else list(devices))
        return comm.place_inputs(inputs, devices, buffers)

    monkeypatch.setattr(gs, "place_inputs", spy)
    return seen


def _records(run_dir):
    """The metric log without its clock readings."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if "time" not in k} for r in records]


def _run(run_dir, devices, extra=(), capsys=None):
    """train 1 epoch, resume to epoch 2, test: the records and the test's
    printed metrics."""
    sets = COMMON + TINY_SETS + list(extra)
    if devices is not None:
        sets += ["--devices", devices]
    cli.main(["train", "--model", "1", "--run-dir", run_dir, "--max-epochs", "1"] + sets)
    cli.main(["resume", "--run-dir", run_dir, "--max-epochs", "2"] + sets)
    if capsys is not None:
        capsys.readouterr()
    cli.main(["test", "--run-dir", run_dir, "--checkpoint", "last"] + sets)
    tested = None
    if capsys is not None:
        tested = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return _records(run_dir), tested


def test_devices_take_the_placement_path_bit_for_bit(tmp_path, placed, capsys):
    """``--devices cpu,cpu`` for ``graph`` 2: every sharded forward of
    ``train`` and ``resume`` places its ranks on the two devices, and the
    metric log (sanity, steps, epochs, test) and the test's metrics equal
    the run without ``--devices`` bit for bit."""
    got, got_test = _run(str(tmp_path / "devices"), "cpu,cpu", GRAPH_2, capsys)
    assert placed and all(p == [CPU, CPU] for p in placed), placed
    n_placed = len(placed)
    placed.clear()
    want, want_test = _run(str(tmp_path / "default"), None, GRAPH_2, capsys)
    assert len(placed) == n_placed and all(p is None for p in placed), placed
    assert [r["step"] for r in got if "training_loss" in r] == [1, 2, 3, 4, 5, 6]
    assert got == want
    assert got_test == want_test


@pytest.mark.parametrize("graph,names", [(2, "cpu"), (4, "cpu,cpu")])
def test_too_few_devices_raise_in_jax_words(tmp_path, graph, names):
    """Fewer devices than ``data x graph`` raise the JAX mesh's ValueError,
    word for word, before any event is read."""
    n = len(names.split(","))
    with pytest.raises(ValueError) as want:
        j_make_mesh(1, graph, jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        cli.main(["train", "--model", "1", "--run-dir", str(tmp_path / "run"),
                  "--max-epochs", "1", "--devices", names, "--set",
                  f'mesh_shape={{"data":1,"graph":{graph}}}'] + COMMON + TINY_SETS)
    assert str(got.value) == str(want.value) == f"mesh 1x{graph} needs {graph} devices, have {n}"
    assert not os.path.exists(tmp_path / "run" / "metrics.jsonl")


def test_devices_without_a_graph_axis_change_nothing(tmp_path, placed):
    """With ``graph`` 1 the JAX trainer builds no mesh: ``--devices`` (even
    fewer than a mesh would need) is accepted, no rank is placed and the
    log equals the run without it."""
    sets = ["--model", "1", "--max-epochs", "1"] + COMMON + TINY_SETS
    cli.main(["train", "--run-dir", str(tmp_path / "a"), "--devices", "cpu"] + sets)
    cli.main(["train", "--run-dir", str(tmp_path / "b")] + sets)
    assert placed == []
    assert _records(str(tmp_path / "a")) == _records(str(tmp_path / "b"))


def test_missing_card_fails_before_the_lock(monkeypatch, tmp_path):
    """A ``--devices`` card the host lacks raises before the device lock is
    taken and before the run starts; ``--help`` names the option."""
    taken = []
    monkeypatch.setattr(device_lock, "acquire", lambda *a, **k: taken.append(a) or True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="names card 5, but this host has 2 cards"):
        cli.main(["train", "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                  "--devices", "cuda:0,cuda:5"] + TINY_SETS)
    assert taken == [] and not os.path.exists(tmp_path / "run")
    with pytest.raises(SystemExit):
        cli.main(["train", "--devices", "nonsense:7"])
    assert taken == []


@pytest.mark.parametrize("graph", [1, 2, 3, 4, 8])
def test_global_mesh_of_local_devices_as_jax(graph):
    """``make_global_mesh(g, devices=8 local devices)`` in one process has the
    JAX ``make_global_mesh(g)``'s shape on its 8 devices (data 8 / g, graph
    g), its ranks on the devices in order; g 3 does not divide 8, and both
    refuse it as incompatible."""
    assert jax.local_device_count() == 8
    devices = [torch.device("cpu", i) for i in range(8)]
    if 8 % graph:
        with pytest.raises(ValueError, match="incompatible with 8 local devices"):
            j_distributed.make_global_mesh(graph)
        with pytest.raises(ValueError, match="incompatible with 8 local devices"):
            distributed.make_global_mesh(graph, devices=devices)
        return
    want = j_distributed.make_global_mesh(graph)
    got = distributed.make_global_mesh(graph, devices=devices)
    assert got.shape == dict(want.shape) == {"data": 8 // graph, "graph": graph}
    assert [[d.index for d in row] for row in got.devices] == [
        [d.id for d in row] for row in want.devices]
    assert (got.local_events, got.group) == (8 // graph, None)
    with pytest.raises(ValueError, match="incompatible with 1 local devices"):
        distributed.make_global_mesh(2, devices=["cpu"])


@pytest.mark.parametrize("device,backend,bound", [
    ("cuda:1", "nccl", "cuda:1"), ("cuda", "nccl", "cuda:0"), ("cuda:1", "gloo", "cuda:1"),
    ("cpu", "gloo", None)])
def test_initialize_binds_the_card(monkeypatch, device, backend, bound):
    """``initialize`` makes a named card current before the group forms and,
    under NCCL, makes the group for it (``device_id``); a bare ``cuda`` is
    the current card; the CPU binds nothing.  The card and the group are
    faked: nothing starts."""
    calls = {"set_device": [], "init": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls["set_device"].append(d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls["init"].append((a, k)))
    distributed.initialize(init_method="file:///nonexistent/store", num_processes=2,
                           process_id=1, backend=backend, device=device)
    ((args, kwargs),) = calls["init"]
    assert args == (backend,) and (kwargs["world_size"], kwargs["rank"]) == (2, 1)
    if bound is None:
        assert calls["set_device"] == [] and "device_id" not in kwargs
        return
    assert calls["set_device"] == [torch.device(bound)]
    if backend == "nccl":
        assert kwargs["device_id"] == torch.device(bound)
    else:
        assert "device_id" not in kwargs


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """The two workers' results."""
    out_dir = tmp_path_factory.mktemp("torch_devices")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), str(NPROC),
                               str(out_dir / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for i in range(NPROC)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        found = [json.loads(line[len("RESULT "):]) for line in out.splitlines()
                 if line.startswith("RESULT ")]
        assert len(found) == 1, out[-4000:]
        results.append(found[0])
    return results


def test_processes_with_placed_ranks_equal_the_default(processes):
    """Over 2 gloo processes, EC-IN's sharded step with each process's graph
    ranks on ``devices=["cpu", "cpu"]`` gives the losses and state
    fingerprints of the step without ``devices``, in both processes, with
    one gather a step; the meshes are ``{data 2, graph 2}``, and 4 local
    devices make ``{data 4, graph 2}``, two events a process from twice its
    offset."""
    for i, r in enumerate(processes):
        none, placed = r["steps"]["none"], r["steps"]["cpu x 2"]
        assert none["mesh"] == placed["mesh"] == {"data": 2, "graph": 2}
        assert none["devices"] is None and placed["devices"] == [["cpu", "cpu"]]
        assert (none["loss"], none["fingerprint"]) == (placed["loss"], placed["fingerprint"])
        assert none["gathers"] == placed["gathers"] == 1
        assert r["wide"] == [{"data": 4, "graph": 2}, 2, 2 * i, [["cpu", "cpu"]] * 2]
    assert len({r["steps"]["cpu x 2"]["loss"] for r in processes}) == 1
    assert len({r["steps"]["cpu x 2"]["fingerprint"] for r in processes}) == 1
