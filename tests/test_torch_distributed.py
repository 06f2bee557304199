"""Port parity: the ``data`` axis over processes (``parallel/distributed.py``,
``parallel/mesh.py``, ``parallel/step.py::EventMeanStep``).

The port's counterpart of ``tests/test_distributed.py``: two CPU processes
form one ``torch.distributed`` group over gloo, meeting through a
``file://`` store, and each takes its own event of the same two; the step's
gradient sum crosses the process boundary in one all-gather.  The workers
(``tests/_torch_distributed_worker.py``) start once for every check of this
file; each is bounded by ``communicate(timeout=240)`` and its group by a
120 s timeout.  At ``tests/test_parallel.py``'s TINY, f32:

  * EC-IN's DP step over ``{data 2}``: the processes' losses equal, and the
    loss, parameters and moments equal to the port's one-process step over
    both events, bit for bit; the loss within 1e-4 relative of the JAX
    oracle (``tests/test_distributed.py::_oracle_loss``);
  * EC-IN's graph-sharded step over ``{data 2, graph 2}`` and TP step over
    ``{data 2, model 2}``: equal to the one-process steps of the same meshes
    bit for bit, and within the JAX test's bounds of the JAX unsharded step
    (loss 1e-4 relative, parameters rtol 5e-4 / atol 1e-5);
  * BC-HGNN-GMM's DP step: every buffer (the ``score_cut`` and ``knn_radius``
    EMAs, the batch statistics) equal to the one-process step's;
  * ``assert_host_identical`` failing on both processes after one moved one
    parameter by one ulp; meshes, batches and threads refused where they
    must be.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.data.synthetic import generate_dataset as j_generate
from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
from hierarchicalgnn_tpu.parallel import distributed as j_distributed
from hierarchicalgnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from hierarchicalgnn_tpu.parallel.step import make_dp_train_step as j_dp_step
from hierarchicalgnn_tpu.parallel.step import stack_events as j_stack
from hierarchicalgnn_tpu.train.optim import make_optimizer as j_make_optimizer
from hierarchicalgnn_tpu.train.trainer import Trainer as JTrainer

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_dataset
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.parallel import distributed, mesh as mesh_mod, tp
from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
from hierarchicalgnn_torch.parallel.step import make_dp_train_step, stack_events
from hierarchicalgnn_torch.train.checkpoint import train_state
from hierarchicalgnn_torch.train.optim import make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to

import _torch_distributed_worker as worker
from _torch_parity import flax_leaves, to_dict
from test_parallel import TINY as JAX_TINY

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")
REPO = worker.REPO
NPROC = 2
TINY = worker.TINY
RTOL, ATOL, LOSS_RTOL = 5e-4, 1e-5, 1e-4   # the JAX test's bounds
CHECKS = ("mesh", "dp", "sharded", "tp", "bc", "drift", "thread")


def _jax_oracle(out_dir):
    """The JAX EC-IN's initial variables (written for the workers) and its
    unsharded DP step over both events (mesh 1 x 1): (loss, flax params)."""
    hparams, model, pipeline = j_selector("EC-IN", TINY)
    raws = j_generate(NPROC, seed=worker.DATA_SEED, n_particles=worker.N_PARTICLES)
    evs = [jax.tree.map(jnp.asarray, j_preprocess(e, hparams)) for e in raws]
    trainer = JTrainer(hparams, model, pipeline, run_dir=str(out_dir / "jax_run"))
    state = trainer.init_state(evs[0])
    variables = to_dict({"params": state.params, **state.buffers})
    np.savez(out_dir / "ec_in_variables.npz", **worker.flat(variables))
    return hparams, pipeline, state, j_stack(evs), variables


def _spawn(out_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    store = out_dir / "store"
    return [subprocess.Popen([sys.executable, WORKER, str(i), str(NPROC), str(store),
                              str(out_dir)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=REPO)
            for i in range(NPROC)]


def _collect(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
    results = []
    for out in outs:
        found = {}
        for line in out.splitlines():
            if not line.startswith("RESULT "):
                continue
            record = json.loads(line[len("RESULT "):])
            found[record.pop("check")] = record
        assert tuple(found) == CHECKS, f"worker output lacks checks:\n{out[-4000:]}"
        results.append(found)
    return results


def _port_ec_in(variables, raws):
    hp, model, pipeline = model_selector("EC-IN", TINY)
    convert.load_jax_variables(model, variables)
    events = [event_to(preprocess_event(r, hp), "cpu") for r in raws]
    return hp, model, pipeline, make_optimizer(list(model.parameters()), hp,
                                               worker.STEPS_PER_EPOCH), events


def _one_process_steps(variables):
    """The port's one-process steps over both events, for each check:
    (the metrics as float hex, {"state": flat train state, "flax": flat
    params}; BC also its buffers before the step)."""
    raws = generate_dataset(NPROC, seed=worker.DATA_SEED, n_particles=worker.N_PARTICLES)
    out = {}

    hp, model, pipeline, optimizer, events = _port_ec_in(variables, raws)
    metrics = make_dp_train_step(pipeline, optimizer, {"data": 2})(stack_events(events), 0)
    out["dp"] = (worker.exact(metrics), worker.flat(
        {"state": train_state(model, optimizer),
         "flax": convert.to_jax_variables(model)["params"]}))

    hp, model, pipeline, optimizer, events = _port_ec_in(variables, raws)
    step = make_sharded_train_step(pipeline, optimizer, {"data": 2, "graph": 2}, hp,
                                   device="cpu")
    metrics = step(events, 0)
    out["sharded"] = (worker.exact(metrics), worker.flat(
        {"state": train_state(model, optimizer),
         "flax": convert.to_jax_variables(model)["params"]}))

    hp, model, pipeline, optimizer, events = _port_ec_in(variables, raws)
    state, step = tp.make_tp_train_step(pipeline, optimizer, tp.make_tp_mesh(2, 2, hp["hidden"]),
                                        train_state(model, optimizer), hp["hidden"],
                                        device="cpu")
    state, metrics = step(state, events, 0)
    out["tp"] = (worker.exact(metrics), worker.flat(
        {"state": tp.unshard_state(state),
         "flax": convert.tp_to_jax_variables(model, state)["params"]}))

    hp, model, pipeline = model_selector("BC-HGNN-GMM", TINY)
    events = [event_to(preprocess_event(r, hp), "cpu") for r in raws]
    optimizer = make_optimizer(list(model.parameters()), hp, worker.STEPS_PER_EPOCH)
    before = {k: v.clone() for k, v in model.named_buffers()}
    metrics = make_dp_train_step(pipeline, optimizer, {"data": 2})(events, worker.BC_EPOCH)
    out["bc"] = (worker.exact(metrics),
                 worker.flat({"state": train_state(model, optimizer)}), before)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two workers' results, the port's one-process steps and the JAX
    oracle; the workers run while this process computes the others."""
    out_dir = tmp_path_factory.mktemp("torch_distributed")
    threads = torch.get_num_threads()
    torch.set_num_threads(worker.N_THREADS)
    try:
        hparams, pipeline, state, batch, variables = _jax_oracle(out_dir)
        procs = _spawn(out_dir)
        try:
            new_state, metrics = j_dp_step(pipeline, j_make_optimizer(hparams, NPROC),
                                           j_make_mesh(data=1, graph=1))(state, batch, 0)
            oracle = (float(metrics["training_loss"]), to_dict(new_state.params))
            one = _one_process_steps(variables)
        finally:
            results = _collect(procs)
    finally:
        torch.set_num_threads(threads)
    saved = {check: [dict(np.load(out_dir / f"{check}_{i}.npz")) for i in range(NPROC)]
             for check in ("dp", "sharded", "tp", "bc")}
    return {"results": results, "saved": saved, "one": one, "oracle": oracle}


def _loss(record):
    return float.fromhex(record["loss"])


def _assert_equal_states(got, want, label):
    assert got.keys() == want.keys(), label
    for key, value in want.items():
        assert np.array_equal(got[key], value), f"{label}: {key} differs"


def _assert_near_jax(flax_params, oracle_params, label):
    want = dict(flax_leaves(oracle_params))
    got = {k[len("flax/"):]: v for k, v in flax_params.items() if k.startswith("flax/")}
    assert got.keys() == want.keys(), label
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} {path}")


def test_tiny_is_the_jax_tests_tiny():
    assert TINY == JAX_TINY


def test_global_mesh_of_two_processes(runs):
    """The JAX worker's layout: 2 processes of 2 graph ranks each is ``{data
    2, graph 2}``; each process runs one event from its own offset (two from
    twice its offset on ``make_mesh(4, 1, group)``); the meshes that do not
    fit are refused in both processes."""
    for i, found in enumerate(runs["results"]):
        m = found["mesh"]
        assert m["shape"] == {"data": 2, "graph": 2} and m["wide"] == {"data": 4, "graph": 1}
        assert (m["world"], m["process"], m["local_events"], m["offset"]) == (2, i, 1, i)
        assert m["wide_local"] == [2, 2 * i]
        assert all(m["refused"].values()), m["refused"]


@pytest.mark.parametrize("check", ["dp", "sharded", "tp"])
def test_ec_in_step_across_processes(runs, check):
    """EC-IN's step with its ``data`` axis over the 2 processes equals the
    one-process step of the same mesh over both events, bit for bit: every
    metric (``grad_norm`` too: the clip and Adam's normalisation would hide
    a gradient off by a factor), every parameter, moment and buffer; the
    processes agree; the
    loss is within 1e-4 relative of the JAX oracle and the parameters within
    the JAX test's bounds of the JAX unsharded step."""
    losses = [_loss(found[check]) for found in runs["results"]]
    assert losses[0] == losses[1], f"{check}: the processes disagree on the loss"
    one_metrics, one_state = runs["one"][check]
    for found in runs["results"]:  # loss, grad_norm and the rest, exactly
        assert found[check]["metrics"] == one_metrics, check
    for i, saved in enumerate(runs["saved"][check]):
        _assert_equal_states(saved, one_state, f"{check} process {i}")
    oracle_loss, oracle_params = runs["oracle"]
    np.testing.assert_allclose(losses[0], oracle_loss, rtol=LOSS_RTOL)
    _assert_near_jax(runs["saved"][check][0], oracle_params, check)


def test_steps_meet_once_and_split(runs):
    """The sharded step gathered once a step across the processes, kept its
    ``graph`` collectives inside each process and its auction replicated over
    several events; the TP step split leaves and met in its own ranks."""
    for found in runs["results"]:
        sharded, tp_run, dp = found["sharded"], found["tp"], found["dp"]
        assert sharded["gathers"] == 1 and sharded["gather_bytes"] > 0
        assert sharded["matching_spmd"] is None and sharded["collectives"]["all_gather"] > 0
        assert tp_run["n_split"] > 0 and tp_run["collectives"]["all_gather_features"] > 0
        assert (dp["offset"], dp["count"]) == (found["mesh"]["offset"], 2)


def test_bc_buffers_across_processes(runs):
    """BC-HGNN-GMM's DP step over the processes moves every buffer (the
    ``score_cut`` and ``knn_radius`` EMAs, the batch statistics) exactly as
    the one-process step over both events does, and both processes end with
    the same state, parameters and moments included."""
    one_metrics, one_state, before = runs["one"]["bc"]
    results = runs["results"]
    assert results[0]["bc"]["metrics"] == results[1]["bc"]["metrics"] == one_metrics
    assert results[0]["bc"]["fingerprint"] == results[1]["bc"]["fingerprint"]
    for i, saved in enumerate(runs["saved"]["bc"]):
        _assert_equal_states(saved, one_state, f"BC process {i}")
    moved = [k for k, v in before.items()
             if not np.array_equal(one_state[f"state/buffers/{k}"], v.numpy())]
    assert any("score_cut" in k for k in moved) and any("knn_radius" in k for k in moved)
    assert any(k.endswith("mean") for k in moved), moved


def test_one_ulp_drift_fails_every_process(runs):
    """``assert_host_identical`` passes on the identical state and raises on
    BOTH processes once the last one moved one parameter element by one ulp,
    naming every process's fingerprint."""
    for found in runs["results"]:
        drift = found["drift"]
        assert drift["raised"], drift
        assert len(re.findall(r"[0-9a-f]{16}", drift["message"].split("(")[0])) == NPROC


def test_no_collective_from_a_rank_thread(runs):
    for found in runs["results"]:
        assert found["thread"]["refused"], found["thread"]
        assert "rank thread" in found["thread"]["message"]


def test_fingerprint_sees_one_bf16_ulp():
    """The fingerprint hashes a bf16 tensor's own bytes: one ulp of one
    element moves it; dtype and shape count too, the order of a dict's keys
    does not."""
    gen = torch.Generator().manual_seed(0)
    t = torch.randn(64, generator=gen).to(torch.bfloat16)
    moved = t.clone()
    moved.view(torch.int16)[17] += 1  # the next bf16 away from zero: one ulp
    assert not torch.equal(moved, t) and float((moved.float() - t.float()).abs().max()) <= (
        2 ** -7 * float(t[17].abs()))
    fp = distributed.fingerprint
    assert fp({"a": t}) == fp({"a": t.clone()}) and fp({"a": t}) != fp({"a": moved})
    assert fp({"a": t}) != fp({"a": t.float()}) and fp({"a": t}) != fp({"a": t.view(8, 8)})
    assert fp({"a": 1, "b": t}) == fp({"b": t, "a": 1})  # dict order does not count
    assert len(fp({"a": t})) == 8


@pytest.mark.parametrize("graph", [-1, 0, 1, 2, 3, 4, 8])
def test_global_mesh_raises_where_jax_raises(graph):
    """One process.  The port's ``make_global_mesh`` refuses a
    ``graph_per_host`` below 1, for which the JAX one fails too, and
    otherwise gives ``{data 1, graph}``: one event a step over ``graph``
    thread ranks, the JAX mesh of a process whose local devices are its
    ``graph`` ranks (here with all 8 of this test's CPU devices: graph 8).
    The JAX one also refuses a ``graph_per_host`` that does not divide the
    local devices (3 of 8); thread ranks are no counted devices, so the port
    has no such refusal."""
    assert jax.local_device_count() == 8
    if graph < 1:
        with pytest.raises(ValueError, match="at least 1"):
            distributed.make_global_mesh(graph)
        with pytest.raises((ValueError, ZeroDivisionError)):
            j_distributed.make_global_mesh(graph)
        return
    got = distributed.make_global_mesh(graph)
    assert got.shape == {"data": 1, "graph": graph} and got.group is None
    assert (got.local_events, got.offset) == (1, 0)
    if 8 % graph:
        with pytest.raises(ValueError, match="incompatible"):
            j_distributed.make_global_mesh(graph)
    elif graph == 8:
        assert dict(j_distributed.make_global_mesh(graph).shape) == got.shape


def test_make_mesh_and_batch_sharding():
    """``make_mesh`` refuses an axis below 1 (and, over a group, a data size
    its processes do not divide: the workers' ``mesh`` check); the batch
    sharding puts node arrays on ``data`` and edge arrays on ``data x
    graph``, as the JAX table does; ``replicated`` splits nothing; the TP
    mesh takes a Mesh of graph 1 for its ``data`` axis."""
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(0, 2)
    with pytest.raises(ValueError):
        j_make_mesh(data=16, graph=1)  # the JAX mesh raises for too few devices
    mesh = mesh_mod.make_mesh(2, 4)
    assert (mesh.shape, mesh.world_size, mesh.local_events, mesh.offset) == (
        {"data": 2, "graph": 4}, 1, 2, 0)
    specs = mesh_mod.batch_sharding(mesh)
    assert specs.x.spec == specs.n_particles.spec == ("data",)
    assert specs.graph.senders.spec == specs.y.spec == ("data", "graph")
    assert specs.true_graph.edge_mask.mesh is mesh
    assert mesh_mod.replicated(mesh).spec == ()
    assert mesh_mod.as_mesh({"data": 2, "graph": 4}) == mesh
    tp_mesh = tp.make_tp_mesh(mesh_mod.make_mesh(2), 4)  # the TP step's data axis
    assert (tp_mesh.data, tp_mesh.model, tp_mesh.group) == (2, 4, None)
    assert tp_mesh == tp.make_tp_mesh(2, 4)
    with pytest.raises(ValueError, match="graph 4"):
        tp.make_tp_mesh(mesh, 2)


def test_globalize_batch_checks_the_local_stack():
    """The local stack must hold the process's share of the events and edge
    arrays that split over ``graph``; the result carries its offset and the
    global count, and the steps take it (a step of another count refuses
    it)."""
    hp, _, pipeline = model_selector("EC-IN", TINY)
    raws = generate_dataset(2, seed=worker.DATA_SEED, n_particles=worker.N_PARTICLES)
    events = [event_to(preprocess_event(r, hp), "cpu") for r in raws]
    mesh = mesh_mod.make_mesh(2, 2)
    batch = distributed.globalize_batch(stack_events(events), mesh_mod.batch_sharding(mesh))
    assert (batch.offset, batch.count, batch.events.x.shape[0]) == (0, 2, 2)
    with pytest.raises(ValueError, match="globalized for 2 events"):  # a step of 4 events
        make_dp_train_step(pipeline, None, mesh_mod.make_mesh(4)).forward_backward(batch, 0)
    with pytest.raises(ValueError, match="events"):
        distributed.globalize_batch(stack_events(events[:1]), mesh_mod.batch_sharding(mesh))
    odd = mesh_mod.make_mesh(2, 3)  # 1024 edges do not split over 3 ranks
    with pytest.raises(ValueError, match="graph 3"):
        distributed.globalize_batch(stack_events(events), mesh_mod.batch_sharding(odd))


def test_initialize_needs_a_group_and_a_card(monkeypatch):
    """Without a coordinator, an init method or torchrun's environment,
    ``initialize`` raises; it defaults to the card and raises without one;
    a process id without a count is refused.  (The workers initialise.)"""
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize(init_method="file:///nonexistent/store", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        distributed.initialize("localhost:1", 2, 0, init_method="env://", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()
