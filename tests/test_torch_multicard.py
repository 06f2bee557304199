"""Ranks on several cards: the meshes' ``devices``, K8's launches per card,
and the placement of ranks on devices, on the CPU.

  * ``make_mesh`` and ``make_tp_mesh`` with ``devices`` take the first
    ``data x graph`` (``data x model``) of them, reshaped as the JAX
    functions reshape theirs (held against them on ``jax.devices()``, the
    8 virtual CPU devices of ``conftest.py``), and raise in the JAX words
    when there are too few.
  * ``devices=["cpu"] * P`` is the ``devices=None`` path bit for bit: the
    sharded forward of BC-HGNN-GMM at P 2, the sharded step of EC-IN at P 2
    and the TP step of EC-IN at M 2; all three within the tolerances of
    ``tests/test_torch_graph_shard.py``, ``tests/test_torch_sharded_train.py``
    and ``tests/test_torch_tp.py`` of the JAX package's unsharded forward or
    step.
  * Named devices, even the model's own, take the placement path (inputs
    and buffers handed to each rank through ``place_inputs``, outputs
    brought back); ranks on ``cpu:0`` against the model's ``cpu`` make every
    copy of the card path (none crosses a bus) and match the default path
    within the same tolerances.
  * K8's grouping of ranks into launches, and ``gather_schedule`` over a
    rank range with the grid capped: the launches together write every
    output byte once.

The split launches on the card, the timeout and peer access are in
``chip_smoke.py`` phase 26 and in the ``cuda``-marked tests below, which run
on the card without JAX (the JAX package is imported inside the CPU tests):

    python -m pytest tests/test_torch_multicard.py -q --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.kernels import ring_gather as rg
from hierarchicalgnn_torch.parallel import comm, graph_shard as gs, mesh as mesh_mod, tp
from hierarchicalgnn_torch.train.checkpoint import MOMENTS, train_state
from hierarchicalgnn_torch.train.optim import make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/_torch_parity.py::one_thread``): the suite
    runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    """The JAX package's side of the CPU tests, and the parity helpers that
    import it (neither is imported on the card)."""
    import jax
    import jax.numpy as jnp

    from hierarchicalgnn_tpu.parallel import tp as j_tp
    from hierarchicalgnn_tpu.parallel.mesh import make_mesh as j_make_mesh

    return jax, jnp, j_tp, j_make_mesh


def N(a):
    from _torch_parity import N as to_numpy

    return to_numpy(a)

# tests/test_torch_tp.py's TINY: f32, one iteration of each block
TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 1,
        "n_hierarchical_graph_iters": 1, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "train_split": [4, 2, 2], "warmup": 2, "use_pallas": False,
        "compute_dtype": "float32"}
EPOCH = {"EC-IN": 0, "BC-HGNN-GMM": 50}
CPU = torch.device("cpu")
OTHER = torch.device("cpu", 0)  # not the model's device (``cpu``): the placement path


# ---------------------------------------------------------------------------
# The meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,graph", [(1, 1), (1, 4), (2, 4), (4, 2), (8, 1), (3, 2)])
def test_meshes_reshape_devices_as_jax(data, graph):
    """Rank g of event e runs on the device the JAX mesh puts at [e, g]:
    devices named by index (``cpu:i`` for JAX's device i), the first
    ``data x graph`` of them in row-major order; both TP meshes likewise."""
    jax, _, j_tp, j_make_mesh = _jax()
    devices = [torch.device("cpu", i) for i in range(8)]
    want = j_make_mesh(data, graph, jax.devices()).devices
    got = mesh_mod.make_mesh(data, graph, devices=devices)
    assert (len(got.devices), len(got.devices[0])) == want.shape == (data, graph)
    assert [[d.index for d in row] for row in got.devices] == [
        [d.id for d in row] for row in want]
    assert got.shape == {"data": data, "graph": graph}
    want_tp = j_tp.make_tp_mesh(data, graph, jax.devices()).devices
    got_tp = tp.make_tp_mesh(data, graph, devices=devices)
    assert [[d.index for d in row] for row in got_tp.devices] == [
        [d.id for d in row] for row in want_tp]
    assert mesh_mod.make_mesh(data, graph).devices is None  # the caller's one device
    assert tp.make_tp_mesh(data, graph).devices is None


def test_meshes_refuse_too_few_devices_in_jax_words():
    """Too few devices raise with the JAX message; a repeated device is
    allowed (ranks share it); a card that does not exist raises and is
    never shared instead."""
    _, _, j_tp, j_make_mesh = _jax()
    with pytest.raises(ValueError) as want:
        j_make_mesh(data=16, graph=1)
    with pytest.raises(ValueError) as got:
        mesh_mod.make_mesh(16, 1, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value) == "mesh 16x1 needs 16 devices, have 8"
    with pytest.raises(ValueError) as want:
        j_tp.make_tp_mesh(data=4, model=4)
    with pytest.raises(ValueError) as got:
        tp.make_tp_mesh(4, 4, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)
    shared = mesh_mod.make_mesh(1, 4, devices=["cpu"] * 4)
    assert shared.devices == ((CPU,) * 4,)
    missing = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"names card {missing}"):
        mesh_mod.make_mesh(1, 2, devices=["cpu", f"cuda:{missing}"])
    with pytest.raises(RuntimeError, match="names card"):
        comm.run_sharded(lambda c: None, 2, devices=[f"cuda:{missing}"] * 2)
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        comm.run_sharded(lambda c: None, 2, devices=["cpu"] * 3)
    # devices=None reads the inputs themselves; named devices, even the
    # caller's own, get their copies (one per device)
    x = torch.ones(3)
    inputs_of, buffers_of = comm.place_inputs((x,), None, [x])
    assert inputs_of(1)[0] is x and buffers_of(1) == {}
    inputs_of, buffers_of = comm.place_inputs((x, np.zeros(2)), [CPU, OTHER, OTHER], [x])
    assert inputs_of(0)[0] is x and torch.is_tensor(inputs_of(0)[1])
    assert inputs_of(1)[0] is inputs_of(2)[0] is not x  # a copy (on the CPU, ``cpu`` again)
    assert buffers_of(0)[id(x)] is x and buffers_of(1)[id(x)] is buffers_of(2)[id(x)] is not x


def test_collectives_leave_each_rank_its_result_on_its_device():
    """Ranks on ``cpu`` and ``cpu:0``: the collectives' results equal the
    one-device results exactly, and their backward hands every rank its
    gradient on its own device, equal to the one-device gradient to f32
    rounding (the copies between the devices add autograd nodes, so a leaf's
    contributions from its five collectives may add in another order)."""
    devices = [CPU, OTHER, OTHER, CPU]
    rng = np.random.default_rng(0)
    blocks = [torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32)) for _ in devices]
    leaves = [b.clone().requires_grad_() for b in blocks]
    kinds = ("all_gather", "psum", "psum_scatter", "pmax", "all_gather_features")

    def body(c):
        x = leaves[c.index]
        return [getattr(c, kind)(x) for kind in kinds]

    placed, _ = comm.run_sharded(body, 4, device="cpu", devices=devices)
    default, _ = comm.run_sharded(body, 4, device="cpu")
    for r in range(4):
        for got, want in zip(placed[r], default[r]):
            assert torch.equal(got, want)
    cot = [[torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in outs]
           for outs in default]
    loss = lambda outs: sum((t * w).sum() for ts, ws in zip(outs, cot) for t, w in zip(ts, ws))
    want = torch.autograd.grad(loss(default), leaves)
    got = torch.autograd.grad(loss(placed), leaves)
    for g, w in zip(got, want):  # each leaf's 5 contributions, added by autograd in its order
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # replicate: one view per rank, the gradient back on the tensor's device
    x = torch.ones(3, requires_grad=True)
    views = comm.replicate(x, 3, [CPU, OTHER, OTHER])
    assert views[1].data_ptr() == views[2].data_ptr() != x.data_ptr()
    (g,) = torch.autograd.grad(sum(v.sum() * (i + 1) for i, v in enumerate(views)), [x])
    assert torch.equal(g, torch.full((3,), 6.0))


# ---------------------------------------------------------------------------
# K8: launches per card and the schedule over a rank range
# ---------------------------------------------------------------------------


def test_launch_groups_are_contiguous_ranges():
    """One launch per run of equal (card, stream) keys, in rank order; a
    card whose ranks are not contiguous raises."""
    assert rg.launch_groups([0, 0, 0, 0]) == (rg.Launch(0, 0, 4),)
    assert rg.launch_groups([0, 0, 1, 1]) == (rg.Launch(0, 0, 2), rg.Launch(1, 2, 2))
    assert rg.launch_groups([3, 1, 2, 0]) == tuple(rg.Launch(k, r, 1)
                                                   for r, k in enumerate([3, 1, 2, 0]))
    streams = [(0, 7), (0, 7), (0, 9), (0, 9)]  # one card, two streams
    assert rg.launch_groups(streams) == (rg.Launch((0, 7), 0, 2), rg.Launch((0, 9), 2, 2))
    for keys in ([0, 1, 0], [0, 0, 1, 1, 0], [(0, 7), (0, 9), (0, 7)]):
        with pytest.raises(ValueError, match="not contiguous"):
            rg.launch_groups(keys)


def _walk(cut, block_bytes, in_addrs, out_addrs, counts):
    """Add to ``counts`` ([P, P * B]) one for every output byte the launch of
    ``cut`` writes: its bulk pairs and its vector loop's heads and tails,
    each into every output."""
    n = len(in_addrs)
    assert len(cut.pairs()) == cut.n_pairs
    for r, c in cut.pairs():
        off = cut.head[r] + c * cut.chunk
        nbytes = min(cut.chunk, cut.bulk[r] - c * cut.chunk)
        assert 0 < nbytes <= cut.chunk and (in_addrs[r] + off) % 16 == 0
        for q in range(n):
            counts[q, r * block_bytes + off:r * block_bytes + off + nbytes] += 1
    for r in cut.served():
        for lo, hi in ((0, cut.head[r]), (cut.head[r] + cut.bulk[r], block_bytes)):
            assert lo % cut.vector == 0 and hi % cut.vector == 0
            for q in range(n):
                counts[q, r * block_bytes + lo:r * block_bytes + hi] += 1


@pytest.mark.parametrize("split", [(4,), (2, 2), (1, 1, 1, 1), (1, 3)])
@pytest.mark.parametrize("shape,dtype,offset", [
    ((6144, 256), torch.bfloat16, 0),   # the flagship's halo block at P 4
    ((1001, 3), torch.float32, 12),     # heads and tails on every rank
    ((768, 4), torch.float32, 4),
])
def test_gather_schedule_over_rank_ranges(split, shape, dtype, offset):
    """Launches over the rank ranges of ``split`` on one card, each capped at
    the card's blocks over the launches: each grid within its cap, the
    launches' pairs those of their own ranks, and all launches together
    write every output byte exactly once."""
    resident, n = 132, 4
    block_bytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    outs = rg._outputs(torch.empty(shape, dtype=dtype), n)
    base = outs[0].data_ptr()
    out_addrs = [(1 << 24) + o.data_ptr() - base for o in outs]
    in_addrs = [(1 << 20) * (r + 1) + offset for r in range(n)]
    whole = rg.gather_schedule(block_bytes, in_addrs, out_addrs, resident)
    counts = np.zeros((n, n * block_bytes), dtype=np.int64)
    rank0 = 0
    for n_local in split:
        cut = rg.gather_schedule(block_bytes, in_addrs, out_addrs, resident // len(split),
                                 rank0, n_local)
        assert 1 <= cut.grid <= resident // len(split)
        assert {r for r, _ in cut.pairs()} <= set(cut.served())
        assert (cut.head, cut.bulk, cut.vector) == (whole.head, whole.bulk, whole.vector)
        _walk(cut, block_bytes, in_addrs, out_addrs, counts)
        rank0 += n_local
    assert (counts == 1).all(), "a byte written twice or never"
    assert split != (4,) or rg.gather_schedule(
        block_bytes, in_addrs, out_addrs, resident, 0, 4) == whole


# ---------------------------------------------------------------------------
# The three paths: devices=["cpu"] * P bit for bit, the placement path, JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw():
    return generate_event(np.random.default_rng(3), n_particles=12)


def _pair(name, raw):
    """The JAX model, its variables (jnp) and batch; the port's model,
    pipeline and hparams with the same weights."""
    jax, jnp, _, _ = _jax()
    from _torch_parity import seeded_variables, to_dict
    from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
    from hierarchicalgnn_tpu.models.registry import model_selector as j_selector

    hp_j, model_j, pipeline_j = j_selector(name, TINY)
    batch_j = jax.tree.map(jnp.asarray, j_preprocess(raw, hp_j, stage="test"))
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.key(0), batch_j.x, batch_j.graph, node_mask=batch_j.node_mask,
        training=False))
    variables = seeded_variables(shapes, seed=11)
    hp, model, pipeline = model_selector(name, TINY)
    convert.load_jax_variables(model, to_dict(variables))
    return hp_j, model_j, pipeline_j, jax.tree.map(jnp.asarray, variables), batch_j, \
        hp, model, pipeline


@pytest.fixture
def placed(monkeypatch):
    """The ``devices`` of every ``place_inputs`` call of the sharded and TP
    forwards: None on the default path, the named devices on the other."""
    seen = []

    def spy(inputs, devices, buffers=()):
        seen.append(None if devices is None else list(devices))
        return comm.place_inputs(inputs, devices, buffers)

    monkeypatch.setattr(gs, "place_inputs", spy)
    monkeypatch.setattr(tp, "place_inputs", spy)
    return seen


def _canonical(bgraph, scores, c):
    s, r, m = (N(a) for a in bgraph)
    keys = (s.astype(np.int64) * c + r)[m]
    order = np.argsort(keys, kind="stable")
    return keys[order], N(scores)[m][order]


def test_bc_sharded_forward_on_devices(raw, placed):
    """BC-HGNN-GMM's sharded forward at P 2: ``devices=["cpu"] * 2`` equal
    to ``devices=None`` bit for bit; ranks on ``cpu:0`` within 1e-4; both
    against the JAX unsharded forward as ``tests/test_torch_graph_shard.py``
    holds the sharded forward (clusters and edges exact, scores 1e-4,
    embeddings 1e-4 / 1e-5)."""
    from hierarchicalgnn_tpu.inference import InferenceEngine as JEngine

    hp_j, model_j, _, variables, batch_j, hp, model, pipeline = _pair("BC-HGNN-GMM", raw)
    j_engine = JEngine(hp_j, model_j, variables["params"],
                       {k: v for k, v in variables.items() if k != "params"})
    bg_j, sc_j, emb_j, aux_j = j_engine._forward(j_engine.variables, batch_j.x, batch_j.graph,
                                                 batch_j.node_mask)
    batch = preprocess_event(raw, hp, stage="test")
    outs = {}
    for label, devices in (("none", None), ("cpu", ["cpu"] * 2), ("other", [OTHER] * 2)):
        forward = gs.make_sharded_forward(pipeline, 2, hp, device="cpu", devices=devices)
        outs[label] = forward(batch)
        assert forward.last_stats["partition_ok"] is True
    assert placed == [None, [CPU] * 2, [OTHER] * 2]
    flat = lambda out: [out[0].senders, out[0].receivers, out[0].edge_mask, out[1], out[2],
                        out[3]["clusters"]]
    assert all(torch.equal(a, b) for a, b in zip(flat(outs["none"]), flat(outs["cpu"])))
    assert outs["none"][3]["n_clusters"] == outs["cpu"][3]["n_clusters"]
    c = hp["max_clusters"]
    keys_j, scores_j = _canonical(bg_j, sc_j, c)
    for label in ("cpu", "other"):
        bg, sc, emb, aux = outs[label]
        assert all(t.device == CPU for t in flat(outs[label]))
        assert aux["n_clusters"] == int(aux_j["n_clusters"]) > 3
        np.testing.assert_array_equal(N(aux["clusters"]), np.asarray(aux_j["clusters"]))
        keys, scores = _canonical(bg, sc, c)
        np.testing.assert_array_equal(keys, keys_j)
        np.testing.assert_allclose(scores, scores_j, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(N(emb), np.asarray(emb_j), rtol=1e-4, atol=1e-5)
    for a, b in zip(flat(outs["other"]), flat(outs["none"])):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-4, atol=1e-4)


def _assert_grads(model, grads, want, rel, label):
    for (path, _), g, w in zip(model.named_parameters(), grads, want):
        if w is None:
            assert g is None, (label, path)
            continue
        np.testing.assert_allclose(N(g), N(w), rtol=0, atol=rel * float(w.abs().max()) + 1e-7,
                                   err_msg=f"{label} {path}")


def test_ec_in_sharded_step_on_devices(raw, placed):
    """EC-IN's sharded step at P 2 through ``Trainer``'s route
    (``make_sharded_train_step(..., devices=...)``): ``devices=["cpu"] * 2``
    gives the ``devices=None`` loss, gradients and buffers bit for bit;
    ranks on ``cpu:0`` within the port's unsharded tolerance (loss 1e-5,
    gradients 1e-5 of the leaf's largest entry plus 1e-7); all against the
    JAX unsharded ``value_and_grad`` as ``tests/test_torch_sharded_train.py``
    holds them (loss 1e-4, gradients 1e-3 plus 1e-7)."""
    jax, _, _, _ = _jax()
    from _torch_parity import flax_leaves, to_dict
    _, _, pipeline_j, variables, batch_j, hp, model, pipeline = _pair("EC-IN", raw)
    buffers = {k: v for k, v in variables.items() if k != "params"}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: pipeline_j.loss(p, buffers, batch_j, EPOCH["EC-IN"], training=True)[0]))(
        variables["params"])
    batch = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for label, devices in (("none", None), ("cpu", ["cpu"] * 2), ("other", [OTHER] * 2)):
        model.load_state_dict(start)
        step = gs.make_sharded_train_step(pipeline, make_optimizer(model.parameters(), hp, 1),
                                          {"data": 1, "graph": 2}, hp, device="cpu",
                                          devices=devices)
        grads, metrics = step.forward_backward(batch, EPOCH["EC-IN"])
        runs[label] = (float(metrics["training_loss"]), grads)
        assert step.last_stats["partition_ok"] is True
    assert placed == [None, [CPU] * 2, [OTHER] * 2]
    (loss, grads), (loss_c, grads_c) = runs["none"], runs["cpu"]
    assert loss == loss_c and all((a is None and b is None) or torch.equal(a, b)
                                  for a, b in zip(grads, grads_c))
    loss_o, grads_o = runs["other"]
    assert loss_o == pytest.approx(loss, rel=1e-5)
    _assert_grads(model, grads_o, grads, 1e-5, "cpu:0")
    want_j = dict(flax_leaves(to_dict(grads_j)))
    by_param = {id(p): g for p, g in zip(model.parameters(), grads_o)}
    for label, (value, _) in runs.items():
        assert value == pytest.approx(float(loss_j), rel=1e-4), label
    for path, tensor, transpose in convert.param_targets(model):
        w, g = want_j[path], by_param[id(tensor)]
        np.testing.assert_allclose(N(g).T if transpose else N(g), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max() + 1e-7, err_msg=path)


def test_ec_in_tp_step_on_devices(raw, placed):
    """EC-IN's TP step at M 2 (``make_tp_mesh(1, 2, hidden, devices)``):
    ``devices=["cpu"] * 2`` gives the ``devices=None`` state bit for bit;
    ranks on ``cpu:0`` (the shards and moments there, the replicated leaves
    read through copies) within rtol 5e-4 / atol 1e-5 of it, and both within
    the same bounds (loss 1e-4) of the JAX unsharded step, as
    ``tests/test_torch_tp.py`` holds the TP step."""
    _, jnp, _, j_make_mesh = _jax()
    from _torch_parity import flax_leaves, to_dict
    from hierarchicalgnn_tpu.parallel.step import make_dp_train_step as j_dp_step
    from hierarchicalgnn_tpu.train.optim import make_optimizer as j_make_optimizer
    from hierarchicalgnn_tpu.train.trainer import TrainState

    _, _, pipeline_j, variables, batch_j, hp, model, pipeline = _pair("EC-IN", raw)
    flax_vars = to_dict(variables)  # the JAX step donates its state
    optimizer_j = j_make_optimizer(hp, 4)
    params = variables["params"]
    state_j = TrainState(params=params,
                         buffers={k: v for k, v in variables.items() if k != "params"},
                         opt_state=optimizer_j.init(params), step=jnp.zeros((), jnp.int32))
    from hierarchicalgnn_tpu.parallel.step import stack_events as j_stack
    new_j, metrics_j = j_dp_step(pipeline_j, optimizer_j, j_make_mesh(data=1, graph=1))(
        state_j, j_stack([batch_j]), 0)
    want_params = to_dict(new_j.params)
    event = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
    start = train_state(model, make_optimizer(list(model.parameters()), hp, 4))
    results = {}
    for label, devices in (("none", None), ("cpu", ["cpu"] * 2), ("other", [OTHER] * 2)):
        convert.load_jax_variables(model, flax_vars)
        optimizer = make_optimizer(list(model.parameters()), hp, 4)
        mesh = tp.make_tp_mesh(1, 2, hp["hidden"], devices=devices)
        state, step = tp.make_tp_train_step(pipeline, optimizer, mesh, start, hp["hidden"],
                                            device="cpu")
        state, metrics = step(state, event, 0)
        results[label] = (float(metrics["training_loss"]), tp.unshard_state(state))
        assert placed[-1] == {"none": None, "cpu": [CPU] * 2, "other": [OTHER] * 2}[label]
        if label == "other":
            split = next(iter(state.split))
            assert state.params[1][split].device == CPU
    (loss, s0), (loss_c, s1) = results["none"], results["cpu"]
    assert loss == loss_c
    for part in ("params", "buffers"):
        for n, value in s0[part].items():
            assert torch.equal(s1[part][n], value), (part, n)
    for key in MOMENTS:
        for n, value in s0["opt_state"][key].items():
            assert torch.equal(s1["opt_state"][key][n], value), (key, n)
    loss_o, s2 = results["other"]
    np.testing.assert_allclose(loss_o, loss, rtol=1e-4)
    for n, value in s0["params"].items():
        np.testing.assert_allclose(N(s2["params"][n]), N(value), rtol=5e-4, atol=1e-5,
                                   err_msg=n)
    for label, (value, state) in results.items():
        np.testing.assert_allclose(value, float(metrics_j["training_loss"]), rtol=1e-4,
                                   err_msg=label)
        model.load_state_dict({**state["params"], **state["buffers"]})
        got = dict(flax_leaves(convert.to_jax_variables(model)["params"]))
        for path, value in flax_leaves(want_params):
            np.testing.assert_allclose(got[path], value, rtol=5e-4, atol=1e-5,
                                       err_msg=f"{label} {path}")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _halo_blocks(dev, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((6144, 256), generator=gen, device=dev).to(dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(2, 2), (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_launches_on_one_card(dev, split, dtype):
    """K8 at P 4 as several launches on separate streams of one card, each
    grid capped at its share: 20 calls, every output equal to ``torch.cat``;
    the launches counted one each (``K8_split`` too)."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    blocks = _halo_blocks(dev, dtype)
    streams = [s for n, s in zip(split, [torch.cuda.Stream(dev) for _ in split])
               for _ in range(n)]
    torch.cuda.synchronize()
    want = torch.cat(blocks, 0)
    before = dict(sa.LAUNCHES)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(20):
        for q, out in enumerate(rg.ring_all_gather(blocks, streams=streams)):
            with torch.cuda.stream(streams[q]):
                bad += (out != want).sum()
    torch.cuda.synchronize()
    assert int(bad) == 0
    assert sa.LAUNCHES["K8"] - before["K8"] == sa.LAUNCHES["K8_split"] - before["K8_split"] \
        == 20 * len(split)


def _late_peer_call(dev, timeout_s):
    """K8 at P 4 as 2 launches on 2 streams, the second stream asleep some
    seconds: returns (blocks, streams per rank, the call's outputs, the
    seconds until the first launch gave up)."""
    import time

    blocks = _halo_blocks(dev, torch.float32)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    per_rank = [streams[0], streams[0], streams[1], streams[1]]
    rg.ring_all_gather(blocks, streams=per_rank)
    rg.settle()
    with torch.cuda.stream(streams[1]):
        torch.cuda._sleep(int(4e9))  # some seconds at the card's clock
    t0 = time.perf_counter()
    outs = rg.ring_all_gather(blocks, streams=per_rank, timeout_s=timeout_s)
    streams[0].synchronize()
    return blocks, per_rank, outs, time.perf_counter() - t0


@pytest.mark.cuda
def test_timeout_raises_and_fresh_flags_work(dev):
    """A launch whose peer enters late (its stream asleep past the bound)
    gives up within the bound, and its call stays pending (its outputs held)
    while the late launch has not ended; the next call on that layout raises
    and retires its flags; the error is raised once; the call after
    succeeds on fresh ones."""
    blocks, per_rank, outs, waited = _late_peer_call(dev, 1.0)
    assert waited < 3.0, waited
    assert any(any(o is t for t in call.tensors) for call in rg._PENDING for o in outs)
    with pytest.raises(RuntimeError, match="retired"):
        rg.ring_all_gather(blocks, streams=per_rank)
    rg.settle()  # already raised: nothing more to say
    assert not rg._PENDING
    outs = rg.ring_all_gather(blocks, streams=per_rank)
    rg.settle()
    assert all(torch.equal(o, torch.cat(blocks, 0)) for o in outs)


@pytest.mark.cuda
def test_settle_raises_for_a_timed_out_call(dev):
    """``settle`` waits for the late launch and raises for the call whose
    peer gave up, releasing what it held; the next call is exact."""
    blocks, per_rank, _, _ = _late_peer_call(dev, 1.0)
    with pytest.raises(RuntimeError, match="outlasted its bound"):
        rg.settle()
    assert not rg._PENDING
    outs = rg.ring_all_gather(blocks, streams=per_rank)
    rg.settle()
    assert all(torch.equal(o, torch.cat(blocks, 0)) for o in outs)


@pytest.mark.cuda
def test_peer_access_of_every_pair(dev):
    """Peer access enabled for every ordered pair of this host's cards (none
    to do with one card); twice is the same as once."""
    cards = list(range(torch.cuda.device_count()))
    rg.enable_peers(cards)
    rg.enable_peers(cards)
    assert {(a, b) for a in cards for b in cards if a != b} <= rg._PEERS
