"""Tensor parallelism: every MLP's ``hidden`` width split over a ``model`` axis.

Counterpart of ``hierarchicalgnn_tpu/parallel/tp.py``.  The sharding rule is
the JAX package's, applied to each parameter's flax-layout shape (an
``nn.Linear`` weight ``[out, in]`` is read as the flax kernel ``[in, out]``;
names and transposition from ``convert.py::param_targets``), so both
packages split the same leaves:

  * kernels ``[in, hidden]``  -> ``(None, "model")`` (column split; it wins
    when both dims are ``hidden``)
  * kernels ``[hidden, out]`` -> ``("model", None)`` (row split)
  * 1-D ``(hidden,)`` vectors (biases, LayerNorm scale and bias) ->
    ``("model",)``
  * everything else, and every buffer and the step count, replicated.

The optimizer moments follow their leaves.  The JAX package leaves the
collectives to XLA's partitioner; here they are written out in the MLPs
(``models/mlp.py``: an all-gather of the column blocks where a layer needs
its whole input, a ``psum`` after a row-split layer with the bias added once,
the LayerNorm moments over a split width by ``psum``) and in the clip's
global norm (a ``psum`` of the split leaves' squared norms; each replicated
leaf counted once).

The ``model`` ranks are threads of one shard group (``parallel/comm.py``)
that share the card, or, with ``make_tp_mesh(..., devices=...)``, each run on
a card of its own: rank r's shards and their moments then live on row 0's
card r, the replicated leaves and the buffers stay on the model's card and
each rank reads copies on its card (``parallel/comm.py::replicate``), and
local event e runs rank r on ``devices[e][r]``.  Each runs the whole model:
the graph work is replicated, as every device does it under XLA, and the
MLPs are split.  A
rank holds its own shard of each split leaf and of that leaf's moments;
a replicated leaf is one tensor, the model's own, which every rank reads
(autograd adds the ranks' contributions to its gradient).  The loss is
computed once, on rank 0's outputs, which the collectives share with every
rank, so one backward reaches every rank's shards; rank 0 hands its outputs
over through ``parallel/comm.py::handoff``, so that the backward adds the
loss's and the ranks' contributions in the same order at every step.  The
``data`` axis runs through ``parallel/step.py::EventMeanStep``: ``data``
events a step, one after another, split over the processes of a
``parallel/mesh.py`` Mesh's ``group`` when ``make_tp_mesh`` is given such a
Mesh for ``data``.

    mesh = make_tp_mesh(data=2, model=4, hidden=hp["hidden"])
    state, step = make_tp_train_step(pipeline, optimizer, mesh,
                                     train_state(model, optimizer), hp["hidden"])
    state, metrics = step(state, [event_a, event_b], epoch)
    full = unshard_state(state)       # the checkpoint layout

A split over one rank is no split: with ``model`` 1 every leaf is held whole
and the step is the unsharded one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from hierarchicalgnn_torch.convert import param_targets
from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.models.buffers import agreed, placed_buffers, staged_writes
from hierarchicalgnn_torch.models.mlp import MLP, MatchDims, TPBinding, tensor_parallel
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.parallel.comm import (
    handoff, place_inputs, replicate, run_sharded, to_device)
from hierarchicalgnn_torch.parallel.mesh import Mesh, device_array, make_mesh
from hierarchicalgnn_torch.parallel.step import EventMeanStep, event_index
from hierarchicalgnn_torch.train.checkpoint import MOMENTS, load_model_state
from hierarchicalgnn_torch.utils.device import resolve_device, resolve_devices

AXIS = "model"


class TPMesh(NamedTuple):
    """The ``{data, model}`` layout: ``mesh``, the ``parallel/mesh.py`` Mesh
    of the ``data`` axis (its events a step over its processes, ``graph``
    1), and ``model`` ranks that split the hidden width, threads of each
    process.  ``devices``: ``[local_events][model]`` ``torch.device``s, or
    None (every rank on the model's card)."""
    mesh: Mesh
    model: int
    devices: tuple | None = None

    @property
    def data(self) -> int:
        return self.mesh.data

    @property
    def group(self):
        return self.mesh.group

    def row(self, event: int):
        """The devices of local event ``event``'s ranks (None: the model's)."""
        return None if self.devices is None else list(self.devices[event])


def make_tp_mesh(data: int | Mesh = 1, model: int = 1, hidden: int | None = None,
                 devices=None) -> TPMesh:
    """The mesh; ``data`` is a count of events run by this process alone or
    a ``parallel/mesh.py`` Mesh of ``graph`` 1 (``make_global_mesh()``)
    whose ``data`` axis spans its processes.  Raises when ``hidden`` (if
    given) does not split evenly over ``model`` (JAX's ``NamedSharding``
    refuses an uneven split too).  ``devices`` as the JAX ``make_tp_mesh``
    takes them: the first ``local_events x model``, reshaped to
    ``[local_events, model]`` (fewer raise in the JAX mesh's words)."""
    mesh = data if isinstance(data, Mesh) else make_mesh(data)
    if model < 1:
        raise ValueError(f"mesh {mesh.data}x{model}: both axes must be at least 1")
    if mesh.graph != 1:
        raise ValueError(f"the TP step splits no graph: mesh graph {mesh.graph}")
    mesh = TPMesh(mesh, int(model), device_array(mesh.local_events, int(model), devices,
                                                 f"mesh {mesh.data}x{model}"))
    if hidden is not None:
        _check_hidden(hidden, mesh)
    return mesh


def _check_hidden(hidden: int, mesh: TPMesh):
    if hidden % mesh.model:
        raise ValueError(f"hidden {hidden} does not split over {mesh.model} model ranks")


def leaf_spec(shape, hidden: int, axis: str = AXIS) -> tuple:
    """The split of a leaf of flax-layout ``shape`` (``_leaf_spec``,
    ``tp.py:46-54`` of the JAX package), as the entries of its
    ``PartitionSpec``."""
    if len(shape) == 2:
        if shape[1] == hidden:
            return (None, axis)  # column split
        if shape[0] == hidden:
            return (axis, None)  # row split
    elif len(shape) == 1 and shape[0] == hidden:
        return (axis,)
    return ()


def _targets(model):
    """name -> (flax-layout shape, transposed) of each of ``model``'s
    parameters."""
    names = {id(p): name for name, p in model.named_parameters()}
    out = {}
    for _, tensor, transpose in param_targets(model):
        shape = tuple(tensor.shape)
        out[names[id(tensor)]] = (shape[::-1] if transpose else shape, transpose)
    missing = set(names.values()) - set(out)
    if missing:
        raise KeyError(f"parameters without a flax name: {sorted(missing)}")
    return out


def tp_shardings(model, mesh: TPMesh, hidden: int) -> dict:
    """The spec (flax layout) of each of ``model``'s parameters, by name."""
    _check_hidden(hidden, mesh)
    return {name: leaf_spec(shape, hidden) for name, (shape, _) in _targets(model).items()}


def state_shardings(state: dict, mesh: TPMesh, hidden: int, model) -> dict:
    """A spec for every entry of the full train state (``Trainer.state_dict``
    / ``train/checkpoint.py::train_state``): each parameter's and its
    moments' by the rule, the buffers, the count and the step replicated."""
    specs = tp_shardings(model, mesh, hidden)
    out = {"params": dict(specs), "buffers": {name: () for name in state["buffers"]},
           "opt_state": {"count": (), **{key: dict(specs) for key in MOMENTS}},
           "step": ()}
    return out


def split_dims(model, mesh: TPMesh, hidden: int) -> dict:
    """name -> the torch dim each split parameter is cut along over the
    ``model`` ranks (none with ``model`` 1).  Raises if a split leaf lies
    outside an ``MLP`` or ``MatchDims``, the only modules with a TP path."""
    if mesh.model == 1:
        _check_hidden(hidden, mesh)
        return {}
    targets = _targets(model)
    covered = {id(p) for m in model.modules() if isinstance(m, (MLP, MatchDims))
               for p in m.parameters()}
    dims = {}
    for name, spec in tp_shardings(model, mesh, hidden).items():
        if AXIS not in spec:
            continue
        if id(model.get_parameter(name)) not in covered:
            raise NotImplementedError(f"{name} is split but outside every MLP")
        dim = spec.index(AXIS)
        dims[name] = 1 - dim if targets[name][1] else dim
    return dims


def _shard(full, dim, rank, n_ranks, device, grad=False):
    """Rank ``rank``'s block of ``full`` along ``dim``, in storage of its own."""
    block = full.shape[dim] // n_ranks
    part = torch.clone(full.narrow(dim, rank * block, block).to(device),
                       memory_format=torch.contiguous_format)
    return part.requires_grad_(grad)


@dataclasses.dataclass
class TPState:
    """The train state laid out over the ``model`` ranks.  ``params[r]`` and
    ``opt_state[key][r]`` map each parameter name to what rank ``r`` holds:
    its own shard of a split leaf (``split`` names the torch dim), or the
    replicated tensor, one for all ranks (a parameter: the model's own).
    ``buffers`` are the model's own (replicated)."""
    names: list
    split: dict
    params: list
    buffers: dict
    opt_state: dict
    step: int

    @property
    def n_ranks(self) -> int:
        return len(self.params)

    def _entries(self, per_rank):
        """Rank 0's entries for every name, then each further rank's split
        ones: every tensor once."""
        return [per_rank[0][n] for n in self.names] + [
            per_rank[r][n] for r in range(1, self.n_ranks) for n in self.names
            if n in self.split]

    def leaves(self) -> list:
        """Every tensor the step differentiates and updates, once."""
        return self._entries(self.params)

    def slots(self) -> list:
        """The moments of :meth:`leaves`, one dict each."""
        moments = {key: self._entries(self.opt_state[key]) for key in MOMENTS}
        return [dict(zip(MOMENTS, m)) for m in zip(*(moments[k] for k in MOMENTS))]

    def binding(self, model, comm, replicas, device=None) -> TPBinding:
        """What rank ``comm.index`` reads for each of ``model``'s parameters:
        its shard of a split leaf (a copy on ``device`` where it runs on
        another card than the shard's), its view of a replicated one
        (``replicas``, name -> one view per rank,
        ``parallel/comm.py::replicate``)."""
        own = self.params[comm.index]

        def shard(name):
            return own[name] if device is None else own[name].to(device)

        return TPBinding(comm, {
            id(p): (shard(name), self.split[name]) if name in self.split
            else (replicas[name][comm.index], None) for name, p in model.named_parameters()})

    def grad_norm(self, grads, stats=None):
        """The global norm of ``grads`` (aligned with :meth:`leaves`; None
        counts as zero): each split leaf's squared norms summed over the
        ranks by a ``psum`` in rank order (each rank's on its shards' card),
        each replicated leaf counted once, on the first leaf's device.  The
        psum is added to ``stats["collectives"]``."""
        leaves = self.leaves()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        n = len(self.names)
        norms = list(torch._foreach_norm(grads[:n]))
        if self.split:
            at = [i for i, name in enumerate(self.names) if name in self.split]
            per_rank = [torch.stack([norms[i] for i in at])] + [
                torch.stack(torch._foreach_norm(grads[n + (r - 1) * len(at):n + r * len(at)]))
                for r in range(1, self.n_ranks)]
            squares = [v.square() for v in per_rank]
            total, group = run_sharded(lambda comm: comm.psum(squares[comm.index]),
                                       self.n_ranks, device=leaves[0].device,
                                       devices=[v.device for v in squares])
            if stats is not None:
                _add_counts(stats, group.collectives)
            for i, norm in zip(at, total[0].sqrt().unbind(0)):
                norms[i] = norm
        home = leaves[0].device
        return torch.linalg.vector_norm(torch.stack([v.to(home) for v in norms]))


def _add_counts(stats, collectives):
    total = stats.setdefault("collectives", {})
    for kind, n in collectives.items():
        total[kind] = total.get(kind, 0) + n


def shard_state(state: dict, mesh: TPMesh, hidden: int, model) -> TPState:
    """Lay the full train state out over ``mesh.model`` ranks on the model's
    device (rank r's split leaves on ``mesh.devices[0][r]`` where the mesh
    has devices).  The model's own parameters and buffers take the state's
    values (they are the replicated leaves and the buffers); each rank gets
    a shard of its own of every split leaf and of its moments."""
    dims = split_dims(model, mesh, hidden)
    load_model_state(model, state)
    named = dict(model.named_parameters())
    home = next(iter(named.values())).device
    n_ranks = mesh.model
    cards = mesh.row(0) or [home] * n_ranks
    params = [{} for _ in range(n_ranks)]
    moments = {key: [{} for _ in range(n_ranks)] for key in MOMENTS}
    for name, param in named.items():
        dim = dims.get(name)
        for key in MOMENTS:
            full = state["opt_state"][key][name]
            whole = None if dim is not None else full.to(home).clone()
            for r in range(n_ranks):
                moments[key][r][name] = whole if whole is not None else _shard(
                    full, dim, r, n_ranks, cards[r])
        for r in range(n_ranks):
            params[r][name] = param if dim is None else _shard(
                state["params"][name], dim, r, n_ranks, cards[r], grad=True)
    return TPState(names=list(named), split=dims, params=params,
                   buffers=dict(model.named_buffers()),
                   opt_state={"count": int(state["opt_state"]["count"]), **moments},
                   step=int(state["step"]))


def unshard_state(tp_state: TPState) -> dict:
    """The inverse of :func:`shard_state`: the full train state (copies on
    the CPU), for a test or a checkpoint."""
    def whole(per_rank, name):
        if name in tp_state.split:
            return torch.cat([rank[name].detach().cpu() for rank in per_rank],
                             tp_state.split[name])
        return per_rank[0][name].detach().cpu().clone()

    return {"params": {n: whole(tp_state.params, n) for n in tp_state.names},
            "buffers": {n: b.detach().cpu().clone() for n, b in tp_state.buffers.items()},
            "opt_state": {"count": tp_state.opt_state["count"],
                          **{key: {n: whole(tp_state.opt_state[key], n)
                                   for n in tp_state.names} for key in MOMENTS}},
            "step": tp_state.step}


def batch_shardings(batch, mesh: TPMesh):
    """The events over the ``data`` axis: a ``("data",)`` spec for every
    array of ``batch`` (an Event, stacked or not)."""
    def specs(value):
        if isinstance(value, (Event, Graph)):
            return type(value)._make(specs(v) for v in value)
        return ("data",)

    return specs(batch)


class TPTrainStep:
    """``step(state, batch, epoch) -> (state, metrics)``: one optimizer step
    over ``mesh.data`` events, each through the forward over ``mesh.model``
    ranks.  ``state`` (a :class:`TPState`) is updated in place and returned.
    ``last_stats`` holds the step's host syncs (over all ranks) and its
    collectives by kind."""

    def __init__(self, pipeline, optimizer, mesh: TPMesh, device):
        self.pipeline, self.optimizer, self.mesh = pipeline, optimizer, mesh
        self.device = device
        self.state: TPState | None = None
        self.mean_step = EventMeanStep(
            pipeline, optimizer, self.forward, mesh.data,
            params=lambda: self.state.leaves(),
            grad_norm=lambda grads, stats: self.state.grad_norm(grads, stats),
            group=mesh.group)
        self.last_stats: dict = {}

    def forward(self, event: Event, stats):
        """The training forward of one event over the ``model`` ranks (on the
        row of devices of the step's event in flight): rank 0's outputs and
        the ranks' agreed buffer writes, on the model's device."""
        model, state = self.pipeline.model, self.state
        rank_stats = [{} for _ in range(state.n_ranks)]
        devices = self.mesh.row(event_index())
        devices = None if devices is None else resolve_devices(devices)
        cards = devices or [None] * state.n_ranks
        # each rank reads a view of its own of a replicated leaf, so that the
        # backward adds the ranks' contributions to it in rank order
        replicas = {name: replicate(state.params[0][name], state.n_ranks, devices)
                    for name in state.names if name not in state.split}
        inputs_of, buffers_of = place_inputs((event.x, event.graph, event.node_mask), devices,
                                             model.buffers())

        def per_rank(comm):
            r = comm.index
            x, graph, node_mask = inputs_of(r)
            with staged_writes() as staged, placed_buffers(buffers_of(r)), tensor_parallel(
                    state.binding(model, comm, replicas, cards[r])):
                out = model(x, graph, node_mask, stats=rank_stats[r])
            return handoff(out) if r == 0 else out, staged

        ranks, group = run_sharded(per_rank, state.n_ranks, device=self.device, devices=devices)
        syncs = stats.get("host_syncs", 0) + sum(s.get("host_syncs", 0) for s in rank_stats)
        out, first = to_device(ranks[0][0], self.device), to_device(rank_stats[0], self.device)
        stats.update(first, host_syncs=syncs)
        _add_counts(stats, group.collectives)
        return out, agreed([staged for _, staged in ranks])

    def __call__(self, state: TPState, batch, epoch):
        self.state = state
        try:
            grads, metrics = self.mean_step.forward_backward(batch, epoch)
        finally:
            self.state = None
        leaves = state.leaves()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        slots = state.slots()
        # elementwise: one update per device, each with the norm on that device
        for device in dict.fromkeys(p.device for p in leaves):
            at = [i for i, p in enumerate(leaves) if p.device == device]
            self.optimizer.update([leaves[i] for i in at], [grads[i] for i in at],
                                  [slots[i] for i in at], state.opt_state["count"],
                                  metrics["grad_norm"].to(device))
        state.opt_state["count"] += 1
        state.step += 1
        self.last_stats = self.mean_step.last_stats
        return state, metrics


def make_tp_train_step(pipeline, optimizer, mesh: TPMesh, state, hidden: int,
                       device: str | torch.device = "cuda"):
    """Returns ``(sharded_state, step)`` (``tp.py:90`` of the JAX package):
    ``state``, the full train state (``train/checkpoint.py::train_state``),
    laid out over the mesh (a :class:`TPState` already laid out, such as
    ``convert.load_jax_tp_state`` gives, is taken as it is), and
    ``step(state, batch, epoch) -> (state, metrics)``, whose ``batch`` is one
    Event when this process runs one event, else a list or a stack of its
    events (all ``mesh.data`` of them without a process group).
    ``optimizer`` (an ``AmsgradW``) gives the update's constants and
    schedule; the count is the state's.  ``device`` defaults to the card and
    raises without one."""
    device = resolve_devices([resolve_device(device)])[0]
    pipeline.model.to(device)
    if isinstance(state, TPState):
        if state.n_ranks != mesh.model:
            raise ValueError(f"the state is laid out over {state.n_ranks} ranks, the mesh "
                             f"has {mesh.model}")
        sharded = state
    else:
        sharded = shard_state(state, mesh, hidden, pipeline.model)
    return sharded, TPTrainStep(pipeline, optimizer, mesh, device)
