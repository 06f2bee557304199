"""Training steps over several events: event data parallelism.

Counterpart of ``hierarchicalgnn_tpu/parallel/step.py`` and of the ``data >
1`` branch of ``make_sharded_train_step`` (``graph_shard.py:632-658``).  One
optimizer step takes B events (the mesh's ``data`` size): the loss of each
event, the gradient of their mean, and the mean over the events of the
metrics and of the buffers each event's training forward moved ("the
standard DP treatment of running statistics").  Every event's forward reads
the buffers as they were before the step: its writes are staged
(``models/buffers.py``) and the means applied once at the end.

The events run one after another, each with its backward before the next
forward, so the step holds one event's activations at a time.  Each
backward runs on the caller's thread: autograd otherwise runs each card's
nodes on a thread of that card and adds a tensor's gradient terms in the
order they arrive from those threads, which varies from run to run once
the ranks' graphs span several cards; on one thread the order follows the
graph alone, the same on one card and on several.  The gradient
of the mean loss is the sum of each event's gradient of ``loss / B``, added
in event order on the parameters' device.  Local event e runs on row e of
the mesh's devices where it has them: the forward reads e from
:func:`event_index`.  :class:`EventMeanStep` is shared with the graph-partitioned
step (``parallel/graph_shard.py``), which hands it the sharded forward, and
with the tensor-parallel step (``parallel/tp.py``), which hands it the
forward over the ``model`` ranks, the ranks' shards as the tensors to
differentiate and the global norm over the ranks.

Over the processes of a ``torch.distributed`` group (a ``parallel/mesh.py``
Mesh with a group) each process runs its own ``B / world_size`` of the
events, each with the gradient of ``loss / B``.  After its backward it sends
its summed gradients, its events' metrics and their staged buffer writes in
ONE all-gather (``parallel/distributed.py::gather_from_processes``); every
process then adds the processes' gradients left to right in process order,
as the one-process step adds its events', and takes the mean of the metrics
and of the buffers over all B events in global order.  So every process
applies the same update, and with one event per process the step is the
one-process step bit for bit.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.models.buffers import apply_mean, staged_writes
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.parallel.distributed import GlobalBatch, gather_from_processes
from hierarchicalgnn_torch.parallel.mesh import as_mesh
from hierarchicalgnn_torch.train.optim import apply_gradients, global_norm


_EVENT = threading.local()


def event_index() -> int:
    """The place, among this process's events of the step in flight, of the
    event whose forward the calling thread runs (0 outside a step)."""
    return getattr(_EVENT, "index", 0)


@contextlib.contextmanager
def _local_event(index: int):
    _EVENT.index = index
    try:
        yield
    finally:
        _EVENT.index = 0


def stack_events(events) -> Event:
    """A list of B Events -> one Event whose arrays carry a leading [B] dim
    (graphs field by field)."""
    def stack(values):
        if isinstance(values[0], Graph):
            return Graph(*(stack(list(field)) for field in zip(*values)))
        return torch.stack([torch.as_tensor(v) for v in values])

    return Event._make(stack(list(field)) for field in zip(*events))


def unstack_events(batch: Event) -> list[Event]:
    """The inverse of :func:`stack_events`."""
    def pick(value, b):
        return Graph(*(f[b] for f in value)) if isinstance(value, Graph) else value[b]

    return [Event._make(pick(v, b) for v in batch) for b in range(batch.x.shape[0])]


def events_of(batch) -> list[Event]:
    """One Event, a list of Events, a stacked batch or this process's part of
    a global batch (``parallel/distributed.py::globalize_batch``) -> a list of
    Events."""
    if isinstance(batch, GlobalBatch):
        batch = batch.events
    if isinstance(batch, Event):
        return [batch] if batch.x.ndim == 2 else unstack_events(batch)
    return list(batch)


def _metric_values(metrics, keys, device):
    """One event's metrics ``keys`` as an f32 vector (the value each mean
    takes, the same in and across processes)."""
    return torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device)
                        .detach().reshape(()) for k in keys])


def _mean_metrics(per_event, device):
    keys = list(per_event[0])
    values = torch.stack([_metric_values(m, keys, device) for m in per_event])
    return {k: v.contiguous().mean() for k, v in zip(keys, values.unbind(1))}


class EventMeanStep:
    """``step(batch, epoch) -> metrics``: one optimizer step over the
    ``n_events`` events of ``batch``.  ``forward(event, stats) -> (out,
    staged)`` is the training forward of one event (its outputs in the
    unsharded layout and its staged buffer writes, on the parameters'
    device; :func:`event_index` is the event's place among this process's);
    the loss is
    ``pipeline.loss_from_outputs(out, event, epoch, matching_spmd=...)``.

    :meth:`forward_backward` gives (grads, metrics) and applies the
    buffers; ``__call__`` also applies the gradients through ``optimizer``
    (clip, AdamW-amsgrad), as ``Trainer.train_step`` does.  ``last_stats``
    holds the step's ``host_syncs`` and what the forward adds.

    ``params()`` gives the tensors to differentiate (by default the model's
    parameters) and ``grad_norm(grads, stats)`` the ``grad_norm`` metric from
    their gradients (by default the global norm of those the loss reaches).

    With a process ``group`` the ``n_events`` are the step's events over all
    its processes, and ``batch`` holds this process's share of them (see the
    module's docstring); ``last_stats`` then also counts the all-gather
    (``process_gathers``, ``process_gather_bytes``, ``process_gather_ms``).
    """

    def __init__(self, pipeline, optimizer, forward, n_events: int = 1,
                 matching_spmd=None, params=None, grad_norm=None, group=None):
        self.pipeline = pipeline
        self.optimizer = optimizer
        self.forward = forward
        self.n_events = n_events
        self.group = group
        self.world_size = 1 if group is None else dist.get_world_size(group)
        if n_events % self.world_size:
            raise ValueError(f"{n_events} events do not split over {self.world_size} processes")
        self.n_local = n_events // self.world_size
        self.matching_spmd = matching_spmd
        self.params = params or (lambda: list(pipeline.model.parameters()))
        self.grad_norm = grad_norm or (
            lambda grads, stats: global_norm([g for g in grads if g is not None]))
        self.last_stats: dict = {}

    def forward_backward(self, batch, epoch):
        if isinstance(batch, GlobalBatch) and batch.count != self.n_events:
            raise ValueError(f"the batch was globalized for {batch.count} events, the step "
                             f"takes {self.n_events}")
        events = events_of(batch)
        if len(events) != self.n_local:
            over = "" if self.group is None else (
                f" on each of {self.world_size} processes ({self.n_events} in all)")
            raise ValueError(f"the step takes {self.n_local} events{over}, got {len(events)}")
        self.pipeline.model.train()
        params = self.params()
        stats: dict = {}
        grads, metrics, stages = None, [], []
        for index, event in enumerate(events):
            with _local_event(index):
                out, staged = self.forward(event, stats)
            loss, event_metrics = self.pipeline.loss_from_outputs(
                out, event, epoch, stats=stats, matching_spmd=self.matching_spmd)
            # on this thread, not on autograd's thread per card: one thread
            # meets the ranks' nodes in one order, so a tensor's gradient
            # terms are added in the same order on one card and on several
            with torch.autograd.set_multithreading_enabled(False):
                event_grads = torch.autograd.grad(loss / self.n_events, params,
                                                  allow_unused=True)
            grads = event_grads if grads is None else [
                b if a is None else a if b is None else a + b
                for a, b in zip(grads, event_grads)]
            metrics.append(event_metrics)
            stages.append(staged)
        if self.group is not None:
            grads, metrics, stages = self._across_processes(params, grads, metrics, stages,
                                                            stats)
        apply_mean(stages)
        metrics = _mean_metrics(metrics, params[0].device)
        metrics["grad_norm"] = self.grad_norm(grads, stats)
        self.last_stats = stats
        return grads, metrics

    def _across_processes(self, params, grads, metrics, stages, stats):
        """This process's summed gradients, per-event metrics and staged
        buffer writes -> the same three over every process's events, from one
        all-gather: the gradients added in process order (a process's None
        is no term), the metrics and stages of all events in global order."""
        device = params[0].device
        buffers = [b for _, b in self.pipeline.model.named_buffers()]
        keys = list(metrics[0])
        if any(list(m) != keys for m in metrics):
            raise RuntimeError("the events of a step gave different metrics")
        present = torch.tensor([g is not None for g in grads], dtype=torch.uint8, device=device)
        written = torch.tensor([[id(b) in s for b in buffers] for s in stages],
                               dtype=torch.uint8, device=device)
        values = torch.stack([_metric_values(m, keys, device) for m in metrics])
        sent = ([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                + [present, written, values]
                + [s[id(b)][1] if id(b) in s else b for s in stages for b in buffers])
        got = gather_from_processes(sent, self.group, stats)
        n, world = len(grads), self.world_size
        present, written, values = (got[n + i] for i in range(3))
        summed = []
        for i, copies in enumerate(got[:n]):
            total = None
            for p in range(world):
                if present[p][i]:
                    total = copies[p] if total is None else total + copies[p]
            summed.append(total)
        staged, all_metrics, all_stages = got[n + 3:], [], []
        for p in range(world):
            for e in range(self.n_local):
                all_metrics.append(dict(zip(keys, values[p][e].unbind(0))))
                all_stages.append({id(b): (b, staged[e * len(buffers) + j][p])
                                   for j, b in enumerate(buffers) if written[p][e][j]})
        return summed, all_metrics, all_stages

    def __call__(self, batch, epoch) -> dict:
        grads, metrics = self.forward_backward(batch, epoch)
        apply_gradients(self.optimizer, list(self.pipeline.model.parameters()), grads)
        return metrics


def unsharded_forward(model):
    """The training forward of one event on one device, its buffer writes
    staged."""
    def forward(event: Event, stats):
        with staged_writes() as staged:
            out = model(event.x, event.graph, event.node_mask, stats=stats)
        return out, staged

    return forward


def make_dp_train_step(pipeline, optimizer, mesh_shape) -> EventMeanStep:
    """The event-mean step over ``data`` events without a graph partition
    (``step.py:28`` of the JAX package): per-event losses, buffers and
    metrics averaged.  ``mesh_shape`` is a ``parallel/mesh.py`` Mesh (its
    ``data`` axis over its processes) or a ``{"data": B}`` dict for one
    process.  The model must be on its device already."""
    mesh = as_mesh(mesh_shape)
    return EventMeanStep(pipeline, optimizer, unsharded_forward(pipeline.model), mesh.data,
                         group=mesh.group)
