"""Training steps over several events: event data parallelism.

Counterpart of ``hierarchicalgnn_tpu/parallel/step.py`` and of the ``data >
1`` branch of ``make_sharded_train_step`` (``graph_shard.py:632-658``).  One
optimizer step takes B events (the mesh's ``data`` size): the loss of each
event, the gradient of their mean, and the mean over the events of the
metrics and of the buffers each event's training forward moved ("the
standard DP treatment of running statistics").  Every event's forward reads
the buffers as they were before the step: its writes are staged
(``models/buffers.py``) and the means applied once at the end.

The events run one after another on the one device, each with its backward
before the next forward, so the step holds one event's activations at a
time; the gradient of the mean loss is the sum of each event's gradient of
``loss / B``.  :class:`EventMeanStep` is shared with the graph-partitioned
step (``parallel/graph_shard.py``), which hands it the sharded forward.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.models.buffers import apply_mean, staged_writes
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.train.optim import apply_gradients


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
    """One Event, a list of Events or a stacked batch -> a list of Events."""
    if isinstance(batch, Event):
        return [batch] if batch.x.ndim == 2 else unstack_events(batch)
    return list(batch)


def _mean_metrics(per_event, device):
    return {key: torch.stack([torch.as_tensor(m[key], dtype=torch.float32, device=device)
                              .detach().reshape(()) for m in per_event]).mean()
            for key in per_event[0]}


class EventMeanStep:
    """``step(batch, epoch) -> metrics``: one optimizer step over the
    ``n_events`` events of ``batch``.  ``forward(event, stats) -> (out,
    staged)`` is the training forward of one event (its outputs in the
    unsharded layout and its staged buffer writes); the loss is
    ``pipeline.loss_from_outputs(out, event, epoch, matching_spmd=...)``.

    :meth:`forward_backward` gives (grads, metrics) and applies the
    buffers; ``__call__`` also applies the gradients through ``optimizer``
    (clip, AdamW-amsgrad), as ``Trainer.train_step`` does.  ``last_stats``
    holds the step's ``host_syncs`` and what the forward adds.
    """

    def __init__(self, pipeline, optimizer, forward, n_events: int = 1,
                 matching_spmd=None):
        self.pipeline = pipeline
        self.optimizer = optimizer
        self.forward = forward
        self.n_events = n_events
        self.matching_spmd = matching_spmd
        self.last_stats: dict = {}

    def forward_backward(self, batch, epoch):
        events = events_of(batch)
        if len(events) != self.n_events:
            raise ValueError(f"the step takes {self.n_events} events, got {len(events)}")
        model = self.pipeline.model
        model.train()
        params = list(model.parameters())
        stats: dict = {}
        grads, metrics, stages = None, [], []
        for event in events:
            out, staged = self.forward(event, stats)
            loss, event_metrics = self.pipeline.loss_from_outputs(
                out, event, epoch, stats=stats, matching_spmd=self.matching_spmd)
            event_grads = torch.autograd.grad(loss / len(events), params, allow_unused=True)
            grads = event_grads if grads is None else [
                b if a is None else a if b is None else a + b
                for a, b in zip(grads, event_grads)]
            metrics.append(event_metrics)
            stages.append(staged)
        apply_mean(stages)
        metrics = _mean_metrics(metrics, params[0].device)
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([g for g in grads if g is not None])))
        self.last_stats = stats
        return grads, metrics

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


def make_dp_train_step(pipeline, optimizer, mesh_shape: dict) -> EventMeanStep:
    """The event-mean step over ``mesh_shape["data"]`` events without a graph
    partition (``step.py:28`` of the JAX package): per-event losses, buffers
    and metrics averaged.  The model must be on its device already."""
    return EventMeanStep(pipeline, optimizer, unsharded_forward(pipeline.model),
                         int(mesh_shape.get("data", 1) or 1))
