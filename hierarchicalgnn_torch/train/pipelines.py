"""The bipartite classification training/eval step definition.

Counterpart of ``hierarchicalgnn_tpu/train/pipelines.py::BipartitePipeline``
(reference ``bipartite_classification_base.py:194-224``): a hinge embedding
loss on the input edges and a matched-assignment BCE on the bipartite
scores, mixed on the sine schedule.  The EC and embedding pipelines serve
the other models and are not ported yet.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.train import losses
from hierarchicalgnn_torch.train.matching import match_particles_to_candidates


def event_to(event: Event, device) -> Event:
    """Host (numpy) event -> the same event as tensors on ``device``
    (graphs as int64/bool, as the port's ops index with them)."""
    return Event._make(
        graph_to(v, device) if isinstance(v, Graph)
        else torch.as_tensor(v, device=device) for v in event)


class BipartitePipeline:
    """``loss(batch, epoch) -> (loss, metrics)`` over the model's mode:
    ``model.train()`` makes the forward update the model's buffers."""

    def __init__(self, model, hparams: dict):
        self.model = model
        self.hparams = hparams

    def loss(self, batch: Event, epoch, stats=None):
        out = self.model(batch.x, batch.graph, batch.node_mask, stats=stats)
        return self.loss_from_outputs(out, batch, epoch, stats=stats)

    def loss_from_outputs(self, out, batch: Event, epoch, stats=None):
        hp = self.hparams
        bgraph, scores, intermediate, aux = out

        # embedding hinge loss on the input edges, PID truth (reference :198-204)
        g = batch.graph
        y_pid = (batch.pid[g.senders] == batch.pid[g.receivers]) & g.edge_mask
        weights = losses.edge_pt_weights(
            batch.pt, g.senders, g.receivers, y_pid, g.edge_mask, hp)
        dist = losses.hinge_distances(intermediate, g.senders, g.receivers)
        emb_loss = losses.squared_hinge_loss(
            dist / hp["train_r"], y_pid, weights, margin=1.0)

        asgmt_loss = self._bipartite_loss(scores, bgraph, batch, aux, stats)

        sched = losses.sine_loss_schedule(
            epoch, hp["emb_epoch"], hp.get("loss_schedule"))
        loss = sched * emb_loss + (1 - sched) * asgmt_loss
        metrics = {"training_loss": loss, "embedding_loss": emb_loss,
                   "assignment_loss": asgmt_loss,
                   "score_cut": aux["score_cut"], "clusters": aux["n_clusters"]}
        return loss, metrics

    def _bipartite_loss(self, scores, bgraph: Graph, batch: Event, aux, stats=None):
        """Assignment BCE against the matching truth (reference :152-191)."""
        hp = self.hparams
        truth, row_match, col_match, match_valid = match_particles_to_candidates(
            scores.detach(), bgraph.senders, bgraph.receivers, bgraph.edge_mask,
            batch.pid_compact, batch.particle_pid, batch.n_particles,
            aux["n_clusters"], hp["max_clusters"],
            backend=hp.get("matching_backend", "auction"),
            eps_scale=float(hp.get("matching_eps_scale", 1e-3)), stats=stats)

        # assignment weight: max(hit weight, matched-particle weight)
        # (reference get_asgmt_weight :123-138)
        c_max = hp["max_clusters"]
        supernode_pt = torch.zeros(c_max + 1, dtype=torch.float32, device=scores.device)
        supernode_pt[torch.where(match_valid, col_match, c_max)] = \
            batch.particle_pt[row_match]
        w = torch.maximum(
            losses.pt_weighting(batch.pt[bgraph.senders], hp),
            losses.pt_weighting(supernode_pt[:c_max][bgraph.receivers], hp))
        w = losses.balance_weights(w, truth, bgraph.edge_mask, hp["log_weight_ratio"])
        return losses.weighted_bce(scores, truth, w)
