"""Per-workload training/eval step definitions.

Counterpart of ``hierarchicalgnn_tpu/train/pipelines.py``.  Each pipeline
bundles a model with its loss:

  * ``ECPipeline``         -- weighted BCE on the edge scores (EC-IN)
  * ``EmbeddingPipeline``  -- hinge loss on mined pairs (Embedding-IN,
                              Embedding-HGNN-GMM)
  * ``BipartitePipeline``  -- hinge embedding loss + matched-assignment BCE
                              on the sine schedule (BC-HGNN-GMM, gMRT)

``loss(batch, epoch) -> (loss, metrics)`` runs the model in its own mode:
``model.train()`` makes the forward update the model's buffers.
``loss_from_outputs(out, batch, epoch, matching_spmd=)`` is the loss of
outputs already computed (the sharded training step's reassembled ones);
``matching_spmd``, a number of ranks, row-shards the bipartite matching's
auction over them (``train/matching.py``; the JAX package's ``(mesh,
axis)``).
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.ops.grid_knn import grid_knn_graph
from hierarchicalgnn_torch.ops.intersect import edges_in_set
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    build_sorted_plan, build_transposed_plan, gather_edge_endpoints)
from hierarchicalgnn_torch.ops.knn import knn_graph
from hierarchicalgnn_torch.train import losses
from hierarchicalgnn_torch.train.matching import match_particles_to_candidates


def event_to(event: Event, device) -> Event:
    """Host (numpy) event -> the same event as tensors on ``device``
    (graphs as int64/bool, as the port's ops index with them)."""
    return Event._make(
        graph_to(v, device) if isinstance(v, Graph)
        else torch.as_tensor(v, device=device) for v in event)


class _Pipeline:
    """A model with its loss: ``loss_from_outputs(out, batch, epoch)`` is the
    subclass's part."""

    def __init__(self, model, hparams: dict):
        self.model = model
        self.hparams = hparams

    def loss(self, batch: Event, epoch, stats=None):
        out = self.model(batch.x, batch.graph, batch.node_mask, stats=stats)
        return self.loss_from_outputs(out, batch, epoch, stats=stats)


class ECPipeline(_Pipeline):
    """Edge classification: weighted BCE on the edge scores.

    Truth per ``true_edges`` (reference ``edge_classifier_base.py:113-132``):
    with modulewise truth, neutral edges (PID-true but not modulewise-true)
    are dropped from the loss.
    """

    def loss_from_outputs(self, scores, batch: Event, epoch, stats=None,
                          matching_spmd=None):
        hp = self.hparams
        emask = batch.graph.edge_mask
        if hp["true_edges"] == "modulewise_true_edges":
            keep = emask & (~batch.y_pid | batch.y)
            y = batch.y
        else:
            keep = emask
            y = batch.y_pid
        weights = losses.edge_pt_weights(
            batch.pt, batch.graph.senders, batch.graph.receivers, y, keep, hp)
        loss = losses.weighted_bce(scores, y, weights)
        return loss, {"training_loss": loss}


class EmbeddingPipeline(_Pipeline):
    """Metric-learning embeddings with a hinge loss on mined pairs.

    Sample mining (reference ``embedding_base.py:109-135``): the kNN graph
    in embedding space at radius ``train_r``, intersected with the
    bidirectional signal truth; fake pairs filtered to different PIDs.  The
    hierarchical variant adds a hinge loss on the IN-block embeddings over
    the input edges, mixed on the sine schedule (``:158-209``).
    """

    def __init__(self, model, hparams: dict, hierarchical: bool):
        super().__init__(model, hparams)
        self.hierarchical = hierarchical
        self.knn_exact = None
        if hparams.get("knn_backend", "brute") not in ("brute", "grid"):
            raise ValueError(f"knn_backend {hparams['knn_backend']!r}: "
                             f"expected 'brute' or 'grid'")

    def _training_samples(self, embeddings, batch: Event):
        """(senders, receivers, y, mask) of the mined and the truth pairs.

        ``knn_backend: grid`` mines with the cell-blocked search
        (``ops/grid_knn.py``; ``knn_grid_cells``, by default one cell per 256
        rows and at least 16, and ``knn_grid_probe``, 16) and leaves its
        ``exact`` flag in ``knn_exact`` (None for the brute force), which the
        loss reports as the ``knn_exact`` metric."""
        hp = self.hparams
        self.knn_exact = None
        if hp.get("knn_backend", "brute") == "grid":
            n = embeddings.shape[0]
            ps, pr, pmask, _, self.knn_exact = grid_knn_graph(
                embeddings.detach(), hp["train_r"], hp["knn"], mask=batch.node_mask,
                n_cells=int(hp.get("knn_grid_cells") or max(n // 256, 16)),
                n_probe=int(hp.get("knn_grid_probe", 16)))
        else:
            ps, pr, pmask, _ = knn_graph(
                embeddings.detach(), hp["train_r"], hp["knn"], mask=batch.node_mask,
                block_size=hp.get("knn_block_size", 1024))
        # bidirectional signal-masked truth
        tg = batch.true_graph
        ts = torch.cat([tg.senders, tg.receivers])
        tr = torch.cat([tg.receivers, tg.senders])
        tmask = torch.cat([tg.edge_mask, tg.edge_mask])
        tmask = tmask & batch.signal_mask[ts] & batch.signal_mask[tr]

        s, r = torch.cat([ps, ts]), torch.cat([pr, tr])
        if hp["true_edges"] == "modulewise_true_edges":
            y_pred = edges_in_set(ps, pr, pmask, ts, tr, tmask)
            # fake pairs: not in truth, different PID (or either is noise)
            pid_s, pid_r = batch.pid[ps], batch.pid[pr]
            fake = pmask & ~y_pred & ((pid_s != pid_r) | (pid_s == 0) | (pid_r == 0))
            mask = torch.cat([fake, tmask])
            y = torch.cat([torch.zeros_like(fake), tmask])
        else:  # pid_true_edges (reference :127-134)
            mask = torch.cat([pmask, tmask])
            pid_s, pid_r = batch.pid[s], batch.pid[r]
            y = (pid_s == pid_r) & (pid_s != 0) & (pid_r != 0) & mask
            sig = batch.signal_mask[s] & batch.signal_mask[r]
            # As in the JAX package, a deliberate divergence from the
            # reference, whose ``mask = signal.all(0) | y == 0`` parses as
            # ``(signal | y) == 0`` and keeps only non-signal fake pairs:
            # keep the fakes plus the signal-masked true pairs.
            mask = mask & (sig | ~y)
        return s, r, y & mask, mask

    def _hinge(self, embeddings, s, r, y, mask, batch: Event):
        """Weighted squared hinge loss over the pairs (s, r).

        Under autograd the pairs are receiver-sorted first, so the backward
        of the two row gathers is the K1 kernel over the plan and its
        transposed plan: a hit is an endpoint of some 2 x ``knn`` pairs,
        and autograd's own index backward serialises on such repeats.  The
        loss is a sum over pairs, so their order changes only its rounding.
        """
        hp = self.hparams
        weights = losses.edge_pt_weights(batch.pt, s, r, y, mask, hp)
        if torch.is_grad_enabled() and embeddings.requires_grad:
            n = embeddings.shape[0]
            plan = build_sorted_plan(s, r, mask, n)
            plan_t, r2s = build_transposed_plan(plan, s, r, mask, n)
            e_s, e_r = gather_edge_endpoints(embeddings, plan, plan_t, r2s)
            y, weights = plan.sort(y), plan.sort(weights)
        else:
            e_s, e_r = embeddings[s], embeddings[r]
        dist = losses.endpoint_distances(e_s, e_r)
        return losses.squared_hinge_loss(dist, y, weights, hp["train_r"])

    def loss_from_outputs(self, out, batch: Event, epoch, stats=None,
                          matching_spmd=None):
        hp = self.hparams
        metrics = {}
        if self.hierarchical:
            embeddings, intermediate, aux = out
            g = batch.graph
            y_pid = (batch.pid[g.senders] == batch.pid[g.receivers]) & g.edge_mask
            intermediate_loss = self._hinge(
                intermediate, g.senders, g.receivers, y_pid, g.edge_mask, batch)
            s, r, y, mask = self._training_samples(embeddings, batch)
            emb_loss = self._hinge(embeddings, s, r, y, mask, batch)
            sched = losses.sine_loss_schedule(
                epoch, hp.get("intermediate_epoch", hp.get("emb_epoch", 1)),
                hp.get("loss_schedule"))
            loss = sched * intermediate_loss + (1 - sched) * emb_loss
            metrics.update(embedding_loss=emb_loss,
                           intermediate_loss=intermediate_loss,
                           score_cut=aux["score_cut"], clusters=aux["n_clusters"])
        else:
            s, r, y, mask = self._training_samples(out, batch)
            loss = self._hinge(out, s, r, y, mask, batch)
        if self.knn_exact is not None:
            metrics["knn_exact"] = self.knn_exact.float()
        metrics["training_loss"] = loss
        return loss, metrics


class BipartitePipeline(_Pipeline):
    """Bipartite classification (BC and gMRT): a hinge embedding loss on the
    input edges and a matched-assignment BCE on the bipartite scores, mixed
    on the sine schedule (reference
    ``bipartite_classification_base.py:194-224``)."""

    def loss_from_outputs(self, out, batch: Event, epoch, stats=None,
                          matching_spmd=None):
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

        asgmt_loss = self._bipartite_loss(scores, bgraph, batch, aux, stats,
                                          matching_spmd)

        sched = losses.sine_loss_schedule(
            epoch, hp["emb_epoch"], hp.get("loss_schedule"))
        loss = sched * emb_loss + (1 - sched) * asgmt_loss
        metrics = {"training_loss": loss, "embedding_loss": emb_loss,
                   "assignment_loss": asgmt_loss,
                   "score_cut": aux["score_cut"], "clusters": aux["n_clusters"]}
        return loss, metrics

    def _bipartite_loss(self, scores, bgraph: Graph, batch: Event, aux, stats=None,
                        matching_spmd=None):
        """Assignment BCE against the matching truth (reference :152-191);
        ``matching_spmd`` ranks row-shard the auction."""
        hp = self.hparams
        truth, row_match, col_match, match_valid = match_particles_to_candidates(
            scores.detach(), bgraph.senders, bgraph.receivers, bgraph.edge_mask,
            batch.pid_compact, batch.particle_pid, batch.n_particles,
            aux["n_clusters"], hp["max_clusters"],
            backend=hp.get("matching_backend", "auction"),
            eps_scale=float(hp.get("matching_eps_scale", 1e-3)), stats=stats,
            n_parts=matching_spmd)

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
