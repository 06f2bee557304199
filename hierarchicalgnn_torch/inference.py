"""Serving: raw event -> track candidates.

Counterpart of ``hierarchicalgnn_tpu/inference.py`` for the BC model:
preprocess the raw event, one eval forward on the device, then the
bipartite (hit, track) candidates above the score cut.

    engine = InferenceEngine(hparams, model)          # device="cuda"
    tracks = engine.reconstruct(raw_event)             # [2, M] int32

Loading a trained run (``from_run``) waits for a torch checkpoint format,
which comes with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.evaluation.candidates import bipartite_candidates
from hierarchicalgnn_torch.evaluation.tracking import eval_metrics
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.utils.device import resolve_device


class InferenceEngine:
    """``hparams``: a loaded config; ``model``: a ``BipartiteClassifierHGNN``.
    ``device`` defaults to the card and raises without one."""

    def __init__(self, hparams: dict, model, device: str | torch.device = "cuda"):
        if hparams["model"] != "BC-HGNN-GMM":
            raise ValueError(f"model {hparams['model']!r} is not ported yet")
        self.hparams = hparams
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.last_stats: dict = {}

    @torch.no_grad()
    def forward(self, batch):
        """One eval forward of a preprocessed event.  ``last_stats`` then
        holds the run's host syncs and its cluster count."""
        self.last_stats = {}
        x = torch.as_tensor(batch.x, device=self.device)
        node_mask = torch.as_tensor(batch.node_mask, device=self.device)
        out = self.model(x, graph_to(batch.graph, self.device), node_mask,
                         stats=self.last_stats)
        self.last_stats["n_clusters"] = out[3]["n_clusters"]
        return out

    def reconstruct(self, raw_event: dict, return_metrics: bool = False):
        """Full reconstruction of one raw event.

        Returns the bipartite (hit, track) assignment in the event's
        original hit indices; optionally tracking metrics vs its truth.
        """
        hp = self.hparams
        batch = preprocess_event(raw_event, hp, stage="test")
        bgraph, scores, _, _ = self.forward(batch)
        host = Graph(bgraph.senders.cpu().numpy().astype(np.int32),
                     bgraph.receivers.cpu().numpy().astype(np.int32),
                     bgraph.edge_mask.cpu().numpy())
        bipartite = bipartite_candidates(host, scores.cpu().numpy(), batch, hp)
        if not return_metrics:
            return bipartite
        pid = np.asarray(raw_event["pid"])
        pt = np.asarray(raw_event["pt"]).copy()
        pt[pid == 0] = 0.0
        metrics = eval_metrics(bipartite, pid, pt,
                               primary=raw_event.get("primary"),
                               pt_cut=hp["ptcut"], nhits_cut=hp["n_hits"],
                               majority_cut=hp["majority_cut"])
        return bipartite, metrics
