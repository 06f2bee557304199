"""Serving: raw event -> track candidates.

Counterpart of ``hierarchicalgnn_tpu/inference.py``: preprocess the raw
event, one eval forward on the device, then the (hit, track) candidates of
the model's own candidate function (``evaluation/candidates.py``).

    hparams, model, _ = model_selector("BC-HGNN-GMM")
    engine = InferenceEngine(hparams, model)           # device="cuda"
    tracks = engine.reconstruct(raw_event)             # [2, M]

    engine = InferenceEngine.from_run("runs/bc")       # a trained run's "best"
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.evaluation.tracking import eval_metrics
from hierarchicalgnn_torch.ops.graph import graph_to
from hierarchicalgnn_torch.train import checkpoint as ckpt_lib
from hierarchicalgnn_torch.utils.device import resolve_device


class InferenceEngine:
    """``hparams``, ``model``: as ``model_selector`` returns them.
    ``device`` defaults to the card and raises without one."""

    def __init__(self, hparams: dict, model, device: str | torch.device = "cuda"):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.last_stats: dict = {}

    @staticmethod
    def from_run(run_dir: str, checkpoint: str = "best", device: str | torch.device = "cuda",
                 sweep_configs: dict | None = None) -> "InferenceEngine":
        """Serve a trained run: its ``hparams.json`` (with ``sweep_configs``
        over it) builds the model through ``model_selector``, and the
        checkpoint's parameters and buffers are loaded into it."""
        from hierarchicalgnn_torch.models.registry import model_selector

        saved = ckpt_lib.load_hparams(run_dir)
        hparams, model, _ = model_selector(saved["model"], {**saved, **(sweep_configs or {})})
        ckpt_lib.load_model_state(model, ckpt_lib.restore_checkpoint(run_dir, checkpoint))
        return InferenceEngine(hparams, model, device=device)

    @torch.no_grad()
    def forward(self, batch):
        """One eval forward of a preprocessed event; returns the model's
        output.  ``last_stats`` then holds the run's host syncs and, for a
        hierarchical model, its cluster count."""
        self.last_stats = {}
        x = torch.as_tensor(batch.x, device=self.device)
        node_mask = torch.as_tensor(batch.node_mask, device=self.device)
        out = self.model(x, graph_to(batch.graph, self.device), node_mask,
                         stats=self.last_stats)
        if isinstance(out, tuple):  # the hierarchical models end in their aux
            self.last_stats["n_clusters"] = out[-1]["n_clusters"]
        return out

    def reconstruct(self, raw_event: dict, return_metrics: bool = False):
        """Full reconstruction of one raw event.

        Returns the (hit, track) assignment in the event's original hit
        indices; optionally tracking metrics vs its truth.
        """
        hp = self.hparams
        batch = preprocess_event(raw_event, hp, stage="test")
        bipartite = self.model.candidates(self.forward(batch), batch, hp,
                                          stats=self.last_stats)
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
