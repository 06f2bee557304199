"""The flagship model: the hierarchical bipartite classifier, BC-HGNN-GMM.

Counterpart of ``hierarchicalgnn_tpu/models/models.py::BipartiteClassifierHGNN``
(reference ``Modules/BipartiteClassification/Models/HGNN_GMM.py:300-346``),
single device (``spmd is None``), eval mode.  The other four models, the
graph-partitioned branches and the training-mode buffer updates come in
later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.ops.graph import Graph, bidirectionalize
from hierarchicalgnn_torch.models.blocks import (
    HierarchicalGNNBlock, InteractionGNNBlock, sorted_graph_mode)
from hierarchicalgnn_torch.models.mlp import MLP
from hierarchicalgnn_torch.utils.config import ArchConfig


class BipartiteClassifierHGNN(nn.Module):
    """Hierarchical bipartite hit<->supernode classifier (BC-HGNN-GMM)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.share_weight:
            raise NotImplementedError("share_weight is not ported yet")
        self.cfg = cfg
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters)
        self.hgnn = HierarchicalGNNBlock(cfg)
        self.bipartite_output_layer = MLP(
            2 * cfg.latent, cfg.hidden, 1, cfg.output_layers,
            hidden_activation=cfg.hidden_output_activation,
            output_activation=None, layer_norm=cfg.layernorm,
            compute_dtype=cfg.compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded kaiming init of every MLP (``models/mlp.py``); batch-norm
        affine parameters and buffers keep their defaults."""
        for module in self.modules():
            if isinstance(module, MLP):
                module.reset_parameters(generator)

    def forward(self, x, graph: Graph, node_mask=None, stats=None):
        """Eval-mode forward over one padded event.

        Returns (bgraph, scores, embeddings, aux) like the JAX model: the
        receiver-sorted bipartite graph, its f32 edge scores (0 on padded
        slots), the IN-block embeddings and the clustering aux.  ``stats``:
        optional dict that collects ``host_syncs``.
        """
        if self.training:
            raise NotImplementedError("training mode is not ported yet; call .eval()")
        if node_mask is None:
            node_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        work, agg, plan = sorted_graph_mode(bidirectionalize(graph), x.shape[0])
        embeddings, nodes, edges = self.ignn(x, work, agg)
        nodes, supernodes, (bgraph, _), aux = self.hgnn(
            embeddings, nodes, edges, work, node_mask, agg, plan, stats)
        logits = self.bipartite_output_layer(torch.cat(
            [nodes[bgraph.senders], supernodes[bgraph.receivers]], -1))[:, 0]
        scores = torch.where(bgraph.edge_mask, torch.sigmoid(logits.float()), 0.0)
        return bgraph, scores, embeddings, aux


def build_model(hparams: dict, seed: int = 0) -> BipartiteClassifierHGNN:
    """BC model of a config with seeded random weights (on the CPU)."""
    model = BipartiteClassifierHGNN(ArchConfig.from_hparams(hparams))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
