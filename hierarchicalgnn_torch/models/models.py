"""The flagship model: the hierarchical bipartite classifier, BC-HGNN-GMM.

Counterpart of ``hierarchicalgnn_tpu/models/models.py::BipartiteClassifierHGNN``
(reference ``Modules/BipartiteClassification/Models/HGNN_GMM.py:300-346``),
single device (``spmd is None``).  ``model.train()`` / ``model.eval()``
select the mode: training fits the pooling GMM every forward, updates the
buffers (``score_cut``, ``knn_radius``, batch-norm statistics) in place and
builds the transposed plans whose K1 backward the endpoint gathers use.
The other four models and the graph-partitioned branches come in later
slices.
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.ops.graph import Graph, bidirectionalize
from hierarchicalgnn_torch.models.blocks import (
    HierarchicalGNNBlock, InteractionGNNBlock, sorted_graph_mode)
from hierarchicalgnn_torch.models.mlp import MLP, MaskedBatchNorm
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
            compute_dtype=cfg.compute_dtype, remat=cfg.remat)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded kaiming init of every MLP (``models/mlp.py``); batch-norm
        affine parameters and every buffer return to their defaults."""
        for module in self.modules():
            if isinstance(module, MLP):
                module.reset_parameters(generator)
            elif isinstance(module, MaskedBatchNorm):
                with torch.no_grad():
                    module.scale.fill_(1.0)
                    module.bias.zero_()
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
        with torch.no_grad():
            self.hgnn.score_cut.fill_(float("inf"))
            self.hgnn.super_graph_construction.knn_radius.fill_(1.0)
            self.hgnn.bipartite_graph_construction.knn_radius.fill_(1.0)

    def forward(self, x, graph: Graph, node_mask=None, stats=None):
        """Forward over one padded event, in the module's mode.

        Returns (bgraph, scores, embeddings, aux) like the JAX model: the
        receiver-sorted bipartite graph, its f32 edge scores (0 on padded
        slots), the IN-block embeddings and the clustering aux.  ``stats``:
        optional dict that collects ``host_syncs``.
        """
        training = self.training
        if node_mask is None:
            node_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        work, agg, gather, plan = sorted_graph_mode(
            bidirectionalize(graph), x.shape[0], transposed=training)
        embeddings, nodes, edges = self.ignn(x, work, agg, gather)
        nodes, supernodes, (bgraph, _), aux, head_gather = self.hgnn(
            embeddings, nodes, edges, work, node_mask, agg, plan, stats,
            gather=gather, training=training)
        logits = self.bipartite_output_layer(torch.cat(
            head_gather(nodes, supernodes), -1))[:, 0]
        scores = torch.where(bgraph.edge_mask, torch.sigmoid(logits.float()), 0.0)
        return bgraph, scores, embeddings, aux


def build_model(hparams: dict, seed: int = 0) -> BipartiteClassifierHGNN:
    """BC model of a config with seeded random weights (on the CPU)."""
    model = BipartiteClassifierHGNN(ArchConfig.from_hparams(hparams))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
