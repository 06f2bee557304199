"""The two models the benchmark runs: Embedding-IN and BC-HGNN-GMM.

Each is a module over (x, undirected Graph, node_mask), on one device, with
no sharding: ``EmbeddingIN`` returns the unit f32 hit embeddings,
``BipartiteClassifierHGNN`` returns (bipartite graph, f32 scores, IN-block
embeddings, clustering aux).  ``model.train()`` fits the pooling GMM every
forward and moves the buffers (``score_cut``, ``knn_radius``, batch-norm
statistics) in place.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.hgnn.ops.graph import Graph, bidirectionalize
from portbench.reference.hgnn.models.blocks import (
    HierarchicalGNNBlock, InteractionGNNBlock, sorted_graph_mode)
from portbench.reference.hgnn.models.dynamic_graph import DynamicGraphConstruction
from portbench.reference.hgnn.models.mlp import MLP, MaskedBatchNorm, MatchDims
from portbench.reference.hgnn.utils.config import ArchConfig


def _score_head(cfg: ArchConfig, remat):
    """The f32-output score MLP over a pair of latent rows."""
    return MLP(2 * cfg.latent, cfg.hidden, 1, cfg.output_layers,
               hidden_activation=cfg.hidden_output_activation,
               output_activation=None, layer_norm=cfg.layernorm,
               compute_dtype=cfg.compute_dtype, remat=remat)


class _Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg

    def reset_parameters(self, generator: torch.Generator):
        """Seeded kaiming init of every MLP, buffers to their defaults."""
        for module in self.modules():
            if isinstance(module, (MLP, MatchDims)):
                module.reset_parameters(generator)
            elif isinstance(module, MaskedBatchNorm):
                with torch.no_grad():
                    module.scale.fill_(1.0)
                    module.bias.zero_()
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
            elif isinstance(module, DynamicGraphConstruction):
                with torch.no_grad():
                    module.knn_radius.fill_(1.0)
            elif isinstance(module, HierarchicalGNNBlock):
                with torch.no_grad():
                    module.score_cut.fill_(float("inf"))

    def _work_graph(self, x, graph: Graph, node_mask):
        if node_mask is None:
            node_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        return (node_mask,) + sorted_graph_mode(
            bidirectionalize(graph), x.shape[0], transposed=self.training)


class EmbeddingIN(_Model):
    """Flat metric-learning embedding model (Embedding-IN)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters)

    def forward(self, x, graph: Graph, node_mask=None, stats=None):
        """Returns the unit-norm f32 embeddings [N, emb_dim]."""
        _, work, agg, gather, _ = self._work_graph(x, graph, node_mask)
        return self.ignn(x, work, agg, gather)[0]


class BipartiteClassifierHGNN(_Model):
    """Hierarchical bipartite hit<->supernode classifier (BC-HGNN-GMM)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters)
        self.hgnn = HierarchicalGNNBlock(cfg)
        self.bipartite_output_layer = _score_head(cfg, remat=cfg.remat)

    def forward(self, x, graph: Graph, node_mask=None, stats=None):
        """Returns (bgraph, scores, embeddings, aux): the receiver-sorted
        bipartite graph, its f32 edge scores (0 on padded slots), the IN
        block's embeddings and the clustering aux."""
        node_mask, work, agg, gather, plan = self._work_graph(x, graph, node_mask)
        embeddings, nodes, edges = self.ignn(x, work, agg, gather)
        nodes, supernodes, (bgraph, _), aux, head_gather = self.hgnn(
            embeddings, nodes, edges, work, node_mask, agg, plan, stats,
            gather=gather, training=self.training)
        logits = self.bipartite_output_layer(torch.cat(
            head_gather(nodes, supernodes), -1))[:, 0]
        scores = torch.where(bgraph.edge_mask, torch.sigmoid(logits.float()), 0.0)
        return bgraph, scores, embeddings, aux


def build(cls, hparams: dict, seed: int = 0):
    """A ``cls`` model of ``hparams``, seeded, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        model = cls(ArchConfig.from_hparams(hparams))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
