"""gMRT: BC-HGNN-GMM with single-layer encoders in place of the IN stack.

The published model is ``gMRT`` of clairesonglee/HierarchicalGNN
(``Modules/gMRT/Models/HGNN_GMM.py:276-356``, arXiv:2303.01640): three
``match_dims`` layers (``Modules/utils.py:209-225``), node
``spatial_channels -> latent``, edge ``2 spatial_channels -> latent`` and
output ``latent -> emb_dim``, each ``Linear -> LayerNorm -> activation`` (the
output layer without activation), then BC's hierarchical block and bipartite
score head unchanged.  ``GMRT`` is the reference BC's forward
(``models.BipartiteClassifierHGNN.forward``) with ``GMRTEncoders`` in place
of the IN block.

Where this reference departs from the published model, as the rest of this
package does from BC's:

* the three encoders compute in float32 on any compute dtype; the
  embeddings are the output layer's, l2-normalised, taken from the float32
  nodes before nodes and edges are cast to the compute dtype (the published
  model runs in float32 throughout);
* the GMM pooling, the kNN graphs and the matching are this package's plain
  versions (``ops/gmm.py``, ``ops/knn.py``, ``train/matching.py``), not
  scikit-learn's mixture, ``fsolve``, cuGraph and scipy's matching;
* events are padded to fixed capacities (``n_nodes_max``, ``max_clusters``);
* the published model's phase counters (``pooling_time``,
  ``graph_construct_time``) and its graph-caching flags (``create_dset``,
  ``load_dset``) are left out: they time and cache, and compute nothing;
* the weights are the caller's: the published ``transfer_params``
  (``Modules/gMRT/gmrt_utils.py:28-43``), which copies a trained BC's
  trailing parameters, is broken as written (``path`` and
  ``BC_HierarchicalGNN_GMM`` are undefined in its scope) and is not used.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.hgnn.models.blocks import HierarchicalGNNBlock, l2_normalize
from portbench.reference.hgnn.models.cells import plain_gather
from portbench.reference.hgnn.models.mlp import MatchDims
from portbench.reference.hgnn.models.models import (
    BipartiteClassifierHGNN, _Model, _score_head)
from portbench.reference.hgnn.ops.graph import Graph
from portbench.reference.hgnn.ops.knn import _full_f32_matmul
from portbench.reference.hgnn.utils.config import ArchConfig
from portbench.reference.hgnn.utils.device import FP8, torch_dtype


class GMRTEncoders(nn.Module):
    """The three ``MatchDims`` of gMRT, in float32."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        act = cfg.hidden_activation
        self.node_encoder = MatchDims(cfg.spatial_channels, cfg.latent, act,
                                      cfg.layernorm, cfg.remat)
        self.edge_encoder = MatchDims(2 * cfg.spatial_channels, cfg.latent, act,
                                      cfg.layernorm, cfg.remat)
        self.output_layer = MatchDims(cfg.latent, cfg.emb_dim, None, cfg.layernorm)

    def forward(self, x, graph: Graph, agg=None, gather=None):
        """Returns (embeddings f32, nodes, edges) over the receiver-sorted
        work graph ``graph``.  The encoders aggregate nothing, so ``agg`` and
        ``gather`` (the IN block's arguments) go unused: the edge encoder
        reads the edges' endpoints by direct indexing.  TF32 goes off first,
        as before the kNN's first query: the float32 matmuls stay float32."""
        _full_f32_matmul()
        nodes = self.node_encoder(x)
        edges = self.edge_encoder(torch.cat(plain_gather(graph)(x), -1))
        embeddings = l2_normalize(self.output_layer(nodes).float())
        dtype = torch_dtype(self.cfg.compute_dtype)
        if dtype is FP8:  # the control: float8 matmuls on a bfloat16 stream
            dtype = torch.bfloat16
        if dtype is not None:
            nodes, edges = nodes.to(dtype), edges.to(dtype)
        return embeddings, nodes, edges


class GMRT(_Model):
    """gMRT: (bipartite graph, f32 scores, the encoders' embeddings,
    clustering aux), as BC returns them."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = GMRTEncoders(cfg)
        self.hgnn = HierarchicalGNNBlock(cfg)
        self.bipartite_output_layer = _score_head(cfg, remat=cfg.remat)

    forward = BipartiteClassifierHGNN.forward
