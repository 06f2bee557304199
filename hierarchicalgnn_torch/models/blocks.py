"""Model blocks: the interaction stack and the hierarchical (pooling) stack.

Counterpart of ``hierarchicalgnn_tpu/models/blocks.py`` on its single-device
sorted-native branch (``use_pallas``, ``blocks.py:343-350`` and
``:414-460``), eval mode.  Every graph is receiver-sorted once per forward
(:class:`SortedPlan`) and each aggregation is a kernel: K1 for the flat
edge->node sums, K2 for the weighted bipartite and super-graph
convolutions, K5 for the connected-components hop of the GMM pooling.

f32 islands on the bf16 path: the embedding head, the edge likelihood and
the GMM stay f32, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.ops import gmm as gmm_ops
from hierarchicalgnn_torch.ops.connected import cluster_labels_sorted, count_host_sync
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    build_sorted_plan, sorted_aggregate, sorted_aggregate_weighted)
from hierarchicalgnn_torch.ops.sddmm import cosine_from_endpoints, normalize_unit_f32
from hierarchicalgnn_torch.ops.segment import segment_mean
from hierarchicalgnn_torch.models.cells import HierarchicalGNNCell, InteractionGNNCell
from hierarchicalgnn_torch.models.dynamic_graph import DynamicGraphConstruction
from hierarchicalgnn_torch.models.mlp import MLP
from hierarchicalgnn_torch.utils.config import ArchConfig
from hierarchicalgnn_torch.utils.device import torch_dtype


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(||x||, eps) (torch ``F.normalize`` numerics)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def l1_normalize(x, dim=-1, eps=1e-12):
    n = torch.sum(torch.abs(x), dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def sorted_graph_mode(graph: Graph, num_segments: int):
    """Receiver-sort a graph.  Returns (work_graph, agg, plan): the graph in
    sorted order, its K1 aggregator, and the plan."""
    plan = build_sorted_plan(graph.senders, graph.receivers, graph.edge_mask,
                             num_segments)
    work = Graph(plan.senders_sorted, plan.receivers_sorted, plan.edge_mask_sorted)
    return work, (lambda d: sorted_aggregate(d, plan)), plan


def _mlp(cfg: ArchConfig, input_size, output_size, layers, hidden_act,
         output_act, compute_dtype):
    return MLP(input_size, cfg.hidden, output_size, layers,
               hidden_activation=hidden_act, output_activation=output_act,
               layer_norm=cfg.layernorm, compute_dtype=compute_dtype)


class InteractionGNNBlock(nn.Module):
    """Node/edge encoders + N interaction cells + the f32 embedding head."""

    def __init__(self, cfg: ArchConfig, iterations: int):
        super().__init__()
        self.cfg = cfg
        act = cfg.hidden_activation
        self.node_encoder = _mlp(cfg, cfg.spatial_channels, cfg.latent,
                                 cfg.nb_node_layer, act, act, cfg.compute_dtype)
        self.edge_encoder = _mlp(cfg, 2 * cfg.spatial_channels, cfg.latent,
                                 cfg.nb_edge_layer, act, act, cfg.compute_dtype)
        self.cells = nn.ModuleList(InteractionGNNCell(cfg) for _ in range(iterations))
        # The embedding head computes in f32 on the bf16 path too: bf16-valued
        # embeddings collide once same-track hits converge (blocks.py:140-150).
        self.output_layer = _mlp(cfg, cfg.latent, cfg.emb_dim, cfg.output_layers,
                                 cfg.hidden_output_activation, None,
                                 cfg.emb_head_dtype)

    def forward(self, x, graph: Graph, agg):
        """``graph``: receiver-sorted work graph; ``agg``: its K1 aggregator.
        Returns (embeddings f32, nodes, edges)."""
        nodes = self.node_encoder(x)
        edges = self.edge_encoder(torch.cat([x[graph.senders], x[graph.receivers]], -1))
        dtype = torch_dtype(self.cfg.compute_dtype)
        if dtype is not None:
            nodes, edges = nodes.to(dtype), edges.to(dtype)
        for cell in self.cells:
            nodes, edges = cell(nodes, edges, graph, agg)
        embeddings = l2_normalize(self.output_layer(nodes).float())
        return embeddings, nodes, edges


class HierarchicalGNNBlock(nn.Module):
    """GMM pooling -> dynamic super/bipartite graphs -> N hierarchical cells,
    in its BC form: node features are 1-norm normalized before the
    supernode init aggregation (reference BC ``HGNN_GMM.py:269``).
    """

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        act = cfg.hidden_activation
        # +inf until the first training fit; eval then cuts at the GMM means'
        # midpoint (blocks.py:212-220)
        self.register_buffer("score_cut", torch.full((1,), float("inf")))
        self.supernode_encoder = _mlp(cfg, cfg.latent, cfg.latent - cfg.emb_dim,
                                      cfg.nb_node_layer, act, act, cfg.compute_dtype)
        self.superedge_encoder = _mlp(cfg, 2 * cfg.latent, cfg.latent,
                                      cfg.nb_edge_layer, act, act, cfg.compute_dtype)
        self.super_graph_construction = DynamicGraphConstruction(
            "sigmoid", k=cfg.supergraph_sparsity, sym=True, norm=True,
            knn_block_size=cfg.knn_block_size)
        self.bipartite_graph_construction = DynamicGraphConstruction(
            "exp", k=cfg.bipartitegraph_sparsity, sym=False, norm=True,
            return_logits=True, knn_block_size=cfg.knn_block_size)
        self.cells = nn.ModuleList(HierarchicalGNNCell(cfg)
                                   for _ in range(cfg.n_hierarchical_graph_iters))

    def clustering(self, embeddings, graph: Graph, node_mask, plan, stats=None):
        """GMM edge cut + connected components over the sorted flat graph
        (reference ``HGNN_GMM.py:184-238``), eval mode.  Returns
        (clusters int32[N] with -1 fill, n_clusters as a Python int)."""
        cfg = self.cfg
        unit = normalize_unit_f32(embeddings)
        likelihood = cosine_from_endpoints(unit[graph.senders], unit[graph.receivers],
                                           mask=graph.edge_mask)
        sc = self.score_cut[0]
        count_host_sync(stats)
        if bool(torch.isinf(sc)):
            # eval cuts at the buffer value; solve_cut only feeds the training
            # EMA, so eval fits the GMM for its means alone
            gmm = gmm_ops.fit_gmm2(likelihood, graph.edge_mask, iters=cfg.gmm_iters)
            sc = torch.mean(gmm.means)
        keep = graph.edge_mask & (likelihood >= sc)
        n = embeddings.shape[0]

        def cluster(mask):
            clusters, n_clusters = cluster_labels_sorted(
                plan, mask, n, min_cluster_size=cfg.min_cluster_size,
                node_mask=node_mask, stats=stats)
            count_host_sync(stats)
            return clusters, int(n_clusters)

        clusters, n_clusters = cluster(keep)
        # over-cut fallback: <= 3 clusters -> recluster on the full graph
        if n_clusters <= 3:
            clusters, n_clusters = cluster(graph.edge_mask)
        return clusters, n_clusters

    def forward(self, embeddings, nodes, edges, graph: Graph, node_mask, agg,
                plan, stats=None):
        """``graph``: sorted flat work graph with K1 aggregator ``agg`` and
        plan ``plan``.  Returns (nodes, supernodes, (bgraph, bweights), aux)."""
        cfg = self.cfg
        n = nodes.shape[0]
        clusters, n_clusters = self.clustering(embeddings, graph, node_mask, plan,
                                               stats)
        in_cluster = clusters >= 0
        seg = torch.where(in_cluster, clusters, 0).long()
        means = l2_normalize(segment_mean(embeddings, seg, cfg.max_clusters,
                                          mask=in_cluster))
        cluster_valid = torch.arange(cfg.max_clusters, device=means.device) < n_clusters
        means = torch.where(cluster_valid[:, None], means, 0.0)

        super_graph, super_weights = self.super_graph_construction(
            means, means, src_mask=cluster_valid, dst_mask=cluster_valid)
        bipartite_graph, bipartite_weights, _ = self.bipartite_graph_construction(
            embeddings, means, src_mask=node_mask, dst_mask=cluster_valid)

        # one receiver-sorted plan per direction, shared by the init and
        # every hierarchical iteration
        s_plan = build_sorted_plan(super_graph.senders, super_graph.receivers,
                                   super_graph.edge_mask, cfg.max_clusters)
        super_graph = Graph(s_plan.senders_sorted, s_plan.receivers_sorted,
                            s_plan.edge_mask_sorted)
        super_weights = s_plan.sort(super_weights)
        b1 = build_sorted_plan(bipartite_graph.senders, bipartite_graph.receivers,
                               bipartite_graph.edge_mask, cfg.max_clusters)
        b2 = build_sorted_plan(bipartite_graph.receivers, bipartite_graph.senders,
                               bipartite_graph.edge_mask, n)
        w1 = b1.sort(bipartite_weights)
        w2 = b2.sort(bipartite_weights)
        bipartite_graph = Graph(b1.senders_sorted, b1.receivers_sorted,
                                b1.edge_mask_sorted)
        aggs = {
            "edge_to_node": agg,
            "bip_to_super": (lambda d: sorted_aggregate_weighted(d, w1, b1),
                             b1.senders_sorted),
            "bip_to_node": (lambda d: sorted_aggregate_weighted(d, w2, b2),
                            b2.senders_sorted),
            "super_to_super": lambda d: sorted_aggregate_weighted(d, super_weights,
                                                                  s_plan),
        }

        agg_to_super, b_send = aggs["bip_to_super"]
        agg_init = agg_to_super(l1_normalize(nodes)[b_send]).to(nodes.dtype)
        supernodes = torch.cat([means.to(nodes.dtype),
                                self.supernode_encoder(agg_init)], -1)
        superedges = self.superedge_encoder(torch.cat(
            [supernodes[super_graph.senders], supernodes[super_graph.receivers]], -1))

        for cell in self.cells:
            nodes, edges, supernodes, superedges = cell(
                nodes, edges, supernodes, superedges, graph, super_graph, aggs)

        aux = {"clusters": clusters, "n_clusters": n_clusters,
               "cluster_valid": cluster_valid, "score_cut": self.score_cut[0]}
        return nodes, supernodes, (bipartite_graph, w1), aux
