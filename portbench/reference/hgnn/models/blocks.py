"""Model blocks: the interaction stack and the hierarchical (pooling) stack.

Every graph is receiver-sorted once per forward (``SortedPlan``) and each
aggregation is a plain segment sum over the plan.  In training the pooling
fits the GMM and updates the ``score_cut`` EMA.  f32 islands on a bf16 path:
both embedding heads, the edge likelihood and the GMM stay f32.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.hgnn.ops import gmm as gmm_ops
from portbench.reference.hgnn.ops.connected import cluster_labels_sorted, count_host_sync
from portbench.reference.hgnn.ops.graph import Graph
from portbench.reference.hgnn.ops.sorted_agg import (
    build_sorted_plan, build_transposed_plan, cross_permutation,
    gather_edge_endpoints, gather_receivers, gather_senders, sorted_aggregate,
    sorted_aggregate_weighted)
from portbench.reference.hgnn.ops.sddmm import cosine_from_endpoints, normalize_unit_f32
from portbench.reference.hgnn.ops.segment import segment_mean, segment_sum
from portbench.reference.hgnn.models.buffers import read_buffer, write_buffer
from portbench.reference.hgnn.models.cells import (
    HierarchicalGNNCell, InteractionGNNCell, plain_gather)
from portbench.reference.hgnn.models.dynamic_graph import DynamicGraphConstruction
from portbench.reference.hgnn.models.mlp import MLP, MatchDims
from portbench.reference.hgnn.utils.config import ArchConfig
from portbench.reference.hgnn.utils.device import FP8, torch_dtype


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(||x||, eps) (torch ``F.normalize`` numerics)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def l1_normalize(x, dim=-1, eps=1e-12):
    n = torch.sum(torch.abs(x), dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def endpoint_gather(plan, graph: Graph, num_segments: int, transposed: bool):
    """``x -> (x[senders], x[receivers])`` over ``plan``."""
    return lambda x: gather_edge_endpoints(x, plan)


def sorted_graph_mode(graph: Graph, num_segments: int, transposed: bool = False):
    """Receiver-sort a graph.  Returns (work_graph, agg, gather, plan): the
    graph in sorted order, its K1 aggregator, its endpoint gather
    (:func:`endpoint_gather`) and the plan."""
    plan = build_sorted_plan(graph.senders, graph.receivers, graph.edge_mask,
                             num_segments)
    work = Graph(plan.senders_sorted, plan.receivers_sorted, plan.edge_mask_sorted)
    gather = endpoint_gather(plan, graph, num_segments, transposed)
    return work, (lambda d: sorted_aggregate(d, plan)), gather, plan


def _mlp(cfg: ArchConfig, input_size, output_size, layers, hidden_act,
         output_act, compute_dtype, remat=False):
    return MLP(input_size, cfg.hidden, output_size, layers,
               hidden_activation=hidden_act, output_activation=output_act,
               layer_norm=cfg.layernorm, compute_dtype=compute_dtype, remat=remat)


def _embedding_head(cfg: ArchConfig):
    """The f32 embedding head.  It computes in f32 on the bf16 path too:
    bf16-valued embeddings collide once same-track hits converge
    (blocks.py:140-150).  Like the JAX package's, it is never recomputed."""
    return _mlp(cfg, cfg.latent, cfg.emb_dim, cfg.output_layers,
                cfg.hidden_output_activation, None, cfg.emb_head_dtype)


def _cells(cell_cls, cfg: ArchConfig, iterations: int):
    """``iterations`` cells, or one cell under ``share_weight``."""
    return nn.ModuleList(cell_cls(cfg)
                         for _ in range(1 if cfg.share_weight else iterations))


def _schedule(cells, iterations: int):
    """The cell of each iteration: the shared one every time, or each once."""
    return [cells[i % len(cells)] for i in range(iterations)]


class InteractionGNNBlock(nn.Module):
    """Node/edge encoders + N interaction cells [+ the f32 embedding head].
    ``emb=False`` (the edge classifier) owns no head and returns (nodes,
    edges)."""

    def __init__(self, cfg: ArchConfig, iterations: int, emb: bool = True):
        super().__init__()
        self.cfg = cfg
        self.iterations = iterations
        act = cfg.hidden_activation
        self.node_encoder = _mlp(cfg, cfg.spatial_channels, cfg.latent,
                                 cfg.nb_node_layer, act, act, cfg.compute_dtype,
                                 cfg.remat)
        self.edge_encoder = _mlp(cfg, 2 * cfg.spatial_channels, cfg.latent,
                                 cfg.nb_edge_layer, act, act, cfg.compute_dtype,
                                 cfg.remat)
        self.cells = _cells(InteractionGNNCell, cfg, iterations)
        self.output_layer = _embedding_head(cfg) if emb else None

    def forward(self, x, graph: Graph, agg, gather=None, encode_gather=None):
        """``graph``: receiver-sorted work graph; ``agg``: its K1 aggregator;
        ``gather``: its endpoint gather; ``encode_gather``: the endpoint
        gather of the edge encoder's input (direct indexing if None; the halo
        gather under graph partitioning, where senders live on other ranks).
        Returns (embeddings f32, nodes, edges), or (nodes, edges) without the
        head."""
        nodes = self.node_encoder(x)
        edges = self.edge_encoder(torch.cat(
            (encode_gather or plain_gather(graph))(x), -1))
        dtype = torch_dtype(self.cfg.compute_dtype)
        if dtype is FP8:  # the control: float8 matmuls on a bfloat16 stream
            dtype = torch.bfloat16
        if dtype is not None:
            nodes, edges = nodes.to(dtype), edges.to(dtype)
        for cell in _schedule(self.cells, self.iterations):
            nodes, edges = cell(nodes, edges, graph, agg, gather)
        if self.output_layer is None:
            return nodes, edges
        embeddings = l2_normalize(self.output_layer(nodes).float())
        return embeddings, nodes, edges


class HierarchicalGNNBlock(nn.Module):
    """GMM pooling -> dynamic super/bipartite graphs -> N hierarchical cells.

    ``l1_norm_supernode_init``: BC and gMRT normalize the node features with
    a 1-norm before the supernode init aggregation (reference BC
    ``HGNN_GMM.py:269``); the embedding model does not.  ``emb_output``: the
    embedding model adds a final f32 embedding head and returns
    (embeddings, aux); BC and gMRT return the nodes, the supernodes and the
    bipartite graph for their score head.
    """

    def __init__(self, cfg: ArchConfig, l1_norm_supernode_init: bool = True,
                 emb_output: bool = False):
        super().__init__()
        self.cfg = cfg
        self.l1_norm_supernode_init = l1_norm_supernode_init
        act = cfg.hidden_activation
        # +inf until the first training fit; eval then cuts at the GMM means'
        # midpoint (blocks.py:212-220)
        self.register_buffer("score_cut", torch.full((1,), float("inf")))
        self.supernode_encoder = _mlp(cfg, cfg.latent, cfg.latent - cfg.emb_dim,
                                      cfg.nb_node_layer, act, act, cfg.compute_dtype,
                                      cfg.remat)
        self.superedge_encoder = _mlp(cfg, 2 * cfg.latent, cfg.latent,
                                      cfg.nb_edge_layer, act, act, cfg.compute_dtype,
                                      cfg.remat)
        self.super_graph_construction = DynamicGraphConstruction(
            "sigmoid", k=cfg.supergraph_sparsity, sym=True, norm=True,
            knn_block_size=cfg.knn_block_size)
        self.bipartite_graph_construction = DynamicGraphConstruction(
            "exp", k=cfg.bipartitegraph_sparsity, sym=False, norm=True,
            return_logits=True, knn_block_size=cfg.knn_block_size)
        self.cells = _cells(HierarchicalGNNCell, cfg, cfg.n_hierarchical_graph_iters)
        self.output_layer = _embedding_head(cfg) if emb_output else None

    @torch.no_grad()
    def clustering(self, embeddings, graph: Graph, node_mask, plan, stats=None,
                   training: bool = False):
        """GMM edge cut + connected components over the sorted flat graph,
        gradient-free.  Training fits the GMM, moves the ``score_cut`` EMA
        (momentum 0.95; its first value is the GMM means' midpoint; a fit
        without a valid cut leaves it) and cuts at the new value; eval cuts
        at the buffer, or at the means' midpoint while it is ``inf``.
        Returns (clusters int32[N] with -1 fill, n_clusters as a Python int)."""
        cfg = self.cfg
        unit = normalize_unit_f32(embeddings.detach())
        x_s, x_r = unit[graph.senders], unit[graph.receivers]
        likelihood = cosine_from_endpoints(x_s, x_r, mask=graph.edge_mask)

        def fit_gmm():
            return gmm_ops.fit_gmm2(likelihood, graph.edge_mask, iters=cfg.gmm_iters)

        sc = read_buffer(self.score_cut)[0]
        if training:
            gmm = fit_gmm()
            sc = torch.where(torch.isinf(sc), torch.mean(gmm.means), sc)
            cut, valid = gmm_ops.solve_cut(gmm, cfg.cluster_granularity)
            sc = torch.where(valid, 0.95 * sc + (1 - 0.95) * cut, sc)
            write_buffer(self.score_cut, sc[None])
        else:
            count_host_sync(stats)
            if bool(torch.isinf(sc)):
                sc = torch.mean(fit_gmm().means)
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
                plan, stats=None, gather=None, training: bool = False):
        """``graph``: sorted flat work graph with aggregator ``agg``, endpoint
        gather ``gather`` and plan ``plan``.  Returns (nodes, supernodes,
        (bgraph, bweights), aux, head_gather)."""
        cfg = self.cfg
        n = nodes.shape[0]
        clusters, n_clusters = self.clustering(embeddings, graph, node_mask, plan,
                                               stats, training)
        in_cluster = clusters >= 0
        seg = torch.where(in_cluster, clusters, 0).long()
        means = segment_mean(embeddings, seg, cfg.max_clusters, mask=in_cluster)
        means = l2_normalize(means)
        cluster_valid = torch.arange(cfg.max_clusters, device=means.device) < n_clusters
        means = torch.where(cluster_valid[:, None], means, 0.0)

        super_graph, super_weights = self.super_graph_construction(
            means, means, training, src_mask=cluster_valid, dst_mask=cluster_valid)
        bipartite_graph, bipartite_weights, _ = self.bipartite_graph_construction(
            embeddings, means, training, src_mask=node_mask, dst_mask=cluster_valid)

        s_plan = build_sorted_plan(super_graph.senders, super_graph.receivers,
                                   super_graph.edge_mask, cfg.max_clusters)
        gather_super = endpoint_gather(s_plan, super_graph, cfg.max_clusters,
                                       transposed=training)
        super_graph = Graph(s_plan.senders_sorted, s_plan.receivers_sorted,
                            s_plan.edge_mask_sorted)
        super_weights = s_plan.sort(super_weights)
        b1 = build_sorted_plan(bipartite_graph.senders, bipartite_graph.receivers,
                               bipartite_graph.edge_mask, cfg.max_clusters)
        b2 = build_sorted_plan(bipartite_graph.receivers, bipartite_graph.senders,
                               bipartite_graph.edge_mask, n)
        w1 = b1.sort(bipartite_weights)
        w2 = b2.sort(bipartite_weights)
        bipartite_graph, bipartite_weights = Graph(
            b1.senders_sorted, b1.receivers_sorted, b1.edge_mask_sorted), w1
        gathers = {
            "graph": gather or plain_gather(graph),
            "super": gather_super,
            "bip_to_super": lambda x: gather_senders(x, b1),
            "bip_to_node": lambda x: gather_senders(x, b2),
        }
        aggs = {
            "edge_to_node": agg,
            "bip_to_super": (lambda d: sorted_aggregate_weighted(d, w1, b1),
                             b1.senders_sorted),
            "bip_to_node": (lambda d: sorted_aggregate_weighted(d, w2, b2),
                            b2.senders_sorted),
            "super_to_super": lambda d: sorted_aggregate_weighted(d, super_weights,
                                                                  s_plan),
        }
        head_gather = lambda x, sn: (gathers["bip_to_super"](x),
                                     gather_receivers(sn, b1))

        agg_to_super, _ = aggs["bip_to_super"]
        init_nodes = l1_normalize(nodes) if self.l1_norm_supernode_init else nodes
        agg_init = agg_to_super(gathers["bip_to_super"](init_nodes)).to(nodes.dtype)
        supernodes = torch.cat([means.to(nodes.dtype),
                                self.supernode_encoder(agg_init)], -1)
        superedges = self.superedge_encoder(torch.cat(gathers["super"](supernodes), -1))

        for cell in _schedule(self.cells, cfg.n_hierarchical_graph_iters):
            nodes, edges, supernodes, superedges = cell(
                nodes, edges, supernodes, superedges, graph, super_graph, aggs,
                gathers)

        aux = {"clusters": clusters, "n_clusters": n_clusters,
               "cluster_valid": cluster_valid,
               "score_cut": read_buffer(self.score_cut)[0].clone()}
        if self.output_layer is not None:
            return l2_normalize(self.output_layer(nodes).float()), aux
        return nodes, supernodes, (bipartite_graph, bipartite_weights), aux, head_gather
