"""Model blocks: the interaction stack and the hierarchical (pooling) stack.

Counterpart of ``hierarchicalgnn_tpu/models/blocks.py`` on its single-device
sorted-native branch (``use_pallas``, ``blocks.py:343-350`` and
``:414-460``).  Every graph is receiver-sorted once per forward
(:class:`SortedPlan`) and each aggregation is a kernel: K1 for the flat
edge->node sums, K2 for the weighted bipartite and super-graph
convolutions, K5 for the connected-components hop of the GMM pooling.
In training the flat and super graphs also get a transposed plan, so the
endpoint gathers' backward runs K1 (``gather_edge_endpoints``); the two
bipartite plans are each other's transposes, so the bipartite row gathers'
backward runs K1 too; and the pooling updates the ``score_cut`` EMA.
With ``shard`` (``parallel/graph_shard.py``) the blocks run as one rank of a
shard group: node rows and edges are the rank's own, the halo and the pooled
space go through the group's collectives, and the parameters are the same.
In training every gather of a rank keeps its K1 backward, and the buffer
updates are staged (``models/buffers.py``) for the caller to apply once.

f32 islands on the bf16 path: both embedding heads, the edge likelihood
and the GMM stay f32, as in the JAX package.  Each block exists once,
parameterized by the models' deltas: the IN block with or without its
embedding head, the hierarchical block with or without the 1-norm before
the supernode init and the final embedding head, and ``share_weight``
(one cell applied at every iteration).
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.ops import gmm as gmm_ops
from hierarchicalgnn_torch.ops.connected import cluster_labels_sorted, count_host_sync
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    build_sorted_plan, build_transposed_plan, cross_permutation,
    gather_edge_endpoints, gather_receivers, gather_senders, sorted_aggregate,
    sorted_aggregate_weighted)
from hierarchicalgnn_torch.ops.sddmm import cosine_from_endpoints, normalize_unit_f32
from hierarchicalgnn_torch.ops.segment import segment_mean, segment_sum
from hierarchicalgnn_torch.parallel.graph_shard import (
    make_hier_shard_aggs, pooled_active, sharded_cluster_labels)
from hierarchicalgnn_torch.models.buffers import read_buffer, write_buffer
from hierarchicalgnn_torch.models.cells import (
    HierarchicalGNNCell, InteractionGNNCell, plain_gather)
from hierarchicalgnn_torch.models.dynamic_graph import DynamicGraphConstruction
from hierarchicalgnn_torch.models.mlp import MLP, MatchDims
from hierarchicalgnn_torch.utils.config import ArchConfig
from hierarchicalgnn_torch.utils.device import torch_dtype


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(||x||, eps) (torch ``F.normalize`` numerics)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def l1_normalize(x, dim=-1, eps=1e-12):
    n = torch.sum(torch.abs(x), dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def endpoint_gather(plan, graph: Graph, num_segments: int, transposed: bool):
    """``x -> (x[senders], x[receivers])`` over ``plan`` (built from
    ``graph``).  With ``transposed`` it carries the K1 backward, at the
    price of one more sort of the edges."""
    plan_t = r2s = None
    if transposed:
        plan_t, r2s = build_transposed_plan(plan, graph.senders, graph.receivers,
                                            graph.edge_mask, num_segments)
    return lambda x: gather_edge_endpoints(x, plan, plan_t, r2s)


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
                   training: bool = False, shard=None, endpoint_gather=None):
        """GMM edge cut + connected components over the sorted flat graph
        (reference ``HGNN_GMM.py:184-238``), gradient-free.  Training fits
        the GMM, moves the ``score_cut`` EMA (momentum 0.95; its first value
        is the GMM means' midpoint; a fit without a valid cut leaves it) and
        cuts at the new value (``blocks.py:212-220``).

        ``shard``: ``graph`` is this rank's receiver-partitioned
        edge slice (global ids), ``embeddings`` and ``node_mask`` the whole
        event's; ``endpoint_gather()`` gives the unit embeddings at the local
        edges' ends through the halo.  The likelihood is computed on the
        local edges only, the GMM is fitted on every rank on the all-gathered
        likelihood (the same moments, summed in per-rank order), and the
        components run partitioned (``sharded_cluster_labels``).
        Returns (clusters int32[N] with -1 fill, n_clusters as a Python int)."""
        cfg = self.cfg
        if endpoint_gather is not None:
            x_s, x_r = endpoint_gather()
        else:
            unit = normalize_unit_f32(embeddings.detach())
            x_s, x_r = unit[graph.senders], unit[graph.receivers]
        likelihood = cosine_from_endpoints(x_s, x_r, mask=graph.edge_mask)

        def fit_gmm():
            if shard is None:
                return gmm_ops.fit_gmm2(likelihood, graph.edge_mask, iters=cfg.gmm_iters)
            return gmm_ops.fit_gmm2(shard.all_gather(likelihood),
                                    shard.all_gather(graph.edge_mask),
                                    iters=cfg.gmm_iters)

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
                # eval cuts at the buffer value; solve_cut only feeds the
                # training EMA, so eval fits the GMM for its means alone
                sc = torch.mean(fit_gmm().means)
        keep = graph.edge_mask & (likelihood >= sc)
        n = embeddings.shape[0]

        def cluster(mask):
            if shard is not None:
                clusters, n_clusters = sharded_cluster_labels(
                    shard, mask, n, min_cluster_size=cfg.min_cluster_size,
                    node_mask=node_mask, stats=stats)
            else:
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

    def _pool_sharded(self, embeddings, node_mask, shard, stats, training):
        """The pooling of one rank of a shard group: (clusters, n_clusters,
        cluster means [C, emb] before normalisation, the whole event's
        embeddings and node mask).  With the pooled space partitioned the
        clustering and the means work on the rank's own rows and edges;
        otherwise every rank pools the whole gathered event.  The means carry
        the embeddings' gradient, through the sum over ranks or the
        all-gather."""
        cfg = self.cfg
        emb_global = shard.all_gather(embeddings)
        mask_global = shard.all_gather(node_mask)
        if pooled_active(shard.spec, cfg.max_clusters):
            clusters, n_clusters = self.clustering(
                emb_global, shard.local_graph, mask_global, None, stats, training,
                shard=shard, endpoint_gather=lambda: shard.gather(
                    normalize_unit_f32(embeddings.detach())))
            # cluster means from the LOCAL rows and one sum over the ranks of
            # the [C, emb] and [C] partial moments
            rows = slice(shard.index * shard.n_local, (shard.index + 1) * shard.n_local)
            in_cluster = clusters[rows] >= 0
            seg = torch.where(in_cluster, clusters[rows], 0).long()
            total = segment_sum(embeddings, seg, cfg.max_clusters, mask=in_cluster)
            count = segment_sum(torch.ones_like(embeddings[:, 0]), seg, cfg.max_clusters,
                                mask=in_cluster)
            total, count = shard.comm.psum(total), shard.comm.psum(count)
            means = total / torch.clamp(count, min=1)[:, None]
        else:
            full = shard.full_graph
            fplan = build_sorted_plan(full.senders, full.receivers, full.edge_mask,
                                      emb_global.shape[0])
            fgraph = Graph(fplan.senders_sorted, fplan.receivers_sorted,
                           fplan.edge_mask_sorted)
            clusters, n_clusters = self.clustering(emb_global, fgraph, mask_global,
                                                   fplan, stats, training)
            in_cluster = clusters >= 0
            means = segment_mean(emb_global, torch.where(in_cluster, clusters, 0).long(),
                                 cfg.max_clusters, mask=in_cluster)
        return clusters, n_clusters, means, emb_global, mask_global

    def forward(self, embeddings, nodes, edges, graph: Graph, node_mask, agg,
                plan, stats=None, gather=None, training: bool = False, shard=None):
        """``graph``: sorted flat work graph with K1 aggregator ``agg``,
        endpoint gather ``gather`` and plan ``plan``.  Returns (nodes,
        supernodes, (bgraph, bweights), aux, head_gather); ``head_gather(nodes,
        supernodes)`` gives the rows at the bipartite edges' two ends.  With
        ``emb_output`` it returns (embeddings f32, aux).

        ``shard``: a ``parallel.graph_shard.ShardTools`` when this call is one
        rank of a shard group.  ``embeddings``, ``nodes`` and ``node_mask``
        are then the rank's row blocks and ``graph`` its receiver-partitioned
        edges (``agg``, ``gather`` and ``plan`` come from ``shard``).  The
        bipartite graph comes back in the kNN's edge order (the rank's own
        block with local sender ids when the pooled space is partitioned, the
        whole graph otherwise), the supernodes whole, and ``head_gather`` is
        ``(gather, plan)`` over the rank's block of the bipartite edges
        (``make_hier_shard_aggs``)."""
        cfg = self.cfg
        n = nodes.shape[0]
        pooled = False
        if shard is not None:
            pooled = pooled_active(shard.spec, cfg.max_clusters)
            clusters, n_clusters, means, emb_global, mask_global = self._pool_sharded(
                embeddings, node_mask, shard, stats, training)
        else:
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
        if shard is None or pooled:
            # unsharded, or query-sharded: this rank mines its own node rows and
            # the result IS its sender-contiguous block of the bipartite graph
            bipartite_graph, bipartite_weights, _ = self.bipartite_graph_construction(
                embeddings, means, training, src_mask=node_mask, dst_mask=cluster_valid,
                comm=shard.comm if pooled else None)
        else:
            bipartite_graph, bipartite_weights, _ = self.bipartite_graph_construction(
                emb_global, means, training, src_mask=mask_global,
                dst_mask=cluster_valid)

        if shard is not None:
            # local flat edges, the local bipartite block + one sum over the
            # ranks into the supernode space, the halo gather for the edge update
            aggs, gathers, super_graph, super_weights, s_ok, head_gather = \
                make_hier_shard_aggs(shard, bipartite_graph, bipartite_weights,
                                     super_graph, super_weights, cfg.max_clusters,
                                     cfg.bipartitegraph_sparsity, training)
            if stats is not None:
                stats.setdefault("partition_ok", []).append(s_ok)
        else:
            # one receiver-sorted plan per direction, shared by the init and
            # every hierarchical iteration
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
            # b1 (sorted by cluster) and b2 (sorted by node) hold the same edges:
            # each is the other's transposed plan, so in training the row gathers
            # by b1's senders (nodes) and by b2's senders (clusters) get a K1
            # backward for the price of two index gathers
            b1_of_b2 = cross_permutation(b1, b2) if training else None
            b2_of_b1 = cross_permutation(b2, b1) if training else None
            t1, t2 = (b2, b1) if training else (None, None)
            gathers = {
                "graph": gather or plain_gather(graph),
                "super": gather_super,
                "bip_to_super": lambda x: gather_senders(x, b1, t1, b1_of_b2),
                "bip_to_node": lambda x: gather_senders(x, b2, t2, b2_of_b1),
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
            # the score head's inputs: rows by the bipartite graph's endpoints
            head_gather = lambda x, sn: (gathers["bip_to_super"](x),
                                         gather_receivers(sn, b1))

        agg_to_super, _ = aggs["bip_to_super"]
        init_nodes = l1_normalize(nodes) if self.l1_norm_supernode_init else nodes
        agg_init = agg_to_super(gathers["bip_to_super"](init_nodes)).to(nodes.dtype)
        means_rows = means
        if pooled:  # this rank's block of the supernode rows
            c_local = cfg.max_clusters // shard.spec.n_parts
            means_rows = means[shard.index * c_local:(shard.index + 1) * c_local]
        supernodes = torch.cat([means_rows.to(nodes.dtype),
                                self.supernode_encoder(agg_init)], -1)
        # the whole supernode array, for indexing by global cluster ids: an
        # all-gather when the rows are blocked over the ranks, else the identity
        super_bcast = gathers.get("super_bcast") or (lambda x: x)
        superedges = self.superedge_encoder(torch.cat(
            gathers["super"](super_bcast(supernodes)), -1))

        for cell in _schedule(self.cells, cfg.n_hierarchical_graph_iters):
            nodes, edges, supernodes, superedges = cell(
                nodes, edges, supernodes, superedges, graph, super_graph, aggs,
                gathers)

        # a copy: the buffer is updated in place by the next training forward
        aux = {"clusters": clusters, "n_clusters": n_clusters,
               "cluster_valid": cluster_valid,
               "score_cut": read_buffer(self.score_cut)[0].clone()}
        if self.output_layer is not None:
            return l2_normalize(self.output_layer(nodes).float()), aux
        return (nodes, super_bcast(supernodes), (bipartite_graph, bipartite_weights),
                aux, head_gather)


class GMRTEncoders(nn.Module):
    """gMRT's minimal encoders: single Dense layers in place of the deep IN
    block (``blocks.py:539-568`` of the JAX package), all in f32.  The
    embeddings come from the f32 nodes, before the cast to the compute
    dtype."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        act = cfg.hidden_activation
        self.node_encoder = MatchDims(cfg.spatial_channels, cfg.latent, act,
                                      cfg.layernorm, cfg.remat)
        self.edge_encoder = MatchDims(2 * cfg.spatial_channels, cfg.latent, act,
                                      cfg.layernorm, cfg.remat)
        self.output_layer = MatchDims(cfg.latent, cfg.emb_dim, None, cfg.layernorm)

    def forward(self, x, graph: Graph, encode_gather=None):
        """Returns (embeddings f32, nodes, edges) over the sorted work graph.
        ``encode_gather``: as in :class:`InteractionGNNBlock`."""
        nodes = self.node_encoder(x)
        edges = self.edge_encoder(torch.cat(
            (encode_gather or plain_gather(graph))(x), -1))
        embeddings = l2_normalize(self.output_layer(nodes).float())
        dtype = torch_dtype(self.cfg.compute_dtype)
        if dtype is not None:
            nodes, edges = nodes.to(dtype), edges.to(dtype)
        return embeddings, nodes, edges
