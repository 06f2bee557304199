"""The five pipeline models.

Counterpart of ``hierarchicalgnn_tpu/models/models.py``.  Each is a module
over (x, undirected Graph, node_mask):

  * EdgeClassifierIN        -- EC-IN: scores of the input edges
  * EmbeddingIN             -- Embedding-IN: hit embeddings
  * EmbeddingHGNNGMM        -- Embedding-HGNN-GMM: (embeddings, IN-block
                               embeddings, clustering aux)
  * BipartiteClassifierHGNN -- BC-HGNN-GMM, the flagship: (bipartite graph,
                               scores, IN-block embeddings, aux)
  * GMRT                    -- gMRT: BC with single-layer encoders

``model.candidates(out, host_batch, hparams)`` turns the eval output ``out``
into the [2, M] (hit, track) candidates of the model's kind.
``model.train()`` / ``model.eval()`` select the mode: training fits the
pooling GMM every forward, updates the buffers (``score_cut``,
``knn_radius``, batch-norm statistics) in place and builds the transposed
plans whose K1 backward the endpoint gathers use.

``spmd`` (a ``parallel.graph_shard.SpmdSpec`` with the calling rank's
``comm``) runs the forward, in either mode, as one rank of a shard group:
``x`` and ``node_mask`` are the rank's node-row blocks, ``graph`` the whole
event's, and the node- and edge-space outputs are the rank's blocks, which
``parallel.graph_shard.make_sharded_forward`` (eval) and
``make_sharded_train_step`` (training) reassemble by the model's
``sharded_out_specs(spmd)``: a tree, shaped like the forward's output, of
``SHARDED`` (the ranks' blocks concatenate along dim 0) and ``REPLICATED``
(every rank holds the whole), what ``out_specs`` is to a ``shard_map``.  In
training the partition gets transposed plans, so every gather of a rank,
the halo's included, has K1 as its backward.
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.evaluation import candidates
from hierarchicalgnn_torch.ops.graph import Graph, bidirectionalize
from hierarchicalgnn_torch.models.blocks import (
    GMRTEncoders, HierarchicalGNNBlock, InteractionGNNBlock, sorted_graph_mode)
from hierarchicalgnn_torch.models.dynamic_graph import DynamicGraphConstruction
from hierarchicalgnn_torch.models.mlp import MLP, MaskedBatchNorm, MatchDims
from hierarchicalgnn_torch.parallel.graph_shard import (
    REPLICATED, SHARDED, make_shard_tools, pooled_active)
from hierarchicalgnn_torch.utils.config import ArchConfig


def _score_head(cfg: ArchConfig, remat):
    """The f32-output score MLP over a pair of latent rows."""
    return MLP(2 * cfg.latent, cfg.hidden, 1, cfg.output_layers,
               hidden_activation=cfg.hidden_output_activation,
               output_activation=None, layer_norm=cfg.layernorm,
               compute_dtype=cfg.compute_dtype, remat=remat)


class _Model(nn.Module):
    """What the five models share: the config, the seeded init and the
    sorted work graph of a forward."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg

    def reset_parameters(self, generator: torch.Generator):
        """Seeded kaiming init of every MLP and dim-matching layer
        (``models/mlp.py``), in module order; batch-norm affine parameters
        and every buffer return to their defaults."""
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
        """(node_mask, work graph, K1 aggregator, endpoint gather, plan) of
        the bidirected input graph, receiver-sorted."""
        if node_mask is None:
            node_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        return (node_mask,) + sorted_graph_mode(
            bidirectionalize(graph), x.shape[0], transposed=self.training)

    def _shard_tools(self, x, graph: Graph, spmd, stats):
        """This rank's partition of the bidirected input graph, its K1
        aggregator and its halo gather (with a K1 backward in training); the
        partition's overflow flag goes into ``stats["partition_ok"]``."""
        tools = make_shard_tools(bidirectionalize(graph), x.shape[0], spmd,
                                 transposed=self.training)
        if stats is not None:
            stats.setdefault("partition_ok", []).append(tools.ok)
        return tools


class EdgeClassifierIN(_Model):
    """Flat interaction-network edge classifier (EC-IN): each undirected
    edge is scored from the concat of its two directed copies' features
    (reference ``IN.py:118-128``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters, emb=False)
        self.edge_classifier = _score_head(cfg, remat=False)

    def forward(self, x, graph: Graph, node_mask=None, stats=None, spmd=None):
        """Returns the f32 scores of the input edges (0 on padded slots);
        under ``spmd`` those of this rank's contiguous slice of the edges."""
        if spmd is not None:
            return self._forward_sharded(x, graph, spmd, stats)
        _, work, agg, gather, plan = self._work_graph(x, graph, node_mask)
        _, edges = self.ignn(x, work, agg, gather)
        # back to input order: the plan holds exactly the 2e directed edges,
        # so the halves pair the two copies of each undirected edge
        edges = plan.unsort(edges)
        e = graph.senders.shape[0]
        logits = self.edge_classifier(torch.cat([edges[:e], edges[e:]], -1))[:, 0]
        return torch.where(graph.edge_mask, torch.sigmoid(logits.float()), 0.0)

    def _forward_sharded(self, x, graph: Graph, spmd, stats):
        tools = self._shard_tools(x, graph, spmd, stats)
        _, edges_local = self.ignn(x, tools.local_graph, tools.agg, tools.gather,
                                   encode_gather=tools.gather)
        # the two directed copies of an edge live on (possibly) different
        # ranks: gather every rank's edge rows and pick both copies of this
        # rank's slice of the undirected edges by their partition slots
        edges_all = tools.all_gather(edges_local)
        e = graph.senders.shape[0]
        e_loc = e // spmd.n_parts
        mine = slice(tools.index * e_loc, (tools.index + 1) * e_loc)
        pair = torch.cat([edges_all[tools.slot[:e][mine]],
                          edges_all[tools.slot[e:][mine]]], -1)
        logits = self.edge_classifier(pair)[:, 0]
        return torch.where(graph.edge_mask[mine], torch.sigmoid(logits.float()), 0.0)

    def sharded_out_specs(self, spmd):
        return SHARDED  # scores [E]

    def candidates(self, out, host_batch, hparams, stats=None):
        return candidates.ec_candidates(out, host_batch, hparams, stats=stats)


class EmbeddingIN(_Model):
    """Flat metric-learning embedding model (Embedding-IN)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters)

    def forward(self, x, graph: Graph, node_mask=None, stats=None, spmd=None):
        """Returns the unit-norm f32 embeddings [N, emb_dim]; under ``spmd``
        those of this rank's node rows."""
        if spmd is not None:
            tools = self._shard_tools(x, graph, spmd, stats)
            return self.ignn(x, tools.local_graph, tools.agg, tools.gather,
                             encode_gather=tools.gather)[0]
        _, work, agg, gather, _ = self._work_graph(x, graph, node_mask)
        return self.ignn(x, work, agg, gather)[0]

    def sharded_out_specs(self, spmd):
        return SHARDED  # embeddings [N, emb_dim]

    def candidates(self, out, host_batch, hparams, stats=None):
        return candidates.embedding_candidates(out, host_batch, hparams)


class EmbeddingHGNNGMM(_Model):
    """Hierarchical embedding model (Embedding-HGNN-GMM)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.ignn = InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters)
        self.hgnn = HierarchicalGNNBlock(cfg, l1_norm_supernode_init=False,
                                         emb_output=True)

    def forward(self, x, graph: Graph, node_mask=None, stats=None, spmd=None):
        """Returns (embeddings, IN-block embeddings, aux).  ``stats``:
        optional dict that collects ``host_syncs``.  Under ``spmd`` both
        embeddings are those of this rank's node rows."""
        if spmd is not None:
            tools = self._shard_tools(x, graph, spmd, stats)
            intermediate, nodes, edges = self.ignn(
                x, tools.local_graph, tools.agg, tools.gather, encode_gather=tools.gather)
            embeddings, aux = self.hgnn(
                intermediate, nodes, edges, tools.local_graph, node_mask, tools.agg,
                tools.local_plan, stats, gather=tools.gather, training=self.training,
                shard=tools)
            return embeddings, intermediate, aux
        node_mask, work, agg, gather, plan = self._work_graph(x, graph, node_mask)
        intermediate, nodes, edges = self.ignn(x, work, agg, gather)
        embeddings, aux = self.hgnn(
            intermediate, nodes, edges, work, node_mask, agg, plan, stats,
            gather=gather, training=self.training)
        return embeddings, intermediate, aux

    def sharded_out_specs(self, spmd):
        return (SHARDED, SHARDED, REPLICATED)

    def candidates(self, out, host_batch, hparams, stats=None):
        return candidates.embedding_candidates(out[0], host_batch, hparams)


class _BipartiteScorer(_Model):
    """BC and gMRT: an encoder, the hierarchical block and the bipartite
    score head.  A subclass passes its encoder and says how to call it."""

    def __init__(self, cfg: ArchConfig, encoder: nn.Module):
        super().__init__(cfg)
        self.ignn = encoder
        self.hgnn = HierarchicalGNNBlock(cfg)
        self.bipartite_output_layer = _score_head(cfg, remat=cfg.remat)

    def forward(self, x, graph: Graph, node_mask=None, stats=None, spmd=None):
        """Forward over one padded event, in the module's mode.

        Returns (bgraph, scores, embeddings, aux) like the JAX model: the
        receiver-sorted bipartite graph, its f32 edge scores (0 on padded
        slots), the encoder's embeddings and the clustering aux.  ``stats``:
        optional dict that collects ``host_syncs``.  Under ``spmd`` the
        scores and embeddings are this rank's blocks and the bipartite graph
        is in the kNN's edge order (:meth:`_forward_sharded`).
        """
        if spmd is not None:
            return self._forward_sharded(x, graph, node_mask, spmd, stats)
        node_mask, work, agg, gather, plan = self._work_graph(x, graph, node_mask)
        embeddings, nodes, edges = self._encode(x, work, agg, gather)
        nodes, supernodes, (bgraph, _), aux, head_gather = self.hgnn(
            embeddings, nodes, edges, work, node_mask, agg, plan, stats,
            gather=gather, training=self.training)
        logits = self.bipartite_output_layer(torch.cat(
            head_gather(nodes, supernodes), -1))[:, 0]
        scores = torch.where(bgraph.edge_mask, torch.sigmoid(logits.float()), 0.0)
        return bgraph, scores, embeddings, aux

    def _forward_sharded(self, x, graph: Graph, node_mask, spmd, stats):
        """One rank's forward.  With the pooled space partitioned the block's
        bipartite graph IS this rank's sender-contiguous block; its senders
        are made global for the returned graph, and the ranks' blocks
        concatenate into the unsharded kNN edge order.  Otherwise the whole
        graph comes back on every rank and the scores are those of this
        rank's slice of it.  The head scores the rank's edges in the order of
        the block's node-sorted plan (its row gathers' backward is K1) and
        puts them back into the kNN's order."""
        cfg = self.cfg
        tools = self._shard_tools(x, graph, spmd, stats)
        embeddings, nodes, edges = self._encode(
            x, tools.local_graph, tools.agg, tools.gather, encode_gather=tools.gather)
        nodes, supernodes, (bgraph, _), aux, (head_gather, head_plan) = self.hgnn(
            embeddings, nodes, edges, tools.local_graph, node_mask, tools.agg,
            tools.local_plan, stats, gather=tools.gather, training=self.training,
            shard=tools)
        if pooled_active(spmd, cfg.max_clusters):
            b_send, b_recv, b_mask = bgraph
            bgraph = Graph(b_send + tools.index * tools.n_local, b_recv, b_mask)
        logits = self.bipartite_output_layer(torch.cat(
            head_gather(nodes, supernodes), -1))[:, 0]
        scores = torch.where(head_plan.edge_mask_sorted, torch.sigmoid(logits.float()), 0.0)
        return bgraph, head_plan.unsort(scores), embeddings, aux

    def sharded_out_specs(self, spmd):
        """With the pooled space partitioned the bipartite graph comes back
        as the rank's sender-contiguous block; otherwise whole on every rank."""
        pooled = pooled_active(spmd, self.cfg.max_clusters)
        bgraph = Graph(SHARDED, SHARDED, SHARDED) if pooled else REPLICATED
        return (bgraph, SHARDED, SHARDED, REPLICATED)

    def candidates(self, out, host_batch, hparams, stats=None):
        return candidates.bipartite_candidates(out[0], out[1], host_batch, hparams)


class BipartiteClassifierHGNN(_BipartiteScorer):
    """Hierarchical bipartite hit<->supernode classifier (BC-HGNN-GMM)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg, InteractionGNNBlock(cfg, cfg.n_interaction_graph_iters))

    def _encode(self, x, work, agg, gather, encode_gather=None):
        return self.ignn(x, work, agg, gather, encode_gather=encode_gather)


class GMRT(_BipartiteScorer):
    """gMRT: BC with single-layer encoders in place of the IN stack."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg, GMRTEncoders(cfg))

    def _encode(self, x, work, agg, gather, encode_gather=None):
        return self.ignn(x, work, encode_gather=encode_gather)


MODELS = {"EC-IN": EdgeClassifierIN, "Embedding-IN": EmbeddingIN,
          "Embedding-HGNN-GMM": EmbeddingHGNNGMM,
          "BC-HGNN-GMM": BipartiteClassifierHGNN, "gMRT": GMRT}


def build_model(hparams: dict, seed: int = 0):
    """The model that ``hparams["model"]`` names, with seeded random weights
    (on the CPU), in eval mode.  The weights come from ``seed`` alone: the
    layers' default init, which draws from torch's global generator, runs on a
    fork of it, so building a model leaves that generator as it was."""
    try:
        model_cls = MODELS[hparams["model"]]
    except KeyError:
        raise ValueError(f"Can't find model name {hparams['model']!r}! "
                         f"Available: {sorted(MODELS)}") from None
    with torch.random.fork_rng(devices=[]):
        model = model_cls(ArchConfig.from_hparams(hparams))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
