"""Per-phase timing probes: pooling and dynamic graph construction.

Counterpart of ``hierarchicalgnn_tpu/utils/phase_probe.py``.  The gMRT
pipeline logs per-epoch ``pooling_time`` and ``graph_construct_time``
(reference ``Modules/gMRT/gmrt_base.py:61-73``).  The probes run the
phases' own math -- the same ops, shapes and hparams -- on the model's
intermediate embeddings: the cosine likelihood, ``fit_gmm2``, the cut,
``cluster_labels`` (K5) and the cluster means, then the super and
bipartite kNN.  Each phase is timed by :class:`utils.profiling.PhaseTimer`
(CUDA events on the card).
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.connected import cluster_labels
from hierarchicalgnn_torch.ops.gmm import fit_gmm2, solve_cut
from hierarchicalgnn_torch.ops.knn import knn
from hierarchicalgnn_torch.ops.sddmm import edge_cosine_likelihood
from hierarchicalgnn_torch.ops.segment import segment_mean
from hierarchicalgnn_torch.utils.profiling import PhaseTimer


class PhaseProbes:
    """Pooling and graph-construction probes for one config."""

    def __init__(self, hparams: dict):
        self.hparams = hparams
        self.min_cluster = int(hparams.get("min_cluster_size", 3))
        self.granularity = float(hparams.get("cluster_granularity", 0))
        self.gmm_iters = int(hparams.get("gmm_iters", 60))
        self.max_clusters = int(hparams["max_clusters"])
        self.k_super = int(hparams.get("supergraph_sparsity", 10))
        self.k_bip = int(hparams.get("bipartitegraph_sparsity", 5))
        self.block = int(hparams.get("knn_block_size", 1024))

    def _pooling(self, embeddings, graph, node_mask):
        s, r, edge_mask = graph.senders, graph.receivers, graph.edge_mask
        lik = edge_cosine_likelihood(embeddings, s, r, mask=edge_mask)
        gmm = fit_gmm2(lik, edge_mask, iters=self.gmm_iters)
        cut, _ = solve_cut(gmm, self.granularity)
        keep = edge_mask & (lik >= cut)
        clusters, n_clusters = cluster_labels(
            s, r, keep, embeddings.shape[0], min_cluster_size=self.min_cluster,
            node_mask=node_mask)
        in_cluster = clusters >= 0
        means = segment_mean(embeddings.float(), torch.where(in_cluster, clusters, 0).long(),
                             self.max_clusters, mask=in_cluster)
        return means, n_clusters

    def _construct(self, embeddings, means, node_mask, n_clusters):
        cvalid = torch.arange(means.shape[0], device=means.device) < n_clusters
        s_idx, _ = knn(means, means, self.k_super, 1e9, q_mask=cvalid, p_mask=cvalid,
                       block_size=self.block)
        b_idx, _ = knn(embeddings, means, self.k_bip, 1e9, q_mask=node_mask, p_mask=cvalid,
                       block_size=self.block)
        return s_idx, b_idx

    @torch.no_grad()
    def measure(self, embeddings, graph, node_mask) -> dict[str, float]:
        """Returns {'pooling_time', 'graph_construct_time'} in seconds."""
        timer = PhaseTimer(embeddings.device)
        with timer.phase("pooling_time"):
            means, n_clusters = self._pooling(embeddings, graph, node_mask)
        with timer.phase("graph_construct_time"):
            self._construct(embeddings, means, node_mask, n_clusters)
        return timer.summary()
