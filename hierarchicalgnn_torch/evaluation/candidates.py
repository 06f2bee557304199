"""Track-candidate construction for evaluation, per pipeline.

Counterpart of ``hierarchicalgnn_tpu/evaluation/candidates.py``:
  * EC: score-cut the input edges -> connected components on the device ->
    candidate labels (reference ``edge_classifier_base.py:156-165``).
  * Embedding: HDBSCAN clustering of the final embeddings (reference
    ``embedding_base.py:266-270``) with the port's own HDBSCAN
    (``evaluation/hdbscan.py``): core distances and the MST as kernels on
    the embeddings' device, the tree on the host.
  * BC/gMRT: the bipartite graph filtered by the score cut (reference
    ``bipartite_classification_base.py:262``).

All of them remap hit indices through ``inverse_mask`` so metrics are
computed against the unmodified event.  Each model names its own builder
(``model.candidates`` in ``models/models.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.evaluation.hdbscan import hdbscan_labels
from hierarchicalgnn_torch.ops.connected import cluster_labels


def ec_candidates(scores, batch, hparams, stats=None):
    """Connected components over the edges with score >= score_cut.
    ``scores``: a tensor; ``batch``: the event, on the host or the device
    (its graph moves to the scores' device)."""
    device = scores.device
    g = batch.graph
    senders = torch.as_tensor(g.senders, device=device)
    receivers = torch.as_tensor(g.receivers, device=device)
    edge_mask = torch.as_tensor(g.edge_mask, device=device)
    node_mask = torch.as_tensor(batch.node_mask, device=device)
    above = edge_mask & (scores >= hparams["score_cut"])
    # keep all edges if none pass the cut (reference :161-162)
    keep = torch.where(torch.any(above), above, edge_mask)
    clusters, _ = cluster_labels(senders, receivers, keep, node_mask.shape[0],
                                 min_cluster_size=1, node_mask=node_mask, stats=stats)
    clusters = clusters.cpu().numpy()
    node_mask = node_mask.cpu().numpy()
    inverse = np.asarray(torch.as_tensor(batch.inverse_mask).cpu())
    sel = node_mask & (clusters >= 0)
    return np.stack([inverse[sel], clusters[sel]])


def embedding_candidates(embeddings, batch, hparams, stats=None):
    """HDBSCAN spatial clustering of the embedding space: the valid rows
    (``node_mask``) as float64 on the embeddings' own device
    (``embeddings``: a tensor or an array), the labels of
    ``sklearn.cluster.HDBSCAN(min_cluster_size, metric="euclidean",
    cluster_selection_method="eom")`` exactly.  ``stats["host_syncs"]``
    counts the HDBSCAN's host reads."""
    embeddings = torch.as_tensor(embeddings)
    node_mask = np.asarray(batch.node_mask)
    rows = np.flatnonzero(node_mask)  # on the host: selecting them reads nothing back
    if len(rows) < hparams["inference_min_cluster_size"]:
        return np.zeros((2, 0), np.int64)
    emb = embeddings[torch.as_tensor(rows, device=embeddings.device)].to(torch.float64)
    clusters = hdbscan_labels(emb, hparams["inference_min_cluster_size"], stats=stats)
    inverse = np.asarray(batch.inverse_mask)[node_mask]
    sel = clusters >= 0
    return np.stack([inverse[sel], clusters[sel]])


def bipartite_candidates(bgraph, scores, batch, hparams):
    """Bipartite hit->supernode assignments above the score cut.  ``bgraph``
    and ``scores``: tensors (as the model returns them) or host arrays."""
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    emask, scores = host(bgraph.edge_mask), host(scores)
    senders, receivers = host(bgraph.senders), host(bgraph.receivers)
    sel = emask & (scores >= hparams["score_cut"])
    inverse = np.asarray(batch.inverse_mask)
    return np.stack([inverse[senders[sel]], receivers[sel]])
