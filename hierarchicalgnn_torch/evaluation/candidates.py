"""Track-candidate construction for the bipartite classifier (numpy).

A copy of ``hierarchicalgnn_tpu/evaluation/candidates.py::bipartite_candidates``
(reference ``bipartite_classification_base.py:262``): the bipartite graph
filtered by the score cut, with hit indices remapped through
``inverse_mask`` so metrics are computed against the unmodified event.
The EC and embedding builders serve the other models and are not ported
yet.
"""

from __future__ import annotations

import numpy as np


def bipartite_candidates(bgraph, scores, batch, hparams):
    """Bipartite hit->supernode assignments above the score cut."""
    emask = np.asarray(bgraph.edge_mask)
    scores = np.asarray(scores)
    senders = np.asarray(bgraph.senders)
    receivers = np.asarray(bgraph.receivers)
    sel = emask & (scores >= hparams["score_cut"])
    inverse = np.asarray(batch.inverse_mask)
    return np.stack([inverse[senders[sel]], receivers[sel]])
