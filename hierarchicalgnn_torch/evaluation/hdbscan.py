"""HDBSCAN for the embedding models' track candidates: the port's own.

A port of scikit-learn 1.9.0's ``sklearn.cluster.HDBSCAN(...).fit_predict``
for the one setting that ``hierarchicalgnn_tpu/evaluation/candidates.py:43``
uses: ``min_samples`` None (so equal to ``min_cluster_size``), Euclidean
metric, ``alpha`` 1, ``cluster_selection_method="eom"``,
``allow_single_cluster`` False, ``cluster_selection_epsilon`` 0,
``max_cluster_size`` None, float64 input.  Its labels equal sklearn's
element for element.

The two heavy parts are kernels (``ops/kernels/hdbscan.py``): HD1 the core
distances, HD2 Prim's minimum spanning tree of the mutual-reachability
graph, in the order in which Prim's loop adds the edges.  The tree work on
the host follows sklearn's Cython line by line where the order of the work
decides the output:

  * ``hdbscan.py:148-168`` ``_process_mst``: numpy's default (unstable)
    ``argsort`` of the edge weights, called on the same structured field as
    sklearn calls it, so that tied weights keep sklearn's order;
  * ``_linkage.pyx:226-`` ``make_single_linkage`` with sklearn's union-find;
  * ``_tree.pyx``: ``tree_to_labels`` (:61), ``bfs_from_hierarchy`` (:86),
    ``_condense_tree`` (:122, the same ``relabel`` and ``next_label``
    order), ``_compute_stability`` (:240), ``_get_clusters`` (:644, the EOM
    path) and ``_do_labelling`` (:433).

Exactness sets the design: the weights of a mutual-reachability MST tie
structurally (``max(core_a, core_b, d(a, b))`` is often a core distance),
and another MST algorithm picks another tree among equal-weight ones, which
changes the partition.  ``TreeUnionFind.find`` is recursive in sklearn; here
it is a loop that compresses the same path.  sklearn's ``leaf`` selection
and its epsilon search are not ported (this setting never reaches them).

The tree code is derived from scikit-learn, whose notice follows.

    Authors: The scikit-learn developers
    SPDX-License-Identifier: BSD-3-Clause

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met:

    1. Redistributions of source code must retain the above copyright notice,
    this list of conditions and the following disclaimer.

    2. Redistributions in binary form must reproduce the above copyright
    notice, this list of conditions and the following disclaimer in the
    documentation and/or other materials provided with the distribution.

    3. Neither the name of the copyright holder nor the names of its
    contributors may be used to endorse or promote products derived from this
    software without specific prior written permission.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
    IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO,
    THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR
    PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT HOLDER OR
    CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL,
    EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO,
    PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
    PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
    LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
    NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
    SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.ops.kernels.hdbscan import core_distances, prim_mst
from hierarchicalgnn_torch.utils.profiling import host_read

# sklearn's MST_edge_dtype (_linkage.pyx:47): the array whose "distance"
# field _process_mst argsorts
MST_EDGE_DTYPE = np.dtype([("current_node", np.int64), ("next_node", np.int64),
                           ("distance", np.float64)])
NOISE = -1


def hdbscan_labels(x, min_cluster_size: int, stats=None) -> np.ndarray:
    """``sklearn.cluster.HDBSCAN(min_cluster_size, metric="euclidean",
    cluster_selection_method="eom").fit_predict(x)``, ``min_samples`` None.

    ``x``: [N, D] float64 tensor on the card or the CPU (the kernels run on
    its device; the tree on the host).  Returns int64 labels [N], -1 for
    noise.  Raises on a non-finite row (sklearn would set it apart; an
    embedding is a unit vector, so such a row is a fault).  ``stats``:
    optional dict whose ``host_syncs`` counts the two host reads (the finite
    check, the edges)."""
    if not isinstance(x, torch.Tensor) or x.ndim != 2 or x.dtype != torch.float64:
        raise ValueError(f"x must be a 2-D float64 tensor, got {getattr(x, 'dtype', type(x))}")
    if min_cluster_size < 2:
        raise ValueError(f"min_cluster_size must be at least 2, got {min_cluster_size}")
    k = min_cluster_size  # sklearn's min_samples None
    n = x.shape[0]
    if n < 2:
        raise ValueError(f"HDBSCAN needs more than one sample, got {n}")
    if k > n:
        raise ValueError(f"min_samples ({k}) must be in [1, {n}], the number of samples")
    with host_read(stats):
        finite = bool(torch.isfinite(x).all())
    if not finite:
        raise ValueError("x has non-finite values")
    x = x.contiguous()
    src, dst, dist = prim_mst(x, core_distances(x, k))
    with host_read(stats):
        edges = torch.stack((src, dst, dist.view(torch.int64))).cpu().numpy()  # one copy
    return labels_from_mst(edges[0], edges[1], edges[2].view(np.float64), min_cluster_size)


def labels_from_mst(src, dst, dist, min_cluster_size: int) -> np.ndarray:
    """The host side: the MST's edges in Prim's order -> labels.
    ``_process_mst`` followed by ``tree_to_labels``."""
    mst = np.empty(len(dist), dtype=MST_EDGE_DTYPE)
    mst["current_node"], mst["next_node"], mst["distance"] = src, dst, dist
    order = np.argsort(mst["distance"])  # numpy's default kind, as sklearn
    mst = mst[order]
    left, right, size = single_linkage(mst["current_node"], mst["next_node"])
    return tree_to_labels(left, right, mst["distance"].tolist(), size, min_cluster_size)


def single_linkage(current, nxt):
    """``make_single_linkage`` (_linkage.pyx:226): merge the sorted edges'
    endpoints with sklearn's ``UnionFind`` (a new label per merge).  Returns
    (left, right, cluster_size) as Python lists; the merge values are the
    sorted edges' weights."""
    n = len(current) + 1
    parent = [-1] * (2 * n - 1)
    usize = [1] * n + [0] * (n - 1)
    next_label = n
    left, right, size = [], [], []

    def find(node):
        root = node
        while parent[root] != -1:
            root = parent[root]
        # the path to the root points at it (sklearn's shortcut differs; the
        # root, all that is read, does not)
        while node != root and parent[node] != root:
            parent[node], node = root, parent[node]
        return root

    for a, b in zip(current.tolist(), nxt.tolist()):
        a, b = find(a), find(b)
        left.append(a)
        right.append(b)
        merged = usize[a] + usize[b]
        size.append(merged)
        parent[a] = parent[b] = next_label
        usize[next_label] = merged
        next_label += 1
    return left, right, size


def tree_to_labels(left, right, value, size, min_cluster_size: int) -> np.ndarray:
    """``tree_to_labels`` (_tree.pyx:61) for EOM selection without a single
    cluster, epsilon or maximum size."""
    parent, child, lam, csize = condense_tree(left, right, value, size, min_cluster_size)
    stability = compute_stability(parent, child, lam, csize)
    return get_clusters(parent, child, csize, stability)


def bfs_from_hierarchy(left, right, n: int, root: int) -> list:
    """``bfs_from_hierarchy`` (_tree.pyx:86): the nodes under ``root``,
    level by level, left before right.  sklearn builds each level from the
    last; one first-in first-out pass gives the same order."""
    result = [root]
    for node in result:  # grows as it goes
        if node >= n:
            result.append(left[node - n])
            result.append(right[node - n])
    return result


def condense_tree(left, right, value, size, min_cluster_size: int):
    """``_condense_tree`` (_tree.pyx:122): walk the single-linkage tree
    from the root in BFS order; a split into two sides of at least
    ``min_cluster_size`` makes two new clusters (labels from ``next_label``
    on), a smaller side falls out of its parent point by point.  Returns the
    rows (parent, child, lambda, child size) as numpy arrays."""
    n = len(left) + 1
    root = 2 * (n - 1)
    next_label = n + 1
    relabel = [0] * (root + 1)
    relabel[root] = n
    ignore = bytearray(root + 1)
    rows_p, rows_c, rows_l, rows_s = [], [], [], []

    def count(node):
        return size[node - n] if node >= n else 1

    def fall_out(node, sub_root, lambda_value):
        for sub in bfs_from_hierarchy(left, right, n, sub_root):
            if sub < n:
                rows_p.append(relabel[node])
                rows_c.append(sub)
                rows_l.append(lambda_value)
                rows_s.append(1)
            ignore[sub] = 1

    for node in bfs_from_hierarchy(left, right, n, root):
        if ignore[node] or node < n:
            continue
        i = node - n
        a, b, distance = left[i], right[i], value[i]
        lambda_value = 1.0 / distance if distance > 0.0 else np.inf
        a_count, b_count = count(a), count(b)
        if a_count >= min_cluster_size and b_count >= min_cluster_size:
            for side, side_count in ((a, a_count), (b, b_count)):
                relabel[side] = next_label
                next_label += 1
                rows_p.append(relabel[node])
                rows_c.append(relabel[side])
                rows_l.append(lambda_value)
                rows_s.append(side_count)
        elif a_count < min_cluster_size and b_count < min_cluster_size:
            fall_out(node, a, lambda_value)
            fall_out(node, b, lambda_value)
        elif a_count < min_cluster_size:
            relabel[b] = relabel[node]
            fall_out(node, a, lambda_value)
        else:
            relabel[a] = relabel[node]
            fall_out(node, b, lambda_value)
    return (np.array(rows_p, np.int64), np.array(rows_c, np.int64),
            np.array(rows_l, np.float64), np.array(rows_s, np.int64))


def compute_stability(parent, child, lam, csize) -> dict:
    """``_compute_stability`` (_tree.pyx:240): per cluster, the sum over
    its rows of (lambda - the cluster's birth lambda) * size, added in row
    order."""
    smallest = int(parent.min())
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    result = np.zeros(int(parent.max()) - smallest + 1)
    np.add.at(result, parent - smallest, (lam - births[parent]) * csize)  # in row order
    return {i + smallest: v for i, v in enumerate(result.tolist())}


def get_clusters(parent, child, csize, stability: dict) -> np.ndarray:
    """``_get_clusters`` (_tree.pyx:644), EOM: from the leaves up, a
    cluster is kept when its stability is at least its children's sum
    (which then replaces it otherwise); a kept cluster unselects all below
    it.  Then ``_do_labelling`` (:433)."""
    node_list = sorted(stability, reverse=True)[:-1]  # all but the root
    is_cluster = dict.fromkeys(node_list, True)
    tree = csize > 1
    children = {}
    for p, c in zip(parent[tree].tolist(), child[tree].tolist()):
        children.setdefault(p, []).append(c)
    for node in node_list:
        below = children.get(node, [])
        subtree_stability = np.sum([stability[c] for c in below])
        if subtree_stability > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree_stability
        else:
            stack = list(below)  # every cluster under node
            while stack:
                sub = stack.pop()
                is_cluster[sub] = False
                stack.extend(children.get(sub, ()))
    clusters = {c for c, keep in is_cluster.items() if keep}
    cluster_map = {c: i for i, c in enumerate(sorted(clusters))}
    return do_labelling(parent, child, clusters, cluster_map)


def do_labelling(parent, child, clusters: set, cluster_map: dict) -> np.ndarray:
    """``_do_labelling`` (_tree.pyx:433) without a single cluster: join
    every row whose child is not a selected cluster (sklearn's
    ``TreeUnionFind``, union by rank); a point's label is its root's, noise
    where that is the root cluster."""
    root_cluster = int(parent.min())
    size = int(parent.max()) + 1
    up = list(range(size))
    rank = [0] * size

    def find(x):
        root = x
        while up[root] != root:
            root = up[root]
        while up[x] != root:
            up[x], x = root, up[x]
        return root

    for p, c in zip(parent.tolist(), child.tolist()):
        if c in clusters:
            continue
        xr, yr = find(p), find(c)
        if rank[xr] < rank[yr]:
            up[xr] = yr
        elif rank[xr] > rank[yr]:
            up[yr] = xr
        else:
            up[yr] = xr
            rank[xr] += 1
    labels = np.empty(root_cluster, np.int64)
    for point in range(root_cluster):
        cluster = find(point)
        labels[point] = NOISE if cluster == root_cluster else cluster_map[cluster]
    return labels
