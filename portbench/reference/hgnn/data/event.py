"""Event container and host-side preprocessing (numpy).

A copy of ``hierarchicalgnn_tpu/data/event.py``: the same raw event and
hparams give identical arrays in both packages.

Numpy re-design of ``TrackMLDataset.__getitem__`` (reference
``Modules/utils.py:28-113``): per-event masks (noise / hard pT cut /
isolated hits), node reindexing, per-particle hit counts and signal masks
-- then padding to static capacities so the device side is shape-stable.

The padded :class:`Event` is a pytree of device-ready arrays; ``raw`` event
dicts (host numpy) keep the unfiltered arrays needed by the evaluation path,
which scores against the unmodified event (reference
``edge_classifier_base.py:167-174``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from portbench.reference.hgnn.ops.graph import Graph


class Event(NamedTuple):
    """A single padded event (all arrays static-shape)."""

    x: np.ndarray            # [N_pad, spatial_channels] float32
    pt: np.ndarray           # [N_pad] float32
    pid: np.ndarray          # [N_pad] int32 (0 = noise)
    primary: np.ndarray      # [N_pad] int32
    nhits: np.ndarray        # [N_pad] int32
    signal_mask: np.ndarray  # [N_pad] bool
    node_mask: np.ndarray    # [N_pad] bool
    graph: Graph             # candidate edges, capacity E_pad
    y: np.ndarray            # [E_pad] bool  (modulewise truth labels)
    y_pid: np.ndarray        # [E_pad] bool  (PID truth labels)
    true_graph: Graph        # modulewise_true_edges, capacity T_pad
    signal_true_graph: Graph  # signal_true_edges, capacity T_pad
    inverse_mask: np.ndarray  # [N_pad] int32: index into the raw event
    # Particle-level arrays (reference recomputes these per step with
    # torch.unique + scatter_min, bipartite_classification_base.py:156-158;
    # here they are host-precomputed once per event).
    pid_compact: np.ndarray    # [N_pad] int32: rank of pid among unique pids
    n_particles: np.ndarray    # [] int32 (noise counts as rank 0 if present)
    particle_pid: np.ndarray   # [P_max] int32: original pid per rank
    particle_pt: np.ndarray    # [P_max] float32: min hit pt per particle
    particle_nhits: np.ndarray  # [P_max] int32


def _pad1(a, n, fill=0):
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _pad_graph(edges, capacity):
    e = edges.shape[1]
    if e > capacity:
        raise ValueError(f"edge count {e} exceeds capacity {capacity}")
    s = np.zeros(capacity, np.int32)
    r = np.zeros(capacity, np.int32)
    m = np.zeros(capacity, bool)
    s[:e], r[:e], m[:e] = edges[0], edges[1], True
    return Graph(s, r, m)


def preprocess_event(raw: dict, hparams: dict, rng: np.random.Generator | None = None,
                     stage: str = "train") -> Event:
    """Apply reference masking/filtering semantics and pad.

    ``raw`` keys follow the reference event schema (``utils.py:39-50``):
    x, pid, pt, edge_index, modulewise_true_edges, signal_true_edges,
    y, y_pid [, primary, cell_data].
    """
    pid = np.asarray(raw["pid"]).astype(np.int64)
    pt = np.asarray(raw["pt"]).astype(np.float32).copy()
    x = np.asarray(raw["x"]).astype(np.float32)
    edge_index = np.asarray(raw["edge_index"]).astype(np.int64)
    y = np.asarray(raw["y"]).astype(bool)
    y_pid = np.asarray(raw["y_pid"]).astype(bool)
    mw_edges = np.asarray(raw["modulewise_true_edges"]).astype(np.int64)
    sig_edges = np.asarray(raw["signal_true_edges"]).astype(np.int64)
    n = len(pid)

    # --- node mask (reference utils.py:59-68) ---
    if hparams.get("noise", True):
        mask = pid == pid  # only drop NaN PIDs (never happens for ints)
    else:
        mask = pid != 0
    if hparams.get("hard_ptcut", 0) > 0:
        mask = mask & (pt > hparams["hard_ptcut"])
    if hparams.get("remove_isolated", False):
        node_mask = np.zeros(n, bool)
        node_mask[np.unique(edge_index)] = True
        mask = mask & node_mask

    pt[pid == 0] = 0.0

    inverse = np.zeros(n, np.int64)
    inverse[mask] = np.arange(mask.sum())
    original_index = np.arange(n)[mask]

    # per-particle hit counts over the *unfiltered* event (utils.py:79-80)
    _, inv_u, counts = np.unique(pid, return_inverse=True, return_counts=True)
    nhits = counts[inv_u]

    if hparams.get("primary", False) and "primary" in raw:
        primary = np.asarray(raw["primary"]).astype(np.int64)
        signal_mask = (nhits >= hparams["n_hits"]) & (primary == 1)
    else:
        primary = np.zeros(n, np.int64)
        signal_mask = nhits >= hparams["n_hits"]

    # --- edge dropping (training augmentation, utils.py:88-92) ---
    drop = hparams.get("edge_dropping_ratio", 0.0)
    if drop and stage == "train":
        rng = rng or np.random.default_rng()
        keep = rng.random(edge_index.shape[1]) >= drop
        edge_index, y, y_pid = edge_index[:, keep], y[keep], y_pid[keep]

    # --- apply node mask & reindex (utils.py:94-106) ---
    gmask = mask[edge_index].all(0)
    y, y_pid = y[gmask], y_pid[gmask]
    edge_index = inverse[edge_index[:, gmask]]

    def filter_edges(e):
        return inverse[e[:, mask[e].all(0)]]

    mw_edges = filter_edges(mw_edges)
    sig_edges = filter_edges(sig_edges)

    x, pid_f, pt_f = x[mask], pid[mask], pt[mask]
    nhits_f, signal_f, primary_f = nhits[mask], signal_mask[mask], primary[mask]

    # --- pad to static capacities ---
    # With ``size_buckets`` ([[n_nodes, n_edges], ...]) each event pads to
    # the smallest fitting bucket instead of the global maximum -- one
    # compiled program per bucket, far less padding waste on small events.
    n_valid = len(pid_f)
    e_valid = edge_index.shape[1]
    n_pad = hparams["n_nodes_max"]
    e_pad = hparams["n_edges_max"]
    for bucket in sorted(hparams.get("size_buckets") or [],
                         key=lambda b: b[0]):
        if n_valid <= bucket[0] and e_valid <= bucket[1]:
            n_pad, e_pad = int(bucket[0]), int(bucket[1])
            break
    if n_valid > n_pad:
        raise ValueError(f"event has {n_valid} nodes > n_nodes_max {n_pad}")

    node_mask_pad = np.zeros(n_pad, bool)
    node_mask_pad[:n_valid] = True

    graph = _pad_graph(edge_index, e_pad)

    # particle-level arrays over the filtered event
    p_max = hparams["max_particles"]
    upid, pid_compact = np.unique(pid_f, return_inverse=True)
    n_particles = len(upid)
    if n_particles > p_max:
        raise ValueError(f"{n_particles} particles > max_particles {p_max}")
    particle_pt = np.full(p_max, np.inf, np.float32)
    np.minimum.at(particle_pt, pid_compact, pt_f)
    particle_pt[~np.isfinite(particle_pt)] = 0.0
    particle_nhits = np.zeros(p_max, np.int32)
    np.add.at(particle_nhits, pid_compact, 1)

    return Event(
        x=_pad1(x, n_pad),
        pt=_pad1(pt_f, n_pad),
        pid=_pad1(pid_f.astype(np.int32), n_pad),
        primary=_pad1(primary_f.astype(np.int32), n_pad),
        nhits=_pad1(nhits_f.astype(np.int32), n_pad),
        signal_mask=_pad1(signal_f, n_pad),
        node_mask=node_mask_pad,
        graph=graph,
        y=_pad1(y, e_pad),
        y_pid=_pad1(y_pid, e_pad),
        true_graph=_pad_graph(mw_edges, e_pad),
        signal_true_graph=_pad_graph(sig_edges, e_pad),
        inverse_mask=_pad1(original_index.astype(np.int32), n_pad),
        pid_compact=_pad1(pid_compact.astype(np.int32), n_pad),
        n_particles=np.asarray(n_particles, np.int32),
        particle_pid=_pad1(upid.astype(np.int32), p_max),
        particle_pt=particle_pt,
        particle_nhits=particle_nhits,
    )
