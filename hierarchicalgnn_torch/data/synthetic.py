"""Synthetic TrackML-like event generator (numpy).

A copy of ``hierarchicalgnn_tpu/data/synthetic.py``: the same generator
state gives identical events in both packages.

The reference trains on preprocessed TrackML-1GeV quickstart events
(reference ``README.md:65``) that are not shipped with the repo.  This
generator produces events with the same schema and qualitative structure --
helical tracks through cylindrical detector layers, noise hits, a candidate
graph from true adjacencies plus geometric fakes -- so every pipeline can
be trained, tested, and benchmarked hermetically.  Real preprocessed events
(PyG ``.pt`` files) are supported via :mod:`data.reader`.
"""

from __future__ import annotations

import numpy as np

LAYER_RADII = np.array([32, 72, 116, 172, 260, 360, 500, 660, 820, 1020],
                       dtype=np.float32) / 1000.0  # meters-ish, scaled


def generate_event(rng: np.random.Generator, n_particles: int = 120,
                   noise_fraction: float = 0.1, pt_min: float = 0.1,
                   pt_max: float = 5.0, fake_edge_ratio: float = 1.0) -> dict:
    """One event dict with the reference schema (``utils.py:39-50``)."""
    xs, pids, pts, primaries = [], [], [], []
    mw_src, mw_dst = [], []

    hit_count = 0
    for p in range(1, n_particles + 1):
        # log-uniform pT; curvature ~ 1/pT
        pt = float(np.exp(rng.uniform(np.log(pt_min), np.log(pt_max))))
        phi0 = rng.uniform(0, 2 * np.pi)
        cot_theta = rng.normal(0.0, 1.2)
        z0 = rng.normal(0.0, 0.05)
        curvature = rng.choice([-1.0, 1.0]) * 0.3 / max(pt, 0.05)
        n_layers = rng.integers(3, len(LAYER_RADII) + 1)
        primary = int(rng.random() < 0.7)

        first = hit_count
        for li in range(n_layers):
            r = LAYER_RADII[li]
            phi = phi0 + curvature * r + rng.normal(0.0, 0.002)
            z = z0 + cot_theta * r + rng.normal(0.0, 0.002)
            xs.append([r, np.sin(phi), z])
            pids.append(p)
            pts.append(pt)
            primaries.append(primary)
            hit_count += 1
        for i in range(first, hit_count - 1):
            mw_src.append(i)
            mw_dst.append(i + 1)

    # noise hits (pid 0)
    n_noise = int(hit_count * noise_fraction)
    for _ in range(n_noise):
        r = float(rng.choice(LAYER_RADII))
        xs.append([r, np.sin(rng.uniform(0, 2 * np.pi)),
                   rng.normal(0.0, 1.0)])
        pids.append(0)
        pts.append(0.0)
        primaries.append(0)
        hit_count += 1

    x = np.asarray(xs, np.float32)
    pid = np.asarray(pids, np.int64)
    pt = np.asarray(pts, np.float32)
    primary = np.asarray(primaries, np.int64)
    mw_edges = np.stack([np.asarray(mw_src), np.asarray(mw_dst)]).astype(np.int64)

    # signal_true_edges: true edges of reconstructable particles (>=5 hits)
    _, inv_u, counts = np.unique(pid, return_inverse=True, return_counts=True)
    nhits = counts[inv_u]
    sig = (nhits[mw_edges] >= 5).all(0)
    sig_edges = mw_edges[:, sig]

    # candidate graph: all true edges + random fakes between nearby layers
    n_fake = int(mw_edges.shape[1] * fake_edge_ratio)
    f_src = rng.integers(0, hit_count, n_fake)
    f_dst = rng.integers(0, hit_count, n_fake)
    ok = f_src != f_dst
    fakes = np.stack([f_src[ok], f_dst[ok]]).astype(np.int64)
    edge_index = np.concatenate([mw_edges, fakes], axis=1)
    perm = rng.permutation(edge_index.shape[1])
    edge_index = edge_index[:, perm]

    # labels
    true_set = {(a, b) for a, b in mw_edges.T}
    y = np.array([(a, b) in true_set or (b, a) in true_set
                  for a, b in edge_index.T])
    y_pid = (pid[edge_index[0]] == pid[edge_index[1]]) & (pid[edge_index[0]] != 0)

    return {
        "x": x,
        "cell_data": np.zeros((hit_count, 1), np.float32),
        "pid": pid,
        "hid": np.arange(hit_count, dtype=np.int64),
        "pt": pt,
        "primary": primary,
        "edge_index": edge_index,
        "modulewise_true_edges": mw_edges,
        "signal_true_edges": sig_edges,
        "y": y,
        "y_pid": y_pid,
    }


def generate_dataset(n_events: int, seed: int = 0, **kwargs) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [generate_event(rng, **kwargs) for _ in range(n_events)]
