"""Traffic: a pool of synthetic detector events made from the seed.

``generate_event`` draws what the port's generator
(``hierarchicalgnn_torch/data/synthetic.py``) draws, with the same
distributions, in bulk: helical tracks of 3 to 10 hits through ten
cylindrical layers (log-uniform pT, curvature 0.3 / pT), 10% noise hits
(pid 0), and a candidate graph of the true adjacencies plus as many random
fakes.  It draws whole arrays where the port's draws particle by particle,
so one seed gives other events than the port's generator would, in a tenth
of the time; the generator lives here so that a change to the program
cannot change the benchmark's inputs.  A traffic file
(``portbench/traffic/*.json``) gives the pool's size and the parameters,
and may fix the pool and the weights (``pool_seed``, ``weights_seed``) where
the seed would otherwise change the work: BC-HGNN-GMM's auction took
105 to 172 rounds a step by the weights drawn.
"""

from __future__ import annotations

import numpy as np

LAYER_RADII = np.array([32, 72, 116, 172, 260, 360, 500, 660, 820, 1020],
                       dtype=np.float32) / 1000.0


def generate_event(rng: np.random.Generator, n_particles: int = 120,
                   noise_fraction: float = 0.1, pt_min: float = 0.1,
                   pt_max: float = 5.0, fake_edge_ratio: float = 1.0) -> dict:
    """One raw event dict (the reference's TrackML schema)."""
    n = n_particles
    pt = np.exp(rng.uniform(np.log(pt_min), np.log(pt_max), n))
    phi0 = rng.uniform(0, 2 * np.pi, n)
    cot_theta = rng.normal(0.0, 1.2, n)
    z0 = rng.normal(0.0, 0.05, n)
    curvature = rng.choice([-1.0, 1.0], n) * 0.3 / np.maximum(pt, 0.05)
    n_layers = rng.integers(3, len(LAYER_RADII) + 1, n)
    primary = (rng.random(n) < 0.7).astype(np.int64)

    particle = np.repeat(np.arange(n), n_layers)        # hit -> particle
    first = np.cumsum(n_layers) - n_layers
    layer = np.arange(particle.shape[0]) - first[particle]
    r = LAYER_RADII[layer]
    phi = phi0[particle] + curvature[particle] * r + rng.normal(0.0, 0.002, r.shape)
    z = z0[particle] + cot_theta[particle] * r + rng.normal(0.0, 0.002, r.shape)
    hits = particle.shape[0]
    n_noise = int(hits * noise_fraction)
    noise_r = rng.choice(LAYER_RADII, n_noise)
    x = np.concatenate([
        np.stack([r, np.sin(phi), z], 1),
        np.stack([noise_r, np.sin(rng.uniform(0, 2 * np.pi, n_noise)),
                  rng.normal(0.0, 1.0, n_noise)], 1)]).astype(np.float32)
    pid = np.concatenate([particle + 1, np.zeros(n_noise, np.int64)])
    pt_hit = np.concatenate([pt[particle], np.zeros(n_noise)]).astype(np.float32)
    primary_hit = np.concatenate([primary[particle], np.zeros(n_noise, np.int64)])
    hit_count = hits + n_noise

    inner = np.flatnonzero(layer[1:] > 0)             # hit i -> i + 1 on one track
    mw_edges = np.stack([inner, inner + 1]).astype(np.int64)

    _, inv_u, counts = np.unique(pid, return_inverse=True, return_counts=True)
    nhits = counts[inv_u]
    sig_edges = mw_edges[:, (nhits[mw_edges] >= 5).all(0)]

    n_fake = int(mw_edges.shape[1] * fake_edge_ratio)
    f_src = rng.integers(0, hit_count, n_fake)
    f_dst = rng.integers(0, hit_count, n_fake)
    ok = f_src != f_dst
    edge_index = np.concatenate([mw_edges, np.stack([f_src[ok], f_dst[ok]])], axis=1)
    edge_index = edge_index[:, rng.permutation(edge_index.shape[1])].astype(np.int64)

    true_keys = mw_edges[0] * hit_count + mw_edges[1]
    y = (np.isin(edge_index[0] * hit_count + edge_index[1], true_keys)
         | np.isin(edge_index[1] * hit_count + edge_index[0], true_keys))
    y_pid = (pid[edge_index[0]] == pid[edge_index[1]]) & (pid[edge_index[0]] != 0)

    return {
        "x": x,
        "cell_data": np.zeros((hit_count, 1), np.float32),
        "pid": pid,
        "hid": np.arange(hit_count, dtype=np.int64),
        "pt": pt_hit,
        "primary": primary_hit,
        "edge_index": edge_index,
        "modulewise_true_edges": mw_edges,
        "signal_true_edges": sig_edges,
        "y": y,
        "y_pid": y_pid,
    }


def make_pool(seed: int, traffic: dict) -> list[dict]:
    """``traffic["pool_events"]`` raw events, each of ``n_particles``
    particles with the file's noise and fake-edge ratio: drawn from
    ``seed``, or, where the traffic names a ``pool_seed``, drawn from that
    and put in an order drawn from ``seed`` (the same work for every seed)."""
    rng = np.random.default_rng(traffic.get("pool_seed", seed))
    pool = [generate_event(rng, n_particles=traffic["n_particles"],
                           noise_fraction=traffic["noise_fraction"],
                           fake_edge_ratio=traffic["fake_edge_ratio"])
            for _ in range(traffic["pool_events"])]
    if "pool_seed" in traffic:
        pool = [pool[i] for i in np.random.default_rng(seed).permutation(len(pool))]
    return pool


def weights_seed(seed: int, traffic: dict) -> int:
    """The seed the weights are drawn from: the run's, or the traffic's
    ``weights_seed`` where it names one."""
    return int(traffic.get("weights_seed", seed))
