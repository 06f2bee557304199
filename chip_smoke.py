#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``hierarchicalgnn_torch`` (never JAX or the JAX package) through
five phases and fails if any of them fails:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA source of the port for sm_90a;
  3. kernels  each kernel against its plain PyTorch version at the
              flagship shapes (ragged rows, empty rows, a row of degree
              > 4096), in bf16 and f32, with times beside the bytes bound
              and one PyTorch library call;
  4. serving  the BC-HGNN-GMM flagship (latent 256, hidden 512, 6 + 6
              iterations, bf16, capacities 24576/49152/3072/4096, seeded
              weights) reconstructs 3 synthetic events of 3000 particles
              through ``InferenceEngine.reconstruct``; the launch counts
              show the path went through the kernels;
  5. parity   the same forward in f32 through the kernels and through the
              plain versions on the card: IN-block embeddings agree and
              the clusters are equal.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

# Flagship serving capacities (scripts/profile_bc_step.py:41-45).
FLAGSHIP = {"n_nodes_max": 24576, "n_edges_max": 49152, "max_clusters": 3072,
            "max_particles": 4096}
N_PARTICLES = 3000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM non-tensor f32
SOURCE = "hierarchicalgnn_torch/csrc/segment_csr.cu"
REPLACES = {
    "K1": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:148",
    "K2": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:252",
    "K5": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:390",
}
NAMES = {"K1": "K1 sorted_aggregate", "K2": "K2 sorted_aggregate_weighted",
         "K5": "K5 sorted_segment_min_i32"}
SUM_TOL = 1e-4  # f32 accumulation in another order: 1e-4 of the row's sum of |terms|


def log(msg):
    print(msg, flush=True)


def time_ms(torch, fn, iters=20):
    """Mean device ms per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_receivers(torch, e, n, gen):
    """Receivers with empty rows (every row = 3 mod 7) and one hot row of
    degree 5000 (> 4096); ~2% of the edges invalid."""
    r = torch.randint(0, n, (e,), generator=gen)
    r = torch.where(r % 7 == 3, (r + 1) % n, r)
    r[:5000] = 5
    s = torch.randint(0, n, (e,), generator=gen)
    m = torch.rand(e, generator=gen) >= 0.02
    return s, r, m


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build():
    from hierarchicalgnn_torch.ops.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} source(s) compiled in {time.perf_counter() - t0:.1f} s")
    for source, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")
    build.library()


def phase_kernels(torch):
    """Each kernel against its plain version; returns {kernel: row}."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    rows = {}

    def bound_ms(n_bytes, n_ops):
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")

    # (kernel, name of the shape, E, N, D): the flagship serving shapes
    sum_cases = [("K1", "flat edges->nodes", 98304, 24576),
                 ("K2", "bipartite nodes->clusters (b1)", 122880, 3072),
                 ("K2", "bipartite clusters->nodes (b2)", 122880, 24576),
                 ("K2", "super graph", 61440, 3072)]
    d = 256
    for kernel, label, e, n in sum_cases:
        s, r, m = ragged_receivers(torch, e, n, gen)
        plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
        n_valid = int(plan.row_ptr[-1])
        w = plan.sort(torch.rand(e, generator=gen).to(dev) * 2.9 + 0.1)
        for dtype in (torch.bfloat16, torch.float32):
            data = plan.sort(torch.randn(e, d, generator=gen).to(dev, dtype))
            if kernel == "K1":
                fn = lambda: sa.sorted_aggregate(data, plan)
                plain = lambda: sa.sorted_aggregate_plain(data, plan)
                abs_sum = sa.sorted_aggregate_plain(data.abs(), plan)
                recv = plan.receivers_sorted[:n_valid]
                d32 = data[:n_valid].float()
                library = lambda: torch.zeros((n, d), device=dev).index_add_(0, recv, d32)
                library_call = "index_add_ (f32 copy of the data)"
                n_bytes = n_valid * d * data.element_size() + 4 * (n + 1) + 4 * n * d
            else:
                fn = lambda: sa.sorted_aggregate_weighted(data, w, plan)
                plain = lambda: sa.sorted_aggregate_weighted_plain(data, w, plan)
                abs_sum = sa.sorted_aggregate_weighted_plain(data.abs(), w, plan)
                with warnings.catch_warnings():  # beta-state notices
                    warnings.simplefilter("ignore", UserWarning)
                    csr = torch.sparse_csr_tensor(plan.row_ptr.long(),
                                                  torch.arange(n_valid, device=dev),
                                                  w[:n_valid], size=(n, e))
                d32 = data.float()
                library = lambda: csr @ d32
                library_call = "sparse CSR @ dense (f32 copy of the data)"
                n_bytes = (n_valid * d * data.element_size() + 4 * n_valid
                           + 4 * (n + 1) + 4 * n * d)
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs()
            ok = bool((err <= SUM_TOL * abs_sum + 1e-6).all())
            assert (out[3::7] == 0).all(), f"{kernel} wrote to an empty row"
            ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                    time_ms(torch, library))
            b_ms, b_by = bound_ms(n_bytes, n_valid * d * (2 if kernel == "K2" else 1))
            log(f"{kernel} {label} {str(dtype)[6:]} E={e} N={n} D={d}: max_abs_err "
                f"{float(err.max()):.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"library_ms {lib_ms:.4f} [{library_call}] bound_ms {b_ms:.4f} ({b_by})")
            if not ok:
                raise AssertionError(f"{kernel} {label} {dtype} disagrees with its plain "
                                     f"version beyond {SUM_TOL} of |terms|")
            first = kernel not in rows
            if first and dtype == torch.bfloat16:
                rows[kernel] = {"max_abs_err": float(err.max()), "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": lib_ms,
                                "shape": f"{label} bf16 E={e} N={n} D={d}"}

    e, n = 98304, 24576
    s, r, m = ragged_receivers(torch, e, n, gen)
    plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
    n_valid = int(plan.row_ptr[-1])
    vals = plan.sort(torch.randint(0, n, (e,), generator=gen, dtype=torch.int32).to(dev))
    vals = torch.where(plan.edge_mask_sorted, vals, sa.INT32_MAX)
    fn = lambda: sa.sorted_segment_min_i32(vals, plan)
    plain = lambda: sa.sorted_segment_min_i32_plain(vals, plan)
    recv = plan.receivers_sorted[:n_valid]
    vv = vals[:n_valid].contiguous()
    library = lambda: torch.full((n,), sa.INT32_MAX, dtype=torch.int32,
                                 device=dev).scatter_reduce_(0, recv, vv, "amin")
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K5 disagrees with its plain version")
    assert (out[3::7] == sa.INT32_MAX).all(), "K5 wrote to an empty row"
    ms, plain_ms, lib_ms = time_ms(torch, fn), time_ms(torch, plain), time_ms(torch, library)
    b_ms, b_by = bound_ms(4 * n_valid + 4 * (n + 1) + 4 * n, n_valid)
    log(f"K5 CC hop int32 E={e} N={n}: exact, ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} [scatter_reduce_ amin] bound_ms {b_ms:.4f} ({b_by})")
    rows["K5"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": lib_ms,
                  "shape": f"CC hop int32 E={e} N={n}"}
    return rows


def phase_serving(torch):
    """Full-width bf16 serving of 3 events; returns the launch counts and
    the kernels' mean device ms per launch on the serving inputs."""
    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.utils.config import load_config

    hp = load_config("bc_hgnn_gmm", FLAGSHIP)
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"]) == (
        256, 512, 6, 6, "bfloat16"), hp
    engine = InferenceEngine(hp, build_model(hp, seed=0))
    events = [generate_event(np.random.default_rng(seed), n_particles=N_PARTICLES)
              for seed in range(3)]
    engine.reconstruct(events[0])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    sa.reset_launches()
    event_ms = []
    for seed, raw in enumerate(events):
        before = dict(sa.LAUNCHES)
        t0 = time.perf_counter()
        cands, metrics = engine.reconstruct(raw, return_metrics=True)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        event_ms.append(ms)
        counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
        stats = engine.last_stats
        log(f"serve event seed={seed} hits={len(raw['pid'])}: {ms:.1f} ms (host clock, "
            f"preprocess + forward + candidates), n_clusters={stats['n_clusters']}, "
            f"candidates={cands.shape[1]}, host_syncs={stats['host_syncs']}, "
            f"launches={counts}, metrics={metrics}")
        assert cands.shape[0] == 2 and cands.shape[1] > 0, cands.shape
        assert counts["K1"] == 12, counts
        assert counts["K2"] == 19, counts
        assert counts["K5"] >= 2, counts
    totals = dict(sa.LAUNCHES)
    log(f"serving launches over 3 events: {totals}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    per_launch = profile_forward(torch, engine, events[0], event_ms[0])

    # outputs of one event: finite, of the expected shapes
    hp_n, cap = hp["n_nodes_max"], hp["n_nodes_max"] * hp["bipartitegraph_sparsity"]
    bgraph, scores, emb, aux = engine.forward(preprocess_event(events[0], hp, stage="test"))
    assert scores.shape == (cap,) and emb.shape == (hp_n, hp["emb_dim"])
    assert bool(torch.isfinite(scores).all()) and bool(torch.isfinite(emb).all())
    assert bool(bgraph.edge_mask.any()) and 1 <= aux["n_clusters"]
    return totals, per_launch


def profile_forward(torch, engine, raw, wall_ms):
    """Device time by kernel over one reconstruct (torch.profiler), against
    ``wall_ms``, the same reconstruct's host-clock time without the
    profiler; returns {kernel: mean device ms per launch on the serving
    inputs}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.reconstruct(raw)
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = lambda ev: getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(ev) for ev in events) / 1e3
    if busy_ms == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return {}
    log(f"profile of one reconstruct: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"unprofiled host clock (idle share {100 * (1 - busy_ms / wall_ms):.1f}%), "
        f"{len(events)} kernel names, {sum(ev.count for ev in events)} launches")
    for ev in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"  {dev_us(ev) / 1e3:8.3f} ms  x{ev.count:<5d} {ev.key[:110]}")
    per_launch = {}
    for kernel, tag in (("K1", "csr_sum_kernel<__nv_bfloat16, false>"),
                        ("K2", "csr_sum_kernel<__nv_bfloat16, true>"),
                        ("K5", "csr_min_i32_kernel")):
        hits = [ev for ev in events if tag in ev.key]
        n = sum(ev.count for ev in hits)
        if n:
            per_launch[kernel] = sum(dev_us(ev) for ev in hits) / 1e3 / n
            log(f"  {kernel}: {n} launches, {per_launch[kernel]:.4f} ms per launch")
    return per_launch


def phase_parity(torch):
    """f32 forward through the kernels vs through the plain versions."""
    from unittest import mock

    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models import blocks
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.ops import connected
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.utils.config import load_config

    hp = load_config("bc_hgnn_gmm", {**FLAGSHIP, "compute_dtype": None})
    engine = InferenceEngine(hp, build_model(hp, seed=0))
    batch = preprocess_event(generate_event(np.random.default_rng(0),
                                            n_particles=N_PARTICLES), hp, stage="test")
    kern = engine.forward(batch)
    with mock.patch.object(blocks, "sorted_aggregate", sa.sorted_aggregate_plain), \
            mock.patch.object(blocks, "sorted_aggregate_weighted",
                              sa.sorted_aggregate_weighted_plain), \
            mock.patch.object(connected, "sorted_segment_min_i32",
                              sa.sorted_segment_min_i32_plain):
        before = dict(sa.LAUNCHES)
        plain = engine.forward(batch)
        assert sa.LAUNCHES == before, "the plain run launched a kernel"
    emb_err = float((kern[2] - plain[2]).abs().max())
    log(f"parity f32: embeddings max_abs_err {emb_err:.3e}, n_clusters "
        f"{kern[3]['n_clusters']} vs {plain[3]['n_clusters']}")
    if emb_err > 1e-4:
        raise AssertionError(f"IN-block embeddings differ by {emb_err}")
    if not torch.equal(kern[3]["clusters"], plain[3]["clusters"]):
        raise AssertionError("clusters differ between the kernel and plain paths")
    if all(torch.equal(a, b) for a, b in zip(kern[0], plain[0])):
        log(f"parity f32: bipartite graphs equal, scores max_abs_err "
            f"{float((kern[1] - plain[1]).abs().max()):.3e}")
    else:
        # the plain index_add_ sums in a run-dependent order; a kNN near-tie
        # in the bipartite graph can then pick another neighbour
        differ = int((kern[0].receivers != plain[0].receivers).sum())
        log(f"parity f32: bipartite graphs differ in {differ} of "
            f"{kern[0].receivers.numel()} receiver slots (kNN near-ties)")


def main():
    if not (Path(__file__).resolve().parent / "hierarchicalgnn_torch").is_dir():
        raise SystemExit("hierarchicalgnn_torch/ is not beside chip_smoke.py: "
                         "run it from a checkout of the repo")
    import torch

    phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    launches, per_launch = phase_serving(torch)
    phase_parity(torch)
    table = [{"name": NAMES[k], "route": "cuda", "source": SOURCE,
              "replaces": REPLACES[k], "launches": launches[k], **rows[k],
              "main_path_ms_per_launch": per_launch.get(k)}
             for k in ("K1", "K2", "K5")]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
