#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``hierarchicalgnn_torch`` (never JAX or the JAX package) through
these phases and fails if any of them fails:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA source of the port for sm_90a;
  3. kernels  each kernel (K1-K8) against its plain PyTorch version at the
              shapes the models give it (the flagship's at latent 256, the
              other models' at latent 128 and bipartite k 8, the mined-pair
              hinge's at width 8; ragged rows, empty rows, a row of degree
              > 4096), in bf16 and f32, with times beside the bytes bound
              and one PyTorch library call; K1-K5 also at the shapes one
              rank of the sharded forwards and training steps gives them
              (receiver-partitioned buffers of 36864 flat edges into 6144
              nodes and 23552 superedges into 768 supernodes, with the
              slack's padding at the tail; the rank's block of the bipartite
              graph into 3072 and 6144 rows; K1 as the backward of the halo,
              bipartite and superedge gathers), K6 at one rank's block of the
              row-sharded auction (1024 and 2048 of 3072 columns), each
              K1/K2 row with its device time per call from the profiler (tile
              kernel + fix-up) and two calls compared bit for bit; K1 and K2
              on the inputs that put row ends on every kind of tile boundary
              (``tile_cases``: a row of one tile, rows ending on boundaries,
              E < T, no valid slot, no slot, a ragged last tile, hub rows of
              degree 5000 and 50000); K7 also at widths that are no
              whole 16-byte vectors; ``make_aggregator`` six times over one
              gather layout (K7's entry point); K8, the all-gather between
              the ranks of a shard group, exactly, at P 1, 2, 3, 4 and 8, in
              f32, bf16, int32 and bool, 2-D and 1-D, at block sizes and bases
              that are no multiple of 16 bytes, at every block shape the
              sharded forwards hand it, 50 calls back to back on one set of
              buffers, and two groups on two streams.  Phases 12-15 and 20-25
              record the inputs they hand K1-K6 and K8 (``path_keys``) and
              fail on one whose shape and type were not checked here
              (phase 25's at 2 ranks a process: ``PROCESS_GRAPH``);
 3b. hdbscan  HD1 (core distances) and HD2 (Prim's MST), the kernels of the
              embedding models' HDBSCAN, against their plain versions on the
              card: on the embeddings of one served Embedding-IN event (N
              about 21.2k, D 8), on coordinates quantised to 0.5 (ties), on
              N = min_cluster_size points, on identical points, on unit
              vectors around 400 centres and on 700 points of one feature.
              HD1 bit for bit; HD2's cluster route (the size the card's
              occupancy query gives, printed) and, on the served event, its
              cooperative route element for element (src, dst, the
              distances' bits); the labels of ``hdbscan_labels`` equal; on
              80000 random points (above the cluster's capacity) HD1 bit for
              bit and ``prim_mst`` on the cooperative route by the route
              counters, its tree checked by invariants (N - 1 edges, every
              node but 0 reached once, every weight recomputed bit for bit);
              HD1 (with its S and Q), both HD2 routes and the host tree timed
              on the served event, with each route's step floor (the same N
              at D 1);
 3c. knn      KNN1, the kNN's k-selection, against its plain version (the
              four elementwise passes and the stable sort's first k) bit for
              bit on one block of each main-path shape: Embedding-IN's pair
              mining on the embeddings of a served event (1024 x 24576, k
              100) and BC's bipartite (1024 x 3072, k 5) and super (3072 x
              3072, k 10) graphs on cluster means, 2048 of 3072 valid; the
              whole ``knn`` of each equal to the plain path's; the kernel
              timed beside its bound, the plain version, ``torch.topk`` on
              the same d2 and the block's GEMM, and the whole ``knn`` on both
              paths; then one BC and one Embedding-IN training step with
              their KNN1 launches counted;
  4. serving  the BC-HGNN-GMM flagship (latent 256, hidden 512, 6 + 6
              iterations, bf16, capacities 24576/49152/3072/4096, seeded
              weights) reconstructs 2 synthetic events of 3000 particles
              through ``InferenceEngine.reconstruct``; the launch counts
              show the path went through the kernels;
  5. parity   the same forward in f32 through the kernels and through the
              plain versions on the card: IN-block embeddings agree and
              the clusters are equal;
  6. gradients  each kernel-backed ``autograd.Function`` (K7's too) against
              autograd through its plain version, f32, at the flagship shapes;
  7. auction  a seeded sparse matching instance of the warm flagship shape
              (3001 x 2633 of 4096 x 3072) on the card with kernel K6,
              against scipy's exact matching on the host;
  8. training 3 steps of the same flagship through ``Trainer.train_step``
              (forward in training mode, auction truth, loss, backward
              through the kernels, clip, AdamW-amsgrad, buffer updates);
              the launch counts per step are asserted;
  9. training parity  one f32 step at depth 2 + 2 through the kernels and
              through the plain versions: loss and gradient norm agree;
 10. models   EC-IN, Embedding-IN, Embedding-HGNN-GMM and gMRT from
              ``model_selector`` at their shipped configs (bf16) and the
              flagship capacities: one served event and 2 training steps
              each, launch counts asserted (the embedding models serve
              through ``reconstruct``: their HDBSCAN candidates, non-empty,
              with HD1 and HD2 launched once, HD2 by the cluster
              route), and the mined-pair hinge
              through the sorted plan beside autograd's index backward;
 11. models parity  the f32 forward of Embedding-HGNN-GMM at depth 2 + 2
              through the kernels and through the plain versions, on one
              super and bipartite graph;
 12. halo     the flat-IN halo demonstration (``parallel/halo.py``) over 4
              ranks with K8 as the halo, against the unsharded step;
 13. sharded serving  the flagship's graph-partitioned forward
              (``parallel.graph_shard.make_sharded_forward``: 4 ranks that
              share the card, pooled space partitioned, ``halo_backend: rdma``)
              on 2 events, with the launch counts of K1, K2, K5 and K8 asserted;
 14. sharded parity  f32 at depth 2 + 2 over 4 ranks against the unsharded
              forward of the same weights, for both ``shard_pooled`` values,
              and ``rdma`` against ``xla`` halo bit for bit;
 15. sharded models  one sharded event for each of the other four models at
              its shipped widths, K8 counts asserted;
 16. cli      ``python -m hierarchicalgnn_torch.run`` as ``run.main`` at the
              flagship's width (capacities and 3000-particle events as in
              phase 4, ``train_split [2,1,1]``): ``train`` 2 epochs, then
              ``checkpoints/{last,best,hparams.json}`` and ``metrics.jsonl``
              checked, ``resume`` to epoch 3, ``test`` (its ``track_eff``
              line), ``transfer`` BC -> gMRT for 1 epoch; then ``train
              --model 2`` (Embedding-IN) 1 epoch and ``test``, whose
              ``track_eff`` and ``test_track_eff`` (HDBSCAN candidates on the
              card) are finite; then the flagship's ``train`` 1 epoch over
              ``mesh_shape {data 1, graph 4}`` (rdma) with ``--devices
              cuda:0,cuda:0,cuda:0,cuda:0``: every sharded forward placed its
              ranks there, ``partition_ok`` at every step, the log finite
              with ``score_cut`` below the clamp; K1-K6, K8, HD1 and HD2
              launched;
 17. checkpoint  f32 at depth 2 + 2 under deterministic algorithms: a save
              at step 1 restored into a fresh ``Trainer`` takes step 2 as
              the saving trainer did (loss and every parameter compared), and
              ``InferenceEngine.from_run`` serves the restored run with the
              trainer's scores;
 18. grid knn ``grid_knn_graph`` against the brute ``knn_graph`` on a seeded
              Embedding-IN's embeddings (N 24576, k 100) and on a clustered
              cloud of 131072 points (M 512, T 16, cap 512), edges equal
              where ``exact``, both timed; then 2 Embedding-IN training steps
              with ``knn_backend: grid``;
 19. streaming  ``write_event`` 3 events, then ``Trainer.fit_streaming`` one
              epoch of 2 steps through the loader g++ builds from
              ``native/hgnn_io.cc``;
 20. sharded training  the flagship (as phase 4: bf16, full width and depth)
              through ``Trainer.train_step`` with ``mesh_shape {data 1, graph
              4}``, ``halo_backend: rdma``, ``shard_pooled`` and
              ``shard_matching`` on: a warm-up and 2 timed steps, each with its
              host ms, device busy and idle share, peak memory, auction rounds
              and launches; K1-K6 and K8 must launch;
 21. sharded training parity  f32, depth 2 + 2, full width and capacities,
              4 ranks: one sharded step against the unsharded step (loss,
              every gradient, every buffer) for both ``shard_pooled`` values,
              ``rdma`` against ``xla`` (forward bit for bit, gradients), and
              the row-sharded auction against the unsharded one on phase 7's
              instance with ``eps`` pinned;
 22. sharded models training  one sharded step of each of the other four
              models at its shipped widths, K8 counted, and one ``Trainer.fit``
              epoch of the flagship over ``mesh_shape {data 2, graph 4}``;
 23. tp training  the flagship (as phase 4) through
              ``parallel.tp.make_tp_train_step`` over ``{data 1, model 4}``
              (each rank 128 of the 512 hidden columns of every MLP): a
              warm-up and 2 timed steps with host ms, device busy and idle
              share, peak memory, launches and collectives by kind; K1-K6
              must launch; the bf16 TP loss against the unsharded bf16 and f32
              losses of the same weights; one TP step of each other model;
 24. tp parity  f32 (remat on), depth 2 + 2, full width: the TP step over
              ``{data 1, model 4}`` and ``{data 2, model 4}`` against the
              unsharded ``make_dp_train_step`` (loss within 1e-4 relative,
              every parameter after the step within rtol 5e-4 / atol 1e-5),
              and once with the clip acting (``grad_norm`` within 1e-4);
 25. processes  the ``data`` axis over a ``torch.distributed`` group: this
              script starts 2 workers of itself (``--process-worker``) on the
              one card, joined over gloo on CUDA tensors through a
              ``file://`` store: (a) the flagship (as phase 4) through
              ``make_sharded_train_step`` over ``{data 2 across the processes,
              graph 2 in each}``, ``halo_backend: rdma``, 2 timed steps: the
              processes' losses equal bit for bit, their states identical
              (``assert_host_identical``), K1-K6 and K8 launched in each,
              with host ms, device busy, peak memory and the cross-process
              all-gather's count, bytes and host ms; (b) its f32 parity at
              depth 2 + 2 against one process's ``{data 2, graph 2}`` step
              (the JAX test's bounds); (c) EC-IN's DP step over ``{data 2}``
              and TP step over ``{data 2, model 2}``, losses equal; (d) one
              worker alone over ``nccl`` takes (c)'s DP step.  The processes
              time-share the card: the phase measures the path's cost on one
              card, not a step over two.
 26. multicard  ranks on several cards: the card count, each card's
              nvidia-smi line and the peer-access matrix; (a) K8 at P 4 on
              the halo input (bf16, f32) as 2 launches of 2 ranks and 4 of 1
              on streams of card 0, grids capped at their share, exact, timed
              beside one launch (``k8_timings``: ms a call, host us a call
              over 100 calls enqueued without a wait, device ms a launch,
              block 0's entry spin and run); (b) a launch whose peer sleeps past a 2 s
              bound gives up, the next call raises, fresh flags are exact;
              (c) ``devices=[cuda:0] * 4`` against ``devices=None``: the f32
              2 + 2 sharded forward's outputs, the step's loss, buffers and
              launch counts bit for bit, gradients within phase 21's bound;
              (d) with 2 or more cards, the flagship's ranks on min(4,
              count) cards: K8 exact on every card and timed, the f32 2 + 2
              sharded forward, step and TP step against one card, bf16 events
              and steps with host ms, peak GiB and idle share per card beside
              the one-card run; K8's library time (``torch.cuda.nccl``'s
              all-gather, one call over the cards, its output equal to K8's,
              its host us), K8 timed again after it;
              the f32 step over the cards three times, twice under a probe
              that hashes the gradient at every seam of the ranks' graphs;
              (e) with 2 or more cards, 2 processes over NCCL, each bound to
              cards of its own (phase 25's worker): the flagship's step over
              ``{data 2, graph 2}``, losses and states equal, one gather a
              step, K1-K6 and K8 in each, per-card busy, idle and peak, the
              gather alone; its f32 2 + 2 step against one process over the
              same cards; K8 at each process's P 2 over its 2 cards (2
              launches a call) timed beside NCCL's all-gather of the same
              blocks; (f) with 4 cards, the CLI: ``train`` 1 epoch over
              ``--devices cuda:0,cuda:1,cuda:2,cuda:3``, ``resume`` to epoch
              2 and ``test``, its log against the one-card ``--devices`` run;
              with fewer cards each of (d)-(f) prints that it did not run.
              ``python3 chip_smoke.py --multicard`` runs this phase alone.

Each phase prints its seconds on a line of its own, and the script its
total before the kernel table.

The second-to-last line is the kernel table as JSON (K1-K8 and K8's
split-launch rows (with several cards, its row over them), then HD1, HD2
and KNN1, which replace no Pallas kernel); the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import math
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

# Flagship serving capacities (scripts/profile_bc_step.py:41-45).
FLAGSHIP = {"n_nodes_max": 24576, "n_edges_max": 49152, "max_clusters": 3072,
            "max_particles": 4096}
N_PARTICLES = 3000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM non-tensor f32
# H100 SXM non-tensor f64: the data sheet's 34 TFLOP/s counts an FMA as two
# operations; HD1/HD2 issue a separate sub, mul and add, each one operation
# at the FMA's instruction rate, so half of it
F64_OPS_PER_S = 34e12 / 2
CSRC = "hierarchicalgnn_torch/csrc/"
SOURCES = {"K1": "segment_csr.cu", "K2": "segment_csr.cu", "K5": "segment_csr.cu",
           "K3": "sddmm_csr.cu", "K4": "sddmm_csr.cu", "K6": "top2.cu",
           "K7": "segment_gather.cu", "K8": "ring_gather.cu",
           "HD1": "hdbscan.cu", "HD2": "hdbscan.cu", "KNN1": "knn_select.cu"}
REPLACES = {
    "K1": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:148",
    "K2": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:252",
    "K5": "hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:390",
    "K3": "hierarchicalgnn_tpu/ops/pallas/sddmm_kernel.py:63",
    "K4": "hierarchicalgnn_tpu/ops/pallas/sddmm_kernel.py:133",
    "K6": "hierarchicalgnn_tpu/ops/pallas/top2.py:31",
    "K7": "hierarchicalgnn_tpu/ops/pallas/segment_kernel.py:114",
    "K8": "hierarchicalgnn_tpu/ops/pallas/ring_gather.py:32",
    "HD1": "sklearn.cluster.HDBSCAN (host) via hierarchicalgnn_tpu/evaluation/candidates.py:43",
    "HD2": "sklearn.cluster.HDBSCAN (host) via hierarchicalgnn_tpu/evaluation/candidates.py:43",
    "KNN1": "XLA's sort (lax.top_k) in hierarchicalgnn_tpu/ops/knn.py",
}
NAMES = {"K1": "K1 sorted_aggregate", "K2": "K2 sorted_aggregate_weighted",
         "K5": "K5 sorted_segment_min_i32", "K3": "K3 sorted_sddmm",
         "K4": "K4 scaled_gather", "K6": "K6 row_top2", "K7": "K7 csr_segment_sum",
         "K8": "K8 ring_all_gather"}
# the kernels of the embedding models' HDBSCAN: no Pallas counterpart
HD_NAMES = {"HD1": "HD1 core_distances", "HD2": "HD2 prim_mst"}
# the kNN's k-selection: no Pallas counterpart either
KNN_NAMES = {"KNN1": "KNN1 knn_select"}
# the kernels' names in a profiler trace (K1/K2: the bf16 tile kernel, K7 its
# tile kernel; the fix-up, a second device launch of the same call, is
# FIXUP_TAGS)
PROFILE_TAGS = {"K1": "csr_tile_sum_kernel<__nv_bfloat16, false>",
                "K2": "csr_tile_sum_kernel<__nv_bfloat16, true>",
                "K5": "csr_min_i32_kernel", "K3": "sddmm_kernel<",
                "K4": "scaled_gather_kernel<", "K6": "row_top2_kernel",
                "K7": "csr_gather_tile_kernel<", "K8": "all_gather_kernel<",
                "HD1": "core_distance_kernel<", "HD2": "prim_mst_cluster_kernel<",
                "KNN1": "knn_radix_kernel<"}
# HD2's cooperative route (N above the cluster's capacity) in a trace
COOP_TAG = "prim_mst_kernel"
FIXUP_TAGS = {"K1": "csr_tile_fixup_kernel<__nv_bfloat16, false>",
              "K2": "csr_tile_fixup_kernel<__nv_bfloat16, true>",
              "K7": "csr_gather_fixup_kernel<"}
SUM_TOL = 1e-4  # f32 accumulation in another order: 1e-4 of the row's sum of |terms|
DOT_TOL = 1e-5  # K3's f32 dot of up to 256 terms, K4's single product: 1e-5 of the sum of |terms|
TRAIN_EPOCH = 50  # of emb_epoch 100: both losses carry weight on the sine schedule
MODELS_EPOCH = 15  # of intermediate_epoch 30: the same for the hierarchical embedding loss
SCORE_CUT_CLAMP = 8.38  # atanh(1 - 1e-7): a score_cut there means collapsed clustering
N_PARTS = 4  # ranks of the sharded phases; they share the one card before phase 26
# Per-rank blocks that the sharded forwards of the five models hand K8 at
# N_PARTS ranks and the flagship capacities (n_local 6144, e_cap 36864, c_local
# 768): hit features, embeddings, node rows at latent 128 and 256, supernode
# rows, EC-IN's edge rows, and the 1-D masks, labels and likelihood.  Each is
# held against torch.cat in all four dtypes.
K8_PATH_SHAPES = ((6144, 3), (6144, 8), (6144, 128), (6144, 256), (768, 128), (768, 256),
                  (36864, 128), (6144,), (36864,))
PROCESS_GRAPH = 2  # graph ranks of each process in phase 25 (n_local 12288, e_cap 73728)
# the blocks the flagship's sharded step hands K8 at PROCESS_GRAPH ranks
K8_PROCESS_SHAPES = ((12288, 3), (12288, 8), (12288, 256), (1536, 256), (12288,), (73728,))
# (kernel, shape key) of every input that phase 3 held against the kernel's
# plain version (``path_keys`` gives the keys); the sharded phases record what
# they hand K1-K6 and K8 and fail on a key that is not here
PATH_CHECKED = set()
WATCHDOG_S = 300  # a phase that waits on K8's flags longer than this ends the run
GRID_FULL_N = 131072  # the grid kNN's full-event point (hierarchicalgnn_tpu/ops/grid_knn.py:33)
HD2_ABOVE_CAPACITY = 80000  # points above HD2's cluster capacity at D 8 (16 x 1024 x 4 = 65536)


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


def _device_us(ev):
    return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, tags, iters=10):
    """Device ms per launch of the kernels whose names hold each of ``tags``
    (torch.profiler over ``iters`` calls of ``fn``, one launch of each a
    call, after one warm-up); None for a tag the profiler did not see.  The
    mean is over the launches the profiler reports: it has shown fewer than
    were made (2 of 3 and 2 of 5 calls of the HDBSCAN kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a second window if the first came back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
        found = {}
        for tag in tags:
            hits = [ev for ev in events if tag in ev.key]
            seen = sum(ev.count for ev in hits)
            found[tag] = sum(_device_us(ev) for ev in hits) / 1e3 / seen if seen else None
            if seen and seen != iters:
                log(f"  profiler: {seen} launches of {tag} in {iters} calls")
        if any(v is not None for v in found.values()):
            break
    return found


def tile_tags(kernel, dtype_name):
    """K1's or K2's tile kernel and fix-up, by name, for data of ``dtype_name``."""
    ctype = {"bfloat16": "__nv_bfloat16", "float32": "float"}[dtype_name]
    return tuple(tags[kernel].replace("__nv_bfloat16", ctype)
                 for tags in (PROFILE_TAGS, FIXUP_TAGS))


def tile_cases(tile):
    """K1/K2's boundary inputs at a tile of ``tile`` edges: (label, degree of
    each row, invalid slots)."""
    t = tile
    return [
        # rows ending on tile boundaries (t, 2t, 3t, 5t), an empty row on one,
        # a row of exactly one tile, one of exactly two, empty rows at the end
        ("rows that end on tile boundaries", [t // 2, t // 2, t, 0, t - 3, 3, 2 * t, 5, 0, 0], 4),
        ("one row of exactly one tile", [t], 0),
        ("a row that starts a tile and runs past its end", [t, t + 1, t - 1, 2], 3),
        ("E < T", [3, 0, 5, 1], 2),
        ("all slots invalid (row_ptr[N] = 0)", [0] * 50, 40),
        ("every row empty, no slots", [0] * 50, 0),
        ("the last tile ragged", [(37 * i) % 11 for i in range(300)], 13),
        ("hub rows of degree 5000 and 50000", [2, 5000, 0, 7, 50000, 1, 0, 3], 100),
    ]


def padded_for(sa, tile, degrees, n_invalid):
    """The invalid slots that make the K1/K2 wrapper cut these rows into
    tiles of ``tile`` edges (it sizes the tile from all E slots): at least
    ``n_invalid``, more where the rows alone are too few edges.  Rows of
    more edges than the tile's range get the next larger tile."""
    e_min = 0 if tile == sa.TILE_SIZES[-1] else (sa.MIN_TILES - 1) * tile + 1
    return max(n_invalid, e_min - sum(degrees))


def degree_plan(torch, degrees, n_invalid, dev, seed=0):
    """A sorted plan whose row ``i`` has ``degrees[i]`` edges, with
    ``n_invalid`` invalid slots, the slots handed over in a shuffled order."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    gen = torch.Generator().manual_seed(seed)
    n = len(degrees)
    r = torch.repeat_interleave(torch.arange(n), torch.tensor(degrees, dtype=torch.long))
    r = torch.cat([r, torch.randint(0, n, (n_invalid,), generator=gen)])
    m = torch.arange(r.shape[0]) < r.shape[0] - n_invalid
    order = torch.randperm(r.shape[0], generator=gen)
    s = torch.randint(0, n, (r.shape[0],), generator=gen)
    return sa.build_sorted_plan(s.to(dev), r[order].to(dev), m[order].to(dev), n)


def ragged_receivers(torch, e, n, gen):
    """Receivers with empty rows (every row = 3 mod 7) and one hot row of
    degree 5000 (> 4096); ~2% of the edges invalid."""
    r = torch.randint(0, n, (e,), generator=gen)
    r = torch.where(r % 7 == 3, (r + 1) % n, r)
    r[:5000] = 5
    s = torch.randint(0, n, (e,), generator=gen)
    m = torch.rand(e, generator=gen) >= 0.02
    return s, r, m


def partitioned_receivers(torch, e, n, gen, fill=2 / 3):
    """One rank's buffer as ``parallel.graph_shard.partition_edges`` fills it:
    about ``fill`` of the ``e`` slots valid (capacity is the slack's 1.5 times
    the mean share), the valid edges first and receiver-sorted, so that a
    sorted plan over them is the identity, the padding at the tail; rows as
    ragged as :func:`ragged_receivers` makes them."""
    s, r, m = ragged_receivers(torch, e, n, gen)
    m &= torch.rand(e, generator=gen) < fill
    order = torch.argsort(torch.where(m, r, n), stable=True)
    return s[order], r[order], m[order]


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
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  ptxas {source}: {line.strip()}")
    for source in build.SIGNATURES:
        build.library(source)


def phase_kernels(torch):
    """Each kernel against its plain version; returns {kernel: row}."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import SpmdSpec, edge_capacity

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    rows = {}

    def bound_ms(n_bytes, n_ops):
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")

    # (kernel, name of the shape, E, N, D, types): the flagship's serving
    # shapes first (the first bf16 row of a kernel goes into the table), then
    # the shapes the latent-128 models give the same kernels: their flat graph,
    # Embedding-HGNN-GMM's bipartite graph of k 8, its super graph
    both = (torch.bfloat16, torch.float32)
    sum_cases = [("K1", "flat edges->nodes", 98304, 24576, 256, both),
                 ("K2", "bipartite nodes->clusters (b1)", 122880, 3072, 256, both),
                 ("K2", "bipartite clusters->nodes (b2)", 122880, 24576, 256, both),
                 ("K2", "super graph", 61440, 3072, 256, both),
                 ("K1", "flat edges->nodes, latent 128", 98304, 24576, 128, both),
                 ("K2", "bipartite k 8 nodes->clusters, latent 128", 196608, 3072, 128, both),
                 ("K2", "bipartite k 8 clusters->nodes, latent 128", 196608, 24576, 128, both),
                 ("K2", "super graph, latent 128", 61440, 3072, 128, both)]
    # what one rank of the sharded forwards (4 ranks, the same capacities) gives
    # the same kernels.  Its flat edges and, with the pooled space partitioned,
    # its superedges come receiver-partitioned (identity plans, padding at the
    # tail): e_cap 36864 -> n_local 6144 and 23552 -> c_local 768.  Its block of
    # the bipartite graph (n_local * k edges in the kNN's order) goes into all
    # 3072 supernode rows and into its own 6144 node rows.  With the pooled
    # space replicated the super graph is the unsharded one above.
    rank_identity = [("K1", "per-rank flat edges->nodes", 36864, 6144, 256, both),
                     ("K2", "per-rank superedges", 23552, 768, 256, both),
                     ("K1", "per-rank flat edges->nodes, latent 128", 36864, 6144, 128, both),
                     ("K2", "per-rank superedges, latent 128", 23552, 768, 128, both)]
    rank_bipartite = [
        ("K2", "per-rank bipartite nodes->clusters", 6144 * 5, 3072, 256, both),
        ("K2", "per-rank bipartite clusters->nodes", 6144 * 5, 6144, 256, both),
        ("K2", "per-rank bipartite k 8 nodes->clusters, latent 128", 6144 * 8, 3072, 128, both),
        ("K2", "per-rank bipartite k 8 clusters->nodes, latent 128", 6144 * 8, 6144, 128, both)]
    # what the backward of one rank's training step gives K1 besides: the
    # halo gather's sender side over all P * n_local gathered node rows (and
    # Embedding-HGNN-GMM's f32 embeddings'), the
    # bipartite row gathers' over the rank's block (each direction's plan is
    # the other's transpose), the superedge gathers' over the rank's own 768
    # and all 3072 supernode rows, and the replicated super graph's
    rank_backward = [
        ("K1", f"per-rank halo gather backward{w}", 36864, 24576, d, both)
        for w, d in (("", 256), (", latent 128", 128))] + [
        ("K1", "per-rank halo gather backward, embeddings of width 8", 36864, 24576, 8,
         (torch.float32,))] + [
        ("K1", f"per-rank bipartite gather backward -> {to}{w}", 6144 * k, rows_to, d, both)
        for w, k, d in (("", 5, 256), (", k 8, latent 128", 8, 128))
        for to, rows_to in (("clusters", 3072), ("nodes", 6144))] + [
        ("K1", f"per-rank superedge gather backward -> {to}{w}", 23552, rows_to, d, both)
        for w, d in (("", 256), (", latent 128", 128))
        for to, rows_to in (("own supernodes", 768), ("all supernodes", 3072))] + [
        ("K1", f"super graph gather backward{w}", 61440, 3072, d, both)
        for w, d in (("", 256), (", latent 128", 128))]
    # the embedding pipeline's mined pairs (k 100 per hit and the doubled
    # truth edges) over the f32 embeddings of width 8, and Embedding-HGNN-GMM's
    # hinge over the event's 49152 edges: K1 is their gathers' backward
    hinge_cases = [("K1", "mined-pair hinge plan, emb 8", 24576 * 100 + 2 * 49152, 24576, 8,
                    (torch.float32,)),
                   ("K1", "edge-pair hinge plan, emb 8", 49152, 24576, 8, (torch.float32,))]
    # the unsharded step's bipartite row gathers: their backward is K1 over
    # each direction's plan (the flagship's k 5, Embedding-HGNN-GMM's k 8)
    bipartite_backward = [
        ("K1", f"bipartite gather backward -> {to}{w}", e, rows_to, d, both)
        for w, e, d in (("", 122880, 256), (", k 8, latent 128", 196608, 128))
        for to, rows_to in (("clusters", 3072), ("nodes", 24576))]
    # the same for one rank of phase 25's flagship step, PROCESS_GRAPH ranks a
    # process: n_local 12288, c_local 1536, e_cap 73728, superedges 46080
    p2 = PROCESS_GRAPH
    n2, c2 = 24576 // p2, 3072 // p2
    e2, s2 = (edge_capacity(e, SpmdSpec(n_parts=p2)) for e in (98304, 61440))
    rank_identity += [("K1", f"per-rank flat edges->nodes, {p2} ranks", e2, n2, 256, both),
                      ("K2", f"per-rank superedges, {p2} ranks", s2, c2, 256, both)]
    rank_bipartite += [
        ("K2", f"per-rank bipartite nodes->clusters, {p2} ranks", n2 * 5, 3072, 256, both),
        ("K2", f"per-rank bipartite clusters->nodes, {p2} ranks", n2 * 5, n2, 256, both)]
    rank_backward += [
        ("K1", f"per-rank halo gather backward, {p2} ranks", e2, 24576, 256, both),
        ("K1", f"per-rank bipartite gather backward -> nodes, {p2} ranks", n2 * 5, n2, 256,
         both),
        ("K1", f"per-rank superedge gather backward -> own supernodes, {p2} ranks", s2, c2, 256,
         both),
        ("K1", f"per-rank superedge gather backward -> all supernodes, {p2} ranks", s2, 3072,
         256, both)]
    all_cases = (sum_cases + rank_identity + rank_bipartite + rank_backward + hinge_cases
                 + bipartite_backward)
    for case in all_cases:
        kernel, label, e, n, d, dtypes = case
        if case in rank_identity:
            s, r, m = partitioned_receivers(torch, e, n, gen)
        else:
            s, r, m = ragged_receivers(torch, e, n, gen)
        plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
        n_valid = int(plan.row_ptr[-1])
        if case in rank_identity:
            assert torch.equal(plan.perm, torch.arange(e, device=dev)) and n_valid < 0.7 * e
        w = plan.sort(torch.rand(e, generator=gen).to(dev) * 2.9 + 0.1)
        for dtype in dtypes:
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
            assert torch.equal(fn(), out), f"{kernel} {label} {dtype}: two calls differ"
            ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                    time_ms(torch, library))
            # the device time per call from the profiler: at 20-60 us the
            # wrapper's host work is as long as the kernels, and "ms" times it
            tags = tile_tags(kernel, str(dtype)[6:])
            found = device_ms(torch, fn, tags)
            tile_ms, fix_ms = found[tags[0]], found[tags[1]]
            dev_ms = None if tile_ms is None or fix_ms is None else tile_ms + fix_ms
            b_ms, b_by = bound_ms(n_bytes, n_valid * d * (2 if kernel == "K2" else 1))
            slower = [what for what, t in (("library", lib_ms), ("plain", plain_ms)) if ms > t]
            log(f"{kernel} {label} {str(dtype)[6:]} E={e} N={n} D={d}: max_abs_err "
                f"{float(err.max()):.3e} ms {ms:.4f} device_ms {dev_ms} (tile {tile_ms} "
                f"+ fix-up {fix_ms}) plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                f"[{library_call}] bound_ms {b_ms:.4f} ({b_by})"
                + (f" SLOWER THAN {' AND '.join(slower).upper()}" if slower else ""))
            if not ok:
                raise AssertionError(f"{kernel} {label} {dtype} disagrees with its plain "
                                     f"version beyond {SUM_TOL} of |terms|")
            PATH_CHECKED.add((kernel, e, n, d, dtype))
            first = kernel not in rows
            if first and dtype == torch.bfloat16:
                rows[kernel] = {"max_abs_err": float(err.max()), "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": lib_ms,
                                "device_ms": dev_ms, "device_ms_fixup": fix_ms,
                                "shape": f"{label} bf16 E={e} N={n} D={d}"}
    kernel_tile_boundaries(torch)

    # the unsharded hop over the whole flat graph, then one rank's hop of the
    # sharded forward over its receiver-partitioned edges
    for label, e, n, make in (("CC hop", 98304, 24576, ragged_receivers),
                              ("per-rank CC hop", 36864, 6144, partitioned_receivers),
                              (f"per-rank CC hop, {p2} ranks", e2, n2, partitioned_receivers)):
        s, r, m = make(torch, e, n, gen)
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
        out, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 {label} disagrees with its plain version")
        assert (out[3::7] == sa.INT32_MAX).all(), "K5 wrote to an empty row"
        assert torch.equal(out, again), f"K5 {label}: two calls differ"
        PATH_CHECKED.add(("K5", e, n))
        ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                time_ms(torch, library))
        tag = PROFILE_TAGS["K5"]
        dev_ms = device_ms(torch, fn, (tag,))[tag]
        b_ms, b_by = bound_ms(4 * n_valid + 4 * (n + 1) + 4 * n, n_valid)
        log(f"K5 {label} int32 E={e} N={n} (T {sa.min_tiling(e).tile}): exact, ms {ms:.4f} "
            f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"[scatter_reduce_ amin] bound_ms {b_ms:.4f} ({b_by})")
        if "K5" not in rows:
            rows["K5"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                          "device_ms": dev_ms, "shape": f"{label} int32 E={e} N={n}"}
    kernel_min_boundaries(torch)
    kernels_backward(torch, gen, all_cases, rank_identity, bound_ms, rows)
    kernel_top2(torch, gen, bound_ms, rows)
    kernel_gather_sum(torch, gen, bound_ms, rows)
    phase_ring_gather(torch, rows)
    return rows


def kernel_tile_boundaries(torch):
    """K1 and K2 on the inputs that put row ends on every kind of tile
    boundary (:func:`tile_cases`) at each tile size the wrapper picks, bf16
    and f32, at D 256 (one and two column slices) and D 8 (16 or 32 workers
    per warp): within SUM_TOL of the plain version, empty rows exactly zero,
    two calls equal bit for bit."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    checked = 0
    for tile, (label, degrees, n_invalid) in (
            (t, case) for t in sa.TILE_SIZES for case in tile_cases(t)):
        plan = degree_plan(torch, degrees, padded_for(sa, tile, degrees, n_invalid), dev)
        e, n = plan.perm.shape[0], len(degrees)
        used = sa.tile_edges(e)
        empty = torch.tensor(degrees, device=dev) == 0
        w = plan.sort(torch.rand(e, generator=gen).to(dev) * 2.9 + 0.1)
        for d in (256, 8):
            for dtype in (torch.bfloat16, torch.float32):
                data = plan.sort(torch.randn(e, d, generator=gen).to(dev, dtype))
                for kernel, fn, plain in (
                        ("K1", lambda x: sa.sorted_aggregate(x, plan),
                         lambda x: sa.sorted_aggregate_plain(x, plan)),
                        ("K2", lambda x: sa.sorted_aggregate_weighted(x, w, plan),
                         lambda x: sa.sorted_aggregate_weighted_plain(x, w, plan))):
                    out, again, ref = fn(data), fn(data), plain(data)
                    torch.cuda.synchronize()
                    what = f"{kernel} tile boundaries, {label}, {str(dtype)[6:]} D={d}"
                    assert out.shape == (n, d) and out.dtype == torch.float32, what
                    if not bool(((out - ref).abs() <= SUM_TOL * plain(data.abs()) + 1e-6).all()):
                        raise AssertionError(f"{what}: disagrees with its plain version "
                                             f"beyond {SUM_TOL} of |terms|")
                    assert not out[empty].any(), f"{what}: an empty row is not zero"
                    assert torch.equal(out, again), f"{what}: two calls differ"
                    checked += 1
        assert used == tile or sum(degrees) > (sa.MIN_TILES - 1) * tile, (label, tile, used)
        log(f"K1/K2 tile boundaries at T {used}, {label} (E={e} N={n}, "
            f"{int(plan.row_ptr[-1])} valid, longest row {max(degrees)}): within {SUM_TOL} of "
            f"|terms|, empty rows zero, two calls bitwise equal")
    log(f"K1/K2 tile boundaries: {checked} comparisons at tiles {sa.TILE_SIZES}")


def kernel_min_boundaries(torch):
    """K5 on the inputs of :func:`tile_cases` at each tile size K5 takes
    (forced: the wrapper picks it from E), the degree-50000 row among them:
    exactly its plain version, empty rows INT32_MAX, two calls bit for bit
    equal; then 50 calls back to back on one scratch and calls on two
    streams, where a counter left unreset would show."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(98)
    pick = sa.min_tile_edges
    checked = 0
    try:
        for tile in sa.MIN_TILE_SIZES:
            sa.min_tile_edges = lambda n_edges, tile=tile: tile
            sa.min_tiling.cache_clear()
            for label, degrees, n_invalid in tile_cases(tile):
                plan = degree_plan(torch, degrees, n_invalid, dev)
                e = plan.perm.shape[0]
                vals = torch.randint(0, 10**6, (e,), generator=gen, dtype=torch.int32).to(dev)
                vals = torch.where(plan.edge_mask_sorted, vals, sa.INT32_MAX)
                out, again = (sa.sorted_segment_min_i32(vals, plan),
                              sa.sorted_segment_min_i32(vals, plan))
                torch.cuda.synchronize()
                what = f"K5 tile boundaries at T {tile}, {label}"
                assert torch.equal(out, sa.sorted_segment_min_i32_plain(vals, plan)), what
                assert (out[torch.tensor(degrees, device=dev) == 0] == sa.INT32_MAX).all(), what
                assert torch.equal(out, again), f"{what}: two calls differ"
                checked += 1
    finally:
        sa.min_tile_edges = pick
        sa.min_tiling.cache_clear()
    label, degrees, n_invalid = tile_cases(128)[-1]
    plan = degree_plan(torch, degrees, n_invalid, dev)
    e = plan.perm.shape[0]
    vals = [torch.randint(0, 10**6, (e,), generator=gen, dtype=torch.int32).to(dev)
            for _ in range(4)]
    wants = [sa.sorted_segment_min_i32_plain(v, plan) for v in vals]
    tag = PROFILE_TAGS["K5"]
    hub_ms = device_ms(torch, lambda: sa.sorted_segment_min_i32(vals[0], plan), (tag,))[tag]
    outs = [sa.sorted_segment_min_i32(vals[i % 4], plan) for i in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, wants[i % 4]) for i, o in enumerate(outs)), "K5 50 reuses"
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = {}
    for k in range(10):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[k, i] = sa.sorted_segment_min_i32(vals[(k + i) % 4], plan)
    torch.cuda.synchronize()
    assert all(torch.equal(o, wants[(k + i) % 4]) for (k, i), o in got.items()), "K5 streams"
    log(f"K5 tile boundaries: {checked} inputs at tiles {sa.MIN_TILE_SIZES} exact, empty rows "
        f"INT32_MAX, two calls equal; rows of degree 5000 and 50000 (E={e}, T "
        f"{sa.min_tiling(e).tile}) device_ms {hub_ms}; 50 calls back to back and 2 x 10 on "
        f"two streams exact")


def kernels_backward(torch, gen, cases, identity, bound_ms, rows):
    """K3 and K4 against their plain versions on the inputs of phase 3's K1
    and K2 ``cases`` (those in ``identity`` receiver-partitioned as one rank
    holds them, the others ragged): K3 with bf16 and f32 data, K4 as the
    plain gather (the K1 shapes) and scaled (the K2 shapes), writing bf16
    and f32."""
    from hierarchicalgnn_torch.ops.kernels import sddmm, sorted_agg as sa

    dev = torch.device("cuda")
    for case in cases:
        kernel, label, e, n, d, dtypes = case
        make = partitioned_receivers if case in identity else ragged_receivers
        s, r, m = make(torch, e, n, gen)
        plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
        n_valid = int(plan.row_ptr[-1])
        recv = plan.receivers_sorted
        g = torch.randn(n, d, generator=gen).to(dev)
        scale = None if kernel == "K1" else plan.sort(torch.randn(e, generator=gen).to(dev))
        tail = slice(n_valid, None)
        for dtype in dtypes:
            name = str(dtype)[6:]
            if kernel == "K2":  # K3 is d_w of K2 only
                data = plan.sort(torch.randn(e, d, generator=gen).to(dev, dtype))
                fn = lambda: sddmm.sorted_sddmm(data, g, plan)
                plain = lambda: sddmm.sorted_sddmm_plain(data, g, plan)
                d32 = data.float()
                library = lambda: (d32 * g[recv]).sum(-1)
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                err = (out - ref).abs()
                abs_sum = sddmm.sorted_sddmm_plain(data.abs(), g.abs(), plan)
                assert not out[tail].any(), "K3 wrote to an invalid slot"
                if not bool((err <= DOT_TOL * abs_sum + 1e-6).all()):
                    raise AssertionError(f"K3 {label} {dtype} disagrees with its plain "
                                         f"version beyond {DOT_TOL} of |terms|")
                PATH_CHECKED.add(("K3", e, n, d, dtype))
                ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                        time_ms(torch, library))
                b_ms, b_by = bound_ms(n_valid * d * data.element_size() + 4 * n * d
                                      + 4 * n_valid + 4 * (n + 1) + 4 * e, 2 * n_valid * d)
                log(f"K3 {label} {name} E={e} N={n} D={d}: max_abs_err "
                    f"{float(err.max()):.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                    f"library_ms {lib_ms:.4f} [gather + (a*b).sum(-1), f32 copy of the "
                    f"data] bound_ms {b_ms:.4f} ({b_by})")
                if "K3" not in rows:
                    rows["K3"] = {"max_abs_err": float(err.max()), "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": lib_ms,
                                  "shape": f"{label} {name} E={e} N={n} D={d}"}
            fn = lambda: sddmm.scaled_gather(scale, g, plan, out_dtype=dtype)
            plain = lambda: sddmm.scaled_gather_plain(scale, g, plan, out_dtype=dtype)
            if scale is None:
                library = lambda: g.index_select(0, recv).to(dtype)
                library_call = "index_select"
            else:
                library = lambda: (g.index_select(0, recv) * scale[:, None]).to(dtype)
                library_call = "index_select * scale"
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            assert not out[tail].any(), "K4 wrote to an invalid slot"
            if not bool((err <= DOT_TOL * ref.float().abs()).all()):
                raise AssertionError(f"K4 {label} {dtype} disagrees with its plain version")
            PATH_CHECKED.add(("K4", e, n, d, dtype, scale is not None))
            ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                    time_ms(torch, library))
            b_ms, b_by = bound_ms(4 * n * d + 4 * n_valid + 4 * (n + 1)
                                  + (0 if scale is None else 4 * n_valid)
                                  + e * d * out.element_size(),
                                  0 if scale is None else n_valid * d)
            how = "gather" if scale is None else "scaled"
            log(f"K4 {how} {label} -> {name} E={e} N={n} D={d}: max_abs_err "
                f"{float(err.max()):.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"library_ms {lib_ms:.4f} [{library_call}] bound_ms {b_ms:.4f} ({b_by})")
            if "K4" not in rows and scale is not None:
                rows["K4"] = {"max_abs_err": float(err.max()), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": lib_ms,
                              "shape": f"scaled, {label} -> {name} E={e} N={n} D={d}"}


# K6's ties between columns in neighbouring lanes (vector and scalar form), in
# one lane's first and a later batch (vector 256 = column 1024; column 256), in
# neighbouring warps of a row of 8 warps (column 128; column 32), between the
# row's two ends, and one whose winner is not column 0
TOP2_TIE_PAIRS = ((0, 4), (0, 1), (0, 1024), (0, 256), (0, 128), (0, 32), (-1, 0), (1028, 4))


def plant_top2_ties(a, prices, first_row=1):
    """Rows ``first_row``, ... of ``a`` (numpy or torch) get an equal best of
    90 in the two columns of each of TOP2_TIE_PAIRS, at equal prices of 0.5
    (pairs that fall on one column of a narrow row are left out)."""
    p, c = a.shape
    for row, pair in enumerate(TOP2_TIE_PAIRS, start=first_row):
        cols = {j % c if j < 0 else min(j, c - 1) for j in pair}
        if row < p and len(cols) == 2:
            for j in cols:
                a[row, j], prices[j] = 90.0, 0.5


def kernel_top2(torch, gen, bound_ms, rows):
    """K6 against its plain version, exactly, at the unsharded auction's two
    sweep shapes and at one rank's block of the row-sharded auction over 4
    and 2 ranks (4 and 2 warps a row on 132 SMs), with planted ties and a
    row of all NEG; then the boundary
    inputs: C 3071, 5 and 1 (no whole 16-byte rows), an ``a`` one float off
    a 16-byte boundary, P 1 and 37, ties across lane, batch and warp
    boundaries.  Every input: two calls equal bit for bit."""
    from hierarchicalgnn_torch.ops.kernels import top2

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def exact(a, prices, label):
        (v1, j1, v2), again, (r1, rj, r2) = (top2.row_top2(a, prices), top2.row_top2(a, prices),
                                             top2.row_top2_plain(a, prices))
        torch.cuda.synchronize()
        if not (torch.equal(v1, r1) and torch.equal(j1, rj) and torch.equal(v2, r2)):
            raise AssertionError(f"K6 {label} differs from its plain version: "
                                 f"{int((j1 != rj).sum())} j1, {int((v1 != r1).sum())} v1, "
                                 f"{int((v2 != r2).sum())} v2 of {a.shape[0]} rows")
        assert all(torch.equal(x, y) for x, y in zip((v1, j1, v2), again)), f"K6 {label}: two calls"
        PATH_CHECKED.add(("K6",) + tuple(a.shape))
        cut = top2.top2_schedule(*a.shape, sms)
        loads, staged = top2.top2_loads(cut, *a.shape, a.data_ptr(), prices.data_ptr())
        return (v1, j1, v2), (f"{cut.warps_per_row} warp(s) a row, grid {cut.grid}, {loads} "
                              f"loads, prices in {'shared' if staged else 'global'} memory")

    # the unsharded auction's sweeps, then one rank's block of the row-sharded
    # auction's sweep at 4 and 2 ranks (4 and 2 warps a row)
    c = 3072
    for p, label in ((4096, "full sweep"), (256, "tail sweep"), (1024, "per-rank sweep, 4 ranks"),
                     (2048, "per-rank sweep, 2 ranks")):
        a = torch.rand(p, c, generator=gen) * 40.0
        a[torch.rand(p, c, generator=gen) < 0.99] = top2.NEG  # ~30 candidates a row
        a[0] = top2.NEG                       # a row of all NEG
        a[1, 7] = a[1, 2900] = 77.0           # equal best in two columns
        a[2] = top2.NEG
        a[2, 5] = 1.0                         # a single candidate
        a[3, 3071] = a[3, 0] = 88.0           # a tie between the row's two ends
        prices = torch.rand(c, generator=gen) * 3.0
        prices[7] = prices[2900] = prices[0] = prices[3071] = 0.5
        plant_top2_ties(a, prices, first_row=4)
        a, prices = a.to(dev), prices.to(dev)
        fn = lambda: top2.row_top2(a, prices)
        plain = lambda: top2.row_top2_plain(a, prices)
        library = lambda: torch.topk(a - prices[None, :], 2)
        (v1, j1, v2), how = exact(a, prices, label)
        assert int(j1[1]) == 7 and float(v2[1]) == float(v1[1]) == 76.5, "K6 tie"
        assert int(j1[3]) == 0 and float(v2[3]) == float(v1[3]) == 87.5, "K6 tie"
        assert int(j1[0]) == 0 and float(v1[0]) == float(v2[0]), "K6 all-NEG row"
        ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                time_ms(torch, library))
        dev_ms = device_ms(torch, fn, (PROFILE_TAGS["K6"],))[PROFILE_TAGS["K6"]]
        b_ms, b_by = bound_ms(4 * p * c + 4 * c + 12 * p, 3 * p * c)
        log(f"K6 {label} f32 P={p} C={c} ({how}): exact (ties and the all-NEG row included), "
            f"ms {ms:.4f} device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"[torch.topk(a - prices, 2)] bound_ms {b_ms:.4f} ({b_by})")
        if "K6" not in rows:
            rows["K6"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                          "device_ms": dev_ms, "shape": f"{label} f32 P={p} C={c}"}
        else:
            rows["K6"]["device_ms_" + ("tail_sweep" if p == 256 else f"per_rank_{p}_rows")] = dev_ms
    # the boundary inputs; `offset` floats into a buffer puts `a` off 16 bytes
    for p, c, offset in ((1, 3072, 0), (37, 3072, 0), (37, 3071, 0), (37, 5, 0), (37, 1, 0),
                         (40, 3072, 1), (3001, 2633, 0)):
        a = torch.randn(p, c, generator=gen) * 10.0
        a[torch.rand(p, c, generator=gen) < 0.5] = top2.NEG
        a[0] = top2.NEG
        prices = torch.rand(c, generator=gen)
        plant_top2_ties(a, prices)
        buf = torch.empty(p * c + offset, device=dev)
        a_dev = buf[offset:].view(p, c)
        a_dev.copy_(a)
        _, how = exact(a_dev, prices.to(dev), f"P={p} C={c} offset {offset}")
        log(f"K6 f32 P={p} C={c}, a {4 * offset} bytes off 16 ({how}): exact, two calls equal")


def kernel_gather_sum(torch, gen, bound_ms, rows):
    """K7 against its plain version on unsorted edge rows of the flagship
    flat graph (ragged rows, empty rows, the hot row, invalid edges), in
    bf16 and f32, at D 256 and 128 (16-byte loads) and D 100 and 3 (8, 4 or
    2 bytes: the widest load that divides the row), each also at a base one
    element off 16 bytes; then on :func:`tile_cases`.  Within SUM_TOL of
    |terms|, empty rows exactly 0, two calls bit for bit equal."""
    from hierarchicalgnn_torch.ops.kernels import segment_gather as sg

    dev = torch.device("cuda")
    e, n = 98304, 24576
    _, r, m = ragged_receivers(torch, e, n, gen)
    r, m = r.to(dev), m.to(dev)
    layout = sg.make_csr_layout(r, m, n)
    n_valid = int(layout.row_ptr[-1])
    valid = m.nonzero()[:, 0]
    recv = r[valid]
    tags = (PROFILE_TAGS["K7"], FIXUP_TAGS["K7"])
    for d in (256, 128, 100, 3):
        for dtype in (torch.bfloat16, torch.float32):
            flat = torch.randn(e * d + 1, generator=gen).to(dev, dtype)
            for offset in (0, 1):
                data = flat[offset:offset + e * d].view(e, d)
                fn = lambda: sg.csr_segment_sum(data, layout)
                plain = lambda: sg.csr_segment_sum_plain(data, layout)
                out, again, ref = fn(), fn(), plain()
                torch.cuda.synchronize()
                err = (out - ref).abs()
                abs_sum = sg.csr_segment_sum_plain(data.abs(), layout)
                width = sg.load_width(d, data.element_size(), data.data_ptr())
                label = (f"flat edges->nodes, unsorted {str(dtype)[6:]} E={e} N={n} D={d}"
                         + (f", base {data.data_ptr() % 16} bytes off 16" if offset else ""))
                assert (out[3::7] == 0).all(), f"K7 {label}: wrote to an empty row"
                assert torch.equal(out, again), f"K7 {label}: two calls differ"
                if not bool((err <= SUM_TOL * abs_sum + 1e-6).all()):
                    raise AssertionError(f"K7 {label} disagrees with its plain version "
                                         f"beyond {SUM_TOL} of |terms|")
                found = device_ms(torch, fn, tags)
                tile_ms, fix_ms = found[tags[0]], found[tags[1]]
                dev_ms = None if tile_ms is None or fix_ms is None else tile_ms + fix_ms
                if offset:
                    log(f"K7 {label} ({width}-byte loads): max_abs_err {float(err.max()):.3e} "
                        f"ms {time_ms(torch, fn):.4f} device_ms {dev_ms}")
                    continue
                d32 = data.float()[valid]
                library = lambda: torch.zeros((n, d), device=dev).index_add_(0, recv, d32)
                ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                        time_ms(torch, library))
                b_ms, b_by = bound_ms(n_valid * d * data.element_size() + 4 * n_valid
                                      + 4 * (n + 1) + 4 * n * d, n_valid * d)
                log(f"K7 {label} ({width}-byte loads): max_abs_err {float(err.max()):.3e} ms "
                    f"{ms:.4f} device_ms {dev_ms} (tile {tile_ms} + fix-up {fix_ms}) plain_ms "
                    f"{plain_ms:.4f} library_ms {lib_ms:.4f} [index_add_ (f32 copy of the "
                    f"valid rows)] bound_ms {b_ms:.4f} ({b_by})")
                if "K7" not in rows:
                    rows["K7"] = {"max_abs_err": float(err.max()), "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                  "library_ms": lib_ms, "device_ms": dev_ms,
                                  "device_ms_fixup": fix_ms, "shape": label}
    # the boundary inputs at each tile size (forced: the wrapper picks it from
    # E and the lanes a tile takes)
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    pick = sa.tile_for_threads
    checked = 0
    try:
        for tile in sa.TILE_SIZES:
            sa.tile_for_threads = lambda *args, tile=tile: tile
            sa.csr_tiling.cache_clear()
            for label, degrees, n_invalid in tile_cases(tile):
                checked += gather_boundary_case(torch, gen, sg, label, degrees, n_invalid)
    finally:
        sa.tile_for_threads = pick
        sa.csr_tiling.cache_clear()
    log(f"K7 tile boundaries: {checked} comparisons (tile_cases at T {sa.TILE_SIZES}, D 256, "
        f"100 and 3, bf16 and f32, aligned and one element off) within {SUM_TOL} of |terms|, "
        f"empty rows zero, two calls bitwise equal")


def gather_boundary_case(torch, gen, sg, label, degrees, n_invalid):
    """K7 on one input of :func:`tile_cases`, its edges in a shuffled
    original order; returns the number of comparisons."""
    dev = torch.device("cuda")
    plan = degree_plan(torch, degrees, n_invalid, dev)
    lay = sg.make_csr_layout(plan.unsort(plan.receivers_sorted),
                             plan.unsort(plan.edge_mask_sorted), len(degrees))
    e = plan.perm.shape[0]
    empty = torch.tensor(degrees, device=dev) == 0
    checked = 0
    for d in (256, 100, 3):
        for dtype in (torch.bfloat16, torch.float32):
            flat = torch.randn(e * d + 1, generator=gen).to(dev, dtype)
            for offset in (0, 1):
                data = flat[offset:offset + e * d].view(e, d)
                out, again = sg.csr_segment_sum(data, lay), sg.csr_segment_sum(data, lay)
                torch.cuda.synchronize()
                what = f"K7 tile boundaries, {label}, {str(dtype)[6:]} D={d} offset {offset}"
                bound = sg.csr_segment_sum_plain(data.abs(), lay)
                if not bool(((out - sg.csr_segment_sum_plain(data, lay)).abs()
                             <= SUM_TOL * bound + 1e-6).all()):
                    raise AssertionError(f"{what}: disagrees with its plain version")
                assert not out[empty].any(), f"{what}: an empty row is not zero"
                assert torch.equal(out, again), f"{what}: two calls differ"
                checked += 1
    return checked


def hdbscan_cases(torch, served, m):
    """(label, [N, D] float64 on the card) for the hdbscan phase: the served
    event's embeddings, then the edge inputs."""
    import numpy as np

    rng = np.random.default_rng(7)
    centres = rng.normal(size=(400, 8))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    blobs = centres[rng.integers(0, 400, 8000)] + 0.03 * rng.normal(size=(8000, 8))
    blobs /= np.linalg.norm(blobs, axis=1, keepdims=True)
    ties = np.round(rng.uniform(0, 6, (3000, 8)) * 2) / 2
    cases = [("coordinates quantised to 0.5 (ties)", ties),
             ("N = min_cluster_size", rng.normal(size=(m, 8))),
             ("all points equal", np.ones((500, 8))),
             ("unit vectors around 400 centres", blobs),
             ("one feature", rng.normal(size=(700, 1)))]
    return [("served Embedding-IN event (seed 0)", served)] + [
        (label, torch.as_tensor(x, dtype=torch.float64, device="cuda").contiguous())
        for label, x in cases]


def _same_bits(torch, a, b):
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    return a.shape == b.shape and torch.equal(
        a.view(bits[a.dtype]) if a.dtype in bits else a,
        b.view(bits[b.dtype]) if b.dtype in bits else b)


def _route_counts(sa, before):
    return {k: sa.LAUNCHES[k] - before[k] for k in ("HD2", "HD2_cluster", "HD2_coop")}


def phase_hdbscan(torch, events):
    """HD1 and HD2 against their plain versions on the card (the plain
    versions run on the same card tensors): HD1 bit for bit on every input,
    HD2's cluster route element for element on every input and its
    cooperative route on the served event; above the cluster's capacity
    ``prim_mst`` takes the cooperative route (by the route counters), and its
    tree holds the invariants; the labels of the kernels' path against the
    labels of the plain edges; the times of HD1, both HD2 routes, their step
    floors and the host tree on the served event.  Returns the kernel
    table's rows."""
    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.evaluation.hdbscan import hdbscan_labels, labels_from_mst
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import hdbscan as hd
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    hp, model, _ = model_selector("Embedding-IN", FLAGSHIP)
    m = hp["inference_min_cluster_size"]
    engine = InferenceEngine(hp, model)
    batch = preprocess_event(events[0], hp, stage="test")
    mask = torch.as_tensor(batch.node_mask, device=engine.device)
    served = engine.forward(batch)[mask].to(torch.float64).contiguous()
    del engine, model
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster, wide, narrow = hd.mst_cluster_size(0)
    log(f"HD2 cluster size {cluster} (cudaOccupancyMaxActiveClusters: {wide} clusters of 16, "
        f"{narrow} of 8 CTAs at {hd.SMEM_BYTES} bytes of shared memory a CTA)")
    plain_hd2_ms = None
    for label, x in hdbscan_cases(torch, served, m):
        n, d = x.shape
        core, core_plain = hd.core_distances(x, m), hd.core_distances_plain(x, m)
        torch.cuda.synchronize()
        if not _same_bits(torch, core, core_plain):
            raise AssertionError(f"HD1 {label}: core distances differ from the plain version")
        before = dict(sa.LAUNCHES)
        edges = hd.prim_mst(x, core)
        torch.cuda.synchronize()
        if _route_counts(sa, before) != {"HD2": 1, "HD2_cluster": 1, "HD2_coop": 0}:
            raise AssertionError(f"HD2 {label}: prim_mst did not take the cluster route")
        t0 = time.perf_counter()
        plain_edges = hd.prim_mst_plain(x, core)
        torch.cuda.synchronize()
        if plain_hd2_ms is None:  # the served event comes first
            plain_hd2_ms = 1e3 * (time.perf_counter() - t0)
            before = dict(sa.LAUNCHES)
            coop_edges = hd.prim_mst_cooperative(x, core)
            torch.cuda.synchronize()
            assert _route_counts(sa, before) == {"HD2": 1, "HD2_cluster": 0, "HD2_coop": 1}
            for got, want, what in zip(coop_edges, plain_edges, ("src", "dst", "distance")):
                if not _same_bits(torch, got, want):
                    raise AssertionError(f"HD2 cooperative route {label}: the edges' {what} "
                                         "differ from the plain version's")
        for got, want, what in zip(edges, plain_edges, ("src", "dst", "distance")):
            if not _same_bits(torch, got, want):
                raise AssertionError(f"HD2 {label}: the edges' {what} differ from the plain "
                                     "version's")
        labels = hdbscan_labels(x, m)
        plain_labels = labels_from_mst(*(t.cpu().numpy() for t in plain_edges), m)
        if not np.array_equal(labels, plain_labels):
            raise AssertionError(f"hdbscan_labels {label}: the labels differ from those of "
                                 "the plain edges")
        cut = hd.mst_cluster_schedule(n, d, cluster)
        log(f"hdbscan {label} N={n} D={d}: HD1 bit for bit, HD2's {n - 1} edges equal "
            f"(cluster route: {cut.points} points a CTA, {cut.per_thread} a thread"
            f"{'; cooperative route equal too' if label.startswith('served') else ''}), "
            f"labels equal ({labels.max() + 1} clusters, {int((labels == -1).sum())} noise)")

    # above the cluster's capacity: the cooperative route, by the counters,
    # and a tree that holds the invariants that are cheap to check
    n_big = HD2_ABOVE_CAPACITY
    cap = hd.mst_cluster_capacity(8, cluster)
    assert n_big > cap, (n_big, cap)
    gen = torch.Generator(device="cuda").manual_seed(11)
    big = torch.randn(n_big, 8, dtype=torch.float64, device="cuda", generator=gen)
    core = hd.core_distances(big, m)
    if not _same_bits(torch, core, hd.core_distances_plain(big, m)):
        raise AssertionError(f"HD1 N={n_big}: core distances differ from the plain version")
    before = dict(sa.LAUNCHES)
    t0 = time.perf_counter()
    src, dst, dist = hd.prim_mst(big, core)
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0)
    if _route_counts(sa, before) != {"HD2": 1, "HD2_cluster": 0, "HD2_coop": 1}:
        raise AssertionError(f"HD2 N={n_big} (capacity {cap}): prim_mst did not take the "
                             "cooperative route")
    assert src.shape == dst.shape == dist.shape == (n_big - 1,)
    if not torch.equal(torch.sort(dst).values, torch.arange(1, n_big, device="cuda")):
        raise AssertionError(f"HD2 N={n_big}: not every node but 0 is reached exactly once")
    acc = torch.zeros(n_big - 1, dtype=torch.float64, device="cuda")
    for f in range(8):  # d2(src, dst) in feature order, no FMA: the plain helpers' arithmetic
        t = big[src, f] - big[dst, f]
        acc = acc + t * t
    want = torch.maximum(torch.maximum(core[src], core[dst]), hd.sqrt_rn(acc))
    if not _same_bits(torch, dist, want):
        raise AssertionError(f"HD2 N={n_big}: an edge's weight is not max(core[src], "
                             "core[dst], sqrt(d2(src, dst)))")
    log(f"hdbscan N={n_big} D=8 random normal (cluster capacity {cap}): HD1 bit for bit; "
        f"prim_mst took the cooperative route ({big_ms:.1f} ms, host clock, one call); "
        f"{n_big - 1} edges, every node but 0 reached once, every weight max(core[src], "
        f"core[dst], sqrt(d2)) bit for bit")
    del big, core, src, dst, dist, acc, want

    x = served
    n, d = x.shape
    cut = hd.mst_cluster_schedule(n, d, cluster)
    coop_cut = hd.mst_schedule(n, d, sms)
    core_cut = hd.core_schedule(n, sms)
    core = hd.core_distances(x, m)
    hd1 = lambda: hd.core_distances(x, m)
    hd2 = lambda: hd.prim_mst(x, core)
    coop = lambda: hd.prim_mst_cooperative(x, core)
    x1 = x[:, :1].contiguous()  # the same steps, 1/8 of the arithmetic
    ms = {"HD1": time_ms(torch, hd1, iters=10), "HD2": time_ms(torch, hd2, iters=5)}
    coop_ms = time_ms(torch, coop, iters=3)
    dev_ms = {"HD1": device_ms(torch, hd1, (PROFILE_TAGS["HD1"],), iters=5)[PROFILE_TAGS["HD1"]],
              "HD2": device_ms(torch, hd2, (PROFILE_TAGS["HD2"],), iters=3)[PROFILE_TAGS["HD2"]]}
    coop_dev_ms = device_ms(torch, coop, (COOP_TAG,), iters=3)[COOP_TAG]
    floor_ms = time_ms(torch, lambda: hd.prim_mst(x1, core), iters=5)
    coop_floor_ms = time_ms(torch, lambda: hd.prim_mst_cooperative(x1, core), iters=3)
    plain_ms = {"HD1": time_ms(torch, lambda: hd.core_distances_plain(x, m), iters=2),
                "HD2": plain_hd2_ms}
    lib_ms = time_ms(torch, lambda: torch.cdist(x, x).kthvalue(m, dim=1), iters=3)
    edges = [t.cpu().numpy() for t in hd2()]
    t0 = time.perf_counter()
    for _ in range(3):
        labels_from_mst(*edges, m)
    tree_ms = 1e3 * (time.perf_counter() - t0) / 3
    pairs = n * (n - 1) / 2
    bounds = {}
    for kernel, n_bytes, n_ops in (("HD1", 8 * n * d + 8 * n, 3 * d * pairs),
                                   ("HD2", 8 * n * d + 8 * n + 24 * (n - 1), (3 * d + 3) * pairs)):
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F64_OPS_PER_S
        bounds[kernel] = (1e3 * max(by_bytes, by_ops),
                          "bytes" if by_bytes >= by_ops else "operations")
    rows = {}
    for kernel in HD_NAMES:
        rows[kernel] = {"max_abs_err": 0.0, "ms": ms[kernel], "plain_ms": plain_ms[kernel],
                        "bound_ms": bounds[kernel][0], "bound_by": bounds[kernel][1],
                        "library_ms": lib_ms if kernel == "HD1" else None,
                        "device_ms": dev_ms[kernel],
                        "shape": f"served Embedding-IN event N={n} D={d} k={m} float64"}
    rows["HD1"].update(slices=core_cut.slices, queries_per_thread=hd.CORE_Q,
                       query_blocks=core_cut.blocks)
    rows["HD2"].update(step_floor_ms=floor_ms, host_tree_ms=tree_ms, mst_route="cluster",
                       cluster=cluster, points_per_cta=cut.points, points_per_thread=cut.per_thread,
                       smem_per_cta=cut.smem, coop_ms=coop_ms, coop_device_ms=coop_dev_ms,
                       coop_step_floor_ms=coop_floor_ms, coop_grid=coop_cut.grid,
                       coop_points_per_block=coop_cut.points,
                       above_capacity_n=n_big, above_capacity_coop_ms=big_ms)
    log(f"HD1 N={n} D={d} k={m}: {core_cut.blocks} query blocks x {core_cut.slices} slices (S), "
        f"{hd.CORE_Q} queries a thread (Q); ms {ms['HD1']:.4f} device_ms {dev_ms['HD1']} "
        f"plain_ms {plain_ms['HD1']:.4f} library_ms {lib_ms:.4f} [cdist + kthvalue, f64] "
        f"bound_ms {bounds['HD1'][0]:.4f} ({bounds['HD1'][1]})")
    log(f"HD2 N={n} D={d}, cluster route ({cluster} CTAs, {cut.points} points a CTA, "
        f"{cut.per_thread} a thread, {cut.smem} bytes of shared memory a CTA): ms "
        f"{ms['HD2']:.4f} device_ms {dev_ms['HD2']} plain_ms {plain_hd2_ms:.1f} (host clock, "
        f"one call) bound_ms {bounds['HD2'][0]:.4f} ({bounds['HD2'][1]}); step floor (D 1) "
        f"{floor_ms:.4f} ms = {1e3 * floor_ms / (n - 1):.3f} us a step")
    log(f"HD2 N={n} D={d}, cooperative route ({coop_cut.grid} blocks of {coop_cut.points} "
        f"points): ms {coop_ms:.4f} device_ms {coop_dev_ms}; step floor (D 1) "
        f"{coop_floor_ms:.4f} ms = {1e3 * coop_floor_ms / (n - 1):.3f} us a step")
    log(f"host tree (labels_from_mst) N={n}: {tree_ms:.1f} ms (host clock, mean of 3)")
    return rows


def knn_block(torch, queries, points, p_mask, rows):
    """The first block of ``rows`` queries as ``ops/knn.py::_block_topk`` hands
    it to KNN1: the GEMM in full f32 and the two norms."""
    q_block = queries[:rows]
    dots = q_block @ points.T
    sq_q = torch.sum(torch.square(q_block), dim=-1, keepdim=True)
    return dots, sq_q, torch.sum(torch.square(points), dim=-1), p_mask


def phase_knn(torch, events):
    """KNN1 against its plain version on one block of each main-path shape,
    bit for bit, and the whole ``knn`` of each against the plain path; the
    kernel timed beside its bound, the plain version, ``torch.topk`` on the
    same d2 and the block's GEMM; then one BC and one Embedding-IN training
    step with KNN1's launches counted.  Returns {"KNN1": row}, the row at
    Embedding-IN's shape with BC's beside it."""
    from unittest import mock

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops import knn as knn_mod
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks, sorted_agg as sa
    from hierarchicalgnn_torch.train.trainer import Trainer

    hp, model, _ = model_selector("Embedding-IN", FLAGSHIP)
    engine = InferenceEngine(hp, model)
    batch = preprocess_event(events[0], hp, stage="test")
    emb = engine.forward(batch).float()
    mask = torch.as_tensor(batch.node_mask, device=emb.device)
    gen = torch.Generator().manual_seed(0)
    means = torch.randn(FLAGSHIP["max_clusters"], emb.shape[1], generator=gen).to(emb.device)
    cvalid = torch.arange(means.shape[0], device=emb.device) < 2048
    block = hp["knn_block_size"]
    cases = (("Embedding-IN mining", emb, emb, mask, mask, hp["knn"], hp["train_r"]),
             ("BC bipartite", emb, means, mask, cvalid, 5, 1.0),
             ("BC super", means, means, cvalid, cvalid, 10, 1.0))
    found = {}
    for label, queries, points, q_mask, p_mask, k, r in cases:
        dots, sq_q, sq_p, valid = knn_block(torch, queries, points, p_mask, block)
        cut = ks.knn_schedule(points.shape[0], k)
        got = ks.knn_select(dots, sq_q, sq_p, valid, k)
        want = ks.knn_select_plain(dots, sq_q, sq_p, valid, k)
        full = knn_mod.knn(queries, points, k, r, q_mask=q_mask, p_mask=p_mask,
                           block_size=block)
        with mock.patch.object(knn_mod, "knn_select", ks.knn_select_plain):
            full_plain = knn_mod.knn(queries, points, k, r, q_mask=q_mask, p_mask=p_mask,
                                     block_size=block)
        torch.cuda.synchronize()
        if not (_same_bits(torch, got[0], want[0]) and torch.equal(got[1], want[1])
                and _same_bits(torch, full[1], full_plain[1])
                and torch.equal(full[0], full_plain[0])):
            raise AssertionError(f"KNN1 {label}: the kernel and the plain path differ")
        tag = PROFILE_TAGS["KNN1"]
        rows, p = dots.shape
        d2 = torch.where(valid[None, :], torch.clamp(sq_q + sq_p[None, :] - 2.0 * dots, min=0.0),
                         float("inf"))
        n_bytes = 4 * rows * p + 4 * rows + 5 * p + 12 * rows * k
        found[label] = {
            "shape": f"{rows} x {p} of {queries.shape[0]} queries, k {k}",
            "staged": cut.staged, "smem": cut.smem,
            "ms": time_ms(torch, lambda: ks.knn_select(dots, sq_q, sq_p, valid, k)),
            "device_ms": device_ms(torch, lambda: ks.knn_select(dots, sq_q, sq_p, valid, k),
                                   (tag,))[tag],
            "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "plain_ms": time_ms(torch, lambda: ks.knn_select_plain(dots, sq_q, sq_p, valid, k),
                                iters=5),
            "library_ms": time_ms(torch, lambda: torch.topk(d2, k, dim=1, largest=False),
                                  iters=10),
            "gemm_ms": time_ms(torch, lambda: queries[:block] @ points.T),
            "knn_ms": time_ms(torch, lambda: knn_mod.knn(
                queries, points, k, r, q_mask=q_mask, p_mask=p_mask, block_size=block),
                iters=5)}
        with mock.patch.object(knn_mod, "knn_select", ks.knn_select_plain):
            found[label]["knn_plain_ms"] = time_ms(torch, lambda: knn_mod.knn(
                queries, points, k, r, q_mask=q_mask, p_mask=p_mask, block_size=block),
                iters=3)
        log(f"KNN1 {label} ({found[label]['shape']}): bit for bit, the whole knn too; "
            f"{ {key: v for key, v in found[label].items() if key != 'shape'} }")
        del dots, d2
    del engine, emb
    torch.cuda.empty_cache()

    launches = {}
    for name in ("BC-HGNN-GMM", "Embedding-IN"):
        if name == "BC-HGNN-GMM":
            trainer = flagship_trainer({})[1]
        else:
            trainer = Trainer(*model_selector(name, FLAGSHIP))
            trainer.init_state(seed=0)
        batch = trainer.make_datasets(events)[0][0][2]
        before = sa.LAUNCHES["KNN1"]
        trainer.train_step(batch, TRAIN_EPOCH)
        torch.cuda.synchronize()
        launches[name] = sa.LAUNCHES["KNN1"] - before
        assert launches[name] > 0, f"a {name} training step never launched KNN1"
        del trainer
        torch.cuda.empty_cache()
    log(f"KNN1 launches a training step: {launches}")
    row = dict(found["Embedding-IN mining"])
    row["bc"] = {label: found[label] for label in ("BC bipartite", "BC super")}
    row["launches_per_train_step"] = launches
    return {"KNN1": row}


def phase_aggregator(torch):
    """K7's entry point: ``make_aggregator(use_pallas=True)`` builds one
    layout of the flagship flat graph and sums six edge tensors over it (one
    per iteration of a six-cell stack).  Returns the launch counts."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.ops.segment import make_aggregator, segment_sum

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(77)
    e, n, d = 98304, 24576, 256
    _, r, m = ragged_receivers(torch, e, n, gen)
    r, m = r.to(dev), m.to(dev)
    sa.reset_launches()
    agg = make_aggregator(r, m, n, use_pallas=True)
    edges = torch.randn(e, d, generator=gen).to(dev, torch.bfloat16)
    for _ in range(6):
        out = agg(edges)
        edges = (edges + out[r].to(edges.dtype)) * 0.5
    torch.cuda.synchronize()
    assert sa.LAUNCHES["K7"] == 6, sa.LAUNCHES
    totals = dict(sa.LAUNCHES)  # the entry point's own launches; the checks below add theirs
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    ref = segment_sum(edges.float(), r, n, mask=m)
    err = (agg(edges) - ref).abs()
    bound = segment_sum(edges.float().abs(), r, n, mask=m)
    assert bool((err <= SUM_TOL * bound + 1e-6).all()), "aggregator disagrees"
    # a width that is no whole number of 16-byte vectors launches the kernel too
    thin = torch.randn(e, 3, generator=gen).to(dev)
    narrow = agg(thin)
    assert narrow.shape == (n, 3) and sa.LAUNCHES["K7"] == totals["K7"] + 2
    thin_err = (narrow - segment_sum(thin, r, n, mask=m)).abs()
    thin_bound = segment_sum(thin.abs(), r, n, mask=m)
    assert bool((thin_err <= SUM_TOL * thin_bound + 1e-6).all()), "aggregator, width 3"
    log(f"aggregator: make_aggregator(use_pallas=True) over one layout, launches "
        f"{ {k: v for k, v in totals.items() if v} } (6 in the loop), "
        f"max_abs_err {float(err.max()):.3e}; width 3 launched K7 as well, "
        f"max_abs_err {float(thin_err.max()):.3e}")
    return totals


def flagship_events():
    """The synthetic events both main paths run: 3000 particles, seeds 0-2."""
    import numpy as np

    from hierarchicalgnn_torch.data.synthetic import generate_event

    return [generate_event(np.random.default_rng(seed), n_particles=N_PARTICLES)
            for seed in range(3)]


def phase_serving(torch, events):
    """Full-width bf16 serving of 2 events (after a warm-up on a third);
    returns the launch counts and the kernels' mean device ms per launch on
    the serving inputs."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.utils.config import load_config

    hp = load_config("bc_hgnn_gmm", FLAGSHIP)
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"]) == (
        256, 512, 6, 6, "bfloat16"), hp
    engine = InferenceEngine(hp, build_model(hp, seed=0))
    engine.reconstruct(events[2])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    sa.reset_launches()
    event_ms = []
    for seed, raw in enumerate(events[:2]):
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
    log(f"serving launches over 2 events: {totals}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kernel in ("K1", "K2", "K5"):
        assert totals[kernel] > 0, f"serving never launched {kernel}"

    before = dict(sa.LAUNCHES)
    per_launch, trace, _ = profile_call(torch, lambda: engine.reconstruct(events[0]),
                                        event_ms[0], "one reconstruct", ("K1", "K2", "K5"))
    # K5 is one device launch a call: the trace holds as many K5 kernels as
    # the wrapper counted calls
    k5_calls = sa.LAUNCHES["K5"] - before["K5"]
    k5_kernels = sum(count for key, count, _ in trace if PROFILE_TAGS["K5"] in key)
    assert k5_calls > 0 and k5_kernels == k5_calls, (k5_kernels, k5_calls)
    log(f"K5 on the served event: {k5_calls} wrapper calls, {k5_kernels} device launches "
        f"in the trace")

    # outputs of one event: finite, of the expected shapes
    hp_n, cap = hp["n_nodes_max"], hp["n_nodes_max"] * hp["bipartitegraph_sparsity"]
    bgraph, scores, emb, aux = engine.forward(preprocess_event(events[0], hp, stage="test"))
    assert scores.shape == (cap,) and emb.shape == (hp_n, hp["emb_dim"])
    assert bool(torch.isfinite(scores).all()) and bool(torch.isfinite(emb).all())
    assert bool(bgraph.edge_mask.any()) and 1 <= aux["n_clusters"]
    return totals, per_launch


def profile_call(torch, fn, wall_ms, what, kernels, top=15):
    """Device time by kernel over one call of ``fn`` (torch.profiler),
    against ``wall_ms``, the same call's host-clock time without the
    profiler.  Returns ({kernel: mean device ms per launch}, the trace's
    device events, the device's busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device activities only: a host-side annotation (the optimizer's
    # "Optimizer.step#..." span) is mirrored onto the device timeline and
    # would count the kernels under it twice
    events = [ev for ev in prof.key_averages()
              if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)
              and not ev.key.startswith("Optimizer.")]
    busy_ms = sum(_device_us(ev) for ev in events) / 1e3
    if busy_ms == 0.0:
        log(f"profile of {what}: the profiler saw no device time (not measured)")
        return {}, [], None
    log(f"profile of {what}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"unprofiled host clock (idle share {100 * (1 - busy_ms / wall_ms):.1f}%), "
        f"{len(events)} kernel names, {sum(ev.count for ev in events)} launches")
    for ev in sorted(events, key=_device_us, reverse=True)[:top]:
        log(f"  {_device_us(ev) / 1e3:8.3f} ms  x{ev.count:<5d} {ev.key[:110]}")
    per_launch = {}
    for kernel in kernels:
        hits = [ev for ev in events if PROFILE_TAGS[kernel] in ev.key]
        n = sum(ev.count for ev in hits)
        if n:
            per_launch[kernel] = sum(_device_us(ev) for ev in hits) / 1e3 / n
            log(f"  {kernel}: {n} launches, {per_launch[kernel]:.4f} ms per launch")
        if kernel in FIXUP_TAGS:  # the second device launch of each K1/K2 call
            fix = [ev for ev in events if FIXUP_TAGS[kernel] in ev.key]
            n_fix = sum(ev.count for ev in fix)
            if n_fix:
                log(f"  {kernel} fix-up: {n_fix} launches, "
                    f"{sum(_device_us(ev) for ev in fix) / 1e3 / n_fix:.4f} ms per launch")
    return per_launch, [(ev.key, ev.count, _device_us(ev) / 1e3) for ev in events], busy_ms


def phase_parity(torch):
    """f32 forward through the kernels vs through the plain versions."""
    from unittest import mock

    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models import blocks
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.ops import connected, knn
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks, sorted_agg as sa
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
                              sa.sorted_segment_min_i32_plain), \
            mock.patch.object(knn, "knn_select", ks.knn_select_plain):
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


def phase_gradients(torch):
    """Each kernel-backed Function against autograd through its plain
    version, in f32, on ragged inputs of the flagship shapes.  Sums (the
    gather's backward, d_rows) within SUM_TOL of the sum of |terms|; K3/K4
    outputs (d_w, d_data) within DOT_TOL."""
    from hierarchicalgnn_torch.ops.kernels import sddmm, segment_gather as sg
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    d = 256

    def grads(fn, inputs, cot):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)

    def check(name, got, want, bound, tol):
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= tol * bound + 1e-6).all())
        log(f"gradient {name}: max_abs_err {float(err.max()):.3e} "
            f"(tolerance {tol} of the sum of |terms|)")
        if not ok:
            raise AssertionError(f"gradient {name} disagrees with autograd of the "
                                 f"plain version")

    for label, e, n in (("flat", 98304, 24576), ("bipartite b1", 122880, 3072)):
        s, r, m = ragged_receivers(torch, e, n, gen)
        s, r, m = s.to(dev), r.to(dev), m.to(dev)
        plan = sa.build_sorted_plan(s, r, m, n)
        plan_t, r2s = sa.build_transposed_plan(plan, s, r, m, n)
        data = plan.sort(torch.randn(e, d, generator=gen).to(dev))
        w = plan.sort(torch.rand(e, 1, generator=gen).to(dev) + 0.1)
        rows = torch.randn(n, d, generator=gen).to(dev)
        nodes = torch.randn(n, d, generator=gen).to(dev)
        cot_n = torch.randn(n, d, generator=gen).to(dev)
        cot_e = torch.randn(e, generator=gen).to(dev)
        cot_s = torch.randn(e, d, generator=gen).to(dev)
        cot_r = torch.randn(e, d, generator=gen).to(dev)
        mask = plan.edge_mask_sorted[:, None]
        recv_cot = cot_n.abs()[plan.receivers_sorted] * mask
        before = dict(sa.LAUNCHES)

        (got,) = grads(lambda x: sa.sorted_aggregate(x, plan), [data], [cot_n])
        (want,) = grads(lambda x: sa.sorted_aggregate_plain(x, plan), [data], [cot_n])
        check(f"K1 {label} d_data (K4)", got, want, recv_cot, DOT_TOL)

        got = grads(lambda x, ww: sa.sorted_aggregate_weighted(x, ww, plan),
                    [data, w], [cot_n])
        want = grads(lambda x, ww: sa.sorted_aggregate_weighted_plain(x, ww, plan),
                     [data, w], [cot_n])
        check(f"K2 {label} d_data (K4)", got[0], want[0], recv_cot * w, DOT_TOL)
        check(f"K2 {label} d_w (K3)", got[1], want[1],
              (data.abs() * recv_cot).sum(-1, keepdim=True), DOT_TOL)

        got = grads(lambda x, y: sddmm.sorted_sddmm(x, y, plan), [data, rows], [cot_e])
        want = grads(lambda x, y: sddmm.sorted_sddmm_plain(x, y, plan), [data, rows],
                     [cot_e])
        check(f"K3 {label} d_data (K4)", got[0], want[0],
              cot_e.abs()[:, None] * rows.abs()[plan.receivers_sorted], DOT_TOL)
        check(f"K3 {label} d_rows (K2)", got[1], want[1],
              sa.sorted_aggregate_weighted_plain(data.abs(), cot_e.abs(), plan), SUM_TOL)

        (got,) = grads(lambda x: sa.gather_edge_endpoints(x, plan, plan_t, r2s), [nodes],
                       [cot_s, cot_r])
        # the plain gather also scatters the invalid slots' cotangents (to
        # node 0, where their indices point): mask them as the Function does
        (want,) = grads(lambda x: sa.gather_edge_endpoints(x, plan), [nodes],
                        [cot_s * mask, cot_r * mask])
        bound = torch.zeros(n, d, device=dev).index_add_(
            0, plan.senders_sorted, cot_s.abs() * mask).index_add_(
            0, plan.receivers_sorted, cot_r.abs() * mask)
        check(f"endpoint gather {label} d_nodes (K1 twice)", got, want, bound, SUM_TOL)
        used = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
        assert (used["K1"], used["K2"], used["K3"], used["K4"]) == (3, 2, 2, 3), used

        # K7: unsorted rows through the gather layout
        layout = sg.make_csr_layout(r, m, n)
        raw_rows = torch.randn(e, d, generator=gen).to(dev)
        (got,) = grads(lambda x: sg.csr_segment_sum(x, layout), [raw_rows], [cot_n])
        (want,) = grads(lambda x: sg.csr_segment_sum_plain(x, layout), [raw_rows], [cot_n])
        check(f"K7 {label} d_data (gather)", got, want, cot_n.abs()[r] * m[:, None],
              DOT_TOL)
        assert sa.LAUNCHES["K7"] - before["K7"] == 1, sa.LAUNCHES


def warm_like_instance(np, seed=0, p=3001, c=2633, p_max=4096, c_max=3072,
                       draws=120000):
    """A sparse pair-score matrix of the warm flagship matching's shape: each
    particle's candidates lie near a home column, as the hits of one track
    fall into a few neighbouring clusters; ~80k non-zeros, scores to ~40."""
    rng = np.random.default_rng(seed)
    scores = np.zeros((p_max, c_max), np.float32)
    rows = rng.integers(0, p, draws)
    home = rng.integers(0, c, p)
    cols = (home[rows] + rng.integers(-24, 25, draws)) % c
    np.add.at(scores, (rows, cols), rng.gamma(1.2, 2.2, draws).astype(np.float32))
    return scores, p, c


def phase_auction(torch):
    """The auction on the card (kernel K6 every round) against scipy's exact
    matching on the host: every row assigned, objective within 0.1%."""
    import numpy as np

    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.train import auction, matching

    scores, p, c = warm_like_instance(np)
    rows, cols, valid = matching.host_matching(scores, p, c, scores.shape[0])
    real = valid & (cols < c)
    oracle = float(scores[rows[real], cols[real]].sum())
    dev_scores = torch.from_numpy(scores).to(torch.device("cuda"))
    auction.auction_match(dev_scores, p, c, eps_scale=1e-2)  # warm-up
    torch.cuda.synchronize()
    stats, before = {}, sa.LAUNCHES["K6"]
    t0 = time.perf_counter()
    col_match, matched, iters, n_un = auction.auction_match(
        dev_scores, p, c, eps_scale=1e-2, return_iters=True, stats=stats)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    col_match, matched = col_match.cpu().numpy(), matched.cpu().numpy()
    hit = np.nonzero(matched)[0]
    objective = float(scores[hit, col_match[hit]].sum())
    used = col_match[hit]
    gap = (oracle - objective) / oracle
    log(f"auction P={p} C={c} nnz={int((scores > 0).sum())} max score "
        f"{float(scores.max()):.1f}: {int(iters)} rounds ({stats['auction_rounds_launched']} "
        f"launched), {stats['host_syncs']} host syncs, {ms:.1f} ms host clock, "
        f"{int(matched.sum())} matched (scipy {int(real.sum())}), objective {objective:.3f} "
        f"vs scipy {oracle:.3f} (gap {100 * gap:.4f}%), unassigned {int(n_un)}")
    assert int(n_un) == 0, "the auction left rows unassigned"
    assert len(set(used.tolist())) == len(used), "a candidate was matched twice"
    assert abs(gap) <= 1e-3, f"auction objective off scipy's by {gap}"
    assert sa.LAUNCHES["K6"] - before == stats["auction_rounds_launched"]


def flagship_trainer(overrides, devices=None):
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.train.pipelines import BipartitePipeline
    from hierarchicalgnn_torch.train.trainer import Trainer
    from hierarchicalgnn_torch.utils.config import load_config

    hp = load_config("bc_hgnn_gmm", {**FLAGSHIP, **overrides})
    model = build_model(hp, seed=0)
    trainer = Trainer(hp, model, BipartitePipeline(model, hp), devices=devices)
    trainer.init_state(seed=0)
    return hp, trainer


def phase_training(torch, events):
    """3 steps of the flagship (full width and depth, bf16) through
    ``Trainer.train_step``.  Returns the launch counts of the 3 steps and
    the kernels' mean device ms per launch on the training inputs."""
    import math

    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    hp, trainer = flagship_trainer({})
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"], hp["remat"]) == (
        256, 512, 6, 6, "bfloat16", False), hp
    model = trainer.model
    trainset, _, _ = trainer.make_datasets(events)
    assert len(trainset) == 3
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_iters = hp["n_interaction_graph_iters"], hp["n_hierarchical_graph_iters"]
    # K1: one per cell forward; in the backward two per endpoint gather that
    # gets a gradient (every IN cell's; the superedge init's; every
    # hierarchical cell's flat and super gather but the last cell's, whose
    # edge and superedge updates feed nothing) and one per row gather (the
    # supernode init's, two per hierarchical cell, two for the score head)
    gathers = n_iters[0] + 1 + 2 * (n_iters[1] - 1)
    row_gathers = 1 + 2 * n_iters[1] + 2
    expect = {"K1": sum(n_iters) + 2 * gathers + row_gathers, "K2": 1 + 3 * n_iters[1],
              "K3": 1 + 3 * n_iters[1], "K4": sum(n_iters) + 1 + 3 * n_iters[1]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.reset_launches()
    step_ms = []
    for step, (_, _, batch) in enumerate(trainset):
        before = dict(sa.LAUNCHES)
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, TRAIN_EPOCH)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
        stats = trainer.last_stats
        log(f"train step {step}: {step_ms[-1]:.1f} ms (host clock), metrics={metrics}, "
            f"auction rounds launched {stats['auction_rounds_launched']}, "
            f"host_syncs={stats['host_syncs']}, launches={counts}")
        assert all(math.isfinite(v) for v in metrics.values()), metrics
        assert metrics["score_cut"] < SCORE_CUT_CLAMP, metrics
        assert metrics["clusters"] >= 1 and metrics["grad_norm"] > 0
        for kernel, n in expect.items():
            assert counts[kernel] == n, (kernel, counts, expect)
        assert counts["K6"] == stats["auction_rounds_launched"] >= 1, counts
        assert counts["K5"] >= 2, counts
    totals = dict(sa.LAUNCHES)
    log(f"training launches over 3 steps: {totals}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the state after 3 steps: finite, and every tensor moved
    end = model.state_dict()
    buffers = {name for name, _ in model.named_buffers()}
    unchanged = [k for k in end if torch.equal(end[k], start[k])]
    for k, v in end.items():
        assert bool(torch.isfinite(v).all()), f"{k} is not finite"
    assert not [k for k in unchanged if k in buffers], unchanged
    # a parameter stays only where it is 0 and gets no gradient, as the
    # biases of the two networks the loss does not reach (decay moves the rest)
    assert all(not end[k].any() for k in unchanged), unchanged
    log(f"after 3 steps: {len(end) - len(unchanged)} of {len(end)} tensors changed, "
        f"all finite; score_cut {float(end['hgnn.score_cut']):.4f}, knn_radius "
        f"{float(end['hgnn.super_graph_construction.knn_radius']):.4f} / "
        f"{float(end['hgnn.bipartite_graph_construction.knn_radius']):.4f}")

    batch = trainset[0][2]
    per_launch, trace, _ = profile_call(
        torch, lambda: trainer.train_step(batch, TRAIN_EPOCH), step_ms[-1],
        "one train step", ("K1", "K2", "K3", "K4", "K5", "K6"))
    scatter = [(key, count) for key, count, _ in trace
               if any(word in key.lower() for word in ("index", "scatter", "atomic"))]
    log("indexing and scatter kernels in the step's trace (the K1/K2 backward and "
        "the flat and super endpoint gathers' backward are not among them: they ran "
        "as sddmm_kernel, scaled_gather_kernel and csr_tile_sum_kernel above):")
    for key, count in scatter:
        log(f"  x{count:<5d} {key[:120]}")
    return totals, per_launch


def phase_training_parity(torch, events):
    """One f32 training step at depth 2 + 2 (full width and capacities)
    through the kernels and through the plain versions with autograd's own
    backward: loss within 1e-5 relative, gradient global norm within 1e-4.
    Where a near-tie (a kNN neighbour, an edge on the GMM cut) gave the two
    runs different clusters or bipartite graphs, they computed the losses of
    different graphs and are held to 1e-2 / 1e-1 only."""
    from unittest import mock

    from hierarchicalgnn_torch.models import blocks
    from hierarchicalgnn_torch.ops import connected, knn
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks, sorted_agg as sa, top2
    from hierarchicalgnn_torch.train import auction

    overrides = {"compute_dtype": None, "n_interaction_graph_iters": 2,
                 "n_hierarchical_graph_iters": 2}

    def one_step():
        _, trainer = flagship_trainer(overrides)
        seen = {}
        trainer.model.register_forward_hook(
            lambda mod, args, out: seen.update(receivers=out[0].receivers,
                                               clusters=out[3]["clusters"]))
        batch = trainer.make_datasets(events[:1])[0][0][2]
        return trainer.train_step(batch, TRAIN_EPOCH), seen

    kern, kern_seen = one_step()
    plain_gather = lambda nodes, plan, *_: (
        nodes[plan.senders_sorted], nodes[plan.receivers_sorted])
    with mock.patch.object(blocks, "sorted_aggregate", sa.sorted_aggregate_plain), \
            mock.patch.object(blocks, "sorted_aggregate_weighted",
                              sa.sorted_aggregate_weighted_plain), \
            mock.patch.object(blocks, "gather_edge_endpoints", plain_gather), \
            mock.patch.object(blocks, "gather_senders",
                              lambda nodes, plan, *_: nodes[plan.senders_sorted]), \
            mock.patch.object(blocks, "gather_receivers",
                              lambda nodes, plan, *_: nodes[plan.receivers_sorted]), \
            mock.patch.object(connected, "sorted_segment_min_i32",
                              sa.sorted_segment_min_i32_plain), \
            mock.patch.object(auction, "row_top2", top2.row_top2_plain), \
            mock.patch.object(knn, "knn_select", ks.knn_select_plain):
        before = dict(sa.LAUNCHES)
        plain, plain_seen = one_step()
        assert sa.LAUNCHES == before, "the plain run launched a kernel"
    same = (torch.equal(kern_seen["clusters"], plain_seen["clusters"])
            and torch.equal(kern_seen["receivers"], plain_seen["receivers"]))
    loss_err = abs(kern["training_loss"] / plain["training_loss"] - 1)
    norm_err = abs(kern["grad_norm"] / plain["grad_norm"] - 1)
    log(f"training parity f32 (2 + 2): loss {kern['training_loss']:.6f} vs "
        f"{plain['training_loss']:.6f} (rel {loss_err:.2e}), grad norm "
        f"{kern['grad_norm']:.6f} vs {plain['grad_norm']:.6f} (rel {norm_err:.2e}), "
        f"clusters {kern['clusters']:.0f} vs {plain['clusters']:.0f}, "
        f"{'same' if same else 'different'} clusters and bipartite graph")
    loss_tol, norm_tol = (1e-5, 1e-4) if same else (1e-2, 1e-1)
    if loss_err > loss_tol or norm_err > norm_tol:
        raise AssertionError(f"kernel and plain training steps differ: loss {loss_err}, "
                             f"gradient norm {norm_err}")


# Launches of each of the four later models: per eval forward, and per
# training step (K1 = the forward's cells + 2 per endpoint gather that gets a
# gradient + 1 per row gather + 2 per hinge of the embedding pipeline; K4 = one
# per K1 and K2 of the forward; K3 = K2).  K5 and K6 depend on the data.
MODEL_LAUNCHES = {
    "EC-IN": ({"K1": 14, "K2": 0}, {"K1": 42, "K2": 0, "K3": 0, "K4": 14}),
    "Embedding-IN": ({"K1": 12, "K2": 0}, {"K1": 36, "K2": 0, "K3": 0, "K4": 12}),
    "Embedding-HGNN-GMM": ({"K1": 14, "K2": 25}, {"K1": 77, "K2": 25, "K3": 25, "K4": 39}),
    "gMRT": ({"K1": 6, "K2": 19}, {"K1": 43, "K2": 19, "K3": 19, "K4": 25}),
}
MODEL_WIDTHS = {  # (latent, hidden, IN iterations, hierarchical iterations or None)
    "EC-IN": (128, 256, 14, None), "Embedding-IN": (128, 256, 12, None),
    "Embedding-HGNN-GMM": (128, 256, 6, 8), "gMRT": (256, 512, 6, 6),
}


def phase_models(torch, events):
    """EC-IN, Embedding-IN, Embedding-HGNN-GMM and gMRT at their shipped
    configs and the flagship capacities: one served event and 2 training
    steps each (after a warm-up call), with the launch counts asserted.
    Returns the summed launch counts and one record per model."""
    import math

    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.train.trainer import Trainer

    totals = {k: 0 for k in sa.LAUNCHES}
    records = {}
    for name, (fwd_expect, step_expect) in MODEL_LAUNCHES.items():
        hp, model, pipeline = model_selector(name, FLAGSHIP)
        assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
                hp.get("n_hierarchical_graph_iters")) == MODEL_WIDTHS[name], hp
        assert hp["compute_dtype"] == "bfloat16" and hp["remat"] is False, hp
        hier = name in ("Embedding-HGNN-GMM", "gMRT")
        rec = records[name] = {}

        # ---- serving
        engine = InferenceEngine(hp, model)
        serve = engine.reconstruct
        serve(events[2])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sa.reset_launches()
        t0 = time.perf_counter()
        out = serve(events[0])
        torch.cuda.synchronize()
        rec["serve_ms"] = 1e3 * (time.perf_counter() - t0)
        counts = dict(sa.LAUNCHES)
        rec["serve_launches"] = counts
        rec["serve_host_syncs"] = engine.last_stats.get("host_syncs", 0)
        rec["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{name} serve event seed=0 through InferenceEngine.reconstruct: "
            f"{rec['serve_ms']:.1f} ms (host "
            f"clock), host_syncs={rec['serve_host_syncs']}, launches="
            f"{ {k: v for k, v in counts.items() if v} }, peak memory "
            f"{rec['serve_peak_gib']:.2f} GiB, stats={engine.last_stats}")
        for kernel, n in fwd_expect.items():
            assert counts[kernel] == n, (name, kernel, counts)
        assert (counts["K5"] >= 2) == (name != "Embedding-IN"), (name, counts)
        assert not any(counts[k] for k in ("K3", "K4", "K6", "K7")), (name, counts)
        # the embedding models' HDBSCAN: one core-distance and one MST launch
        hd_expect = 1 if name.startswith("Embedding") else 0
        assert counts["HD1"] == counts["HD2"] == hd_expect, (name, counts)
        # ... the MST by the cluster route: the served event fits it
        assert counts["HD2_cluster"] == hd_expect and counts["HD2_coop"] == 0, (name, counts)
        # ... and its two host reads (the finite check, the edges) are counted
        assert rec["serve_host_syncs"] >= 2 * hd_expect, (name, engine.last_stats)
        for k in totals:
            totals[k] += counts[k]
        # outputs: finite, embeddings of unit norm, scores in [0, 1]
        batch = preprocess_event(events[0], hp, stage="test")
        fwd = engine.forward(batch)
        node_mask = torch.as_tensor(batch.node_mask, device=engine.device)
        scores, embs = {"EC-IN": (fwd, ()), "Embedding-IN": (None, (fwd,)),
                        "Embedding-HGNN-GMM": (None, fwd[:2]),
                        "gMRT": (fwd[1], fwd[2:3])}[name]
        if scores is not None:
            assert bool(torch.isfinite(scores).all()), name
            assert bool(((scores >= 0) & (scores <= 1)).all()) and float(scores.max()) > 0
        for emb in embs:
            assert emb.shape == (hp["n_nodes_max"], hp["emb_dim"]), emb.shape
            assert emb.dtype == torch.float32
            norms = torch.linalg.vector_norm(emb[node_mask], dim=1)
            assert bool(((norms - 1).abs() < 1e-4).all()), (name, float(norms.min()))
        if name in ("EC-IN", "gMRT"):
            # seeded weights may put no bipartite score above the cut; the edge
            # classifier's candidates then keep every edge
            assert out.shape[0] == 2 and (out.shape[1] > 0 or name == "gMRT"), out.shape
        if name.startswith("Embedding"):
            assert out.shape[0] == 2 and out.shape[1] > 0, out.shape
        log(f"{name}: {out.shape[1]} (hit, track) candidates, "
            f"{len(np.unique(out[1]))} tracks")
        _, _, rec["serve_busy_ms"] = profile_call(
            torch, lambda: serve(events[0]), rec["serve_ms"], f"{name}: one served event",
            (), top=0)

        # ---- training
        trainer = Trainer(hp, model, pipeline)
        trainer.init_state(seed=0)
        trainset, _, _ = trainer.make_datasets(events)
        trainer.train_step(trainset[2][2], MODELS_EPOCH)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for step in range(2):
            sa.reset_launches()
            t0 = time.perf_counter()
            metrics = trainer.train_step(trainset[step][2], MODELS_EPOCH)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts, stats = dict(sa.LAUNCHES), trainer.last_stats
            log(f"{name} train step {step}: {step_ms[-1]:.1f} ms (host clock), "
                f"metrics={metrics}, stats={stats}, launches="
                f"{ {k: v for k, v in counts.items() if v} }")
            assert all(math.isfinite(v) for v in metrics.values()), (name, metrics)
            assert metrics["training_loss"] > 0 and metrics["grad_norm"] > 0, metrics
            for kernel, n in step_expect.items():
                assert counts[kernel] == n, (name, kernel, counts, step_expect)
            if hier:
                assert metrics["score_cut"] < SCORE_CUT_CLAMP and metrics["clusters"] >= 1
                assert counts["K5"] >= 2, (name, counts)
            if name == "gMRT":
                assert counts["K6"] == stats["auction_rounds_launched"] >= 1, counts
            else:
                assert counts["K6"] == 0, (name, counts)
            assert counts["K7"] == 0, (name, counts)
            for k in totals:
                totals[k] += counts[k]
        rec.update(step_ms=step_ms, step_launches=counts,
                   step_host_syncs=trainer.last_stats.get("host_syncs", 0),
                   step_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        batch = trainset[1][2]
        _, _, rec["step_busy_ms"] = profile_call(
            torch, lambda: trainer.train_step(batch, MODELS_EPOCH), step_ms[-1],
            f"{name}: one train step", tuple(k for k in ("K1", "K2", "K3", "K4", "K5", "K6")
                                            if counts[k]), top=5)
        log(f"{name}: peak memory over the 2 steps {rec['step_peak_gib']:.2f} GiB")
        if name == "Embedding-IN":
            hinge_compare(torch, trainer, batch)
        del engine, trainer, model, pipeline, trainset, batch, fwd, out, scores, embs
        torch.cuda.empty_cache()
    log("models " + json.dumps(records))
    return totals, records


def hinge_compare(torch, trainer, batch):
    """The mined-pair hinge of the embedding pipeline, forward + backward
    over one event's real pair list: through the sorted plan with K1 as the
    gathers' backward (what ``EmbeddingPipeline._hinge`` does under
    autograd) beside plain indexing with autograd's own index backward."""
    from hierarchicalgnn_torch.train import losses

    pipeline, hp = trainer.pipeline, trainer.hparams
    trainer.model.eval()
    with torch.no_grad():
        emb = trainer.model(batch.x, batch.graph, batch.node_mask)
        s, r, y, mask = pipeline._training_samples(emb, batch)

    def plain(e):
        w = losses.edge_pt_weights(batch.pt, s, r, y, mask, hp)
        return losses.squared_hinge_loss(losses.hinge_distances(e, s, r), y, w,
                                         hp["train_r"])

    def run(fn):
        e = emb.clone().requires_grad_()
        loss = fn(e)
        (g,) = torch.autograd.grad(loss, e)
        return loss.detach(), g

    sorted_fn = lambda e: pipeline._hinge(e, s, r, y, mask, batch)
    (loss_a, g_a), (loss_b, g_b) = run(sorted_fn), run(plain)
    torch.cuda.synchronize()
    err = float((g_a - g_b).abs().max())
    scale = float(g_b.abs().max())
    sorted_ms = time_ms(torch, lambda: run(sorted_fn), iters=5)
    plain_ms = time_ms(torch, lambda: run(plain), iters=3)
    log(f"hinge over {int(mask.sum())} valid of {mask.numel()} pairs (k={hp['knn']}), "
        f"forward + backward: sorted plan + K1 {sorted_ms:.3f} ms, plain indexing + "
        f"autograd's index backward {plain_ms:.3f} ms; loss {float(loss_a):.6f} vs "
        f"{float(loss_b):.6f}, gradient max_abs_err {err:.3e} of max {scale:.3e}")
    assert abs(float(loss_a) / float(loss_b) - 1) < 1e-4, (loss_a, loss_b)
    assert err <= 1e-4 * scale, (err, scale)


def phase_models_parity(torch):
    """The f32 forward of Embedding-HGNN-GMM at depth 2 + 2 (full width and
    capacities) through the kernels and through the plain versions.  The
    plain run is given the kernel run's kNN results, so both build the same
    super and bipartite graphs whatever a near-tie would have picked, and
    the hierarchical cells (K2 at latent 128) are compared on one graph:
    IN-block and final embeddings within 1e-4, equal clusters."""
    from unittest import mock

    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models import blocks, dynamic_graph
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops import connected
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    hp, model, _ = model_selector("Embedding-HGNN-GMM", {
        **FLAGSHIP, "compute_dtype": None, "n_interaction_graph_iters": 2,
        "n_hierarchical_graph_iters": 2})
    engine = InferenceEngine(hp, model)
    batch = preprocess_event(generate_event(np.random.default_rng(0),
                                            n_particles=N_PARTICLES), hp, stage="test")
    found, knn = [], dynamic_graph.knn

    def recording_knn(*args, **kwargs):
        found.append(knn(*args, **kwargs))
        return found[-1]

    before = dict(sa.LAUNCHES)
    with mock.patch.object(dynamic_graph, "knn", recording_knn):
        kern = engine.forward(batch)
    assert sa.LAUNCHES["K1"] - before["K1"] == 4 and sa.LAUNCHES["K2"] - before["K2"] == 7
    assert len(found) == 2, "one kNN each for the super and the bipartite graph"
    replay = iter(found)
    with mock.patch.object(blocks, "sorted_aggregate", sa.sorted_aggregate_plain), \
            mock.patch.object(blocks, "sorted_aggregate_weighted",
                              sa.sorted_aggregate_weighted_plain), \
            mock.patch.object(connected, "sorted_segment_min_i32",
                              sa.sorted_segment_min_i32_plain), \
            mock.patch.object(dynamic_graph, "knn", lambda *args, **kwargs: next(replay)):
        before = dict(sa.LAUNCHES)
        plain = engine.forward(batch)
        assert sa.LAUNCHES == before, "the plain run launched a kernel"
    inter_err = float((kern[1] - plain[1]).abs().max())
    emb_err = float((kern[0] - plain[0]).abs().max())
    log(f"models parity f32 Embedding-HGNN-GMM (2 + 2), one graph for both runs: "
        f"IN-block embeddings max_abs_err {inter_err:.3e}, final embeddings "
        f"{emb_err:.3e}, n_clusters {kern[2]['n_clusters']} vs {plain[2]['n_clusters']}")
    if inter_err > 1e-4:
        raise AssertionError(f"IN-block embeddings differ by {inter_err}")
    if not torch.equal(kern[2]["clusters"], plain[2]["clusters"]):
        raise AssertionError("clusters differ between the kernel and plain paths")
    if emb_err > 1e-4:
        raise AssertionError(f"final embeddings differ by {emb_err}")


class watchdog:
    """Ends the process (traceback of every thread, exit code 1) if the body
    takes longer than ``WATCHDOG_S``: K8's ranks wait on each other's flags,
    and a wait that never ends must fail the run, not hold the card."""

    def __enter__(self):
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()


def phase_ring_gather(torch, rows):
    """K8 against its plain version (``torch.cat``), exactly: P 1, 2, 3, 4, 8;
    f32, bf16, int32, bool; 2-D and 1-D; block sizes and bases that are no
    multiple of 16 bytes (narrower loads); 50 calls back to back on one set
    of input buffers with changing data and no host wait between them (the
    flags' generation counter).  Timed at the flagship halo (P 4, [6144, 256]
    bf16) and at P 2 and 8 with the same total rows.  Ranks share the one
    card: the copies ride its HBM, not NVLink."""
    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg, sorted_agg as sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(88)

    def make(shape, dtype):
        if dtype == torch.bool:
            return torch.rand(shape, generator=gen) < 0.5
        if dtype == torch.int32:
            return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int64
                                 ).to(torch.int32)
        return torch.randn(shape, generator=gen).to(dtype)

    def check(blocks, what):
        """Two calls, each exact against torch.cat; the launcher's cut equals
        ``gather_schedule``'s.  Returns the path the bytes took."""
        before = sa.LAUNCHES["K8"]
        outs = rg.ring_all_gather(blocks)
        again = rg.ring_all_gather(blocks)
        ref = rg.ring_all_gather_plain(blocks)
        torch.cuda.synchronize()
        assert sa.LAUNCHES["K8"] == before + 2, "one launch serves all ranks"
        assert len(outs) == len(blocks)
        if outs[0].numel():  # every rank has an output of its own
            assert len({o.data_ptr() for o in outs}) == len(outs)
        for q, (out, out2, want) in enumerate(zip(outs, again, ref)):
            if out.dtype != want.dtype or not torch.equal(out, want):
                raise AssertionError(f"K8 {what}: rank {q}'s output differs from torch.cat")
            if not torch.equal(out2, want):
                raise AssertionError(f"K8 {what}: rank {q}'s output of a second call differs")
        (grid, vector, n_pairs, resident, chunk), = rg.launch_info(blocks)
        nbytes = blocks[0].numel() * blocks[0].element_size()
        cut = rg.gather_schedule(nbytes, [b.data_ptr() for b in blocks],
                                 [o.data_ptr() for o in again], resident)
        assert (grid, vector, n_pairs, chunk) == (cut.grid, cut.vector, cut.n_pairs,
                                                  cut.chunk), (what, cut)
        bulk = sum(cut.bulk)
        return ("bulk" if bulk == len(blocks) * nbytes and nbytes else
                "vector" if bulk == 0 else "bulk + vector")

    n_cases = 0
    with watchdog():
        for p in (1, 2, 3, 4, 8):
            for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
                for shape in ((768, 256), (6144,), (1001, 3), (1001,), (0, 8)):
                    blocks = [make(shape, dtype).to(dev) for _ in range(p)]
                    check(blocks, f"P={p} {dtype} {shape}")
                    n_cases += 1
                # a sliced base: rows 1.. of a [B + 1, 3] array start 3 elements in
                blocks = [make((1002, 3), dtype).to(dev)[1:] for _ in range(p)]
                assert dtype != torch.float32 or blocks[0].data_ptr() % 16 == 12
                check(blocks, f"P={p} {dtype} sliced base")
                n_cases += 1
        paths = {}
        for shape in K8_PATH_SHAPES:
            for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
                path = check([make(shape, dtype).to(dev) for _ in range(N_PARTS)],
                             f"P={N_PARTS} {dtype} {shape}")
                assert path == "bulk", f"K8 {shape} {dtype}: the sharded path's block took {path}"
                paths.setdefault(path, []).append(f"{list(shape)} {str(dtype)[6:]}")
                PATH_CHECKED.add(("K8", shape, dtype))
                n_cases += 1
        for shape in K8_PROCESS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.bool):
                path = check([make(shape, dtype).to(dev) for _ in range(PROCESS_GRAPH)],
                             f"P={PROCESS_GRAPH} {dtype} {shape}")
                assert path == "bulk", f"K8 {shape} {dtype}: the sharded path's block took {path}"
                PATH_CHECKED.add(("K8", shape, dtype))
                n_cases += 1
        # the bulk copies' boundaries: (shape, dtype, rows 1.. of a larger array)
        for p in (1, 2, 3, 4, 8):
            # 2 KB a rank: one chunk of the least size; 12 KB: exactly S of them
            for shape, dtype, sliced in (((512, 4), torch.float32, False),
                                         ((768, 4), torch.float32, False),
                                         ((768, 4), torch.float32, True),   # head, chunks, tail
                                         ((1025, 4), torch.int32, True),
                                         ((3,), torch.bool, False),          # under 16 bytes
                                         ((7, 3), torch.bfloat16, True)):
                full = (shape[0] + 1,) + shape[1:]
                blocks = [make(full, dtype).to(dev) for _ in range(p)]
                blocks = [b[1:] if sliced else b[:-1].contiguous() for b in blocks]
                path = check(blocks, f"P={p} {dtype} {shape}{' sliced' if sliced else ''}")
                if p == N_PARTS:
                    paths.setdefault(path, []).append(
                        f"{list(shape)} {str(dtype)[6:]}{' sliced' if sliced else ''}")
                n_cases += 1
        log(f"K8 exact against torch.cat in {n_cases} cases, each called twice (the two "
            f"calls equal), the launcher's cut equal to gather_schedule's: P 1/2/3/4/8 x "
            f"f32/bf16/int32/bool x [768,256], [6144], [1001,3], [1001], [0,8] and a sliced "
            f"base; P {N_PARTS} x the same types x the sharded forwards' blocks "
            f"{[list(shape) for shape in K8_PATH_SHAPES]}; P {PROCESS_GRAPH} x the same types x "
            f"phase 25's blocks {[list(shape) for shape in K8_PROCESS_SHAPES]}; "
            f"P 1/2/3/4/8 x one chunk, S chunks, "
            f"sliced S chunks ([512,4], [768,4] f32), [1025,4] int32 sliced, [3] bool, "
            f"[7,3] bf16 sliced")
        for path, cases in paths.items():
            log(f"K8 at P {N_PARTS}, {path}: {', '.join(cases)}")

        # 50 calls back to back, the inputs rewritten in place between them,
        # checked on the device with no host wait in the loop
        blocks = [make((6144, 256), torch.bfloat16).to(dev) for _ in range(N_PARTS)]
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        for call in range(50):
            for r, b in enumerate(blocks):
                b.mul_(-1).add_(float(call % 7 + r))
            outs = rg.ring_all_gather(blocks)
            want = torch.cat(blocks, 0)
            for out in outs:
                bad += (out != want).sum()
        torch.cuda.synchronize()
        assert int(bad) == 0, f"K8 reuse: {int(bad)} wrong elements over 50 calls"
        log("K8 50 calls back to back on one set of input buffers (data rewritten in "
            "place, no host wait between calls): exact")

        # two groups, each on a stream of its own with flag words of its own,
        # 30 calls each and nothing ordering one stream against the other
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        groups = [[make((6144, 256), torch.bfloat16).to(dev) for _ in range(N_PARTS)]
                  for _ in streams]
        bads = [torch.zeros((), dtype=torch.int64, device=dev) for _ in streams]
        torch.cuda.synchronize()
        for call in range(30):
            for i, (stream, group) in enumerate(zip(streams, groups)):
                with torch.cuda.stream(stream):
                    for r, b in enumerate(group):
                        b.mul_(-1).add_(float(call % 5 + r + i))
                    want = torch.cat(group, 0)
                    for out in rg.ring_all_gather(group):
                        bads[i] += (out != want).sum()
        torch.cuda.synchronize()
        assert [int(b) for b in bads] == [0, 0], f"K8 on two streams: {bads}"
        log("K8 two groups on two streams, 30 calls each, unordered against each other: "
            "exact")

        # blocks that need a gradient: K8 forward, and a backward that is the
        # reduce-scatter of the ranks' cotangents, equal to autograd through
        # one torch.cat (f32, integer-valued: exact)
        leaves = [b.float().requires_grad_() for b in blocks]
        ref = [b.float().requires_grad_() for b in blocks]
        weights = [torch.full((1, b.shape[1]), float(q + 1), device=dev)
                   for q, b in enumerate(blocks)]
        before = sa.LAUNCHES["K8"]
        outs = rg.ring_all_gather(leaves)
        assert sa.LAUNCHES["K8"] == before + 1 and all(o.requires_grad for o in outs)
        got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, weights)), leaves)
        cat = torch.cat(ref, 0)
        want = torch.autograd.grad(sum((cat * w).sum() for w in weights), ref)
        assert all(torch.equal(o.detach(), cat.detach()) for o in outs)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), "K8's backward"
        log(f"K8 under autograd at P {len(blocks)}: forward exact, backward (the "
            f"reduce-scatter of the ranks' cotangents) equal to autograd through torch.cat")

        for p, b in ((4, 6144), (2, 12288), (8, 3072)):
            blocks = [make((b, 256), torch.bfloat16).to(dev) for _ in range(p)]
            fn = lambda: rg.ring_all_gather(blocks)
            plain = lambda: rg.ring_all_gather_plain(blocks)
            library = lambda: [torch.cat(blocks, 0) for _ in range(p)]
            ms, plain_ms, lib_ms = (time_ms(torch, fn), time_ms(torch, plain),
                                    time_ms(torch, library))
            dev_ms = device_ms(torch, fn, (PROFILE_TAGS["K8"],))[PROFILE_TAGS["K8"]]
            block_bytes = b * 256 * 2
            n_bytes = p * block_bytes + p * p * block_bytes  # every input once, every output once
            b_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
            nvlink_ms = 1e3 * (p - 1) * block_bytes / 450e9
            log(f"K8 halo bf16 P={p} block [{b}, 256] (ranks on one card, HBM): exact, "
                f"ms {ms:.4f} device_ms {dev_ms} plain_ms {plain_ms:.4f} "
                f"[one torch.cat shared by all ranks] "
                f"library_ms {lib_ms:.4f} [torch.cat of the P blocks into each of P "
                f"outputs] bound_ms {b_ms:.4f} (bytes: {n_bytes} over HBM); over NVLink "
                f"not measured (its bound: {nvlink_ms:.4f} ms to receive "
                f"{(p - 1) * block_bytes} bytes per rank at 450 GB/s)")
            if p == N_PARTS:
                timed = k8_timings(torch, fn, blocks, [])
                log(f"K8 halo bf16 P={p} block [{b}, 256], one launch: {k8_text(timed)}")
                rows["K8"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms,
                              "device_ms": dev_ms, "host_us": timed["host_us"],
                              "entry_spin_us": timed["entry_spin_us"],
                              "streams_ms": timed["ms"],
                              "shape": f"halo bf16 P={p} block [{b}, 256], ranks on one card"}


def path_keys():
    """(module, wrapper, key of its call) for each place the sharded paths
    hand a kernel its inputs.  K1-K3: (E, N, D, dtype of the data); K4: (E,
    N, D, the output's dtype, scaled or not); K5: (E, N); K6: the shape of
    ``a``; K8: one block's shape and dtype."""
    import torch

    from hierarchicalgnn_torch.ops import connected
    from hierarchicalgnn_torch.ops.kernels import sddmm, sorted_agg as sa
    from hierarchicalgnn_torch.parallel import comm, graph_shard
    from hierarchicalgnn_torch.train import auction

    def rows(kernel):
        return lambda data, *rest: (kernel, data.shape[0], rest[-1].num_segments,
                                    data.shape[1], data.dtype)

    def k4(scale, g, plan, out_dtype=torch.float32):
        return "K4", plan.perm.shape[0], plan.num_segments, g.shape[1], out_dtype, scale is not None

    k5 = lambda values, plan: ("K5", values.shape[0], plan.num_segments)
    return ((sa, "_k1", rows("K1")), (sa, "_k2", rows("K2")), (sddmm, "_k2", rows("K2")),
            (sddmm, "_k3", rows("K3")), (sddmm, "scaled_gather", k4),
            (graph_shard, "sorted_segment_min_i32", k5), (connected, "sorted_segment_min_i32", k5),
            (auction, "row_top2", lambda a, prices: ("K6",) + tuple(a.shape)),
            (comm, "ring_all_gather",
             lambda blocks: ("K8", tuple(blocks[0].shape), blocks[0].dtype)))


class recording_path:
    """While the body runs, ``seen`` collects the key (``path_keys``) of
    every input that the body hands K1-K6 and K8; on a clean exit every one
    of them must have been held against the kernel's plain version by phase
    3 (``checked``, by default ``PATH_CHECKED``; None: a worker of phase 25,
    which hands its keys to the parent to check)."""

    def __init__(self, what, checked=PATH_CHECKED):
        self.what, self.seen, self.patches, self.checked = what, set(), [], checked

    def __enter__(self):
        from unittest import mock

        def recording(launch, key):
            def call(*args, **kwargs):
                self.seen.add(key(*args, **kwargs))
                return launch(*args, **kwargs)
            return call

        for module, name, key in path_keys():
            patch = mock.patch.object(module, name, recording(getattr(module, name), key))
            patch.start()
            self.patches.append(patch)
        return self

    def __exit__(self, exc_type, *exc):
        for patch in reversed(self.patches):
            patch.stop()
        if exc_type is None and self.checked is not None:
            unchecked = sorted(str(key) for key in self.seen - self.checked)
            kinds = {k: sum(key[0] == k for key in self.seen) for k in sorted(NAMES)}
            log(f"{self.what}: the kernels were handed "
                f"{ {k: n for k, n in kinds.items() if n} } kinds of input, "
                f"{'all' if not unchecked else 'NOT all'} held against their plain "
                f"versions in phase 3")
            assert not unchecked, f"{self.what}: kernel inputs never checked: {unchecked}"


def phase_halo(torch):
    """The flat-IN halo demonstration over 4 ranks with K8 as the halo
    (``rdma_gather``), f32, against the unsharded step: within 1e-4 (the
    receiver-partitioned segment sums add in another order)."""
    import numpy as np

    from hierarchicalgnn_torch.models.mlp import MLP
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel import halo

    dev = torch.device("cuda")
    n, e, latent, hidden, iterations = 24576, 98304, 128, 256, 3
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    sizes = (3, 6, 2 * latent, 3 * latent)
    mlps = [MLP(size, hidden, latent, 2, layer_norm=True,
                output_activation="Tanh" if i == 3 else "GELU") for i, size in enumerate(sizes)]
    for mlp in mlps:
        mlp.reset_parameters(gen)
        mlp.to(dev)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.95
    parts = [torch.from_numpy(a).to(dev) for a in halo.partition_edges_by_receiver(
        senders, receivers, mask, n, N_PARTS)]
    forward = halo.make_halo_flat_forward(halo.make_halo_flat_in(mlps, iterations),
                                          N_PARTS, rdma_gather=True)
    xd = torch.from_numpy(x).to(dev)
    with torch.no_grad(), watchdog(), recording_path("halo flat-IN"):
        before = sa.LAUNCHES["K8"]
        got = forward(xd, *parts)
        assert sa.LAUNCHES["K8"] - before == 1 + iterations == forward.collectives[
            "all_gather"], (sa.LAUNCHES, forward.collectives)
        want = halo.flat_in_reference_step(
            mlps, xd, torch.from_numpy(senders).to(dev), torch.from_numpy(receivers).to(dev),
            torch.from_numpy(mask).to(dev), n, iterations)
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"halo flat-IN P={N_PARTS} N={n} E={e} latent {latent}, {iterations} iterations, "
        f"K8 as the halo ({1 + iterations} launches): max_abs_err {err:.3e} against the "
        f"unsharded step")
    assert got.shape == (n, latent) and err <= 1e-4, err


def sharded_expect(hp, counts_k5):
    """Launches of one sharded eval forward over ``N_PARTS`` ranks, from the
    code.  K1 and K2: every rank launches what the unsharded forward
    launches.  K8, one launch per all-gather whatever P: the edge encoder's
    halo and one per IN cell; for a hierarchical model the embeddings and the
    node mask, the unit embeddings' halo of the clustering, the likelihood
    and its mask for the GMM fit (``score_cut`` still inf), one per
    connected-components hop (each rank's K5 launches), the supernode rows at
    the init, two per hierarchical cell (supernode rows, node halo) and, for
    a bipartite scorer, the supernode rows for the score head; EC-IN gathers
    its edge rows for the paired head."""
    name = hp["model"]
    n_in = hp["n_interaction_graph_iters"] if name != "gMRT" else 0
    n_hier = hp.get("n_hierarchical_graph_iters", 0) if "GMM" in name or name == "gMRT" else 0
    k1 = n_in + n_hier
    k2 = (1 + 3 * n_hier) if n_hier else 0
    k8 = 1 + n_in
    if name == "EC-IN":
        k8 += 1
    if n_hier:
        assert counts_k5 % N_PARTS == 0, counts_k5
        k8 += 2 + 1 + 2 + counts_k5 // N_PARTS + 1 + 2 * n_hier
        k8 += 1 if name in ("BC-HGNN-GMM", "gMRT") else 0
    return {"K1": N_PARTS * k1, "K2": N_PARTS * k2, "K8": k8}


def phase_sharded_serving(torch, events):
    """The flagship's graph-partitioned forward at full width and depth,
    bf16, over 4 ranks that share the card, pooled space partitioned, every
    all-gather through K8: 2 events after a warm-up.  Returns the launch
    counts of the 2 events and the kernels' mean device ms per launch."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_forward

    hp, _, pipeline = model_selector("BC-HGNN-GMM", {**FLAGSHIP, "halo_backend": "rdma"})
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"], hp["shard_pooled"]) == (
        256, 512, 6, 6, "bfloat16", True), hp
    forward = make_sharded_forward(pipeline, N_PARTS, hp)
    batches = [preprocess_event(raw, hp, stage="test") for raw in events]
    with watchdog(), recording_path("sharded flagship serving"):
        forward(batches[2])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sa.reset_launches()
        event_ms = []
        for seed, batch in enumerate(batches[:2]):
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            bgraph, scores, emb, aux = forward(batch)
            torch.cuda.synchronize()
            event_ms.append(1e3 * (time.perf_counter() - t0))
            counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
            stats = forward.last_stats
            log(f"sharded serve event seed={seed} P={N_PARTS}: {event_ms[-1]:.1f} ms (host "
                f"clock, forward only), n_clusters={stats['n_clusters']}, host_syncs="
                f"{stats['host_syncs']} (all ranks), collectives={stats['collectives']}, "
                f"partition_ok={stats['partition_ok']}, launches="
                f"{ {k: v for k, v in counts.items() if v} }")
            assert stats["partition_ok"], "a rank dropped edges (halo_slack too small)"
            assert counts["K5"] >= 2 * N_PARTS, counts
            expect = sharded_expect(hp, counts["K5"])
            for kernel, n in expect.items():
                assert counts[kernel] == n, (kernel, counts, expect)
            assert counts["K8"] == stats["collectives"]["all_gather"], (counts, stats)
            cap = hp["n_nodes_max"] * hp["bipartitegraph_sparsity"]
            assert scores.shape == (cap,) and emb.shape == (hp["n_nodes_max"], hp["emb_dim"])
            assert bgraph.senders.shape == (cap,) and bool(bgraph.edge_mask.any())
            assert bool(torch.isfinite(scores).all()) and bool(torch.isfinite(emb).all())
            assert bool(((scores >= 0) & (scores <= 1)).all()) and aux["n_clusters"] >= 1
        totals = dict(sa.LAUNCHES)
        log(f"sharded serving launches over 2 events: {totals}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        per_launch, _, _ = profile_call(torch, lambda: forward(batches[0]), event_ms[0],
                                        "one sharded forward", ("K1", "K2", "K5", "K8"))
    return totals, per_launch


def canonical_scores(torch, bgraph, scores, n_clusters_max):
    """(edge keys, scores) of the valid bipartite edges in key order: the
    sharded forward returns the kNN's edge order, the unsharded the
    receiver-sorted one."""
    valid = bgraph.edge_mask
    keys = (bgraph.senders * n_clusters_max + bgraph.receivers)[valid]
    order = torch.argsort(keys)
    return keys[order], scores[valid][order]


def recording_knn(knn, found):
    """``knn`` that also appends each result to ``found``."""
    def recording(*args, **kwargs):
        found.append(knn(*args, **kwargs))
        return found[-1]

    return recording


def replaying_knn(found, n, c):
    """A ``knn`` that hands a sharded forward the results an unsharded forward
    recorded (``found``: the super graph's over ``c`` supernodes, then the
    bipartite graph's over ``n`` nodes), by the order of each rank's calls
    (super graph first): the whole bipartite result where the pooled space is
    replicated, the calling rank's block of it where each rank mines its own
    rows."""
    from hierarchicalgnn_torch.parallel.comm import THREAD_PREFIX

    calls = {}

    def replayed(queries, *args, **kwargs):
        thread = threading.current_thread().name
        nth = calls[thread] = calls.get(thread, -1) + 1
        if nth % 2 == 0:
            assert queries.shape[0] == c, queries.shape
            return found[0]
        idx, d2 = found[1]
        rows = queries.shape[0]
        if rows == n:  # the replicated pooled space mines the whole event
            return idx, d2
        rank = int(thread.removeprefix(THREAD_PREFIX))
        return idx[rank * rows:(rank + 1) * rows], d2[rank * rows:(rank + 1) * rows]

    return replayed


def phase_sharded_parity(torch):
    """f32, depth 2 + 2, full width and capacities, 4 ranks: the sharded
    forward against the unsharded forward of the same weights, for both
    ``shard_pooled`` values: clusters equal, the same bipartite edges, scores
    and IN-block embeddings within 1e-4 (sums over per-rank partitions add in
    another order).  The sharded runs are given the unsharded run's kNN
    results, as phase 11 does, so a near-tie cannot give them another graph.
    Then ``halo_backend: rdma`` against ``xla`` without any replay, under
    ``torch.use_deterministic_algorithms`` (so that two runs of one backend
    are equal to begin with, which is checked): every output equal bit for
    bit."""
    from unittest import mock

    import numpy as np

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models import dynamic_graph
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_forward

    f32 = {**FLAGSHIP, "compute_dtype": None, "n_interaction_graph_iters": 2,
           "n_hierarchical_graph_iters": 2}
    hp, model, pipeline = model_selector("BC-HGNN-GMM", f32)
    engine = InferenceEngine(hp, model)
    batch = preprocess_event(generate_event(np.random.default_rng(0),
                                            n_particles=N_PARTICLES), hp, stage="test")
    found = []
    with mock.patch.object(dynamic_graph, "knn", recording_knn(dynamic_graph.knn, found)):
        ref = engine.forward(batch)
    assert len(found) == 2, "one kNN each for the super and the bipartite graph"
    n, c = hp["n_nodes_max"], hp["max_clusters"]
    replayed_knn = replaying_knn(found, n, c)

    ref_keys, ref_scores = canonical_scores(torch, ref[0], ref[1], c)
    with watchdog(), recording_path("sharded parity f32"):
        for pooled in (True, False):
            forward = make_sharded_forward(
                pipeline, N_PARTS, {**hp, "shard_pooled": pooled, "halo_backend": "rdma"})
            before = sa.LAUNCHES["K8"]
            with mock.patch.object(dynamic_graph, "knn", replayed_knn):
                out = forward(batch)
            torch.cuda.synchronize()
            assert forward.last_stats["partition_ok"]
            keys, scores = canonical_scores(torch, out[0], out[1], c)
            same_edges = torch.equal(keys, ref_keys)
            score_err = float((scores - ref_scores).abs().max()) if same_edges else None
            emb_err = float((out[2] - ref[2]).abs().max())
            log(f"sharded parity f32 (2 + 2) P={N_PARTS} shard_pooled={pooled}: n_clusters "
                f"{out[3]['n_clusters']} vs {ref[3]['n_clusters']}, bipartite edges "
                f"{'equal' if same_edges else 'DIFFER'} ({keys.numel()}), scores "
                f"max_abs_err {score_err}, IN-block embeddings {emb_err:.3e}, K8 launches "
                f"{sa.LAUNCHES['K8'] - before}")
            if not torch.equal(out[3]["clusters"], ref[3]["clusters"]):
                raise AssertionError("sharded and unsharded clusters differ")
            if not same_edges or score_err > 1e-4 or emb_err > 1e-4:
                raise AssertionError(f"sharded forward differs from the unsharded one: "
                                     f"edges equal {same_edges}, scores {score_err}, "
                                     f"embeddings {emb_err}")

        # index_add_ and index_put_ add with atomics in an order that changes
        # from run to run; their deterministic forms make two runs of one
        # backend comparable bit for bit, and so the two backends
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            outs = {}
            for label, backend in (("rdma", "rdma"), ("xla", "xla"), ("xla again", "xla")):
                forward = make_sharded_forward(pipeline, N_PARTS,
                                               {**hp, "halo_backend": backend})
                before = sa.LAUNCHES["K8"]
                with warnings.catch_warnings():  # ops without a deterministic form
                    warnings.simplefilter("ignore", UserWarning)
                    outs[label] = forward(batch)
                torch.cuda.synchronize()
                used = sa.LAUNCHES["K8"] - before
                assert (used > 0) == (backend == "rdma"), (backend, used)
        finally:
            torch.use_deterministic_algorithms(False)

    def differing(a, b):
        pairs = {"senders": (a[0].senders, b[0].senders),
                 "receivers": (a[0].receivers, b[0].receivers),
                 "edge_mask": (a[0].edge_mask, b[0].edge_mask), "scores": (a[1], b[1]),
                 "embeddings": (a[2], b[2]),
                 "clusters": (a[3]["clusters"], b[3]["clusters"])}
        return [name for name, (x, y) in pairs.items() if not torch.equal(x, y)]

    repeat = differing(outs["xla"], outs["xla again"])
    across = differing(outs["rdma"], outs["xla"])
    log(f"sharded parity f32, deterministic index_add_: two runs of the xla halo differ in "
        f"{repeat or 'nothing'}; the rdma halo against the xla halo differs in "
        f"{across or 'nothing: equal bit for bit'} (bipartite graph, scores, embeddings, "
        f"clusters)")
    if repeat:
        raise AssertionError(f"two runs of one backend differ in {repeat}: the comparison "
                             f"of the two halos has no footing")
    if across:
        raise AssertionError(f"the rdma and xla halos give different {across}")


def phase_sharded_models(torch, events):
    """One sharded event (4 ranks, ``halo_backend: rdma``) for each of the
    other four models at its shipped config and the flagship capacities, with
    the launch counts asserted.  Returns the summed launch counts."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_forward

    totals = {k: 0 for k in sa.LAUNCHES}
    for name in MODEL_LAUNCHES:
        hp, _, pipeline = model_selector(name, {**FLAGSHIP, "halo_backend": "rdma"})
        assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
                hp.get("n_hierarchical_graph_iters")) == MODEL_WIDTHS[name], hp
        forward = make_sharded_forward(pipeline, N_PARTS, hp)
        batches = [preprocess_event(raw, hp, stage="test") for raw in (events[2], events[0])]
        with watchdog(), recording_path(f"{name} sharded"):
            forward(batches[0])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sa.reset_launches()
            t0 = time.perf_counter()
            out = forward(batches[1])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        counts, stats = dict(sa.LAUNCHES), forward.last_stats
        log(f"{name} sharded event seed=0 P={N_PARTS}: {ms:.1f} ms (host clock, forward "
            f"only), stats={stats}, launches={ {k: v for k, v in counts.items() if v} }, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        assert stats["partition_ok"], name
        expect = sharded_expect(hp, counts["K5"])
        for kernel, n in expect.items():
            assert counts[kernel] == n, (name, kernel, counts, expect)
        assert counts["K8"] == stats["collectives"]["all_gather"], (name, counts, stats)
        assert (counts["K5"] >= 2 * N_PARTS) == ("GMM" in name or name == "gMRT"), counts
        tensors = [out] if torch.is_tensor(out) else [t for t in out[:3] if torch.is_tensor(t)]
        for t in tensors:
            assert bool(torch.isfinite(t).all()), name
        # the global outputs: scores of every input edge (EC-IN) or of every
        # bipartite slot (gMRT), embeddings of every node (the embedding models)
        if name == "EC-IN":
            assert out.shape == (hp["n_edges_max"],), out.shape
        elif name == "gMRT":
            assert out[1].shape == (hp["n_nodes_max"] * hp["bipartitegraph_sparsity"],)
        else:
            first = out if torch.is_tensor(out) else out[0]
            assert first.shape == (hp["n_nodes_max"], hp["emb_dim"]), first.shape
        for k in totals:
            totals[k] += counts[k]
        del forward, pipeline, out
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phases 16-19: the CLI, the checkpoint round trip, the grid kNN, streaming
# ---------------------------------------------------------------------------

def _flagship_sets(extra=()):
    """``--set`` arguments of the flagship capacities (the shipped widths,
    bf16, ``use_pallas: true``)."""
    sets = []
    for key, value in (*FLAGSHIP.items(), *extra):
        sets += ["--set", f"{key}={json.dumps(value)}"]
    return sets


def _scratch_dir():
    """A temporary directory inside the checkout's git-ignored build/ (the
    run directories hold checkpoints of 0.4 GB)."""
    import tempfile

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=root, prefix="smoke_")


CLI_MESH = {"data": 1, "graph": N_PARTS}  # the graph-sharded CLI runs of phases 16 and 26(f)


class cli_spies:
    """While the body runs: the devices on which every sharded forward placed
    its ranks (``graph_shard.place_inputs``; None on the default path) and
    the ``partition_ok`` of every training step (``Trainer._forward_backward``'s
    ``last_stats``)."""

    def __enter__(self):
        from unittest import mock

        from hierarchicalgnn_torch.parallel import comm, graph_shard
        from hierarchicalgnn_torch.train.trainer import Trainer

        self.placed, self.partition_ok = [], []
        forward_backward = Trainer._forward_backward

        def place(inputs, devices, buffers=()):
            self.placed.append(None if devices is None else [str(d) for d in devices])
            return comm.place_inputs(inputs, devices, buffers)

        def step(trainer, batch, epoch):
            out = forward_backward(trainer, batch, epoch)
            self.partition_ok.append(trainer.last_stats.get("partition_ok"))
            return out

        self.patches = [mock.patch.object(graph_shard, "place_inputs", place),
                        mock.patch.object(Trainer, "_forward_backward", step)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in reversed(self.patches):
            patch.stop()


def _cards(torch, devices):
    """The distinct cards among ``devices``, by index; the current card
    where ``devices`` is None."""
    if devices is None:
        return [torch.device("cuda", torch.cuda.current_device())]
    return sorted({torch.device(d) for d in devices}, key=lambda d: d.index)


def cli_on_devices(torch, run_dir, devices, common, resume_to=None):
    """The flagship through ``run.main`` over ``mesh_shape {data 1, graph 4}``
    and ``halo_backend: rdma`` with ``--devices``: ``train`` 1 epoch and,
    with ``resume_to``, ``resume`` from ``last`` to that many epochs, then
    ``test``.  Asserts that every sharded forward placed its ranks on
    ``devices``, that K8 launched, that ``partition_ok`` held at every step
    and that the metric log is finite with ``score_cut`` below the clamp.
    Returns the log, each command's seconds, the launches, the peak GiB per
    card and the test's metrics."""
    import contextlib
    import io

    from hierarchicalgnn_torch import run
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    cards = _cards(torch, devices)
    sets = [*common, "--set", f"mesh_shape={json.dumps(CLI_MESH)}", "--set",
            'halo_backend="rdma"', "--devices", ",".join(devices)]
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    before = dict(sa.LAUNCHES)
    seconds, tested = {}, None
    with cli_spies() as spy:
        t0 = time.perf_counter()
        run.main(["train", "--model", "4", "--run-dir", run_dir, "--max-epochs", "1", *sets])
        seconds["train"] = time.perf_counter() - t0
        if resume_to is not None:
            t0 = time.perf_counter()
            run.main(["resume", "--run-dir", run_dir, "--max-epochs", str(resume_to), *sets])
            seconds["resume"] = time.perf_counter() - t0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                run.main(["test", "--run-dir", run_dir, *sets])
            seconds["test"] = time.perf_counter() - t0
            tested = json.loads(out.getvalue().strip().splitlines()[-1])
    for d in cards:
        torch.cuda.synchronize(d)
    launches = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES if sa.LAUNCHES[k] > before[k]}
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
    records = [json.loads(line) for line in Path(run_dir, "metrics.jsonl").read_text().splitlines()]
    log(f"cli over --devices {','.join(devices)} (mesh {CLI_MESH}, rdma): seconds "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }, epoch_time "
        f"{[r['epoch_time'] for r in records if 'epoch_time' in r]} s, peak GiB per card "
        f"{[round(p, 2) for p in peaks]}, sharded forwards placed {len(spy.placed)} (on "
        f"{sorted({str(p) for p in spy.placed})}), partition_ok {spy.partition_ok}, launches "
        f"{launches}")
    assert spy.placed and all(p == list(devices) for p in spy.placed), spy.placed
    assert spy.partition_ok and all(ok is True for ok in spy.partition_ok), spy.partition_ok
    assert launches.get("K8", 0) > 0, f"the CLI's sharded run never launched K8: {launches}"
    for r in records:
        assert all(math.isfinite(v) for v in r.values() if isinstance(v, float)), r
        assert r.get("score_cut", 0.0) < SCORE_CUT_CLAMP, r
    return {"records": records, "seconds": seconds, "launches": launches, "peak_gib": peaks,
            "tested": tested}


def phase_cli(torch):
    """The CLI on the card at the flagship's width: ``train`` 2 epochs on
    ``train_split [2,1,1]``, ``resume`` to epoch 3, ``test``, and
    ``transfer`` BC -> gMRT for 1 epoch; then Embedding-IN ``train`` 1 epoch
    and ``test`` (HDBSCAN candidates); then the flagship's ``train`` 1 epoch
    over ``mesh_shape {data 1, graph 4}`` with ``--devices
    cuda:0,cuda:0,cuda:0,cuda:0`` (the placement path on the one card, K8
    and ``partition_ok`` asserted).  Returns the launch counts of the whole
    phase (this slice's main path)."""
    import contextlib
    import io

    from hierarchicalgnn_torch import run
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.train.checkpoint import restore_checkpoint

    common = ["--synthetic-particles", str(N_PARTICLES), "--log-every-n-steps", "1",
              *_flagship_sets((("train_split", [2, 1, 1]),))]
    with _scratch_dir() as tmp:
        bc, gmrt = f"{tmp}/bc", f"{tmp}/gmrt"
        torch.cuda.synchronize()
        sa.reset_launches()
        t0 = time.perf_counter()
        run.main(["train", "--model", "4", "--run-dir", bc, "--max-epochs", "2", *common])
        t_train = time.perf_counter() - t0
        files = sorted(p.name for p in Path(bc, "checkpoints").iterdir())
        assert files == ["best", "hparams.json", "last"], files
        records = [json.loads(line) for line in Path(bc, "metrics.jsonl").read_text().splitlines()]
        assert [r["epoch"] for r in records if "val_loss" in r] == [0, 1], records
        assert [r["step"] for r in records if "training_loss" in r] == [1, 2, 3, 4], records
        for r in records:
            assert all(math.isfinite(v) for v in r.values() if isinstance(v, float)), r
            assert r.get("score_cut", 0.0) < SCORE_CUT_CLAMP, r
        size = Path(bc, "checkpoints", "last").stat().st_size

        t0 = time.perf_counter()
        run.main(["resume", "--run-dir", bc, "--max-epochs", "3", *common])
        t_resume = time.perf_counter() - t0
        assert restore_checkpoint(bc, "last")["epoch"] == 2
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            run.main(["test", "--run-dir", bc, *common])
        t_test = time.perf_counter() - t0
        tested = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"cli test: {out.getvalue().strip().splitlines()[-1]}")
        assert set(tested) == {"val_loss", "track_eff", "track_pur", "hit_eff", "hit_pur"}
        assert math.isfinite(tested["val_loss"]) and 0.0 <= tested["track_eff"] <= 1.0

        t0 = time.perf_counter()
        run.main(["transfer", "--model", "5", "--run-dir", gmrt, "--source-run", bc,
                  "--max-epochs", "1", *common])
        t_transfer = time.perf_counter() - t0
        moved = restore_checkpoint(gmrt, "last")
        assert moved["epoch"] == 0 and moved["step"] == 2, (moved["epoch"], moved["step"])

        # an embedding model: its validation and test build HDBSCAN candidates
        emb = f"{tmp}/emb"
        t0 = time.perf_counter()
        run.main(["train", "--model", "2", "--run-dir", emb, "--max-epochs", "1", *common])
        t_emb_train = time.perf_counter() - t0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            run.main(["test", "--run-dir", emb, *common])
        t_emb_test = time.perf_counter() - t0
        emb_tested = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"cli Embedding-IN test: {out.getvalue().strip().splitlines()[-1]}")
        records = [json.loads(line)
                   for line in Path(emb, "metrics.jsonl").read_text().splitlines()]
        effs = ([r["track_eff"] for r in records if "track_eff" in r]
                + [r["test_track_eff"] for r in records if "test_track_eff" in r])
        assert any("test_track_eff" in r for r in records) and len(effs) >= 2, records
        assert all(math.isfinite(e) and 0.0 <= e <= 1.0 for e in effs + [emb_tested["track_eff"]])
        log(f"cli Embedding-IN: track_eff (validation, then test) {effs}")

        # the graph ranks placed by --devices, all on the one card
        placed = cli_on_devices(torch, f"{tmp}/placed", ["cuda:0"] * N_PARTS, common)
        torch.cuda.synchronize()
    counts = dict(sa.LAUNCHES)
    log(f"cli: train 2 epochs {t_train:.1f} s, resume 1 epoch {t_resume:.1f} s, test "
        f"{t_test:.1f} s, transfer BC -> gMRT 1 epoch {t_transfer:.1f} s, Embedding-IN train "
        f"1 epoch {t_emb_train:.1f} s and test {t_emb_test:.1f} s, train 1 epoch over "
        f"--devices cuda:0 x {N_PARTS} {placed['seconds']['train']:.1f} s (host clock, each "
        f"with its model build and 4 synthetic events); checkpoint {size / 2**20:.1f} MiB; "
        f"launches {counts}")
    for kernel in ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "HD1", "HD2"):
        assert counts[kernel] > 0, f"the CLI never launched {kernel}"
    return counts


def phase_checkpoint(torch, events):
    """Save at step 1, take step 2; restore the save into a fresh trainer
    and take step 2 again: f32, full width at depth 2 + 2, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``.  The
    restored run served through ``InferenceEngine.from_run`` gives the
    trainer's scores."""
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.train.pipelines import BipartitePipeline
    from hierarchicalgnn_torch.train.trainer import Trainer
    from hierarchicalgnn_torch.utils.config import load_config

    hp = load_config("bc_hgnn_gmm", {**FLAGSHIP, "compute_dtype": None, "remat": False,
                                     "n_interaction_graph_iters": 2,
                                     "n_hierarchical_graph_iters": 2})

    def trainer(run_dir, seed):
        model = build_model(hp, seed=seed)
        return Trainer(hp, model, BipartitePipeline(model, hp), run_dir=run_dir,
                       log_every_n_steps=0)

    with _scratch_dir() as tmp, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a = trainer(tmp, 0)
            a.init_state(seed=0)
            trainset = a.make_datasets(events)[0]
            a.train_step(trainset[0][2], TRAIN_EPOCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a._save("last", 0)
            save_s = time.perf_counter() - t0
            step_a = a.train_step(trainset[1][2], TRAIN_EPOCH)
            params_a = {k: v.detach().clone() for k, v in a.model.named_parameters()}
            del a

            b = trainer(tmp, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch = b.restore("last")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            assert epoch == 0 and b.step == 1
            engine = InferenceEngine.from_run(tmp, "last")
            batch = trainset[1][2]
            ours, served = b._val_forward(batch), engine.forward(batch)
            score_err = float((ours[1] - served[1]).abs().max())
            assert torch.equal(ours[0].receivers, served[0].receivers) and score_err == 0.0, \
                score_err
            step_b = b.train_step(batch, TRAIN_EPOCH)
            params_b = dict(b.model.named_parameters())
        finally:
            torch.use_deterministic_algorithms(False)
    loss_err = abs(step_b["training_loss"] - step_a["training_loss"])
    param_err = max(float((params_b[k].detach() - v).abs().max()) for k, v in params_a.items())
    bitwise = step_a == step_b and param_err == 0.0
    nondet = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                     if "deterministic" in str(w.message)})
    log(f"checkpoint round trip (f32, 2 + 2, full width): save {1e3 * save_s:.1f} ms, "
        f"restore {1e3 * restore_s:.1f} ms (host clock); step 2 after the save {step_a}; "
        f"after the restore {step_b}; |loss diff| {loss_err:.3e}, max |param diff| "
        f"{param_err:.3e}, {'bitwise equal' if bitwise else 'not bitwise'}; from_run scores "
        f"equal the restored trainer's; nondeterministic ops warned: {nondet or 'none'}")
    # the same ops on the same values: equal unless an op without a
    # deterministic form (warned above) added in a run-dependent order
    assert bitwise or (nondet and loss_err <= 1e-6 * abs(step_a["training_loss"])
                       and param_err <= 1e-6), (step_a, step_b, param_err)
    return {"save_ms": 1e3 * save_s, "restore_ms": 1e3 * restore_s, "bitwise": bitwise}


def _clustered_sphere(torch, n, gen, n_centers=2048, spread=0.05):
    """The JAX grid benchmark's cloud: points around 2048 random unit centres
    in 8-D, normalised (``scripts/bench_grid_knn.py``)."""
    centers = torch.nn.functional.normalize(torch.randn(n_centers, 8, generator=gen), dim=1)
    pts = centers[torch.randint(0, n_centers, (n,), generator=gen)]
    pts = pts + spread * torch.randn(n, 8, generator=gen)
    return torch.nn.functional.normalize(pts, dim=1).cuda()


def phase_grid_knn(torch, events):
    """``grid_knn_graph`` against the brute ``knn_graph`` on the card: the
    embeddings of a seeded Embedding-IN at N 24576 (d 8, k 100, ``train_r``,
    the shipped grid defaults M = N // 256, T 16) and a clustered cloud at
    N 131072 (M 512, T 16, cap 512); equal edges where ``exact``.  Then 2
    Embedding-IN training steps with ``knn_backend: grid``."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.grid_knn import grid_knn_graph
    from hierarchicalgnn_torch.ops.knn import knn_graph
    from hierarchicalgnn_torch.train.trainer import Trainer

    hp, model, pipeline = model_selector("Embedding-IN", FLAGSHIP)
    engine = InferenceEngine(hp, model)
    batch = preprocess_event(events[0], hp, stage="test")
    emb = engine.forward(batch)
    mask = torch.as_tensor(batch.node_mask, device=engine.device)
    n = emb.shape[0]
    gen = torch.Generator().manual_seed(0)
    cases = [("Embedding-IN embeddings", emb, mask, hp["train_r"], hp["knn"],
              dict(n_cells=max(n // 256, 16), n_probe=16), hp["knn_block_size"]),
             ("clustered cloud", _clustered_sphere(torch, GRID_FULL_N, gen), None, 1.0, 100,
              dict(n_cells=512, n_probe=16, cell_capacity=512), hp["knn_block_size"])]
    rows = {}
    for label, pts, pmask, r, k, kw, block in cases:
        grid = lambda: grid_knn_graph(pts, r, k, mask=pmask, **kw)
        brute = lambda: knn_graph(pts, r, k, mask=pmask, block_size=block)
        s, rcv, m, _, exact = grid()
        s_b, r_b, m_b, _ = brute()
        exact = bool(exact)
        if exact:
            assert torch.equal(m, m_b) and torch.equal(s[m], s_b[m_b]) \
                and torch.equal(rcv[m], r_b[m_b]), label
        grid_ms, brute_ms = time_ms(torch, grid, iters=3), time_ms(torch, brute, iters=3)
        rows[label] = {"n": pts.shape[0], "grid_ms": grid_ms, "brute_ms": brute_ms,
                       "exact": exact, "edges": int(m.sum()), **kw}
        log(f"grid kNN, {label}: N {pts.shape[0]} k {k} r {r} {kw}: grid {grid_ms:.2f} ms, "
            f"brute {brute_ms:.2f} ms (CUDA events, 3 calls), exact {exact}, "
            f"{int(m.sum())} edges{' equal to brute force' if exact else ''}")
    del engine, emb, cases
    torch.cuda.empty_cache()

    hp, model, pipeline = model_selector("Embedding-IN", {**FLAGSHIP, "knn_backend": "grid"})
    trainer = Trainer(hp, model, pipeline)
    trainer.init_state(seed=0)
    trainset, _, _ = trainer.make_datasets(events)
    for step in range(2):
        t0 = time.perf_counter()
        metrics = trainer.train_step(trainset[step][2], MODELS_EPOCH)
        torch.cuda.synchronize()
        log(f"Embedding-IN grid train step {step}: {1e3 * (time.perf_counter() - t0):.1f} ms "
            f"(host clock), metrics={metrics}")
        assert metrics["knn_exact"] in (0.0, 1.0), metrics
        assert all(math.isfinite(v) for v in metrics.values()) and metrics["grad_norm"] > 0
    return rows


def phase_streaming(torch, events):
    """``write_event`` 3 flagship events, then ``fit_streaming`` one epoch of
    2 steps through the loader built with g++ from native/hgnn_io.cc."""
    from hierarchicalgnn_torch.data import native_loader
    from hierarchicalgnn_torch.models.models import build_model
    from hierarchicalgnn_torch.train.pipelines import BipartitePipeline
    from hierarchicalgnn_torch.train.trainer import Trainer
    from hierarchicalgnn_torch.utils.config import load_config

    with _scratch_dir() as tmp:
        t0 = time.perf_counter()
        native_loader.library()
        build_s = time.perf_counter() - t0
        paths = []
        for i, raw in enumerate(events):
            paths.append(f"{tmp}/event{i}.hgnn")
            native_loader.write_event(paths[-1], raw)
        hp = load_config("bc_hgnn_gmm", FLAGSHIP)
        model = build_model(hp, seed=0)
        trainer = Trainer(hp, model, BipartitePipeline(model, hp), run_dir=f"{tmp}/run",
                          log_every_n_steps=1)
        t0 = time.perf_counter()
        history = trainer.fit_streaming(paths, events[:1], steps_per_epoch=2, max_epochs=1,
                                        n_threads=2)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        records = [json.loads(line)
                   for line in Path(trainer.run_dir, "metrics.jsonl").read_text().splitlines()]
        assert sorted(p.name for p in Path(trainer.run_dir, "checkpoints").iterdir()) == [
            "best", "hparams.json", "last"]
    steps = [r for r in records if "training_loss" in r]
    assert [r["step"] for r in steps] == [1, 2] and len(history) == 1, records
    assert all(math.isfinite(v) for r in records for v in r.values() if isinstance(v, float))
    step_s = steps[1]["time"] - steps[0]["time"]
    log(f"streaming: loader {native_loader.library_path().name} built and loaded in "
        f"{build_s:.1f} s; "
        f"fit_streaming 1 epoch of 2 steps + validation + 2 saves {total_s:.1f} s, the "
        f"second step {1e3 * step_s:.1f} ms (host clock, between its log records); {history[0]}")
    return {"step_ms": 1e3 * step_s, "epoch_s": total_s}


# ---------------------------------------------------------------------------
# phases 20-22: the graph-partitioned training step
# ---------------------------------------------------------------------------

SHARDED_STEP_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K8")


def phase_sharded_training(torch, events):
    """The flagship's graph-partitioned training step at its shipped
    operating point (bf16, full width and depth, the capacities of phase 4,
    3000-particle events) through ``Trainer.train_step`` with ``mesh_shape
    {data 1, graph 4}``, ``halo_backend: rdma`` and ``shard_pooled`` and
    ``shard_matching`` on: a warm-up step, then 2 timed steps at epoch 50 of
    ``emb_epoch`` 100.  Each step prints its host ms, the device's busy ms
    and idle share (from a repeat of the step on the same event under the
    profiler), its peak memory, the auction's rounds and its launches; K1-K6
    and K8 must all launch.  Returns the launch counts of the 2 timed steps,
    the kernels' device ms per launch (profiler) and one record per step."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

    hp, trainer = flagship_trainer({"mesh_shape": {"data": 1, "graph": N_PARTS},
                                    "halo_backend": "rdma"})
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"], hp["remat"],
            hp["shard_pooled"], hp.get("shard_matching", True)) == (
        256, 512, 6, 6, "bfloat16", False, True, True), hp
    assert trainer._sharded is not None and trainer._sharded.matching_spmd == N_PARTS
    trainset, _, _ = trainer.make_datasets(events)
    n_hier = hp["n_hierarchical_graph_iters"]
    totals = {k: 0 for k in sa.LAUNCHES}
    per_launch, records = {}, []
    with watchdog(), recording_path("sharded flagship training"):
        trainer.train_step(trainset[2][2], TRAIN_EPOCH)  # warm-up
        torch.cuda.synchronize()
        for step in range(2):
            batch = trainset[step][2]
            torch.cuda.reset_peak_memory_stats()
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch, TRAIN_EPOCH)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
            stats = dict(trainer.last_stats)
            peak = torch.cuda.max_memory_allocated() / 2**30
            for k in totals:
                totals[k] += counts[k]
            per_launch, _, busy = profile_call(
                torch, lambda: trainer.train_step(batch, TRAIN_EPOCH), ms,
                f"sharded train step {step} (its repeat under the profiler)",
                SHARDED_STEP_KERNELS, top=8)
            idle = None if busy is None else 100 * (1 - busy / ms)
            records.append({"host_ms": ms, "busy_ms": busy, "idle_pct": idle,
                            "peak_gib": peak, "rounds": stats["auction_rounds_launched"],
                            "launches": {k: counts[k] for k in SHARDED_STEP_KERNELS}})
            log(f"sharded train step {step} P={N_PARTS}: {ms:.1f} ms (host clock), device "
                f"busy {busy} ms, idle share {idle if idle is None else round(idle, 1)}%, "
                f"peak {peak:.2f} GiB, auction rounds {stats['auction_rounds_launched']} "
                f"(row-sharded), host_syncs={stats['host_syncs']} (all ranks), "
                f"collectives={stats['collectives']}, partition_ok={stats['partition_ok']}, "
                f"metrics={metrics}, launches={ {k: counts[k] for k in SHARDED_STEP_KERNELS} }")
            assert all(math.isfinite(v) for v in metrics.values()), metrics
            assert metrics["score_cut"] < SCORE_CUT_CLAMP, metrics
            assert stats["partition_ok"], "a rank dropped edges (halo_slack too small)"
            for kernel in SHARDED_STEP_KERNELS:
                assert counts[kernel] > 0, (kernel, counts)
            assert counts["K8"] == stats["collectives"]["all_gather"], (counts, stats)
            assert counts["K6"] == N_PARTS * stats["auction_rounds_launched"], (counts, stats)
            assert counts["K2"] == counts["K3"] == N_PARTS * (1 + 3 * n_hier), counts
            assert counts["K5"] % N_PARTS == 0, counts
    log("sharded training " + json.dumps(records))
    del trainer, trainset
    torch.cuda.empty_cache()
    return totals, per_launch, records


def phase_sharded_training_parity(torch, events):
    """f32, depth 2 + 2, full width and capacities, 4 ranks: one sharded
    training step against the unsharded step of the same weights and event,
    for both ``shard_pooled`` values, ``halo_backend: rdma``: the loss within
    1e-4 relative, every gradient within 1e-3 of its largest entry plus 1e-7,
    every buffer after the step within 1e-4 relative of the unsharded step's
    (each EMA moved once) and moved.  The sharded runs are given the
    unsharded run's kNN results, as phase 14 does; the matching runs
    row-sharded on its own, and the truth labels that differ are counted.
    Then ``rdma`` against ``xla``: the training forward bit for bit (under
    deterministic algorithms), the gradients within the same tolerance.  Then
    the row-sharded auction on phase 7's warm-like instance at 4 ranks
    against the unsharded auction with ``eps`` pinned: the same assignment
    and rounds, both timed.  Returns the phase's launch counts."""
    from unittest import mock

    import numpy as np

    from hierarchicalgnn_torch.models import dynamic_graph
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.comm import run_sharded
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
    from hierarchicalgnn_torch.train import auction, pipelines

    launches = dict(sa.LAUNCHES)
    hp, trainer = flagship_trainer({"compute_dtype": None, "n_interaction_graph_iters": 2,
                                    "n_hierarchical_graph_iters": 2})
    model, pipeline = trainer.model, trainer.pipeline
    batch = trainer.make_datasets(events[:1])[0][0][2]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n, c = hp["n_nodes_max"], hp["max_clusters"]
    truths, match = {}, pipelines.match_particles_to_candidates

    def recording_match(label):
        """The matching, recording its truth labels by edge key: the sharded
        step's bipartite graph is in the kNN's edge order, the unsharded one's
        receiver-sorted."""
        def run(scores, senders, receivers, mask, *args, **kwargs):
            out = match(scores, senders, receivers, mask, *args, **kwargs)
            keys = (senders * c + receivers)[mask]
            order = torch.argsort(keys)
            truths[label] = (keys[order], out[0][mask][order])
            return out
        return run

    def restart():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(start[k])

    found = []
    with mock.patch.object(dynamic_graph, "knn", recording_knn(dynamic_graph.knn, found)), \
            mock.patch.object(pipelines, "match_particles_to_candidates",
                              recording_match("unsharded")):
        ref_grads, ref_metrics = trainer._forward_backward(batch, TRAIN_EPOCH)
    assert len(found) == 2, "one kNN each for the super and the bipartite graph"
    ref_buffers = {k: v.clone() for k, v in model.named_buffers()}
    ref_loss = float(ref_metrics["training_loss"].detach())

    def compare(grads, want, label):
        """The worst gradient error as a share of its bound, and of its leaf's
        largest entry (leaves above 1e-5)."""
        worst, worst_rel = 0.0, 0.0
        for (path, _), g, w in zip(model.named_parameters(), grads, want):
            assert (g is None) == (w is None), (label, path)
            if w is None:
                continue
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.abs().max())
            worst = max(worst, err / (1e-3 * scale + 1e-7))
            if scale > 1e-5:  # not the leaf whose true gradient is zero
                worst_rel = max(worst_rel, err / scale)
        return worst, worst_rel

    def sharded_step(overrides):
        return make_sharded_train_step(pipeline, trainer.optimizer, {"graph": N_PARTS},
                                       {**hp, **overrides})

    with watchdog(), recording_path("sharded training parity f32"):
        for pooled in (True, False):
            restart()
            step = sharded_step({"shard_pooled": pooled, "halo_backend": "rdma"})
            label = f"sharded pooled={pooled}"
            with mock.patch.object(dynamic_graph, "knn", replaying_knn(found, n, c)), \
                    mock.patch.object(pipelines, "match_particles_to_candidates",
                                      recording_match(label)):
                grads, metrics = step.forward_backward(batch, TRAIN_EPOCH)
            torch.cuda.synchronize()
            loss = float(metrics["training_loss"])
            loss_err = abs(loss / ref_loss - 1)
            worst, worst_rel = compare(grads, ref_grads, label)
            buffers = dict(model.named_buffers())
            # each buffer's error as a share of 1e-4 of its value plus 1e-6
            buf_err = max(float(((buffers[k] - v).abs() / (1e-4 * v.abs() + 1e-6)).max())
                          for k, v in ref_buffers.items())
            unmoved = [k for k, v in buffers.items() if torch.equal(v, start[k])]
            (keys, truth), (ref_keys, ref_truth) = truths[label], truths["unsharded"]
            assert torch.equal(keys, ref_keys), "the sharded step matched other edges"
            flipped = int((truth != ref_truth).sum())
            log(f"sharded training parity f32 (2 + 2) P={N_PARTS} shard_pooled={pooled}: "
                f"loss {loss:.7f} vs {ref_loss:.7f} (rel {loss_err:.2e}), clusters "
                f"{metrics['clusters']:.0f} vs {ref_metrics['clusters']}, worst gradient "
                f"error {worst:.3f} of its bound ({worst_rel:.2e} of its leaf's largest "
                f"entry), worst buffer error {buf_err:.3f} of its bound, matching truth "
                f"labels that differ {flipped} of {truth.numel()}, auction rounds "
                f"{step.last_stats['auction_rounds_launched']} (row-sharded), "
                f"collectives {step.last_stats['collectives']}")
            assert step.last_stats["partition_ok"]
            assert float(metrics["clusters"]) == float(ref_metrics["clusters"])
            if loss_err > 1e-4 or worst > 1 or buf_err > 1 or unmoved:
                raise AssertionError(
                    f"sharded training step differs from the unsharded one: loss {loss_err}, "
                    f"gradients {worst} of the bound, buffers {buf_err}, unmoved {unmoved}")

        # rdma against xla: the forward bit for bit, the gradients within tolerance
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            outs, grads = {}, {}
            for label, backend in (("rdma", "rdma"), ("xla", "xla"), ("xla again", "xla")):
                restart()
                step = sharded_step({"halo_backend": backend})
                before = sa.LAUNCHES["K8"]
                with warnings.catch_warnings():  # ops without a deterministic form
                    warnings.simplefilter("ignore", UserWarning)
                    out, _ = step.forward(batch)
                    outs[label] = [t.detach() for t in (out[0].senders, out[0].receivers,
                                                         out[0].edge_mask, out[1], out[2],
                                                         out[3]["clusters"])]
                    del out
                    if label != "xla again":
                        restart()
                        grads[label], _ = step.forward_backward(batch, TRAIN_EPOCH)
                torch.cuda.synchronize()
                assert (sa.LAUNCHES["K8"] > before) == (backend == "rdma"), backend
        finally:
            torch.use_deterministic_algorithms(False)
    names = ("senders", "receivers", "edge_mask", "scores", "embeddings", "clusters")
    repeat = [k for k, a, b in zip(names, outs["xla"], outs["xla again"]) if not torch.equal(a, b)]
    across = [k for k, a, b in zip(names, outs["rdma"], outs["xla"]) if not torch.equal(a, b)]
    worst, worst_rel = compare(grads["rdma"], grads["xla"], "rdma vs xla")
    log(f"sharded training forward f32, deterministic: two xla runs differ in "
        f"{repeat or 'nothing'}; rdma against xla differs in "
        f"{across or 'nothing: equal bit for bit'}; gradients rdma against xla: worst "
        f"{worst:.3f} of the bound ({worst_rel:.2e} of the leaf's largest entry)")
    if repeat:
        raise AssertionError(f"two runs of one backend differ in {repeat}")
    if across or worst > 1:
        raise AssertionError(f"rdma and xla training steps differ: {across}, {worst}")
    restart()
    del trainer, model, pipeline, ref_grads, grads
    torch.cuda.empty_cache()

    # the row-sharded auction against the unsharded one, eps pinned
    scores, p, c_valid = warm_like_instance(np)
    row_max = scores[:p, :c_valid].max(1)
    eps = float(np.float32(1e-2) * row_max[row_max > 0].sum() / (row_max > 0).sum())
    dev_scores = torch.from_numpy(scores).to(torch.device("cuda"))
    rows = scores.shape[0] // N_PARTS

    def unsharded():
        return auction.auction_match(dev_scores, p, c_valid, eps=eps, return_iters=True)

    def sharded():
        outs, _ = run_sharded(lambda k: auction.auction_match(
            dev_scores[k.index * rows:(k.index + 1) * rows], p, c_valid, eps=eps,
            return_iters=True, comm=k), N_PARTS, device=dev_scores.device)
        return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
                outs[0][2], outs[0][3])

    times = {}
    for label, fn in (("unsharded", unsharded), ("row-sharded", sharded)):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[label] = (1e3 * (time.perf_counter() - t0), result)
    (u_ms, u), (s_ms, s) = times["unsharded"], times["row-sharded"]
    same = torch.equal(u[0], s[0]) and torch.equal(u[1], s[1])
    log(f"auction {p} x {c_valid} eps pinned {eps:.6g}: unsharded {int(u[2])} rounds "
        f"{u_ms:.1f} ms, row-sharded over {N_PARTS} ranks {int(s[2])} rounds {s_ms:.1f} ms "
        f"(host clock); assignment {'equal' if same else 'DIFFERS'}, unassigned "
        f"{int(u[3])} / {int(s[3])}")
    assert same and int(u[2]) == int(s[2]) and int(s[3]) == int(u[3]) == 0
    return {k: sa.LAUNCHES[k] - launches[k] for k in sa.LAUNCHES}


def phase_sharded_models_training(torch, events):
    """One sharded training step (4 ranks, ``halo_backend: rdma``, after a
    warm-up step) of EC-IN, Embedding-IN, Embedding-HGNN-GMM and gMRT at their
    shipped configs and the flagship capacities, with K8 counted; then one
    ``Trainer.fit`` epoch of the flagship with ``mesh_shape {data 2, graph
    4}`` and ``train_split [3,1,1]``: 2 steps of 2 events, the ragged tail
    repeated.  Returns the summed launch counts."""
    import numpy as np

    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.train.trainer import Trainer

    mesh = {"mesh_shape": {"data": 1, "graph": N_PARTS}, "halo_backend": "rdma"}
    totals = {k: 0 for k in sa.LAUNCHES}
    for name in MODEL_LAUNCHES:
        hp, model, pipeline = model_selector(name, {**FLAGSHIP, **mesh})
        assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
                hp.get("n_hierarchical_graph_iters")) == MODEL_WIDTHS[name], hp
        trainer = Trainer(hp, model, pipeline)
        trainer.init_state(seed=0)
        trainset, _, _ = trainer.make_datasets(events)
        with watchdog(), recording_path(f"{name} sharded training"):
            trainer.train_step(trainset[2][2], MODELS_EPOCH)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            metrics = trainer.train_step(trainset[0][2], MODELS_EPOCH)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
        stats = trainer.last_stats
        log(f"{name} sharded train step P={N_PARTS}: {ms:.1f} ms (host clock), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, metrics={metrics}, "
            f"stats={stats}, launches={ {k: v for k, v in counts.items() if v} }")
        assert all(math.isfinite(v) for v in metrics.values()), (name, metrics)
        assert stats["partition_ok"], name
        assert counts["K8"] == stats["collectives"]["all_gather"] > 0, (name, counts, stats)
        assert counts["K1"] > 0 and counts["K4"] > 0, (name, counts)
        hier = name in ("Embedding-HGNN-GMM", "gMRT")
        for kernel in ("K2", "K3", "K5"):
            assert (counts[kernel] > 0) == hier, (name, kernel, counts)
        if hier:
            assert metrics["score_cut"] < SCORE_CUT_CLAMP, (name, metrics)
        if name == "gMRT":
            assert counts["K6"] == N_PARTS * stats["auction_rounds_launched"] > 0, counts
        for k in totals:
            totals[k] += counts[k]
        del trainer, model, pipeline, trainset
        torch.cuda.empty_cache()

    # the data axis over the graph partition, through Trainer.fit
    hp, trainer = flagship_trainer({"mesh_shape": {"data": 2, "graph": N_PARTS},
                                    "halo_backend": "rdma", "train_split": [3, 1, 1]})
    seen, forward = [], trainer._sharded.forward
    trainer._sharded.forward = lambda ev, stats: seen.append(ev) or forward(ev, stats)
    raw = events + [generate_event(np.random.default_rng(seed), n_particles=N_PARTICLES)
                    for seed in (3, 4)]
    before = dict(sa.LAUNCHES)
    t0 = time.perf_counter()
    with watchdog(), recording_path("flagship fit over data 2 x graph 4"):
        history = trainer.fit(raw, max_epochs=1, num_sanity_val_steps=0)
    counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
    log(f"flagship fit, mesh_shape data 2 x graph {N_PARTS}: {trainer.step} steps of "
        f"{len(seen)} sharded event forwards in {time.perf_counter() - t0:.1f} s (host "
        f"clock, validation included), steps per epoch {trainer._steps_per_epoch()}, "
        f"step log {trainer.step_log}, validation {history[0]}, launches="
        f"{ {k: v for k, v in counts.items() if v} }")
    assert trainer.step == 2 == trainer._steps_per_epoch() and len(seen) == 4
    assert seen[3] is seen[2], "the ragged tail repeats its last event"
    assert all(math.isfinite(v) for rec in trainer.step_log for v in rec.values())
    assert all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters())
    for k in totals:
        totals[k] += counts[k]
    del trainer
    torch.cuda.empty_cache()
    return totals


TP_STEP_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")
# The leaf whose true gradient is zero (the bias of the bipartite weights'
# batch norm): Adam moves it by the normalised rounding noise, a step of up to
# the learning rate either way, in any two runs that round differently
NOISE_LEAF = "hgnn.bipartite_graph_construction.weight_normalization.bias"


def tp_step_for(hp, trainer, data=1, overrides=None):
    """A fresh optimizer like the trainer's and the TP step over ``{data,
    model N_PARTS}`` from the trainer's current state: (state, step)."""
    from hierarchicalgnn_torch.parallel import tp
    from hierarchicalgnn_torch.train.checkpoint import train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer

    hp = {**hp, **(overrides or {})}
    optimizer = make_optimizer(list(trainer.model.parameters()), hp,
                               trainer._steps_per_epoch())
    mesh = tp.make_tp_mesh(data, N_PARTS, hp["hidden"])
    return tp.make_tp_train_step(trainer.pipeline, optimizer, mesh,
                                 train_state(trainer.model, optimizer), hp["hidden"])


def phase_tp_training(torch, events):
    """The flagship's tensor-parallel training step at its shipped operating
    point (bf16, latent 256, hidden 512, 6 + 6 iterations, the capacities of
    phase 4, 3000-particle events) through ``make_tp_train_step`` over ``{data
    1, model 4}``: each of the 4 ranks (threads on the one card) holds 128 of
    the 512 hidden columns of every MLP and runs the graph work itself.  A
    warm-up step, then 2 timed steps at epoch 50, each with its host ms, the
    device's busy ms and idle share (from a repeat under the profiler), its
    peak memory, its launches and its collectives by kind; K1-K6 must all
    launch and ``score_cut`` stay below the atanh clamp.  Then the bf16 TP loss
    against the unsharded bf16 loss of the same weights and event, beside the
    unsharded f32 loss (the size of bf16's own rounding).  Then one TP step of
    each other model at its shipped widths.  Returns the summed launch counts
    of the flagship's 2 timed steps, those of the other models' steps and the
    records."""
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel import tp
    from hierarchicalgnn_torch.train.checkpoint import load_model_state
    from hierarchicalgnn_torch.train.trainer import Trainer

    hp, trainer = flagship_trainer({})
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"], hp["remat"]) == (
        256, 512, 6, 6, "bfloat16", False), hp
    trainset, _, _ = trainer.make_datasets(events)
    state, step = tp_step_for(hp, trainer)
    assert state.split and all(
        rank[n].shape[d] * N_PARTS == trainer.model.get_parameter(n).shape[d]
        for rank in state.params for n, d in state.split.items())
    totals = {k: 0 for k in sa.LAUNCHES}
    records = []
    with watchdog(), recording_path("TP flagship training"):
        state, _ = step(state, trainset[2][2], TRAIN_EPOCH)  # warm-up
        torch.cuda.synchronize()
        for i in range(2):
            batch = trainset[i][2]
            if i == 0:
                before_weights = tp.unshard_state(state)
            torch.cuda.reset_peak_memory_stats()
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, TRAIN_EPOCH)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
            peak = torch.cuda.max_memory_allocated() / 2**30
            stats = dict(step.last_stats)
            values = {k: float(v) for k, v in metrics.items()}
            if i == 0:
                tp_loss = values["training_loss"]
            for k in totals:
                totals[k] += counts[k]

            def again():
                nonlocal state
                state, _ = step(state, batch, TRAIN_EPOCH)

            _, _, busy = profile_call(torch, again, ms,
                                      f"TP train step {i} (its repeat under the profiler)",
                                      TP_STEP_KERNELS, top=8)
            idle = None if busy is None else 100 * (1 - busy / ms)
            records.append({"host_ms": ms, "busy_ms": busy, "idle_pct": idle,
                            "peak_gib": peak, "collectives": stats["collectives"],
                            "launches": {k: counts[k] for k in TP_STEP_KERNELS}})
            log(f"TP train step {i} data 1 x model {N_PARTS}: {ms:.1f} ms (host clock), "
                f"device busy {busy} ms, idle share {idle if idle is None else round(idle, 1)}%, "
                f"peak {peak:.2f} GiB, host_syncs={stats['host_syncs']} (all ranks), "
                f"collectives={stats['collectives']}, metrics={values}, "
                f"launches={ {k: counts[k] for k in TP_STEP_KERNELS} }")
            assert all(math.isfinite(v) for v in values.values()), values
            assert values["score_cut"] < SCORE_CUT_CLAMP, values
            for kernel in TP_STEP_KERNELS:
                assert counts[kernel] > 0, (kernel, counts)
            assert stats["collectives"]["all_gather"] == 0 < stats["collectives"][
                "all_gather_features"] and counts["K8"] == 0, (stats, counts)
    log("TP training " + json.dumps(records))

    # the bf16 TP loss against the unsharded bf16 and f32 losses of its weights
    losses = {}
    for dtype in ("bfloat16", None):
        _, unsharded = flagship_trainer({"compute_dtype": dtype})
        load_model_state(unsharded.model, before_weights)
        unsharded.model.train()
        with torch.no_grad():
            loss, _ = unsharded.pipeline.loss(trainset[0][2], TRAIN_EPOCH)
        losses[dtype or "float32"] = float(loss)
        del unsharded
    bf16, f32 = losses["bfloat16"], losses["float32"]
    log(f"TP bf16 loss {tp_loss:.7f}, unsharded bf16 {bf16:.7f} (rel "
        f"{abs(tp_loss / bf16 - 1):.3e}), unsharded f32 {f32:.7f} (bf16 against f32: rel "
        f"{abs(bf16 / f32 - 1):.3e}; TP against f32: rel {abs(tp_loss / f32 - 1):.3e})")
    records.append({"tp_bf16_loss": tp_loss, "unsharded_bf16_loss": bf16,
                    "unsharded_f32_loss": f32})
    del trainer, trainset, state, step
    torch.cuda.empty_cache()

    models = {k: 0 for k in sa.LAUNCHES}
    for name in MODEL_LAUNCHES:
        hp, model, pipeline = model_selector(name, FLAGSHIP)
        assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
                hp.get("n_hierarchical_graph_iters")) == MODEL_WIDTHS[name], hp
        trainer = Trainer(hp, model, pipeline)
        trainer.init_state(seed=0)
        trainset, _, _ = trainer.make_datasets(events)
        state, step = tp_step_for(hp, trainer)
        with watchdog(), recording_path(f"{name} TP training"):
            state, _ = step(state, trainset[2][2], MODELS_EPOCH)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            state, metrics = step(state, trainset[0][2], MODELS_EPOCH)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
        values = {k: float(v) for k, v in metrics.items()}
        log(f"{name} TP train step data 1 x model {N_PARTS} ({len(state.split)} of "
            f"{len(state.names)} leaves split): {ms:.1f} ms (host clock), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, metrics={values}, "
            f"collectives={step.last_stats['collectives']}, "
            f"launches={ {k: v for k, v in counts.items() if v} }")
        assert all(math.isfinite(v) for v in values.values()), (name, values)
        assert counts["K1"] > 0 and counts["K4"] > 0 and counts["K8"] == 0, (name, counts)
        hier = name in ("Embedding-HGNN-GMM", "gMRT")
        for kernel in ("K2", "K3", "K5"):
            assert (counts[kernel] > 0) == hier, (name, kernel, counts)
        if hier:
            assert values["score_cut"] < SCORE_CUT_CLAMP, (name, values)
        for k in models:
            models[k] += counts[k]
        del trainer, model, pipeline, trainset, state, step
        torch.cuda.empty_cache()
    return totals, models, records


def phase_tp_parity(torch, events):
    """f32 (``remat`` on, the f32 default), depth 2 + 2, full width and
    capacities: one TP step over ``{data 1, model 4}`` and over ``{data 2,
    model 4}`` against the unsharded ``make_dp_train_step`` of the same
    weights and events, then ``{data 1, model 4}`` once more with
    ``gradient_clip_val`` 1e-3, far below the gradient's norm.  The bounds are
    the JAX test's: the loss within 1e-4 relative, every parameter after the
    step within rtol 5e-4 and atol 1e-5 (the leaf whose true gradient is zero
    within twice the learning rate), and with the clip the ``grad_norm``
    within 1e-4 relative.  The TP runs are given the unsharded runs' kNN
    results, as phase 21 does.  Returns the phase's launch counts."""
    from unittest import mock

    from hierarchicalgnn_torch.models import dynamic_graph
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel import tp
    from hierarchicalgnn_torch.parallel.step import make_dp_train_step
    from hierarchicalgnn_torch.train.checkpoint import load_model_state, train_state
    from hierarchicalgnn_torch.train.optim import apply_gradients, make_optimizer

    launches = dict(sa.LAUNCHES)
    hp, trainer = flagship_trainer({"compute_dtype": None, "n_interaction_graph_iters": 2,
                                    "n_hierarchical_graph_iters": 2})
    assert hp["remat"] is True and hp["hidden"] == 512, hp
    model, pipeline = trainer.model, trainer.pipeline
    batches = [b for _, _, b in trainer.make_datasets(events)[0][:2]]
    start = train_state(model, trainer.optimizer)

    def replaying(found):
        """``knn`` that hands each rank the unsharded run's results in the
        order of its own calls."""
        calls = {}

        def replayed(*args, **kwargs):
            thread = threading.current_thread().name
            calls[thread] = calls.get(thread, -1) + 1
            return found[calls[thread]]

        return replayed

    with watchdog(), recording_path("TP training parity f32"):
        for data, clip in ((1, None), (2, None), (1, 1e-3)):
            over = {} if clip is None else {"gradient_clip_val": clip}
            batch = batches[0] if data == 1 else batches[:data]
            load_model_state(model, start)
            optimizer = make_optimizer(list(model.parameters()), {**hp, **over},
                                       trainer._steps_per_epoch())
            found = []
            with mock.patch.object(dynamic_graph, "knn",
                                   recording_knn(dynamic_graph.knn, found)):
                grads, want = make_dp_train_step(pipeline, optimizer, {"data": data}
                                                 ).forward_backward(batch, TRAIN_EPOCH)
                apply_gradients(optimizer, list(model.parameters()), grads)
            assert len(found) == 2 * data, "one kNN each for the super and the bipartite graph"
            want_params = {n: p.detach().clone() for n, p in model.named_parameters()}
            lr = optimizer.schedule(0)
            del grads

            load_model_state(model, start)
            state, step = tp_step_for(hp, trainer, data, over)
            with mock.patch.object(dynamic_graph, "knn", replaying(found)):
                state, got = step(state, batch, TRAIN_EPOCH)
            torch.cuda.synchronize()
            params = tp.unshard_state(state)["params"]
            loss, ref_loss = float(got["training_loss"]), float(want["training_loss"])
            norm, ref_norm = float(got["grad_norm"]), float(want["grad_norm"])
            worst, where = 0.0, None
            for n, value in want_params.items():
                diff = (params[n].to(value.device) - value).abs()
                bound = 2 * lr if n == NOISE_LEAF else 1e-5 + 5e-4 * value.abs()
                share = float((diff / bound).max())
                if share > worst:
                    worst, where = share, n
            label = f"data {data} x model {N_PARTS}" + ("" if clip is None else f", clip {clip}")
            log(f"TP training parity f32 (2 + 2) {label}: loss {loss:.7f} vs {ref_loss:.7f} "
                f"(rel {abs(loss / ref_loss - 1):.2e}), grad_norm {norm:.6g} vs {ref_norm:.6g} "
                f"(rel {abs(norm / ref_norm - 1):.2e}), clusters {float(got['clusters']):.0f} "
                f"vs {float(want['clusters']):.0f}, worst parameter {worst:.3f} of its bound "
                f"({where}), collectives {step.last_stats['collectives']}")
            assert clip is None or ref_norm > 100 * clip, (ref_norm, clip)
            if abs(loss / ref_loss - 1) > 1e-4 or worst > 1 or (
                    clip is not None and abs(norm / ref_norm - 1) > 1e-4):
                raise AssertionError(f"TP step {label} differs from the unsharded one")
            del state, step
    load_model_state(model, start)
    del trainer, model, pipeline
    torch.cuda.empty_cache()
    return {k: sa.LAUNCHES[k] - launches[k] for k in sa.LAUNCHES}


# ---------------------------------------------------------------------------
# Phase 25: the data axis over processes
# ---------------------------------------------------------------------------

PROCESS_WORLD = 2        # processes of phase 25, each with its own card context
PROCESS_TIMEOUT_S = 600  # each worker's limit
GROUP_TIMEOUT_S = 300    # every collective of the workers' group
PROCESS_TAG = "PROCESS_RESULT "


def process_batch(mesh, event):
    """This process's event as its part of the global batch."""
    from hierarchicalgnn_torch.parallel import distributed
    from hierarchicalgnn_torch.parallel.mesh import batch_sharding
    from hierarchicalgnn_torch.parallel.step import stack_events

    return distributed.globalize_batch(stack_events([event]), batch_sharding(mesh))


def process_flagship(torch, rank, events, devices=None):
    """Worker, part (a): the flagship (bf16, full width and depth, the
    capacities of phase 4) through ``make_sharded_train_step`` over ``{data
    2 across the processes, graph 2 in each}``, ``halo_backend: rdma``: a
    warm-up step and 2 timed steps, process r on its own event r, each with
    its host ms, device busy ms (a repeat under the profiler), peak memory,
    launches and the cross-process all-gather's count, bytes and host ms;
    ``assert_host_identical`` on params, moments and buffers before the
    warm-up and after each timed step and its repeat (which lines the
    processes up for the next timed step).  ``devices``: this process's
    cards (phase 26(e)), on which ``make_global_mesh`` puts its graph ranks;
    busy, idle and peak are then per card, and the all-gather of the step's
    bytes is timed alone 5 times (CUDA events, packing included)."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel import distributed
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
    from hierarchicalgnn_torch.train.checkpoint import train_state

    hp, trainer = flagship_trainer({"halo_backend": "rdma"})
    assert (hp["latent"], hp["hidden"], hp["n_interaction_graph_iters"],
            hp["n_hierarchical_graph_iters"], hp["compute_dtype"], hp["remat"]) == (
        256, 512, 6, 6, "bfloat16", False), hp
    mesh = distributed.make_global_mesh(graph_per_host=PROCESS_GRAPH, devices=devices)
    assert mesh.shape == {"data": PROCESS_WORLD, "graph": PROCESS_GRAPH}, mesh
    cards = _cards(torch, devices)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    trainset, _, _ = trainer.make_datasets(events)
    batch = process_batch(mesh, trainset[rank][2])
    step = make_sharded_train_step(trainer.pipeline, trainer.optimizer, mesh, hp)
    assert step.matching_spmd is None and step.n_local == 1
    assert next(trainer.model.parameters()).device == cards[0]
    distributed.replicate(train_state(trainer.model, trainer.optimizer), mesh, check=True)
    records = []
    with watchdog(), recording_path("processes flagship", checked=None) as rec:
        step(batch, TRAIN_EPOCH)  # warm-up
        sync()
        for i in range(2):
            # the processes start each timed step together: the last
            # collective before it is the state check below
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            metrics = step(batch, TRAIN_EPOCH)
            sync()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: sa.LAUNCHES[k] - before[k] for k in SHARDED_STEP_KERNELS}
            stats = dict(step.last_stats)
            peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
            peak = peaks[0] if devices is None else peaks
            values = {k: float(v) for k, v in metrics.items()}
            busy_by_card = None
            if devices is None:
                _, _, busy = profile_call(torch, lambda: step(batch, TRAIN_EPOCH), ms,
                                          f"process {rank}: flagship step {i} (its repeat "
                                          f"under the profiler)", SHARDED_STEP_KERNELS, top=6)
            else:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    step(batch, TRAIN_EPOCH)
                    sync()
                busy_by_card = _busy_by_card(torch, prof)
                busy = sum(busy_by_card.values()) or None
            state = train_state(trainer.model, trainer.optimizer)
            distributed.assert_host_identical(state, f"the flagship's state after step {i} "
                                                     f"and its repeat")
            record = {"host_ms": ms, "busy_ms": busy,
                      "idle_pct": None if busy is None else 100 * (1 - busy / ms),
                      "busy_ms_by_card": busy_by_card,
                      "idle_pct_by_card": None if busy_by_card is None else {
                          k: 100 * (1 - v / ms) for k, v in busy_by_card.items()},
                      "peak_gib": peak, "loss": values["training_loss"].hex(),
                      "metrics": values, "launches": counts,
                      "partition_ok": stats["partition_ok"],
                      "collectives": stats["collectives"],
                      "process_gathers": stats["process_gathers"],
                      "process_gather_bytes": stats["process_gather_bytes"],
                      "process_gather_ms": stats["process_gather_ms"],
                      "fingerprint": distributed.fingerprint(state).hex()}
            records.append(record)
            log(f"process {rank} flagship step {i} over data {PROCESS_WORLD} (processes) x "
                f"graph {PROCESS_GRAPH} on {[str(d) for d in cards]}: {ms:.1f} ms (host "
                f"clock), device busy {busy} ms (by card {busy_by_card}), peak GiB "
                f"{[round(p, 2) for p in peaks]}, gathers {stats['process_gathers']} of "
                f"{stats['process_gather_bytes']} bytes in {stats['process_gather_ms']:.1f} ms "
                f"(host), collectives {stats['collectives']}, partition_ok "
                f"{stats['partition_ok']}, metrics {values}, launches {counts}")
            assert all(math.isfinite(v) for v in values.values()), values
            assert values["score_cut"] < SCORE_CUT_CLAMP, values
        if devices is not None:
            records.append(time_process_gather(torch, records[-1]["process_gather_bytes"]
                                               // PROCESS_WORLD, cards[0], rank))
    del trainer, trainset, step
    torch.cuda.empty_cache()
    return records, sorted(str(key) for key in rec.seen)


def time_process_gather(torch, n_bytes, device, rank, iters=5):
    """The step's cross-process all-gather alone: ``gather_from_processes``
    of one ``n_bytes`` buffer on ``device``, ``iters`` times, each timed by
    CUDA events around the call (packing, the collective and its copies on
    the card) and by the host clock to the end of a synchronize."""
    from hierarchicalgnn_torch.parallel import distributed

    buffer = torch.full((n_bytes,), rank + 1, dtype=torch.uint8, device=device)
    device_ms, host_ms, stats = [], [], {}
    for _ in range(iters):
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        (copies,) = distributed.gather_from_processes([buffer], torch.distributed.group.WORLD,
                                                      stats)
        end.record()
        torch.cuda.synchronize(device)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        device_ms.append(start.elapsed_time(end))
    assert [int(c[0]) for c in copies] == list(range(1, PROCESS_WORLD + 1)), "gather order"
    record = {"gather_alone": True, "bytes_per_process": n_bytes,
              "bytes_received": stats["process_gather_bytes"] // iters,
              "device_ms": device_ms, "host_ms": host_ms}
    log(f"process {rank} the cross-process all-gather alone ({n_bytes} bytes a process, "
        f"{record['bytes_received']} received) on {device}: device ms "
        f"{[round(t, 3) for t in device_ms]}, host ms {[round(t, 3) for t in host_ms]}")
    return record


def process_parity(torch, rank, events, devices=None, reference_devices=None):
    """Worker, part (b): f32 at depth 2 + 2, full width and capacities, under
    deterministic algorithms: one sharded step over ``{data 2 across the
    processes, graph 2}``; process 0 then takes the one-process ``{data 2,
    graph 2}`` step over both events from the same start and compares: the
    loss within 1e-4 relative, every parameter within rtol 5e-4 / atol 1e-5
    (the leaf whose true gradient is zero within twice the learning rate),
    and says whether they agree bit for bit.  ``devices``: this process's
    cards (phase 26(e)); the one-process step then runs its events' ranks on
    ``reference_devices`` (both processes' cards, in order).  The ops that
    ran without a deterministic form (``warn_only``'s warnings) are
    recorded."""
    from hierarchicalgnn_torch.parallel import distributed
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_train_step
    from hierarchicalgnn_torch.parallel.mesh import make_mesh
    from hierarchicalgnn_torch.train.checkpoint import load_model_state, train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer

    hp, trainer = flagship_trainer({"compute_dtype": None, "n_interaction_graph_iters": 2,
                                    "n_hierarchical_graph_iters": 2, "halo_backend": "rdma"})
    model, pipeline = trainer.model, trainer.pipeline
    batches = [b for _, _, b in trainer.make_datasets(events)[0][:PROCESS_WORLD]]
    start = train_state(model, trainer.optimizer)
    mesh = distributed.make_global_mesh(graph_per_host=PROCESS_GRAPH, devices=devices)
    reference = ({"data": PROCESS_WORLD, "graph": PROCESS_GRAPH} if reference_devices is None
                 else make_mesh(PROCESS_WORLD, PROCESS_GRAPH, devices=reference_devices))
    cards = _cards(torch, reference_devices or devices)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def fresh():
        return make_optimizer(list(model.parameters()), hp, trainer._steps_per_epoch())

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with watchdog(), warnings.catch_warnings(record=True) as caught, recording_path(
                "processes parity", checked=None) as rec:
            warnings.simplefilter("always")
            optimizer = fresh()
            metrics = make_sharded_train_step(pipeline, optimizer, mesh, hp)(
                process_batch(mesh, batches[rank]), TRAIN_EPOCH)
            sync()
            got = {n: p.detach().clone() for n, p in model.named_parameters()}
            out["loss"] = float(metrics["training_loss"]).hex()
            if rank == 0:
                lr = optimizer.schedule(0)
                load_model_state(model, start)
                want_metrics = make_sharded_train_step(pipeline, fresh(), reference, hp)(
                    batches, TRAIN_EPOCH)
                sync()
                loss, ref = float(metrics["training_loss"]), float(want_metrics["training_loss"])
                worst, where, equal = 0.0, None, True
                for n, value in model.named_parameters():
                    diff = (got[n] - value.detach()).abs()
                    equal &= bool((diff == 0).all())
                    bound = 2 * lr if n == NOISE_LEAF else 1e-5 + 5e-4 * value.detach().abs()
                    share = float((diff / bound).max())
                    if share > worst:
                        worst, where = share, n
                out.update(ref_loss=ref, loss_rel=abs(loss / ref - 1), worst=worst,
                           worst_leaf=where, bit_for_bit=bool(equal and loss == ref))
                log(f"processes parity f32 (2 + 2) over data {PROCESS_WORLD} (processes) x "
                    f"graph {PROCESS_GRAPH} (ranks on {devices or 'the current card'}) against "
                    f"one process's {{data {PROCESS_WORLD}, graph {PROCESS_GRAPH}}} (ranks on "
                    f"{reference_devices or 'the current card'}): loss {loss:.7f} vs {ref:.7f} "
                    f"(rel {out['loss_rel']:.2e}), worst parameter {worst:.3f} of its bound "
                    f"(loss 1e-4 relative, rtol 5e-4 / atol 1e-5) ({where}), bit for bit: "
                    f"{out['bit_for_bit']}")
        out["nondeterministic"] = sorted({str(w.message).split(".")[0] for w in caught
                                          if "deterministic" in str(w.message)})
        log(f"process {rank} parity: ops without a deterministic form (warn_only's warnings) "
            f"{out['nondeterministic']}")
    finally:
        torch.use_deterministic_algorithms(False)
    del trainer, model, pipeline
    torch.cuda.empty_cache()
    return out, sorted(str(key) for key in rec.seen)


def process_ec_in(torch, rank, events, backend):
    """Worker, part (c): EC-IN at its shipped widths and the flagship
    capacities, one ``make_dp_train_step`` step over ``{data world}`` across
    the processes and, with more than one process, one ``make_tp_train_step``
    step over ``{data 2, model 2}``: losses and launches."""
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel import distributed, tp
    from hierarchicalgnn_torch.parallel.step import make_dp_train_step
    from hierarchicalgnn_torch.train.checkpoint import train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer
    from hierarchicalgnn_torch.train.trainer import Trainer

    hp, model, pipeline = model_selector("EC-IN", FLAGSHIP)
    assert (hp["latent"], hp["hidden"]) == MODEL_WIDTHS["EC-IN"][:2], hp
    trainer = Trainer(hp, model, pipeline)
    trainer.init_state(seed=0)
    trainset, _, _ = trainer.make_datasets(events)
    mesh = distributed.make_global_mesh()
    batch = process_batch(mesh, trainset[rank][2])
    out = {}
    with watchdog(), recording_path("processes EC-IN", checked=None) as rec:
        for label in ("dp", "tp") if mesh.world_size > 1 else ("dp",):
            optimizer = make_optimizer(list(model.parameters()), hp, trainer._steps_per_epoch())
            # the processes start together, from one state
            distributed.replicate(train_state(model, optimizer), mesh, check=True)
            before = dict(sa.LAUNCHES)
            t0 = time.perf_counter()
            if label == "dp":
                step = make_dp_train_step(pipeline, optimizer, mesh)
                metrics = step(batch, 0)
                state = train_state(model, optimizer)
            else:
                state, step = tp.make_tp_train_step(pipeline, optimizer,
                                                    tp.make_tp_mesh(mesh, 2, hp["hidden"]),
                                                    train_state(model, optimizer), hp["hidden"])
                state, metrics = step(state, batch, 0)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            distributed.assert_host_identical(state, f"EC-IN's {label} state")
            counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
            stats = step.last_stats
            out[label] = {"loss": float(metrics["training_loss"]).hex(), "host_ms": ms,
                          "launches": counts, "process_gathers": stats["process_gathers"],
                          "process_gather_bytes": stats["process_gather_bytes"],
                          "process_gather_ms": stats["process_gather_ms"]}
            log(f"process {rank} EC-IN {label} step over {mesh.world_size} process(es), "
                f"{backend}: {ms:.1f} ms (host clock), loss {float(metrics['training_loss']):.7f}"
                f", gathers {stats['process_gathers']} of {stats['process_gather_bytes']} bytes "
                f"in {stats['process_gather_ms']:.1f} ms, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            assert counts["K1"] > 0 and counts["K4"] > 0, (label, counts)
    del trainer, model, pipeline
    torch.cuda.empty_cache()
    return out, sorted(str(key) for key in rec.seen)


def process_k8(torch, cards):
    """Worker, on cards of its own (phase 26(e)): K8 at this process's P 2 on
    the flagship step's halo block ([12288, 256] bf16, one rank on each of
    its cards), exact against torch.cat on each card; its timings
    (``k8_timings``: 2 launches a call) beside NCCL's all-gather of the same
    blocks over the same cards."""
    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg

    devices = [torch.device(c) for c in cards]
    gen = torch.Generator().manual_seed(29)
    blocks = [torch.randn((12288, 256), generator=gen).to(torch.bfloat16).to(d)
              for d in devices]
    want = torch.cat([b.cpu() for b in blocks], 0)
    outs = rg.ring_all_gather(blocks)
    for d in devices:
        torch.cuda.synchronize(d)
    exact = all(torch.equal(o.cpu(), want) for o in outs)
    assert exact, f"K8 over cards {cards} differs from torch.cat"
    streams = [torch.cuda.current_stream(d) for d in devices]
    timed = k8_timings(torch, lambda: rg.ring_all_gather(blocks), blocks, streams)
    library_ms, library_host_us, library_exact = nccl_gather_timings(torch, blocks, outs,
                                                                     streams)
    assert library_exact, "NCCL's all-gather differs from K8's"
    block_bytes = 12288 * 256 * 2
    return {**timed, "exact": exact, "launches": len(rg.launch_info(blocks)),
            "library_ms": library_ms, "library_host_us": library_host_us,
            "bound_ms": 1e3 * (len(blocks) - 1) * block_bytes / 450e9}


def process_worker(rank: int, world: int, store: str, backend: str, cards=None,
                   reference=None):
    """One process of phase 25 (``chip_smoke.py --process-worker <rank>
    <world> <store> <backend>``): joins the group through the ``file://``
    store, runs (a)-(c) with ``gloo`` (over CUDA tensors: two processes on
    one card), or only (c)'s DP step with ``nccl``; prints one line
    ``PROCESS_RESULT {json}``.  With ``cards`` (``... <backend> <cards>
    <reference>``, comma lists: phase 26(e)) the process binds itself to its
    first card and runs (a) and (b) with its graph ranks on ``cards``, (b)'s
    one-process step on ``reference``."""
    import torch

    from hierarchicalgnn_torch.parallel import distributed

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the worker needs a card")
    distributed.initialize(init_method=f"file://{store}", num_processes=world,
                           process_id=rank, backend=backend,
                           device=cards[0] if cards else "cuda", timeout_s=GROUP_TIMEOUT_S)
    assert torch.distributed.get_backend() == backend
    if cards:
        assert torch.cuda.current_device() == torch.device(cards[0]).index
    events = flagship_events()
    result = {"rank": rank, "backend": backend, "keys": [], "cards": cards,
              "current_device": torch.cuda.current_device()}
    try:
        if cards:
            result["flagship"], keys = process_flagship(torch, rank, events, cards)
            result["keys"] += keys
            result["parity"], keys = process_parity(torch, rank, events, cards, reference)
            result["keys"] += keys
            if len(set(cards)) > 1:
                result["k8"] = process_k8(torch, cards)
        elif backend == "gloo":
            result["flagship"], keys = process_flagship(torch, rank, events)
            result["keys"] += keys
            result["parity"], keys = process_parity(torch, rank, events)
            result["keys"] += keys
        if not cards:
            result["ec_in"], keys = process_ec_in(torch, rank, events, backend)
            result["keys"] += keys
    finally:
        torch.distributed.destroy_process_group()
    print(PROCESS_TAG + json.dumps(result), flush=True)


def run_processes(world: int, backend: str, root: Path, cards=None, reference=None) -> list:
    """Start ``world`` workers, each under PROCESS_TIMEOUT_S, their output in
    files (a full pipe would stall a worker that its peer waits for); relay
    it and return each worker's result.  Every worker is ended before this
    returns.  Without ``cards`` they share the current card; with them
    worker r runs on ``cards[r]`` (a list of device names, given on its
    command line, not through ``CUDA_VISIBLE_DEVICES``: every worker sees
    every card) and its one-process reference on ``reference``."""
    store = root / f"{backend}_store"
    logs = [root / f"{backend}_{rank}.log" for rank in range(world)]
    procs = []
    try:
        for rank, path in enumerate(logs):
            placed = [] if cards is None else [",".join(cards[rank]), ",".join(reference)]
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--process-worker",
                     str(rank), str(world), str(store), backend, *placed],
                    stdout=out, stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent))
        deadline = time.monotonic() + PROCESS_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, path) in enumerate(zip(procs, logs)):
        text = path.read_text()
        for line in text.splitlines():
            if not line.startswith(PROCESS_TAG):
                log(f"[{backend} process {rank}] {line}")
        found = [json.loads(line[len(PROCESS_TAG):]) for line in text.splitlines()
                 if line.startswith(PROCESS_TAG)]
        if p.returncode != 0 or len(found) != 1:
            raise AssertionError(f"{backend} process {rank} of {world} failed (exit code "
                                 f"{p.returncode}, killed after {PROCESS_TIMEOUT_S} s if "
                                 f"negative)")
        results.append(found[0])
    return results


def phase_processes(torch):
    """The ``data`` axis over processes (``parallel/distributed.py``): 2
    workers of this script (``--process-worker``) on the one card form a
    ``torch.distributed`` group over gloo on CUDA tensors, meeting through a
    ``file://`` store.  (a) the flagship's sharded step over ``{data 2,
    graph 2}``: the processes' losses equal bit for bit at every step, their
    states identical, K1-K6 and K8 launched in each; (b) its f32 parity at
    depth 2 + 2 against one process's ``{data 2, graph 2}`` step; (c)
    EC-IN's DP and TP steps across the processes, losses equal; (d) one more
    worker runs (c)'s DP step alone over ``nccl``, so that the NCCL path
    initialises and gathers on the card (NCCL takes no two ranks on one
    device).  The processes time-share the card: the numbers are the cost of
    the path on one card, not a step over two cards.  Returns the summed
    launch counts of the flagship's 2 timed steps in both workers and the
    workers' results."""
    with _scratch_dir() as tmp:
        results = run_processes(PROCESS_WORLD, "gloo", Path(tmp))
        (nccl,) = run_processes(1, "nccl", Path(tmp))
    unchecked = sorted({k for r in results + [nccl] for k in r["keys"]}
                       - {str(key) for key in PATH_CHECKED})
    log(f"processes: the kernels were handed {len({k for r in results for k in r['keys']})} "
        f"kinds of input, {'all' if not unchecked else 'NOT all'} held against their plain "
        f"versions in phase 3")
    assert not unchecked, f"phase 25's kernel inputs never checked: {unchecked}"
    launches = {k: 0 for k in NAMES}
    for i in range(2):
        steps = [r["flagship"][i] for r in results]
        assert len({s["loss"] for s in steps}) == 1, f"step {i}: the processes' losses differ"
        assert len({s["fingerprint"] for s in steps}) == 1, f"step {i}: states differ"
        for s in steps:
            assert s["partition_ok"] and s["process_gathers"] == 1, s
            for kernel in SHARDED_STEP_KERNELS:
                assert s["launches"][kernel] > 0, (kernel, s["launches"])
                launches[kernel] += s["launches"][kernel]
    parity = results[0]["parity"]
    assert results[1]["parity"]["loss"] == parity["loss"], "the parity step's losses differ"
    if parity["loss_rel"] > 1e-4 or parity["worst"] > 1:
        raise AssertionError(f"the 2-process step differs from one process's: {parity}")
    for label in ("dp", "tp"):
        assert len({r["ec_in"][label]["loss"] for r in results}) == 1, f"EC-IN {label} losses"
    assert nccl["backend"] == "nccl" and nccl["ec_in"]["dp"]["process_gathers"] == 1, nccl
    log("processes " + json.dumps({"flagship": [r["flagship"] for r in results],
                                   "parity": parity,
                                   "ec_in": [r["ec_in"] for r in results],
                                   "nccl": nccl["ec_in"]}))
    return launches, results


# ---------------------------------------------------------------------------
# Phase 26: ranks on several cards
# ---------------------------------------------------------------------------

SPLITS = ((2, 2), (1, 1, 1, 1))  # phase 26(a): launches of K8 at P 4 on one card
SLEEP_CYCLES = int(8e9)          # phase 26(b): a stream asleep some seconds (past the bound)
TIMEOUT_CHECK_S = 2.0            # phase 26(b): the bound of K8's waits on flags


def time_streams(torch, fn, streams, iters=100, warm=200):
    """Mean device ms per call of ``fn``, whose launches go to ``streams``,
    after ``warm`` calls (the card at its clocks): from an event on the
    current stream that the streams wait on to an event after the current
    stream has waited on all of them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(main)
    for stream in streams:
        stream.wait_stream(main)
    for _ in range(iters):
        fn()
    for stream in streams:
        main.wait_stream(stream)
    end.record(main)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k8_timings(torch, fn, blocks, streams, per_rank=None):
    """K8 as ``fn`` calls it on ``blocks`` (``per_rank``: the streams it
    names, as ``ring_all_gather`` takes them), its launches on ``streams``:
    ms per call (``time_streams``); host us per call, 100 calls enqueued
    without a wait; the profiler's device ms per launch; and what block 0 of
    each launch measured (``launch_stats``): us spun at the entry and us run,
    per launch, over those 100 calls and over 20 calls each waited for."""
    from torch.profiler import ProfilerActivity, profile

    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg

    cards = sorted({b.get_device() for b in blocks})

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def window(calls, wait):
        sync()
        before = rg.launch_stats(blocks, per_rank)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            if wait:
                sync()
        host = 1e6 * (time.perf_counter() - t0) / calls
        sync()
        after = rg.launch_stats(blocks, per_rank)
        return host, [[round((a[k] - b[k]) / calls / 1e3, 2) for a, b in zip(after, before)]
                      for k in (0, 1)]

    ms = time_streams(torch, fn, streams)
    host_us, (spin, run) = window(100, False)
    _, (spin_waited, run_waited) = window(20, True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        sync()
    hits = [ev for ev in prof.key_averages() if PROFILE_TAGS["K8"] in ev.key]
    n = sum(ev.count for ev in hits)
    return {"ms": ms, "host_us": host_us,
            "device_ms": sum(_device_us(ev) for ev in hits) / 1e3 / n if n else None,
            "entry_spin_us": spin, "run_us": run, "entry_spin_us_waited": spin_waited,
            "run_us_waited": run_waited}


def k8_text(t):
    """One line of ``k8_timings``' numbers."""
    return (f"{t['ms']:.4f} ms per call, host {t['host_us']:.1f} us per call, device "
            f"{t['device_ms']} ms per launch; block 0's entry spin / run us per launch "
            f"{t['entry_spin_us']} / {t['run_us']} back to back, {t['entry_spin_us_waited']} / "
            f"{t['run_us_waited']} with each call waited for")


def multicard_split_launches(torch, rows):
    """26(a): K8 at P 4 on the flagship halo input ([6144, 256], bf16 and
    f32) as 2 launches of 2 ranks and as 4 launches of 1, each on a stream of
    its own of card 0 with its grid capped at its share of the card: the
    first and the last of its calls equal to ``torch.cat`` bit for bit, the
    time per call (``time_streams``) beside the single launch's on the same
    input.  Adds the
    bf16 rows to ``rows``; returns the split launches counted."""
    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg, sorted_agg as sa

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(26)
    counted = {}
    for dtype in (torch.bfloat16, torch.float32):
        blocks = [torch.randn((6144, 256), generator=gen).to(dtype).to(dev) for _ in range(4)]
        want = torch.cat(blocks, 0)
        single = k8_timings(torch, lambda: rg.ring_all_gather(blocks), blocks, [])
        (grid1, *_), = rg.launch_info(blocks)
        log(f"26(a) K8 {str(dtype)[6:]} P=4 [6144, 256] as one launch on card 0 (grid "
            f"{grid1}): {k8_text(single)}")
        plain_ms = time_ms(torch, lambda: rg.ring_all_gather_plain(blocks))
        lib_ms = time_ms(torch, lambda: [torch.cat(blocks, 0) for _ in range(4)])
        block_bytes = blocks[0].numel() * blocks[0].element_size()
        n_bytes = 4 * block_bytes + 16 * block_bytes
        for split in SPLITS:
            streams = [torch.cuda.Stream(dev) for _ in split]
            per_rank = [s for n, s in zip(split, streams) for _ in range(n)]
            torch.cuda.synchronize()
            before = dict(sa.LAUNCHES)
            calls = [0]

            def gather():
                calls[0] += 1
                return rg.ring_all_gather(blocks, streams=per_rank)

            outs = gather()
            torch.cuda.synchronize()
            first = all(torch.equal(o, want) for o in outs)
            timed = k8_timings(torch, gather, blocks, streams, per_rank)
            outs = gather()
            torch.cuda.synchronize()
            last = all(torch.equal(o, want) for o in outs)
            made = {k: sa.LAUNCHES[k] - before[k] for k in ("K8", "K8_split")}
            info = rg.launch_info(blocks, per_rank)
            label = " + ".join(str(n) for n in split)
            log(f"26(a) K8 {str(dtype)[6:]} P=4 [6144, 256] as {len(split)} launches "
                f"({label} ranks) on {len(split)} streams of card 0: first and last of "
                f"{calls[0]} calls {'equal' if first and last else 'NOT equal'} to torch.cat, "
                f"{k8_text(timed)}; against {single['ms']:.4f} ms as one launch and "
                f"{lib_ms:.4f} ms for 4 torch.cat; grids {[i[0] for i in info]} of caps "
                f"{[i[3] for i in info]}, chunks {[i[4] for i in info]}; launches {made}")
            assert first and last, f"split K8 {split} {dtype} differs from torch.cat"
            assert made["K8"] == made["K8_split"] == len(split) * calls[0], made
            counted[split] = counted.get(split, 0) + made["K8_split"]
            if dtype == torch.bfloat16:
                rows[f"K8 split {label}"] = {
                    "max_abs_err": 0.0, **timed, "plain_ms": plain_ms,
                    "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                    "library_ms": lib_ms, "single_launch_ms": single["ms"],
                    "single_launch_host_us": single["host_us"],
                    "grids": [i[0] for i in info], "caps": [i[3] for i in info],
                    "shape": f"halo bf16 P=4 block [6144, 256], {len(split)} launches of "
                             f"{label} ranks on streams of one card"}
    return counted


def multicard_timeout(torch):
    """26(b): K8 at P 4 as 2 launches on 2 streams of card 0, the second
    stream asleep (``torch.cuda._sleep``) past the bound of 2 s, twice.  Each
    time the first launch gives up within the bound and its stream goes on,
    while the call stays pending and holds its outputs until the late launch
    has ended.  The first time the next call on that layout raises and
    retires its flags; the second time ``settle`` (what the sharded forward
    calls before reading its results back) raises for the call itself.
    After each, a call on fresh flags is exact."""
    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(27)
    blocks = [torch.randn((6144, 256), generator=gen).to(dev) for _ in range(4)]
    want = torch.cat(blocks, 0)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    per_rank = [streams[0], streams[0], streams[1], streams[1]]
    rg.ring_all_gather(blocks, streams=per_rank)
    rg.settle()
    for raiser in ("the next call", "settle"):
        with torch.cuda.stream(streams[1]):
            torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        outs = rg.ring_all_gather(blocks, streams=per_rank, timeout_s=TIMEOUT_CHECK_S)
        streams[0].synchronize()
        waited = time.perf_counter() - t0
        held = any(o is t for call in rg._PENDING for t in call.tensors for o in outs)
        del outs
        t1 = time.perf_counter()
        try:
            if raiser == "settle":
                rg.settle()
            else:
                rg.ring_all_gather(blocks, streams=per_rank)
            raised = None
        except RuntimeError as exc:
            raised = str(exc)
        rg.settle()  # raised once already: waits for the late launch and says nothing
        rest = time.perf_counter() - t1
        outs = rg.ring_all_gather(blocks, streams=per_rank)
        rg.settle()
        exact = all(torch.equal(o, want) for o in outs)
        log(f"26(b) K8 with a peer that enters late (its stream asleep): the other launch gave "
            f"up after {waited:.3f} s (bound {TIMEOUT_CHECK_S} s); the call's outputs "
            f"{'held' if held else 'NOT held'} while the late launch ran; {raiser} raised: "
            f"{raised!r}; the late launch ended {rest:.3f} s later, nothing left pending "
            f"{not rg._PENDING}; a call on fresh flags {'is exact' if exact else 'DIFFERS'}")
        assert held and raised and "retired" in raised, (held, raised)
        assert waited < TIMEOUT_CHECK_S + 1.0, waited
        assert exact and not rg._PENDING


def _sharded_outputs(out):
    bgraph, scores, emb, aux = out
    return [bgraph.senders, bgraph.receivers, bgraph.edge_mask, scores, emb, aux["clusters"]]


def multicard_one_card(torch, events):
    """26(c): f32, depth 2 + 2, the flagship's sharded forward and sharded
    step at P 4 with ``devices=[cuda:0] * 4`` (the placement path: inputs
    and buffers handed to the ranks through ``place_inputs``, the card made
    current in every rank) against ``devices=None``, each twice, under
    deterministic algorithms: every forward output, the loss, every gradient,
    the buffers after the step and the launch counts equal bit for bit, each
    path with itself and the two paths with each other.  The warnings that
    ``warn_only`` raises name each op that ran without a deterministic form;
    they are recorded and printed."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import (
        make_sharded_forward, make_sharded_train_step)

    dev = torch.device("cuda", 0)
    f32 = {**FLAGSHIP, "compute_dtype": None, "n_interaction_graph_iters": 2,
           "n_hierarchical_graph_iters": 2, "halo_backend": "rdma"}
    hp, model, pipeline = model_selector("BC-HGNN-GMM", f32)
    batch = preprocess_event(events[0], hp, stage="test")
    hp_t, trainer = flagship_trainer({**f32, "mesh_shape": {"data": 1, "graph": N_PARTS}})
    train_batch = trainer.make_datasets(events[:1])[0][0][2]
    start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    names = [n for n, _ in trainer.model.named_parameters()]
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for label, devices in (("none", None), ("none again", None),
                                   ("cuda:0 x 4", [dev] * N_PARTS),
                                   ("cuda:0 x 4 again", [dev] * N_PARTS)):
                forward = make_sharded_forward(pipeline, N_PARTS, hp, devices=devices)
                before = dict(sa.LAUNCHES)
                outs = [t.detach() for t in _sharded_outputs(forward(batch))]
                torch.cuda.synchronize()
                fwd_counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
                with torch.no_grad():
                    for k, v in trainer.model.state_dict().items():
                        v.copy_(start[k])
                step = make_sharded_train_step(trainer.pipeline, trainer.optimizer,
                                               {"graph": N_PARTS}, hp_t, devices=devices)
                before = dict(sa.LAUNCHES)
                grads, metrics = step.forward_backward(train_batch, TRAIN_EPOCH)
                torch.cuda.synchronize()
                step_counts = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES}
                runs[label] = (outs, metrics["training_loss"].detach(), grads,
                               {k: v.clone() for k, v in trainer.model.named_buffers()},
                               fwd_counts, step_counts)
    finally:
        torch.use_deterministic_algorithms(False)
        with torch.no_grad():
            for k, v in trainer.model.state_dict().items():
                v.copy_(start[k])
    nondeterministic = sorted({str(w.message).split(".")[0] for w in caught
                               if "deterministic" in str(w.message)})

    def differ(a, b):
        outs = [i for i, (x, y) in enumerate(zip(a[0], b[0])) if not torch.equal(x, y)]
        leaves = {}
        for name, x, y in zip(names, a[2], b[2]):
            assert (x is None) == (y is None), name
            if x is not None and not torch.equal(x, y):
                leaves[name] = float((x - y).abs().max()) / float(x.abs().max())
        bufs = [k for k in a[3] if not torch.equal(a[3][k], b[3][k])]
        return {"outputs": outs, "loss": not torch.equal(a[1], b[1]), "buffers": bufs,
                "launches": (a[4] != b[4], a[5] != b[5])}, leaves

    pairs = {"devices=None twice": ("none", "none again"),
             "devices=[cuda:0] x 4 twice": ("cuda:0 x 4", "cuda:0 x 4 again"),
             "the two paths": ("none", "cuda:0 x 4")}
    found = {k: differ(runs[a], runs[b]) for k, (a, b) in pairs.items()}
    for k, (rest, leaves) in found.items():
        worst = max(leaves.items(), key=lambda kv: kv[1], default=(None, 0.0))
        log(f"26(c) f32 2 + 2, P {N_PARTS}, {k}: forward outputs, loss, buffers and launch "
            f"counts {rest}; gradient leaves that differ {len(leaves)} of {len(names)}, "
            f"largest difference {worst[1]:.2e} of its leaf's largest entry ({worst[0]}); "
            f"first leaves {sorted(leaves)[:6]}")
    log(f"26(c) ops without a deterministic form (warn_only's warnings): {nondeterministic}")
    log(f"26(c) forward launches { {k: v for k, v in runs['none'][4].items() if v} }, step "
        f"launches { {k: v for k, v in runs['none'][5].items() if v} }")
    clean = {"outputs": [], "loss": False, "buffers": [], "launches": (False, False)}
    for k, (rest, leaves) in found.items():
        assert rest == clean and not leaves, f"26(c) {k}: {rest}, gradients {leaves}"
    del trainer, model, pipeline, runs
    torch.cuda.empty_cache()


class cotangent_probe:
    """While the body runs, the gradient that autograd's engine hands each
    rank at the graph's seams, by the sha256 of its bytes: at every
    collective a rank enters (``ShardGroup.meet``), its input (``in``: every
    term added, the collective's and the rank's own consumers') and its
    output (``out``: the rank's consumers' terms), keyed ``(kind, the rank's
    call number, rank, side)``; and each rank's outputs where the forward
    brings them to the model's card (``("result", leaf, rank, "out")``).
    Each hook copies its gradient to the host."""

    def __enter__(self):
        from unittest import mock

        import torch
        import torch.utils._pytree as pytree

        from hierarchicalgnn_torch.parallel import comm, graph_shard

        self.digests, lock, calls, inside = {}, threading.Lock(), {}, threading.local()
        meet, reassemble = comm.ShardGroup.meet, graph_shard._reassemble

        def record(key):
            def hook(grad):
                data = grad.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                with lock:
                    self.digests[key] = hashlib.sha256(data.numpy().tobytes()).hexdigest()[:16]
            return hook

        def probed_meet(group, rank, kind, value):
            with lock:
                n = calls.get((id(group), rank), 0)
                calls[(id(group), rank)] = n + 1
            if isinstance(value, torch.Tensor) and value.requires_grad:
                value.register_hook(record((kind, n, rank, "in")))
            out = meet(group, rank, kind, value)
            if isinstance(out, torch.Tensor) and out.requires_grad:
                out.register_hook(record((kind, n, rank, "out")))
            return out

        def probed_reassemble(spec, outs, device=None):
            if getattr(inside, "on", False):
                return reassemble(spec, outs, device)
            for rank, out in enumerate(outs):
                leaves = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
                for i, t in enumerate(leaves):
                    if t.requires_grad:
                        t.register_hook(record(("result", i, rank, "out")))
            inside.on = True
            try:
                return reassemble(spec, outs, device)
            finally:
                inside.on = False

        self.patches = [mock.patch.object(comm.ShardGroup, "meet", probed_meet),
                        mock.patch.object(graph_shard, "_reassemble", probed_reassemble)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in reversed(self.patches):
            patch.stop()


def _backward_order(key):
    """The probe's keys in the order the backward meets them: the ranks'
    outputs, then the collectives from the last call to the first, each
    one's output before its input."""
    kind, n, rank, side = key
    return (kind != "result", -n if kind != "result" else n, side != "out", rank)


def divergence(want, got):
    """The probe keys whose gradients differ between two runs, in backward
    order, and the first input among them whose collective's outputs all
    agree: the add into that input is where the runs part."""
    differ = sorted((k for k in set(want) | set(got) if want.get(k) != got.get(k)),
                    key=_backward_order)
    for kind, n, rank, side in differ:
        if side == "in" and kind != "result" and all(
                want.get(k) == got.get(k) for k in want if k[:2] == (kind, n) and k[3] == "out"):
            return differ, (kind, n, rank, side)
    return differ, None


def multicard_f32(torch, events, cards, devices, n_cards):
    """26(d)'s f32 part at depth 2 + 2, under the caller's deterministic
    algorithms: the sharded forward over the cards against one card (clusters
    and edges equal, scores within 1e-4); the sharded step on one card once
    and over the cards three times, against one card (the loss within 1e-4
    relative, every gradient within 1e-3 of its leaf's largest entry plus
    1e-7), the first and the last run under ``cotangent_probe``, so that the
    first gradient at a seam that differs from one card's is named; the TP
    step over the cards against one card (the same bounds)."""
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.graph import Graph
    from hierarchicalgnn_torch.parallel.graph_shard import (
        make_sharded_forward, make_sharded_train_step)

    out = {}
    f32 = {**FLAGSHIP, "compute_dtype": None, "n_interaction_graph_iters": 2,
           "n_hierarchical_graph_iters": 2, "halo_backend": "rdma"}
    hp, model, pipeline = model_selector("BC-HGNN-GMM", f32)
    batch = preprocess_event(events[0], hp, stage="test")
    one = _sharded_outputs(make_sharded_forward(pipeline, N_PARTS, hp)(batch))
    many = _sharded_outputs(make_sharded_forward(pipeline, N_PARTS, hp, devices=devices)(batch))
    c = hp["max_clusters"]
    (k1, s1), (k2, s2) = (canonical_scores(torch, Graph(*o[:3]), o[3], c) for o in (one, many))
    score_err = float((s1 - s2).abs().max()) if torch.equal(k1, k2) else float("inf")
    emb_err = float((one[4] - many[4]).abs().max())
    log(f"26(d) f32 2 + 2 sharded forward over {n_cards} cards against one card: clusters "
        f"{'equal' if torch.equal(one[5], many[5]) else 'DIFFER'}, edges "
        f"{'equal' if torch.equal(k1, k2) else 'DIFFER'}, scores within {score_err:.2e}, "
        f"embeddings within {emb_err:.2e}")
    assert torch.equal(one[5], many[5]) and torch.equal(k1, k2) and score_err <= 1e-4
    del model, pipeline
    hp_t, trainer = flagship_trainer({**f32, "mesh_shape": {"data": 1, "graph": N_PARTS}})
    train_batch = trainer.make_datasets(events[:1])[0][0][2]
    start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    names = [n for n, _ in trainer.model.named_parameters()]

    def restart():
        with torch.no_grad():
            for k, v in trainer.model.state_dict().items():
                v.copy_(start[k])

    runs = []
    for label, devs, probed in (("one card", None, True), ("cards 1", devices, False),
                                ("cards 2", devices, False), ("cards 3", devices, True)):
        restart()
        step = make_sharded_train_step(trainer.pipeline, trainer.optimizer, {"graph": N_PARTS},
                                       hp_t, devices=devs)
        if probed:
            with cotangent_probe() as probe:
                grads, metrics = step.forward_backward(train_batch, TRAIN_EPOCH)
                for d in cards:
                    torch.cuda.synchronize(d)
            digests = probe.digests
        else:
            grads, metrics = step.forward_backward(train_batch, TRAIN_EPOCH)
            digests = None
        buffers = {k: v.detach().clone() for k, v in trainer.model.named_buffers()}
        runs.append((label, metrics["training_loss"].detach().clone(), grads, buffers, digests))
        del step
    (_, loss1, g1, b1, d1) = runs[0]
    out["step"] = {}
    for label, loss2, g2, b2, d2 in runs[1:]:
        worst, differ = 0.0, []
        for name, a, b in zip(names, g1, g2):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.device == b.device == cards[0]
                worst = max(worst, float((a - b).abs().max()) / (1e-3 * float(a.abs().max())
                                                                 + 1e-7))
                if not torch.equal(a, b):
                    differ.append(name)
        buffers = [k for k in b1 if not torch.equal(b1[k], b2[k])]
        rel = abs(float(loss2) / float(loss1) - 1)
        seams = first = None
        if d2 is not None:
            seams, first = divergence(d1, d2)
        out["step"][label] = {"loss_equal": bool(torch.equal(loss1, loss2)), "loss_rel": rel,
                              "worst": worst, "leaves_differ": len(differ),
                              "buffers_differ": buffers, "first_leaves": differ[:6],
                              "seams_differ": None if seams is None else len(seams),
                              "seams_probed": None if d2 is None else len(d2),
                              "first_seams": None if seams is None else seams[:8],
                              "first_input": first}
        log(f"26(d) f32 2 + 2 sharded step over {n_cards} cards ({label}) against one card: "
            f"loss {float(loss2):.7f} vs {float(loss1):.7f} (rel {rel:.2e}, equal "
            f"{out['step'][label]['loss_equal']}), worst gradient error {worst:.3f} of its "
            f"bound, gradient leaves that differ {len(differ)} of {len(names)} (first "
            f"{differ[:6]}), buffers that differ {buffers}"
            + ("" if d2 is None else
               f"; seams probed {len(d2)}, differing {len(seams)} (first in backward order "
               f"{seams[:8]}); first input whose collective's outputs all agree: {first}"))
        assert rel <= 1e-4 and worst <= 1
    out["cards_runs_equal"] = {
        f"{a} / {b}": all(x is None or torch.equal(x, y) for x, y in zip(ga, gb))
        for (a, _, ga, _, _), (b, _, gb, _, _) in zip(runs[1:], runs[2:])}
    log(f"26(d) f32 2 + 2 sharded step over the cards, run against run (gradients bit for "
        f"bit): {out['cards_runs_equal']}")
    del runs, g1

    # the TP step over {data 1, model 4} with the model ranks on the cards
    from hierarchicalgnn_torch.parallel import tp
    from hierarchicalgnn_torch.train.checkpoint import train_state
    from hierarchicalgnn_torch.train.optim import make_optimizer
    results = []
    for devs in (None, devices):
        restart()
        optimizer = make_optimizer(list(trainer.model.parameters()), hp_t,
                                   trainer._steps_per_epoch())
        mesh = tp.make_tp_mesh(1, N_PARTS, hp_t["hidden"], devices=devs)
        state, step = tp.make_tp_train_step(trainer.pipeline, optimizer, mesh,
                                            train_state(trainer.model, optimizer),
                                            hp_t["hidden"])
        step.state = state
        grads, metrics = step.mean_step.forward_backward(train_batch, TRAIN_EPOCH)
        step.state = None
        results.append((float(metrics["training_loss"]), [g.cpu() if g is not None else None
                                                           for g in grads],
                        sorted({str(p.device) for p in state.leaves()})))
        del state, step, grads
    (loss1, g1, cards1), (loss2, g2, cards2) = results
    worst = max(float((a - b).abs().max()) / (1e-3 * float(a.abs().max()) + 1e-7)
                for a, b in zip(g1, g2) if a is not None)
    equal = loss1 == loss2 and all(a is None or torch.equal(a, b) for a, b in zip(g1, g2))
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
    log(f"26(d) f32 2 + 2 TP step {{data 1, model {N_PARTS}}} with its leaves on {cards2} "
        f"against one card ({cards1}): loss {loss2:.7f} vs {loss1:.7f} (rel "
        f"{abs(loss2 / loss1 - 1):.2e}), worst gradient error {worst:.3f} of its bound, bit "
        f"for bit {equal}; peak GiB per card so far {[round(p, 2) for p in peaks]}")
    assert abs(loss2 / loss1 - 1) <= 1e-4 and worst <= 1
    out["tp"] = {"loss_rel": abs(loss2 / loss1 - 1), "worst": worst, "bit_for_bit": equal}
    restart()
    del trainer, results, g1, g2
    return out


def _busy_by_card(torch, prof):
    """Device ms per card of a profiled run (its kernels and copies)."""
    busy = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or ev.name.startswith("Optimizer."):
            continue
        t = getattr(ev, "device_time", getattr(ev, "cuda_time", 0.0))
        busy[ev.device_index] = busy.get(ev.device_index, 0.0) + t / 1e3
    return busy


def nccl_gather_timings(torch, blocks, outs, streams):
    """NCCL's all-gather of ``blocks`` (one on each card, one call over the
    cards: ``torch.cuda.nccl``): ms per call (``time_streams``), host us per
    call (100 calls enqueued without a wait), and whether its outputs equal
    ``outs``."""
    from torch.cuda import nccl

    shape = (len(blocks) * blocks[0].shape[0],) + tuple(blocks[0].shape[1:])
    gathered = [torch.empty(shape, dtype=b.dtype, device=b.device) for b in blocks]
    call = lambda: nccl.all_gather(blocks, gathered)
    call()
    for b in blocks:
        torch.cuda.synchronize(b.device)
    exact = all(torch.equal(g, o) for g, o in zip(gathered, outs))
    ms = time_streams(torch, call, streams)
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    host_us = 1e6 * (time.perf_counter() - t0) / 100
    for b in blocks:
        torch.cuda.synchronize(b.device)
    return ms, host_us, exact


def multicard_cards(torch, events, n_cards):
    """26(d), on a host with 2 or more cards: the flagship's ranks (P 4) on
    ``n_cards`` cards.  K8 at P 4 on the halo input with each rank's block on
    its card, exact against torch.cat on every card (its bulk stores reach
    the peers' memory), timed beside its plain version and, with one rank a
    card, NCCL's all-gather of the same blocks (``torch.cuda.nccl``, one
    call; equal to K8's output); the f32 part (``multicard_f32``) under
    deterministic algorithms, recording the ops ``warn_only`` names; then
    bf16 at full depth, on one card and then over the cards in
    the same call: 2 sharded events and 2 sharded steps after a warm-up
    each, with the host ms, the peak GiB of each card and each card's idle
    share (a profiled repeat).  Returns the records, K8's row among them."""
    from torch.profiler import ProfilerActivity, profile

    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg, sorted_agg as sa
    from hierarchicalgnn_torch.parallel.graph_shard import make_sharded_forward

    cards = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [cards[r * n_cards // N_PARTS] for r in range(N_PARTS)]
    gen = torch.Generator().manual_seed(28)
    records = {"devices": [str(d) for d in devices]}

    # K8 over the cards
    blocks = [torch.randn((6144, 256), generator=gen).to(torch.bfloat16).to(d)
              for d in devices]
    want = torch.cat([b.cpu() for b in blocks], 0)
    outs = rg.ring_all_gather(blocks)
    for d in cards:
        torch.cuda.synchronize(d)
    exact = all(torch.equal(o.cpu(), want) for o in outs)
    streams = [torch.cuda.current_stream(d) for d in cards]
    fn = lambda: rg.ring_all_gather(blocks)
    timed = k8_timings(torch, fn, blocks, streams)
    plain_ms = time_streams(torch, lambda: rg.ring_all_gather_plain(blocks), streams)
    block_bytes = 6144 * 256 * 2
    nvlink_ms = 1e3 * (N_PARTS - 1) * block_bytes / 450e9  # each rank receives the others' blocks
    # the library's all-gather of the same blocks: NCCL, one process over the
    # cards, one call (torch.cuda.nccl takes one tensor per card)
    library_ms = library_exact = library_host_us = None
    if len(set(devices)) == N_PARTS:
        library_ms, library_host_us, library_exact = nccl_gather_timings(
            torch, blocks, outs, streams)
    # the new per-layout path against nothing else: K8 again after NCCL, in turns
    again = k8_timings(torch, fn, blocks, streams)
    log(f"26(d) K8 bf16 P=4 [6144, 256] over {n_cards} cards (devices {records['devices']}): "
        f"{'exact' if exact else 'NOT exact'} on every card, {k8_text(timed)}; again after "
        f"NCCL {again['ms']:.4f} ms, host {again['host_us']:.1f} us; plain {plain_ms:.4f} ms (a "
        f"torch.cat on each card), library {library_ms} ms, host {library_host_us} us "
        f"(torch.cuda.nccl.all_gather, one call over the cards; equal to K8's outputs: "
        f"{library_exact}); bound {nvlink_ms:.4f} ms over NVLink at 450 GB/s; launches "
        f"{rg.launch_info(blocks)}")
    assert exact, "K8 over the cards differs from torch.cat"
    assert library_exact in (None, True), "NCCL's all-gather differs from K8's"
    records["k8_row"] = {"max_abs_err": 0.0, **timed, "plain_ms": plain_ms,
                         "bound_ms": nvlink_ms, "bound_by": "bytes", "library_ms": library_ms,
                         "library_host_us": library_host_us, "ms_again": again["ms"],
                         "host_us_again": again["host_us"],
                         "library": "torch.cuda.nccl.all_gather (one process, one call over "
                                    "the cards)" if library_ms is not None else None,
                         "shape": f"halo bf16 P=4 block [6144, 256], one rank a card over "
                                  f"{n_cards} cards (NVLink)"}
    del blocks, outs

    # f32 depth 2 + 2 against the one-card run, under deterministic algorithms
    # (else atomics add in another order and a near-tie of the bipartite kNN
    # can pick another edge; the runs then see the same graph, as phase 14's
    # replayed kNN makes them); warn_only's warnings name the ops that ran
    # without a deterministic form
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            records["f32"] = multicard_f32(torch, events, cards, devices, n_cards)
    finally:
        torch.use_deterministic_algorithms(False)
    records["f32"]["nondeterministic"] = sorted({str(w.message).split(".")[0] for w in caught
                                                if "deterministic" in str(w.message)})
    log(f"26(d) ops without a deterministic form (warn_only's warnings) in the f32 forward, "
        f"steps and TP steps: {records['f32']['nondeterministic']}")
    torch.cuda.empty_cache()

    # bf16, full depth: the sharded event and the sharded step, on one card
    # (devices=None) and over the cards, in this call
    hp, _, pipeline = model_selector("BC-HGNN-GMM", {**FLAGSHIP, "halo_backend": "rdma"})
    batches = [preprocess_event(raw, hp, stage="test") for raw in events]

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def measured(label, run, items):
        """2 timed calls of ``run(item)`` after a warm-up, the peak of each
        card, each card's busy ms under the profiler (a repeat of the first)
        and the launches of the timed calls."""
        run(items[2])
        sync_all()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        before = dict(sa.LAUNCHES)
        host = []
        for item in items[:2]:
            t0 = time.perf_counter()
            run(item)
            sync_all()
            host.append(1e3 * (time.perf_counter() - t0))
        launches = {k: sa.LAUNCHES[k] - before[k] for k in sa.LAUNCHES if sa.LAUNCHES[k] > before[k]}
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(items[0])
            sync_all()
        busy = _busy_by_card(torch, prof)
        record = {"host_ms": host, "peak_gib": peaks, "busy_ms": busy,
                  "idle_pct": {k: 100 * (1 - v / host[0]) for k, v in busy.items()},
                  "launches": launches}
        log(f"26(d) bf16 flagship {label}: {[round(h, 1) for h in host]} ms (host clock), peak "
            f"GiB per card {[round(p, 2) for p in peaks]}, device busy ms per card "
            f"{ {k: round(v, 1) for k, v in busy.items()} } (idle share per card against the "
            f"first call's host ms {({k: round(v, 1) for k, v in record['idle_pct'].items()})}%), "
            f"launches {launches}")
        return record

    for label, devs in (("one card", None), ("cards", devices)):
        forward = make_sharded_forward(pipeline, N_PARTS, hp, devices=devs)
        records[f"event {label}"] = measured(f"sharded event, {label}", forward, batches)
        assert forward.last_stats["partition_ok"]
        del forward
        torch.cuda.empty_cache()
    k8 = records["event cards"]["launches"]
    assert k8["K8"] == k8["K8_split"] == n_cards * records["event one card"]["launches"]["K8"]

    for label, devs in (("one card", None), ("cards", devices)):
        hp_t, trainer = flagship_trainer({"mesh_shape": {"data": 1, "graph": N_PARTS},
                                          "halo_backend": "rdma"}, devices=devs)
        trainset, _, _ = trainer.make_datasets(events)
        records[f"step {label}"] = measured(
            f"sharded step, {label}", lambda b: trainer.train_step(b, TRAIN_EPOCH),
            [t[2] for t in trainset])
        del trainer, trainset
        torch.cuda.empty_cache()
    records["k8_row"]["launches"] = (records["event cards"]["launches"]["K8_split"]
                                     + records["step cards"]["launches"]["K8_split"])
    return records


def multicard_processes(torch, count):
    """26(e), on a host with 2 or more cards: the data axis over 2 processes
    that meet over NCCL, each on cards of its own.  Of n = 4 cards (2 where
    the host has fewer than 4) process p takes ``cards[p n / 2:(p + 1) n /
    2]``, named on its command line; with one card each its two graph ranks
    share it.  Each binds itself to its first card (``initialize``), builds
    ``make_global_mesh(2, devices=its cards)`` and keeps its model there.
    (a) The flagship (phase 25's worker, bf16, full width and depth, rdma):
    the processes' losses equal bit for bit and their states identical at
    both timed steps, K1-K6 and K8 launched in each, one gather a step,
    ``partition_ok``; host ms, busy and idle and peak per card, the gather's
    ms and bytes, and the gather alone.  (b) f32 at depth 2 + 2 against
    process 0's one-process ``{data 2, graph 2}`` step with its events' ranks
    on the same cards: within phase 25's bounds (loss 1e-4 relative, every
    parameter rtol 5e-4 / atol 1e-5), whether bit for bit is printed.
    Returns the workers' results."""
    n = 4 if count >= 4 else 2
    cards = [f"cuda:{i}" for i in range(n)]
    per = n // PROCESS_WORLD
    own = [cards[p * per:(p + 1) * per] for p in range(PROCESS_WORLD)]
    own = [c * (PROCESS_GRAPH // len(c)) for c in own]  # one card: both ranks share it
    reference = [d for c in own for d in c]
    with _scratch_dir() as tmp:
        results = run_processes(PROCESS_WORLD, "nccl", Path(tmp), own, reference)
    if PATH_CHECKED:  # phase 3 ran in this process
        unchecked = sorted({k for r in results for k in r["keys"]}
                           - {str(key) for key in PATH_CHECKED})
        assert not unchecked, f"26(e)'s kernel inputs never checked: {unchecked}"
    for r, mine in zip(results, own):
        assert r["backend"] == "nccl" and r["cards"] == mine, r
        assert r["current_device"] == torch.device(mine[0]).index, r
    for i in range(2):
        steps = [r["flagship"][i] for r in results]
        assert len({s["loss"] for s in steps}) == 1, f"26(e) step {i}: the losses differ"
        assert len({s["fingerprint"] for s in steps}) == 1, f"26(e) step {i}: states differ"
        for s in steps:
            assert s["partition_ok"] and s["process_gathers"] == 1, s
            for kernel in SHARDED_STEP_KERNELS:
                assert s["launches"][kernel] > 0, (kernel, s["launches"])
    parity = results[0]["parity"]
    assert results[1]["parity"]["loss"] == parity["loss"], "26(e): the parity losses differ"
    if parity["loss_rel"] > 1e-4 or parity["worst"] > 1:
        raise AssertionError(f"26(e): the 2-process step differs from one process's: {parity}")
    for r in results:
        if "k8" in r:
            log(f"26(e) process {r['rank']}: K8 bf16 P=2 [12288, 256] over its cards "
                f"{r['cards']}, exact, {r['k8']['launches']} launches a call: "
                f"{k8_text(r['k8'])}; NCCL {r['k8']['library_ms']:.4f} ms, host "
                f"{r['k8']['library_host_us']:.1f} us; bound {r['k8']['bound_ms']:.4f} ms")
    log(f"26(e) processes over nccl on cards {own}: losses equal and states identical at "
        f"both steps; f32 2 + 2 against one process over {reference}: loss rel "
        f"{parity['loss_rel']:.2e}, worst parameter {parity['worst']:.3f} of phase 25's bound, "
        f"bit for bit {parity['bit_for_bit']}; ops without a deterministic form "
        f"{sorted({op for r in results for op in r['parity']['nondeterministic']})}")
    return results


def multicard_cli(torch, count):
    """26(f), on a host with 4 cards: the CLI over the cards.  The flagship's
    ``train`` 1 epoch over ``mesh_shape {data 1, graph 4}`` with ``--devices
    cuda:0,cuda:0,cuda:0,cuda:0`` (phase 16's run), then with ``--devices
    cuda:0,cuda:1,cuda:2,cuda:3`` ``train`` 1 epoch, ``resume`` from
    ``last`` to epoch 2 and ``test`` (``cli_on_devices`` asserts each).  The
    logs' records up to the first epoch's end have the same keys in the same
    order, and the one over the cards goes on with a second epoch and the
    test.  Returns both runs' records."""
    common = ["--synthetic-particles", str(N_PARTICLES), "--log-every-n-steps", "1",
              *_flagship_sets((("train_split", [2, 1, 1]),))]
    with _scratch_dir() as tmp:
        one = cli_on_devices(torch, f"{tmp}/one", ["cuda:0"] * N_PARTS, common)
        many = cli_on_devices(torch, f"{tmp}/cards", [f"cuda:{i}" for i in range(N_PARTS)],
                              common, resume_to=2)
    keys = lambda records: [sorted(r) for r in records]
    first = len(one["records"])
    assert keys(many["records"][:first]) == keys(one["records"]), (one["records"],
                                                                   many["records"])
    rest = many["records"][first:]
    assert [r["epoch"] for r in rest if "val_loss" in r] == [1], rest
    assert any("test_track_eff" in r for r in rest), rest
    assert set(many["tested"]) == {"val_loss", "track_eff", "track_pur", "hit_eff", "hit_pur"}
    log(f"26(f) cli over {N_PARTS} cards: train / resume / test seconds {many['seconds']}, "
        f"epoch_time {[r['epoch_time'] for r in many['records'] if 'epoch_time' in r]} s (one "
        f"card: {[r['epoch_time'] for r in one['records'] if 'epoch_time' in r]}), peak GiB per "
        f"card {[round(p, 2) for p in many['peak_gib']]} (one card {one['peak_gib']}); test "
        f"{many['tested']}")
    return {"one card": one, "cards": many}


def phase_multicard(torch, events):
    """Phase 26: the card count, every card's ``nvidia-smi`` line and the
    peer-access matrix; (a) K8's split launches on one card, (b) the bound
    on its waits, (c) ``devices=[cuda:0] * 4`` against ``devices=None``, (d)
    the ranks on several cards and (e) processes over NCCL on cards of
    their own where the host has 2 or more, (f) the CLI over 4 cards (else
    one line each says it did not run); last, that the f32 steps of (d) and
    (e) equal one card's and one process's bit for bit.  Returns (K8's
    split-launch rows, the records of (d)-(f) or None)."""
    count = torch.cuda.device_count()
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    log(f"26 cards: {count}")
    for line in lines:
        log(f"  {line}")
    matrix = [["-" if a == b else ("yes" if torch.cuda.can_device_access_peer(a, b) else "no")
               for b in range(count)] for a in range(count)]
    log(f"26 peer access (row reaches column): {matrix}")
    rows = {}
    with watchdog():
        counted = multicard_split_launches(torch, rows)
        multicard_timeout(torch)
        multicard_one_card(torch, events)
    if count >= 2:
        with watchdog():
            records = multicard_cards(torch, events, min(N_PARTS, count))
        log("26(d) " + json.dumps(records))
        # the workers bound themselves (watchdog, PROCESS_TIMEOUT_S, the group's timeout)
        records["processes"] = multicard_processes(torch, count)
        log("26(e) " + json.dumps(records["processes"]))
    else:
        records = None
        log(f"26(d) did not run: this host has {count} card; the ranks on several cards "
            f"need at least 2")
        log(f"26(e) did not run: this host has {count} card; processes on cards of their "
            f"own need at least 2")
    if count >= N_PARTS:
        with watchdog():
            records["cli"] = multicard_cli(torch, count)
        log("26(f) " + json.dumps(records["cli"]))
    else:
        log(f"26(f) did not run: this host has {count} card(s); the CLI over cards needs "
            f"{N_PARTS}")
    if records is not None:
        # asserted last, so that a failure still leaves (e) and (f) measured:
        # the step over the cards adds every gradient's terms as one card does
        steps = records["f32"]["step"]
        assert all(r["loss_equal"] and r["leaves_differ"] == 0 and not r["buffers_differ"]
                   for r in steps.values()), (
            f"26(d): the f32 step over the cards is not one card's bit for bit: {steps}")
        parity = records["processes"][0]["parity"]
        assert parity["bit_for_bit"], (
            f"26(e): the processes' f32 step is not one process's bit for bit: {parity}")
    for split, n in counted.items():
        label = " + ".join(str(k) for k in split)
        rows[f"K8 split {label}"]["launches"] = n
        rows[f"K8 split {label}"]["launches_counted_in"] = "phase 26(a)"
    if records is not None:
        rows[f"K8 over {min(N_PARTS, count)} cards"] = {
            **records.pop("k8_row"), "launches_counted_in":
            "phase 26(d): 2 sharded events and 2 sharded steps over the cards",
            "launches_processes": sum(step["launches"]["K8"] for r in records["processes"]
                                      for step in r["flagship"][:2]),
            "launches_processes_counted_in": "phase 26(e): 2 steps in each process, over "
                                             "its own cards",
            "processes_k8": [r["k8"] for r in records["processes"] if "k8" in r]}
    return rows, records



def timed(name, fn, *args):
    """Run one phase; print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    if not (Path(__file__).resolve().parent / "hierarchicalgnn_torch").is_dir():
        raise SystemExit("hierarchicalgnn_torch/ is not beside chip_smoke.py: "
                         "run it from a checkout of the repo")
    if sys.argv[1:2] == ["--process-worker"]:
        rank, world, store, backend = sys.argv[2:6]
        cards, reference = ([a.split(",") for a in sys.argv[6:8]] if len(sys.argv) > 6
                            else (None, None))
        return process_worker(int(rank), int(world), store, backend, cards, reference)
    import torch

    if sys.argv[1:2] == ["--multicard"]:  # phase 26 alone, on every card the host has
        phase_device(torch)
        timed("build", phase_build)
        rows, records = timed("multicard", phase_multicard, torch, flagship_events())
        print(json.dumps({"kernels": rows, "multicard": records}))
        return 0

    start = time.perf_counter()
    phase_device(torch)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch)
    events = flagship_events()
    rows.update(timed("hdbscan", phase_hdbscan, torch, events))
    rows.update(timed("knn", phase_knn, torch, events))
    aggregator = timed("aggregator", phase_aggregator, torch)
    serving, serving_ms = timed("serving", phase_serving, torch, events)
    timed("parity", phase_parity, torch)
    timed("gradients", phase_gradients, torch)
    timed("auction", phase_auction, torch)
    training, training_ms = timed("training", phase_training, torch, events)
    timed("training parity", phase_training_parity, torch, events)
    models, _ = timed("models", phase_models, torch, events)
    timed("models parity", phase_models_parity, torch)
    timed("halo", phase_halo, torch)
    sharded, sharded_ms = timed("sharded serving", phase_sharded_serving, torch, events)
    timed("sharded parity", phase_sharded_parity, torch)
    sharded_models = timed("sharded models", phase_sharded_models, torch, events)
    cli = timed("cli", phase_cli, torch)
    timed("checkpoint", phase_checkpoint, torch, events)
    timed("grid knn", phase_grid_knn, torch, events)
    timed("streaming", phase_streaming, torch, events)
    sharded_training, sharded_training_ms, _ = timed(
        "sharded training", phase_sharded_training, torch, events)
    sharded_parity = timed("sharded training parity", phase_sharded_training_parity,
                           torch, events)
    sharded_models_training = timed("sharded models training",
                                    phase_sharded_models_training, torch, events)
    tp_training, tp_models, _ = timed("tp training", phase_tp_training, torch, events)
    tp_parity = timed("tp parity", phase_tp_parity, torch, events)
    processes, _ = timed("processes", phase_processes, torch)
    split_rows, multicard = timed("multicard", phase_multicard, torch, events)
    for kernel in NAMES:
        # K7's main path is its entry point make_aggregator, no model calls it;
        # K8's is the sharded forward
        ran = {"K7": aggregator, "K8": sharded}.get(kernel, training)[kernel]
        assert ran > 0, f"the main path never launched {kernel}"
        if kernel not in ("K7", "K8"):
            assert models[kernel] > 0, f"the four models never launched {kernel}"
    assert sharded_models["K8"] > 0, "the four models' sharded forwards never launched K8"
    for kernel in SHARDED_STEP_KERNELS:
        assert sharded_training[kernel] > 0, f"the sharded training step never launched {kernel}"
    assert sharded_models_training["K8"] > 0, "the other sharded training steps never launched K8"
    for kernel in TP_STEP_KERNELS:
        assert tp_training[kernel] > 0, f"the TP training step never launched {kernel}"
    for kernel in SHARDED_STEP_KERNELS:
        assert processes[kernel] > 0, f"the step over processes never launched {kernel}"
    for kernel in HD_NAMES:  # the embedding models' reconstruct, validation and test
        assert models[kernel] > 0, f"the embedding models' serving never launched {kernel}"
        assert cli[kernel] > 0, f"the embedding model's CLI run never launched {kernel}"
    assert models["HD2_cluster"] == models["HD2"], "the served events' MSTs left the cluster route"
    for kernel in KNN_NAMES:  # BC's dynamic graphs, the embedding models' pair mining
        assert training[kernel] > 0, f"the flagship's training never launched {kernel}"
        assert models[kernel] > 0, f"the four models never launched {kernel}"
    table = [{"name": NAMES[k], "route": "cuda", "source": CSRC + SOURCES[k],
              "replaces": REPLACES[k],
              "launches": (serving[k] + training[k] + models[k] + aggregator[k]
                           + sharded[k] + sharded_models[k] + cli[k] + sharded_training[k]
                           + sharded_models_training[k] + tp_training[k] + tp_models[k]
                           + processes[k]),
              "launches_serving_2_events": serving[k],
              "launches_training_3_steps": training[k],
              "launches_four_models": models[k],
              "launches_aggregator": aggregator[k],
              "launches_sharded_serving_2_events": sharded[k],
              "launches_sharded_four_models": sharded_models[k],
              "launches_cli": cli[k],
              "launches_sharded_training_2_steps": sharded_training[k],
              "launches_sharded_training_other_models_and_fit": sharded_models_training[k],
              "launches_sharded_training_parity": sharded_parity[k],
              "launches_tp_training_2_steps": tp_training[k],
              "launches_tp_four_models": tp_models[k],
              "launches_tp_parity": tp_parity[k],
              "launches_processes_flagship_2_steps": processes[k],
              **rows[k],
              "main_path_ms_per_launch": serving_ms.get(k, training_ms.get(k, sharded_ms.get(k))),
              "training_ms_per_launch": training_ms.get(k),
              "sharded_ms_per_launch": sharded_ms.get(k),
              "sharded_training_ms_per_launch": sharded_training_ms.get(k)}
             for k in NAMES]
    table += [{"name": HD_NAMES[k], "route": "cuda", "source": CSRC + SOURCES[k],
               "replaces": REPLACES[k], "launches": models[k] + cli[k],
               "launches_four_models": models[k], "launches_cli": cli[k], **rows[k]}
              for k in HD_NAMES]
    table += [{"name": KNN_NAMES[k], "route": "cuda", "source": CSRC + SOURCES[k],
               "replaces": REPLACES[k],
               "launches": serving[k] + training[k] + models[k] + cli[k] + sharded[k],
               "launches_serving_2_events": serving[k], "launches_training_3_steps": training[k],
               "launches_four_models": models[k], "launches_cli": cli[k],
               "launches_sharded_serving_2_events": sharded[k], **rows[k]}
              for k in KNN_NAMES]
    # K8 launched once per stream of one card (phase 26(a)) and, on a host with
    # several cards, once per card on the main path over them (phase 26(d))
    for name, row in split_rows.items():
        table.append({"name": f"{NAMES['K8']}, {name[3:]}", "route": "cuda",
                      "source": CSRC + SOURCES["K8"], "replaces": REPLACES["K8"], **row})
    log(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
