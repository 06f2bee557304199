"""HDBSCAN's two heavy parts as kernels: HD1 the core distances, HD2 Prim's
minimum spanning tree of the mutual-reachability graph.

Neither has a Pallas counterpart: the JAX package runs this work on the host
through scikit-learn (``hierarchicalgnn_tpu/evaluation/candidates.py:43``).
They reproduce sklearn 1.9.0's float64 arithmetic, so that the labels of
``evaluation/hdbscan.py`` equal sklearn's:

  HD1 :func:`core_distances`  core[i] = the distance from point i to its
      k-th nearest point, counting itself at 0 (``hdbscan.py:340-356``:
      ``kneighbors(X, min_samples)[0][:, -1]``)
  HD2 :func:`prim_mst`        the N - 1 edges (src, dst, distance) in the
      order Prim's loop adds them (``_linkage.pyx:111-223``
      ``mst_from_data_matrix``)

A squared distance sums ``(x_f - y_f)^2`` in feature order with a separate
multiply and add, as sklearn's ``euclidean_rdist`` loop does, then takes a
correctly rounded ``sqrt``.  HD1 ranks squared distances (sqrt is monotone,
so the k-th is the same point); HD2 compares
``mr = max(core[cur], core[j], sqrt(d2))`` with ``min_reach[j]`` strictly and
takes the lowest index among the smallest ``min_reach`` as the next node.

The kernels are CUDA C++ (``csrc/hdbscan.cu``).  HD1 splits the candidate
axis over ``S`` slices (:func:`core_schedule`); HD2 runs Prim's loop in one
thread-block cluster (:func:`mst_cluster_schedule`) or, for N above the
cluster's capacity, in one cooperative grid (:func:`mst_schedule`): the route
is picked by size (:func:`mst_route`), never on a failure.  Each wrapper
takes the plain PyTorch version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``sorted_agg.LAUNCHES["HD1"]`` and
``["HD2"]`` count the launches, ``["HD2_cluster"]`` and ``["HD2_coop"]``
HD2's by route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream)

SOURCE = "hdbscan.cu"
CORE_ENTRY = "hgnn_core_distances_f64"
CLUSTER_SIZE_ENTRY = "hgnn_prim_mst_cluster_size"
CLUSTER_ENTRY = "hgnn_prim_mst_cluster_f64"
MST_ENTRY = "hgnn_prim_mst_f64"
MAX_K = 16            # the source's kMaxK: HD1 keeps the k best in registers
MAX_D = 64            # HD1's query rows and tiles in shared memory
CORE_THREADS = 128    # the source's kCoreThreads
CORE_Q = 2            # the source's kCoreQ: queries a thread of HD1
CORE_TILE = 64        # the source's kCoreTile: candidate rows a tile
CORE_WARPS_PER_SM = 32  # HD1's slices fill the card to about this many warps an SM
CLUSTER_THREADS = 1024  # the source's kClusterThreads: threads a CTA of HD2's cluster
MAX_PER_THREAD = 4    # the source's kMaxPerThread: points a thread of HD2's cluster
MST_THREADS = 256     # the source's kMstThreads
SMEM_BYTES = 232448   # shared memory a block can use on Hopper
PLAIN_ROWS = 1024     # query rows per step of the plain HD1


@dataclasses.dataclass(frozen=True)
class CoreSchedule:
    """How HD1 cuts N points: ``blocks`` query blocks of CORE_THREADS *
    CORE_Q queries, each scanning the candidates in ``slices`` slices, one
    block for each (query block, slice)."""

    blocks: int
    slices: int


def core_schedule(n: int, sms: int, slices: int | None = None) -> CoreSchedule:
    """HD1's grid.  ``slices`` None: enough slices that the card holds about
    CORE_WARPS_PER_SM warps an SM, and at most one a tile of candidates.
    Raises on a ``slices`` outside [1, min(N, 65535)]."""
    blocks = -(-n // (CORE_THREADS * CORE_Q))
    if slices is None:
        target = sms * CORE_WARPS_PER_SM // (CORE_THREADS // 32)
        slices = max(1, min(-(-target // blocks), -(-n // CORE_TILE)))
    if not 1 <= slices <= min(n, 65535):
        raise ValueError(f"core_distances: slices must be in [1, {min(n, 65535)}], got {slices}")
    return CoreSchedule(blocks=blocks, slices=slices)


@dataclasses.dataclass(frozen=True)
class MstClusterSchedule:
    """HD2's cluster route: one thread-block cluster of ``cluster`` CTAs of
    CLUSTER_THREADS threads, each CTA holding ``points`` consecutive points
    (``per_thread`` a thread) in ``smem`` bytes of shared memory."""

    cluster: int
    points: int
    per_thread: int
    smem: int


def _cluster_fixed_bytes(d: int, cluster: int) -> int:
    """A CTA's shared memory beside the coordinates: two parities of a
    record (key, index and source, core, d coordinates; an even number of
    words) from every CTA, its own two records, two mbarriers, node 0's
    record, and two parities of the 32 warps' partials (12 bytes each)."""
    words = (3 + d + 1) // 2 * 2
    return 8 * (2 * cluster * words + 3 * words + 2) + 2 * 12 * 32


def mst_cluster_schedule(n: int, d: int, cluster: int) -> MstClusterSchedule | None:
    """The points dealt evenly over the cluster's CTAs; None where a CTA's
    share needs more than MAX_PER_THREAD points a thread or more shared
    memory than a block has."""
    points = -(-n // cluster)
    per_thread = -(-points // CLUSTER_THREADS)
    smem = 16 * -(-d * points // 2) + _cluster_fixed_bytes(d, cluster)
    if per_thread > MAX_PER_THREAD or smem > SMEM_BYTES:
        return None
    return MstClusterSchedule(cluster=cluster, points=points, per_thread=per_thread, smem=smem)


def mst_cluster_capacity(d: int, cluster: int) -> int:
    """The most points the cluster route holds at width ``d``."""
    by_smem = (SMEM_BYTES - _cluster_fixed_bytes(d, cluster)) // (8 * d)
    return cluster * max(0, min(MAX_PER_THREAD * CLUSTER_THREADS, by_smem))


@dataclasses.dataclass(frozen=True)
class MstSchedule:
    """HD2's cooperative route: ``grid`` blocks of one cooperative launch,
    each holding ``points`` consecutive points (coordinates, core distance
    and Prim state) in ``smem`` bytes of shared memory."""

    grid: int
    points: int
    smem: int


def mst_schedule(n: int, d: int, sms: int) -> MstSchedule:
    """One block per MST_THREADS points, at most one a SM (every block
    takes part in every step's grid barrier, so fewer blocks mean a cheaper
    barrier); then the points dealt evenly.  Raises where a block's share
    does not fit in shared memory."""
    grid = max(1, min(sms, -(-n // MST_THREADS)))
    points = -(-n // grid)
    stride = 4 + d  # a block's candidate: min_reach, index, source, core, coordinates
    smem = points * (8 * d + 8 + 8 + 8 + 1) + 8 * grid * stride + 16 * 32 + 16
    smem = -(-smem // 16) * 16
    if smem > SMEM_BYTES:
        raise ValueError(f"prim_mst: {n} points of width {d} need {smem} bytes of shared "
                         f"memory a block over {grid} blocks, above {SMEM_BYTES}")
    return MstSchedule(grid=grid, points=points, smem=smem)


def mst_route(n: int, d: int, cluster: int, sms: int) -> MstClusterSchedule | MstSchedule:
    """HD2's route for N points of width ``d``: the cluster of ``cluster``
    CTAs where they fit, else the cooperative grid over ``sms`` SMs, which
    raises where they do not fit either."""
    cut = mst_cluster_schedule(n, d, cluster)
    return cut if cut is not None else mst_schedule(n, d, sms)


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _entry(name: str):
    return getattr(library(SOURCE), name)


@functools.cache
def mst_cluster_size(device: int) -> tuple[int, int, int]:
    """(the cluster size HD2 takes on ``device``, how many clusters of 16
    and of 8 CTAs it holds at once), from ``cudaOccupancyMaxActiveClusters``
    at a full block's shared memory: 16 where the card schedules a cluster
    of 16, else 8.  Raises where the query fails or neither fits."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = _entry(CLUSTER_SIZE_ENTRY)(SMEM_BYTES, info)
    _raise_on(rc, CLUSTER_SIZE_ENTRY)
    return info[0], info[1], info[2]


def _check_points(x):
    if x.ndim != 2 or x.dtype != torch.float64 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous 2-D float64, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must hold points of at least one feature, got {tuple(x.shape)}")


def squared_distances_plain(a, b):
    """[A, D] x [B, D] -> [A, B]: sum over f of (a_f - b_f)^2 in feature
    order, one multiply and one add per feature (never ``.sum(-1)`` or
    ``cdist``: both reorder the additions)."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for f in range(a.shape[1]):
        t = a[:, f, None] - b[None, :, f]
        acc = acc + t * t
    return acc


def sqrt_rn(t):
    """The correctly rounded square root, as sklearn's C ``sqrt`` and the
    kernels' ``__dsqrt_rn`` give it.  ``torch.sqrt`` on a CPU float64 tensor
    is not always (sqrt(8) comes out one ulp low); numpy's is, and so is
    ``torch.sqrt`` on a CUDA tensor."""
    return torch.from_numpy(np.sqrt(t.numpy())) if t.is_cpu else torch.sqrt(t)


def core_distances_plain(x, k: int):
    """HD1's plain version: the k-th smallest squared distance of each row
    to all points, then its square root."""
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for start in range(0, x.shape[0], PLAIN_ROWS):
        d2 = squared_distances_plain(x[start:start + PLAIN_ROWS], x)
        out[start:start + PLAIN_ROWS] = sqrt_rn(torch.kthvalue(d2, k, dim=1).values)
    return out


def core_distances(x, k: int, slices: int | None = None):
    """HD1: ``core[i]`` = distance from point i to its k-th nearest point
    (itself the first).  ``x``: [N, D] float64; returns [N] float64.  On the
    card the candidates are split over ``slices`` (None: ``core_schedule``'s
    choice); the result does not depend on it."""
    _check_points(x)
    n, d = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if _on_cpu(x):
        return core_distances_plain(x, k)
    if k > MAX_K or d > MAX_D:
        raise ValueError(f"core_distances on the card takes k <= {MAX_K} and D <= {MAX_D}, "
                         f"got k {k}, D {d}")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return core_distances(x, k, slices)
    cut = core_schedule(n, _sm_count(device), slices)
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    part = torch.empty(cut.slices * n * k if cut.slices > 1 else 0, dtype=torch.float64,
                       device=x.device)
    arrivals = torch.zeros(cut.blocks, dtype=torch.int32, device=x.device)
    rc = _entry(CORE_ENTRY)(x.data_ptr(), out.data_ptr(), part.data_ptr(), arrivals.data_ptr(),
                            n, d, k, cut.slices, _stream(x))
    _raise_on(rc, CORE_ENTRY)
    LAUNCHES["HD1"] += 1
    return out


def prim_mst_plain(x, core):
    """HD2's plain version: sklearn's loop with the inner loop over j as
    tensor operations; the state stays on ``x``'s device (no host read a
    step)."""
    n, dev = x.shape[0], x.device
    index = torch.arange(n, device=dev)
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    min_reach = torch.full((n,), torch.inf, dtype=torch.float64, device=dev)
    source = torch.ones(n, dtype=torch.int64, device=dev)
    src = torch.empty(n - 1, dtype=torch.int64, device=dev)
    dst = torch.empty(n - 1, dtype=torch.int64, device=dev)
    dist = torch.empty(n - 1, dtype=torch.float64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    for i in range(n - 1):
        in_tree[cur] = True
        pair = sqrt_rn(squared_distances_plain(x[cur], x)[0])
        mr = torch.maximum(torch.maximum(core[cur], core), pair)
        update = ~in_tree & (mr < min_reach)
        min_reach = torch.where(update, mr, min_reach)
        source = torch.where(update, cur, source)
        open_reach = torch.where(in_tree, torch.inf, min_reach)
        best = open_reach.min()
        cur = torch.where(open_reach == best, index, n).min().reshape(1)
        src[i], dst[i], dist[i] = source[cur][0], cur[0], min_reach[cur][0]
    return src, dst, dist


def prim_mst(x, core):
    """HD2: the minimum spanning tree of the mutual-reachability graph of
    ``x`` [N, D] float64 with core distances ``core`` [N] float64 (>= 0),
    grown by Prim's loop from node 0.  Returns (src int64 [N-1], dst int64
    [N-1], distance float64 [N-1]) in the order the loop adds the edges.  On
    the card: the cluster route where N fits it, else the cooperative one."""
    return _prim_mst(x, core, cooperative=False)


def prim_mst_cooperative(x, core):
    """HD2 by the cooperative route whatever N: the route :func:`prim_mst`
    takes above the cluster's capacity, callable on its own so that it can
    be held against the plain version at sizes the cluster also holds."""
    return _prim_mst(x, core, cooperative=True)


def _prim_mst(x, core, cooperative: bool):
    _check_points(x)
    n, d = x.shape
    if core.shape != (n,) or core.dtype != torch.float64 or not core.is_contiguous():
        raise ValueError(f"core must be contiguous float64 [{n}], got {core.dtype} "
                         f"{tuple(core.shape)}")
    if _on_cpu(x, core):
        return prim_mst_plain(x, core)
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _prim_mst(x, core, cooperative)
    sms = _sm_count(device)
    cut = (mst_schedule(n, d, sms) if cooperative
           else mst_route(n, d, mst_cluster_size(device)[0], sms))
    src = torch.empty(n - 1, dtype=torch.int64, device=x.device)
    dst = torch.empty(n - 1, dtype=torch.int64, device=x.device)
    dist = torch.empty(n - 1, dtype=torch.float64, device=x.device)
    if isinstance(cut, MstSchedule):
        cand = torch.empty(2 * cut.grid * (4 + d), dtype=torch.float64, device=x.device)
        barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
        rc = _entry(MST_ENTRY)(x.data_ptr(), core.data_ptr(), src.data_ptr(), dst.data_ptr(),
                               dist.data_ptr(), cand.data_ptr(), barrier.data_ptr(), n, d,
                               cut.grid, cut.points, cut.smem, _stream(x))
        _raise_on(rc, MST_ENTRY)
        LAUNCHES["HD2_coop"] += 1
    else:
        rc = _entry(CLUSTER_ENTRY)(x.data_ptr(), core.data_ptr(), src.data_ptr(),
                                   dst.data_ptr(), dist.data_ptr(), n, d, cut.cluster,
                                   cut.points, cut.per_thread, cut.smem, _stream(x))
        _raise_on(rc, CLUSTER_ENTRY)
        LAUNCHES["HD2_cluster"] += 1
    LAUNCHES["HD2"] += 1
    return src, dst, dist
