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

The kernels are CUDA C++ (``csrc/hdbscan.cu``).  Each wrapper takes the
plain PyTorch version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``sorted_agg.LAUNCHES["HD1"]`` and
``["HD2"]`` count the launches.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream)

SOURCE = "hdbscan.cu"
CORE_ENTRY = "hgnn_core_distances_f64"
MST_ENTRY = "hgnn_prim_mst_f64"
MAX_K = 16            # the source's kMaxK: HD1 keeps the k best in registers
MAX_D = 64            # HD1's query and tile rows in shared memory
MST_THREADS = 256     # the source's kMstThreads
SMEM_BYTES = 232448   # shared memory a block can use on Hopper
PLAIN_ROWS = 1024     # query rows per step of the plain HD1


@dataclasses.dataclass(frozen=True)
class MstSchedule:
    """How HD2 cuts N points: ``grid`` blocks of one cooperative launch, each
    holding ``points`` consecutive points (coordinates, core distance and
    Prim state) in ``smem`` bytes of shared memory."""

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


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _entry(name: str):
    return getattr(library(SOURCE), name)


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


def core_distances(x, k: int):
    """HD1: ``core[i]`` = distance from point i to its k-th nearest point
    (itself the first).  ``x``: [N, D] float64; returns [N] float64."""
    _check_points(x)
    if not 1 <= k <= x.shape[0]:
        raise ValueError(f"k must be in [1, {x.shape[0]}], got {k}")
    if _on_cpu(x):
        return core_distances_plain(x, k)
    if k > MAX_K or x.shape[1] > MAX_D:
        raise ValueError(f"core_distances on the card takes k <= {MAX_K} and D <= {MAX_D}, "
                         f"got k {k}, D {x.shape[1]}")
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return core_distances(x, k)
    out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    rc = _entry(CORE_ENTRY)(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], k,
                            _stream(x))
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
    ``x`` [N, D] float64 with core distances ``core`` [N] float64, grown by
    Prim's loop from node 0.  Returns (src int64 [N-1], dst int64 [N-1],
    distance float64 [N-1]) in the order the loop adds the edges."""
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
            return prim_mst(x, core)
    cut = mst_schedule(n, d, _sm_count(device))
    src = torch.empty(n - 1, dtype=torch.int64, device=x.device)
    dst = torch.empty(n - 1, dtype=torch.int64, device=x.device)
    dist = torch.empty(n - 1, dtype=torch.float64, device=x.device)
    cand = torch.empty(2 * cut.grid * (4 + d), dtype=torch.float64, device=x.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    rc = _entry(MST_ENTRY)(x.data_ptr(), core.data_ptr(), src.data_ptr(), dst.data_ptr(),
                           dist.data_ptr(), cand.data_ptr(), barrier.data_ptr(), n, d,
                           cut.grid, cut.points, cut.smem, _stream(x))
    _raise_on(rc, MST_ENTRY)
    LAUNCHES["HD2"] += 1
    return src, dst, dist
