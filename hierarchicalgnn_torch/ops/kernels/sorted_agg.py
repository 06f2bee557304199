"""Receiver-sorted plan, the three CSR segment-reduction kernels and their
gradients.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/sorted_agg.py``.  Edge
tensors live in receiver-sorted order for the whole forward; a
:class:`SortedPlan` holds the sort and the CSR row pointers.

  K1 :func:`sorted_aggregate`           out[i] = sum_{recv(e)=i} data_e
  K2 :func:`sorted_aggregate_weighted`  out[i] = sum_{recv(e)=i} w_e data_e
  K5 :func:`sorted_segment_min_i32`     out[i] = min_{recv(e)=i} v_e

The kernels are CUDA C++ (``csrc/segment_csr.cu``).  Each wrapper takes
its plain PyTorch version only for tensors on the CPU; for a CUDA tensor
it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so
a run can show that its path went through them; a K1 or K2 call counts
once, though it is two device launches (the tile kernel and its fix-up,
cut as :func:`csr_tiling` says).  K5 is one device launch a call, cut by
edges as :func:`min_tiling` says.

K1 and K2 are differentiable (``torch.autograd.Function``): their
backward runs the K3/K4 kernels of ``ops/kernels/sddmm.py``
(``sorted_agg.py:228-246`` and ``:361-384`` of the JAX package), and
:func:`gather_edge_endpoints` is the endpoint gather whose backward is K1
over the plan and its transposed plan (``sorted_agg.py:506-563``).

CSR needs no chunk budget, so the port has no ``overflowed`` path: the
JAX version's ``lax.cond`` fallback to XLA is a TPU workaround.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading

import torch

from hierarchicalgnn_torch.ops.kernels.build import library

INT32_MAX = 2**31 - 1

# Kernel launches since the last reset, by kernel (K3/K4 are counted by
# ops/kernels/sddmm.py, K6 by ops/kernels/top2.py, K7 by
# ops/kernels/segment_gather.py, K8 by ops/kernels/ring_gather.py, HD1/HD2
# by ops/kernels/hdbscan.py, which also counts HD2's launches by route, and
# K8's launches of calls split over several cards or streams as K8_split).
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0, "K3": 0, "K4": 0, "K6": 0, "K7": 0, "K8": 0,
            "K8_split": 0, "HD1": 0, "HD2": 0, "HD2_cluster": 0, "HD2_coop": 0}
# The ranks of a shard group are threads of one process (parallel/comm.py) and
# launch K1, K2 and K5 side by side: their counts are added under this lock.
COUNT_LOCK = threading.Lock()


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


@dataclasses.dataclass(frozen=True)
class SortedPlan:
    """Receiver-sort plan for a fixed edge structure of E edges."""

    perm: torch.Tensor              # int64[E]: original index per sorted slot
    inv_perm: torch.Tensor          # int64[E]: sorted slot per original index
    senders_sorted: torch.Tensor    # int64[E] (0 in invalid slots)
    receivers_sorted: torch.Tensor  # int64[E] (0 in invalid slots)
    edge_mask_sorted: torch.Tensor  # bool[E]: valid slots first
    row_ptr: torch.Tensor           # int32[num_segments + 1]
    num_segments: int
    receivers_i32: torch.Tensor     # int32[E]: receivers_sorted for K1-K4

    def sort(self, x):
        """Original-order edge array -> sorted order, invalid slots zeroed."""
        out = x[self.perm]
        m = self.edge_mask_sorted.reshape((-1,) + (1,) * (out.ndim - 1))
        return torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))

    def unsort(self, x):
        """Sorted order -> original edge order."""
        return x[self.inv_perm]


def build_sorted_plan(senders, receivers, edge_mask, num_segments) -> SortedPlan:
    """Stable sort of the edges by receiver with invalid edges last.

    The JAX plan pads the edge count to a multiple of its block; the port
    does not, and its valid sorted slots coincide with JAX's.  Row ``i``'s
    edges are ``[row_ptr[i], row_ptr[i+1])``.
    """
    receivers = receivers.long()
    key = torch.where(edge_mask, receivers, num_segments)
    perm = torch.argsort(key, stable=True)
    inv_perm = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))
    mask_sorted = edge_mask[perm]
    row_ptr = torch.searchsorted(
        key[perm], torch.arange(num_segments + 1, device=key.device))
    receivers_sorted = torch.where(mask_sorted, receivers[perm], 0)
    return SortedPlan(
        perm=perm, inv_perm=inv_perm,
        senders_sorted=torch.where(mask_sorted, senders.long()[perm], 0),
        receivers_sorted=receivers_sorted,
        edge_mask_sorted=mask_sorted,
        row_ptr=row_ptr.to(torch.int32), num_segments=num_segments,
        receivers_i32=receivers_sorted.to(torch.int32))


def cross_permutation(plan: SortedPlan, plan_t: SortedPlan):
    """For two plans over the same edge list: ``r2s[k]`` is the slot of
    ``plan`` that holds the same original edge as slot ``k`` of ``plan_t``
    (0 in the invalid slots of ``plan_t``)."""
    return torch.where(plan_t.edge_mask_sorted, plan.inv_perm[plan_t.perm], 0)


def build_transposed_plan(plan: SortedPlan, senders, receivers, edge_mask,
                          num_segments):
    """Sender-sorted companion plan and :func:`cross_permutation` for the
    sender side of :func:`gather_edge_endpoints`' backward."""
    plan_t = build_sorted_plan(receivers, senders, edge_mask, num_segments)
    return plan_t, cross_permutation(plan, plan_t)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path, and what the kernels are held to.
# ---------------------------------------------------------------------------


def sorted_aggregate_plain(data_sorted, plan: SortedPlan):
    vals = torch.where(plan.edge_mask_sorted[:, None], data_sorted.float(), 0.0)
    out = torch.zeros((plan.num_segments, data_sorted.shape[1]),
                      dtype=torch.float32, device=data_sorted.device)
    return out.index_add_(0, plan.receivers_sorted, vals)


def sorted_aggregate_weighted_plain(data_sorted, weights_sorted, plan: SortedPlan):
    w = torch.where(plan.edge_mask_sorted,
                    weights_sorted.reshape(-1).float(), 0.0)
    return sorted_aggregate_plain(data_sorted.float() * w[:, None], plan)


def sorted_segment_min_i32_plain(values_sorted, plan: SortedPlan):
    vals = torch.where(plan.edge_mask_sorted, values_sorted.int(), INT32_MAX)
    out = torch.full((plan.num_segments,), INT32_MAX, dtype=torch.int32,
                     device=values_sorted.device)
    return out.scatter_reduce_(0, plan.receivers_sorted, vals, "amin")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_SUM_ENTRY = {torch.bfloat16: "hgnn_csr_sum_bf16", torch.float32: "hgnn_csr_sum_f32"}
_WSUM_ENTRY = {torch.bfloat16: "hgnn_csr_wsum_bf16", torch.float32: "hgnn_csr_wsum_f32"}

# K1/K2 cut the valid edges into tiles of 128 edges, or of 64 or 32 where
# larger tiles would leave fewer than MIN_TILES (about 4 a SM) for the grid:
# on a small input the walk down a tile, 16 edges a round trip, sets the time
TILE_SIZES = (128, 64, 32)
MIN_TILES = 512
_TILE_THREADS, _FIXUP_THREADS = 64, 256  # threads per block of the two kernels


@dataclasses.dataclass(frozen=True)
class CsrTiling:
    """How K1/K2 (and K7) cut one call: ``lanes`` threads (a power of two up
    to 32, 16 bytes of columns each, or K7's load width) per worker, ``slices`` column slices of
    ``lanes`` vectors, one worker per tile of ``tile`` edges in the tile
    kernel and per row in the fix-up, ``scratch_rows`` f32 rows of width D
    for the cut rows' partials (two per tile).  Grids are (blocks, slices)."""

    tile: int
    lanes: int
    slices: int
    n_tiles: int
    scratch_rows: int
    main_grid: tuple[int, int]
    fixup_grid: tuple[int, int]


def tile_edges(n_edges: int) -> int:
    """The largest of TILE_SIZES that cuts ``n_edges`` into MIN_TILES tiles
    or more, else the smallest."""
    for tile in TILE_SIZES:
        if -(-n_edges // tile) >= MIN_TILES:
            return tile
    return TILE_SIZES[-1]


def tile_for_threads(n_edges: int, threads_per_tile: int, min_threads: int) -> int:
    """The largest of TILE_SIZES whose tiles give ``min_threads`` threads or
    more at ``threads_per_tile`` each, else the smallest (K7's rule: a
    gathered row costs a round trip for ``perm`` before its load, so narrow
    rows, few lanes a tile, take shorter tiles)."""
    for tile in TILE_SIZES:
        if -(-n_edges // tile) * threads_per_tile >= min_threads:
            return tile
    return TILE_SIZES[-1]


def _lanes_and_slices(vectors: int) -> tuple[int, int]:
    """A worker's lanes (a power of two up to 32, one vector each) and the
    column slices that cover ``vectors`` vectors of a row."""
    lanes = min(32, 1 << max(0, vectors - 1).bit_length())
    return lanes, -(-vectors // lanes)


@functools.lru_cache(maxsize=1024)
def csr_tiling(n_edges: int, n_rows: int, d: int, element_size: int, width: int = 16,
               min_threads: int | None = None) -> CsrTiling:
    """The cut of a K1/K2 (or K7) call over ``n_edges`` edge slots (valid or
    not: the grid is sized on the host, and a tile past ``row_ptr[N]``
    exits), as the C launcher takes it, for lanes that load ``width`` bytes
    of a row each (K1/K2 16, K7 ``segment_gather.load_width``).  The tile is
    :func:`tile_edges`, or with ``min_threads`` :func:`tile_for_threads`.
    Cached: the wrapper asks at every call."""
    lanes, slices = _lanes_and_slices(-(-d * element_size // width))
    if min_threads is None:
        tile = tile_edges(n_edges)
    else:  # counted in 16-byte lanes at any width, so that the cut, and the order
        # in which a row is summed, is the same at every alignment of the base
        tile = tile_for_threads(n_edges, math.prod(_lanes_and_slices(-(-d * element_size // 16))),
                                min_threads)
    n_tiles = -(-n_edges // tile)
    return CsrTiling(tile=tile, lanes=lanes, slices=slices, n_tiles=n_tiles,
                     scratch_rows=2 * n_tiles,
                     main_grid=(-(-n_tiles // (_TILE_THREADS // lanes)), slices),
                     fixup_grid=(-(-n_rows // (_FIXUP_THREADS // lanes)), slices))


# f32 scratch for the cut rows' partials, one buffer per (device, stream),
# grown as needed.  Calls on one stream run in order, so they can share it;
# the ranks of a shard group (parallel/comm.py) take turns on one stream.
_PARTIALS = {}
_PARTIALS_LOCK = threading.Lock()


def _partials(device, stream: int, n_floats: int):
    key = (device.index, stream)
    buf = _PARTIALS.get(key)
    if buf is not None and buf.numel() >= n_floats:
        return buf
    with _PARTIALS_LOCK:
        buf = _PARTIALS.get(key)
        if buf is None or buf.numel() < n_floats:
            buf = _PARTIALS[key] = torch.empty(max(n_floats, 1), dtype=torch.float32,
                                               device=device)
    return buf


# K5 cuts the valid edges into tiles of 64 edges, one warp each (a lane a run
# of 2), or of 32 where tiles of 64 would be fewer than MIN_MIN_TILES: the CC
# hop (E 98304) takes T 64, one rank's hop (36864) T 32 (scripts/k5_k7_sweep.py)
MIN_TILE_SIZES = (64, 32)
MIN_MIN_TILES = 1024


@dataclasses.dataclass(frozen=True)
class MinTiling:
    """How K5 cuts one call: ``n_tiles`` tiles of ``tile`` edges, one warp
    each (the C launcher puts 4 in a block, and launches one block at least:
    with no valid edge the kernel fills every row)."""

    tile: int
    n_tiles: int


def min_tile_edges(n_edges: int) -> int:
    """The largest of MIN_TILE_SIZES that cuts ``n_edges`` into
    MIN_MIN_TILES tiles or more, else the smallest."""
    for tile in MIN_TILE_SIZES:
        if -(-n_edges // tile) >= MIN_MIN_TILES:
            return tile
    return MIN_TILE_SIZES[-1]


@functools.lru_cache(maxsize=1024)
def min_tiling(n_edges: int) -> MinTiling:
    """The cut of a K5 call over ``n_edges`` edge slots, from E alone (a
    tile past ``row_ptr[N]`` exits).  Cached: the wrapper asks at every
    call."""
    tile = min_tile_edges(n_edges)
    return MinTiling(tile=tile, n_tiles=-(-n_edges // tile))


# K5's scratch, one per (device, stream): an arrival counter and a min word
# per row, for the rows that cross tiles, set once when allocated (0 and
# INT32_MAX) and set back by the kernel that uses them.  Grown as needed,
# never shrunk.
_MIN_SCRATCH = {}


def _min_scratch(device, stream: int, n_rows: int):
    """(arrivals, mins) for a K5 call over ``n_rows`` rows: views of one
    int32 buffer of 2 * capacity, the counters first."""
    key = (device.index, stream)
    found = _MIN_SCRATCH.get(key)
    if found is None or found[0].numel() < n_rows:
        with _PARTIALS_LOCK:
            found = _MIN_SCRATCH.get(key)
            if found is None or found[0].numel() < n_rows:
                cap = max(n_rows, 1)
                buf = torch.zeros(2 * cap, dtype=torch.int32, device=device)
                buf[cap:] = INT32_MAX
                found = _MIN_SCRATCH[key] = (buf[:cap], buf[cap:])
    return found


def _on_cpu(*tensors) -> bool:
    if all(t.is_cpu for t in tensors):
        return True
    if all(t.is_cuda for t in tensors):
        return False
    devices = {t.device.type for t in tensors}
    raise ValueError(f"tensors on unsupported or mixed devices: {devices}")


def _check_edges(t, plan: SortedPlan, name):
    if t.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"{name} has {t.shape[0]} rows, the plan {plan.perm.shape[0]} edges")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_data(data, plan: SortedPlan):
    if data.ndim != 2 or data.dtype not in _SUM_ENTRY:
        raise ValueError(f"data must be 2-D bfloat16 or float32, got "
                         f"{data.dtype} {tuple(data.shape)}")
    _check_edges(data, plan, "data")
    per_vec = 16 // data.element_size()
    if data.shape[1] % per_vec:
        raise ValueError(f"feature width {data.shape[1]} must be a multiple of "
                         f"{per_vec} for {data.dtype}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")


def _raise_on(rc: int, entry: str):
    if rc:
        raise RuntimeError(f"{entry} failed to launch: cudaError {rc}")


def _stream(t) -> int:
    """The handle of the current stream of ``t``'s card (the raw accessor:
    ``torch.cuda.current_stream`` builds a Stream object at every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.cache
def _tile_entry(weighted: bool, dtype):
    return getattr(library(), (_WSUM_ENTRY if weighted else _SUM_ENTRY)[dtype])


def _tile_sum(data_sorted, w, plan: SortedPlan):
    """Launch K1 (``w`` None) or K2 on CUDA tensors: the tile kernel and its
    fix-up, one C call."""
    if data_sorted.get_device() != torch.cuda.current_device():
        with torch.cuda.device(data_sorted.device):  # launch with its card current
            return _tile_sum(data_sorted, w, plan)
    _check_data(data_sorted, plan)
    (e, d), n = data_sorted.shape, plan.num_segments
    out = data_sorted.new_empty((n, d), dtype=torch.float32)
    cut = csr_tiling(e, n, d, data_sorted.element_size())
    weights = () if w is None else (w.data_ptr(),)
    stream = _stream(data_sorted)
    partials = _partials(data_sorted.device, stream, cut.scratch_rows * d)
    entry = _tile_entry(w is not None, data_sorted.dtype)
    rc = entry(data_sorted.data_ptr(), *weights, plan.receivers_i32.data_ptr(),
               plan.row_ptr.data_ptr(), out.data_ptr(), partials.data_ptr(), e, n, d,
               cut.tile, cut.lanes, stream)
    _raise_on(rc, entry.__name__)
    return out


def _k1(data_sorted, plan: SortedPlan):
    """K1 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data_sorted, plan.row_ptr):
        return sorted_aggregate_plain(data_sorted, plan)
    out = _tile_sum(data_sorted, None, plan)
    with COUNT_LOCK:
        LAUNCHES["K1"] += 1
    return out


def _k2(data_sorted, weights_sorted, plan: SortedPlan):
    """K2 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data_sorted, weights_sorted, plan.row_ptr):
        return sorted_aggregate_weighted_plain(data_sorted, weights_sorted, plan)
    w = weights_sorted if weights_sorted.ndim == 1 else weights_sorted.reshape(-1)
    if w.dtype != torch.float32:
        raise ValueError(f"weights must be float32, got {w.dtype}")
    _check_edges(w, plan, "weights")
    out = _tile_sum(data_sorted, w, plan)
    with COUNT_LOCK:
        LAUNCHES["K2"] += 1
    return out


class _SortedAggregate(torch.autograd.Function):
    """K1 forward; backward ``d_data[e] = g[recv(e)]`` through K4."""

    @staticmethod
    def forward(ctx, data_sorted, plan):
        ctx.plan, ctx.dtype = plan, data_sorted.dtype
        return _k1(data_sorted, plan)

    @staticmethod
    def backward(ctx, g):
        from hierarchicalgnn_torch.ops.kernels.sddmm import scaled_gather

        # the cotangent is f32 (K1's output); the gradient takes the data's dtype
        return scaled_gather(None, g.float().contiguous(), ctx.plan,
                             out_dtype=ctx.dtype), None


class _SortedAggregateWeighted(torch.autograd.Function):
    """K2 forward; backward ``d_data[e] = w_e g[recv(e)]`` through K4 and
    ``d_w[e] = <data_e, g[recv(e)]>`` through K3."""

    @staticmethod
    def forward(ctx, data_sorted, weights_sorted, plan):
        ctx.plan = plan
        ctx.save_for_backward(data_sorted, weights_sorted)
        return _k2(data_sorted, weights_sorted, plan)

    @staticmethod
    def backward(ctx, g):
        from hierarchicalgnn_torch.ops.kernels.sddmm import _k3, scaled_gather

        data, weights = ctx.saved_tensors
        g = g.float().contiguous()
        d_data = d_w = None
        if ctx.needs_input_grad[0]:
            w = weights.reshape(-1).float().contiguous()
            d_data = scaled_gather(w, g, ctx.plan, out_dtype=data.dtype)
        if ctx.needs_input_grad[1]:
            d_w = _k3(data, g, ctx.plan).reshape(weights.shape).to(weights.dtype)
        return d_data, d_w, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def sorted_aggregate(data_sorted, plan: SortedPlan):
    """K1: masked segment sum of plan-order edge rows -> f32 [num_segments, D].

    Replaces ``_sorted_kernel`` (hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:148).
    Differentiable in ``data_sorted``.
    """
    if _wants_grad(data_sorted):
        return _SortedAggregate.apply(data_sorted, plan)
    return _k1(data_sorted, plan)


def sorted_aggregate_weighted(data_sorted, weights_sorted, plan: SortedPlan):
    """K2: ``out[i] = sum_{recv(e)=i} w_e data_e`` in f32 -> [num_segments, D].

    Replaces ``_sorted_weighted_kernel`` (sorted_agg.py:252).  The weight is
    kept in f32 and multiplied in f32; the Pallas kernel rounds it to the
    data's dtype first (sorted_agg.py:275-276).  Differentiable in both
    ``data_sorted`` and ``weights_sorted`` ([E] or [E, 1]).
    """
    if _wants_grad(data_sorted, weights_sorted):
        return _SortedAggregateWeighted.apply(data_sorted, weights_sorted, plan)
    return _k2(data_sorted, weights_sorted, plan)


class _GatherEndpoints(torch.autograd.Function):
    """``(nodes[senders], nodes[offset + receivers])`` in plan order; the
    backward's two scatter-adds are K1 over the plan and over the transposed
    plan, added in f32 and rounded once."""

    @staticmethod
    def forward(ctx, nodes, plan, plan_t, r2s, offset):
        ctx.plan, ctx.plan_t, ctx.r2s, ctx.offset = plan, plan_t, r2s, offset
        own = nodes.narrow(0, offset, plan.num_segments)
        return nodes[plan.senders_sorted], own[plan.receivers_sorted]

    @staticmethod
    def backward(ctx, g_s, g_r):
        # K1 reads valid slots only, so neither cotangent needs masking;
        # the sender cotangent moves into the transposed plan's slot order
        d_r = _k1(g_r.contiguous(), ctx.plan)
        d_s = _k1(g_s[ctx.r2s], ctx.plan_t)
        d_s.narrow(0, ctx.offset, d_r.shape[0]).add_(d_r)
        return d_s.to(g_r.dtype), None, None, None, None


def gather_edge_endpoints(nodes, plan: SortedPlan, plan_t=None, r2s=None, offset: int = 0):
    """``(nodes[senders], nodes[offset + receivers])`` in plan order: the
    senders index all of ``nodes``, the receivers (``plan``'s segments) its
    rows from ``offset`` on.

    With the transposed plan (:func:`build_transposed_plan`, over all of
    ``nodes``' rows) the backward runs K1 twice instead of autograd's
    scatter-add, is deterministic and rounds the gradient once.  Without it
    this is plain indexing.
    """
    if plan_t is None or not _wants_grad(nodes):
        own = nodes.narrow(0, offset, plan.num_segments)
        return nodes[plan.senders_sorted], own[plan.receivers_sorted]
    return _GatherEndpoints.apply(nodes, plan, plan_t, r2s, offset)


class _GatherSenders(torch.autograd.Function):
    """``nodes[senders]`` in plan order; the backward's scatter-add is K1
    over the transposed plan."""

    @staticmethod
    def forward(ctx, nodes, plan, plan_t, r2s):
        ctx.plan_t, ctx.r2s = plan_t, r2s
        return nodes[plan.senders_sorted]

    @staticmethod
    def backward(ctx, g):
        return _k1(g[ctx.r2s], ctx.plan_t).to(g.dtype), None, None, None


class _GatherReceivers(torch.autograd.Function):
    """``nodes[receivers]`` in plan order; the backward's scatter-add is K1
    over the plan itself."""

    @staticmethod
    def forward(ctx, nodes, plan):
        ctx.plan = plan
        return nodes[plan.receivers_sorted]

    @staticmethod
    def backward(ctx, g):
        return _k1(g.contiguous(), ctx.plan).to(g.dtype), None


def gather_senders(nodes, plan: SortedPlan, plan_t=None, r2s=None):
    """``nodes[plan.senders_sorted]``.  With a plan of the same edges sorted
    by sender (``plan_t``, with its :func:`cross_permutation` ``r2s``) the
    backward runs K1 instead of autograd's scatter-add, which serialises on
    indices that repeat hundreds of times (a supernode's hits)."""
    if plan_t is None or not _wants_grad(nodes):
        return nodes[plan.senders_sorted]
    return _GatherSenders.apply(nodes, plan, plan_t, r2s)


def gather_receivers(nodes, plan: SortedPlan):
    """``nodes[plan.receivers_sorted]``, with K1 as its backward."""
    if not _wants_grad(nodes):
        return nodes[plan.receivers_sorted]
    return _GatherReceivers.apply(nodes, plan)


def sorted_segment_min_i32(values_sorted, plan: SortedPlan):
    """K5: int32 segment min of plan-order values, INT32_MAX for empty rows.

    Replaces ``_sorted_min_kernel`` (sorted_agg.py:390).  One device launch
    a call, cut by edges as :func:`min_tiling` says.
    """
    if _on_cpu(values_sorted, plan.row_ptr):
        return sorted_segment_min_i32_plain(values_sorted, plan)
    if values_sorted.get_device() != torch.cuda.current_device():
        with torch.cuda.device(values_sorted.device):  # launch with its card current
            return sorted_segment_min_i32(values_sorted, plan)
    if values_sorted.dtype != torch.int32 or values_sorted.ndim != 1:
        raise ValueError(f"values must be 1-D int32, got {values_sorted.dtype}")
    _check_edges(values_sorted, plan, "values")
    e, n = values_sorted.shape[0], plan.num_segments
    out = values_sorted.new_empty((n,))
    cut = min_tiling(e)
    stream = _stream(values_sorted)
    arrivals, mins = _min_scratch(values_sorted.device, stream, n)
    rc = _min_entry()(values_sorted.data_ptr(), plan.receivers_i32.data_ptr(),
                      plan.row_ptr.data_ptr(), out.data_ptr(), arrivals.data_ptr(),
                      mins.data_ptr(), e, n, cut.tile, stream)
    _raise_on(rc, "hgnn_csr_min_i32")
    with COUNT_LOCK:
        LAUNCHES["K5"] += 1
    return out


@functools.cache
def _min_entry():
    return library().hgnn_csr_min_i32
