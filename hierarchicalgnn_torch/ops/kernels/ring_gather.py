"""All-gather of row blocks between the ranks of a shard group: K8.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/ring_gather.py``.  Rank ``r``
holds a block ``x_r`` of shape ``[B, ...]``; after

  K8 :func:`ring_all_gather`   out_q = concat(x_0 ... x_{P-1}) for every q

every rank holds the ``[P * B, ...]`` concatenation, bit for bit
(``csrc/ring_gather.cu``).  The name is the JAX package's; the schedule is
not.  The TPU kernel forwards blocks round a two-way ring through VMEM
because its interconnect is a torus and its remote DMA starts in VMEM.  The
cards of an H100 host are joined all to all, so here every rank reads its
block once and stores it straight into every rank's output: no forwarding,
each byte read once.  Stores, not loads from the peers, because a store over
NVLink does not wait for a round trip.  The bytes go through shared memory
by Hopper's 1-D bulk asynchronous copies: one load of a chunk of up to 32
KB, P bulk stores of it, in a ring of 6 chunk buffers per block of a
persistent grid (one block a SM) that deals out all (rank, chunk) pairs (:func:`gather_schedule` is the cut;
heads, tails and unaligned blocks take a vector loop in the same kernel).

What carries over is the synchronisation contract, kept in flag words that
each rank owns and that only grow (a generation counter and a running
arrival count, never reset): no rank's output is written before that rank
has entered the call, no rank's launch ends before every peer's block is in
its output, and a later call cannot see an earlier call's flags.

The kernel sees its peers only through a table of device pointers and the
range of ranks its launch serves.  This module fills the table with
allocations of ONE card: the P ranks of a group run in one process and share
the card (``parallel/comm.py``), so the transfers ride its HBM and not
NVLink.  All P ranks go into one cooperative launch, so no rank can wait for
a peer whose launch sits behind something else in a queue.  It
runs on the caller's current stream: the blocks must have been produced on
that stream (or the stream made to wait for them), and whoever reads the
outputs is ordered after the launch by the same stream.  ``parallel/comm.py``
runs all ranks on one stream.  The flag words belong to one (device, P,
stream): the stream orders the calls that share them, and a group on another
stream has its own.

The TPU kernel takes only 2-D f32/bf16 blocks that fill its VMEM tiles and
leaves the rest to ``lax.all_gather``.  This one copies bytes: any dtype,
any number of dimensions, any size, any base.  Each rank's output starts on
a 16-byte boundary (one allocation, padded between ranks where P blocks are
no whole number of 16 bytes), so a rank whose input does too goes by bulk
copies from its first 16-byte boundary.

The wrapper takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``LAUNCHES["K8"]`` counts
the launches (one per call, whatever P).  The JAX kernel's backward is
``lax.psum_scatter``, an XLA collective; it comes with the sharded training
step, and until then a block that requires grad raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream, _wants_grad)

SOURCE = "ring_gather.cu"
ENTRY = "hgnn_ring_all_gather"
MAX_RANKS = 16      # kMaxRanks of the source
FLAG_WORDS = 32     # int64 words per rank: [0] arrivals, [16 + q] entered by q
# the cut of the source's launcher: kChunk, kMinChunk, kStages, kAhead, kVecThreads,
# kVecBatch
CHUNK, MIN_CHUNK, STAGES, AHEAD, VEC_THREADS, VEC_BATCH = 32768, 2048, 6, 3, 224, 4


@dataclasses.dataclass(frozen=True)
class GatherSchedule:
    """How K8 cuts one call (the C launcher's cut, written out).  Rank r's
    block is ``head[r]`` bytes for the vector loop, ``bulk[r]`` bytes (whole
    16-byte units) in chunks of ``chunk`` for the bulk copies, and the rest
    (its tail) for the vector loop again; pair k of the ``n_pairs`` (rank,
    chunk) pairs goes to block ``k % grid``, and each block runs its pairs
    through ``stages`` chunk buffers, ``ahead`` loads ahead of the stores.
    The chunk is CHUNK bytes, halved down to MIN_CHUNK while the pairs are
    fewer than the blocks the card holds.
    The vector loop moves ``vector`` bytes at a time."""

    chunk: int
    stages: int
    ahead: int
    grid: int
    vector: int
    head: tuple
    bulk: tuple
    n_pairs: int

    def pairs(self):
        """(rank, chunk index) of every pair, in pair order."""
        return [(r, c) for r, b in enumerate(self.bulk) for c in range(-(-b // self.chunk))]


def gather_schedule(block_bytes, in_addrs, out_addrs, resident) -> GatherSchedule:
    """The cut of a call over P = len(in_addrs) ranks whose blocks start at
    ``in_addrs`` and whose outputs start at ``out_addrs``, on a card that
    holds ``resident`` blocks of the kernel at once."""
    n = len(in_addrs)
    bits = block_bytes
    for addr in (*in_addrs, *out_addrs):
        bits |= addr
    vector = next(v for v in (16, 8, 4, 2, 1) if bits % v == 0)
    head, bulk = [], []
    for r, addr in enumerate(in_addrs):
        mis = addr % 16
        same = all((out + r * block_bytes) % 16 == mis for out in out_addrs)
        h = min((16 - mis) % 16 if same else block_bytes, block_bytes)
        head.append(h)
        bulk.append((block_bytes - h) // 16 * 16)
    chunk = CHUNK
    while True:
        n_pairs = sum(-(-b // chunk) for b in bulk)
        if chunk <= MIN_CHUNK or n_pairs >= resident:
            break
        chunk //= 2
    vec_units = (n * block_bytes - sum(bulk)) // vector
    want = max(n_pairs, -(-vec_units // (VEC_THREADS * VEC_BATCH)), 1)
    return GatherSchedule(chunk=chunk, stages=STAGES, ahead=AHEAD, grid=min(want, resident),
                          vector=vector, head=tuple(head), bulk=tuple(bulk), n_pairs=n_pairs)


class _GroupFlags:
    """The flag words of one group of ``n_ranks`` ranks on one stream of one
    device, and the host's copy of what they hold once every call so far has
    ended.  The stream orders the calls that share them (and the zeroing
    before the first); groups on other streams have words of their own, so
    their arrival counts cannot mix.  ``info`` receives the launcher's cut of
    the last call (blocks, vector bytes, bulk pairs, blocks the card holds,
    chunk bytes)."""

    def __init__(self, device, n_ranks):
        self.words = torch.zeros((n_ranks, FLAG_WORDS), dtype=torch.int64, device=device)
        self.pointers = (ctypes.c_void_p * n_ranks)(
            *(self.words[r].data_ptr() for r in range(n_ranks)))
        self.generation = 0
        self.arrivals = 0
        self.info = (ctypes.c_int * 5)()
        self.lock = threading.Lock()


_FLAGS: dict = {}
_FLAGS_LOCK = threading.Lock()


def _group_flags(device: int, n_ranks, stream) -> _GroupFlags:
    key = (device, n_ranks, stream)
    flags = _FLAGS.get(key)
    if flags is None:
        with _FLAGS_LOCK:
            flags = _FLAGS.get(key)
            if flags is None:
                flags = _FLAGS[key] = _GroupFlags(device, n_ranks)
    return flags


@functools.cache
def _entry():
    return getattr(library(SOURCE), ENTRY)


@functools.cache
def _table(n_ranks):
    """The ctypes type of a table of ``n_ranks`` device pointers."""
    return ctypes.c_void_p * n_ranks


def ring_all_gather_plain(blocks):
    """The plain version: one ``torch.cat`` along dim 0, shared by all ranks
    (a list of P references to it; nobody writes into a gathered array)."""
    out = torch.cat(list(blocks), 0)
    return [out] * len(blocks)


def _check_blocks(blocks):
    first = blocks[0]
    if first.ndim < 1:
        raise ValueError("blocks must have at least one dimension")
    for b in blocks:
        if b.shape != first.shape or b.dtype != first.dtype or b.device != first.device:
            raise ValueError(
                f"blocks differ: {tuple(b.shape)} {b.dtype} {b.device} vs "
                f"{tuple(first.shape)} {first.dtype} {first.device}")
        if not b.is_contiguous():
            raise ValueError("blocks must be contiguous")
    if len(blocks) > MAX_RANKS:
        raise ValueError(f"{len(blocks)} ranks, the kernel's table holds {MAX_RANKS}")


def _outputs(first, n_ranks):
    """P outputs of ``[P * B, ...]`` in one allocation, each starting on a
    16-byte boundary (a gap between them where P blocks are no whole number
    of 16 bytes)."""
    shape = (n_ranks * first.shape[0],) + tuple(first.shape[1:])
    nbytes = n_ranks * first.numel() * first.element_size()
    if nbytes % 16 == 0:
        return list(first.new_empty((n_ranks,) + shape).unbind(0))
    stride = -(-nbytes // 16) * 16 // first.element_size()
    flat = first.new_empty(n_ranks * stride)
    size = n_ranks * first.numel()
    return [flat[q * stride:q * stride + size].view(shape) for q in range(n_ranks)]


def ring_all_gather(blocks):
    """K8: ``blocks[r]`` is rank r's ``[B, ...]`` block; returns a list whose
    entry q is rank q's own ``[P * B, ...]`` concatenation of all blocks.

    Replaces ``_ring_kernel`` (hierarchicalgnn_tpu/ops/pallas/ring_gather.py:32).
    One launch serves all P ranks.  Not differentiable yet.
    """
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no blocks")
    if _wants_grad(*blocks):
        raise NotImplementedError(
            "K8 has no backward yet: the reduce-scatter comes with the sharded "
            "training step (ROADMAP.md, Queue 1 item 5)")
    if _on_cpu(*blocks):
        return ring_all_gather_plain(blocks)
    _check_blocks(blocks)
    first = blocks[0]
    device = first.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):  # launch with its card current
            return ring_all_gather(blocks)
    n_ranks = len(blocks)
    outs = _outputs(first, n_ranks)
    table = _table(n_ranks)
    stream = _stream(first)
    flags = _group_flags(device, n_ranks, stream)
    with flags.lock:
        rc = _entry()(
            table(*[b.data_ptr() for b in blocks]), table(*[o.data_ptr() for o in outs]),
            flags.pointers, n_ranks, first.numel() * first.element_size(),
            flags.generation + 1, flags.arrivals, device, flags.info, stream)
        _raise_on(rc, ENTRY)
        flags.generation += 1
        flags.arrivals += flags.info[0]
    LAUNCHES["K8"] += 1
    return outs
