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
no staging copy, each byte moved once.  Stores, not loads from the peers,
because a store over NVLink does not wait for a round trip.

What carries over is the synchronisation contract, kept in flag words that
each rank owns and that only grow (a generation counter and a running
arrival count, never reset): no rank's output is written before that rank
has entered the call, no rank's launch ends before every peer's block is in
its output, and a later call cannot see an earlier call's flags.

The kernel sees its peers only through a table of device pointers and a
rank id.  This module fills the table with allocations of ONE card: the P
ranks of a group run in one process and share the card
(``parallel/comm.py``), so the transfers ride its HBM and not NVLink.  All P
ranks go into one cooperative launch (``blockIdx.y`` is the rank), so no rank
can wait for a peer whose launch sits behind something else in a queue.  It
runs on the caller's current stream: the blocks must have been produced on
that stream (or the stream made to wait for them), and whoever reads the
outputs is ordered after the launch by the same stream.  ``parallel/comm.py``
runs all ranks on one stream.  The flag words belong to one (device, P,
stream): the stream orders the calls that share them, and a group on another
stream has its own.

The TPU kernel takes only 2-D f32/bf16 blocks that fill its VMEM tiles and
leaves the rest to ``lax.all_gather``.  This one copies bytes: any dtype,
any number of dimensions, any size; 16-byte loads where the block's bytes
and every base are multiples of 16, the widest of 8/4/2/1 otherwise.

The wrapper takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``LAUNCHES["K8"]`` counts
the launches (one per call, whatever P).  The JAX kernel's backward is
``lax.psum_scatter``, an XLA collective; it comes with the sharded training
step, and until then a block that requires grad raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream, _wants_grad)

SOURCE = "ring_gather.cu"
ENTRY = "hgnn_ring_all_gather"
MAX_RANKS = 16      # kMaxRanks of the source
FLAG_WORDS = 32     # int64 words per rank: [0] arrivals, [16 + q] entered by q


class _GroupFlags:
    """The flag words of one group of ``n_ranks`` ranks on one stream of one
    device, and the host's copy of what they hold once every call so far has
    ended.  The stream orders the calls that share them (and the zeroing
    before the first); groups on other streams have words of their own, so
    their arrival counts cannot mix."""

    def __init__(self, device, n_ranks):
        self.words = torch.zeros((n_ranks, FLAG_WORDS), dtype=torch.int64, device=device)
        self.pointers = (ctypes.c_void_p * n_ranks)(
            *(self.words[r].data_ptr() for r in range(n_ranks)))
        self.generation = 0
        self.arrivals = 0
        self.lock = threading.Lock()


_FLAGS: dict = {}
_FLAGS_LOCK = threading.Lock()


def _group_flags(device, n_ranks, stream) -> _GroupFlags:
    key = (device.index if device.index is not None else torch.cuda.current_device(),
           n_ranks, stream)
    with _FLAGS_LOCK:
        if key not in _FLAGS:
            _FLAGS[key] = _GroupFlags(device, n_ranks)
        return _FLAGS[key]


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
    n_ranks = len(blocks)
    # one allocation, a slice per rank (with ranks on several cards each
    # would allocate its own)
    outs = list(torch.empty((n_ranks, n_ranks * first.shape[0]) + tuple(first.shape[1:]),
                            dtype=first.dtype, device=first.device).unbind(0))
    pointers = ctypes.c_void_p * n_ranks
    info = (ctypes.c_int * 2)()
    stream = _stream(first)
    flags = _group_flags(first.device, n_ranks, stream)
    with flags.lock, torch.cuda.device(first.device):
        rc = getattr(library(SOURCE), ENTRY)(
            pointers(*(b.data_ptr() for b in blocks)),
            pointers(*(o.data_ptr() for o in outs)),
            flags.pointers,
            n_ranks, first.numel() * first.element_size(),
            flags.generation + 1, flags.arrivals, info, stream)
        _raise_on(rc, ENTRY)
        flags.generation += 1
        flags.arrivals += (n_ranks - 1) * info[0]
    LAUNCHES["K8"] += 1
    return outs
