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
range of ranks its launch serves.  The wrapper groups the ranks by the card
their block lies on (and, where ``streams`` names them, by stream): the
ranks of one card must be contiguous, and each group gets ONE cooperative
launch on its card's stream (:func:`launch_groups`).  A call is one call
into the library whatever the number of launches: the library's layout
(made once per layout, with the flag words) issues every launch in rank
order from one loop and records its end on an event of its own, and the
cut of the call (:func:`gather_schedule` for each launch, the grids capped
at what each card holds over the launches that share it) is planned once
per layout, block size and placement of the pointers against 16 bytes
(``_GroupFlags.plan``), the arrival target with it.  Each rank's output and
flag words are allocated on its own card; a launch stores into the outputs and
flags of the other cards through peer-mapped pointers, over NVLink (peer
access is enabled once per ordered pair of cards, :func:`enable_peers`).
When all ranks share one card and one stream (``parallel/comm.py`` without
``devices``: the transfers ride the card's HBM) that is one launch for all
P.  Several launches on one card (separate streams) each take a share of
what the card holds, so that all fit at once.  A launch runs on its card's
current stream (or the one ``streams`` names): the blocks must have been
produced on that stream (or the stream made to wait for them), and whoever
reads a rank's output is ordered after its card's launch by the same stream.
The flag words belong to one layout of launches (cards, streams and rank
ranges): each stream orders the calls that share them, and another layout
has its own.

Every wait on a flag is bounded (``TIMEOUT_S``, or the call's
``timeout_s``): a launch whose peer never comes writes an error word and
ends instead of hanging the card.  A call of several launches stays
pending until the library's event after each of its launches has passed:
until then it holds its inputs, outputs and flag words, since a late launch may still
write into the outputs of a peer that gave up.  :func:`settle` waits for
the pending calls and raises for one that timed out (the sharded forward
calls it before reading its results back); a call on a layout whose error
word is set raises too.  Either way the layout's flag words are retired,
so the call after starts on fresh ones.

The TPU kernel takes only 2-D f32/bf16 blocks that fill its VMEM tiles and
leaves the rest to ``lax.all_gather``.  This one copies bytes: any dtype,
any number of dimensions, any size, any base.  Each rank's output starts on
a 16-byte boundary (one allocation, padded between ranks where P blocks are
no whole number of 16 bytes), so a rank whose input does too goes by bulk
copies from its first 16-byte boundary.

The wrapper takes its plain PyTorch version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  ``LAUNCHES["K8"]`` counts
the launches (one per call on one card; one per card, or per stream, where
the call spans several), ``LAUNCHES["K8_split"]`` those of calls that took
more than one.

Both gathers are differentiable through one ``autograd.Function``
(``_AllGather``): its forward is K8 or ``torch.cat``, its backward the same
for both, a reduce-scatter of the P ranks' cotangents
(:func:`reduce_scatter_plain`: summed in rank order, bf16 and f16 added in
f32 and rounded once, each rank given its own row block).  The JAX kernel's
backward is ``lax.psum_scatter`` (``_ring_bwd``), an XLA collective and no
Pallas kernel, so the plain reduce-scatter is the whole of its port.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading
import weakref
from typing import NamedTuple

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    COUNT_LOCK, LAUNCHES, _on_cpu, _raise_on, _stream, _wants_grad)

SOURCE = "ring_gather.cu"
ENTRY = "hgnn_ring_all_gather"
LAYOUT_ENTRY = "hgnn_k8_layout"
TIMEOUT_S = 10.0    # the bound of every wait on a flag, by default
MAX_RANKS = 16      # kMaxRanks of the source
FLAG_WORDS = 32     # int64 words per rank: [0] arrivals, [16 + q] entered by q
SPIN_AT, LAUNCH_AT = 1, 2  # words of a launch's first rank: ns spun at the entry, ns run
NOT_READY = 600     # cudaErrorNotReady
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
    The chunk is the largest one given (CHUNK; MIN_CHUNK where the call's
    launches span several cards), halved down to MIN_CHUNK while the pairs
    are fewer than the blocks the launch may hold.
    The vector loop moves ``vector`` bytes at a time.  ``head`` and ``bulk``
    cover every rank; the launch serves ranks ``rank0`` to ``rank0 + n_local
    - 1``, and only their pairs are in ``n_pairs``."""

    chunk: int
    stages: int
    ahead: int
    grid: int
    vector: int
    head: tuple
    bulk: tuple
    n_pairs: int
    rank0: int = 0
    n_local: int = 0

    def served(self):
        return range(self.rank0, self.rank0 + self.n_local)

    def pairs(self):
        """(rank, chunk index) of every pair, in pair order."""
        return [(r, c) for r in self.served() for c in range(-(-self.bulk[r] // self.chunk))]


def gather_schedule(block_bytes, in_addrs, out_addrs, resident, rank0=0,
                    n_local=None, chunk=CHUNK) -> GatherSchedule:
    """The cut of the launch that serves ranks ``rank0`` to ``rank0 + n_local
    - 1`` (by default all) of a call over P = len(in_addrs) ranks whose
    blocks start at ``in_addrs`` and whose outputs start at ``out_addrs``;
    the launch may hold ``resident`` blocks at once (what the card holds,
    over the launches that share it); its chunks are ``chunk`` bytes at
    most."""
    n = len(in_addrs)
    n_local = n - rank0 if n_local is None else n_local
    served = range(rank0, rank0 + n_local)
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
    while True:
        n_pairs = sum(-(-bulk[r] // chunk) for r in served)
        if chunk <= MIN_CHUNK or n_pairs >= resident:
            break
        chunk //= 2
    vec_units = sum(block_bytes - bulk[r] for r in served) // vector
    want = max(n_pairs, -(-vec_units // (VEC_THREADS * VEC_BATCH)), 1)
    return GatherSchedule(chunk=chunk, stages=STAGES, ahead=AHEAD, grid=min(want, resident),
                          vector=vector, head=tuple(head), bulk=tuple(bulk), n_pairs=n_pairs,
                          rank0=rank0, n_local=n_local)


class Launch(NamedTuple):
    """One launch of a call: ``key`` (card, stream) and the ranks it serves."""

    key: tuple
    rank0: int
    n_local: int


def launch_groups(keys) -> tuple:
    """The launches of a call whose rank r runs at ``keys[r]`` (a card, or a
    (card, stream) pair): one per run of equal keys, in rank order.  Raises
    where the ranks of one key are not contiguous (the JAX mesh's reshape
    gives every card a contiguous range)."""
    launches, seen = [], set()
    for r, key in enumerate(keys):
        if launches and launches[-1].key == key:
            last = launches[-1]
            launches[-1] = last._replace(n_local=last.n_local + 1)
            continue
        if key in seen:
            raise ValueError(f"the ranks of {key} are not contiguous: {list(keys)}")
        seen.add(key)
        launches.append(Launch(key, r, 1))
    return tuple(launches)


class _Plan(NamedTuple):
    """The cut of a call on one layout: ``cuts[i]`` launch i's
    :class:`GatherSchedule` (capped at ``resident[i]`` blocks), ``table`` the
    library's form of it (int64: the vector bytes, each launch's grid and
    chunk, each rank's head and bulk), ``blocks`` the arrivals it adds."""

    cuts: tuple
    resident: tuple
    table: object
    blocks: int


def _plan(block_bytes, ins, outs, launches, resident) -> _Plan:
    # over NVLink the copy ran faster the smaller its chunks, over HBM not (P 4,
    # [6144, 256] bf16, a launch, scripts/k8_chunks.py: over four H100s 53 us
    # at 16 KB, 39 at 4 KB, 37 at 2 KB; on one, 28 at 32 KB, 31 at 4 KB)
    chunk = MIN_CHUNK if len({launch.key[0] for launch in launches}) > 1 else CHUNK
    cuts = tuple(gather_schedule(block_bytes, ins, outs, cap, launch.rank0, launch.n_local,
                                 chunk) for launch, cap in zip(launches, resident))
    first = cuts[0]
    words = [first.vector, *(x for cut in cuts for x in (cut.grid, cut.chunk)),
             *(x for r in range(len(ins)) for x in (first.head[r], first.bulk[r]))]
    return _Plan(cuts, tuple(resident), (ctypes.c_longlong * len(words))(*words),
                 sum(cut.grid for cut in cuts))


def _device_words(launches):
    """Each rank's flag words on its launch's card (zeroed, the cards
    synchronised before the first call), peer access between the launches'
    cards, and the error word (host memory the cards write).  Returns (the
    ranks' words, the error word)."""
    rows = []
    for launch in launches:
        words = torch.zeros((launch.n_local, FLAG_WORDS), dtype=torch.int64,
                            device=torch.device("cuda", launch.key[0]))
        rows += list(words.unbind(0))
    cards = [launch.key[0] for launch in launches]
    for device in set(cards):
        torch.cuda.synchronize(device)
    if len(set(cards)) > 1:
        enable_peers(cards)
    return rows, torch.zeros(1, dtype=torch.int64).pin_memory()


class _GroupFlags:
    """One layout of ``launches``: the flag words of its ranks
    (:func:`_device_words`), the host's copy of what they hold once every
    call so far has ended, the error word that a wait past its bound sets,
    the library's layout (``handle``: each launch's card, stream and ranks,
    its events) and the cuts planned for it.  Each launch's stream orders
    the calls that share them; layouts on other streams have words of their
    own, so their arrival counts cannot mix.  ``last`` is the plan of the
    last call."""

    def __init__(self, launches):
        self.launches = launches
        self.words, self.error = _device_words(launches)
        self.error_word = self.error.numpy()  # read without a device call
        n, ints = len(launches), ctypes.c_int * len(launches)
        held, handle = ints(), (ctypes.c_void_p * 1)()
        lib = _library()
        _raise_on(lib.hgnn_k8_layout(
            n, ints(*(launch.key[0] for launch in launches)),
            (ctypes.c_void_p * n)(*(launch.key[1] for launch in launches)),
            ints(*(launch.rank0 for launch in launches)),
            ints(*(launch.n_local for launch in launches)), len(self.words),
            _table(len(self.words))(*(w.data_ptr() for w in self.words)),
            self.error.data_ptr(), held, handle), LAYOUT_ENTRY)
        self.handle = handle[0]
        weakref.finalize(self, lib.hgnn_k8_layout_free, self.handle).atexit = False
        cards = [launch.key[0] for launch in launches]
        self.devices = [torch.device("cuda", card) for card in cards]
        # the call's pointer tables and issued count, filled under the lock
        self.ins, self.outs = _table(len(self.words))(), _table(len(self.words))()
        self.issued = (ctypes.c_int * 1)()
        # what each launch may hold: its card's blocks over the launches sharing it
        self.resident = [h // cards.count(card) for h, card in zip(held, cards)]
        self.plans = {}
        self.last = None
        self.generation = 0
        self.arrivals = 0
        self.lock = threading.Lock()
        self.retired = False  # its error raised once

    def plan(self, block_bytes, ins, outs) -> _Plan:
        """The cut of a call whose blocks start at ``ins`` and outputs at
        ``outs``: planned at the first call of its key (it depends on the
        addresses only through their places against 16 bytes)."""
        key = (block_bytes, *[a & 15 for a in ins], *[a & 15 for a in outs])
        found = self.plans.get(key)
        if found is None:
            found = self.plans[key] = _plan(block_bytes, ins, outs, self.launches,
                                            self.resident)
        return found


class _Call(NamedTuple):
    """A call of several launches still in flight: its flags, its
    generation, the launches issued, and its inputs and outputs, kept
    referenced until every launch has ended (a launch writes into other
    cards' or streams' outputs, which their allocators do not know of; a late
    one may still write after its peer gave up)."""

    flags: _GroupFlags
    generation: int
    issued: int
    tensors: list


_FLAGS: dict = {}
_PENDING: list = []  # _Calls in issue order
_FLAGS_LOCK = threading.Lock()
_PEERS: set = set()


def _group_flags(launches) -> _GroupFlags:
    flags = _FLAGS.get(launches)
    if flags is None:
        with _FLAGS_LOCK:
            flags = _FLAGS.get(launches)
            if flags is None:
                flags = _FLAGS[launches] = _GroupFlags(launches)
    return flags


def _retire(flags):
    """Take ``flags`` out of use after a wait past its bound or a failed
    launch: the next call on its layout gets fresh ones (a pending call
    that ran on them keeps them alive until its launches have ended), and
    their error is raised once.  Returns the error to raise."""
    with _FLAGS_LOCK:
        if _FLAGS.get(flags.launches) is flags:
            del _FLAGS[flags.launches]
    flags.retired = True
    return RuntimeError(
        f"K8 over {[(l.key, l.rank0, l.n_local) for l in flags.launches]}: a wait on a flag "
        f"outlasted its bound (error {int(flags.error_word[0])}: 1 a peer never entered, "
        f"2 a peer's bytes never arrived); its flags are retired, the next call starts on "
        f"fresh ones")


def _reap(wait: bool):
    """Drop the pending calls whose launches have ended, oldest first (with
    ``wait``, every pending call, after waiting for it); raises for a layout
    whose error word one of them set, after retiring its flags."""
    with _FLAGS_LOCK:
        calls = list(_PENDING)
    done = 0
    for call in calls:
        rc = _library().hgnn_k8_ended(call.flags.handle, call.generation, call.issued,
                                      int(wait))
        if rc == NOT_READY:
            break
        _raise_on(rc, "hgnn_k8_ended")
        done += 1
    with _FLAGS_LOCK:
        del _PENDING[:done]
    failed = {id(call.flags): call.flags for call in calls[:done]
              if call.flags.error_word[0] and not call.flags.retired}
    errors = [_retire(flags) for flags in failed.values()]
    if errors:
        raise errors[0]


def settle():
    """Wait for every K8 call of several launches still in flight, release
    what it held, and raise where a wait of one of them outlasted its bound.
    A sharded forward calls it before it reads its results back: a call
    whose peer never came then fails the forward that made it."""
    if _PENDING:
        _reap(wait=True)


def enable_peers(devices):
    """Let every card of ``devices`` reach every other's memory (once per
    ordered pair); raises for a pair that cannot."""
    devices = sorted(set(devices))
    for a in devices:
        for b in devices:
            if a == b or (a, b) in _PEERS:
                continue
            with torch.cuda.device(a):
                rc = _library().hgnn_enable_peer_access(a, b)
            if rc:
                raise RuntimeError(f"card {a} cannot reach card {b}'s memory: cudaError {rc}")
            _PEERS.add((a, b))


@functools.cache
def _library():
    return library(SOURCE)


def _entry():
    return getattr(_library(), ENTRY)


@functools.cache
def _table(n_ranks):
    """The ctypes type of a table of ``n_ranks`` device pointers."""
    return ctypes.c_void_p * n_ranks


def on_each(value, devices):
    """``value`` for each of ``devices``: itself where it lies there, else one
    copy per card, shared by the ranks of that card."""
    copies = {value.device: value}
    for d in devices:
        if d not in copies:
            copies[d] = value.to(d)
    return [copies[d] for d in devices]


@contextlib.contextmanager
def current_streams(streams):
    """Make each of ``streams`` (CUDA streams, one per card; None: nothing to
    do) current on its card: a copy between two cards is ordered by the two
    cards' current streams, so every copy of a rank's data must run while
    the ranks' streams are current."""
    with contextlib.ExitStack() as stack:
        for stream in streams or ():
            stack.enter_context(torch.cuda.stream(stream))
        yield


def ring_all_gather_plain(blocks):
    """The plain version: one ``torch.cat`` along dim 0, shared by the ranks
    of a card (a list of P references, one concatenation per card; nobody
    writes into a gathered array).  Differentiable, with K8's backward
    (``_AllGather``)."""
    blocks = list(blocks)
    if _wants_grad(*blocks):
        return _with_grad(ring_all_gather_plain, blocks)
    devices = [b.device for b in blocks]
    outs = {}
    for d in devices:
        if d not in outs:
            outs[d] = torch.cat([b.to(d) for b in blocks], 0)
    return [outs[d] for d in devices]


def sum_in_rank_order(values):
    """``values[0] + values[1] + ...`` in that order, on the first value's
    device; bf16 and f16 are added in f32 and rounded once."""
    first = values[0]
    wide = first.dtype in (torch.bfloat16, torch.float16)
    total = first.float() if wide else first
    for v in values[1:]:
        v = v.to(first.device)
        total = total + (v.float() if wide else v)
    return total.to(first.dtype)


def reduce_scatter_plain(values, n_ranks=None, devices=None):
    """The sum of ``values`` (:func:`sum_in_rank_order`), cut into
    ``n_ranks`` (by default one per value) row blocks: entry r is rank r's
    (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``), on
    ``devices[r]`` (by default where the values lie).  Across cards each
    rank's block is summed on its own card from the values' rows of that
    block alone, in the same order, so it is the same sum."""
    n_ranks = n_ranks or len(values)
    rows = values[0].shape[0] // n_ranks
    if devices is None or all(d == values[0].device for d in devices):
        total = sum_in_rank_order(values)
        return [total[r * rows:(r + 1) * rows] for r in range(n_ranks)]
    return [sum_in_rank_order([v[r * rows:(r + 1) * rows].to(devices[r]) for v in values])
            for r in range(n_ranks)]


class _AllGather(torch.autograd.Function):
    """The all-gather of P blocks under autograd: ``gather(blocks)`` forward
    (K8 or ``torch.cat``), :func:`reduce_scatter_plain` of the P outputs'
    cotangents backward, each rank's block on its own card.  The P outputs
    are views: nothing may write them in place."""

    @staticmethod
    def forward(ctx, gather, *blocks):
        ctx.set_materialize_grads(False)  # a rank that never reads its copy adds nothing
        ctx.devices = [b.device for b in blocks]
        ctx.streams = _streams_of(ctx.devices)
        return tuple(out.view_as(out) for out in gather(blocks))

    @staticmethod
    def backward(ctx, *grads):
        given = [g for g in grads if g is not None]
        if not given:
            return (None,) * (1 + len(grads))
        with current_streams(ctx.streams):
            return (None, *reduce_scatter_plain(given, len(grads), ctx.devices))


def _streams_of(devices):
    """The current stream of each card among ``devices`` when they span
    several (None otherwise: nothing crosses a card)."""
    cards = {d for d in devices if d.type == "cuda"}
    if len(cards) < 2:
        return None
    return [torch.cuda.current_stream(d) for d in sorted(cards, key=lambda d: d.index)]


def _with_grad(gather, blocks):
    """``gather(blocks)`` (K8 or its plain version) under autograd."""
    return list(_AllGather.apply(gather, *blocks))


def _check_blocks(blocks):
    first = blocks[0]
    if first.ndim < 1:
        raise ValueError("blocks must have at least one dimension")
    for b in blocks:
        if b.shape != first.shape or b.dtype != first.dtype:
            raise ValueError(
                f"blocks differ: {tuple(b.shape)} {b.dtype} vs "
                f"{tuple(first.shape)} {first.dtype}")
        if not b.is_contiguous():
            raise ValueError("blocks must be contiguous")
    if len(blocks) > MAX_RANKS:
        raise ValueError(f"{len(blocks)} ranks, the kernel's table holds {MAX_RANKS}")


def _on_stream(stream, fn, *args):
    """``fn(*args)`` with ``stream`` current on its card and the caller's
    card and streams as they were after (the raw setters: a
    ``torch.cuda.stream`` context costs more than the allocation it
    orders)."""
    device = torch._C._cuda_getDevice()
    before = torch._C._cuda_getCurrentStream(stream.device_index)
    torch._C._cuda_setStream(stream_id=stream.stream_id, device_index=stream.device_index,
                             device_type=stream.device_type)
    out = fn(*args)
    torch._C._cuda_setStream(stream_id=before[0], device_index=before[1],
                             device_type=before[2])
    if torch._C._cuda_getDevice() != device:
        torch._C._cuda_setDevice(device)
    return out


def _outputs(first, n_ranks, count=None, device=None):
    """``count`` (by default P) outputs of ``[P * B, ...]`` on ``device`` (by
    default ``first``'s) in one allocation, each starting on a 16-byte
    boundary (a gap between them where P blocks are no whole number of 16
    bytes)."""
    count = n_ranks if count is None else count
    device = first.device if device is None else device
    shape = (n_ranks * first.shape[0],) + tuple(first.shape[1:])
    nbytes = n_ranks * first.numel() * first.element_size()
    if nbytes % 16 == 0:
        if count == 1:  # one rank on the card: no views to cut
            return [torch.empty(shape, dtype=first.dtype, device=device)]
        return list(torch.empty((count,) + shape, dtype=first.dtype, device=device).unbind(0))
    stride = -(-nbytes // 16) * 16 // first.element_size()
    flat = first.new_empty(count * stride, device=device)
    size = n_ranks * first.numel()
    return [flat[q * stride:q * stride + size].view(shape) for q in range(count)]


def _layout(blocks, streams=None):
    """The launches of a call on ``blocks`` (CUDA tensors)."""
    if streams is None:
        device = blocks[0].get_device()
        if all(b.get_device() == device for b in blocks):
            return _one_launch(device, _stream(blocks[0]), len(blocks))
        return _grouped(tuple((b.get_device(), _stream(b)) for b in blocks))
    return _grouped(tuple((b.get_device(), s.cuda_stream) for b, s in zip(blocks, streams)))


@functools.cache
def _one_launch(device, stream, n_ranks):
    """The layout of a call whose ranks all lie on one card's stream."""
    return (Launch((device, stream), 0, n_ranks),)


@functools.cache
def _grouped(keys):
    return launch_groups(keys)


def launch_info(blocks, streams=None):
    """The cut of the last call on ``blocks``' layout (as
    :func:`ring_all_gather` takes them), one tuple per launch: (blocks,
    vector bytes, bulk pairs, blocks the launch may hold, chunk bytes)."""
    plan = _group_flags(_layout(blocks, streams)).last
    return [(cut.grid, cut.vector, cut.n_pairs, resident, cut.chunk)
            for cut, resident in zip(plan.cuts, plan.resident)]


def launch_stats(blocks, streams=None):
    """What block 0 of each launch of ``blocks``' layout measured, summed
    over the calls so far: (ns spun at the entry, ns from its start to its
    end), one tuple per launch.  Call it with the layout's cards
    synchronised."""
    flags = _group_flags(_layout(blocks, streams))
    return [tuple(flags.words[launch.rank0][SPIN_AT:LAUNCH_AT + 1].tolist())
            for launch in flags.launches]


def ring_all_gather(blocks, streams=None, timeout_s=None):
    """K8: ``blocks[r]`` is rank r's ``[B, ...]`` block, on rank r's card;
    returns a list whose entry q is rank q's own ``[P * B, ...]``
    concatenation of all blocks, on rank q's card.

    Replaces ``_ring_kernel`` (hierarchicalgnn_tpu/ops/pallas/ring_gather.py:32).
    One launch per card (:func:`launch_groups`), on the card's current
    stream; ``streams[r]`` (CUDA streams) names rank r's instead, and ranks
    of one card on different streams then get launches of their own.
    ``timeout_s`` bounds every wait on a flag (default ``TIMEOUT_S``).
    Differentiable: the backward is a plain reduce-scatter (``_AllGather``).
    """
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no blocks")
    if _wants_grad(*blocks):
        return _with_grad(functools.partial(ring_all_gather, streams=streams,
                                            timeout_s=timeout_s), blocks)
    if _on_cpu(*blocks):
        return ring_all_gather_plain(blocks)
    _check_blocks(blocks)
    first, n_ranks = blocks[0], len(blocks)
    flags = _group_flags(_layout(blocks, streams))
    launches = flags.launches
    if len(launches) == 1 and launches[0].key[0] == torch.cuda.current_device():
        outs = _outputs(first, n_ranks)
    elif streams is None:  # each card's outputs, on its current stream
        outs = []
        for launch, device in zip(launches, flags.devices):
            outs += _outputs(first, n_ranks, launch.n_local, device)
    else:  # ... on the stream of its launch
        outs = []
        for launch, device in zip(launches, flags.devices):
            outs += _on_stream(streams[launch.rank0], _outputs, first, n_ranks, launch.n_local,
                               device)
    ins, outs_at = [b.data_ptr() for b in blocks], [o.data_ptr() for o in outs]
    nbytes = first.numel() * first.element_size()
    plan = flags.plan(nbytes, ins, outs_at)
    timeout_ns = int(1e9 * (TIMEOUT_S if timeout_s is None else timeout_s))
    if _PENDING:
        _reap(wait=False)
    with flags.lock:
        if flags.error_word[0]:
            raise _retire(flags)
        # one call into the library: every launch, with the plan and the arrival target
        flags.ins[:], flags.outs[:] = ins, outs_at
        rc = _entry()(flags.handle, plan.table, flags.ins, flags.outs, nbytes,
                      flags.generation + 1, flags.arrivals + plan.blocks, timeout_ns,
                      flags.issued)
        issued = flags.issued[0]
        with COUNT_LOCK:
            for _ in range(issued):  # one for each launch the library issued
                LAUNCHES["K8"] += 1
                if len(launches) > 1:
                    LAUNCHES["K8_split"] += 1
        if len(launches) > 1 and issued:  # pending until its launches have ended
            with _FLAGS_LOCK:
                _PENDING.append(_Call(flags, flags.generation + 1, issued, blocks + outs))
        if rc and issued:  # those issued wait for the others until their bound
            _retire(flags)  # the launch's failure is raised instead
        _raise_on(rc, ENTRY)
        flags.generation += 1
        flags.arrivals += plan.blocks
        flags.last = plan
    return outs
