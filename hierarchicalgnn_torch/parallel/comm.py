"""The shard group: P ranks of one process, and their collectives.

The JAX package writes the graph-partitioned path as per-device code under
``shard_map`` and takes its collectives from ``lax`` (``axis_index``,
``all_gather``, ``psum``, ``psum_scatter``, ``pmax``).  PyTorch has no
``shard_map``.  This module is its counterpart for ranks that share one
process and one card: :func:`run_sharded` runs the per-device function once
per rank, each in a thread of its own, and hands it a :class:`Comm`, whose
collectives are rendezvous points between the threads.

Threads, not lockstep code over lists of tensors: a collective sits deep
inside a cell (the halo gather of every message-passing iteration), so
lockstep code would have to rewrite every cell and block over lists.  With a
thread per rank the cells and the parameter tree stay as they are and the
per-device code reads like the JAX package's.  The price is that the ranks'
host work takes turns and that work the JAX package replicates across
devices is done P times on the one card.

The thread group carries the ``graph`` and ``model`` axes, which the JAX
package keeps inside one process.  The ``data`` axis goes over the processes
of a ``torch.distributed`` group (``parallel/distributed.py``), which meet on
the caller's thread after the backward, never from a rank thread.

The ranks take turns explicitly: a rank runs only while it holds the group's
baton, and hands it on where it waits at a rendezvous.  Python runs one
thread at a time anyway; left to themselves, four threads that each release
the interpreter lock inside every torch call hand it to each other at every
call, and the forward spends its time in those hand-overs (the flagship's
sharded event took 1.1 s that way on an H100, its device busy for 68 ms).
With the baton a rank's kernels between two collectives are queued in one
go; after a rendezvous the baton goes to whichever rank wakes first, so the
order of the ranks' runs on the stream is not fixed (their results do not
depend on it: a rank reads other ranks' data only through a collective).

At a rendezvous every rank leaves its tensor and waits; the rank that
arrives last computes the collective for all of them (for an all-gather under
``halo_backend: rdma`` that is the single K8 launch,
``ops/kernels/ring_gather.py``) and every rank picks up its result.  All
ranks run on one CUDA stream, the caller's current one, so the launch is
ordered after every rank's producer and before every rank's consumer by the
stream alone.

``all_gather`` under ``halo_backend: xla`` (the JAX package's name for the
library collective, kept so that one config reads the same in both packages)
is K8's plain version, a ``torch.cat``.  ``psum``, ``psum_scatter``,
``pmax`` and ``pmin`` are XLA collectives in the JAX package, no Pallas
kernels, and are plain torch here: the partial results are added in rank
order; bf16 and f16 partials are added in f32 and rounded once.
``all_gather_features``, the tensor-parallel MLPs' all-gather of column
blocks (``parallel/tp.py``), is XLA's in the JAX package too, and a
``torch.cat`` on the last dim here whatever ``halo_backend`` says; it is
counted under its own kind.

Every collective is differentiable, so in a training forward the P ranks'
graphs join into ONE autograd graph through the collectives, and one
``torch.autograd.grad`` from the caller's thread runs every rank's backward:
the all-gather's backward is a reduce-scatter of the ranks' cotangents
(``ops/kernels/ring_gather.py``, the same for both backends), the feature
all-gather's gives each rank its column block of the summed cotangents,
``psum``'s gives each rank's input the ranks' cotangents summed in rank order,
and ``psum_scatter``'s is autograd's own.  No rendezvous is needed in the
backward.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils._pytree as pytree

from hierarchicalgnn_torch.ops.kernels.ring_gather import (
    reduce_scatter_plain, ring_all_gather, ring_all_gather_plain, sum_in_rank_order)

HALO_BACKENDS = ("xla", "rdma")
THREAD_PREFIX = "shard-rank-"


class _Psum(torch.autograd.Function):
    """The ranks' values summed in rank order, handed to every rank as a
    view of its own; backward: the ranks' cotangents summed in rank order
    (bf16 in f32, rounded once), the same sum for every rank's input.  One
    fixed order: with a single shared output autograd would add the ranks'
    cotangents in the order its engine meets them, which follows which rank
    completed the rendezvous."""

    @staticmethod
    def forward(ctx, *values):
        ctx.set_materialize_grads(False)  # a rank that never reads its copy adds nothing
        total = sum_in_rank_order(values)
        return tuple(total.view_as(total) for _ in values)

    @staticmethod
    def backward(ctx, *grads):
        given = [g for g in grads if g is not None]
        if not given:
            return (None,) * len(grads)
        return (sum_in_rank_order(given),) * len(grads)


class _FeatureGather(torch.autograd.Function):
    """The ranks' ``[..., D_r]`` column blocks -> one ``[..., sum D_r]``
    ``torch.cat`` on the last dim, handed to every rank as a view of its own;
    backward: the ranks' cotangents summed in rank order (bf16 in f32, rounded
    once) and cut back into the column blocks."""

    @staticmethod
    def forward(ctx, *blocks):
        ctx.set_materialize_grads(False)  # a rank that never reads its copy adds nothing
        ctx.widths = [b.shape[-1] for b in blocks]
        out = torch.cat(blocks, -1)
        return tuple(out.view_as(out) for _ in blocks)

    @staticmethod
    def backward(ctx, *grads):
        given = [g for g in grads if g is not None]
        if not given:
            return (None,) * len(grads)
        return sum_in_rank_order(given).split(ctx.widths, -1)


class _Replicate(torch.autograd.Function):
    """``n`` views of one tensor, one per rank; backward: the ranks'
    cotangents summed in rank order (bf16 in f32, rounded once)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        given = [g for g in grads if g is not None]
        return (sum_in_rank_order(given) if given else None), None


def replicate(x, n_parts: int):
    """``n_parts`` views of ``x``, one for each rank to read: ``x``'s gradient
    is then the ranks' contributions added in rank order, not in the order
    the backward happens to meet them."""
    if torch.is_grad_enabled() and x.requires_grad:
        return list(_Replicate.apply(x, n_parts))
    return [x] * n_parts


class _Handoff(torch.autograd.Function):
    """Views of a rank's outputs; backward: the cotangents as they are."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return grads


def handoff(tree):
    """``tree`` (a pytree: tuples, named tuples, lists, dicts) with every
    tensor that requires grad replaced by a view whose autograd node is made
    on the calling thread, for a rank to hand its outputs to the caller's
    thread.

    Autograd runs ready nodes in the order of their sequence numbers, which
    count per thread.  The rank threads are new at every forward, the
    caller's thread is not: its numbers grow from step to step.  Where the
    loss, computed on the caller's thread, and the rank's own nodes both add
    to one tensor's gradient, the order of those additions would follow how
    many nodes the caller's thread made before.  Behind the handoff every
    path from the loss enters the rank's graph through one node numbered on
    the rank's thread, so the order is the same at every step."""
    leaves, spec = pytree.tree_flatten(tree)
    at = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor) and v.requires_grad]
    if not at or not torch.is_grad_enabled():
        return tree
    for i, view in zip(at, _Handoff.apply(*(leaves[i] for i in at))):
        leaves[i] = view
    return pytree.tree_unflatten(leaves, spec)


class ShardGroup:
    """The meeting point of ``n_parts`` ranks.  ``collectives`` counts the
    completed rendezvous by kind."""

    def __init__(self, n_parts: int, halo_backend: str = "xla"):
        if halo_backend not in HALO_BACKENDS:
            raise ValueError(f"halo_backend must be one of {HALO_BACKENDS}, "
                             f"got {halo_backend!r}")
        self.n_parts = n_parts
        self.halo_backend = halo_backend
        self.collectives = {"all_gather": 0, "all_gather_features": 0, "psum": 0,
                            "psum_scatter": 0, "pmax": 0, "pmin": 0}
        self._left = [None] * n_parts
        self._picked_up = None
        self._barrier = threading.Barrier(n_parts, action=self._complete)
        self.baton = threading.Lock()  # held by the one rank that is running
        self._returned = 0             # ranks whose function has returned

    # -- the collectives, each over the list of the ranks' tensors ----------

    def _all_gather(self, values):
        if self.halo_backend == "rdma":
            return ring_all_gather(values)  # the kernel, unless the tensors are on the CPU
        return ring_all_gather_plain(values)

    def _all_gather_features(self, values):
        if torch.is_grad_enabled() and any(v.requires_grad for v in values):
            return list(_FeatureGather.apply(*values))
        return [torch.cat(values, -1)] * self.n_parts

    def _psum(self, values):
        if torch.is_grad_enabled() and any(v.requires_grad for v in values):
            return list(_Psum.apply(*values))
        return [sum_in_rank_order(values)] * self.n_parts

    def _psum_scatter(self, values):
        return reduce_scatter_plain(values)

    def _pmax(self, values):
        top = values[0]
        for v in values[1:]:
            top = torch.maximum(top, v)
        return [top] * self.n_parts

    def _pmin(self, values):
        low = values[0]
        for v in values[1:]:
            low = torch.minimum(low, v)
        return [low] * self.n_parts

    def _complete(self):
        """Runs in the rank that arrives last, while the others wait."""
        kinds = {kind for kind, _ in self._left}
        if len(kinds) != 1:
            raise RuntimeError(f"the ranks met in different collectives: {sorted(kinds)}")
        kind = kinds.pop()
        self._picked_up = getattr(self, "_" + kind)([value for _, value in self._left])
        self.collectives[kind] += 1

    def meet(self, rank: int, kind: str, value):
        """Called by a rank that holds the baton: leave ``value``, let the
        other ranks run up to the same point, pick up this rank's result."""
        if self._returned:
            raise RuntimeError(f"rank {rank} waits in {kind} for a rank that has "
                               f"returned: the ranks must meet in the same collectives")
        self._left[rank] = (kind, value)
        self.baton.release()
        try:
            self._barrier.wait()
        finally:
            self.baton.acquire()
        # the next rendezvous cannot complete before this rank joins it, so
        # the results are still this one's
        return self._picked_up[rank]

    def returned(self):
        """Called by a rank that holds the baton when its function is done: a
        rank still waiting at a rendezvous could wait for ever."""
        self._returned += 1
        if self._barrier.n_waiting:
            self._barrier.abort()

    def abort(self):
        self._barrier.abort()


class Comm:
    """One rank's handle on its group: what ``lax`` gives a ``shard_map``
    body.  ``index`` is a Python int (``lax.axis_index`` is traced; slices by
    it are static here)."""

    def __init__(self, group: ShardGroup, index: int):
        self.group = group
        self.index = index
        self.n_parts = group.n_parts

    def all_gather(self, x):
        """``[B, ...]`` per rank -> ``[P * B, ...]`` on every rank
        (``lax.all_gather(..., axis=0, tiled=True)``)."""
        return self.group.meet(self.index, "all_gather", x.contiguous())

    def all_gather_features(self, x):
        """``[..., D / P]`` per rank -> ``[..., D]`` on every rank: the ranks'
        column blocks side by side in rank order (``lax.all_gather(...,
        axis=-1, tiled=True)``)."""
        return self.group.meet(self.index, "all_gather_features", x.contiguous())

    def psum(self, x):
        return self.group.meet(self.index, "psum", x)

    def psum_scatter(self, x):
        """Sum over ranks, then this rank's row block of the sum
        (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
        if x.shape[0] % self.n_parts:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.n_parts} ranks")
        return self.group.meet(self.index, "psum_scatter", x)

    def pmax(self, x):
        return self.group.meet(self.index, "pmax", x)

    def pmin(self, x):
        return self.group.meet(self.index, "pmin", x)


def run_sharded(fn, n_parts: int, halo_backend: str = "xla", device=None):
    """Run ``fn(comm)`` once per rank and return ``(results, group)``:
    the list of the ranks' return values and the group with its counts.

    The ranks are threads named ``shard-rank-<r>``.  They inherit the
    caller's grad mode and, with a CUDA ``device``, its current stream.  If a
    rank raises, or returns while others wait for it, the others are released
    from their rendezvous and the first error is raised here.
    """
    group = ShardGroup(n_parts, halo_backend)
    results, errors = [None] * n_parts, [None] * n_parts
    grad = torch.is_grad_enabled()
    device = torch.device(device) if device is not None else None
    stream = torch.cuda.current_stream(device) if device is not None and \
        device.type == "cuda" else None

    def work(rank):
        try:
            on_stream = torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext()
            with group.baton, torch.set_grad_enabled(grad), on_stream:
                results[rank] = fn(Comm(group, rank))
                group.returned()
        except BaseException as exc:  # noqa: BLE001 - handed to the caller below
            errors[rank] = exc
            group.abort()

    if n_parts == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(r,), name=f"{THREAD_PREFIX}{r}")
                   for r in range(n_parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        own = [e for e in raised if not isinstance(e, threading.BrokenBarrierError)]
        if not own:
            raise RuntimeError("a rank returned while others waited at a rendezvous: the "
                               "ranks must meet in the same collectives") from raised[0]
        raise own[0]
    return results, group
