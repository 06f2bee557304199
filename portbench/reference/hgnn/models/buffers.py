"""Buffer writes of a training forward: in place, or staged.

A training forward moves some of its modules' buffers: the pooling's
``score_cut`` EMA, each dynamic graph's ``knn_radius`` EMA and the batch-norm
running statistics.  The unsharded step writes them in place.  The ranks of a
shard group (``parallel/comm.py``) are threads that share ONE module, so in
place each EMA would be applied once per rank, and a rank that runs after
another would read a value that has already moved (and which rank runs first
changes from run to run).  In the JAX package every device reads the old
value and one updated copy comes out of the ``shard_map``.

Under :func:`staged_writes` the writes of the calling thread are recorded
instead of applied, and reads see the thread's own staged value.  The caller
collects each rank's (or each event's) staged values, checks that the ranks
agree (:func:`agreed`: they are computed from group-reduced statistics) and
applies them once (:func:`apply_mean`; over several events, their mean).

A rank on another card than the module's reads its card's copy of each
buffer (:func:`placed_buffers`); its staged values lie on its card and are
brought to the buffer's card before they are compared and applied.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCAL = threading.local()


@contextlib.contextmanager
def staged_writes():
    """Record the calling thread's buffer writes in the yielded dict
    (``id(buffer) -> (buffer, new value)``) instead of applying them."""
    previous = getattr(_LOCAL, "staged", None)
    _LOCAL.staged = staged = {}
    try:
        yield staged
    finally:
        _LOCAL.staged = previous


@contextlib.contextmanager
def placed_buffers(copies: dict):
    """Within the block, the calling thread reads each buffer of ``copies``
    (``id(buffer) -> tensor``) as that copy: a rank on another card reads
    its card's."""
    previous = getattr(_LOCAL, "placed", None)
    _LOCAL.placed = copies
    try:
        yield copies
    finally:
        _LOCAL.placed = previous


def placed(buffer: torch.Tensor) -> torch.Tensor:
    """The buffer's copy on this thread's card (the buffer itself outside
    :func:`placed_buffers`)."""
    copies = getattr(_LOCAL, "placed", None)
    return copies.get(id(buffer), buffer) if copies else buffer


def read_buffer(buffer: torch.Tensor) -> torch.Tensor:
    """The buffer's value as this thread sees it: its staged write, if any."""
    staged = getattr(_LOCAL, "staged", None)
    if staged and id(buffer) in staged:
        return staged[id(buffer)][1]
    return placed(buffer)


def write_buffer(buffer: torch.Tensor, value: torch.Tensor):
    """``buffer <- value``, in place, or staged under :func:`staged_writes`."""
    value = value.detach().reshape(buffer.shape).to(buffer.dtype)
    staged = getattr(_LOCAL, "staged", None)
    if staged is None:
        with torch.no_grad():
            buffer.copy_(value)
    else:
        staged[id(buffer)] = (buffer, value)


def on_buffer_cards(stage: dict) -> dict:
    """``stage`` with each value on its buffer's device (``stage`` itself
    where they all are)."""
    if all(value.device == buffer.device for buffer, value in stage.values()):
        return stage
    return {key: (buffer, value.to(buffer.device)) for key, (buffer, value) in stage.items()}


def agreed(stages, rtol: float = 1e-5, atol: float = 1e-6) -> dict:
    """The ranks' staged writes of one forward, which must name the same
    buffers with the same values (to rounding: each rank computes them from
    the same reduced statistics), compared on the buffers' devices.
    Returns rank 0's."""
    stages = [on_buffer_cards(stage) for stage in stages]
    first = stages[0]
    for rank, stage in enumerate(stages[1:], 1):
        if stage.keys() != first.keys():
            raise RuntimeError(f"rank {rank} wrote other buffers than rank 0")
        for key, (_, value) in stage.items():
            want = first[key][1]
            if not torch.allclose(value, want, rtol=rtol, atol=atol):
                raise RuntimeError(f"rank {rank} staged {value.tolist()} for a buffer that "
                                   f"rank 0 set to {want.tolist()}")
    return first


def apply_mean(stages):
    """Apply the mean over ``stages`` (one dict per event) of each staged
    buffer; an event that did not write a buffer counts its current value."""
    stages = [on_buffer_cards(stage) for stage in stages]
    buffers = {key: buffer for stage in stages for key, (buffer, _) in stage.items()}
    with torch.no_grad():
        for key, buffer in buffers.items():
            values = [stage[key][1] if key in stage else buffer for stage in stages]
            buffer.copy_(values[0] if len(values) == 1 else torch.stack(values).mean(0))
