"""Profiling: the port's span recorder, its phase timers and its counted
host reads.

Counterpart of ``hierarchicalgnn_tpu/utils/profiling.py``.  The reference
times its pooling, graph-construction and layer phases with host clocks;
the JAX package adds ``jax.profiler`` traces and timers that force a
readback.  Here the training step's layers open named spans (:func:`span`),
which cost one flag test until :func:`enable` switches the recorder on.

An enabled span keeps one record: its name, its parent, its step (the
sequence number of the root span it lies in, shared by every span of that
step) and its host interval, and it opens a ``record_function`` range
``hgnn::<name>`` so that an active ``torch.profiler`` puts it in the same
trace as the kernels.  A span with ``device=True`` also records a pair of
CUDA events on the current stream, never waited for inside the step.  Its
device interval runs from the phase's first enqueue to its last kernel's
end, idle time included: a stretch in which the card waited for the host
to enqueue the phase's next kernels is charged to that phase.
:func:`drain`, called outside any step, waits for the events and returns
the records.  On the CPU a span keeps its host interval only.

:func:`host_read` marks a read of a device value by the host (``int(...)``,
``bool(...)``, ``.tolist()``): it counts the read in a step's ``stats`` and,
when enabled, is a host-only span whose length is the time the host sat
blocked on the card.  :class:`PhaseTimer` times the gMRT phases over a
recorder of its own.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

import torch


class Recorder:
    """Span records in memory until :meth:`drain`.  ``cuda``: whether a span
    with ``device=True`` records CUDA events.  Each thread nests its own
    spans: a span opened in another thread (a shard group's rank) is a root
    of its own."""

    def __init__(self, cuda: bool = False):
        self.cuda = cuda
        self._done: list[tuple[dict, tuple | None]] = []
        self._ids = itertools.count()
        self._steps = itertools.count()
        self._open = threading.local()

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        stack = self._open.__dict__.setdefault("spans", [])
        parent = stack[-1] if stack else None
        rec = {"id": next(self._ids), "name": name,
               "parent": None if parent is None else parent["id"],
               "step": next(self._steps) if parent is None else parent["step"]}
        events = None
        with torch.profiler.record_function(f"hgnn::{name}"):
            rec["host_start_ns"] = time.perf_counter_ns()
            if device and self.cuda:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            stack.append(rec)
            try:
                yield
            finally:
                stack.pop()
                if events is not None:
                    events[1].record()
                rec["host_end_ns"] = time.perf_counter_ns()
                self._done.append((rec, events))

    def drain(self) -> list[dict]:
        """The closed spans' records in the order they opened, each with its
        ``device_ms`` (None without a device interval), and forgets them.
        Waits for the spans' events: call it outside any step."""
        done, self._done = self._done, []
        out = []
        for rec, events in sorted(done, key=lambda d: d[0]["id"]):
            rec["device_ms"] = None
            if events is not None:
                events[1].synchronize()
                rec["device_ms"] = events[0].elapsed_time(events[1])
            out.append(rec)
        return out


_RECORDER = Recorder()
_on = False


def enable():
    """Record every span from here on (device intervals where a card is)."""
    global _on
    _RECORDER.cuda = torch.cuda.is_available()
    _on = True


def disable():
    """Stop recording; what was recorded waits for :func:`drain`."""
    global _on
    _on = False


@contextlib.contextmanager
def span(name: str, device: bool = False):
    """A named phase of the program: nothing unless :func:`enable` ran;
    then a record and a ``record_function`` range, and with ``device`` the
    phase's device interval."""
    if not _on:
        yield
        return
    with _RECORDER.span(name, device):
        yield


@contextlib.contextmanager
def host_read(stats):
    """Around one read of a device value by the host: adds 1 to
    ``stats["host_syncs"]`` (``stats`` a dict, or None to count nothing)
    and, when enabled, records a ``host_read`` span of the host's wait."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    if not _on:
        yield
        return
    with _RECORDER.span("host_read"):
        yield


def drain() -> list[dict]:
    """The records of every span closed since the last drain (see
    :meth:`Recorder.drain`)."""
    return _RECORDER.drain()


def totals(records) -> dict[str, dict]:
    """Per span name: ``count``, the summed ``host_ms`` and the summed
    ``device_ms`` (None where no record of the name has a device
    interval)."""
    out: dict[str, dict] = {}
    for rec in records:
        t = out.setdefault(rec["name"], {"device_ms": None, "host_ms": 0.0, "count": 0})
        t["count"] += 1
        t["host_ms"] += (rec["host_end_ns"] - rec["host_start_ns"]) / 1e6
        if rec["device_ms"] is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + rec["device_ms"]
    return out


class PhaseTimer:
    """Accumulating named phase timers, in seconds (resettable per epoch:
    the gMRT counters ``pooling_time`` / ``graph_construct_time``).

    ``device``: where the timed work runs.  A phase is a span of the timer's
    own recorder; on a CUDA device it is timed by the span's device
    interval, read when ``totals``, ``counts`` or :meth:`summary` is, so the
    phases are not waited for one by one; on the CPU by the host clock.
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self._recorder = Recorder(cuda=self.device.type == "cuda")
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        return self._recorder.span(name, device=True)

    def time_fn(self, name: str, fn, *args, **kwargs):
        with self.phase(name):
            out = fn(*args, **kwargs)
        return out

    def _collect(self):
        for name, t in totals(self._recorder.drain()).items():
            ms = t["host_ms"] if t["device_ms"] is None else t["device_ms"]
            self._totals[name] += ms / 1e3
            self._counts[name] += t["count"]

    @property
    def totals(self) -> dict[str, float]:
        self._collect()
        return self._totals

    @property
    def counts(self) -> dict[str, int]:
        self._collect()
        return self._counts

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> dict[str, float]:
        out = self.summary()
        self._totals.clear()
        self._counts.clear()
        return out
