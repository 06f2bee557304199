"""The ``data`` axis over processes: a ``torch.distributed`` group.

Counterpart of ``hierarchicalgnn_tpu/parallel/distributed.py``, whose
policy it keeps: every process calls :func:`initialize`, then builds one
global mesh (:func:`make_global_mesh`) whose ``data`` axis spans the
processes while its ``graph`` axis stays inside each of them, so the halo
never crosses a process boundary.  Here the ``graph`` ranks are threads of
the process (``parallel/comm.py``); each process runs its own share of the
step's events and the processes meet once a step, after the backward, in
one all-gather (:func:`gather_from_processes`, called by
``parallel/step.py::EventMeanStep``).

Why an all-gather, not an all-reduce: a backend's all-reduce adds in an
order of its own.  The port adds partials in rank order (``parallel/comm.py``),
and across processes in process order: every process receives every
process's gradients and folds them left to right, as the one-process step
folds its events, so with one event per process the step equals the
one-process step over the same events bit for bit.

The group's ``timeout`` bounds every collective, so a peer that hangs or
dies fails the run instead of holding it.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.parallel.comm import THREAD_PREFIX
from hierarchicalgnn_torch.parallel.mesh import Mesh, Sharding, make_mesh
from hierarchicalgnn_torch.utils.device import resolve_device

TIMEOUT_S = 300.0
_ALIGN = 16  # bytes: each tensor of a gathered buffer starts on a multiple


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               init_method: str | None = None, device: str | torch.device = "cuda",
               timeout_s: float = TIMEOUT_S):
    """``torch.distributed.init_process_group`` for this process; returns the
    group (``dist.group.WORLD``).

    ``coordinator_address`` (``host:port``, process 0's) or ``init_method``
    (e.g. ``file:///path``) with ``num_processes`` and ``process_id`` name the
    group; with neither, torchrun's environment does (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), the counterpart of JAX's
    auto-detection.  ``backend`` defaults to ``nccl`` on the card and
    ``gloo`` on the CPU; ``device`` defaults to the card and raises without
    one.  ``timeout_s`` bounds every collective of the group."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is not None:
        if init_method is not None:
            raise ValueError("give coordinator_address or init_method, not both")
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"no coordinator given and no torchrun environment "
                               f"({', '.join(missing)} unset)")
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("num_processes and process_id name this process in the group")
        kwargs.update(world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.group.WORLD


def make_global_mesh(graph_per_host: int = 1) -> Mesh:
    """The mesh over every process of the default group (one process when
    none is initialised): one event a step in each process, split over
    ``graph_per_host`` thread ranks, so ``data`` is the processes.  (For
    several events a process, ``make_mesh(world * k, graph, group)``.)
    Raises when ``graph_per_host`` is below 1."""
    if graph_per_host < 1:
        raise ValueError(f"graph_per_host {graph_per_host} must be at least 1")
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    return make_mesh(world, graph_per_host, group)


class GlobalBatch(NamedTuple):
    """This process's events of a global batch: ``events`` (an Event stacked
    ``[B_local, ...]``), the global index of the first (``offset``) and the
    events of the step over all processes (``count``)."""

    events: Event
    offset: int
    count: int


def globalize_batch(local_batch: Event, shardings) -> GlobalBatch:
    """The global batch of which ``local_batch``, this process's ``[B_local,
    ...]`` stack, is a part; the data stays in the process.  ``shardings``
    (``parallel.mesh.batch_sharding(mesh)``) fixes the mesh: every array
    must hold the process's ``mesh.local_events`` events, and a dim split
    over ``graph`` must divide by it."""
    found = []

    def check(value, sharding, path):
        if isinstance(sharding, Sharding):
            mesh, shape = sharding.mesh, tuple(value.shape)
            found.append(mesh)
            if not shape or shape[0] != mesh.local_events:
                raise ValueError(f"{path} holds {shape[:1]} events; process {mesh.process} "
                                 f"of {mesh.world_size} runs {mesh.local_events} of "
                                 f"data {mesh.data}")
            for dim, axis in enumerate(sharding.spec):
                if axis == "graph" and shape[dim] % mesh.graph:
                    raise ValueError(f"{path} dim {dim} of {shape[dim]} does not split "
                                     f"over graph {mesh.graph}")
            return
        for field, v, s in zip(sharding._fields, value, sharding):
            check(v, s, f"{path}.{field}")

    check(local_batch, shardings, "batch")
    mesh = found[0]
    return GlobalBatch(local_batch, mesh.offset, mesh.data)


def _leaves(tree):
    """The leaves of a tree of dicts (by sorted key), sequences and
    dataclasses, in a fixed order."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for field in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, field.name))
    else:
        yield tree


def fingerprint(tree) -> bytes:
    """The first 8 bytes of the sha256 of every leaf's raw bytes (a tensor's
    dtype, shape and storage bytes, so a bf16 tensor is hashed as it is
    held: no cast hides a one-ulp change), in :func:`_leaves` order."""
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
        elif isinstance(leaf, np.ndarray):
            h.update(f"{leaf.dtype}{leaf.shape}".encode())
            h.update(np.ascontiguousarray(leaf).tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.digest()[:8]


def _group_device(group) -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assert_host_identical(tree, name: str = "tree", group=None):
    """Raise ``ValueError`` unless every process of ``group`` (the default
    group if None) holds a bit-identical ``tree``: params, optimizer moments
    and buffers of a replicated state, for instance.  One all-gather of an
    8-byte fingerprint (:func:`fingerprint`); no group, nothing to compare."""
    if group is None and not dist.is_initialized():
        return
    digest = np.frombuffer(fingerprint(tree), dtype=np.int64).copy()
    mine = torch.from_numpy(digest).to(_group_device(group))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    _check_thread("assert_host_identical")
    dist.all_gather(parts, mine, group=group)
    got = [int(p.item()) for p in parts]
    if any(g != got[0] for g in got):
        raise ValueError(
            f"{name} differs across processes: fingerprints "
            f"{[f'{g & (2**64 - 1):016x}' for g in got]} (process "
            f"{dist.get_rank(group)} has {int(digest[0]) & (2**64 - 1):016x}): check that "
            f"seeds and configs are identical")


def replicate(tree, mesh: Mesh, check: bool = False):
    """The replicated state of every process: each process holds it whole,
    on its own device, so nothing moves.  All processes must hold equal
    values (a seeded init gives them); ``check=True`` verifies it with
    :func:`assert_host_identical`."""
    if check:
        assert_host_identical(tree, "replicate() input", mesh.group)
    return tree


def read_replicated(x) -> np.ndarray:
    """Host value of a replicated tensor (bf16 widened to f32)."""
    t = torch.as_tensor(x).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_thread(what):
    if threading.current_thread().name.startswith(THREAD_PREFIX):
        raise RuntimeError(f"{what}: a collective over the processes from a rank thread "
                           f"would deadlock against the shard group's baton")


def gather_from_processes(tensors, group, stats: dict | None = None) -> list:
    """Every process's copy of each of ``tensors``: a list with, for each
    tensor, the ``world_size`` copies in process order.  Every process must
    pass tensors of the same shapes and dtypes.  One all-gather moves them
    all, as the bytes of one buffer (each tensor aligned to 16 bytes), from
    the caller's thread, never a rank thread.  ``stats`` receives the count
    (``process_gathers``), the bytes each process receives
    (``process_gather_bytes``) and the host ms (``process_gather_ms``)."""
    _check_thread("gather_from_processes")
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return []
    device = tensors[0].device
    sizes = [t.numel() * t.element_size() for t in tensors]
    starts, at = [], 0
    for size in sizes:
        starts.append(at)
        at += -(-size // _ALIGN) * _ALIGN
    t0 = time.perf_counter()
    flat = torch.zeros(at, dtype=torch.uint8, device=device)
    for t, start, size in zip(tensors, starts, sizes):
        flat[start:start + size] = t.reshape(-1).contiguous().view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    out = [[part[start:start + size].view(t.dtype).view(t.shape) for part in parts]
           for t, start, size in zip(tensors, starts, sizes)]
    if stats is not None:
        stats["process_gathers"] = stats.get("process_gathers", 0) + 1
        stats["process_gather_bytes"] = (stats.get("process_gather_bytes", 0)
                                         + len(parts) * at)
        stats["process_gather_ms"] = (stats.get("process_gather_ms", 0.0)
                                      + 1e3 * (time.perf_counter() - t0))
    return out
