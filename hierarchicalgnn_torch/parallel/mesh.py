"""The ``{data, graph}`` mesh of the training steps.

Counterpart of ``hierarchicalgnn_tpu/parallel/mesh.py``.  The JAX mesh is an
array of devices with a ``data`` axis (events, data parallelism) and a
``graph`` axis (the edge partition of one event); XLA inserts the
collectives its shardings imply.  Here the axes are carried out by hand:

  * ``graph``: ranks that are threads of one process (``parallel/comm.py``);
  * ``data``: the events of a step, split evenly over the processes of a
    ``torch.distributed`` group (``parallel/distributed.py``); each process
    runs its own share of them (``parallel/step.py::EventMeanStep``).

A mesh without a group is one process that runs every event itself.  The
steps also take a plain ``{"data": B, "graph": G}`` dict for that case.

``devices`` places the ranks as the JAX mesh's device array does: the first
``local_events x graph`` of them, reshaped to ``[local_events, graph]``, and
rank g of this process's event e runs on ``devices[e][g]`` (a device may
repeat: those ranks share it).  Without ``devices`` every rank of every
event runs on the caller's one device; that is the port's default, and no
path then takes another card.

    mesh = make_mesh(data=1, graph=4)                      # 4 ranks on one card
    mesh = make_mesh(data=1, graph=4,
                     devices=[torch.device("cuda", g) for g in range(4)])
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch.distributed as dist

from hierarchicalgnn_torch.utils.device import resolve_devices

from hierarchicalgnn_torch.data.event import Event
from hierarchicalgnn_torch.ops.graph import Graph


class Mesh(NamedTuple):
    """``data`` events a step over ``world_size`` processes (``group``, None
    for one process), each event over ``graph`` thread ranks; this process is
    ``process`` and runs the ``local_events`` events from ``offset`` on.
    ``devices``: ``[local_events][graph]`` ``torch.device``s, or None (every
    rank on the caller's device)."""

    data: int
    graph: int
    group: Any = None
    world_size: int = 1
    process: int = 0
    devices: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "graph": self.graph}

    @property
    def local_events(self) -> int:
        return self.data // self.world_size

    @property
    def offset(self) -> int:
        return self.process * self.local_events



class Sharding(NamedTuple):
    """What ``NamedSharding`` is to the JAX mesh: a mesh and, for each dim of
    an array, the mesh axes it is split over (``()``: replicated)."""

    mesh: Mesh
    spec: tuple


def make_mesh(data: int = 1, graph: int = 1, group=None, devices=None) -> Mesh:
    """The mesh; raises when an axis is below 1, when the processes of
    ``group`` do not split ``data`` evenly, or, as the JAX ``make_mesh``
    does, when ``devices`` are fewer than the mesh's ranks in this process
    (see the module's docstring; a card that does not exist raises too)."""
    if data < 1 or graph < 1:
        raise ValueError(f"mesh {data}x{graph}: both axes must be at least 1")
    world, process = 1, 0
    if group is not None:
        world, process = dist.get_world_size(group), dist.get_rank(group)
    if data % world:
        raise ValueError(f"mesh {data}x{graph}: data {data} does not split over "
                         f"{world} processes")
    return Mesh(int(data), int(graph), group, world, process,
                device_array(data // world, graph, devices, f"mesh {data}x{graph}"))


def device_array(rows: int, cols: int, devices, what: str):
    """The first ``rows * cols`` of ``devices`` as ``[rows][cols]`` (a tuple
    of tuples of ``torch.device``), or None without ``devices``; raises, in
    the JAX mesh's words, when there are fewer."""
    if devices is None:
        return None
    devices = list(devices)
    n = rows * cols
    if n > len(devices):
        raise ValueError(f"{what} needs {n} devices, have {len(devices)}")
    flat = resolve_devices(devices[:n])
    return tuple(tuple(flat[e * cols:(e + 1) * cols]) for e in range(rows))


def as_mesh(mesh_shape) -> Mesh:
    """A :class:`Mesh` as it is, or a ``{"data", "graph"}`` dict as the mesh
    of one process."""
    if isinstance(mesh_shape, Mesh):
        return mesh_shape
    return make_mesh(int(mesh_shape.get("data", 1) or 1), int(mesh_shape.get("graph", 1) or 1))


def batch_sharding(mesh: Mesh) -> Event:
    """The sharding of each field of a batched Event ``[B, ...]``: node
    arrays over ``data`` (replicated over ``graph``), edge arrays over
    ``data`` and their edge dim over ``graph`` (``mesh.py:32-55`` of the JAX
    package)."""
    node = Sharding(mesh, ("data",))
    edge = Sharding(mesh, ("data", "graph"))

    def egraph():
        return Graph(senders=edge, receivers=edge, edge_mask=edge)

    return Event(
        x=node, pt=node, pid=node, primary=node, nhits=node,
        signal_mask=node, node_mask=node,
        graph=egraph(), y=edge, y_pid=edge,
        true_graph=egraph(), signal_true_graph=egraph(),
        inverse_mask=node,
        pid_compact=node, n_particles=node,
        particle_pid=node, particle_pt=node, particle_nhits=node,
    )


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
