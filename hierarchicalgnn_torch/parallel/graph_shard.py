"""Graph-partitioned forward and training step of the five models.

Counterpart of ``hierarchicalgnn_tpu/parallel/graph_shard.py``.
One event is split over ``n_parts`` ranks that share one process
(``parallel/comm.py``), on the caller's one card, or each on its own card
where ``devices`` names them (the JAX mesh's device array, see
``parallel/mesh.py``; :class:`ShardedForward`):

  * **Node space row-blocked**: rank d owns global node rows
    ``[d*n_local, (d+1)*n_local)``.
  * **Flat edges receiver-partitioned**: every directed edge lives on the
    rank that owns its receiver, so the edge->node sum is local (kernel K1
    over a per-rank sorted plan).  Each rank computes the partition itself
    (:func:`partition_edges`, one argsort); per-rank capacity is
    ``ceil(E * slack / n_parts)`` and an ``ok`` flag reports overflow
    (edges dropped) instead of corrupting silently.
  * **Halo**: the sender-side node rows are refreshed once per
    message-passing iteration by an all-gather: kernel K8 under
    ``halo_backend: rdma``, its plain ``torch.cat`` under ``xla``.  Under
    ``rdma`` EVERY all-gather of this path goes through K8 (node rows,
    supernode rows, embeddings, bool masks, int32 labels, the 1-D
    likelihood): it copies bytes and has no shape rule.
  * **Pooled space row-blocked too** (``shard_pooled``, default on, when
    ``max_clusters`` divides): supernode rows split like node rows (a
    ``psum_scatter`` completes the bipartite node->supernode sum, one small
    all-gather rebuilds the replicated view per use), superedges are
    receiver-partitioned over the supernode blocks, connected components
    hop on the local edges (kernel K5) with one all-gather of ``[n_local]``
    labels per hop, and the bipartite kNN is query-sharded.  Replicated on
    every rank: the GMM fit and cut, the C x C super kNN, the partition
    argsorts.  ``shard_pooled: false`` keeps the whole pooled space
    replicated.
  * **Bipartite edges sender-block contiguous**: the kNN emits ``senders =
    repeat(arange(N), k)``, so rank d's bipartite edges are the static slice
    ``[d*n_local*k, (d+1)*n_local*k)``.

The cells and the parameter tree are the unsharded ones: shard awareness
enters through their ``agg``/``gather``/``aggs``/``gathers`` arguments, so
one ``state_dict`` serves both paths.

Training (:func:`make_sharded_train_step`, ``graph_shard.py:567`` of the JAX
package): the ranks' forwards run with autograd and join into one autograd
graph through the collectives (the all-gather's backward is a reduce-scatter,
``ops/kernels/ring_gather.py``), so one backward from the caller's thread
reaches every rank.  Every gather of a rank has K1 as its backward, the halo
gather's too (:func:`halo_endpoint_gather`).  The loss runs on the caller's
thread on the reassembled outputs; its matching's auction is row-sharded
over the ranks (``train/matching.py``).  The ranks share one module: each
reads its parameters as views of its own (:func:`place_model`), so that
their gradients add in rank order, and their buffer writes are staged,
checked to agree and applied once (``models/buffers.py``).  Over a data axis each step takes several events
(``parallel/step.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from hierarchicalgnn_torch.ops.connected import compact_labels, count_host_sync
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.ops.kernels.ring_gather import settle
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    INT32_MAX, SortedPlan, build_sorted_plan, build_transposed_plan, cross_permutation,
    gather_edge_endpoints, gather_receivers, gather_senders, sorted_aggregate,
    sorted_aggregate_weighted, sorted_segment_min_i32)
from hierarchicalgnn_torch.ops.segment import segment_sum
from hierarchicalgnn_torch.models.buffers import agreed, placed_buffers, staged_writes
from hierarchicalgnn_torch.models.mlp import TPBinding, tensor_parallel
from hierarchicalgnn_torch.parallel.comm import (
    HALO_BACKENDS, Comm, place_inputs, replicate, run_sharded, to_card, to_device)
from hierarchicalgnn_torch.parallel.mesh import as_mesh, make_mesh
from hierarchicalgnn_torch.parallel.step import EventMeanStep, event_index
from hierarchicalgnn_torch.utils.config import SHARD_DEFAULTS
from hierarchicalgnn_torch.utils.device import resolve_device, resolve_devices

# The JAX package rounds the per-rank edge capacity to the edge block of its
# Pallas kernels (``BLOCK_E`` of ops/pallas/sorted_agg.py).  CSR needs no
# block; the constant is kept so that both packages give the same capacities
# and the same ``slot`` and ``ok``.
BLOCK_E = 1024

class SpmdSpec(NamedTuple):
    """What threads the partition through a model's forward.  ``comm`` is
    the calling rank's handle on its shard group (what the mesh axis is to a
    ``shard_map`` body); the other fields are the same on every rank."""

    n_parts: int = 1
    slack: float = 1.5          # per-rank edge capacity head-room
    halo_backend: str = "xla"   # "xla": torch.cat | "rdma": kernel K8
    shard_pooled: bool = True   # row-block the pooled space too
    comm: Any = None


def spec_from_hparams(n_parts: int, hparams: dict) -> SpmdSpec:
    backend = str(hparams.get("halo_backend", SHARD_DEFAULTS["halo_backend"]))
    if backend not in HALO_BACKENDS:
        raise ValueError(f"halo_backend must be one of {HALO_BACKENDS}, got {backend!r}")
    slack = float(hparams.get("halo_slack", SHARD_DEFAULTS["halo_slack"]))
    return SpmdSpec(n_parts=n_parts, slack=slack, halo_backend=backend,
                    shard_pooled=bool(hparams.get("shard_pooled", True)))


def pooled_active(spec: SpmdSpec, max_clusters: int) -> bool:
    """Whether the pooled-space partition is in effect."""
    return bool(spec.shard_pooled) and max_clusters % spec.n_parts == 0


class ShardTools(NamedTuple):
    """One rank's handles, built once per forward."""

    spec: SpmdSpec
    index: int                  # this rank's position
    n_local: int                # owned node rows
    full_graph: Graph           # the whole directed graph (global ids)
    local_graph: Graph          # owned edges (senders/receivers GLOBAL ids)
    slot: torch.Tensor          # [E] global (rank*e_cap+position) slot per input edge
    ok: torch.Tensor            # 0-d bool: no edge was dropped
    agg: Callable               # local edge->node sum (K1)
    gather: Callable            # halo endpoint gather: x_local -> (x[s], x[r])
    all_gather: Callable        # x_local [n_local, ...] -> [N, ...]
    local_plan: SortedPlan      # over the local edges, local receiver ids
    comm: Comm


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def edge_capacity(n_edges: int, spec: SpmdSpec) -> int:
    """Per-rank edge capacity: the slack share, never more than every edge."""
    e_cap = _round_up(max(int(n_edges * spec.slack) // spec.n_parts, BLOCK_E), BLOCK_E)
    return min(e_cap, _round_up(n_edges, BLOCK_E))


def partition_edges(graph: Graph, num_nodes: int, spec: SpmdSpec):
    """Receiver-partition a padded edge list into ``[n_parts, e_cap]``
    buffers.

    A stable sort by receiver alone gives owner-grouped AND receiver-sorted
    per-rank edge lists, valid edges first, so a rank's sorted plan over its
    buffer is the identity permutation.

    Returns (stacked Graph ``[n_parts, e_cap]`` with GLOBAL ids, ``slot``
    int64[E] mapping each input edge to its slot in the flattened buffers,
    ``ok`` 0-d bool).  An edge beyond its owner's capacity is dropped and
    clears ``ok``.
    """
    senders, receivers, edge_mask = graph.senders.long(), graph.receivers.long(), graph.edge_mask
    e = senders.shape[0]
    n_parts = spec.n_parts
    e_cap = edge_capacity(e, spec)
    block = num_nodes // n_parts
    device = senders.device

    key = torch.where(edge_mask, receivers, num_nodes)  # padded edges past every owner
    order = torch.argsort(key, stable=True)
    s_s, r_s, m_s = senders[order], receivers[order], edge_mask[order]
    owner = torch.where(m_s, r_s // block, n_parts)

    counts = torch.zeros(n_parts + 1, dtype=torch.long, device=device).scatter_add_(
        0, owner, torch.ones_like(owner))
    starts = torch.cumsum(counts, 0) - counts
    position = torch.arange(e, device=device) - starts[owner]
    keep = m_s & (position < e_cap)
    ok = ~torch.any(m_s & (position >= e_cap))
    dump = n_parts * e_cap
    dest = torch.where(keep, owner * e_cap + position, dump)

    def buf(vals, fill):
        out = torch.full((dump + 1,), fill, dtype=vals.dtype, device=device)
        out[dest] = torch.where(keep, vals, torch.full((), fill, dtype=vals.dtype,
                                                       device=device))
        return out[:-1].reshape(n_parts, e_cap)

    parts = Graph(buf(s_s, 0), buf(r_s, 0), buf(keep, False))
    # slot per INPUT edge: invert the sort permutation
    slot = torch.zeros(e, dtype=torch.long, device=device)
    slot[order] = torch.clamp(dest, max=dump - 1)
    return parts, slot, ok


def halo_endpoint_gather(graph: Graph, plan: SortedPlan, offset: int, num_rows: int,
                         transposed: bool):
    """``x_all -> (x_all[senders], x_all[receivers])`` over a rank's local
    edges ``graph`` (GLOBAL ids of ``x_all``'s ``num_rows`` rows; the
    receivers are the rank's own, ``offset`` on) and their receiver-sorted
    ``plan`` (local receiver ids).  Without ``transposed`` this is plain
    indexing.  With it the backward is K1, never autograd's index backward:
    the sender side over a sender-sorted plan of the gathered rows, the
    receiver side over ``plan`` itself, added in f32 and rounded once (as
    the unsharded gather does); then the all-gather's reduce-scatter hands
    each rank its rows' sums."""
    if not transposed:
        return lambda x_all: (x_all[graph.senders], x_all[graph.receivers])
    plan_t, r2s = build_transposed_plan(plan, graph.senders, graph.receivers,
                                        graph.edge_mask, num_rows)
    return lambda x_all: gather_edge_endpoints(x_all, plan, plan_t, r2s, offset)


def make_shard_tools(directed: Graph, n_local: int, spec: SpmdSpec,
                     transposed: bool = False) -> ShardTools:
    """One rank's partition, K1 aggregator and halo gather, from the
    bidirected input graph.  Global N = ``n_local * n_parts``.  With
    ``transposed`` (training) the halo gather's backward is K1
    (:func:`halo_endpoint_gather`)."""
    comm = spec.comm
    idx = comm.index
    num_nodes = n_local * spec.n_parts
    parts, slot, ok = partition_edges(directed, num_nodes, spec)
    local = Graph(parts.senders[idx], parts.receivers[idx], parts.edge_mask[idx])
    # the local edges are receiver-sorted with the valid ones first: the plan's
    # sort is the identity and edge tensors made from ``local`` are in plan order
    plan = build_sorted_plan(local.senders, local.receivers - idx * n_local,
                             local.edge_mask, n_local)
    halo = halo_endpoint_gather(local, plan, idx * n_local, num_nodes, transposed)

    def gather(x_local):
        return halo(comm.all_gather(x_local))

    return ShardTools(spec=spec, index=idx, n_local=n_local, full_graph=directed,
                      local_graph=local, slot=slot, ok=ok,
                      agg=lambda data: sorted_aggregate(data, plan), gather=gather,
                      all_gather=comm.all_gather, local_plan=plan, comm=comm)


def bipartite_local_slice(shard: ShardTools, bgraph: Graph, weights, k: int):
    """This rank's contiguous block of the global bipartite kNN edges, node
    ids made local: (senders_local, supers_global, mask, weights)."""
    e_loc = shard.n_local * k
    rows = slice(shard.index * e_loc, (shard.index + 1) * e_loc)
    return (bgraph.senders[rows] - shard.index * shard.n_local, bgraph.receivers[rows],
            bgraph.edge_mask[rows], weights[rows])


def partition_edge_values(slot, edge_mask, values, n_parts: int, e_cap: int):
    """Scatter per-edge values into the layout of :func:`partition_edges`.
    Returns ``[n_parts, e_cap, ...]``; padded edges add zero."""
    m = edge_mask.reshape((-1,) + (1,) * (values.ndim - 1))
    v = torch.where(m, values, torch.zeros((), dtype=values.dtype, device=values.device))
    flat = torch.zeros((n_parts * e_cap,) + tuple(values.shape[1:]), dtype=values.dtype,
                       device=values.device)
    flat.index_add_(0, slot, v)
    return flat.reshape((n_parts, e_cap) + tuple(values.shape[1:]))


def sharded_cluster_labels(shard: ShardTools, keep_local, num_nodes: int,
                           min_cluster_size: int, node_mask, max_iters: int = 64,
                           stats=None):
    """Graph-partitioned connected components -> dense cluster labels.

    The hop runs on the LOCAL receiver-partitioned edges (K5 into this rank's
    node rows) and one all-gather of ``[n_local]`` int32 labels per hop
    rebuilds the full label vector, identical on every rank (min is exact),
    so the host-polled loop of ``ops/connected.py`` ends on the same body on
    every rank.  Same shape as the unsharded loop (two hops per body, three
    pointer jumps per hop), so the labels equal its labels.

    ``keep_local``: bool[e_cap] over ``shard.local_graph`` (the GMM cut);
    ``node_mask``: bool[num_nodes], the whole event's.  Returns (clusters
    int32[num_nodes], n_clusters 0-d), the same on every rank.
    """
    lg = shard.local_graph
    arange = torch.arange(num_nodes, dtype=torch.int32, device=keep_local.device)

    def hop(labels):
        l_edge = torch.minimum(labels[lg.senders], labels[lg.receivers])
        l_edge = torch.where(keep_local, l_edge, INT32_MAX)
        m = shard.all_gather(sorted_segment_min_i32(l_edge, shard.local_plan))
        new = torch.minimum(labels, m)
        for _ in range(3):
            new = torch.minimum(new, new[new.long()])
        return new

    labels = arange
    for _ in range(max_iters // 2):
        new = hop(hop(labels))
        count_host_sync(stats)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    labels = torch.where(node_mask, labels, arange)
    sizes = segment_sum(node_mask.int(), labels.long(), num_nodes)
    keep_nodes = node_mask & (sizes[labels.long()] >= min_cluster_size)
    return compact_labels(labels, keep_nodes)


def make_hier_shard_aggs(shard: ShardTools, bgraph: Graph, bweights, sgraph: Graph,
                         sweights, max_clusters: int, k: int, training: bool = False):
    """Shard-aware ``aggs`` and ``gathers`` for ``HierarchicalGNNCell``.

    Collectives per hierarchical iteration: one sum over ranks of the
    ``[C, D]`` bipartite node->supernode partials and one all-gather of the
    node rows for the edge update; with the pooled space partitioned, also
    one small all-gather of the supernode rows.  The bipartite and super
    convolutions are K2 over per-rank sorted plans.

    With :func:`pooled_active`: ``bgraph``/``bweights`` are this rank's LOCAL
    bipartite construction (senders are local node ids; the query-sharded
    kNN emits exactly this block); supernode rows are blocked
    (``psum_scatter``), the superedges receiver-partitioned over the
    supernode blocks (:func:`partition_edges`), and ``gathers["super_bcast"]``
    rebuilds the whole supernode array (one all-gather of ``[c_local, D]``
    per use); ``gathers["super"]`` then takes that gathered array.
    Otherwise ``bgraph`` is the global graph and this rank's slice is taken
    here, and the super graph stays whole on every rank.

    ``training``: every gather gets a K1 backward, as in the unsharded
    block: the superedge endpoints through transposed plans, the bipartite
    row gathers through the two bipartite plans, which are each other's
    transposes.

    Returns (aggs, gathers, sgraph, sweights, ok, head): the super graph as
    this rank's cells must see it (receiver-sorted; local in pooled mode),
    and the score head's ``(gather, plan)``: ``gather(nodes, supernodes)``
    gives the rows at the two ends of this rank's bipartite edges in
    ``plan``'s order, and ``plan.unsort`` puts per-edge values back into the
    kNN's order.
    """
    comm = shard.comm
    n_local, idx = shard.n_local, shard.index
    pooled = pooled_active(shard.spec, max_clusters)
    if pooled:
        b_send_l, b_sup_l, b_m_l, b_w_l = (bgraph.senders, bgraph.receivers,
                                           bgraph.edge_mask, bweights)
        c_local = max_clusters // shard.spec.n_parts
        s_parts, s_slot, ok = partition_edges(sgraph, max_clusters, shard.spec)
        sw_parts = partition_edge_values(s_slot, sgraph.edge_mask, sweights,
                                         shard.spec.n_parts, s_parts.senders.shape[1])
        # the local superedges are receiver-sorted already: identity plan
        s_plan = build_sorted_plan(s_parts.senders[idx],
                                   s_parts.receivers[idx] - idx * c_local,
                                   s_parts.edge_mask[idx], c_local)
        sgraph = Graph(s_plan.senders_sorted, s_plan.receivers_sorted + idx * c_local,
                       s_plan.edge_mask_sorted)
        sweights = s_plan.sort(sw_parts[idx])
        reduce_c = comm.psum_scatter
        gather_super = halo_endpoint_gather(sgraph, s_plan, idx * c_local, max_clusters,
                                            training)
        extra = {"super_bcast": comm.all_gather}
    else:
        b_send_l, b_sup_l, b_m_l, b_w_l = bipartite_local_slice(shard, bgraph, bweights, k)
        s_plan = build_sorted_plan(sgraph.senders, sgraph.receivers, sgraph.edge_mask,
                                   max_clusters)
        s_t = r2s = None
        if training:
            s_t, r2s = build_transposed_plan(s_plan, sgraph.senders, sgraph.receivers,
                                             sgraph.edge_mask, max_clusters)
        sgraph = Graph(s_plan.senders_sorted, s_plan.receivers_sorted,
                       s_plan.edge_mask_sorted)
        sweights = s_plan.sort(sweights)
        reduce_c = comm.psum
        gather_super = lambda x: gather_edge_endpoints(x, s_plan, s_t, r2s)
        extra = {}
        ok = torch.ones((), dtype=torch.bool, device=sweights.device)

    # the local bipartite block, one receiver-sorted plan per direction; each
    # is the other's transposed plan, so the row gathers' backward is K1
    p_bs = build_sorted_plan(b_send_l, b_sup_l, b_m_l, max_clusters)
    p_bn = build_sorted_plan(b_sup_l, b_send_l, b_m_l, n_local)
    w_bs, w_bn = p_bs.sort(b_w_l), p_bn.sort(b_w_l)
    t_bs, t_bn = (p_bn, p_bs) if training else (None, None)
    bs_of_bn = cross_permutation(p_bs, p_bn) if training else None
    bn_of_bs = cross_permutation(p_bn, p_bs) if training else None
    gather_cluster_rows = lambda x: gather_senders(x, p_bn, t_bn, bn_of_bs)
    aggs = {
        "edge_to_node": shard.agg,
        "bip_to_super": (lambda d: reduce_c(sorted_aggregate_weighted(d, w_bs, p_bs)),
                         p_bs.senders_sorted),
        "bip_to_node": (lambda d: sorted_aggregate_weighted(d, w_bn, p_bn),
                        p_bn.senders_sorted),
        "super_to_super": lambda d: sorted_aggregate_weighted(d, sweights, s_plan),
    }
    gathers = {"graph": shard.gather, "super": gather_super,
               "bip_to_super": lambda x: gather_senders(x, p_bs, t_bs, bs_of_bn),
               "bip_to_node": gather_cluster_rows, **extra}
    head = (lambda x, sn: (gather_receivers(x, p_bn), gather_cluster_rows(sn)), p_bn)
    return aggs, gathers, sgraph, sweights, ok, head


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

# A model's ``sharded_out_specs(spmd)`` is a tree of these, shaped like its
# forward's output (what ``out_specs`` is to a ``shard_map``): SHARDED, the
# ranks' blocks concatenated along dim 0; REPLICATED, every rank holds the
# whole and rank 0's is taken.
SHARDED, REPLICATED = "sharded", "replicated"


def _reassemble(spec, outs, device=None):
    """The ranks' outputs in the unsharded layout; on ``device`` where given
    (the ranks' outputs lie on their cards)."""
    if spec == SHARDED:
        return torch.cat(outs if device is None else [to_card(o, device) for o in outs], 0)
    if spec == REPLICATED:
        return outs[0] if device is None else to_device(outs[0], device)
    parts = [_reassemble(s, [o[i] for o in outs], device) for i, s in enumerate(spec)]
    return type(spec)(*parts) if isinstance(spec, Graph) else tuple(parts)


def place_model(model, devices):
    """``on_card(comm)``: the context in which rank ``comm.index`` of a
    forward over ``devices`` reads each of ``model``'s parameters as a view
    of its own, through ``parallel/comm.py::replicate`` (one copy per card
    other than the parameter's): the ranks' contributions to its gradient are
    then added on its card in rank order.  Read directly, the parameter
    would gather them in the order autograd's engine meets them, which on the
    card varies from run to run.  Call it on the caller's thread, before the
    ranks run."""
    params = {id(p): replicate(p, len(devices), devices) for p in model.parameters()}
    return lambda comm: tensor_parallel(
        TPBinding(comm, {k: (v[comm.index], None) for k, v in params.items()}))


class ShardedForward:
    """``forward(batch)``: the eval forward of one preprocessed event over
    ``n_parts`` ranks, returning the GLOBAL outputs in the unsharded layout
    on ``device``.  BC and gMRT return their bipartite graph in the kNN's
    edge order, the unsharded forward in receiver-sorted order: the same
    edges and scores, permuted.

    ``devices``: for each local event, the devices of its ranks (None: every
    rank on ``device``, the model's, the default path).  Given, even where
    every entry is ``device``, each rank gets its inputs and the model's
    buffers on its device (``parallel/comm.py::place_inputs``) and runs with
    that card current; the outputs come back to ``device``.  Every rank
    reads the parameters through :func:`place_model`, on its card.

    ``last_stats`` then holds ``host_syncs`` (summed over the ranks),
    ``partition_ok`` (no rank dropped an edge; one host read), the group's
    ``collectives`` and, for a hierarchical model, ``n_clusters``.
    """

    def __init__(self, model, spec: SpmdSpec, hparams: dict, device, devices=None):
        self.model, self.spec, self.hparams, self.device = model, spec, hparams, device
        self.devices = devices
        self.out_specs = model.sharded_out_specs(spec)
        self.last_stats: dict = {}

    @torch.no_grad()
    def __call__(self, batch):
        return self._run(batch)[0]

    def _run(self, batch, event: int = 0):
        """The ranks' forwards of local event ``event`` in the model's mode and
        the caller's grad mode.  Returns (the reassembled outputs, each rank's
        staged buffer writes)."""
        n_parts = self.spec.n_parts
        x = torch.as_tensor(batch.x, device=self.device)
        node_mask = torch.as_tensor(batch.node_mask, device=self.device)
        graph = graph_to(batch.graph, self.device)
        if x.shape[0] % n_parts or graph.senders.shape[0] % n_parts:
            raise ValueError(f"{x.shape[0]} nodes and {graph.senders.shape[0]} edges "
                             f"must both divide by n_parts {n_parts}")
        n_local = x.shape[0] // n_parts
        stats = [{} for _ in range(n_parts)]
        devices = None if self.devices is None else resolve_devices(self.devices[event])
        inputs_of, buffers_of = place_inputs((x, graph, node_mask), devices,
                                             self.model.buffers())
        on_card = place_model(self.model, devices or [self.device] * n_parts)

        def per_rank(comm):
            r = comm.index
            rows = slice(r * n_local, (r + 1) * n_local)
            x_r, graph_r, mask_r = inputs_of(r)
            with staged_writes() as staged, placed_buffers(buffers_of(r)), on_card(comm):
                out = self.model(x_r[rows], graph_r, mask_r[rows], stats=stats[r],
                                 spmd=self.spec._replace(comm=comm))
            return out, staged

        ranks, group = run_sharded(per_rank, n_parts, self.spec.halo_backend, self.device,
                                   devices)
        out = _reassemble(self.out_specs, [o for o, _ in ranks], self.device)
        settle()  # a K8 call whose peer never came fails this forward
        flags = [flag.to(self.device) for s in stats for flag in s.get("partition_ok", ())]
        self.last_stats = {
            "host_syncs": sum(s.get("host_syncs", 0) for s in stats) + 1,
            "partition_ok": bool(torch.stack(flags).all()),
            "collectives": dict(group.collectives)}
        if isinstance(out, tuple):
            self.last_stats["n_clusters"] = out[-1]["n_clusters"]
        return out, [staged for _, staged in ranks]


class ShardedTrainForward(ShardedForward):
    """``forward(batch, stats) -> (out, staged)``: the TRAINING forward of one
    event over ``n_parts`` ranks, with autograd.  The ranks' graphs are one
    autograd graph through the collectives, so one backward from the
    caller's thread reaches every rank.  The ranks' buffer writes are staged
    and must agree (``models/buffers.py::agreed``); ``staged`` is rank 0's,
    for the caller to apply.  The ranks run on the row of devices of the
    step's event in flight (``parallel/step.py::event_index``).  ``stats``
    receives ``last_stats``: host syncs
    and collectives added up, ``partition_ok`` and-ed."""

    def __call__(self, batch, stats=None):
        self.model.train()
        out, stages = self._run(batch, event_index())
        if stats is not None:
            last = self.last_stats
            stats["host_syncs"] = stats.get("host_syncs", 0) + last["host_syncs"]
            stats["partition_ok"] = stats.get("partition_ok", True) and last["partition_ok"]
            total = stats.setdefault("collectives", {})
            for kind, n in last["collectives"].items():
                total[kind] = total.get(kind, 0) + n
            if "n_clusters" in last:
                stats["n_clusters"] = last["n_clusters"]
        return out, agreed(stages)


def make_sharded_forward(pipeline, n_parts: int, hparams: dict,
                         device: str | torch.device = "cuda", devices=None) -> ShardedForward:
    """The graph-partitioned eval forward of ``pipeline.model`` over
    ``n_parts`` ranks (``halo_backend``, ``halo_slack`` and ``shard_pooled``
    from ``hparams``): on ``device``, where the model and the outputs live,
    or rank r on ``devices[r]`` (a row of a mesh's devices).  ``device``
    defaults to the card and raises without one."""
    device = resolve_devices([resolve_device(device)])[0]
    model = pipeline.model.to(device).eval()
    rows = None if devices is None else make_mesh(1, n_parts, devices=devices).devices
    return ShardedForward(model, spec_from_hparams(n_parts, hparams), hparams, device, rows)


def make_sharded_train_step(pipeline, optimizer, mesh_shape, hparams: dict,
                            device: str | torch.device = "cuda", devices=None) -> EventMeanStep:
    """The training step with the model's forward graph-partitioned over
    ``graph`` ranks and ``data`` events a step (``graph_shard.py:567`` of the
    JAX package).  ``mesh_shape`` is a ``parallel/mesh.py`` Mesh, whose
    ``data`` axis may span the processes of a ``torch.distributed`` group
    (the ``graph`` ranks stay threads of each process), or a ``{"data",
    "graph"}`` dict for one process.  ``step(batch, epoch) -> metrics`` takes
    one Event when this process runs one event, else a list or a stack
    (``parallel/step.py::stack_events``) of its events;
    ``step.forward_backward`` gives the gradients without applying them.

    The loss, the bipartite matching's truth included, runs on the caller's
    thread on the reassembled outputs: the unsharded ``loss_from_outputs``.
    With one event a step the matching's auction is row-sharded over the
    ranks (``shard_matching``, default on); over several events it is
    replicated, as in the JAX package.  ``device`` (the model's, where the
    loss runs) defaults to the card and raises without one.  The ranks of
    local event e run on row e of the mesh's devices, or of ``devices`` (a
    flat list, as ``make_mesh`` takes it), where given.
    """
    device = resolve_devices([resolve_device(device)])[0]
    mesh = as_mesh(mesh_shape)
    if devices is not None:
        mesh = make_mesh(mesh.data, mesh.graph, mesh.group, devices)
    model = pipeline.model.to(device)
    forward = ShardedTrainForward(model, spec_from_hparams(mesh.graph, hparams), hparams,
                                  device, mesh.devices)
    matching = (mesh.graph if mesh.data == 1 and bool(hparams.get("shard_matching", True))
                else None)
    return EventMeanStep(pipeline, optimizer, forward, mesh.data, matching_spmd=matching,
                         group=mesh.group)
