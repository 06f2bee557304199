"""Graph-partitioned serving forward of the five models.

Counterpart of the eval path of ``hierarchicalgnn_tpu/parallel/graph_shard.py``.
One event is split over ``n_parts`` ranks that share one process and one
card (``parallel/comm.py``):

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

Not ported yet (``ROADMAP.md``, Queue 1 item 5): the sharded training step
with K8's backward, the training branches of the clustering, the dynamic
graphs and the batch norm, the sharded auction.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from hierarchicalgnn_torch.ops.connected import compact_labels, count_host_sync
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    INT32_MAX, SortedPlan, build_sorted_plan, sorted_aggregate,
    sorted_aggregate_weighted, sorted_segment_min_i32)
from hierarchicalgnn_torch.ops.segment import segment_sum
from hierarchicalgnn_torch.parallel.comm import HALO_BACKENDS, Comm, run_sharded
from hierarchicalgnn_torch.utils.config import SHARD_DEFAULTS
from hierarchicalgnn_torch.utils.device import resolve_device

# The JAX package rounds the per-rank edge capacity to the edge block of its
# Pallas kernels (``BLOCK_E`` of ops/pallas/sorted_agg.py).  CSR needs no
# block; the constant is kept so that both packages give the same capacities
# and the same ``slot`` and ``ok``.
BLOCK_E = 1024

NOT_PORTED = ("the sharded training step is not ported yet "
              "(ROADMAP.md, Queue 1 item 5)")


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


def make_shard_tools(directed: Graph, n_local: int, spec: SpmdSpec) -> ShardTools:
    """One rank's partition, K1 aggregator and halo gather, from the
    bidirected input graph.  Global N = ``n_local * n_parts``."""
    comm = spec.comm
    idx = comm.index
    num_nodes = n_local * spec.n_parts
    parts, slot, ok = partition_edges(directed, num_nodes, spec)
    local = Graph(parts.senders[idx], parts.receivers[idx], parts.edge_mask[idx])
    # the local edges are receiver-sorted with the valid ones first: the plan's
    # sort is the identity and edge tensors made from ``local`` are in plan order
    plan = build_sorted_plan(local.senders, local.receivers - idx * n_local,
                             local.edge_mask, n_local)

    def gather(x_local):
        x_all = comm.all_gather(x_local)
        return x_all[local.senders], x_all[local.receivers]

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
                         sweights, max_clusters: int, k: int):
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

    Returns (aggs, gathers, sgraph, sweights, ok): the super graph as this
    rank's cells must see it (receiver-sorted; local in pooled mode).
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
        gather_super = lambda x_all: (x_all[sgraph.senders], x_all[sgraph.receivers])
        extra = {"super_bcast": comm.all_gather}
    else:
        b_send_l, b_sup_l, b_m_l, b_w_l = bipartite_local_slice(shard, bgraph, bweights, k)
        s_plan = build_sorted_plan(sgraph.senders, sgraph.receivers, sgraph.edge_mask,
                                   max_clusters)
        sgraph = Graph(s_plan.senders_sorted, s_plan.receivers_sorted,
                       s_plan.edge_mask_sorted)
        sweights = s_plan.sort(sweights)
        reduce_c = comm.psum
        gather_super = lambda x: (x[sgraph.senders], x[sgraph.receivers])
        extra = {}
        ok = torch.ones((), dtype=torch.bool, device=sweights.device)

    # the local bipartite block, one receiver-sorted plan per direction
    p_bs = build_sorted_plan(b_send_l, b_sup_l, b_m_l, max_clusters)
    p_bn = build_sorted_plan(b_sup_l, b_send_l, b_m_l, n_local)
    w_bs, w_bn = p_bs.sort(b_w_l), p_bn.sort(b_w_l)
    aggs = {
        "edge_to_node": shard.agg,
        "bip_to_super": (lambda d: reduce_c(sorted_aggregate_weighted(d, w_bs, p_bs)),
                         p_bs.senders_sorted),
        "bip_to_node": (lambda d: sorted_aggregate_weighted(d, w_bn, p_bn),
                        p_bn.senders_sorted),
        "super_to_super": lambda d: sorted_aggregate_weighted(d, sweights, s_plan),
    }
    gathers = {"graph": shard.gather, "super": gather_super,
               "bip_to_super": lambda x: x[p_bs.senders_sorted], **extra}
    return aggs, gathers, sgraph, sweights, ok


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

# A model's ``sharded_out_specs(spmd)`` is a tree of these, shaped like its
# forward's output (what ``out_specs`` is to a ``shard_map``): SHARDED, the
# ranks' blocks concatenated along dim 0; REPLICATED, every rank holds the
# whole and rank 0's is taken.
SHARDED, REPLICATED = "sharded", "replicated"


def _reassemble(spec, outs):
    if spec == SHARDED:
        return torch.cat(outs, 0)
    if spec == REPLICATED:
        return outs[0]
    parts = [_reassemble(s, [o[i] for o in outs]) for i, s in enumerate(spec)]
    return type(spec)(*parts) if isinstance(spec, Graph) else tuple(parts)


class ShardedForward:
    """``forward(batch)``: the eval forward of one preprocessed event over
    ``n_parts`` ranks, returning the GLOBAL outputs in the unsharded layout.
    BC and gMRT return their bipartite graph in the kNN's edge order, the
    unsharded forward in receiver-sorted order: the same edges and scores,
    permuted.

    ``last_stats`` then holds ``host_syncs`` (summed over the ranks),
    ``partition_ok`` (no rank dropped an edge; one host read), the group's
    ``collectives`` and, for a hierarchical model, ``n_clusters``.
    """

    def __init__(self, model, spec: SpmdSpec, hparams: dict, device):
        self.model, self.spec, self.hparams, self.device = model, spec, hparams, device
        self.out_specs = model.sharded_out_specs(spec)
        self.last_stats: dict = {}

    @torch.no_grad()
    def __call__(self, batch):
        n_parts = self.spec.n_parts
        x = torch.as_tensor(batch.x, device=self.device)
        node_mask = torch.as_tensor(batch.node_mask, device=self.device)
        graph = graph_to(batch.graph, self.device)
        if x.shape[0] % n_parts or graph.senders.shape[0] % n_parts:
            raise ValueError(f"{x.shape[0]} nodes and {graph.senders.shape[0]} edges "
                             f"must both divide by n_parts {n_parts}")
        n_local = x.shape[0] // n_parts
        stats = [{} for _ in range(n_parts)]

        def per_rank(comm):
            rows = slice(comm.index * n_local, (comm.index + 1) * n_local)
            return self.model(x[rows], graph, node_mask[rows], stats=stats[comm.index],
                              spmd=self.spec._replace(comm=comm))

        outs, group = run_sharded(per_rank, n_parts, self.spec.halo_backend, self.device)
        out = _reassemble(self.out_specs, outs)
        flags = [flag for s in stats for flag in s.get("partition_ok", ())]
        self.last_stats = {
            "host_syncs": sum(s.get("host_syncs", 0) for s in stats) + 1,
            "partition_ok": bool(torch.stack(flags).all()),
            "collectives": dict(group.collectives)}
        if isinstance(out, tuple):
            self.last_stats["n_clusters"] = out[-1]["n_clusters"]
        return out


def make_sharded_forward(pipeline, n_parts: int, hparams: dict,
                         device: str | torch.device = "cuda") -> ShardedForward:
    """The graph-partitioned eval forward of ``pipeline.model`` over
    ``n_parts`` ranks on one device (``halo_backend``, ``halo_slack`` and
    ``shard_pooled`` from ``hparams``).  ``device`` defaults to the card and
    raises without one."""
    device = resolve_device(device)
    model = pipeline.model.to(device).eval()
    return ShardedForward(model, spec_from_hparams(n_parts, hparams), hparams, device)
