"""Message-passing cells.

Counterpart of ``hierarchicalgnn_tpu/models/cells.py``, for receiver-sorted
graphs: the aggregations are the K1/K2 kernels, passed in prebuilt by the
blocks (one plan per graph per forward, shared by every iteration).  The
hierarchical update order is semantic: supernodes from the *old* nodes,
then nodes from the *new* supernodes (reference ``gnn_utils.py:162-167``).
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.models.mlp import MLP
from hierarchicalgnn_torch.utils.config import ArchConfig


def _update_mlp(cfg: ArchConfig, n_inputs: int, layers: int, output_activation):
    return MLP(n_inputs * cfg.latent, cfg.hidden, cfg.latent, layers,
               hidden_activation=cfg.hidden_activation,
               output_activation=output_activation, layer_norm=cfg.layernorm,
               compute_dtype=cfg.compute_dtype)


class InteractionGNNCell(nn.Module):
    """One flat interaction-network iteration (reference ``gnn_utils.py:45-71``):

      m_i   = sum_{e: recv(e)=i} edge_e          (K1)
      n_i  <- MLP_n([n_i, m_i]) + n_i
      e    <- MLP_e([n_src, n_recv, e]) + e
    """

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.node_network = _update_mlp(cfg, 2, cfg.nb_node_layer,
                                        cfg.hidden_activation)
        self.edge_network = _update_mlp(cfg, 3, cfg.nb_edge_layer, "Tanh")

    def forward(self, nodes, edges, graph, agg):
        """``graph``: receiver-sorted; ``agg``: its K1 aggregator."""
        # f32-accumulated messages back to the residual stream's dtype
        edge_messages = agg(edges).to(nodes.dtype)
        nodes = self.node_network(torch.cat([nodes, edge_messages], -1)) + nodes
        edges = self.edge_network(torch.cat(
            [nodes[graph.senders], nodes[graph.receivers], edges], -1)) + edges
        return nodes, edges


class HierarchicalGNNCell(nn.Module):
    """One hierarchical iteration (reference ``gnn_utils.py:119-169``) with
    weighted (K2) bipartite and super-graph convolutions."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.node_network = _update_mlp(cfg, 3, cfg.nb_node_layer,
                                        cfg.hidden_activation)
        self.edge_network = _update_mlp(cfg, 3, cfg.nb_edge_layer, "Tanh")
        self.supernode_network = _update_mlp(cfg, 3, cfg.nb_node_layer,
                                             cfg.hidden_activation)
        self.superedge_network = _update_mlp(cfg, 3, cfg.nb_edge_layer, "Tanh")

    def forward(self, nodes, edges, supernodes, superedges, graph, super_graph,
                aggs):
        """``aggs``: {"edge_to_node": K1 over ``graph``,
        "bip_to_super": (K2, sender ids), "bip_to_node": (K2, cluster ids),
        "super_to_super": K2 over ``super_graph``}."""
        agg_to_super, b_send = aggs["bip_to_super"]
        agg_to_node, b_cluster = aggs["bip_to_node"]

        node_messages = agg_to_super(nodes[b_send]).to(supernodes.dtype)
        attention_messages = aggs["super_to_super"](superedges).to(supernodes.dtype)
        new_supernodes = self.supernode_network(torch.cat(
            [supernodes, attention_messages, node_messages], -1)) + supernodes

        supernode_messages = agg_to_node(new_supernodes[b_cluster]).to(nodes.dtype)
        edge_messages = aggs["edge_to_node"](edges).to(nodes.dtype)
        new_nodes = self.node_network(torch.cat(
            [nodes, edge_messages, supernode_messages], -1)) + nodes

        new_superedges = self.superedge_network(torch.cat(
            [new_supernodes[super_graph.senders],
             new_supernodes[super_graph.receivers], superedges], -1)) + superedges
        new_edges = self.edge_network(torch.cat(
            [new_nodes[graph.senders], new_nodes[graph.receivers], edges],
            -1)) + edges
        return new_nodes, new_edges, new_supernodes, new_superedges
