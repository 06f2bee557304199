"""The FLOP and byte counts against hand counts at tiny shapes."""

import pytest
import torch

from portbench.harness import cell as cell_lib
from portbench.harness import flops, ops, peaks

BC = cell_lib.load_module("models", "bc_hgnn_gmm")
EMBEDDING_IN = cell_lib.load_module("models", "embedding_in")


def test_mlp_flops_by_hand():
    # 3 -> 4 -> 4 -> 2 over 5 rows: 2 * 5 * (12 + 16 + 8)
    assert flops.mlp_sizes(3, 4, 2, 3) == [3, 4, 4, 2]
    assert flops.mlp_flops(5, [3, 4, 4, 2]) == 2 * 5 * (12 + 16 + 8)


def test_embedding_in_forward_by_hand():
    hp = {"model": "Embedding-IN", "latent": 4, "hidden": "ratio", "hidden_ratio": 2,
          "emb_dim": 2, "nb_node_layer": 2, "nb_edge_layer": 2, "output_layers": 2,
          "spatial_channels": 3, "n_interaction_graph_iters": 1}
    n, e = 10, 7  # 14 directed edges
    by_hand = (2 * n * (3 * 8 + 8 * 4)          # node encoder
               + 2 * 14 * (6 * 8 + 8 * 4)       # edge encoder
               + 2 * n * (8 * 8 + 8 * 4)        # node network
               + 2 * 14 * (12 * 8 + 8 * 4)      # edge network
               + 2 * n * (4 * 8 + 8 * 2))       # embedding head
    assert EMBEDDING_IN.forward_flops(hp, n, e) == by_hand
    assert flops.train_flops(EMBEDDING_IN, hp, n, e) == 3 * by_hand


def test_bc_adds_the_hierarchy():
    hp = {"model": "BC-HGNN-GMM", "latent": 4, "hidden": 8, "emb_dim": 2, "nb_node_layer": 2,
          "nb_edge_layer": 2, "output_layers": 2, "spatial_channels": 3,
          "n_interaction_graph_iters": 0, "n_hierarchical_graph_iters": 1,
          "supergraph_sparsity": 2, "bipartitegraph_sparsity": 3}
    n, e, c = 10, 7, 4
    flat = dict(hp, model="Embedding-IN")
    s, b = 2 * c * 2, n * 3
    hier = (2 * c * (4 * 8 + 8 * 2) + 2 * s * (8 * 8 + 8 * 4)
            + 2 * n * (12 * 8 + 8 * 4) + 2 * 14 * (12 * 8 + 8 * 4)
            + 2 * c * (12 * 8 + 8 * 4) + 2 * s * (12 * 8 + 8 * 4)
            + 2 * b * (8 * 8 + 8 * 1))
    assert BC.forward_flops(hp, n, e, c) == EMBEDDING_IN.forward_flops(flat, n, e) + hier


def _plan(n_valid, rows):
    return {"row_ptr": torch.tensor([0] * rows + [n_valid], dtype=torch.int32), "rows": rows}


@pytest.mark.parametrize("op,extra", [("segment_sum", 0), ("segment_wsum", 4)])
def test_segment_sum_bytes_by_hand(op, extra):
    rec = {"d": 16, "elt": 2, **_plan(100, 10)}
    by_hand = 100 * 16 * 2 + 100 * 4 + 11 * 4 + 100 * extra + 10 * 16 * 4
    assert ops.bound_s(op, rec) == pytest.approx(by_hand / peaks.H100["hbm_bytes_per_s"])


def test_segment_min_and_top2_bytes_by_hand():
    bw = peaks.H100["hbm_bytes_per_s"]
    rec = {"d": 1, "elt": 4, **_plan(100, 10)}
    assert ops.bound_s("segment_min", rec) == pytest.approx((800 + 44 + 40) / bw)
    assert ops.bound_s("auction_top2", {"p": 6, "c": 5}) == pytest.approx(
        (6 * 5 * 4 + 5 * 4 + 3 * 6 * 4) / bw)


@pytest.mark.parametrize("scaled,out_elt", [(False, 2), (True, 4)])
def test_scaled_gather_bytes_by_hand(scaled, out_elt):
    rec = {"d": 16, "elt": out_elt, "scaled": scaled, **_plan(100, 10)}
    by_hand = 10 * 16 * 4 + (100 * 4 if scaled else 0) + 100 * 4 + 11 * 4 + 100 * 16 * out_elt
    assert ops.bound_s("scaled_gather", rec) == pytest.approx(
        by_hand / peaks.H100["hbm_bytes_per_s"])


def test_sddmm_bytes_by_hand():
    rec = {"d": 16, "elt": 2, **_plan(100, 10)}
    by_hand = 100 * 16 * 2 + 10 * 16 * 4 + 100 * 4 + 11 * 4 + 100 * 4
    assert ops.bound_s("sddmm", rec) == pytest.approx(by_hand / peaks.H100["hbm_bytes_per_s"])


def test_op_log_sees_the_backwards_kernels():
    """The wrappers see K1, K2, K3 and K4 where autograd's backward calls
    them, and record each call's shapes."""
    from hierarchicalgnn_torch.ops.kernels import sorted_agg

    oplog = ops.OpLog()
    try:
        recv = torch.tensor([0, 0, 1, 2, 2, 2])
        send = torch.tensor([1, 2, 0, 0, 1, 3])
        plan = sorted_agg.build_sorted_plan(send, recv, torch.ones(6, dtype=torch.bool), 4)
        data = torch.randn(6, 8, requires_grad=True)
        w = torch.rand(6, requires_grad=True)
        oplog.active = True
        out = sorted_agg.sorted_aggregate_weighted(data, w, plan)
        out.sum().backward()
        oplog.active = False
    finally:
        oplog.close()
    assert [op for op, _ in oplog.calls] == ["segment_wsum", "scaled_gather", "sddmm"]
    assert all(int(rec["row_ptr"][-1]) == 6 and rec["d"] == 8 for _, rec in oplog.calls)
