"""The port's HDBSCAN (``evaluation/hdbscan.py``) and its kernels HD1/HD2
(``ops/kernels/hdbscan.py``) against scikit-learn 1.9.0.

Everything is exact: the port reproduces sklearn's float64 arithmetic and
Prim's order, so the core distances are equal bit for bit, the MST's edge
list element for element in order, and the labels array-equal, also on
inputs built to tie.  On the CPU the wrappers take their plain versions;
the ``cuda`` cases hold the kernels against those on the card:

    python -m pytest tests/test_torch_hdbscan.py -q --noconftest -m cuda
"""

import warnings

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.evaluation.hdbscan import hdbscan_labels, labels_from_mst
from hierarchicalgnn_torch.ops.kernels import hdbscan as hd
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES


def _blobs(rng, n, d, centres, spread=0.05):
    """Unit vectors scattered around ``centres`` random unit centres, as the
    embedding models' outputs are."""
    c = rng.normal(size=(centres, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, centres, n)] + spread * rng.normal(size=(n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "quantised ties":  # coordinates on a 0.5 grid: many equal distances
        return np.round(rng.uniform(0, 6, (600, 8)) * 2) / 2
    if name.startswith("unit blobs D"):
        d = int(name.split("D")[1])
        return _blobs(rng, 700, d, 50)
    if name == "N = m":
        return rng.normal(size=(5, 8))
    if name == "identical points":
        return np.ones((40, 8))
    if name == "two far groups":
        return np.concatenate([rng.normal(size=(30, 3)), 100 + rng.normal(size=(30, 3))])
    raise KeyError(name)


CASES = ["quantised ties", "unit blobs D2", "unit blobs D8", "unit blobs D12", "N = m",
         "identical points", "two far groups"]


def _sklearn_labels(x, m):
    cluster = pytest.importorskip("sklearn.cluster")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return cluster.HDBSCAN(min_cluster_size=m, copy=True).fit_predict(x)


def _sklearn_core(x, k):
    """sklearn's core distances as HDBSCAN computes them
    (``_hdbscan_prims``: a KD-tree query that includes the point itself)."""
    neighbors = pytest.importorskip("sklearn.neighbors")
    nn = neighbors.NearestNeighbors(n_neighbors=k, algorithm="kd_tree").fit(x)
    return np.ascontiguousarray(nn.kneighbors(x)[0][:, -1])


@pytest.mark.parametrize("name", CASES)
def test_core_distances_plain_match_sklearn(name):
    """HD1's plain version equals sklearn's k-th neighbour distance bit for
    bit (the k-th smallest squared distance in feature order, then a
    correctly rounded sqrt)."""
    x = _case(name)
    k = min(5, len(x))
    got = hd.core_distances(torch.from_numpy(x), k).numpy()
    want = _sklearn_core(x, k)
    assert got.view(np.int64).tolist() == want.view(np.int64).tolist()


@pytest.mark.parametrize("name", CASES)
def test_prim_mst_plain_matches_sklearn(name):
    """HD2's plain version gives the edge list of sklearn's
    ``mst_from_data_matrix`` element for element, in Prim's order.  That
    function is a private sklearn API (``sklearn.cluster._hdbscan._linkage``),
    the one ``HDBSCAN`` calls."""
    linkage = pytest.importorskip("sklearn.cluster._hdbscan._linkage")
    metrics = pytest.importorskip("sklearn.metrics")
    x = np.ascontiguousarray(_case(name))
    core = _sklearn_core(x, min(5, len(x)))
    src, dst, dist = hd.prim_mst(torch.from_numpy(x), torch.from_numpy(core))
    want = linkage.mst_from_data_matrix(x, core, metrics.DistanceMetric.get_metric("euclidean"))
    np.testing.assert_array_equal(src.numpy(), want["current_node"])
    np.testing.assert_array_equal(dst.numpy(), want["next_node"])
    assert dist.numpy().view(np.int64).tolist() == want["distance"].view(np.int64).tolist()


@pytest.mark.parametrize("name,m", [(name, m) for name in CASES for m in (5, 3, 10)
                                    if name != "N = m" or m == 5])
def test_hdbscan_labels_match_sklearn(name, m):
    """``hdbscan_labels`` equals ``HDBSCAN(min_cluster_size=m).fit_predict``
    element for element; the CPU path launches no kernel."""
    x = _case(name)
    before = dict(LAUNCHES)
    got = hdbscan_labels(torch.from_numpy(x), m)
    assert LAUNCHES == before
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _sklearn_labels(x, m))


def test_labels_are_not_trivial():
    """The blob and tie cases exercise real selection: several clusters
    and some noise (so the equality above is not all -1 against all -1)."""
    noise = 0
    for name in ("quantised ties", "unit blobs D8", "two far groups"):
        labels = hdbscan_labels(torch.from_numpy(_case(name)), 5)
        assert labels.max() >= 1, name
        noise += int((labels == -1).sum())
    assert noise > 0


def test_hdbscan_labels_match_sklearn_on_small_quantised_inputs():
    """Small point sets on an integer grid (many exact ties, repeated
    points, one-feature lines) give sklearn's labels exactly."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    hnp = pytest.importorskip("hypothesis.extra.numpy")

    @hypothesis.settings(max_examples=40, deadline=None, database=None)
    @hypothesis.given(hnp.arrays(np.int64, st.tuples(st.integers(5, 60), st.integers(1, 4)),
                                 elements=st.integers(0, 4)),
                      st.integers(2, 6))
    def check(grid, m):
        x = grid.astype(np.float64) / 2
        if len(x) < m:
            m = len(x)
        np.testing.assert_array_equal(hdbscan_labels(torch.from_numpy(x), m),
                                      _sklearn_labels(x, m))

    check()


def test_hdbscan_labels_count_host_syncs():
    """``stats["host_syncs"]`` counts the finite check and the one copy of
    the edges to the host."""
    stats = {}
    hdbscan_labels(torch.from_numpy(_case("unit blobs D8")), 5, stats=stats)
    assert stats == {"host_syncs": 2}


def test_host_tree_matches_sklearn_tree_to_labels():
    """The host side alone, fed sklearn's own MST: ``labels_from_mst``
    equals ``_process_mst`` + ``tree_to_labels``."""
    hdb = pytest.importorskip("sklearn.cluster._hdbscan.hdbscan")
    tree = pytest.importorskip("sklearn.cluster._hdbscan._tree")
    linkage = pytest.importorskip("sklearn.cluster._hdbscan._linkage")
    metrics = pytest.importorskip("sklearn.metrics")
    x = _case("quantised ties")
    core = _sklearn_core(x, 5)
    mst = linkage.mst_from_data_matrix(x, core, metrics.DistanceMetric.get_metric("euclidean"))
    want, _ = tree.tree_to_labels(hdb._process_mst(mst.copy()), 5, "eom")
    got = labels_from_mst(mst["current_node"], mst["next_node"], mst["distance"], 5)
    np.testing.assert_array_equal(got, want)


def test_hdbscan_labels_refuse_bad_input():
    """Non-finite rows, another type, too few points or too small a cluster
    size raise."""
    x = torch.from_numpy(_case("unit blobs D8"))
    bad = x.clone()
    bad[3, 2] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        hdbscan_labels(bad, 5)
    with pytest.raises(ValueError, match="float64"):
        hdbscan_labels(x.float(), 5)
    with pytest.raises(ValueError, match="more than one"):
        hdbscan_labels(x[:1], 5)
    with pytest.raises(ValueError, match="min_samples"):
        hdbscan_labels(x[:4], 5)
    with pytest.raises(ValueError, match="at least 2"):
        hdbscan_labels(x, 1)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        hd.core_distances(x.to("meta"), 5)


def test_mst_schedule_covers_the_points():
    """HD2's cut: every point in one block, at most one block a SM, a
    block's share within shared memory; a share too large raises."""
    for n, d, sms in ((21600, 8, 132), (5, 8, 132), (1000, 12, 132), (300000, 8, 132),
                      (2, 1, 1)):
        cut = hd.mst_schedule(n, d, sms)
        assert 1 <= cut.grid <= sms and cut.grid * cut.points >= n
        assert (cut.grid - 1) * cut.points < n  # no block without points
        assert cut.smem <= hd.SMEM_BYTES and cut.smem % 16 == 0
    assert hd.mst_schedule(21600, 8, 132).grid == 85
    with pytest.raises(ValueError, match="shared memory"):
        hd.mst_schedule(2_000_000, 8, 132)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("d", [1, 3, 8, 12, 64])
def test_mst_cluster_schedule_capacity(cluster, d):
    """HD2's cluster route: every point in one CTA (a small N leaves CTAs
    empty: the cluster's size is the card's), at most MAX_PER_THREAD
    points a thread, a CTA's share within shared memory; the capacity is
    the largest N that fits, and one more point does not."""
    cap = hd.mst_cluster_capacity(d, cluster)
    assert 0 < cap <= cluster * hd.CLUSTER_THREADS * hd.MAX_PER_THREAD
    for n in (1, 2, cluster, cluster + 1, 21183, cap - 1, cap):
        if n > cap:
            continue
        cut = hd.mst_cluster_schedule(n, d, cluster)
        assert cut.cluster == cluster and cut.points * cluster >= n
        assert (cut.points - 1) * cluster < n  # the fewest points a CTA that hold N
        assert cut.per_thread == -(-cut.points // hd.CLUSTER_THREADS) <= hd.MAX_PER_THREAD
        assert cut.smem <= hd.SMEM_BYTES and cut.smem % 16 == 0
        # the coordinates (8 D bytes a point) and two parities of every CTA's candidate
        assert cut.smem >= 8 * d * cut.points + 16 * cluster * (3 + d)
    assert hd.mst_cluster_schedule(cap + 1, d, cluster) is None
    assert hd.mst_cluster_schedule(cap + cluster, d, cluster) is None


def test_mst_cluster_schedule_at_the_served_sizes():
    """The served event (N 21183, D 8) takes 2 points a thread over 16 CTAs,
    3 over 8; 8 CTAs hold the configured node capacity (24576) at D 8; 16
    hold less than 16 x 1024 x 4 points at D 8 (shared memory bounds it)."""
    assert hd.mst_cluster_schedule(21183, 8, 16).per_thread == 2
    assert hd.mst_cluster_schedule(21183, 8, 8).per_thread == 3
    assert hd.mst_cluster_schedule(24576, 8, 8) is not None
    assert 24576 <= hd.mst_cluster_capacity(8, 8) < hd.mst_cluster_capacity(8, 16) < 65536
    assert hd.mst_cluster_capacity(1, 16) == 16 * 1024 * 4  # points a thread bound it at D 1


@pytest.mark.parametrize("cluster", [16, 8])
def test_mst_route_choice(cluster):
    """``prim_mst``'s route by size: the cluster at and below its capacity,
    the cooperative grid above it, and a raise where neither fits."""
    for d in (1, 8, 12):
        cap = hd.mst_cluster_capacity(d, cluster)
        for n in (2, cap - 1, cap):
            assert isinstance(hd.mst_route(n, d, cluster, 132), hd.MstClusterSchedule), (d, n)
        for n in (cap + 1, cap + 2 * cluster, 80000):
            cut = hd.mst_route(n, d, cluster, 132)
            assert isinstance(cut, hd.MstSchedule) and cut == hd.mst_schedule(n, d, 132), (d, n)
    with pytest.raises(ValueError, match="shared memory"):
        hd.mst_route(2_000_000, 8, cluster, 132)
    with pytest.raises(ValueError, match="shared memory"):
        hd.mst_route(600_000, 64, cluster, 132)


def test_core_schedule_fills_the_card():
    """HD1's grid: query blocks of CORE_THREADS x CORE_Q queries; at the
    served size enough candidate slices for about 32 warps an SM; one slice
    where the candidates are one tile; a given slice count is taken as it
    is, and one outside [1, N] raises."""
    rows = hd.CORE_THREADS * hd.CORE_Q
    cut = hd.core_schedule(21183, 132)
    assert cut.blocks == -(-21183 // rows) == 83
    assert cut.slices == 13
    warps = cut.blocks * cut.slices * hd.CORE_THREADS // 32
    assert warps >= 132 * hd.CORE_WARPS_PER_SM > (cut.blocks * (cut.slices - 1) * hd.CORE_THREADS
                                                   // 32)
    assert hd.core_schedule(40, 132) == hd.CoreSchedule(blocks=1, slices=1)
    assert hd.core_schedule(200, 132).slices == 4  # at most one slice a tile of 64 candidates
    assert hd.core_schedule(21183, 132, slices=7) == hd.CoreSchedule(blocks=83, slices=7)
    for bad in (0, 41, 70000):
        with pytest.raises(ValueError, match="slices"):
            hd.core_schedule(40 if bad < 1000 else 100000, 132, slices=bad)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_core_distances_kernel_matches_plain(dev, name):
    """HD1 on the card equals its plain version bit for bit."""
    x = torch.from_numpy(_case(name)).to(dev)
    k = min(5, len(x))
    before = LAUNCHES["HD1"]
    got = hd.core_distances(x, k)
    torch.cuda.synchronize()
    assert LAUNCHES["HD1"] == before + 1
    assert torch.equal(got.view(torch.int64), hd.core_distances_plain(x, k).view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 7, 40])
@pytest.mark.parametrize("name", ["quantised ties", "unit blobs D12", "identical points"])
def test_core_distances_kernel_matches_plain_at_any_slices(dev, name, slices):
    """HD1's result does not depend on how many slices split the
    candidates: bit for bit with the plain version at each."""
    x = torch.from_numpy(_case(name)).to(dev)
    got = hd.core_distances(x, 5, slices=slices)
    assert torch.equal(got.view(torch.int64), hd.core_distances_plain(x, 5).view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cluster", "cooperative"])
@pytest.mark.parametrize("name", CASES)
def test_prim_mst_kernel_matches_plain(dev, name, route):
    """HD2 on the card, by either route, gives its plain version's edge list
    element for element (src, dst and the distances' bits), in order;
    ``prim_mst`` takes the cluster route at these sizes."""
    x = torch.from_numpy(_case(name)).to(dev)
    core = hd.core_distances_plain(x, min(5, len(x)))
    before = dict(LAUNCHES)
    got = hd.prim_mst(x, core) if route == "cluster" else hd.prim_mst_cooperative(x, core)
    torch.cuda.synchronize()
    key = {"cluster": "HD2_cluster", "cooperative": "HD2_coop"}[route]
    assert {k: LAUNCHES[k] - before[k] for k in ("HD2", "HD2_cluster", "HD2_coop")} == {
        "HD2": 1, "HD2_cluster": 0, "HD2_coop": 0, key: 1}
    want = hd.prim_mst_plain(x, core)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int64), want[2].view(torch.int64))


@pytest.mark.cuda
def test_prim_mst_above_the_cluster_capacity_takes_the_cooperative_route(dev):
    """N above the cluster's capacity goes to the cooperative kernel, and
    its tree holds the invariants that are cheap to check: N - 1 edges,
    every node but 0 reached once, each weight max(core[src], core[dst],
    sqrt(d2(src, dst))) bit for bit."""
    n = hd.mst_cluster_capacity(8, hd.mst_cluster_size(dev.index or 0)[0]) + 1
    x = torch.from_numpy(_blobs(np.random.default_rng(3), n, 8, 2000)).to(dev)
    core = hd.core_distances(x, 5)
    before = dict(LAUNCHES)
    src, dst, dist = hd.prim_mst(x, core)
    torch.cuda.synchronize()
    assert LAUNCHES["HD2_coop"] == before["HD2_coop"] + 1
    assert LAUNCHES["HD2_cluster"] == before["HD2_cluster"]
    assert src.shape == dst.shape == dist.shape == (n - 1,)
    assert torch.equal(torch.sort(dst).values, torch.arange(1, n, device=dev))
    acc = torch.zeros(n - 1, dtype=torch.float64, device=dev)
    for f in range(8):
        t = x[src, f] - x[dst, f]
        acc = acc + t * t
    want = torch.maximum(torch.maximum(core[src], core[dst]), hd.sqrt_rn(acc))
    assert torch.equal(dist.view(torch.int64), want.view(torch.int64))
