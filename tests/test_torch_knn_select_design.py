"""KNN1's selection (``csrc/knn_select.cu``), the kNN's first k of each row.

On the CPU: the kernel's walk written out in numpy, the same steps as the
kernel -- the keys (``d2``'s bits, formed in float32 one operation at a
time, NaN one above +inf), the 64-bit composite ``(key << B) | j``, the
radix select's 11-bit digits from the top with the wanted rank carried down,
its stop where a bin holds exactly the rank still wanted, the threshold and
the collection of every composite up to it, ranked -- checked against the
plain version, ``torch.sort(stable=True)``'s first k, on ties, +inf, NaN, k
equal to P and rows with fewer than k finite candidates, at Embedding-IN's
and BC's shapes.  Also the schedule: staging and shared memory for which
(P, k).

On the card: ``tests/test_torch_cuda.py`` holds KNN1 against the plain
version through ``knn`` and ``knn_graph``.
"""

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.ops.kernels import knn_select as ks

INF_KEY, NAN_KEY = 0x7F800000, 0x7F800001


def keys_of(dots, sq_q, sq_p, valid):
    """The kernel's keys: ``(sq_q + sq_p) - 2 dots`` rounded one operation at
    a time in float32, clamped at 0, +inf where masked, every NaN one above."""
    with np.errstate(invalid="ignore", over="ignore"):
        d2 = (sq_q[:, None] + sq_p[None, :]) - np.float32(2) * dots
    d2 = np.where(d2 < 0, np.float32(0), d2).astype(np.float32)
    key = d2.view(np.uint32).astype(np.uint64)
    key = np.where(np.isnan(d2), NAN_KEY, key)
    return np.where(valid[None, :], key, INF_KEY).astype(np.uint64)


def value_of(key):
    v = np.asarray(key, np.uint32).view(np.float32).copy()
    v[key == NAN_KEY] = np.nan
    return v


def radix_walk(keys, k, idx_bits):
    """The radix select on one row of keys: returns the k composites in
    order and the number of histogram passes."""
    p = keys.shape[0]
    c = (keys << np.uint64(idx_bits)) | np.arange(p, dtype=np.uint64)
    total = ks.KEY_BITS + idx_bits
    shift = total - ks.DIGIT_BITS
    n_bins = ks.BINS
    # pass 0, as the keys are made: +inf and NaN share one bin
    hist = np.bincount((keys >> np.uint64(ks.KEY_BITS - ks.DIGIT_BITS)).astype(np.int64),
                       minlength=n_bins)
    prefix = mask = 0
    want, passes = k, 1
    while True:
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, want))  # the least b with cum[b] >= want
        below, count = int(cum[b] - hist[b]), int(hist[b])
        prefix |= b << shift
        mask |= (n_bins - 1) << shift
        want -= below
        assert 1 <= want <= count
        if count == want or shift == 0:
            break
        nxt = shift - ks.DIGIT_BITS if shift > ks.DIGIT_BITS else 0
        n_bins, shift = 1 << (shift - nxt), nxt
        match = (c & np.uint64(mask)) == np.uint64(prefix)
        hist = np.bincount(((c[match] >> np.uint64(shift)) & np.uint64(n_bins - 1)).astype(
            np.int64), minlength=n_bins)
        passes += 1
    threshold = prefix | (~mask & ((1 << total) - 1))
    chosen = c[c <= np.uint64(threshold)]  # the collection, in any order
    assert chosen.shape == (k,)
    rank = (chosen[None, :] < chosen[:, None]).sum(1)
    out = np.empty(k, np.uint64)
    out[rank] = chosen
    return out, passes


def _problem(case, r, p, seed):
    """Rows of dots and norms as ``knn``'s blocks give them: embeddings of
    8 features (``ties``: quantised, with duplicated points), and masks."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(p, 8)).astype(np.float32)
    q = rng.normal(size=(r, 8)).astype(np.float32)
    valid = np.ones(p, bool)
    if case == "ties":
        pts = np.round(pts * 2) / 2
        pts[1::3] = pts[0:p - 1:3][:len(pts[1::3])]
        q = pts[rng.integers(0, p, r)]
    elif case == "masked":
        valid = rng.random(p) < 0.7
    elif case == "few_finite":  # fewer than k finite candidates: +inf ties decide
        valid = np.zeros(p, bool)
        valid[rng.choice(p, size=max(1, p // 40), replace=False)] = True
    elif case == "none_valid":
        valid[:] = False
    elif case == "nan":
        pts[rng.integers(0, p, max(1, p // 50))] = np.nan
        valid = rng.random(p) < 0.9
    dots = (q.astype(np.float64) @ pts.astype(np.float64).T).astype(np.float32)
    sq_q = np.square(q).sum(-1, dtype=np.float32)
    sq_p = np.square(pts).sum(-1, dtype=np.float32)
    return dots, sq_q, sq_p, valid


def _plain(dots, sq_q, sq_p, valid, k):
    d2, idx = ks.knn_select_plain(torch.from_numpy(dots), torch.from_numpy(sq_q)[:, None],
                                  torch.from_numpy(sq_p), torch.from_numpy(valid), k)
    return d2.numpy(), idx.numpy()


def _check(got, idx_bits, want):
    d2, idx = want
    np.testing.assert_array_equal(got & np.uint64((1 << idx_bits) - 1), idx)
    v = value_of(got >> np.uint64(idx_bits))
    np.testing.assert_array_equal(v.view(np.uint32)[~np.isnan(v)],
                                  d2.view(np.uint32)[~np.isnan(v)])
    assert np.isnan(d2[np.isnan(v)]).all()


CASES = ["random", "ties", "masked", "few_finite", "none_valid", "nan"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p,k", [(2048, 100), (97, 97), (300, 17), (4099, 40), (3072, 10),
                                 (3071, 5), (300, 8), (97, 16), (16, 16)])
def test_radix_walk_matches_the_stable_sort(case, p, k):
    """The walk gives the stable sort's first k, bit for bit, ties by index
    (the index digits of the composite), +inf and NaN last: at k 100 and at
    BC's k 5 and 10 over 3072 cluster means, on short rows and on k = P."""
    dots, sq_q, sq_p, valid = _problem(case, 6, p, seed=p + k)
    keys = keys_of(dots, sq_q, sq_p, valid)
    cut = ks.knn_schedule(p, k)
    want_d2, want_idx = _plain(dots, sq_q, sq_p, valid, k)
    passes = []
    for i in range(dots.shape[0]):
        got, n = radix_walk(keys[i], k, cut.idx_bits)
        _check(got, cut.idx_bits, (want_d2[i], want_idx[i]))
        passes.append(n)
    if case in ("random", "masked"):  # the values fix the k-th: the index digits are never read
        assert max(passes) <= 3, passes


@pytest.mark.parametrize("p,k,want", [
    (24576, 100, ks.KnnSchedule(True, 15, 4 * 2048 + 800 + 4 * 24576)),
    (3072, 5, ks.KnnSchedule(True, 12, 4 * 2048 + 40 + 4 * 3072)),
    (3072, 10, ks.KnnSchedule(True, 12, 4 * 2048 + 80 + 4 * 3072)),
    (3072, 8, ks.KnnSchedule(True, 12, 4 * 2048 + 64 + 4 * 3072)),
    (97, 97, ks.KnnSchedule(True, 7, 4 * 2048 + 8 * 97 + 4 * 97)),
    (8192, 16, ks.KnnSchedule(True, 13, 4 * 2048 + 128 + 4 * 8192)),
    (8193, 16, ks.KnnSchedule(True, 14, 4 * 2048 + 128 + 4 * 8193)),
    (3072, 17, ks.KnnSchedule(True, 12, 4 * 2048 + 136 + 4 * 3072)),
    (1, 1, ks.KnnSchedule(True, 1, 4 * 2048 + 8 + 4)),
    (54000, 100, ks.KnnSchedule(True, 16, 4 * 2048 + 800 + 4 * 54000)),
    (60000, 100, ks.KnnSchedule(False, 16, 4 * 2048 + 800)),
])
def test_knn_schedule(p, k, want):
    """The main path's shapes: Embedding-IN's mining (P 24576, k 100) with its
    keys staged (two rows an SM); BC's super graph (k 10) and bipartite graph
    (k 5) and Embedding-HGNN-GMM's k 8 at P 3072; k equal to P; the keys
    recomputed where they do not fit."""
    cut = ks.knn_schedule(p, k)
    assert cut == want
    assert cut.smem <= ks.SMEM_BYTES
    assert (1 << cut.idx_bits) >= p and ks.KEY_BITS + cut.idx_bits <= 64


def test_knn_schedule_refuses():
    assert ks.K_MAX == 27904  # its k composites beside the histogram
    for p, k in ((100, 0), (100, 101), (50000, ks.K_MAX + 1)):
        with pytest.raises(ValueError):
            ks.knn_schedule(p, k)


def test_cpu_path_is_the_plain_version():
    """On CPU tensors the wrapper is the plain version: the four passes and
    the stable sort's first k, and no launch."""
    dots, sq_q, sq_p, valid = _problem("ties", 5, 200, seed=3)
    before = dict(ks.LAUNCHES)
    args = (torch.from_numpy(dots), torch.from_numpy(sq_q)[:, None], torch.from_numpy(sq_p),
            torch.from_numpy(valid))
    got = ks.knn_select(*args, 50)
    want = ks.knn_select_plain(*args, 50)
    assert ks.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
