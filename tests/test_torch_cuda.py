"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (inside a fixture, at run time) where no
card is present.  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which this file does
not need and a machine with a card may not have.)

Tolerance: the kernels and the plain versions accumulate in f32 in
different orders, so sums agree within 1e-4 of each row's sum of |terms|;
the int32 min is exact.
"""

import pytest
import torch

from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(dev, e, n, seed):
    g = torch.Generator().manual_seed(seed)
    r = torch.randint(0, n, (e,), generator=g)
    r = torch.where(r % 5 == 2, 0, r)  # empty rows, and a heavy row 0
    s = torch.randint(0, n, (e,), generator=g)
    m = torch.rand(e, generator=g) < 0.95
    return sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n), g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,n,d", [(20000, 3000, 256), (5000, 700, 32)])
def test_sum_kernels(dev, dtype, e, n, d):
    plan, g = _plan(dev, e, n, 0)
    data = plan.sort(torch.randn(e, d, generator=g).to(dev, dtype))
    w = plan.sort(torch.rand(e, generator=g).to(dev) + 0.1)
    before = dict(sa.LAUNCHES)
    for got, want, bound in (
            (sa.sorted_aggregate(data, plan), sa.sorted_aggregate_plain(data, plan),
             sa.sorted_aggregate_plain(data.abs(), plan)),
            (sa.sorted_aggregate_weighted(data, w, plan),
             sa.sorted_aggregate_weighted_plain(data, w, plan),
             sa.sorted_aggregate_weighted_plain(data.abs(), w, plan))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert ((got - want).abs() <= 1e-4 * bound + 1e-6).all()
        assert (got[2::5] == 0).all()
    assert sa.LAUNCHES["K1"] == before["K1"] + 1
    assert sa.LAUNCHES["K2"] == before["K2"] + 1


def test_min_kernel(dev):
    plan, g = _plan(dev, 30000, 4000, 1)
    vals = plan.sort(torch.randint(0, 10**6, (30000,), generator=g,
                                   dtype=torch.int32).to(dev))
    got = sa.sorted_segment_min_i32(vals, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, sa.sorted_segment_min_i32_plain(vals, plan))
    assert (got[2::5] == sa.INT32_MAX).all()


def test_kernels_reject_bad_inputs(dev):
    plan, _ = _plan(dev, 1000, 100, 2)
    with pytest.raises(ValueError, match="multiple of"):
        sa.sorted_aggregate(torch.zeros(1000, 10, device=dev), plan)  # f32: 4 | D
    with pytest.raises(ValueError, match="rows"):
        sa.sorted_aggregate(torch.zeros(999, 32, device=dev), plan)
    with pytest.raises(ValueError, match="int32"):
        sa.sorted_segment_min_i32(torch.zeros(1000, device=dev), plan)
