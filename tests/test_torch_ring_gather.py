"""Port parity: the all-gather K8 (its plain version on the CPU), the shard
group's collectives and the flat-IN halo demonstration.

The JAX side runs under ``shard_map`` on the virtual CPU devices of
``conftest.py``, the Pallas ring kernel through its TPU interpreter, as
``tests/test_ring_gather.py`` runs it.  Inputs come from numpy with a seed.
An all-gather copies, so it is compared exactly; sums over ranks and the
halo forward are compared in f32 with the tolerance stated at each test.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hierarchicalgnn_tpu.models.mlp import MLP as JMLP
from hierarchicalgnn_tpu.ops.pallas.ring_gather import ring_all_gather as j_ring_all_gather
from hierarchicalgnn_tpu.parallel import halo as j_halo

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.models.mlp import MLP
from hierarchicalgnn_torch.ops.kernels import ring_gather
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.parallel import comm, halo

from _torch_parity import N, T, to_dict



def _mesh(n_dev):
    return Mesh(np.array(jax.devices()[:n_dev]), ("graph",))


def _over_ranks(fn, n_dev, x, out_specs=P("graph")):
    """``fn`` per device over the row blocks of ``x``; per-device results
    stacked along dim 0."""
    return np.asarray(jax.jit(shard_map(fn, mesh=_mesh(n_dev), in_specs=P("graph"),
                                        out_specs=out_specs, check_vma=False))(x))


@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_plain_all_gather_equals_pallas_ring(n_dev):
    """Exact: K8's plain version gives every rank what the Pallas ring
    (interpreted) gives every device."""
    b, d = 8, 128
    x = np.random.default_rng(n_dev).normal(size=(n_dev * b, d)).astype(np.float32)
    want = _over_ranks(lambda xl: j_ring_all_gather(xl, "graph", n_dev, interpret=True),
                       n_dev, jnp.asarray(x)).reshape(n_dev, n_dev * b, d)
    blocks = [T(x[r * b:(r + 1) * b]) for r in range(n_dev)]
    before = dict(LAUNCHES)
    got = ring_gather.ring_all_gather(blocks)
    assert LAUNCHES == before  # CPU tensors take the plain version
    assert len(got) == n_dev
    for rank in range(n_dev):
        np.testing.assert_array_equal(N(got[rank]), want[rank])


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (6, 16)), (torch.int32, (7,)), (torch.bool, (5,)),
    (torch.float32, (3, 5)), (torch.float32, (0, 4)), (torch.float32, (2, 3, 4))])
def test_all_gather_any_dtype_and_shape(dtype, shape):
    """Exact: no shape rule.  Every dtype and rank of block the sharded path
    gathers (rows, 1-D masks and labels, an empty block) is the
    concatenation along dim 0, through the wrapper and through a group."""
    rng = np.random.default_rng(1)
    blocks = [T(rng.integers(0, 2, shape)).to(dtype) if dtype != torch.float32
              else T(rng.normal(size=shape).astype(np.float32)) for _ in range(3)]
    want = torch.cat(blocks, 0)
    for out in ring_gather.ring_all_gather(blocks):
        assert out.dtype == dtype and torch.equal(out, want)
    for backend in comm.HALO_BACKENDS:
        outs, group = comm.run_sharded(lambda c: c.all_gather(blocks[c.index]), 3, backend)
        assert all(torch.equal(out, want) for out in outs)
        assert group.collectives["all_gather"] == 1


def test_all_gather_refuses_what_it_cannot_take():
    """A block that requires grad gathers under autograd (its rank gets the
    sum of the cotangents of its rows; a block that needs none gets none); a
    device other than CPU or CUDA, or mixed devices, never reach the plain
    version; ragged blocks raise."""
    x = torch.ones(4, 8)
    leaf = x.clone().requires_grad_()
    outs = ring_gather.ring_all_gather([leaf, x])
    assert outs[0].requires_grad and torch.equal(outs[1].detach(), torch.cat([x, x]))
    (grad,) = torch.autograd.grad(outs[0][:4].sum() + 2 * outs[1][:4].sum(), leaf)
    assert torch.equal(grad, torch.full((4, 8), 3.0))
    with torch.no_grad():  # nothing to differentiate: a copy
        assert ring_gather.ring_all_gather([x.clone().requires_grad_(), x])[0].shape == (8, 8)
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported or mixed"):
        ring_gather.ring_all_gather([meta, meta])
    with pytest.raises(ValueError, match="unsupported or mixed"):
        ring_gather.ring_all_gather([x, meta])
    with pytest.raises(ValueError, match="no blocks"):
        ring_gather.ring_all_gather([])
    with pytest.raises(ValueError, match="blocks differ"):
        ring_gather._check_blocks([x, torch.ones(3, 8)])
    with pytest.raises(ValueError, match="contiguous"):
        ring_gather._check_blocks([x.T, x.T])
    with pytest.raises(ValueError, match="ranks"):
        ring_gather._check_blocks([x] * (ring_gather.MAX_RANKS + 1))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_group_reductions_equal_lax(n_dev):
    """``psum``, ``psum_scatter`` and ``pmax`` over a group against the
    ``lax`` collectives under ``shard_map``: pmax exact; the sums within 1e-6
    (f32 added in rank order here, in XLA's order there)."""
    rows, d = 8, 5
    x = np.random.default_rng(7).normal(size=(n_dev * rows, d)).astype(np.float32)
    block = lambda r: T(x[r * rows:(r + 1) * rows])

    want = _over_ranks(lambda xl: jax.lax.psum(xl, "graph"), n_dev, jnp.asarray(x))
    outs, group = comm.run_sharded(lambda c: c.psum(block(c.index)), n_dev)
    np.testing.assert_allclose(N(torch.cat(outs)), want, rtol=0, atol=1e-6)
    assert group.collectives == {"all_gather": 0, "psum": 1, "psum_scatter": 0, "pmax": 0,
                                 "pmin": 0}

    want = _over_ranks(lambda xl: jax.lax.psum_scatter(
        xl, "graph", scatter_dimension=0, tiled=True), n_dev, jnp.asarray(x))
    outs, _ = comm.run_sharded(lambda c: c.psum_scatter(block(c.index)), n_dev)
    assert outs[0].shape == (rows // n_dev, d)
    np.testing.assert_allclose(N(torch.cat(outs)), want, rtol=0, atol=1e-6)

    want = _over_ranks(lambda xl: jax.lax.pmax(xl, "graph"), n_dev, jnp.asarray(x))
    outs, _ = comm.run_sharded(lambda c: c.pmax(block(c.index)), n_dev)
    np.testing.assert_array_equal(N(torch.cat(outs)), want)


def test_psum_adds_bf16_partials_in_f32():
    """Exact: bf16 partials are added in f32 and rounded once.  256 + 1 + 1
    is 258 that way; added in bf16 (8 bits of mantissa) it would stay 256."""
    parts = [torch.full((2,), v, dtype=torch.bfloat16) for v in (256.0, 1.0, 1.0)]
    outs, _ = comm.run_sharded(lambda c: c.psum(parts[c.index]), 3)
    assert outs[0].dtype == torch.bfloat16 and outs[0].tolist() == [258.0, 258.0]
    assert (parts[0] + parts[1] + parts[2]).tolist() == [256.0, 256.0]
    ints, _ = comm.run_sharded(lambda c: c.psum(torch.tensor([c.index + 1])), 3)
    assert ints[0].dtype == torch.int64 and ints[0].tolist() == [6]


def test_run_sharded_ranks_modes_and_errors():
    """The ranks are threads of their own with the caller's grad mode and a
    Python-int index; one rank's error releases the others from their
    rendezvous and is raised to the caller; ranks that meet in different
    collectives raise; a bad backend raises."""
    seen = {}

    def body(c):
        seen[c.index] = (threading.current_thread().name, torch.is_grad_enabled(), c.n_parts)
        return c.all_gather(torch.tensor([c.index]))

    with torch.no_grad():
        outs, _ = comm.run_sharded(body, 4)
    assert all(out.tolist() == [0, 1, 2, 3] for out in outs)
    assert seen == {r: (f"{comm.THREAD_PREFIX}{r}", False, 4) for r in range(4)}
    assert comm.run_sharded(lambda c: torch.is_grad_enabled(), 2)[0] == [True, True]
    one, _ = comm.run_sharded(lambda c: c.psum_scatter(torch.ones(3)), 1)
    assert one[0].tolist() == [1.0, 1.0, 1.0]

    def failing(c):
        if c.index == 2:
            raise KeyError("rank 2 fails")
        return c.all_gather(torch.ones(1))

    with pytest.raises(KeyError, match="rank 2 fails"):
        comm.run_sharded(failing, 4)
    with pytest.raises(RuntimeError, match="different collectives"):
        comm.run_sharded(lambda c: c.psum(torch.ones(1)) if c.index else
                         c.pmax(torch.ones(1)), 2)
    with pytest.raises(RuntimeError, match="same collectives"):  # rank 0 returns at once
        comm.run_sharded(lambda c: c.psum(torch.ones(1)) if c.index else None, 3)
    with pytest.raises(ValueError, match="do not split"):
        comm.run_sharded(lambda c: c.psum_scatter(torch.ones(3)), 2)
    with pytest.raises(ValueError, match="halo_backend"):
        comm.run_sharded(lambda c: None, 2, halo_backend="nccl")


def test_group_stress_more_ranks_than_cores():
    """16 ranks, 300 rendezvous each, with the interpreter switching threads
    as often as it can: every collective's result is the right one for its
    round (a rank that picked up another round's result, or a lost update of
    the counts, would break the sums)."""
    n_ranks, rounds = 16, 150
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(c):
            seen = []
            for i in range(rounds):
                total = c.psum(torch.tensor([c.index + i]))
                every = c.all_gather(torch.tensor([c.index * 1000 + i]))
                seen.append((int(total), every.tolist()))
            return seen

        outs, group = comm.run_sharded(body, n_ranks)
    finally:
        sys.setswitchinterval(interval)
    want = [(sum(range(n_ranks)) + n_ranks * i, [r * 1000 + i for r in range(n_ranks)])
            for i in range(rounds)]
    assert all(out == want for out in outs)
    assert group.collectives == {"all_gather": rounds, "psum": rounds, "psum_scatter": 0,
                                 "pmax": 0, "pmin": 0}
    assert not [t for t in threading.enumerate() if t.name.startswith(comm.THREAD_PREFIX)]


# ---------------------------------------------------------------------------
# The flat-IN halo demonstration
# ---------------------------------------------------------------------------

N_PARTS, N_NODES, N_EDGES, LATENT, ITERATIONS = 4, 64, 200, 16, 2


@pytest.fixture(scope="module")
def flat_in():
    """The demonstration's graph, and its four MLPs in both packages with the
    same numpy-seeded weights."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(N_NODES, 3)).astype(np.float32)
    senders = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    receivers = rng.integers(0, N_NODES, N_EDGES).astype(np.int32)
    mask = rng.random(N_EDGES) < 0.9
    names = ("node_enc", "edge_enc", "node_net", "edge_net")
    sizes = (3, 6, 2 * LATENT, 3 * LATENT)
    acts = ("GELU", "GELU", "GELU", "Tanh")
    j_mlps = tuple(JMLP(hidden_size=32, output_size=LATENT, hidden_layers=2,
                        layer_norm=True, output_activation=act) for act in acts)
    params, mlps = {}, []
    for name, size, act, j_mlp in zip(names, sizes, acts, j_mlps):
        shapes = jax.eval_shape(lambda m=j_mlp, s=size: m.init(
            jax.random.key(0), jnp.zeros((1, s))))["params"]
        filled = jax.tree.map(
            lambda leaf: (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])
                          ).astype(np.float32), shapes)
        params[name] = jax.tree.map(jnp.asarray, filled)
        # a Linear draws its default init from torch's global generator, which
        # other test files seed and rely on: build on a fork of it
        with torch.random.fork_rng(devices=[]):
            mlp = MLP(size, 32, LATENT, 2, output_activation=act, layer_norm=True)
        mlps.append(convert.load_jax_mlp(mlp, to_dict(filled)))
    return x, senders, receivers, mask, j_mlps, params, tuple(mlps)


def test_partition_by_receiver_equals_jax(flat_in):
    """Exact: the host-side plan is the JAX function's."""
    _, senders, receivers, mask, *_ = flat_in
    got = halo.partition_edges_by_receiver(senders, receivers, mask, N_NODES, N_PARTS)
    want = j_halo.partition_edges_by_receiver(senders, receivers, mask, N_NODES, N_PARTS)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        halo.partition_edges_by_receiver(senders, receivers, mask, N_NODES, 3)


@pytest.mark.parametrize("rdma", [False, True], ids=["cat", "rdma"])
def test_halo_flat_in_equals_jax_and_unsharded(flat_in, rdma):
    """f32, within 1e-5: the port's halo forward over 4 ranks against the JAX
    package's ``make_halo_flat_forward`` (the Pallas ring interpreted when
    ``rdma``) and against the port's own unsharded step.  The partitioned
    segment sums add each receiver's edges in the same order, so only the
    MLPs' matmuls differ between the packages."""
    x, senders, receivers, mask, j_mlps, params, mlps = flat_in
    s_p, r_p, m_p = halo.partition_edges_by_receiver(senders, receivers, mask, N_NODES,
                                                     N_PARTS)
    j_forward = j_halo.make_halo_flat_forward(
        j_halo.make_halo_flat_in(j_mlps, iterations=ITERATIONS), _mesh(N_PARTS),
        rdma_gather=rdma)
    want = np.asarray(j_forward(params, jnp.asarray(x), jnp.asarray(s_p.reshape(-1)),
                                jnp.asarray(r_p.reshape(-1)), jnp.asarray(m_p.reshape(-1))))

    forward = halo.make_halo_flat_forward(halo.make_halo_flat_in(mlps, ITERATIONS),
                                          N_PARTS, rdma_gather=rdma)
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = forward(T(x), T(s_p), T(r_p), T(m_p))
        own = halo.flat_in_reference_step(mlps, T(x), T(senders).long(),
                                          T(receivers).long(), T(mask), N_NODES, ITERATIONS)
    assert LAUNCHES == before  # CPU tensors take the plain version
    assert forward.collectives["all_gather"] == 1 + ITERATIONS
    assert got.shape == (N_NODES, LATENT)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(got), N(own), rtol=0, atol=1e-5)
    assert np.abs(N(got)).max() > 0.1  # not a trivial output
