"""Structure of the port: import purity, device policy, kernel dispatch."""

import dataclasses
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models.models import build_model
from hierarchicalgnn_torch.ops.kernels import (
    build, hdbscan, ring_gather, sddmm, segment_gather, sorted_agg, top2)
from hierarchicalgnn_torch.parallel import comm, distributed, graph_shard, halo, mesh
from hierarchicalgnn_torch.utils.config import load_config

import chip_smoke
from _torch_parity import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PURITY = """
import importlib, pkgutil, sys
import hierarchicalgnn_torch, chip_smoke
for m in pkgutil.walk_packages(hierarchicalgnn_torch.__path__, "hierarchicalgnn_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "hierarchicalgnn_tpu", "sklearn"))
print(len([n for n in sys.modules if n.startswith("hierarchicalgnn_torch.")]))
sys.exit(f"loaded: {bad}" if bad else 0)
"""


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, import without JAX, flax,
    the JAX package or scikit-learn (in a fresh interpreter)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the training modules, the registry, the gather kernels' and the
    # parallel package among them
    assert int(out.stdout.split()[-1]) >= 37


def test_building_a_model_leaves_the_global_generator_alone():
    """A model's weights come from its seed alone.  The layers' default init
    draws from torch's global generator; ``build_model`` runs it on a fork, so
    a program (or a test file that seeded the generator for itself) finds the
    generator as it left it.  The weights do not depend on its state."""
    hparams = load_config("bc_hgnn_gmm", SMALL)
    with torch.random.fork_rng(devices=[]):  # this test's own seeding stays inside
        torch.manual_seed(123)
        state = torch.get_rng_state()
        first = build_model(hparams).state_dict()
        assert torch.equal(torch.get_rng_state(), state)
        torch.manual_seed(456)
        second = build_model(hparams).state_dict()
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_parallel_modules_import_no_jax():
    """The sharded path's modules are the port's own: torch and the port,
    never jax, flax or the JAX package, in their source."""
    for module in (ring_gather, comm, halo, graph_shard, distributed, mesh):
        text = inspect.getsource(module)
        imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
        assert imports, module.__name__
        for name in imports:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "hierarchicalgnn_tpu"), (
                module.__name__, name)


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert inspect.signature(InferenceEngine).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("bc_hgnn_gmm", "ec_in", "embedding_in", "embedding_hgnn_gmm", "gmrt"):
        hp = load_config(name, SMALL)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(hp, build_model(hp))
        InferenceEngine(hp, build_model(hp), device="cpu")


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: a
    device other than CPU/CUDA, or mixed devices, raise."""
    s = torch.tensor([0, 1, 1])
    plan = sorted_agg.build_sorted_plan(s, s, torch.ones(3, dtype=torch.bool), 2)
    meta = torch.empty((3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sorted_agg.sorted_aggregate(meta, plan)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sorted_agg.sorted_aggregate_weighted(torch.ones(3, 8), meta[:, 0], plan)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sorted_agg.sorted_segment_min_i32(meta[:, 0].int(), plan)
    rows = torch.ones(2, 8)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sddmm.sorted_sddmm(meta, rows, plan)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sddmm.scaled_gather(None, meta[:2], plan)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        sddmm.scaled_gather(meta[:, 0], rows, plan)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        top2.row_top2(meta, torch.ones(8))
    layout = segment_gather.make_csr_layout(s, torch.ones(3, dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        segment_gather.csr_segment_sum(meta, layout)
    with pytest.raises(ValueError, match="unsupported or mixed"):
        segment_gather.csr_segment_sum(torch.ones(3, 8), dataclasses.replace(
            layout, perm=layout.perm.to("meta")))
    from hierarchicalgnn_torch.ops.segment import make_aggregator
    with pytest.raises(ValueError, match="unsupported or mixed"):
        make_aggregator(s, torch.ones(3, dtype=torch.bool), 2, use_pallas=True)(meta)


def test_plan_csr_rows():
    """row_ptr delimits each receiver's edges in the sorted order; invalid
    edges sit after the last row."""
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.integers(0, 50, 400))
    m = torch.from_numpy(rng.random(400) < 0.8)
    plan = sorted_agg.build_sorted_plan(r.flip(0), r, m, 50)
    rp = plan.row_ptr.long()
    assert rp[0] == 0 and rp[-1] == int(m.sum()) and (rp[1:] >= rp[:-1]).all()
    for i in range(50):
        seg = plan.receivers_sorted[rp[i]:rp[i + 1]]
        assert (seg == i).all()
        assert rp[i + 1] - rp[i] == int(((r == i) & m).sum())
    assert not plan.edge_mask_sorted[rp[-1]:].any()
    assert torch.equal(plan.unsort(plan.sort(torch.arange(400)))[m], torch.arange(400)[m])


def test_kernel_sources_and_build_flags():
    """Every CUDA source has its signatures, every entry point the wrappers
    call is declared in its source and holds a ``__global__`` kernel, and
    the build targets sm_90a."""
    sources = sorted(path.name for path in build.CSRC_DIR.glob("*.cu"))
    assert sources == sorted(build.SIGNATURES) == [
        "hdbscan.cu", "ring_gather.cu", "sddmm_csr.cu", "segment_csr.cu", "segment_gather.cu",
        "top2.cu"]
    for source, entries in build.SIGNATURES.items():
        src = (build.CSRC_DIR / source).read_text()
        assert "__global__" in src and 'extern "C"' in src
        for name in entries:
            assert f"int {name}(" in src, (source, name)
        assert build.library_path(source).parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # ctypes passes as many arguments as each C entry takes
    for source, entries in build.SIGNATURES.items():
        src = (build.CSRC_DIR / source).read_text()
        for name, argtypes in entries.items():
            params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
            assert len(params.split(",")) == len(argtypes), (source, name)
    # K1/K2: the tile kernel and its fix-up take the plan's receivers, the
    # partials' scratch, the tile and the lanes; the profiler's names of
    # every kernel are kernels of their sources
    src = (build.CSRC_DIR / "segment_csr.cu").read_text()
    for name in ("hgnn_csr_sum_bf16", "hgnn_csr_wsum_f32"):
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        for arg in ("recv", "partials", "n_edges", "tile", "lanes"):
            assert re.search(rf"\b{arg}\b", params), (name, arg)
    assert "csr_tile_fixup_kernel<T, kWeighted>" in src and "csr_sum_kernel" not in src
    for tags in (chip_smoke.PROFILE_TAGS, chip_smoke.FIXUP_TAGS):
        for kernel, tag in tags.items():
            text = (build.CSRC_DIR / chip_smoke.SOURCES[kernel]).read_text()
            assert re.search(rf"__global__ void(?: __launch_bounds__\(\w+\))?\s+"
                             rf"{tag.split('<')[0]}\(", text), tag
    # the wrappers name entry points that exist
    for module, source in ((sorted_agg, "segment_csr.cu"), (sddmm, "sddmm_csr.cu"),
                           (top2, "top2.cu"), (segment_gather, "segment_gather.cu"),
                           (ring_gather, "ring_gather.cu"), (hdbscan, "hdbscan.cu")):
        text = inspect.getsource(module)
        assert all(name in text for name in build.SIGNATURES[source]), source


def test_every_kernel_wrapper_has_a_plain_sibling_and_a_counter():
    """K1-K8 and HD1/HD2: wrapper, plain version in the same module, launch
    counter; and no ``try`` around a build or a launch."""
    wrappers = {"K1": (sorted_agg, "sorted_aggregate"),
                "K2": (sorted_agg, "sorted_aggregate_weighted"),
                "K5": (sorted_agg, "sorted_segment_min_i32"),
                "K3": (sddmm, "sorted_sddmm"), "K4": (sddmm, "scaled_gather"),
                "K6": (top2, "row_top2"),
                "K7": (segment_gather, "csr_segment_sum"),
                "K8": (ring_gather, "ring_all_gather"),
                "HD1": (hdbscan, "core_distances"), "HD2": (hdbscan, "prim_mst")}
    # HD2's launches are also counted by route, K8's of calls over several launches too
    assert set(sorted_agg.LAUNCHES) == set(wrappers) | {"HD2_cluster", "HD2_coop", "K8_split"}
    for kernel, (module, name) in wrappers.items():
        assert callable(getattr(module, name)) and callable(getattr(module, name + "_plain"))
        text = inspect.getsource(module)
        assert f'LAUNCHES["{kernel}"] += 1' in text, kernel
        assert not re.search(r"^\s*(try|except)\b", text, re.M), module.__name__
    assert not re.search(r"^\s*try\b", inspect.getsource(build.library), re.M)
    # K1/K2 take their plain versions on the line after the CPU test and
    # nowhere else; the launch path names no plain version
    for fn in (sorted_agg._k1, sorted_agg._k2):
        text = inspect.getsource(fn)
        assert text.count("_plain(") == 1
        cpu = text.index("if _on_cpu(")
        assert text[cpu:text.index("_plain(")].count("\n") == 1
        assert text.index("_tile_sum(") > text.index("_plain(")
    assert "_plain" not in inspect.getsource(sorted_agg._tile_sum)
    sorted_agg.LAUNCHES["K3"] += 1
    sorted_agg.reset_launches()
    assert not any(sorted_agg.LAUNCHES.values())


def test_rdma_halo_cannot_reach_the_plain_version_on_the_card():
    """By inspection, as for K1-K7.  In the wrapper the plain version is
    returned in one place only, under the CPU test, and everything after it
    is the launch; under ``halo_backend: rdma`` the group's all-gather calls
    the wrapper and nothing else; no shape sends a block to ``torch.cat``."""
    text = inspect.getsource(ring_gather.ring_all_gather)
    assert text.count("ring_all_gather_plain(") == 1
    cpu_branch = text.index("if _on_cpu(*blocks):")
    plain_call = text.index("return ring_all_gather_plain(blocks)")
    launch = text.index("_entry()(")
    assert cpu_branch < plain_call < launch
    assert text[cpu_branch:plain_call].count("\n") == 1  # the very next line
    after = text[plain_call + len("return ring_all_gather_plain(blocks)"):]
    assert "return outs" in after and "torch.cat" not in after and "shape[1] %" not in text
    assert 'LAUNCHES["K8"] += 1' in after

    gather = inspect.getsource(comm.ShardGroup._all_gather)
    rdma = gather.index('if self.halo_backend == "rdma":')
    assert gather.index("return ring_all_gather(values)") > rdma
    assert gather[rdma:].index("return ring_all_gather(values)") < gather[rdma:].index(
        "ring_all_gather_plain")
    # every all-gather of the sharded path goes through the group: neither
    # module names the wrapper or its plain version
    for module in (graph_shard, halo):
        assert "ring_all_gather" not in inspect.getsource(module), module.__name__

    # on the CPU the rdma backend takes the plain version, and only there
    blocks = [torch.ones(2, 3), torch.zeros(2, 3)]
    outs, _ = comm.run_sharded(lambda c: c.all_gather(blocks[c.index]), 2, "rdma")
    assert torch.equal(outs[1], torch.cat(blocks)) and sorted_agg.LAUNCHES["K8"] == 0
    with pytest.raises(ValueError, match="unsupported or mixed"):
        comm.run_sharded(lambda c: c.all_gather(torch.empty(2, device="meta")), 2, "rdma")
