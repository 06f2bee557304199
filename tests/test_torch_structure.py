"""Structure of the port: import purity, device policy, kernel dispatch."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models.models import build_model
from hierarchicalgnn_torch.ops.kernels import build, sorted_agg
from hierarchicalgnn_torch.utils.config import load_config

from _torch_parity import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PURITY = """
import importlib, pkgutil, sys
import hierarchicalgnn_torch, chip_smoke
for m in pkgutil.walk_packages(hierarchicalgnn_torch.__path__, "hierarchicalgnn_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "hierarchicalgnn_tpu"))
print(len([n for n in sys.modules if n.startswith("hierarchicalgnn_torch.")]))
sys.exit(f"loaded: {bad}" if bad else 0)
"""


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, import without JAX, flax
    or the JAX package (in a fresh interpreter)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert inspect.signature(InferenceEngine).parameters["device"].default == "cuda"
    hp = load_config("bc_hgnn_gmm", SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
    """Every entry point the wrappers call is declared, and the build
    targets sm_90a."""
    src = (build.CSRC_DIR / "segment_csr.cu").read_text()
    for name in build.SIGNATURES["segment_csr.cu"]:
        assert f"int {name}(" in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.library_path("segment_csr.cu").parent == build.BUILD_DIR
