"""Configuration: JSON config -> sweep merge -> derived keys -> ArchConfig.

PyTorch counterpart of ``hierarchicalgnn_tpu/utils/config.py``.  The
shipped configs are JSON (``hierarchicalgnn_torch/configs/*.json``, the
JAX package's YAML rewritten key for key), so loading needs only the
standard library.  ``process_hparams`` and ``ArchConfig`` keep the JAX
package's semantics and defaults, so one name gives the same dict in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")

_DEFAULTS = {
    # static capacities (events are padded up to these)
    "n_nodes_max": 4096,
    "n_edges_max": 16384,
    "size_buckets": None,   # [[n_nodes, n_edges], ...] smallest-fit padding
    "max_clusters": 1024,
    "max_particles": 512,
    # kernels / precision
    "use_pallas": False,
    "knn_block_size": 1024,
    "gmm_iters": 60,
    # parallelism
    "mesh_shape": None,
    "shard_pooled": True,
    "gradient_clip_val": 0.5,
}


def process_hparams(hparams: dict) -> dict:
    """Derived-key post-processing (``hidden: ratio``, granularity, remat)."""
    hparams = dict(hparams)
    if hparams.get("hidden") == "ratio":
        hparams["hidden"] = hparams["hidden_ratio"] * hparams["latent"]
    if "cluster_granularity" not in hparams:
        hparams["cluster_granularity"] = 0
    raw = hparams.get("compute_dtype") or "float32"
    dtype = raw if isinstance(raw, str) else str(raw).replace("torch.", "")
    hparams.setdefault("remat", dtype == "float32")
    for key, value in _DEFAULTS.items():
        hparams.setdefault(key, value)
    return hparams


def load_config(name_or_path: str, sweep_configs: dict | None = None) -> dict:
    """Load a named config from the package config dir, or a JSON path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, name_or_path)
        if not path.endswith(".json"):
            path += ".json"
    with open(path) as f:
        hparams = json.load(f)
    return process_hparams({**hparams, **(sweep_configs or {})})


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture fields of a config (same names and defaults as JAX's)."""

    spatial_channels: int = 3
    latent: int = 256
    hidden: int = 512
    emb_dim: int = 8
    n_interaction_graph_iters: int = 6
    n_hierarchical_graph_iters: int = 6
    nb_node_layer: int = 3
    nb_edge_layer: int = 2
    output_layers: int = 3
    hidden_activation: str = "GELU"
    hidden_output_activation: str = "Tanh"
    layernorm: bool = True
    share_weight: bool = False
    bipartitegraph_sparsity: int = 5
    supergraph_sparsity: int = 10
    min_cluster_size: int = 3
    cluster_granularity: float = 5.0
    max_clusters: int = 1024
    gmm_iters: int = 60
    knn_block_size: int = 1024
    use_pallas: bool = False  # the port always runs its kernel path
    compute_dtype: str | None = None  # "bfloat16": MLPs and residual streams
    emb_head_dtype: str | None = None  # None keeps the embedding head f32
    remat: bool | str = True  # read by training only

    @staticmethod
    def from_hparams(hparams: dict) -> "ArchConfig":
        fields = {f.name for f in dataclasses.fields(ArchConfig)}
        kwargs: dict[str, Any] = {}
        for k, v in hparams.items():
            if k in fields and v is not None:
                kwargs[k] = v
        return ArchConfig(**kwargs)
