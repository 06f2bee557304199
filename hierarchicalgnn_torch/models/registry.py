"""Model registry: name or numeric ID -> (config, model, pipeline).

Counterpart of ``hierarchicalgnn_tpu/models/registry.py`` (reference
``Modules/training_utils.py:22-46``), with the numeric IDs "1"-"5" of the
example notebook.
"""

from __future__ import annotations

from hierarchicalgnn_torch.models.models import build_model
from hierarchicalgnn_torch.train.pipelines import (
    BipartitePipeline, ECPipeline, EmbeddingPipeline)
from hierarchicalgnn_torch.utils.config import load_config

# name -> (config file, pipeline factory)
_REGISTRY = {
    "EC-IN": ("ec_in", ECPipeline),
    "Embedding-IN": ("embedding_in",
                     lambda m, hp: EmbeddingPipeline(m, hp, hierarchical=False)),
    "Embedding-HGNN-GMM": ("embedding_hgnn_gmm",
                           lambda m, hp: EmbeddingPipeline(m, hp, hierarchical=True)),
    "BC-HGNN-GMM": ("bc_hgnn_gmm", BipartitePipeline),
    "gMRT": ("gmrt", BipartitePipeline),
}

_ALIASES = {"1": "EC-IN", "2": "Embedding-IN", "3": "Embedding-HGNN-GMM",
            "4": "BC-HGNN-GMM", "5": "gMRT"}


def available_models():
    return sorted(_REGISTRY)


def model_selector(model_name: str, sweep_configs: dict | None = None):
    """Returns (hparams, model, pipeline) for a model name or numeric ID.
    The model has seeded random weights (seed 0; ``Trainer.init_state``
    draws anew), lies on the CPU and is in eval mode; ``InferenceEngine`` and ``Trainer`` move it to their device."""
    name = _ALIASES.get(str(model_name), str(model_name))
    if name not in _REGISTRY:
        raise ValueError(f"Can't find model name {model_name!r}! "
                         f"Available: {available_models()}")
    config_name, pipeline_factory = _REGISTRY[name]
    hparams = load_config(config_name, sweep_configs)
    model = build_model(hparams)
    return hparams, model, pipeline_factory(model, hparams)
