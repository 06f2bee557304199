"""Transfer learning between models.

Counterpart of ``transfer_params`` in
``hierarchicalgnn_tpu/train/checkpoint.py``: load a pretrained model's
parameters into a different model, skipping what does not match -- the
semantics of ``load_from_pretrained(strict=False)`` and of the
encoder-skipping BC -> gMRT transfer.  Saving and restoring a run waits for
the torch checkpoint format.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.convert import param_targets


def transfer_params(target_model, source_model, skip_prefixes: tuple[str, ...] = ()):
    """Copy the source's parameters into the target where the flax-shaped
    names (``convert.py``: ``HierarchicalGNNBlock_0/CheckpointMLP_0/Dense_0/
    kernel``, ...) and the shapes match; everything else keeps the target's
    initialisation.  A name that starts with, or contains, one of
    ``skip_prefixes`` is left alone.  Only parameters move, never buffers.
    Returns the names that were copied."""
    source = {path: tensor for path, tensor, _ in param_targets(source_model)}
    moved = []
    with torch.no_grad():
        for path, tensor, _ in param_targets(target_model):
            if any(path.startswith(p) or p in path for p in skip_prefixes):
                continue
            src = source.get(path)
            if src is not None and src.shape == tensor.shape:
                tensor.copy_(src)
                moved.append(path)
    return moved
