"""Checkpoints, resume and transfer learning.

Counterpart of ``hierarchicalgnn_tpu/train/checkpoint.py``, with torch
files in the place of orbax and the JAX layout:
``run_dir/checkpoints/{best,last,autosave}`` (one file each) and
``run_dir/checkpoints/hparams.json``.  A checkpoint is the dict
``Trainer.state_dict`` makes: ``params`` and ``buffers`` by the model's
names (the ``score_cut`` and ``knn_radius`` EMAs and the batch-norm running
statistics are buffers), ``opt_state`` (``AmsgradW``'s ``count`` and its
``mu``, ``nu`` and ``nu_max`` by parameter name), ``step`` and ``epoch``.

A save writes a temporary file beside the target and renames it over the
target, so a kill in the middle of a save leaves the previous checkpoint
whole.  A file that cannot be read raises ``ValueError`` and a missing one
``FileNotFoundError``, the two errors ``run.py``'s ``resume`` falls back
on, as with orbax.

:func:`transfer_params` loads a pretrained model's parameters into a
different model, skipping what does not match: the semantics of
``load_from_pretrained(strict=False)`` and of the encoder-skipping BC ->
gMRT transfer (reference ``script.py:76-85``).
"""

from __future__ import annotations

import json
import os
import pickle

import torch

from hierarchicalgnn_torch.convert import param_targets


def checkpoint_path(run_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(run_dir, "checkpoints", name))


def _replace_atomically(path: str, write):
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(run_dir: str, name: str, state_dict: dict, hparams: dict | None = None):
    """Write ``state_dict`` (tensors on any device; saved from the CPU) as
    ``checkpoints/name``, and ``hparams.json`` with the values of JSON
    types (the JAX package's filter)."""
    path = checkpoint_path(run_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _replace_atomically(path, lambda tmp: torch.save(state_dict, tmp))
    if hparams is not None:
        kept = {k: v for k, v in hparams.items()
                if isinstance(v, (int, float, str, bool, list, type(None)))}
        hp_path = os.path.join(os.path.dirname(path), "hparams.json")

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(kept, f, indent=2)

        _replace_atomically(hp_path, write)


def restore_checkpoint(run_dir: str, name: str) -> dict:
    """The state dict saved as ``checkpoints/name``, on the CPU."""
    path = checkpoint_path(run_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, EOFError, pickle.UnpicklingError) as e:
        raise ValueError(f"checkpoint {path} is unreadable: {e}") from e


def load_hparams(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "checkpoints", "hparams.json")) as f:
        return json.load(f)


def model_state(model) -> dict:
    """{"params": ..., "buffers": ...}: copies on the CPU, by the model's
    names."""
    return {"params": {k: v.detach().cpu().clone() for k, v in model.named_parameters()},
            "buffers": {k: v.detach().cpu().clone() for k, v in model.named_buffers()}}


MOMENTS = ("mu", "nu", "nu_max")


def train_state(model, optimizer) -> dict:
    """The whole train state without its epoch: ``model_state`` plus
    ``opt_state`` (the optimizer's ``count`` and each parameter's moments by
    name, zeros before its first step) and ``step``."""
    state = model_state(model)
    moments = {key: {} for key in MOMENTS}
    for name, p in model.named_parameters():
        slots = optimizer.state[p]
        for key in MOMENTS:
            moments[key][name] = (slots[key] if slots else torch.zeros_like(p)).cpu().clone()
    state["opt_state"] = {"count": optimizer.count, **moments}
    state["step"] = optimizer.count
    return state


def load_model_state(model, state: dict):
    """Copy a checkpoint's parameters and buffers into ``model`` in place.
    Raises ValueError unless the names and shapes are exactly the model's
    (a checkpoint of another model or configuration)."""
    parts = (("params", dict(model.named_parameters())), ("buffers", dict(model.named_buffers())))
    for part, current in parts:  # check all before anything is copied
        saved = state[part]
        if set(saved) != set(current):
            raise ValueError(f"checkpoint {part} do not match the model: missing "
                             f"{sorted(set(current) - set(saved))}, unexpected "
                             f"{sorted(set(saved) - set(current))}")
        for key, tensor in current.items():
            if saved[key].shape != tensor.shape:
                raise ValueError(f"checkpoint {part} {key}: shape {tuple(saved[key].shape)}, "
                                 f"model {tuple(tensor.shape)}")
    with torch.no_grad():
        for part, current in parts:
            for key, tensor in current.items():
                tensor.copy_(state[part][key])


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
