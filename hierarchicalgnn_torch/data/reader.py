"""Event files: preprocessed TrackML events as ``.npz`` or PyG ``.pt``.

Counterpart of ``hierarchicalgnn_tpu/data/reader.py``; the same files give
the same dicts of numpy arrays, in the same order.  The reference loads PyG
``Data`` objects with ``torch.load`` in dataloader workers (reference
``Modules/utils.py:54``); here an event directory is read once up front, or
streamed by :mod:`data.native_loader`.  ``.npz`` with the keys of
``EVENT_KEYS`` is the preferred format (:func:`save_event_npz`).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

EVENT_KEYS = ("x", "cell_data", "pid", "hid", "pt", "primary", "edge_index",
              "modulewise_true_edges", "signal_true_edges", "y", "y_pid")


def load_dataset_paths(input_dir, datatype_names, shuffle_seed: int = 42):
    """The event files under ``input_dir/{name}`` for each of
    ``datatype_names``, each directory sorted, then a seed-42 shuffle
    (reference ``Modules/utils.py:15-26``)."""
    all_events = []
    for name in datatype_names:
        sub = os.path.join(input_dir, name)
        if not os.path.isdir(sub):
            continue
        all_events.extend(sorted(os.path.join(sub, e) for e in os.listdir(sub)))
    random.Random(shuffle_seed).shuffle(all_events)
    return all_events


def load_event_file(path: str) -> dict:
    """One raw event dict (numpy arrays) from ``.npz`` or a torch ``.pt``
    (a dict of tensors, or a PyG ``Data`` with or without ``_store``)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    # a PyG Data object is a pickled class instance, so weights_only is off:
    # read only event files of trusted origin
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "__dict__") and not isinstance(obj, dict):
        src = {**getattr(obj, "__dict__", {})}
        store = src.get("_store")
        if store is not None:
            src = dict(store)
    else:
        src = dict(obj)
    out = {}
    for k, v in src.items():
        if hasattr(v, "numpy"):
            out[k] = v.numpy()
        elif isinstance(v, np.ndarray):
            out[k] = v
    return out


def load_event_dir(input_dir, datatype_names, limit=None):
    paths = load_dataset_paths(input_dir, datatype_names)
    if limit:
        paths = paths[:limit]
    return [load_event_file(p) for p in paths]


def save_event_npz(path: str, event: dict):
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in event.items()
                                 if k in EVENT_KEYS})
