"""Numerics sanitizer: finiteness audits and a determinism check.

Counterpart of ``hierarchicalgnn_tpu/utils/sanitize.py``.  The failures
worth guarding here are numerical: bf16 under- and overflow, a NaN leaking
through a masked reduction, and reductions whose order changes from run to
run (``index_add_`` on the card adds in a run-dependent order).

  * :func:`finite_report` / :func:`assert_all_finite` audit a module (its
    parameters and buffers), a state dict, a nested dict of tensors or
    arrays, or one tensor, and name every non-finite entry by its path;
  * :func:`check_determinism` calls a function twice on the same inputs and
    demands bit-identical outputs;
  * the trainer's ``debug_numerics: true`` guard reads the step's metrics
    (the one readback every step makes) and, on the first non-finite value,
    saves ``autosave`` and raises ``FloatingPointError`` with the reports of
    the parameters and buffers.

Paths are written as ``jax.tree_util.keystr`` writes them (``['params']
['Dense_0']``, ``[0]``), so a report names a nested dict's entries as the
JAX package's does; a module's entries keep their dotted names
(``['hgnn.score_cut']``).
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, prefix=""):
    """(path, numpy array) of every leaf."""
    if isinstance(tree, torch.nn.Module):
        tree = {**dict(tree.named_parameters()), **dict(tree.named_buffers())}
    if isinstance(tree, dict):  # in sorted key order, as jax flattens a dict
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        t = tree.detach()
        yield prefix, (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    else:
        yield prefix, np.asarray(tree)


def finite_report(tree, max_leaves: int = 0) -> dict[str, tuple[int, int]]:
    """{path: (n_bad, n_total)} for every floating leaf with a non-finite
    entry.  Reads the tree back to the host: for failure paths and tests.
    ``max_leaves`` > 0 truncates the report."""
    bad = {}
    for path, arr in _leaves(tree):
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n_bad = int(np.size(arr) - np.isfinite(arr).sum())
        if n_bad:
            bad[path] = (n_bad, int(np.size(arr)))
            if max_leaves and len(bad) >= max_leaves:
                break
    return bad


def assert_all_finite(tree, what: str = "tree"):
    """Raise FloatingPointError naming every non-finite leaf."""
    bad = finite_report(tree)
    if bad:
        lines = [f"  {path}: {n}/{total} non-finite" for path, (n, total) in bad.items()]
        raise FloatingPointError(f"{what} contains non-finite values:\n" + "\n".join(lines))


def check_determinism(fn, *args, runs: int = 2, what: str = "fn"):
    """Call ``fn(*args)`` ``runs`` times; raise unless every output leaf is
    bit-identical (NaNs equal).  Returns the first run's leaves as
    {path: numpy array}."""
    ref = dict(_leaves(fn(*args)))
    for r in range(1, runs):
        for (path, a), (_, b) in zip(ref.items(), _leaves(fn(*args))):
            if not np.array_equal(a, b, equal_nan=True):
                delta = np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))
                raise AssertionError(f"{what} is nondeterministic at leaf {path} "
                                     f"(run {r}): max |delta| = {delta}")
    return ref
