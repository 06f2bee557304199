"""The discrete stages of a step, recorded on one side and replayed on the other.

A training step makes discrete choices: in BC-HGNN-GMM the pooling's
clusters, the kNN graphs over the cluster means, the matching of particles
to candidates; in Embedding-IN the mined kNN pairs.  On the
card the program computes them in bf16 and the plain f32 reference would
choose differently near every cut, so the comparison follows the program:

* ``Recorder`` wraps each stage where the program's caller looks it up and
  keeps, for the calls of a slot (a training step), their
  inputs and outputs.
* ``Forcer`` wraps the same stages in the reference and hands it the
  program's outputs, so the reference's continuous work (forward, loss,
  gradient, update) runs on the program's choices.
* ``stage_diffs`` checks each stage by itself: the reference's stage on the
  program's own inputs must give the program's outputs.  The matching is
  checked in its parts (``INNER``): its pair-score sums within float32's
  rounding, its auction exactly on the program's own sums.

The stage names and where each lives are the same in the port and in the
reference (``portbench/reference/hgnn``), which keeps the port's layout.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

# stage -> (module under the package root, attribute); instance stages have
# no module: their owner is an object the driver names
MODULE_STAGES = {
    "knn": ("models.dynamic_graph", "knn"),
    "matching": ("train.pipelines", "match_particles_to_candidates"),
    "auction": ("train.matching", "auction_match"),
    "knn_graph": ("train.pipelines", "knn_graph"),
}

# A model file (``portbench/models/<model_file>.py``) lists its training
# step's stages in ``STAGES``, in the order the comparisons report them, and
# in ``INNER`` those recorded inside one of them and checked with it, never
# handed to the reference: the auction inside the matching, whose input is
# the program's own pair-score matrix.  That matrix is a float32 sum by
# atomic adds, so its last bits, and through a near tie the auction's
# answer, vary from run to run: the matching is judged on the program's own
# matrix.


def _detach(value, device):
    """``value`` with every tensor detached and copied (to ``device`` if
    given), tuples and lists kept: a recorded view of a buffer must not
    move when the buffer does."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        return value.clone() if device is None else value.to(device, copy=True)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_detach(v, device) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_detach(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _detach(v, device) for k, v in value.items()}
    return value


class _Patches:
    """Attribute replacements, undone in reverse order by ``restore``."""

    def __init__(self):
        self._undo = []

    def set(self, owner, attr, value):
        had = attr in vars(owner)
        old = getattr(owner, attr)
        setattr(owner, attr, value)
        self._undo.append((owner, attr, old, had))

    def restore(self):
        while self._undo:
            owner, attr, old, had = self._undo.pop()
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


def stage_owner(root: str, stage: str, owners: dict):
    """(object, attribute) where ``stage`` is looked up: a module of the
    package ``root`` or one of the driver's ``owners``."""
    if stage in MODULE_STAGES:
        module, attr = MODULE_STAGES[stage]
        return importlib.import_module(f"{root}.{module}"), attr
    return owners[stage]


class Recorder:
    """Records the stages' calls of the slots it is told about.

    ``slot`` is None outside a recorded call: the wrappers then only pass
    through.  ``calls[slot]`` lists (stage, args, kwargs, out, extra) in
    call order; ``begin(slot)`` starts a slot afresh."""

    def __init__(self, root: str, stages, owners: dict, to_host: bool = False):
        self.slot = None
        self.calls: dict = {}
        self.to_host = to_host
        self._patches = _Patches()
        for stage in stages:
            owner, attr = stage_owner(root, stage, owners)
            self._patches.set(owner, attr, self._wrap(stage, owner, getattr(owner, attr)))

    def _wrap(self, stage, owner, fn):
        def tapped(*args, **kwargs):
            slot = self.slot
            extra = None
            if slot is not None and stage == "clustering":
                # the EMA's value before the call, which the cut reads
                extra = owner.score_cut.detach().clone()
            out = fn(*args, **kwargs)
            if slot is not None:
                dev = "cpu" if self.to_host else None
                self.calls[slot].append((stage, _detach(args, dev), _detach(kwargs, dev),
                                         _detach(out, dev), _detach(extra, dev)))
            return out
        return tapped

    def begin(self, slot):
        self.slot = slot
        self.calls[slot] = []

    def end(self):
        self.slot = None

    def close(self):
        self.slot = None
        self._patches.restore()


def _knn_d2(queries, points, idx):
    """The kNN's squared distances for given neighbour indices, by the kNN's
    own algebra (``|q|^2 + |p|^2 - 2 q.p``, clamped at 0; inf where -1)."""
    q, p = queries.float(), points.float()
    safe = idx.clamp(min=0)
    dots = torch.einsum("qd,qkd->qk", q, p[safe])
    d2 = (q.square().sum(-1)[:, None] + p.square().sum(-1)[safe] - 2.0 * dots).clamp(min=0.0)
    return torch.where(idx >= 0, d2, float("inf"))


class Forcer:
    """Hands the reference the recorded outputs of ``calls`` (one slot's
    list) at its stages, in call order.  ``knn`` keeps the program's
    neighbours and takes its distances from the reference's own rows."""

    def __init__(self, root: str, stages, owners: dict, calls, device):
        self.queue = {s: [c for c in calls if c[0] == s] for s in stages}
        self.device = device
        self._patches = _Patches()
        for stage in stages:
            owner, attr = stage_owner(root, stage, owners)
            self._patches.set(owner, attr, self._wrap(stage))

    def _next(self, stage):
        if not self.queue[stage]:
            raise RuntimeError(f"the reference called {stage} more often than the program")
        return _detach(self.queue[stage].pop(0)[3], self.device)

    def _wrap(self, stage):
        def forced(*args, **kwargs):
            out = self._next(stage)
            if stage == "knn":
                idx = out[0]
                return idx, _knn_d2(args[0], args[1], idx)
            return out
        return forced

    def close(self):
        self._patches.restore()
        left = {s: len(q) for s, q in self.queue.items() if q}
        if left:
            raise RuntimeError(f"the reference made fewer stage calls than the program: {left}")


def _count_diff(a, b) -> int:
    """Entries that differ between two arrays; every entry when the shapes
    differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size, 1))
    return int(np.count_nonzero(a != b))


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _matching_diff(ref, args, kwargs, out, auction) -> int:
    """Entries of one matching call that the reference gives otherwise, the
    auction inside it recorded as ``auction`` (args, kwargs, out): the
    program's pair scores that lie outside float32's rounding of their
    exact sums, the auction's answer against the reference's auction on
    those scores, and the rest of the matching (the filter and the truth)
    against the reference's on the program's auction answer."""
    a_args, a_kwargs, a_out = auction
    n = ref.pair_scores_outside(args, kwargs, a_args[0])
    got = ref.auction(a_args, a_kwargs)
    n += _count_diff(_host(got[0]), _host(a_out[0])) + _count_diff(_host(got[1]), _host(a_out[1]))
    got = ref.matching(args, kwargs, auction=a_out)
    return n + _count_diff(_host(got[0]), _host(out[0])) + _count_diff(_host(got[3]), _host(out[3]))


def stage_diffs(calls, ref, device) -> dict:
    """Each recorded stage call redone by the reference on the program's
    inputs; returns {stage: entries that differ}, summed over the calls.
    An inner stage (``INNER``) is checked with the call that holds it.

    ``ref`` is a ``drivers.ReferenceStages`` (the reference's stage
    functions and the model whose buffers they read)."""
    diffs: dict = {}
    inner = None  # the auction recorded inside the next matching call
    for stage, args, kwargs, out, extra in calls:
        args, kwargs, out = (_detach(v, device) for v in (args, kwargs, out))
        if stage == "auction":
            inner = (args, kwargs, out)
            continue
        if stage == "knn":
            idx, _ = ref.knn(*args, **kwargs)
            n = _count_diff(_host(idx), _host(out[0]))
        elif stage == "clustering":
            clusters, n_clusters = ref.clustering(args, kwargs, _detach(extra, device))
            n = _count_diff(_host(clusters), _host(out[0])) + abs(int(n_clusters) - int(out[1]))
        elif stage == "matching" and inner is not None:
            n, inner = _matching_diff(ref, args, kwargs, out, inner), None
        elif stage == "matching":
            got = ref.matching(args, kwargs)
            n = _count_diff(_host(got[0]), _host(out[0])) + _count_diff(
                _host(got[3]), _host(out[3]))
        elif stage == "knn_graph":
            s, r, m, _ = ref.knn_graph(*args, **kwargs)
            n = _count_diff(_host(m), _host(out[2])) + _count_diff(
                _host(torch.where(m, r, -1)), _host(torch.where(out[2], out[1], -1)))
        else:
            raise ValueError(stage)
        diffs[stage] = diffs.get(stage, 0) + n
    return diffs
