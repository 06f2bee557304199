"""The port's kernel entries, wrapped where their callers look them up, and
the least time each call could take (its roofline bound).

A call is named by the op it does, not by the kernel that does it: the
wrapper records the call's shapes and opens a ``record_function`` range
``pb::<op>::<index>``, and ``profile.reduce`` gives the device time of the
kernels launched inside it.  Bounds follow the arithmetic of the port's
kernel table: each input byte read once and each output byte written once,
over the card's bandwidth.  The entries are the kernels' own Python entries
(``_k1`` and the rest), so the calls that autograd makes in the backward
(K1 as a gather's backward, K3 and K4 as K2's) are counted with the
forward's.  Edge counts are the calls' valid edges (the plans' last row
pointer), read once the traced calls are over, so the wrappers add no host
read to the path.
"""

from __future__ import annotations

import importlib

import torch

from portbench.harness import peaks

# op -> the places under the port where its callers look it up (module,
# attribute): the forward's and the backward's calls alike
ENTRIES = {
    "segment_sum": [("ops.kernels.sorted_agg", "_k1")],
    "segment_wsum": [("ops.kernels.sorted_agg", "_k2"), ("ops.kernels.sddmm", "_k2")],
    "sddmm": [("ops.kernels.sddmm", "_k3")],
    "scaled_gather": [("ops.kernels.sddmm", "scaled_gather")],
    "segment_min": [("ops.connected", "sorted_segment_min_i32")],
    "auction_top2": [("train.auction", "row_top2")],
}
SEGMENT_OPS = ("segment_sum", "segment_wsum", "segment_min", "sddmm", "scaled_gather")


def _shape_record(op, args, kwargs):
    """What the bound needs of a call, without reading the device."""
    if op in SEGMENT_OPS:
        plan = args[2] if op == "scaled_gather" else args[-1]
        if op == "scaled_gather":
            scale, rows = args[0], args[1]
            out = kwargs.get("out_dtype", args[3] if len(args) > 3 else torch.float32)
            return {"d": rows.shape[1], "elt": torch.empty((), dtype=out).element_size(),
                    "scaled": scale is not None, "rows": plan.num_segments,
                    "row_ptr": plan.row_ptr}
        data = args[0]
        d = data.shape[1] if data.ndim > 1 else 1
        return {"d": d, "elt": data.element_size(), "rows": plan.num_segments,
                "row_ptr": plan.row_ptr}
    a = args[0]
    return {"p": a.shape[0], "c": a.shape[1]}


def bound_s(op, rec) -> float:
    """The least time of one call on the card (seconds)."""
    bw = peaks.H100["hbm_bytes_per_s"]
    if op == "auction_top2":
        p, c = rec["p"], rec["c"]
        return (p * c * 4 + c * 4 + 3 * p * 4) / bw
    e = int(rec["row_ptr"][-1])  # the call's valid edges
    n, d = rec["rows"], rec["d"]
    index = e * 4 + (n + 1) * 4  # receivers and row pointers
    if op == "segment_min":
        return (e * 4 + index + n * 4) / bw
    if op == "sddmm":  # edge rows and f32 node rows in, one f32 a valid edge out
        return (e * d * rec["elt"] + n * d * 4 + index + e * 4) / bw
    if op == "scaled_gather":  # f32 node rows (and a scale an edge) in, edge rows out
        return (n * d * 4 + (e * 4 if rec["scaled"] else 0) + index + e * d * rec["elt"]) / bw
    read = e * d * rec["elt"] + index + (e * 4 if op == "segment_wsum" else 0)
    return (read + n * d * 4) / bw


class OpLog:
    """Wraps the entries while ``active``; each call while active is logged
    and runs inside its own profiler range."""

    def __init__(self, root: str = "hierarchicalgnn_torch"):
        self.active = False
        self.calls: list = []
        self._undo = []
        for op, places in ENTRIES.items():
            for module, attr in places:
                mod = importlib.import_module(f"{root}.{module}")
                fn = getattr(mod, attr)
                setattr(mod, attr, self._wrap(op, fn))
                self._undo.append((mod, attr, fn))

    def _wrap(self, op, fn):
        def logged(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            index = len(self.calls)
            self.calls.append((op, _shape_record(op, args, kwargs)))
            with torch.profiler.record_function(f"pb::{op}::{index}"):
                return fn(*args, **kwargs)
        return logged

    def close(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo = []

    def rooflines(self, range_device_s: dict) -> list:
        """(op, bound seconds, device seconds) of every logged call that the
        trace saw launch kernels."""
        out = []
        for index, (op, rec) in enumerate(self.calls):
            dev = range_device_s.get(f"pb::{op}::{index}")
            if dev:
                out.append((op, bound_s(op, rec), dev))
        return out
