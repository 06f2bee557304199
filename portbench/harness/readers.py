"""What the per-layer readers (``portbench/metrics/<metric>.py``) share.

A reader takes the run's record (``modes/*.py``: ``mode``, ``window_s``,
``events``, ``counters``, and in a traced run ``profile``, ``rooflines``
and, where the port records spans, ``spans``) and returns a number, or None
where it finds nothing to read (another mode, no such counter or span): the
harness then leaves the metric out.
"""

from __future__ import annotations

import statistics

from portbench.harness import peaks


def profiled(rec: dict, mode: str):
    """The reduced trace of a traced run of ``mode``, or None."""
    if rec.get("mode") != mode:
        return None
    prof = rec.get("profile")
    return prof if prof and prof.get("wall_s", 0) > 0 else None


def idle_share(rec: dict, mode: str):
    """% of a step's time in which no operation ran on the device: the
    device's busy time a step in the profiled pass over the window's time a
    step.  The profiler stretches a step by its own cost on the host and
    leaves the device's operations as they are; the profiled pass does what
    each of the window's passes does."""
    prof = profiled(rec, mode)
    if prof is None or not prof.get("steps") or not rec.get("events"):
        return None
    busy = prof["busy_s"] / prof["steps"]
    return 100.0 * (1.0 - busy / (rec["window_s"] / rec["events"]))


def mfu(rec: dict, mode: str):
    """% of the bf16 peak: the model FLOPs of the window's events over the
    window's wall time."""
    flops = rec.get("counters", {}).get("flops") if rec.get("mode") == mode else None
    if not flops or rec["window_s"] <= 0:
        return None
    return 100.0 * sum(flops) / rec["window_s"] / peaks.H100["bf16_flops_per_s"]


def kernel_roofline(rec: dict, mode: str):
    """% : the summed bounds of the profiled calls of the port's kernel
    entries over their summed device time."""
    rows = rec.get("rooflines") if rec.get("mode") == mode else None
    if not rows:
        return None
    return 100.0 * sum(b for _, b, _ in rows) / sum(d for _, _, d in rows)


def mean_counter(rec: dict, mode: str, name: str):
    values = rec.get("counters", {}).get(name) if rec.get("mode") == mode else None
    return statistics.fmean(values) if values else None


def spans_a_step(records: list, steps: int) -> dict:
    """The port's span records (``utils.profiling.drain``: each span's
    ``id``, ``name``, ``parent``, host interval and ``device_ms``) over
    ``steps`` steps, per name and a step: ``count``; ``host_ms`` and
    ``device_ms``, the spans' intervals; ``host_self_ms`` and
    ``device_self_ms``, each interval less the part its child spans cover
    on that clock (a layer's self time).  A device interval runs on the
    card's clock from the stream's reaching the span to its last kernel's
    end, so it holds the card's wait for the host inside it.  The
    ``device_*`` values are None for a name with no device interval.  What a
    run's ``record["spans"]`` holds."""
    own = {}
    for r in records:
        own[r["id"]] = {"host": (r["host_end_ns"] - r["host_start_ns"]) / 1e6,
                        "device": r["device_ms"]}
    for r in records:
        parent = own.get(r["parent"])
        if parent is None:
            continue
        parent["host"] -= own[r["id"]]["host"]
        if parent["device"] is not None and r["device_ms"] is not None:
            parent["device"] -= r["device_ms"]
    out: dict = {}
    for r in records:
        t = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "device_ms": None,
                                       "host_self_ms": 0.0, "device_self_ms": None})
        t["count"] += 1
        t["host_ms"] += (r["host_end_ns"] - r["host_start_ns"]) / 1e6
        t["host_self_ms"] += own[r["id"]]["host"]
        if r["device_ms"] is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + r["device_ms"]
            t["device_self_ms"] = (t["device_self_ms"] or 0.0) + own[r["id"]]["device"]
    return {name: {key: None if v is None else v / steps for key, v in t.items()}
            for name, t in out.items()}


def span_ms(rec: dict, mode: str, name: str, clock: str):
    """Self milliseconds a step of the span ``name`` in a run of ``mode`` by
    ``clock`` ("device" or "host"), or None where the record has no such
    span or it has no interval on that clock."""
    spans = rec.get("spans") if rec.get("mode") == mode else None
    span = spans.get(name) if spans else None
    return None if span is None else span[f"{clock}_self_ms"]
