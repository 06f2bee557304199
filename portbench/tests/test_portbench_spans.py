"""The seven span readers on synthetic records, and the traced run's span
passes on the CPU."""

import pytest

from portbench.harness import cell as cell_lib
from portbench.harness import drivers, readers, traffic
from portbench.modes import train
from portbench.tests.tiny import tiny_cell

def _span(device_ms, host_ms, count, device_self_ms=None, host_self_ms=None):
    return {"device_ms": device_ms, "host_ms": host_ms, "count": count,
            "device_self_ms": device_ms if device_self_ms is None else device_self_ms,
            "host_self_ms": host_ms if host_self_ms is None else host_self_ms}


SPANS = {"forward": _span(96.5, 74.0, 1.0, 48.25, 33.0),
         "pool": _span(48.25, 40.0, 1.0),
         "loss": _span(35.5, 27.0, 1.0, 2.75, 3.5),
         "match": _span(32.75, 23.0, 1.0),
         "backward": _span(69.0, 44.0, 1.0),
         "optimizer": _span(10.5, 12.5, 1.0),
         "host_read": _span(None, 1.75, 20.0)}
READS = [("forward_ms.train", 48.25), ("pool_ms.train", 48.25), ("loss_ms.train", 2.75),
         ("match_ms.train", 32.75), ("backward_ms.train", 69.0),
         ("optimizer_ms.train", 10.5), ("sync_wait_ms.train", 1.75)]


@pytest.mark.parametrize("metric,value", READS, ids=[m for m, _ in READS])
def test_span_readers(metric, value):
    reader = cell_lib.load_module("metrics", metric)
    rec = {"mode": "train", "window_s": 30.0, "events": 120, "counters": {}, "spans": SPANS}
    assert reader.read(rec) == value
    assert reader.read({**rec, "mode": "serve"}) is None          # another mode
    assert reader.read({**rec, "spans": {}}) is None              # the span absent
    assert reader.read({k: v for k, v in rec.items() if k != "spans"}) is None  # untraced


def _record(id_, name, parent, host_ms, device_ms):
    return {"id": id_, "name": name, "parent": parent, "step": 0, "host_start_ns": 0,
            "host_end_ns": int(host_ms * 1e6), "device_ms": device_ms}


def test_spans_a_step():
    """Intervals summed by name; a span's self time is its interval less
    its children's on the same clock; a step is the total over ``steps``."""
    records = []
    for step in range(2):
        base = 10 * step
        records += [_record(base, "train_step", None, 30.0, 40.0),
                    _record(base + 1, "forward", base, 20.0, 24.0),
                    _record(base + 2, "pool", base + 1, 8.0, 10.0),
                    _record(base + 3, "host_read", base + 2, 2.0, None),
                    _record(base + 4, "host_read", base + 1, 1.0, None)]
    spans = readers.spans_a_step(records, 2)
    assert spans["train_step"] == _span(40.0, 30.0, 1.0, 16.0, 10.0)
    assert spans["forward"] == _span(24.0, 20.0, 1.0, 14.0, 11.0)
    assert spans["pool"] == _span(10.0, 8.0, 1.0, 10.0, 6.0)
    assert spans["host_read"] == {"device_ms": None, "host_ms": 3.0, "count": 2.0,
                                  "device_self_ms": None, "host_self_ms": 3.0}


def test_span_passes_fill_the_record_on_the_cpu():
    from hierarchicalgnn_torch.utils import profiling

    cell = tiny_cell("embin_train", compute_dtype="float32")
    seed = 2147483695
    prog = drivers.PortTrain(cell.hp, "cpu", seed)
    start = prog.save()
    batches = [prog.batch(raw, i) for i, raw in enumerate(traffic.make_pool(seed, cell.traffic))]
    spans = train.span_passes(prog, start, batches, cell.traffic["epoch"], "cpu")
    assert spans["train_step"]["count"] == 1.0  # a step each
    for name in ("forward", "loss", "backward", "optimizer", "readback", "host_read"):
        assert spans[name]["host_ms"] > 0 and spans[name]["device_ms"] is None, name
        assert 0 < spans[name]["host_self_ms"] <= spans[name]["host_ms"], name
        assert spans[name]["device_self_ms"] is None, name
    with profiling.span("after"):  # the recorder is off again
        pass
    assert profiling.drain() == []
