"""K8's host side over several launches (``ops/kernels/ring_gather.py``), on
the CPU with no card.

  * The cut kept per layout (``_GroupFlags.plan``) equals
    ``gather_schedule`` for each launch of the layouts that ``chip_smoke.py``
    drives (one launch; 2 + 2 and 1 x 4 launches on streams of one card,
    26(a); one rank a card over four cards, 26(d); a process's two ranks on
    two cards, 26(e)), each grid capped at its card's blocks over the
    launches sharing it, at the sharded forwards' and the process step's
    block shapes and at blocks whose bases sit off 16 bytes.  The launches
    together write every output byte exactly once, with every bulk copy
    16-byte aligned on both sides.  The plan is made once per key (block
    bytes, the pointers' places against 16 bytes) and the library's form of
    it (the int64 table) says the same.
  * With the library replaced by a recorder, one call over 4 launches is one
    call into the library, with the layout, the cut and the arrival target
    that planning every launch separately gives; the generation and the
    arrival count grow across calls and start fresh after ``_retire``;
    ``settle`` reaps the pending calls through the library's events.

The kernel itself runs only on the card (``chip_smoke.py`` phases 3 and 26,
``tests/test_torch_multicard.py``'s ``cuda`` tests).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalgnn_torch.ops.kernels import ring_gather as rg
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

HELD = 132  # K8 blocks an H100 holds at once (one a SM)
ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4, torch.bool: 1}
STREAMS = (7, 9, 11, 13)  # stream handles, as the layouts key them

# (label, P, the (card, stream) of each rank)
LAYOUTS = {
    "one launch": [(0, 7)] * 4,
    "26(a) 2 + 2": [(0, 7), (0, 7), (0, 9), (0, 9)],
    "26(a) 1 x 4": [(0, s) for s in STREAMS],
    "26(d) four cards": [(c, 7) for c in range(4)],
    "26(e) two cards": [(0, 7), (1, 7)],
}


class Recorder:
    """The library's entries, recorded: a layout gets a handle and ``HELD``
    blocks a card; a call issues every launch, which have not ended when
    asked without a wait."""

    def __init__(self):
        self.layouts, self.calls, self.ended, self.freed = [], [], [], []

    def hgnn_k8_layout(self, n, devices, streams, rank0s, n_locals, n_ranks, flags, error,
                       held, handle):
        self.layouts.append({"devices": list(devices), "streams": list(streams),
                             "rank0": list(rank0s), "n_local": list(n_locals),
                             "n_ranks": n_ranks})
        for i in range(n):
            held[i] = HELD
        handle[0] = 1000 + len(self.layouts)
        return 0

    def hgnn_ring_all_gather(self, handle, plan, ins, outs, nbytes, generation, target,
                             timeout_ns, issued):
        n_launches = (len(plan) - 1 - 2 * len(ins)) // 2
        self.calls.append({"handle": handle, "plan": list(plan), "ins": list(ins),
                           "outs": list(outs), "nbytes": nbytes, "generation": generation,
                           "target": target, "timeout_ns": timeout_ns})
        issued[0] = n_launches
        return 0

    def hgnn_k8_ended(self, handle, generation, n_launches, wait):
        self.ended.append((handle, generation, n_launches, wait))
        return 0 if wait else rg.NOT_READY

    def hgnn_k8_layout_free(self, handle):
        self.freed.append(handle)
        return 0


def _cpu_words(launches):
    """``_device_words`` on the CPU: zeroed words, a zeroed error word."""
    n = sum(launch.n_local for launch in launches)
    return list(torch.zeros((n, rg.FLAG_WORDS), dtype=torch.int64).unbind(0)), \
        torch.zeros(1, dtype=torch.int64)


@pytest.fixture
def recorder(monkeypatch):
    """The library and the device side replaced, with the module's layouts
    and pending calls of their own and the launch counts restored after."""
    rec = Recorder()
    monkeypatch.setattr(rg, "_library", lambda: rec)
    monkeypatch.setattr(rg, "_device_words", _cpu_words)
    monkeypatch.setattr(rg, "_FLAGS", {})
    monkeypatch.setattr(rg, "_PENDING", [])
    for key in ("K8", "K8_split"):
        monkeypatch.setitem(sa.LAUNCHES, key, sa.LAUNCHES[key])
    return rec


def _resident(launches):
    """What each launch may hold: its card's blocks over the launches there."""
    cards = [launch.key[0] for launch in launches]
    return [HELD // cards.count(card) for card in cards]


def _largest_chunk(launches):
    """The least chunk where the launches span several cards (the copies go
    over NVLink), else the largest."""
    return rg.MIN_CHUNK if len({l.key[0] for l in launches}) > 1 else rg.CHUNK


def _addresses(n, block_bytes, offset):
    """Input bases ``offset`` bytes past a 16-byte boundary and outputs laid
    out as ``_outputs`` lays them (one allocation, each on a 16-byte
    boundary), on the card of each launch."""
    outs = rg._outputs(torch.empty(block_bytes, dtype=torch.uint8), n)
    base = outs[0].data_ptr()
    return ([(1 << 20) * (r + 1) + offset for r in range(n)],
            [(1 << 24) + o.data_ptr() - base for o in outs])


def _covered(cuts, block_bytes, ins, outs):
    """Every (rank, first byte, last byte + 1) span that the launches of
    ``cuts`` write into every output, checking each bulk copy's alignment on
    both sides and each vector span's; asserts the spans tile every output
    exactly once."""
    n = len(ins)
    spans = []
    for cut in cuts:
        assert len(cut.pairs()) == cut.n_pairs
        assert {r for r, _ in cut.pairs()} <= set(cut.served())
        for r, c in cut.pairs():
            off = cut.head[r] + c * cut.chunk
            nbytes = min(cut.chunk, cut.bulk[r] - c * cut.chunk)
            assert 0 < nbytes <= cut.chunk and nbytes % 16 == 0
            assert (ins[r] + off) % 16 == 0
            assert all((out + r * block_bytes + off) % 16 == 0 for out in outs)
            spans.append((r * block_bytes + off, r * block_bytes + off + nbytes))
        for r in cut.served():
            for lo, hi in ((0, cut.head[r]), (cut.head[r] + cut.bulk[r], block_bytes)):
                assert lo % cut.vector == 0 and hi % cut.vector == 0
                if hi > lo:
                    spans.append((r * block_bytes + lo, r * block_bytes + hi))
    spans.sort()
    end = 0
    for lo, hi in spans:
        assert lo == end, "a byte written twice or never"
        end = hi
    assert end == n * block_bytes


def _cases(label):
    """(shape, dtype, offset) of the blocks that the layout's phase hands K8:
    the sharded forwards' at P 4, the process step's at P 2, and blocks
    whose bases sit 12 and 4 bytes past 16 (heads and tails on every rank)."""
    shapes = chip_smoke.K8_PROCESS_SHAPES if label.startswith("26(e)") else \
        chip_smoke.K8_PATH_SHAPES
    return [(shape, dtype, 0) for shape in shapes for dtype in ITEM] + [
        ((1001, 3), torch.float32, 12), ((768, 4), torch.float32, 4), ((7, 3), torch.bool, 1)]


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_plan_per_layout_is_gather_schedule(recorder, label):
    """For every block the layout's phase hands K8: the plan kept per layout
    is ``gather_schedule`` of each launch at its capped grid, its table says
    the same, the launches write every output byte once; a plan is made once
    per key, and bases in another place against 16 bytes get their own."""
    keys = LAYOUTS[label]
    launches = rg.launch_groups(keys)
    flags = rg._group_flags(launches)
    assert flags.resident == _resident(launches)
    assert recorder.layouts == [{
        "devices": [l.key[0] for l in launches], "streams": [l.key[1] for l in launches],
        "rank0": [l.rank0 for l in launches], "n_local": [l.n_local for l in launches],
        "n_ranks": len(keys)}]
    n = len(keys)
    for shape, dtype, offset in _cases(label):
        block_bytes = int(np.prod(shape)) * ITEM[dtype]
        ins, outs = _addresses(n, block_bytes, offset)
        plan = flags.plan(block_bytes, ins, outs)
        want = [rg.gather_schedule(block_bytes, ins, outs, cap, l.rank0, l.n_local,
                                   _largest_chunk(launches))
                for l, cap in zip(launches, flags.resident)]
        assert list(plan.cuts) == want, (shape, dtype, offset)
        assert plan.blocks == sum(cut.grid for cut in want)
        assert all(1 <= cut.grid <= cap for cut, cap in zip(want, flags.resident))
        words = list(plan.table)
        assert words[0] == want[0].vector
        assert words[1:1 + 2 * len(launches)] == [x for c in want for x in (c.grid, c.chunk)]
        assert words[1 + 2 * len(launches):] == [
            x for r in range(n) for x in (want[0].head[r], want[0].bulk[r])]
        _covered(plan.cuts, block_bytes, ins, outs)
        if offset == 0 and block_bytes % 16 == 0:  # the path's blocks go by bulk copies
            assert sum(want[0].bulk) == n * block_bytes, (shape, dtype)
        assert all(rg.MIN_CHUNK <= cut.chunk <= _largest_chunk(launches) for cut in want)
        # the same places against 16 bytes: the same plan, not a new one
        moved = flags.plan(block_bytes, [a + 4096 for a in ins], [a + 512 for a in outs])
        assert moved is plan
    # bases off 16 bytes where the first case's were on it: a plan of their own
    shape, dtype, _ = _cases(label)[0]
    block_bytes = int(np.prod(shape)) * ITEM[dtype]
    aligned = flags.plan(block_bytes, *_addresses(n, block_bytes, 0))
    off = flags.plan(block_bytes, *_addresses(n, block_bytes, 8))
    assert off is not aligned and off.cuts[0].head != aligned.cuts[0].head


@pytest.mark.parametrize("label", ["26(d) four cards", "26(a) 2 + 2", "26(a) 1 x 4",
                                   "26(e) two cards"])
def test_one_library_call_per_k8_call(recorder, monkeypatch, label):
    """A K8 call over several launches through the wrapper: one call into
    the library, with the layout's handle, the plan and the arrival target
    that planning each launch separately gives (the sum of every launch's
    grid over the calls so far), the generation counting the calls; the
    launches counted one each, the calls pending until ``settle`` reaps them
    through the library's events; after ``_retire`` a fresh layout starts
    again at generation 1."""
    keys = LAYOUTS[label]
    launches = rg.launch_groups(keys)
    n = len(keys)
    monkeypatch.setattr(rg, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(rg, "_layout", lambda blocks, streams=None: launches)
    outputs = rg._outputs
    monkeypatch.setattr(rg, "_outputs", lambda first, n_ranks, count=None, device=None:
                        outputs(first, n_ranks, count))
    gen = np.random.default_rng(17)
    blocks = [torch.from_numpy(gen.normal(size=(24, 8)).astype(np.float32))
              for _ in range(n)]
    before = dict(sa.LAUNCHES)
    grids = None
    for call in (1, 2, 3):
        if call == 3:
            flags = rg._group_flags(launches)
            assert len(rg._PENDING) == 2 and all(c.flags is flags for c in rg._PENDING)
            rg.settle()
            assert not rg._PENDING
            # each call asked after the oldest pending one without a wait
            assert recorder.ended == [(flags.handle, 1, len(launches), 0),
                                      (flags.handle, 1, len(launches), 1),
                                      (flags.handle, 2, len(launches), 1)]
            rg._retire(flags)
        outs = rg.ring_all_gather(blocks)
        assert len(outs) == n and all(o.shape == (24 * n, 8) for o in outs)
        record = recorder.calls[-1]
        ins = [b.data_ptr() for b in blocks]
        out_at = [o.data_ptr() for o in outs]
        assert record["ins"] == ins and record["outs"] == out_at
        assert record["nbytes"] == 24 * 8 * 4
        assert record["timeout_ns"] == int(rg.TIMEOUT_S * 1e9)
        # the old plan-only pass: each launch's grid, planned on its own
        planned = [rg.gather_schedule(24 * 8 * 4, ins, out_at, cap, l.rank0, l.n_local,
                                      _largest_chunk(launches))
                   for l, cap in zip(launches, _resident(launches))]
        grids = [cut.grid for cut in planned]
        rounds = 1 if call == 3 else call
        assert record["generation"] == rounds
        assert record["target"] == rounds * sum(grids)
        flags = rg._group_flags(launches)
        assert record["handle"] == flags.handle
        assert record["plan"] == list(flags.plan(24 * 8 * 4, ins, out_at).table)
        assert [(c.grid, c.vector, c.n_pairs, c.chunk) for c in flags.last.cuts] == [
            (c.grid, c.vector, c.n_pairs, c.chunk) for c in planned]
        assert rg.launch_info(blocks) == [(c.grid, c.vector, c.n_pairs, cap, c.chunk)
                                          for c, cap in zip(planned, _resident(launches))]
    assert len(recorder.calls) == 3  # one library call per K8 call
    assert len(recorder.layouts) == 2  # the retired layout's flags, then fresh ones
    assert sa.LAUNCHES["K8"] - before["K8"] == 3 * len(launches)
    assert sa.LAUNCHES["K8_split"] - before["K8_split"] == 3 * len(launches)
    rg.settle()
    assert not rg._PENDING


def test_a_failed_launch_retires_the_layout(recorder, monkeypatch):
    """The library issues 2 of 4 launches and fails the third: the two are
    counted and pending, the layout is retired (the issued launches wait
    for the others until their bound) and the call raises; the next call
    makes a fresh layout."""
    launches = rg.launch_groups(LAYOUTS["26(d) four cards"])
    monkeypatch.setattr(rg, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(rg, "_layout", lambda blocks, streams=None: launches)
    outputs = rg._outputs
    monkeypatch.setattr(rg, "_outputs", lambda first, n_ranks, count=None, device=None:
                        outputs(first, n_ranks, count))
    issue = recorder.hgnn_ring_all_gather

    def fails_third(*args):
        issue(*args)
        args[-1][0] = 2
        return 719  # cudaErrorLaunchFailure

    monkeypatch.setattr(recorder, "hgnn_ring_all_gather", fails_third)
    blocks = [torch.ones(3, 2) * r for r in range(4)]
    before = sa.LAUNCHES["K8"]
    flags = rg._group_flags(launches)
    with pytest.raises(RuntimeError, match="cudaError 719"):
        rg.ring_all_gather(blocks)
    assert sa.LAUNCHES["K8"] - before == 2
    assert flags.retired and rg._FLAGS.get(launches) is not flags
    assert [(c.generation, c.issued) for c in rg._PENDING] == [(1, 2)]
    assert flags.generation == 0 and flags.last is None
    rg.settle()
    monkeypatch.setattr(recorder, "hgnn_ring_all_gather", issue)
    rg.ring_all_gather(blocks)
    assert len(recorder.layouts) == 2 and recorder.calls[-1]["generation"] == 1
    rg.settle()
