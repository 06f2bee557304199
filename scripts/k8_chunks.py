#!/usr/bin/env python3
"""K8 (``csrc/ring_gather.cu``) at each chunk size of its bulk copies, and
what bounds a call: the device or the host.

    python3 scripts/k8_chunks.py

For one launch on card 0 (P 4, [6144, 256], the HBM route) and, where the
host has the cards, one rank a card over four cards (P 4, [6144, 256]) and
over two (P 2, [12288, 256]: a process of ``chip_smoke.py`` 26(e)), bf16 and
f32: the library's entry called back to back with a plan made once at each
chunk size (``gather_schedule`` with every chunk that size), so the host
issues faster than the device runs: ms per call by CUDA events
(``chip_smoke.time_streams``, device-bound) and block 0's run us per launch
(the kernel's own timer); every output checked against ``torch.cat``.
Beside them, at the chunk the package plans: the wrapper's host us per call
and the bare entry's (100 calls enqueued without a wait), and, over the
cards, NCCL's all-gather of the same blocks (``torch.cuda.nccl``, one call,
ms and host us).  Prints the cards' ``nvidia-smi`` lines first and one JSON
line last.  Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import ring_gather as rg  # noqa: E402


def host_us(fn, cards, reps=100):
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    for d in cards:
        torch.cuda.synchronize(d)
    return us


def bare_entry(blocks, outs, chunk=None):
    """The library's entry on ``blocks``' layout and ``outs``, with the plan
    made once (at ``chunk`` as the largest chunk, or the package's); the
    layout's generation and arrival count move as the wrapper moves them."""
    flags = rg._group_flags(rg._layout(blocks))
    n_bytes = blocks[0].numel() * blocks[0].element_size()
    ins, outs_at = [b.data_ptr() for b in blocks], [o.data_ptr() for o in outs]
    saved = rg.CHUNK, rg.MIN_CHUNK
    if chunk is not None:  # every chunk of the plan that size
        rg.CHUNK = rg.MIN_CHUNK = chunk
    plan = rg._plan(n_bytes, ins, outs_at, flags.launches, flags.resident)
    rg.CHUNK, rg.MIN_CHUNK = saved
    table = rg._table(len(blocks))
    args = (flags.handle, plan.table, table(*ins), table(*outs_at), n_bytes)
    issued, entry = (ctypes.c_int * 1)(), rg._entry()

    def call():
        rc = entry(*args, flags.generation + 1, flags.arrivals + plan.blocks,
                   int(rg.TIMEOUT_S * 1e9), issued)
        assert rc == 0, rc
        flags.generation += 1
        flags.arrivals += plan.blocks
    call.flags, call.plan = flags, plan
    return call


def measure(label, devices, rows, dtype, chunks, gen):
    cards = sorted(set(devices), key=lambda d: d.index)
    streams = [torch.cuda.current_stream(d) for d in cards]
    blocks = [torch.randn((rows, 256), generator=gen).to(dtype).to(d) for d in devices]
    want = torch.cat([b.cpu() for b in blocks], 0)
    outs = rg.ring_all_gather(blocks)
    rg.settle()
    record = {"layout": label, "dtype": str(dtype)[6:], "chunks": []}
    for chunk in chunks:
        call = bare_entry(blocks, outs, chunk)
        for o in outs:
            o.zero_()
        call()
        for d in cards:
            torch.cuda.synchronize(d)
        exact = all(torch.equal(o.cpu(), want) for o in outs)
        assert exact, (label, dtype, chunk)
        before = [call.flags.words[l.rank0][rg.LAUNCH_AT].item() for l in call.flags.launches]
        ms = c.time_streams(torch, call, streams)
        for d in cards:
            torch.cuda.synchronize(d)
        after = [call.flags.words[l.rank0][rg.LAUNCH_AT].item() for l in call.flags.launches]
        run = [round((b - a) / 300 / 1e3, 2) for a, b in zip(before, after)]  # 200 warm + 100
        cut = call.plan.cuts[0]
        row = {"chunk": cut.chunk, "grid": cut.grid, "pairs": cut.n_pairs, "exact": exact,
               "device_bound_ms": ms, "run_us": run}
        record["chunks"].append(row)
        print(f"{label} {str(dtype)[6:]} chunk {cut.chunk} (grid {cut.grid}, pairs "
              f"{cut.n_pairs}): exact, device-bound {ms:.4f} ms a call, block 0 runs {run} us",
              flush=True)
    fn = lambda: rg.ring_all_gather(blocks)
    record["package_chunk"] = rg.launch_info(blocks)[0][4]
    record["wrapper_host_us"] = host_us(fn, cards)
    rg.settle()
    record["entry_host_us"] = host_us(bare_entry(blocks, outs), cards)
    record["wrapper_ms"] = c.time_streams(torch, fn, streams)
    rg.settle()
    if len(cards) == len(devices) > 1:
        record["nccl_ms"], record["nccl_host_us"], exact = c.nccl_gather_timings(
            torch, blocks, outs, streams)
        assert exact
    print(f"{label} {str(dtype)[6:]} at the package's chunk {record['package_chunk']}: wrapper "
          f"{record['wrapper_ms']:.4f} ms a call, host {record['wrapper_host_us']:.1f} us, the "
          f"bare entry's host {record['entry_host_us']:.1f} us; NCCL "
          f"{record.get('nccl_ms')} ms, host {record.get('nccl_host_us')} us", flush=True)
    return record


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    c.phase_build()
    gen = torch.Generator().manual_seed(17)
    count = torch.cuda.device_count()
    card = torch.device("cuda", 0)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        records.append(measure("one launch on one card, P 4", [card] * 4, 6144, dtype,
                               (32768, 16384, 8192, 4096), gen))
    if count >= 4:
        cards = [torch.device("cuda", i) for i in range(4)]
        for dtype in (torch.bfloat16, torch.float32):
            records.append(measure("one rank a card over 4 cards, P 4", cards, 6144, dtype,
                                   (16384, 8192, 4096, 2048), gen))
    if count >= 2:
        records.append(measure("one rank a card over 2 cards, P 2",
                               [torch.device("cuda", 0), torch.device("cuda", 1)], 12288,
                               torch.bfloat16, (16384, 8192, 4096, 2048), gen))
    print(json.dumps({"k8_chunks": records}))


if __name__ == "__main__":
    sys.exit(main())
