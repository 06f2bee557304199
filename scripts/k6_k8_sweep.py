#!/usr/bin/env python3
"""K6 (``csrc/top2.cu``) and K8 (``csrc/ring_gather.cu``) on one CUDA card:
the device time per call from the profiler and the host cost of one wrapper
call beside a bare call of its ctypes entry, at the shapes ``chip_smoke.py``
phase 3 times them.

    python3 scripts/k6_k8_sweep.py

One line per input: ``ms`` (CUDA events over 20 calls), the profiler's
device ms per call, then host microseconds per call (100 calls enqueued
without a wait) of the wrapper, of the bare ctypes entry with its arguments
made beforehand, of the library call and of the wrapper's other parts.
Then the card's practical rates on the same bytes (the profiler's device
time of a row reduction, a copy, a fill and the P ``torch.cat``s), and the
kernels with other values of their cut's constants (a copy of each source
with the constants replaced, built beside the package's libraries and
launched through the same C entry).  Needs a card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import build, ring_gather as rg, top2  # noqa: E402


def host_us(fn, reps=100):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def top2_entry(a, prices):
    """A bare call of K6's C entry on an output made once."""
    p, cols = a.shape
    out = torch.empty((3, p), dtype=torch.int32, device=a.device)
    cut = top2.top2_schedule(p, cols, top2._sm_count(a.get_device()))
    entry = top2._entry()
    args = (a.data_ptr(), prices.data_ptr(), out.data_ptr(), p, cols, cut.warps_per_row,
            cut.grid, rg._stream(a))
    return lambda: entry(*args)


def gather_entry(blocks):
    """A bare call of K8's C entry on outputs, pointer tables and a plan made
    once; the flag words' generation and arrival count move as the wrapper
    moves them, so the calls stay in step with the wrapper's."""
    n = len(blocks)
    outs = rg._outputs(blocks[0], n)
    flags = rg._group_flags(rg._layout(blocks))
    table = rg._table(n)
    ins, outs_at = [b.data_ptr() for b in blocks], [o.data_ptr() for o in outs]
    n_bytes = blocks[0].numel() * blocks[0].element_size()
    plan = flags.plan(n_bytes, ins, outs_at)
    args = (flags.handle, plan.table, table(*ins), table(*outs_at), n_bytes)
    timeout_ns, issued, entry = int(rg.TIMEOUT_S * 1e9), (ctypes.c_int * 1)(), rg._entry()

    def call():
        rc = entry(*args, flags.generation + 1, flags.arrivals + plan.blocks, timeout_ns,
                   issued)
        assert rc == 0, rc
        flags.generation += 1
        flags.arrivals += plan.blocks
    return call


def variant_call(lib, blocks, outs, consts=None):
    """K8 through the C entries of ``lib`` (a variant's library) as one
    launch for all ranks of the blocks' card, on a layout and flag words of
    its own, the plan made by ``gather_schedule`` with ``consts`` (CHUNK,
    MIN_CHUNK) in place of the package's.  Returns the call; ``call.cut`` is
    its cut and ``call.resident`` the blocks the card holds."""
    n = len(blocks)
    device = blocks[0].get_device()
    words = torch.zeros((n, rg.FLAG_WORDS), dtype=torch.int64, device=blocks[0].device)
    torch.cuda.synchronize()
    error = torch.zeros(1, dtype=torch.int64).pin_memory()
    ints = ctypes.c_int * 1
    held, handle = ints(), (ctypes.c_void_p * 1)()
    table = rg._table(n)
    rc = lib.hgnn_k8_layout(1, ints(device), (ctypes.c_void_p * 1)(rg._stream(blocks[0])),
                            ints(0), ints(n), n, table(*(w.data_ptr() for w in words)),
                            error.data_ptr(), held, handle)
    assert rc == 0, rc
    ins, outs_at = [b.data_ptr() for b in blocks], [o.data_ptr() for o in outs]
    n_bytes = blocks[0].numel() * blocks[0].element_size()
    saved = {k: getattr(rg, k) for k in (consts or {})}
    try:
        for k, v in (consts or {}).items():
            setattr(rg, k, v)
        plan = rg._plan(n_bytes, ins, outs_at, rg._layout(blocks), [held[0]])
    finally:
        for k, v in saved.items():
            setattr(rg, k, v)
    args = (handle[0], plan.table, table(*ins), table(*outs_at), n_bytes)
    state = {"gen": 0, "arr": 0}
    issued = ints()

    def call():
        rc = lib.hgnn_ring_all_gather(*args, state["gen"] + 1, state["arr"] + plan.blocks,
                                      int(rg.TIMEOUT_S * 1e9), issued)
        assert rc == 0, rc
        state["gen"] += 1
        state["arr"] += plan.blocks
    call.cut, call.resident, call.keep = plan.cuts[0], held[0], (words, error)
    return call


def dev_ms(fn, tag):
    """The profiler's device ms per call of ``fn`` in kernels named with
    ``tag`` ('' for every kernel), as text."""
    found = c.device_ms(torch, fn, (tag,))[tag]
    return "not measured" if found is None else f"{found:.4f}"


def variants(source, values):
    """{label: library} of ``source`` built once for each dict in ``values``
    (all nvcc runs started together): a name of a constant maps to its new
    value, a text of the source (its first match) to the text that replaces
    it; the label is the dict's keys and values, or its "label" key."""
    procs = {}
    for consts in values:
        text = (build.CSRC_DIR / source).read_text()
        consts = dict(consts)
        label = consts.pop("label", None)
        for name, value in consts.items():
            if name.isidentifier():
                text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
            else:
                n = text.count(name)
                text = text.replace(name, value, 1)
            assert n >= 1, name
        label = label or " ".join(f"{k} {v}" for k, v in consts.items())
        stem = build.BUILD_DIR / f"variant_{Path(source).stem}_{abs(hash(label)):x}"
        stem.with_suffix(".cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
               str(stem.with_suffix(".cu"))]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                         stderr=subprocess.DEVNULL), stem)
    libs = {}
    for label, (proc, stem) in procs.items():
        assert proc.wait() == 0, label
        lib = ctypes.CDLL(str(stem.with_suffix(".so")))
        for name, argtypes in build.SIGNATURES[source].items():
            getattr(lib, name).argtypes = list(argtypes)
        libs[label] = lib
    return libs


def main():
    c.phase_device(torch)
    c.phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    cols = 3072
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k6_variants = variants("top2.cu", [{"kBatch": b, "kSmemCols": cols}
                                       for b in (4, 8) for cols in (top2.SMEM_COLS, 0)])
    k8_variants = variants("ring_gather.cu", [
        {"kChunk": ch, "kStages": st, "kAhead": ah, "kMinChunk": least}
        for ch, st, ah, least in ((32768, 6, 3, 2048), (16384, 8, 4, 2048), (32768, 6, 3, 8192),
                                  (32768, 4, 2, 2048), (32768, 6, 4, 2048),
                                  (16384, 12, 6, 2048))])
    # the cut is planned in Python: each variant's chunk sizes, for gather_schedule
    k8_cuts = {label: {"CHUNK": int(label.split()[1]), "MIN_CHUNK": int(label.split()[-1])}
               for label in k8_variants}
    tag6, tag8 = c.PROFILE_TAGS["K6"], c.PROFILE_TAGS["K8"]
    for p, label in ((4096, "full sweep"), (256, "tail sweep")):
        a = torch.rand(p, cols, generator=gen) * 40.0
        a[torch.rand(p, cols, generator=gen) < 0.99] = top2.NEG
        prices = (torch.rand(cols, generator=gen) * 3.0).to(dev)
        a = a.to(dev)
        fn = lambda: top2.row_top2(a, prices)
        want = top2.row_top2_plain(a, prices)
        assert all(torch.equal(x, y) for x, y in zip(fn(), want))
        found = c.device_ms(torch, fn, (tag6,))[tag6]
        cut = top2.top2_schedule(p, cols, sms)
        host = {"wrapper": host_us(fn), "ctypes entry": host_us(top2_entry(a, prices)),
                "library": host_us(lambda: torch.topk(a - prices[None, :], 2)),
                "output": host_us(lambda: torch.empty((3, p), dtype=torch.int32, device=dev)),
                "schedule": host_us(lambda: top2.top2_schedule(p, cols, top2._sm_count(0)))}
        print(f"K6 {label} P={p} C={cols} ({cut}): ms {c.time_ms(torch, fn):.4f} device_ms "
              f"{found} | host us " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()),
              flush=True)
        rates = {"a.amax(1)": lambda: a.amax(1), "a.sum(1)": lambda: a.sum(1)}
        print(f"  reads of the same {4 * p * cols} bytes: " + ", ".join(
            f"{k} {dev_ms(f, '')} ms" for k, f in rates.items()),
            flush=True)
        out = torch.empty((3, p), dtype=torch.int32, device=dev)
        stream = rg._stream(a)
        for vlabel, lib in k6_variants.items():
            for w in sorted({cut.warps_per_row, 1, 2, 4, 8}):
                rpb = top2.WARPS // w
                grid = max(1, min(-(-p // rpb), top2.BLOCKS_PER_SM * sms))
                call = lambda: lib.hgnn_row_top2_f32(a.data_ptr(), prices.data_ptr(),
                                                     out.data_ptr(), p, cols, w, grid, stream)
                call()
                torch.cuda.synchronize()
                assert torch.equal(out[1], want[1]), (vlabel, w)
                print(f"  variant {vlabel}, {w} warp(s) a row, grid {grid}: device_ms "
                      f"{dev_ms(call, tag6)}", flush=True)
    for p, b in ((2, 12288), (4, 6144), (8, 3072)):
        blocks = [torch.randn(b, 256, generator=gen).to(dev, torch.bfloat16) for _ in range(p)]
        fn = lambda: rg.ring_all_gather(blocks)
        want = torch.cat(blocks, 0)
        assert all(torch.equal(o, want) for o in fn())
        found = c.device_ms(torch, fn, (tag8,))[tag8]
        outs = rg._outputs(blocks[0], p)
        table = rg._table(p)
        host = {"wrapper": host_us(fn), "ctypes entry": host_us(gather_entry(blocks)),
                "library": host_us(lambda: [torch.cat(blocks, 0) for _ in range(p)]),
                "outputs": host_us(lambda: rg._outputs(blocks[0], p)),
                "tables": host_us(lambda: (table(*[x.data_ptr() for x in blocks]),
                                           table(*[o.data_ptr() for o in outs]))),
                "checks": host_us(lambda: rg._check_blocks(blocks)),
                "flags": host_us(lambda: rg._group_flags(rg._layout(blocks)))}
        print(f"K8 bf16 P={p} block [{b}, 256]: ms {c.time_ms(torch, fn):.4f} device_ms "
              f"{found} | host us " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()),
              flush=True)
        big = torch.empty(p * p * b * 256, dtype=torch.bfloat16, device=dev)
        src = torch.cat(blocks, 0).reshape(-1)
        rates = {"P torch.cat": lambda: [torch.cat(blocks, 0) for _ in range(p)],
                 "fill of the P outputs": lambda: big.fill_(1.0),
                 "copy of the P outputs' bytes": lambda: big.view(p, -1).copy_(
                     src[None, :].expand(p, -1))}
        print(f"  the same {p * p * b * 512} bytes written: " + ", ".join(
            f"{k} {dev_ms(f, '')} ms" for k, f in rates.items()),
            flush=True)
        for vlabel, lib in k8_variants.items():
            call = variant_call(lib, blocks, outs, k8_cuts[vlabel])
            call()
            torch.cuda.synchronize()
            assert all(torch.equal(o, want) for o in outs), vlabel
            print(f"  variant {vlabel}: device_ms {dev_ms(call, tag8)} "
                  f"(grid {call.cut.grid}, resident {call.resident}, chunk {call.cut.chunk})",
                  flush=True)

    # what the fixed cost of a call is made of: the kernel with parts of its
    # synchronisation contract taken out (for this measurement only; each is
    # still exact on one card, where the stream orders the calls), on a block
    # of 3 bytes and on the flagship halo
    entry = ("      if (!wait_for(t, t.flags[r] + kEnteredAt + q, generation, kEntryTimedOut)) "
             "timed_out = 1;")
    fence = "    __threadfence_system();\n    red_release_sys_add"
    exit_ = "  if (blockIdx.x == 0 && tid < t.n_local) {\n    wait_for("
    coop = "cudaLaunchCooperativeKernel(kKernels[kind]"
    parts = variants("ring_gather.cu", [
        {"label": "as shipped"},
        {"label": "no entry wait", entry: ";"},
        {"label": "no fence before the arrival", fence: "    red_release_sys_add"},
        {"label": "no exit wait", exit_: "  if (false) {\n    wait_for("},
        {"label": "a plain launch", coop: "cudaLaunchKernel(kKernels[kind]"},
        {"label": "none of the four", entry: ";", fence: "    red_release_sys_add",
         exit_: "  if (false) {\n    wait_for(", coop: "cudaLaunchKernel(kKernels[kind]"},
        {"label": "the whole ring of shared memory at every chunk size",
         "static_cast<size_t>(kStages) * t.chunk,": "kSmemBytes,"}])
    for shape, dtype in (((3,), torch.bool), ((768, 128), torch.bfloat16),
                         ((6144, 256), torch.bfloat16)):
        blocks = [torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4)]
        outs = rg._outputs(blocks[0], 4)
        want = torch.cat(blocks, 0)
        for vlabel, lib in parts.items():
            call = variant_call(lib, blocks, outs)
            call()
            torch.cuda.synchronize()
            assert all(torch.equal(o, want) for o in outs), vlabel
            print(f"K8 P=4 {list(shape)} {str(dtype)[6:]}, {vlabel}: device_ms "
                  f"{dev_ms(call, tag8)}", flush=True)

    # the blocks the sharded forwards hand K8 at P 4, and two that are
    # almost nothing: the launch's fixed cost (entry, arrival, exit)
    for shape, dtype in (((6144, 3), torch.float32), ((6144, 128), torch.bfloat16),
                         ((768, 128), torch.bfloat16), ((36864, 128), torch.bfloat16),
                         ((6144,), torch.bool), ((36864,), torch.float32),
                         ((3,), torch.bool), ((0, 8), torch.float32)):
        blocks = [torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4)]
        fn = lambda: rg.ring_all_gather(blocks)
        assert all(torch.equal(o, torch.cat(blocks, 0)) for o in fn())
        (grid, _, _, _, chunk), = rg.launch_info(blocks)
        print(f"K8 P=4 {list(shape)} {str(dtype)[6:]}: device_ms {dev_ms(fn, tag8)} (grid "
              f"{grid}, chunk {chunk}) | P torch.cat "
              f"{dev_ms(lambda: [torch.cat(blocks, 0) for _ in range(4)], '')}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
