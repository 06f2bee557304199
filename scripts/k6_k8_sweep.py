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


_ERROR = []  # the error word of the bare calls (device-visible host memory)


def one_launch(lib, ins, outs, flags, n, n_bytes, generation, arrivals, info, stream):
    """K8's C entry as one launch for all ``n`` ranks of card 0, with a bound
    of 10 s on its waits (the wrapper's single-card call)."""
    if not _ERROR:
        _ERROR.append(torch.zeros(1, dtype=torch.int64).pin_memory())
    return lib.hgnn_ring_all_gather(ins, outs, flags, n, 0, n, n_bytes, generation, arrivals,
                                    0, 1, int(rg.TIMEOUT_S * 1e9), _ERROR[0].data_ptr(), 0,
                                    info, 0, stream)


def gather_entry(blocks):
    """A bare call of K8's C entry on outputs and pointer tables made once;
    the flag words' generation and arrival count move as the wrapper moves
    them, so the calls stay in step with the wrapper's."""
    n = len(blocks)
    outs = rg._outputs(blocks[0], n)
    stream = rg._stream(blocks[0])
    flags = rg._group_flags(rg._layout(blocks))
    table = rg._table(n)
    ins, outs_p = table(*(b.data_ptr() for b in blocks)), table(*(o.data_ptr() for o in outs))
    lib = rg.library(rg.SOURCE)
    n_bytes = blocks[0].numel() * blocks[0].element_size()

    def call():
        rc = one_launch(lib, ins, outs_p, flags.pointers, n, n_bytes, flags.generation + 1,
                        flags.arrivals, flags.info[0], stream)
        assert rc == 0, rc
        flags.generation += 1
        flags.arrivals += flags.info[0][0]
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
        stream = rg._stream(blocks[0])
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
        n_bytes = b * 256 * 2
        for vlabel, lib in k8_variants.items():
            words = torch.zeros((p, rg.FLAG_WORDS), dtype=torch.int64, device=dev)
            state = {"gen": 0, "arr": 0}
            info = (ctypes.c_int * 5)()
            fl = (ctypes.c_void_p * p)(*(words[r].data_ptr() for r in range(p)))
            ins = table(*[x.data_ptr() for x in blocks])
            outp = table(*[o.data_ptr() for o in outs])

            def call(lib=lib, ins=ins, outp=outp, fl=fl, info=info, state=state):
                rc = one_launch(lib, ins, outp, fl, p, n_bytes, state["gen"] + 1,
                                state["arr"], info, stream)
                assert rc == 0, rc
                state["gen"] += 1
                state["arr"] += info[0]
            call()
            torch.cuda.synchronize()
            assert all(torch.equal(o, want) for o in outs), vlabel
            print(f"  variant {vlabel}: device_ms {dev_ms(call, tag8)} "
                  f"(grid {info[0]}, resident {info[3]}, chunk {info[4]})", flush=True)

    # what the fixed cost of a call is made of: the kernel with parts of its
    # synchronisation contract taken out (for this measurement only; each is
    # still exact on one card, where the stream orders the calls), on a block
    # of 3 bytes and on the flagship halo
    entry = ("      if (!wait_for(t, t.flags[r] + kEnteredAt + q, generation, kEntryTimedOut)) "
             "timed_out = 1;")
    fence = "    __threadfence_system();\n    red_release_sys_add"
    exit_ = "  if (blockIdx.x == 0 && tid < t.n_local) {\n    wait_for("
    coop = "cudaLaunchCooperativeKernel(kernel"
    parts = variants("ring_gather.cu", [
        {"label": "as shipped"},
        {"label": "no entry wait", entry: ";"},
        {"label": "no fence before the arrival", fence: "    red_release_sys_add"},
        {"label": "no exit wait", exit_: "  if (false) {\n    wait_for("},
        {"label": "a plain launch", coop: "cudaLaunchKernel(kernel"},
        {"label": "none of the four", entry: ";", fence: "    red_release_sys_add",
         exit_: "  if (false) {\n    wait_for(", coop: "cudaLaunchKernel(kernel"},
        {"label": "the whole ring of shared memory at every chunk size",
         "args, smem, stream": "args, kSmemBytes, stream"}])
    for shape, dtype in (((3,), torch.bool), ((768, 128), torch.bfloat16),
                         ((6144, 256), torch.bfloat16)):
        blocks = [torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(4)]
        outs = rg._outputs(blocks[0], 4)
        want = torch.cat(blocks, 0)
        table = rg._table(4)
        for vlabel, lib in parts.items():
            words = torch.zeros((4, rg.FLAG_WORDS), dtype=torch.int64, device=dev)
            state = {"gen": 0, "arr": 0}
            info = (ctypes.c_int * 5)()
            fl = (ctypes.c_void_p * 4)(*(words[r].data_ptr() for r in range(4)))
            ins, outp = table(*[x.data_ptr() for x in blocks]), table(*[o.data_ptr() for o in outs])
            stream = rg._stream(blocks[0])

            def call(lib=lib, ins=ins, outp=outp, fl=fl, info=info, state=state,
                     n_bytes=blocks[0].numel() * blocks[0].element_size()):
                rc = one_launch(lib, ins, outp, fl, 4, n_bytes, state["gen"] + 1,
                                state["arr"], info, stream)
                assert rc == 0, rc
                state["gen"] += 1
                state["arr"] += info[0]
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
