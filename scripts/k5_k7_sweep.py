#!/usr/bin/env python3
"""K5 (``csrc/segment_csr.cu``, the int32 segment min of a connected-components
hop) and K7 (``csrc/segment_gather.cu``, the gather-layout segment sum) on one
CUDA card: the device time per call from the profiler and the host cost of
one wrapper call beside a bare call of its ctypes entry.

    python3 scripts/k5_k7_sweep.py [--root DIR]

``--root`` measures the package of another checkout (an unpacked parent
commit, say), so that two versions are compared on one card in one call.

K5 runs on the CC hop of the flagship flat graph (E 98304 into N 24576, a row
of degree 5000), the same graph without its hub row, one rank's hop of the
sharded forward (36864 edges into 6144 nodes) and the hub input of
``chip_smoke.tile_cases`` (rows of degree 5000 and 50000); K7 on the flat
graph's unsorted edge rows at D 256, 128, 100 and 3, bf16 and f32.  One line
per input: ``ms`` (CUDA events over 20 calls), the profiler's device ms per
call (K7: tile kernel + fix-up), the bytes bound, then host microseconds per
call (100 calls enqueued without a wait) of the wrapper, of the bare ctypes
entry with its arguments made beforehand, and of the library call.  The
device time of a one-element fill stands for the floor of a launch.  Where the
package cuts K5 or K7 into tiles, the device ms at each tile size follows.
Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ARGS = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ARGS.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                  help="checkout whose package is measured (default: this one)")
ROOT = Path(ARGS.parse_args().root).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import build  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import segment_gather as sg  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa  # noqa: E402


def host_us(fn, reps=100):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def dev_ms(fn, tags):
    """The profiler's device ms per call of ``fn``, summed over the kernels
    named by ``tags``; None if it saw none of them."""
    found = [v for v in c.device_ms(torch, fn, tags).values() if v is not None]
    return sum(found) if found else None


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def k5_entry(vals, plan):
    """A bare call of K5's C entry on an output (and scratch) made once."""
    n, e = plan.num_segments, vals.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=vals.device)
    stream = sa._stream(vals)
    lib = build.library()
    if len(build.SIGNATURES["segment_csr.cu"]["hgnn_csr_min_i32"]) == 5:  # one warp a row
        args = (vals.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(), n, stream)
    else:
        arrivals, mins = sa._min_scratch(vals.device, stream, n)
        args = (vals.data_ptr(), plan.receivers_i32.data_ptr(), plan.row_ptr.data_ptr(),
                out.data_ptr(), arrivals.data_ptr(), mins.data_ptr(), e, n,
                sa.min_tiling(e).tile, stream)
    return lambda: lib.hgnn_csr_min_i32(*args)


def k7_entry(data, layout):
    """A bare call of K7's C entry on an output (and scratch) made once."""
    (e, d), n = data.shape, layout.num_segments
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    stream = sa._stream(data)
    name = sg._ENTRY[data.dtype]
    fn = getattr(build.library(sg.SOURCE), name)
    if len(build.SIGNATURES[sg.SOURCE][name]) == 7:  # one block a row
        args = (data.data_ptr(), layout.perm.data_ptr(), layout.row_ptr.data_ptr(),
                out.data_ptr(), n, d, stream)
    else:
        width = sg.load_width(d, data.element_size(), data.data_ptr())
        cut = sa.csr_tiling(e, n, d, data.element_size(), width, sg.MIN_THREADS)
        partials = sa._partials(data.device, stream, cut.scratch_rows * d)
        args = (data.data_ptr(), layout.perm.data_ptr(), layout.slot_receivers.data_ptr(),
                layout.row_ptr.data_ptr(), out.data_ptr(), partials.data_ptr(), e, n, d,
                cut.tile, cut.lanes, width, stream)
    return lambda: fn(*args)


def forced_tiles(set_tile, clear, fn, tags, sizes):
    """Device ms of ``fn`` with the package's tile size forced to each of
    ``sizes`` (``set_tile(size)``; ``set_tile(None)`` restores it)."""
    times = []
    for size in sizes:
        set_tile(size)
        clear()
        times.append(f"T{size} {fmt(dev_ms(fn, tags))}")
    set_tile(None)
    clear()
    return " | ".join(times)


def main():
    c.phase_device(torch)
    c.phase_build()
    log = lambda msg: print(msg, flush=True)
    log(f"package measured: {ROOT}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)

    def hubless(torch, e, n, gen):
        s, r, m = c.ragged_receivers(torch, e, n, gen)
        r[:5000] = torch.randint(0, n, (5000,), generator=gen)
        return s, r, m

    def hub_input(torch, e, n, gen):
        label, degrees, n_invalid = c.tile_cases(128)[-1]
        return degrees, n_invalid

    k5_cases = [("CC hop", 98304, 24576, c.ragged_receivers),
                ("CC hop without the hub row", 98304, 24576, hubless),
                ("per-rank CC hop", 36864, 6144, c.partitioned_receivers),
                ("rows of degree 5000 and 50000", None, None, hub_input)]
    tag5 = (c.PROFILE_TAGS["K5"],)
    tiled5 = hasattr(sa, "min_tiling")
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    log(f"launch floor: a one-element fill, device_ms {fmt(dev_ms(lambda: one.fill_(7), ('',)))}")
    for label, e, n, make in k5_cases:
        if e is None:
            degrees, n_invalid = make(torch, e, n, gen)
            plan = c.degree_plan(torch, degrees, n_invalid, dev)
            e, n = plan.perm.shape[0], len(degrees)
        else:
            s, r, m = make(torch, e, n, gen)
            plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
        n_valid = int(plan.row_ptr[-1])
        vals = plan.sort(torch.randint(0, n, (e,), generator=gen, dtype=torch.int32).to(dev))
        vals = torch.where(plan.edge_mask_sorted, vals, sa.INT32_MAX)
        fn = lambda: sa.sorted_segment_min_i32(vals, plan)
        want = sa.sorted_segment_min_i32_plain(vals, plan)
        assert torch.equal(fn(), want), label
        recv = plan.receivers_sorted[:n_valid]
        vv = vals[:n_valid].contiguous()
        library = lambda: torch.full((n,), sa.INT32_MAX, dtype=torch.int32,
                                     device=dev).scatter_reduce_(0, recv, vv, "amin")
        bound = 1e3 * (4 * n_valid + 4 * (n + 1) + 4 * n) / c.HBM_BYTES_PER_S
        host = {"wrapper": host_us(fn), "ctypes entry": host_us(k5_entry(vals, plan)),
                "library": host_us(library)}
        log(f"K5 {label} E={e} N={n} valid={n_valid}: ms {c.time_ms(torch, fn):.4f} "
            f"device_ms {fmt(dev_ms(fn, tag5))} bound_ms {bound:.4f} library device_ms "
            f"{fmt(dev_ms(library, ('',)))} | host us "
            + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
        if tiled5:
            default = sa.min_tile_edges

            def set_tile(size):
                sa.min_tile_edges = default if size is None else (lambda n_edges: size)
            log("  K5 device ms by tile: " + forced_tiles(
                set_tile, sa.min_tiling.cache_clear, fn, tag5, sa.MIN_TILE_SIZES))

    e, n = 98304, 24576
    _, r, m = c.ragged_receivers(torch, e, n, gen)
    r, m = r.to(dev), m.to(dev)
    layout = sg.make_csr_layout(r, m, n)
    n_valid = int(layout.row_ptr[-1])
    valid = m.nonzero()[:, 0]
    recv = r[valid]
    tags7 = tuple(t for t in (c.PROFILE_TAGS["K7"], c.FIXUP_TAGS.get("K7")) if t)
    tiled7 = hasattr(sg, "load_width")
    for d in (256, 128, 100, 3):
        for dtype in (torch.bfloat16, torch.float32):
            data = torch.randn(e, d, generator=gen).to(dev, dtype)
            fn = lambda: sg.csr_segment_sum(data, layout)
            want = sg.csr_segment_sum_plain(data, layout)
            bound_terms = sg.csr_segment_sum_plain(data.abs(), layout)
            assert bool(((fn() - want).abs() <= c.SUM_TOL * bound_terms + 1e-6).all())
            d32 = data.float()[valid]
            library = lambda: torch.zeros((n, d), device=dev).index_add_(0, recv, d32)
            bound = 1e3 * (n_valid * d * data.element_size() + 4 * n_valid + 4 * (n + 1)
                           + 4 * n * d) / c.HBM_BYTES_PER_S
            host = {"wrapper": host_us(fn), "ctypes entry": host_us(k7_entry(data, layout)),
                    "library": host_us(library)}
            how = ""
            if tiled7:
                width = sg.load_width(d, data.element_size(), data.data_ptr())
                cut = sa.csr_tiling(e, n, d, data.element_size(), width, sg.MIN_THREADS)
                how = f" (T {cut.tile}, {width}-byte loads, {cut.lanes} lanes)"
            log(f"K7 {str(dtype)[6:]} E={e} N={n} D={d}{how}: ms {c.time_ms(torch, fn):.4f} "
                f"device_ms {fmt(dev_ms(fn, tags7))} bound_ms {bound:.4f} library "
                f"device_ms {fmt(dev_ms(library, ('',)))} | host us "
                + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
            if tiled7:
                default = sa.tile_for_threads

                def set_tile(size):
                    sa.tile_for_threads = default if size is None else (lambda *args: size)
                log("  K7 device ms by tile: " + forced_tiles(
                    set_tile, sa.csr_tiling.cache_clear, fn, tags7, sa.TILE_SIZES))
    # K7 with its base off a 16-byte boundary: narrower loads, the same kernel
    for d, dtype in ((256, torch.bfloat16), (256, torch.float32)):
        flat = torch.randn(e * d + 1, generator=gen).to(dev, dtype)
        data = flat[1:].view(e, d)
        fn = lambda: sg.csr_segment_sum(data, layout)
        assert bool(((fn() - sg.csr_segment_sum_plain(data, layout)).abs()
                     <= c.SUM_TOL * sg.csr_segment_sum_plain(data.abs(), layout) + 1e-6).all())
        log(f"K7 {str(dtype)[6:]} D={d}, base {data.data_ptr() % 16} bytes off 16: ms "
            f"{c.time_ms(torch, fn):.4f} device_ms {fmt(dev_ms(fn, tags7))}")


if __name__ == "__main__":
    sys.exit(main())
