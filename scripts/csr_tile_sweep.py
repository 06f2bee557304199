#!/usr/bin/env python3
"""K1/K2 (``hierarchicalgnn_torch/csrc/segment_csr.cu``) on one CUDA card:
device time of the tile kernel and its fix-up at each tile size, and the
host cost of one wrapper call beside that of its library call, at the
shapes ``chip_smoke.py`` phase 3 gives them.

    python3 scripts/csr_tile_sweep.py

One line per (shape, dtype): ``ms`` (CUDA events over 20 calls), then the
profiler's tile + fix-up device ms at T 128, 64 and 32, then host
microseconds per call (100 calls enqueued without a wait) of the wrapper,
the library call, the bare ctypes entry (its two launches included),
``new_empty`` of the output and the wrapper's checks.  Needs a card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa  # noqa: E402

# (kernel, label, E, N, D, one rank's receiver-partitioned buffer)
SHAPES = [("K1", "flat", 98304, 24576, 256, False), ("K2", "b1", 122880, 3072, 256, False),
          ("K2", "b2", 122880, 24576, 256, False), ("K2", "super", 61440, 3072, 256, False),
          ("K1", "flat, latent 128", 98304, 24576, 128, False),
          ("K2", "super, latent 128", 61440, 3072, 128, False),
          ("K1", "per-rank flat", 36864, 6144, 256, True),
          ("K2", "per-rank superedges", 23552, 768, 256, True),
          ("K2", "per-rank bipartite -> 3072", 30720, 3072, 256, False),
          ("K2", "per-rank bipartite -> 6144", 30720, 6144, 256, False)]


def host_us(fn, reps=100):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def main():
    c.phase_device(torch)
    c.phase_build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    tile_edges = sa.tile_edges
    for kernel, label, e, n, d, partitioned in SHAPES:
        make = c.partitioned_receivers if partitioned else c.ragged_receivers
        s, r, m = make(torch, e, n, gen)
        plan = sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n)
        n_valid = int(plan.row_ptr[-1])
        w = plan.sort(torch.rand(e, generator=gen).to(dev) + 0.1)
        for dtype in (torch.bfloat16, torch.float32):
            data = plan.sort(torch.randn(e, d, generator=gen).to(dev, dtype))
            if kernel == "K1":
                fn = lambda: sa.sorted_aggregate(data, plan)
                recv, d32 = plan.receivers_sorted[:n_valid], data[:n_valid].float()
                library = lambda: torch.zeros((n, d), device=dev).index_add_(0, recv, d32)
            else:
                fn = lambda: sa.sorted_aggregate_weighted(data, w, plan)
                csr = torch.sparse_csr_tensor(plan.row_ptr.long(), torch.arange(n_valid, device=dev),
                                              w[:n_valid], size=(n, e))
                d32 = data.float()
                library = lambda: csr @ d32
            ref = fn()
            tags = c.tile_tags(kernel, str(dtype)[6:])
            times = []
            for tile in sa.TILE_SIZES:
                sa.tile_edges = lambda n_edges, tile=tile: tile
                sa.csr_tiling.cache_clear()
                out = fn()
                torch.cuda.synchronize()
                assert ((out - ref).abs() <= 1e-4 * (ref.abs() + 1)).all(), (label, tile)
                found = c.device_ms(torch, fn, tags)
                times.append(f"T{tile} {found[tags[0]]}+{found[tags[1]]}")
            sa.tile_edges = tile_edges
            sa.csr_tiling.cache_clear()
            cut = sa.csr_tiling(e, n, d, data.element_size())
            out = torch.empty((n, d), device=dev)
            entry = sa._tile_entry(kernel == "K2", data.dtype)
            stream = sa._stream(data)
            part = sa._partials(data.device, stream, cut.scratch_rows * d)
            args = ((data.data_ptr(),) + (() if kernel == "K1" else (w.data_ptr(),))
                    + (plan.receivers_i32.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(),
                       part.data_ptr(), e, n, d, cut.tile, cut.lanes, stream))
            host = {"wrapper": host_us(fn), "library": host_us(library),
                    "ctypes entry": host_us(lambda: entry(*args)),
                    "new_empty": host_us(lambda: data.new_empty((n, d), dtype=torch.float32)),
                    "checks": host_us(lambda: sa._check_data(data, plan))}
            print(f"{kernel} {label} {str(dtype)[6:]} E={e} N={n} D={d} (T {cut.tile}): ms "
                  f"{c.time_ms(torch, fn):.4f} | device ms " + " | ".join(times)
                  + " | host us " + ", ".join(f"{k} {v:.1f}" for k, v in host.items()),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
