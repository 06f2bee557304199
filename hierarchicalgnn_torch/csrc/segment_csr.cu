// Receiver-sorted CSR segment reductions for Hopper (sm_90a).
//
// Three kernels replace the Pallas kernels of
// hierarchicalgnn_tpu/ops/pallas/sorted_agg.py on the serving path:
//
//   K1 csr_tile_sum            <- _sorted_kernel          (sorted_agg.py:148)
//        out[i] = sum_{e in [row_ptr[i], row_ptr[i+1])} data[e, :]
//   K2 csr_tile_sum (weighted) <- _sorted_weighted_kernel (sorted_agg.py:252)
//        out[i] = sum_e w[e] * data[e, :]             (w f32, product in f32)
//   K5 csr_min_i32             <- _sorted_min_kernel      (sorted_agg.py:390)
//        out[i] = min_e vals[e], INT32_MAX for an empty row
//
// What they compute, not how the TPU computed it: the Pallas kernels build
// a one-hot matrix per 1024-edge chunk and run it through the MXU, with a
// per-row-group chunk budget.  That is a TPU workaround.  Edges arrive sorted
// by receiver, so each output row owns one contiguous edge range and the
// natural Hopper form is a segmented reduction over the edges.
//
// Bound: K1 reads E_valid*D*sizeof(T) + 4(N+1) bytes and writes 4*N*D; K2
// reads 4*E_valid more for the weights; K5 reads 4E + 4(N+1) and writes 4N.
// None does more than one add (or fma, or min) per element read, far below
// the card's ~295 operations per byte: K1 and K2 are memory-bound, K5 is
// bound by a launch's floor (below).
//
// Design, K1/K2: an edge-balanced segmented sum, cut by edges and not by rows
// (the walk and the fix-up are csr_tiles.cuh's, shared with K7).
//  * The valid edges [0, row_ptr[N]) are cut into tiles of `tile` consecutive
//    edges: 128, or 64 or 32 where larger tiles would leave fewer than 512
//    (the wrapper's tile_edges, from E alone).  A worker owns one tile and walks
//    its edges in order, in f32 registers, reading each edge's row from the
//    plan's receiver array.  A row that lies wholly inside the tile is written
//    straight to `out`; a row cut by the tile's start or end leaves a partial.
//    A hub row of degree 5000 is thus 40 workers side by side, not one block:
//    no launch lasts as long as its longest row.  The grid is ceil(E / tile)
//    tiles from E alone; a tile past row_ptr[N] exits, so no host sync and no
//    plan change is needed.
//  * A worker is `lanes` threads (a power of two up to 32), each holding 16
//    bytes of columns (8 bf16 or 4 f32).  Narrow rows (D 8 f32: 2 lanes) put
//    16 workers in a warp, so few lanes idle.  blockIdx.y picks a slice of
//    lanes * 16 bytes of columns: 256 bf16 or 128 f32 at 32 lanes.
//  * Loads are batched by hand: a worker issues the receiver, the weight and
//    the 16-byte data vector of 16 edges before it adds the first, so a warp
//    keeps 8 KB in flight.  On a small input (E 36864 at T 128: 288 tiles)
//    the round trips, not the bytes, set the time: hence the smaller tiles.
//  * A fix-up kernel, launched from the same C entry right after, zeros the
//    empty rows and adds each cut row's partials in tile order.  Two launches
//    and no atomics: every row is summed in one fixed order, so the result is
//    the same bit for bit from run to run.
//  * The partials are 2 * ceil(E / tile) rows of D f32, scratch that the
//    wrapper passes in (bf16 D 256, E 122880: 960 tiles, 1.97 MB against 61
//    MB read); only the cut rows' slots are written and read back.
//
// Design, K5: an edge-balanced segment min in one launch.
//  * Bound: 4E + 4(N + 1) bytes read and 4N written; on the CC hop of the
//    flagship (E 98304, N 24576) 0.0002 ms at 3.35 TB/s.  That is below the
//    floor of any launch (0.0010 ms for a one-element fill on an H100,
//    scripts/k5_k7_sweep.py), so the floor and the round trips to memory bound
//    it, not the bytes: the design keeps to one launch and one round trip
//    before the walk.
//  * The valid edges are cut into tiles of 64 edges, or of 32 where tiles of
//    64 would be fewer than 1024 (sorted_agg.min_tile_edges, from E alone);
//    a warp owns a tile, each lane a run of 2 (or 1) consecutive edges, whose
//    values and receivers it loads with the rest of the tile's loads before
//    the first min.  The one-warp-a-row kernel this replaces walked a hub row
//    of 5000 edges in 157 strided loads on one warp while the rest of the
//    card idled; here a hub is 80-160 warps side by side, and no warp walks
//    more than its tile.
//  * A lane writes the rows that end inside its run; a shuffle scan keyed by
//    row carries a row that crosses lanes to the lane where it ends.  Each
//    tile writes INT32_MAX to the rows strictly between two consecutive
//    receivers it reads (it reads the receiver before its start): they have
//    no edge.  The rows before the first edge and after the last (the flat
//    graph's padding rows), or every row when no edge is valid, are filled in
//    grid-stride shares by every thread of the grid.
//  * A row cut by a tile boundary is finished in the same launch.  Most are
//    short: a row that begins in a tile and ends within 32 slots of its end is
//    finished by that tile, which reads those 32 slots (one a lane) with its
//    other loads, and the next tile drops it; both decide so from the same
//    receivers.  A longer cut row (a hub) is folded through two words of
//    scratch per row: each tile that covers it takes its piece's min into the
//    row's min word and then adds to the row's arrival counter, amounts that
//    sum to a fixed total only once every covering tile has arrived (see
//    arrive()).  A min is exact and order-free, so whoever folds it gives the
//    same bits; the tile that completes the total writes the row and sets
//    both words back.  The words are scratch that the wrapper keeps per
//    stream, set once when allocated: no memset per call, and no tile reads
//    a row's extent from row_ptr.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "csr_tiles.cuh"

namespace {

using csr_tiles::kWarp;
using csr_tiles::Vec;
constexpr int kThreads = 256;  // the fix-up's block
// K1/K2's tile kernel runs 64-thread blocks, so that the flagship's 768-960
// tiles (one warp each at D 256) spread over all 132 SMs in 384-480 blocks
constexpr int kTileThreads = 64;
constexpr int kMinWarps = 4;  // K5: warps (tiles) per block
constexpr int kMinThreads = kWarp * kMinWarps;
constexpr unsigned kAll = 0xffffffffu;

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kTileThreads)
csr_tile_sum_kernel(const T* __restrict__ data, const float* __restrict__ w,
                    const int* __restrict__ recv, const int* __restrict__ row_ptr,
                    float* __restrict__ out, float* __restrict__ partials, int n_tiles,
                    int n_rows, int d, int tile, int lanes) {
  constexpr int V = Vec<T, 16>::N;
  const int t = blockIdx.x * (kTileThreads / lanes) + threadIdx.x / lanes;
  if (t >= n_tiles) return;
  const int c = (blockIdx.y * lanes + threadIdx.x % lanes) * V;
  csr_tiles::tile_walk<T, 16, kWeighted, false>(data, w, nullptr, recv, row_ptr, out,
                                                partials, t, n_rows, d, tile, c);
}

// Templated like the tile kernel it follows, so that a trace tells K1's
// fix-up from K2's.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
csr_tile_fixup_kernel(const float* __restrict__ partials, const int* __restrict__ row_ptr,
                      float* __restrict__ out, int n_rows, int d, int tile, int lanes) {
  csr_tiles::fixup_rows<Vec<T, 16>::N, kThreads>(partials, row_ptr, out, n_rows, d, tile, lanes);
}

// A long cut row (one that is not finished by the tile it begins in) is
// finished in the same launch through two words of scratch per row, kept
// between calls: its arrival counter (0) and its min word (INT32_MAX).  Every
// tile that covers the row takes the min of its piece into the min word and
// then adds to the counter: the tile the row begins in (t0) kHalf + t0 + 1,
// a tile it covers wholly 1, the tile it ends in (t1) kHalf - t1.  These sum
// to 2 kHalf only when all t1 - t0 + 1 have arrived (any subset sums to less,
// as t0, t1 < kHalf), so no tile needs the row's extent.  The add releases the
// piece and acquires the others'; the tile that completes the sum takes the
// min word back to INT32_MAX, writes the row and sets the counter to 0.
constexpr int kHalf = 1 << 29;

__device__ __forceinline__ bool arrive(int* counter, int* min_word, int piece, int add) {
  atomicMin(min_word, piece);
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(counter), "r"(add) : "memory");
  return old + add == 2 * kHalf;
}

__device__ __forceinline__ void finish_cut_row(int* __restrict__ out, int* arrivals, int* mins,
                                               int row) {
  out[row] = atomicExch(mins + row, INT_MAX);
  arrivals[row] = 0;  // ready for the next call on this stream
}

// INT32_MAX to out[0, lead) and out[tail, n_rows), a grid-stride share per thread
__device__ __forceinline__ void fill_ends(int* __restrict__ out, int lead, int tail,
                                          int n_rows) {
  const int stride = gridDim.x * kMinThreads;
  const int n_ends = lead + n_rows - tail;
  for (int i = blockIdx.x * kMinThreads + threadIdx.x; i < n_ends; i += stride)
    out[i < lead ? i : tail + i - lead] = INT_MAX;
}

// kPer = tile / 32: the edges of a lane's run, a compile-time count so that
// the run's loads and walk unroll without predicates
template <int kPer>
__global__ void __launch_bounds__(kMinThreads)
csr_min_i32_kernel(const int* __restrict__ vals, const int* __restrict__ recv,
                   const int* __restrict__ row_ptr, int* __restrict__ out,
                   int* __restrict__ arrivals, int* __restrict__ mins, int n_edges,
                   int n_tiles, int n_rows) {
  constexpr int tile = kPer * kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kMinWarps + threadIdx.x / kWarp;
  const int start = t * tile;
  const int base = start + lane * kPer;
  const int e_last = n_edges - 1;

  // The loads, all at once and before row_ptr[N] is known, so that the walk
  // waits for one round trip to memory: the lane's values and receivers, the
  // receivers around the tile, and one slot a lane of the kWarp slots after
  // it.  Slots past the valid ones are read and dropped below.
  const int n_valid = __ldg(row_ptr + n_rows);
  const int lead = n_edges > 0 ? __ldg(recv) : 0;  // rows [0, lead) have no edge
  int r[kPer], v[kPer];
  int first = 0, before = -1, at31 = -1, before_prev = -1, after = -1, xr = -1, xv = INT_MAX;
  if (t < n_tiles) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = min(base + j, e_last);
      r[j] = __ldg(recv + e);
      v[j] = __ldg(vals + e);
    }
    first = __ldg(recv + start);  // the tile's first row
    before = start > 0 ? __ldg(recv + start - 1) : -1;
    at31 = __ldg(recv + min(start + kWarp - 1, e_last));
    before_prev = start > tile ? __ldg(recv + start - tile - 1) : -1;
    after = start + tile <= e_last ? __ldg(recv + start + tile) : -1;
    const int xe = min(start + tile + lane, e_last);
    xr = __ldg(recv + xe);
    xv = __ldg(vals + xe);
  }
  if (n_valid == 0) {  // no edge: every row is empty
    for (int i = blockIdx.x * kMinThreads + threadIdx.x; i < n_rows; i += gridDim.x * kMinThreads)
      out[i] = INT_MAX;
    return;
  }
  // The rows before the first edge and after the last have none: every thread
  // of the grid fills a share of them, so that no warp walks a long empty tail
  // (the flagship's flat graph has thousands of rows past its last hit).
  const int tail = __ldg(recv + n_valid - 1) + 1;  // rows [tail, n_rows)
  if (t >= n_tiles || start >= n_valid) {  // the whole warp leaves together
    fill_ends(out, lead, tail, n_rows);
    return;
  }
  const int stop = min(start + tile, n_valid);
  const int cnt = max(0, min(kPer, stop - base));  // the lane's edges: [base, base + cnt)
  if (start + kWarp > n_valid) at31 = -1;
  if (stop == n_valid) after = -1;  // else stop = start + tile
  if (stop + lane >= n_valid) {
    xr = -1;
    xv = INT_MAX;
  }

  // the lane's run: the rows that end inside it are written here, its head
  // row's min (if another row follows it in the run) kept in head_min, the
  // min of the row it ends in kept in run_min
  int head_min = INT_MAX, run_min = INT_MAX, row = r[0];
  bool split = false;  // the head row ended inside the run
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < cnt) {
      if (r[j] != row) {
        if (split) {
          out[row] = run_min;  // a row wholly inside the run
        } else {
          head_min = run_min;
        }
        for (int g = row + 1; g < r[j]; ++g) out[g] = INT_MAX;  // rows with no edge
        split = true;
        row = r[j];
        run_min = INT_MAX;
      }
      run_min = min(run_min, v[j]);
    }
  }
  const int head = r[0];
  // the scan: min over the lanes up to this one whose run ends in the same row
  const int key = cnt > 0 ? row : -1;
  int scan = run_min;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int k = __shfl_up_sync(kAll, key, off);
    const int s = __shfl_up_sync(kAll, scan, off);
    if (lane >= off && k == key) scan = min(scan, s);
  }
  const int prev_key = __shfl_up_sync(kAll, key, 1);
  const int prev_scan = __shfl_up_sync(kAll, scan, 1);
  const int next_head = __shfl_down_sync(kAll, cnt > 0 ? head : -1, 1);
  const int last = __shfl_sync(kAll, key, (stop - 1 - start) / kPer);  // the tile's last row

  // The rows across the tile's two boundaries.  One that begins in a tile and
  // ends within kWarp slots of its end ("short") is finished by that tile
  // with the slots after it, and the next tile drops it; both decide it from
  // the same receivers.  Any other cut row (longer, or over three tiles or
  // more) takes the row's min word and arrival counter.
  const bool cut_start = before == first;  // the first row began in an earlier tile
  const bool cut_end = after == last;      // the last row goes on in a later tile
  const bool drop_first = cut_start && at31 != first && (start == tile || before_prev != first);
  const bool short_last =
      cut_end && (last != first || !cut_start) && __shfl_sync(kAll, xr, kWarp - 1) != last;
  int next_min = xr == last ? xv : INT_MAX;  // the last row's values after the tile
  if (short_last) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      next_min = min(next_min, __shfl_xor_sync(kAll, next_min, off));
  }
  const bool long_first = cut_start && !drop_first;
  const bool long_last = cut_end && !short_last && !(last == first && cut_start);

  // the rows that end in this lane; a long cut row's min is this tile's piece
  bool has0 = false, has1 = false;
  int min0 = INT_MAX, min1 = INT_MAX;
  auto finish = [&](int x, int m) {
    if (x == first && cut_start) {
      if (long_first) {
        has0 = true;
        min0 = m;
      }
    } else if (x == last && cut_end) {
      if (short_last) {
        out[x] = min(m, next_min);
      } else {
        has1 = true;
        min1 = m;
      }
    } else {
      out[x] = m;
    }
  };
  if (cnt > 0) {
    // rows with no edge between the previous lane's (or tile's) last row and
    // this lane's first (fill_ends takes those before the first edge)
    const int from = lane > 0 ? prev_key : (start > 0 ? before : head);
    for (int g = from + 1; g < head; ++g) out[g] = INT_MAX;
    if (split) finish(head, min(head_min, lane > 0 && prev_key == head ? prev_scan : INT_MAX));
    if (lane == kWarp - 1 || next_head != row) finish(row, scan);
  }
  fill_ends(out, lead, tail, n_rows);

  // the long cut rows: each tile's piece into the row's min word, then its
  // arrival; the tile that completes the count writes the row
  if (has0) {  // the row began in an earlier tile: this tile covers it wholly, or ends it
    if (arrive(arrivals + first, mins + first, min0, last == first && cut_end ? 1 : kHalf - t))
      finish_cut_row(out, arrivals, mins, first);
  }
  if (has1) {  // the row begins in this tile
    if (arrive(arrivals + last, mins + last, min1, kHalf + t + 1))
      finish_cut_row(out, arrivals, mins, last);
  }
}

// The tile kernel, then the fix-up, on one stream.  `tile` and `lanes` come
// from the wrapper (sorted_agg.py::csr_tiling), which also sizes `partials`
// to 2 * ceil(n_edges / tile) rows of d f32.
template <typename T, bool kWeighted>
int launch_tile_sum(const void* data, const float* w, const int* recv, const int* row_ptr,
                    float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                    int lanes, void* stream) {
  constexpr int V = Vec<T, 16>::N;
  if (tile < 1 || lanes < 1 || lanes > kWarp || (lanes & (lanes - 1)) || n_edges < 0 ||
      d % V) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0 && d > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int slices = (d + lanes * V - 1) / (lanes * V);
    const int n_tiles = static_cast<int>((static_cast<long long>(n_edges) + tile - 1) / tile);
    if (n_tiles > 0) {
      const int per_block = kTileThreads / lanes;
      csr_tile_sum_kernel<T, kWeighted>
          <<<dim3((n_tiles + per_block - 1) / per_block, slices), kTileThreads, 0, s>>>(
              static_cast<const T*>(data), w, recv, row_ptr, out, partials, n_tiles, n_rows,
              d, tile, lanes);
    }
    const int per_block = kThreads / lanes;
    csr_tile_fixup_kernel<T, kWeighted>
        <<<dim3((n_rows + per_block - 1) / per_block, slices), kThreads, 0, s>>>(
            partials, row_ptr, out, n_rows, d, tile, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// (data, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes, stream)
int hgnn_csr_sum_bf16(const void* data, const int* recv, const int* row_ptr, float* out,
                      float* partials, int n_edges, int n_rows, int d, int tile, int lanes,
                      void* stream) {
  return launch_tile_sum<__nv_bfloat16, false>(data, nullptr, recv, row_ptr, out, partials,
                                               n_edges, n_rows, d, tile, lanes, stream);
}

int hgnn_csr_sum_f32(const void* data, const int* recv, const int* row_ptr, float* out,
                     float* partials, int n_edges, int n_rows, int d, int tile, int lanes,
                     void* stream) {
  return launch_tile_sum<float, false>(data, nullptr, recv, row_ptr, out, partials, n_edges,
                                       n_rows, d, tile, lanes, stream);
}

// (data, w, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes, stream)
int hgnn_csr_wsum_bf16(const void* data, const float* w, const int* recv, const int* row_ptr,
                       float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                       int lanes, void* stream) {
  return launch_tile_sum<__nv_bfloat16, true>(data, w, recv, row_ptr, out, partials, n_edges,
                                              n_rows, d, tile, lanes, stream);
}

int hgnn_csr_wsum_f32(const void* data, const float* w, const int* recv, const int* row_ptr,
                      float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                      int lanes, void* stream) {
  return launch_tile_sum<float, true>(data, w, recv, row_ptr, out, partials, n_edges, n_rows,
                                      d, tile, lanes, stream);
}

// (vals, recv, row_ptr, out, arrivals, mins, n_edges, n_rows, tile, stream):
// `arrivals` holds n_rows zeros and `mins` n_rows INT32_MAX, and both are left
// so (sorted_agg.py::_min_scratch); `tile` from sorted_agg.py::min_tiling
int hgnn_csr_min_i32(const int* vals, const int* recv, const int* row_ptr, int* out,
                     int* arrivals, int* mins, int n_edges, int n_rows, int tile,
                     void* stream) {
  if ((tile != 32 && tile != 64) || n_edges < 0 ||
      n_edges / tile >= kHalf) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const int n_tiles = static_cast<int>((static_cast<long long>(n_edges) + tile - 1) / tile);
    const int blocks = n_tiles > 0 ? (n_tiles + kMinWarps - 1) / kMinWarps : 1;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tile == 32) {
      csr_min_i32_kernel<1><<<blocks, kMinThreads, 0, s>>>(vals, recv, row_ptr, out, arrivals,
                                                           mins, n_edges, n_tiles, n_rows);
    } else {
      csr_min_i32_kernel<2><<<blocks, kMinThreads, 0, s>>>(vals, recv, row_ptr, out, arrivals,
                                                           mins, n_edges, n_tiles, n_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
