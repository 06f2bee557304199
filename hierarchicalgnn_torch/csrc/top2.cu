// Row-wise top-2 of ``a - prices`` for Hopper (sm_90a): the bidding sweep of
// an auction round.
//
//   K6 row_top2 <- _top2_kernel (hierarchicalgnn_tpu/ops/pallas/top2.py:31)
//        net[i, j] = a[i, j] - prices[j]
//        v1[i] = max_j net[i, j]
//        j1[i] = the lowest j with net[i, j] == v1[i]
//        v2[i] = max_{j != j1[i]} net[i, j]     (== v1[i] when the best ties)
//
// Values that never exceed NEG = -1e30 (the fill of masked entries) leave
// v1 = v2 = NEG and j1 = 0, as in the Pallas kernel: its running registers
// start at (NEG, 0, NEG).
//
// What it computes, not how the TPU computed it: the Pallas kernel walks
// 256 x 512 tiles in grid order and folds each tile into VMEM-resident
// running values, after padding the matrix to the tile.  Here a row belongs
// to W warps (W = 1 for a full sweep; 2, 4 or 8 when there are too few rows
// to fill the card, as the host's `top2_schedule` picks), and the warps of a
// persistent grid stride over the rows.  Where a block sees more than one
// row of a column (more than one row at a time, or more than one pass), it
// first copies `prices` into shared memory (12 KB at C 3072); else, and when
// C is above kSmemCols, the lanes read them from global memory, each its own
// columns, with no wait before the row's loads start.  A lane owns every
// (W * 32)-th 16-byte vector of its row and reads them 4 at a time, the 4
// loads in flight together (batched by hand; 8 measured 5% slower on the full
// sweep, scripts/k6_k8_sweep.py), keeping (m1, j1, m2) over its columns in increasing order: within a
// vector, then from batch to batch.  The lanes merge by shuffles, the W warps
// of a row through shared memory.  A row that is not 16-byte aligned (C not a
// multiple of 4, or `a` off a 16-byte boundary) is read one float at a time,
// in the same order, by a second instantiation of the kernel.  No padding.
//
// The merge rule carries the tie semantics.  Of two partials the winner has
// the larger m1 and, on equal m1, the lower column; the merged runner-up is
// max(winner.m2, loser.m1).  The rule is symmetric and associative (the
// top-2 of a union), so neither the shuffle order nor the warps' order
// matters.  A lane whose values never exceed NEG keeps the first column it
// owns, so it loses every tie to lane 0, which owns column 0.
//
// Bound: memory.  Reads 4*P*C + 4*C bytes, writes 12*P; one subtract and two
// compares per element.
//
// Interface: plain C, loaded with ctypes.  The entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kBatch = 4;           // loads in flight per lane (8: 5% slower)
constexpr int kSmemCols = 11264;    // prices of up to 44 KB go to shared memory
constexpr float kNeg = -1e30f;

struct Top2 {
  float m1;
  int j1;
  float m2;
};

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = a.m1 > b.m1 || (a.m1 == b.m1 && a.j1 < b.j1);
  Top2 r;
  r.m1 = a_wins ? a.m1 : b.m1;
  r.j1 = a_wins ? a.j1 : b.j1;
  r.m2 = a_wins ? fmaxf(a.m2, b.m1) : fmaxf(b.m2, a.m1);
  return r;
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off);
    o.j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off);
    t = merge(t, o);
  }
  return t;
}

// one column, in increasing column order within the lane
__device__ __forceinline__ void step(Top2& s, float net, int j) {
  if (net > s.m1) {
    s.m2 = s.m1;
    s.m1 = net;
    s.j1 = j;
  } else if (net > s.m2) {
    s.m2 = net;
  }
}

// lane t of the row's T threads: vectors t, t + T, ... of 4 columns; a
// batch's prices are loaded with its values, so that prices in global memory
// cost no second round trip
__device__ __forceinline__ Top2 scan_vec(const float* __restrict__ x, const float* pr,
                                         int n_cols, int t, int T) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* p4 = reinterpret_cast<const float4*>(pr);
  const int n_vec = n_cols / 4;
  Top2 s{kNeg, 4 * t < n_cols ? 4 * t : INT_MAX, kNeg};
  for (int v0 = t; v0 < n_vec; v0 += kBatch * T) {
    float4 xv[kBatch], pv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * T;
      if (v < n_vec) {
        xv[b] = __ldg(x4 + v);
        pv[b] = p4[v];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * T;
      if (v < n_vec) {
        step(s, xv[b].x - pv[b].x, 4 * v);
        step(s, xv[b].y - pv[b].y, 4 * v + 1);
        step(s, xv[b].z - pv[b].z, 4 * v + 2);
        step(s, xv[b].w - pv[b].w, 4 * v + 3);
      }
    }
  }
  return s;
}

// the same order one float at a time: columns t, t + T, ...
__device__ __forceinline__ Top2 scan_scalar(const float* __restrict__ x, const float* pr,
                                            int n_cols, int t, int T) {
  Top2 s{kNeg, t < n_cols ? t : INT_MAX, kNeg};
  for (int j0 = t; j0 < n_cols; j0 += kBatch * T) {
    float xv[kBatch], pv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * T;
      if (j < n_cols) {
        xv[b] = __ldg(x + j);
        pv[b] = pr[j];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * T;
      if (j < n_cols) step(s, xv[b] - pv[b], j);
    }
  }
  return s;
}

// out: [3, n_rows] int32 words: v1 (f32 bits), j1, v2 (f32 bits)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
row_top2_kernel(const float* __restrict__ a, const float* __restrict__ prices,
                int* __restrict__ out, int n_rows, int n_cols, int warps_per_row,
                bool staged) {
  extern __shared__ __align__(16) float staged_prices[];
  __shared__ Top2 part[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  if (staged) {
    if (n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(prices) % 16 == 0) {
      for (int v = tid; v < n_cols / 4; v += kThreads) {
        reinterpret_cast<float4*>(staged_prices)[v] =
            __ldg(reinterpret_cast<const float4*>(prices) + v);
      }
    } else {
      for (int j = tid; j < n_cols; j += kThreads) staged_prices[j] = __ldg(prices + j);
    }
    __syncthreads();
  }
  const float* pr = staged ? staged_prices : prices;
  const int per_row = warps_per_row;
  const int groups = kWarps / per_row;
  const int g = warp / per_row, sub = warp % per_row;
  const int T = per_row * kWarp, t = sub * kWarp + lane;
  for (int base = blockIdx.x * groups; base < n_rows; base += gridDim.x * groups) {
    const int row = base + g;
    Top2 r{kNeg, INT_MAX, kNeg};
    if (row < n_rows) {
      const float* x = a + static_cast<size_t>(row) * n_cols;
      r = kVec ? scan_vec(x, pr, n_cols, t, T) : scan_scalar(x, pr, n_cols, t, T);
    }
    r = warp_merge(r);
    if (per_row > 1) {
      if (lane == 0) part[warp] = r;
      __syncthreads();
      if (sub == 0 && lane == 0) {
        for (int w = 1; w < per_row; ++w) r = merge(r, part[warp + w]);
      }
      __syncthreads();  // part is written again for the next row
    }
    if (sub == 0 && lane == 0 && row < n_rows) {
      out[row] = __float_as_int(r.m1);
      out[n_rows + row] = r.j1;
      out[2 * n_rows + row] = __float_as_int(r.m2);
    }
  }
}

}  // namespace

extern "C" {

// out: [3, n_rows] int32 (v1 and v2 as f32 bits).  warps_per_row (1, 2, 4 or
// 8) and grid come from the host's schedule.
int hgnn_row_top2_f32(const float* a, const float* prices, int* out, int n_rows, int n_cols,
                      int warps_per_row, int grid, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaGetLastError());
  if ((warps_per_row != 1 && warps_per_row != 2 && warps_per_row != 4 && warps_per_row != 8) ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = n_cols <= kSmemCols &&
                      (warps_per_row < kWarps || static_cast<long long>(grid) < n_rows);
  const size_t smem = staged ? static_cast<size_t>(n_cols) * sizeof(float) : 0;
  const bool vec = n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   (staged || reinterpret_cast<uintptr_t>(prices) % 16 == 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    row_top2_kernel<true><<<grid, kThreads, smem, s>>>(a, prices, out, n_rows, n_cols,
                                                       warps_per_row, staged);
  } else {
    row_top2_kernel<false><<<grid, kThreads, smem, s>>>(a, prices, out, n_rows, n_cols,
                                                        warps_per_row, staged);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
