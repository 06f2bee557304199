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
// running values, after padding the matrix to the tile.  Here one block owns
// one row: each thread keeps (m1, j1, m2) over its strided columns, in
// increasing column order, then the partials merge by shuffles within a warp
// and through shared memory across the 8 warps.  No padding.
//
// The merge rule carries the tie semantics.  Of two partials the winner has
// the larger m1 and, on equal m1, the lower column; the merged runner-up is
// max(winner.m2, loser.m1).  The rule is symmetric, so both lanes of an
// xor-shuffle pair arrive at the same result.
//
// Bound: memory.  Reads 4*P*C + 4*C bytes, writes 12*P; one subtract and two
// compares per element.
//
// Interface: plain C, loaded with ctypes.  The entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
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

__global__ void __launch_bounds__(kThreads)
row_top2_kernel(const float* __restrict__ a, const float* __restrict__ prices,
                float* __restrict__ v1, int* __restrict__ j1, float* __restrict__ v2,
                int n_cols) {
  __shared__ Top2 part[kWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = a + static_cast<size_t>(row) * n_cols;
  // a thread that owns no column, or whose values never exceed NEG, keeps
  // its first column (or none) and so loses every tie to a lower column
  Top2 t{kNeg, tid < n_cols ? tid : INT_MAX, kNeg};
#pragma unroll 4
  for (int j = tid; j < n_cols; j += kThreads) {
    const float net = __ldg(x + j) - __ldg(prices + j);
    if (net > t.m1) {
      t.m2 = t.m1;
      t.m1 = net;
      t.j1 = j;
    } else if (net > t.m2) {
      t.m2 = net;
    }
  }
  t = warp_merge(t);
  if (tid % kWarp == 0) part[tid / kWarp] = t;
  __syncthreads();
  if (tid < kWarp) {
    Top2 u = tid < kWarps ? part[tid] : Top2{kNeg, INT_MAX, kNeg};
    u = warp_merge(u);
    if (tid == 0) {
      v1[row] = u.m1;
      j1[row] = u.j1;
      v2[row] = u.m2;
    }
  }
}

}  // namespace

extern "C" {

int hgnn_row_top2_f32(const float* a, const float* prices, float* v1, int* j1,
                      float* v2, int n_rows, int n_cols, void* stream) {
  if (n_rows > 0 && n_cols > 0) {
    row_top2_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, prices, v1, j1, v2, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
