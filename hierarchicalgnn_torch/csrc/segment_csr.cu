// Receiver-sorted CSR segment reductions for Hopper (sm_90a).
//
// Three kernels replace the Pallas kernels of
// hierarchicalgnn_tpu/ops/pallas/sorted_agg.py on the serving path:
//
//   K1 csr_sum            <- _sorted_kernel          (sorted_agg.py:148)
//        out[i] = sum_{e in [row_ptr[i], row_ptr[i+1])} data[e, :]
//   K2 csr_sum (weighted) <- _sorted_weighted_kernel (sorted_agg.py:252)
//        out[i] = sum_e w[e] * data[e, :]             (w f32, product in f32)
//   K5 csr_min_i32        <- _sorted_min_kernel      (sorted_agg.py:390)
//        out[i] = min_e vals[e], INT32_MAX for an empty row
//
// What they compute, not how the TPU computed it: the Pallas kernels build
// a one-hot matrix per 1024-edge chunk and run it through the MXU, with a
// per-row-group chunk budget.  That is a TPU workaround.  Edges arrive sorted
// by receiver, so each output row owns one contiguous edge range and the
// natural Hopper form is a segmented reduction over that range.
//
// Design, K1/K2: one 256-thread block (8 warps) per output row.  Each lane
// owns 16 bytes of columns (8 bf16 or 4 f32) per pass, so a warp reads one
// 512-byte stretch of an edge row per load, coalesced.  The 8 warps take
// every 8th edge of the row, accumulate in f32 registers, and their partial
// sums are added in shared memory in warp order; the row is written once.
// Eight warps per row keep a row of high degree (a hub node, or a large
// cluster in the bipartite graph) from serialising on one warp.  No atomics,
// so results are deterministic and independent of launch order.
// K5: one warp per row; the lanes stride over the row's edges and a shuffle
// tree reduces.
//
// Bound: all three are memory-bound.  K1 reads E*D*sizeof(T) + 4(N+1) bytes
// and writes 4*N*D; K2 reads 4E more for the weights; K5 reads 4E + 4(N+1)
// and writes 4N.  None does more than one add (or fma, or min) per element
// read, far below the card's ~295 operations per byte.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarp * kWarps;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
csr_sum_kernel(const T* __restrict__ data, const float* __restrict__ w,
               const int* __restrict__ row_ptr, float* __restrict__ out, int d) {
  constexpr int V = Vec<T>::N;
  constexpr int kCols = kWarp * V;  // columns one warp covers per pass
  __shared__ float part[kWarps][kCols];
  const int row = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  for (int c0 = 0; c0 < d; c0 += kCols) {  // block-uniform trip count
    const int c = c0 + lane * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (c < d) {
#pragma unroll 4
      for (int e = begin + warp; e < end; e += kWarps) {
        float v[V];
        Vec<T>::load(data + static_cast<size_t>(e) * d + c, v);
        if constexpr (kWeighted) {
          const float we = __ldg(w + e);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(we, v[i], acc[i]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += v[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part[warp][lane * V + i] = acc[i];
    __syncthreads();
    // the warps' partial sums, added in warp order: deterministic
    for (int t = threadIdx.x; t < kCols && c0 + t < d; t += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += part[k][t];
      out[static_cast<size_t>(row) * d + c0 + t] = sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
csr_min_i32_kernel(const int* __restrict__ vals, const int* __restrict__ row_ptr,
                   int* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // whole warp leaves together
  const int begin = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  int m = INT_MAX;
  for (int e = begin + lane; e < end; e += kWarp) m = min(m, __ldg(vals + e));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row] = m;
}


template <typename T, bool kWeighted>
int launch_sum(const void* data, const float* w, const int* row_ptr, float* out,
               int n_rows, int d, void* stream) {
  if (n_rows > 0) {
    csr_sum_kernel<T, kWeighted><<<n_rows, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), w, row_ptr, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hgnn_csr_sum_bf16(const void* data, const int* row_ptr, float* out,
                      int n_rows, int d, void* stream) {
  return launch_sum<__nv_bfloat16, false>(data, nullptr, row_ptr, out, n_rows, d, stream);
}

int hgnn_csr_sum_f32(const void* data, const int* row_ptr, float* out,
                     int n_rows, int d, void* stream) {
  return launch_sum<float, false>(data, nullptr, row_ptr, out, n_rows, d, stream);
}

int hgnn_csr_wsum_bf16(const void* data, const float* w, const int* row_ptr,
                       float* out, int n_rows, int d, void* stream) {
  return launch_sum<__nv_bfloat16, true>(data, w, row_ptr, out, n_rows, d, stream);
}

int hgnn_csr_wsum_f32(const void* data, const float* w, const int* row_ptr,
                      float* out, int n_rows, int d, void* stream) {
  return launch_sum<float, true>(data, w, row_ptr, out, n_rows, d, stream);
}

int hgnn_csr_min_i32(const int* vals, const int* row_ptr, int* out, int n_rows,
                     void* stream) {
  if (n_rows > 0) {
    csr_min_i32_kernel<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(vals, row_ptr, out, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
