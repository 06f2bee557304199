// Gather-layout CSR segment sum for Hopper (sm_90a).
//
//   K7 csr_gather_sum  <- _segment_kernel
//                         (hierarchicalgnn_tpu/ops/pallas/segment_kernel.py:114)
//        out[i] = sum_{k in [row_ptr[i], row_ptr[i+1])} data[perm[k], :]
//
// The edge rows stay in their original, unsorted order; the layout (built
// once per graph by make_csr_layout) is a stable sort of the valid edges by
// receiver: perm[k] is the original index of the edge in slot k, and row_ptr
// delimits each output row's slots.
//
// What it computes, not how the TPU computed it: the Pallas version bins the
// edges into groups of 256 rows with a chunk budget, has XLA materialise
// data[perm], and multiplies by a one-hot matrix on the MXU.  Here a row's
// edges are fetched through perm inside the kernel, so no sorted copy of the
// data is ever written, there is no budget and no overflow path.
//
// Design: one 256-thread block (8 warps) per output row, as the sorted K1.
// The 8 warps take every 8th slot of the row.  A warp reads perm[k] (one
// 4-byte load, the same address for all its lanes), then each lane loads 16
// bytes of that edge row (8 bf16 or 4 f32), so a 512-byte stretch of the row
// per warp and load, and adds in f32 registers.  The loads are written out
// four slots at a time (four perm entries, then four rows, then the adds):
// left to "#pragma unroll" the compiler kept one load in flight in three of
// four instantiations, and the serial walk down a row of high degree then
// waited for perm and for the row, one after the other, at every edge.  The
// warps' partial sums are added in shared memory in warp order and the row is
// written once.  No atomics: the result is deterministic.
//
// Any width is taken.  A row that is not a whole number of 16-byte vectors
// (or a base pointer off a 16-byte boundary) cannot be read by vector loads:
// the same kernel then runs with one element per lane (the Scalar loader
// below), 32 columns per warp and pass.  The launcher picks by width and
// alignment alone.
//
// Bound: memory.  It reads each valid edge row once (E_valid * D * sizeof(T)),
// 4 bytes of perm per valid edge and 4(N+1) of row_ptr, and writes 4*N*D; one
// add per element read.  The gather makes consecutive loads of a warp land on
// unrelated rows, but each is a contiguous stretch of D * sizeof(T) bytes.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarp * kWarps;

// One 16-byte load of a row and its accumulation, kept apart so that a warp
// can issue several loads before it uses the first.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void add(const Raw& q, float (&acc)[N]) {
    acc[0] += q.x; acc[1] += q.y; acc[2] += q.z; acc[3] += q.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void add(const Raw& q, float (&acc)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One element per lane, for rows that vector loads cannot address.
template <typename T>
struct Scalar {
  static constexpr int N = 1;
  using Raw = T;
  __device__ __forceinline__ static Raw load(const T* p) { return *p; }
  __device__ __forceinline__ static void add(const Raw& q, float (&acc)[N]) {
    acc[0] += to_f32(q);
  }
};

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
csr_gather_sum_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                      const int* __restrict__ row_ptr, float* __restrict__ out, int d) {
  constexpr int V = L::N;
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
      const T* col = data + c;
      int k = begin + warp;
      // four slots at a time: the four perm entries, then the four rows, are
      // loaded before any is used, so the walk down a long row waits for one
      // round trip to memory per four edges and not for two per edge
      for (; k + 3 * kWarps < end; k += 4 * kWarps) {
        const int e0 = __ldg(perm + k);
        const int e1 = __ldg(perm + k + kWarps);
        const int e2 = __ldg(perm + k + 2 * kWarps);
        const int e3 = __ldg(perm + k + 3 * kWarps);
        const typename L::Raw q0 = L::load(col + static_cast<size_t>(e0) * d);
        const typename L::Raw q1 = L::load(col + static_cast<size_t>(e1) * d);
        const typename L::Raw q2 = L::load(col + static_cast<size_t>(e2) * d);
        const typename L::Raw q3 = L::load(col + static_cast<size_t>(e3) * d);
        L::add(q0, acc);
        L::add(q1, acc);
        L::add(q2, acc);
        L::add(q3, acc);
      }
      for (; k < end; k += kWarps) {
        const int e = __ldg(perm + k);
        L::add(L::load(col + static_cast<size_t>(e) * d), acc);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part[warp][lane * V + i] = acc[i];
    __syncthreads();
    // the warps' partial sums, added in warp order: deterministic
    for (int t = threadIdx.x; t < kCols && c0 + t < d; t += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[w][t];
      out[static_cast<size_t>(row) * d + c0 + t] = sum;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_gather_sum(const void* data, const int* perm, const int* row_ptr,
                      float* out, int n_rows, int d, void* stream) {
  const T* rows = static_cast<const T*>(data);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vectors = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(data) % 16 == 0;
  if (n_rows > 0 && d > 0) {
    if (vectors) {
      csr_gather_sum_kernel<T, Vec<T>><<<n_rows, kThreads, 0, s>>>(rows, perm, row_ptr, out, d);
    } else {
      csr_gather_sum_kernel<T, Scalar<T>><<<n_rows, kThreads, 0, s>>>(rows, perm, row_ptr, out, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hgnn_csr_gather_sum_bf16(const void* data, const int* perm, const int* row_ptr,
                             float* out, int n_rows, int d, void* stream) {
  return launch_gather_sum<__nv_bfloat16>(data, perm, row_ptr, out, n_rows, d, stream);
}

int hgnn_csr_gather_sum_f32(const void* data, const int* perm, const int* row_ptr,
                            float* out, int n_rows, int d, void* stream) {
  return launch_gather_sum<float>(data, perm, row_ptr, out, n_rows, d, stream);
}

}  // extern "C"
