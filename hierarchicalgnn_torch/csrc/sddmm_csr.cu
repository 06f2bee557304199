// Per-edge products over a receiver-sorted plan for Hopper (sm_90a): the
// backward kernels of the CSR segment sums in segment_csr.cu.
//
// Two kernels replace the Pallas kernels of
// hierarchicalgnn_tpu/ops/pallas/sddmm_kernel.py:
//
//   K3 sddmm          <- _sddmm_kernel          (sddmm_kernel.py:63)
//        out[e] = <data[e, :], rows[recv[e], :]>            (d_w of K2)
//   K4 scaled_gather  <- _scaled_gather_kernel  (sddmm_kernel.py:133)
//        out[e, :] = scale[e] * rows[recv[e], :]            (d_data of K1, K2)
//        scale == nullptr is the plain sorted gather.
//
// Slots at or beyond row_ptr[n_rows] (the invalid edges, sorted last) get 0.
//
// What they compute, not how the TPU computed it: the Pallas kernels form
// all (row, edge) dots of a 256-row group against a 1024-edge chunk on the
// MXU and select with a one-hot mask, because a per-edge row gather is slow
// on the TPU.  On Hopper a gather of a 1 KB row is one coalesced warp load,
// and consecutive sorted edges share their receiver, so the row comes from
// L1/L2 after its first touch.
//
// Design: one warp per edge, 8 warps per block.  There is no reduction across
// edges, so a receiver of high degree costs nothing special.  Each lane owns
// 16 bytes of the edge's data row (K3) or of the output row (K4) per pass, so
// every load and store of a warp is one contiguous stretch.  K3 multiplies
// and accumulates in f32 and reduces over the warp with shuffles.  K4 forms
// the f32 product and rounds once on the store when the output is bf16.
//
// Bound: both are memory-bound.  K3 reads E*D*sizeof(T) of data, at most
// 4*N*D of rows (each row once), 4E receivers, and writes 4E.  K4 reads the
// rows, 4E scales and 4E receivers and writes E*D*sizeof(OutT).  Two
// operations (K3) or one (K4) per element, far below ~295 per byte.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;  // warps (edges) per block
constexpr int kThreads = kWarp * kWarps;

__device__ __forceinline__ void load_f32x4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    load_f32x4(p, v);
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // round to nearest even, once, from the f32 product
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// K3: out[e] = <data[e], rows[recv[e]]>
template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const T* __restrict__ data, const float* __restrict__ rows,
             const int* __restrict__ recv, const int* __restrict__ row_ptr,
             float* __restrict__ out, int n_edges, int n_rows, int d) {
  constexpr int V = Vec<T>::N;
  const int e = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (e >= n_edges) return;  // whole warp leaves together
  if (e >= __ldg(row_ptr + n_rows)) {
    if (lane == 0) out[e] = 0.f;
    return;
  }
  const float* row = rows + static_cast<size_t>(__ldg(recv + e)) * d;
  const T* x = data + static_cast<size_t>(e) * d;
  float acc = 0.f;
  for (int c = lane * V; c < d; c += kWarp * V) {
    float a[V], b[V];
    Vec<T>::load(x + c, a);
#pragma unroll
    for (int i = 0; i < V; i += 4) load_f32x4(row + c + i, b + i);
#pragma unroll
    for (int i = 0; i < V; ++i) acc = fmaf(a[i], b[i], acc);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

// K4: out[e, :] = (kScaled ? scale[e] : 1) * rows[recv[e], :]
template <typename OutT, bool kScaled>
__global__ void __launch_bounds__(kThreads)
scaled_gather_kernel(const float* __restrict__ scale, const float* __restrict__ rows,
                     const int* __restrict__ recv, const int* __restrict__ row_ptr,
                     OutT* __restrict__ out, int n_edges, int n_rows, int d) {
  constexpr int V = Vec<OutT>::N;
  const int e = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (e >= n_edges) return;
  const bool valid = e < __ldg(row_ptr + n_rows);
  const float* row = rows + static_cast<size_t>(valid ? __ldg(recv + e) : 0) * d;
  float s = valid ? 1.f : 0.f;
  if constexpr (kScaled) {
    if (valid) s = __ldg(scale + e);
  }
  OutT* y = out + static_cast<size_t>(e) * d;
  for (int c = lane * V; c < d; c += kWarp * V) {
    float v[V];
    if (valid) {
#pragma unroll
      for (int i = 0; i < V; i += 4) load_f32x4(row + c + i, v + i);
      if constexpr (kScaled) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] *= s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.f;
    }
    Vec<OutT>::store(y + c, v);
  }
}

int grid_for(int n_edges) { return (n_edges + kWarps - 1) / kWarps; }

template <typename T>
int launch_sddmm(const void* data, const float* rows, const int* recv,
                 const int* row_ptr, float* out, int n_edges, int n_rows, int d,
                 void* stream) {
  if (n_edges > 0) {
    sddmm_kernel<T><<<grid_for(n_edges), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), rows, recv, row_ptr, out, n_edges, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_gather(const float* scale, const float* rows, const int* recv,
                  const int* row_ptr, void* out, int n_edges, int n_rows, int d,
                  void* stream) {
  if (n_edges > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    OutT* o = static_cast<OutT*>(out);
    if (scale != nullptr) {
      scaled_gather_kernel<OutT, true><<<grid_for(n_edges), kThreads, 0, s>>>(
          scale, rows, recv, row_ptr, o, n_edges, n_rows, d);
    } else {
      scaled_gather_kernel<OutT, false><<<grid_for(n_edges), kThreads, 0, s>>>(
          scale, rows, recv, row_ptr, o, n_edges, n_rows, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hgnn_sddmm_bf16(const void* data, const float* rows, const int* recv,
                    const int* row_ptr, float* out, int n_edges, int n_rows, int d,
                    void* stream) {
  return launch_sddmm<__nv_bfloat16>(data, rows, recv, row_ptr, out, n_edges, n_rows,
                                     d, stream);
}

int hgnn_sddmm_f32(const void* data, const float* rows, const int* recv,
                   const int* row_ptr, float* out, int n_edges, int n_rows, int d,
                   void* stream) {
  return launch_sddmm<float>(data, rows, recv, row_ptr, out, n_edges, n_rows, d, stream);
}

int hgnn_scaled_gather_bf16(const float* scale, const float* rows, const int* recv,
                            const int* row_ptr, void* out, int n_edges, int n_rows,
                            int d, void* stream) {
  return launch_gather<__nv_bfloat16>(scale, rows, recv, row_ptr, out, n_edges, n_rows,
                                      d, stream);
}

int hgnn_scaled_gather_f32(const float* scale, const float* rows, const int* recv,
                           const int* row_ptr, void* out, int n_edges, int n_rows,
                           int d, void* stream) {
  return launch_gather<float>(scale, rows, recv, row_ptr, out, n_edges, n_rows, d,
                              stream);
}

}  // extern "C"
