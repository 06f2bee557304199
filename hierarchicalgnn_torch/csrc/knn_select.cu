// The brute-force kNN's k-selection for Hopper (sm_90a): kernel KNN1.
//
//   KNN1 knn_select <- no Pallas kernel.  hierarchicalgnn_tpu/ops/knn.py
//        takes the k smallest of each distance row with XLA's sort
//        (lax.top_k); the port's plain version sorts each row in full,
//        stable, and keeps the first k.
//
// Per row i of a query block and candidate j, from the query block's GEMM
// `dots` (computed beside it, in full f32) and the two norm vectors:
//     d2[i, j] = (sq_q[i] + sq_p[j]) - 2 * dots[i, j], clamped at 0,
//                +inf where !valid[j]
// each operation rounded on its own (__fadd_rn, __fmul_rn, __fsub_rn, so no
// FMA is contracted), which gives the bits of the plain path's four
// elementwise passes.  Out: the first k of a stable ascending sort of each
// row, d2 [rows, k] f32 and idx [rows, k] int64: equal values lowest index
// first, NaN after +inf.
//
// The order.  Each candidate is the 64-bit composite (key << B) | j: key is
// d2's bits (clamped values are non-negative, so they order as unsigned
// integers; +inf is 0x7f800000 and every NaN 0x7f800001, one above), B the
// bits of the largest index.  Composites are distinct and order as (value,
// index): the k smallest are the stable sort's first k, ties and all.
//
// One block of 512 threads per row.  The row's keys are computed once, kept
// in shared memory where P keys fit (96 KB at P 24576: two rows an SM; 12 KB
// at BC's P 3072), and histogrammed on their top 11 bits as they are made.  A
// radix select on the composite follows, 11 bits a pass from the top: each
// pass finds the bin holding the wanted rank and histograms the next digit of
// the composites in that bin, until a bin holds exactly the number still
// wanted (usually after two or three passes: the index digits are read only
// where values tie).  Every composite up to that threshold is collected, k of
// them, and each is written at its rank among the k.  Above the shared
// memory's P the keys are recomputed from `dots` at each pass; the host's
// `knn_schedule(P, k)` says which, and the shared memory it takes.
//
// Bound: memory.  The kernel reads `dots` once (4 P bytes a row; sq_p and
// valid are shared by all rows and stay in cache) and writes 12 k bytes a
// row: 1024 rows at P 24576 are 100.7 MB, 30 us at 3.35 TB/s.  So the
// loads are 16 bytes a lane, 4 in flight, where rows are aligned; the
// passes after the first read shared memory, and the select's last steps
// touch only the few candidates in the wanted bin.  Keys of +inf and NaN
// (masked candidates, all in one bin) are counted in registers, not by
// atomics.
//
// Interface: plain C, loaded with ctypes.  The entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBatch = 4;                 // loads in flight per lane
constexpr uint32_t kInfKey = 0x7f800000u;
constexpr uint32_t kNanKey = 0x7f800001u;

constexpr int kRadixThreads = 512;        // one row a block
constexpr int kRadixWarps = kRadixThreads / kWarp;
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr int kKeyBits = 31;              // a key's top bit is always 0

__device__ __forceinline__ uint32_t key_of(float dot, float sq_q, float sq_p, uint8_t valid) {
  if (!valid) return kInfKey;
  float d2 = __fsub_rn(__fadd_rn(sq_q, sq_p), __fmul_rn(2.0f, dot));
  if (d2 < 0.0f) d2 = 0.0f;  // torch.clamp(min=0): NaN stays NaN
  return d2 != d2 ? kNanKey : __float_as_uint(d2);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return key == kNanKey ? __uint_as_float(0x7fffffffu) : __uint_as_float(key);
}

// f(j, key) for the columns j = t, t + T, ... of one row (16-byte vectors
// t, t + T, ... when kVec), kBatch loads in flight
template <bool kVec, typename F>
__device__ __forceinline__ void for_each_key(const float* __restrict__ x,
                                             const float* __restrict__ sq_p,
                                             const uint8_t* __restrict__ valid, float sq,
                                             int n_cols, int t, int T, F&& f) {
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* p4 = reinterpret_cast<const float4*>(sq_p);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(valid);
    const int n_vec = n_cols / 4;
    for (int v0 = t; v0 < n_vec; v0 += kBatch * T) {
      float4 xv[kBatch], pv[kBatch];
      uchar4 mv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int v = v0 + b * T;
        if (v < n_vec) {
          xv[b] = __ldg(x4 + v);
          pv[b] = __ldg(p4 + v);
          mv[b] = __ldg(m4 + v);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int v = v0 + b * T;
        if (v < n_vec) {
          f(4 * v, key_of(xv[b].x, sq, pv[b].x, mv[b].x));
          f(4 * v + 1, key_of(xv[b].y, sq, pv[b].y, mv[b].y));
          f(4 * v + 2, key_of(xv[b].z, sq, pv[b].z, mv[b].z));
          f(4 * v + 3, key_of(xv[b].w, sq, pv[b].w, mv[b].w));
        }
      }
    }
  } else {
    for (int j0 = t; j0 < n_cols; j0 += kBatch * T) {
      float xv[kBatch], pv[kBatch];
      uint8_t mv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b * T;
        if (j < n_cols) {
          xv[b] = __ldg(x + j);
          pv[b] = __ldg(sq_p + j);
          mv[b] = __ldg(valid + j);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b * T;
        if (j < n_cols) f(j, key_of(xv[b], sq, pv[b], mv[b]));
      }
    }
  }
}

__device__ __forceinline__ void write_out(float* out_d2, long long* out_idx, int r, uint64_t c,
                                          int idx_bits) {
  out_d2[r] = value_of(static_cast<uint32_t>(c >> idx_bits));
  out_idx[r] = static_cast<long long>(c & ((1ull << idx_bits) - 1));
}

struct Pick {
  uint32_t bin, below, count;
};

// The bin of `hist[0, n_bins)` that holds rank `want` (1-based): the least
// b with hist[0] + ... + hist[b] >= want; `below` counts the bins before it.
__device__ __forceinline__ Pick find_bin(const uint32_t* hist, int n_bins, uint32_t want,
                                         uint32_t* warp_sums, Pick* pick) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int per = (n_bins + kRadixThreads - 1) / kRadixThreads;
  const int lo = min(tid * per, n_bins), hi = min(lo + per, n_bins);
  uint32_t s = 0;
  for (int b = lo; b < hi; ++b) s += hist[b];
  uint32_t x = s;  // inclusive scan over the block
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kRadixWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kRadixWarps; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kRadixWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  uint32_t cum = (warp ? warp_sums[warp - 1] : 0) + x - s;
  if (cum < want && want <= cum + s) {  // exactly one thread
    for (int b = lo; b < hi; ++b) {
      if (cum + hist[b] >= want) {
        *pick = Pick{static_cast<uint32_t>(b), cum, hist[b]};
        break;
      }
      cum += hist[b];
    }
  }
  __syncthreads();
  return *pick;
}

template <bool kStaged, bool kVec>
__global__ void __launch_bounds__(kRadixThreads)
knn_radix_kernel(const float* __restrict__ dots, const float* __restrict__ sq_q,
                 const float* __restrict__ sq_p, const uint8_t* __restrict__ valid,
                 float* __restrict__ out_d2, long long* __restrict__ out_idx, int n_cols, int k,
                 int idx_bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* hist = smem;                                     // [kBins]
  uint64_t* chosen = reinterpret_cast<uint64_t*>(hist + kBins);  // [k]
  uint32_t* keys = reinterpret_cast<uint32_t*>(chosen + k);  // [n_cols] when staged
  __shared__ uint32_t warp_sums[kRadixWarps];
  __shared__ Pick pick;
  __shared__ uint32_t n_chosen;

  const int tid = threadIdx.x, row = blockIdx.x;
  const float* x = dots + static_cast<size_t>(row) * n_cols;
  const float sq = sq_q[row];
  for (int b = tid; b < kBins; b += kRadixThreads) hist[b] = 0;
  if (tid == 0) n_chosen = 0;
  __syncthreads();

  // pass 0: the keys (staged), and the histogram of their top 11 bits
  const int top_shift = kKeyBits - kDigitBits;
  uint32_t n_inf = 0;  // +inf and NaN keys share the bin kInfKey >> top_shift
  for_each_key<kVec>(x, sq_p, valid, sq, n_cols, tid, kRadixThreads, [&](int j, uint32_t key) {
    if (kStaged) keys[j] = key;
    if (key >= kInfKey) {
      ++n_inf;
    } else {
      atomicAdd(hist + (key >> top_shift), 1u);
    }
  });
  if (n_inf) atomicAdd(hist + (kInfKey >> top_shift), n_inf);
  __syncthreads();

  // the composite's digits from the top: (key << idx_bits) | j
  int shift = kKeyBits + idx_bits - kDigitBits;
  int n_bins = kBins;
  uint64_t prefix = 0, mask = 0;
  uint32_t want = static_cast<uint32_t>(k);
  for (;;) {
    const Pick p = find_bin(hist, n_bins, want, warp_sums, &pick);
    prefix |= static_cast<uint64_t>(p.bin) << shift;
    mask |= static_cast<uint64_t>(n_bins - 1) << shift;
    want -= p.below;
    if (p.count == want || shift == 0) break;  // take the whole bin
    const int next = shift > kDigitBits ? shift - kDigitBits : 0;
    n_bins = 1 << (shift - next);
    shift = next;
    __syncthreads();  // every thread has read the histogram
    for (int b = tid; b < n_bins; b += kRadixThreads) hist[b] = 0;
    __syncthreads();
    const auto count = [&](int j, uint32_t key) {
      const uint64_t c = (static_cast<uint64_t>(key) << idx_bits) | static_cast<uint32_t>(j);
      if ((c & mask) == prefix) atomicAdd(hist + ((c >> shift) & (n_bins - 1)), 1u);
    };
    if (kStaged) {
      for (int j = tid; j < n_cols; j += kRadixThreads) count(j, keys[j]);
    } else {
      for_each_key<kVec>(x, sq_p, valid, sq, n_cols, tid, kRadixThreads, count);
    }
    __syncthreads();
  }
  // every composite <= the threshold: exactly k
  const uint64_t threshold = prefix | (~mask & ((1ull << (kKeyBits + idx_bits)) - 1));
  const auto collect = [&](int j, uint32_t key) {
    const uint64_t c = (static_cast<uint64_t>(key) << idx_bits) | static_cast<uint32_t>(j);
    if (c <= threshold) {
      const uint32_t slot = atomicAdd(&n_chosen, 1u);
      if (slot < static_cast<uint32_t>(k)) chosen[slot] = c;
    }
  };
  if (kStaged) {
    for (int j = tid; j < n_cols; j += kRadixThreads) collect(j, keys[j]);
  } else {
    for_each_key<kVec>(x, sq_p, valid, sq, n_cols, tid, kRadixThreads, collect);
  }
  __syncthreads();
  float* d2_row = out_d2 + static_cast<size_t>(row) * k;
  long long* idx_row = out_idx + static_cast<size_t>(row) * k;
  for (int i = tid; i < k; i += kRadixThreads) {
    const uint64_t c = chosen[i];
    int rank = 0;
    for (int m = 0; m < k; ++m) rank += chosen[m] < c;
    write_out(d2_row, idx_row, rank, c, idx_bits);
  }
}


template <bool kStaged, bool kVec>
int launch_radix(const float* dots, const float* sq_q, const float* sq_p, const uint8_t* valid,
                 float* out_d2, long long* out_idx, int n_rows, int n_cols, int k, int idx_bits,
                 int smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(knn_radix_kernel<kStaged, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_radix_kernel<kStaged, kVec><<<n_rows, kRadixThreads, smem, s>>>(
      dots, sq_q, sq_p, valid, out_d2, out_idx, n_cols, k, idx_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dots [n_rows, n_cols], sq_q [n_rows], sq_p [n_cols] f32; valid [n_cols]
// bytes (0 or 1); out_d2 [n_rows, k] f32, out_idx [n_rows, k] int64.
// The row's keys are staged in `smem` bytes of shared memory when staged is
// 1, else recomputed at each pass.  idx_bits: the bits of n_cols - 1 (at
// least 1).
int hgnn_knn_select_f32(const float* dots, const float* sq_q, const float* sq_p,
                        const uint8_t* valid, float* out_d2, long long* out_idx, int n_rows,
                        int n_cols, int k, int staged, int idx_bits, int smem, void* stream) {
  if (n_rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (k > n_cols || idx_bits < 1 || idx_bits > 31 || (1ll << idx_bits) < n_cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(dots) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sq_p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  const long long need = 4ll * kBins + 8ll * k + (staged ? 4ll * n_cols : 0);
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = staged ? (vec ? &launch_radix<true, true> : &launch_radix<true, false>)
                              : (vec ? &launch_radix<false, true> : &launch_radix<false, false>);
  return launch(dots, sq_q, sq_p, valid, out_d2, out_idx, n_rows, n_cols, k, idx_bits, smem, s);
}

}  // extern "C"
