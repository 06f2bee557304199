// The edge-balanced CSR segment sum shared by K1/K2 (segment_csr.cu) and K7
// (segment_gather.cu): the walk of one tile of edges and the fix-up of the
// rows the tiles cut, as __device__ templates.  Each source defines its own
// __global__ kernels around them.
//
//  * The valid slots [0, row_ptr[N]) are cut into tiles of `tile` consecutive
//    slots.  A worker of `lanes` threads owns one tile and walks its slots in
//    order, in f32 registers, reading each slot's row from `recv` (the row of
//    every slot, sorted).  A row wholly inside the tile is written to `out`; a
//    row cut by the tile's start goes to `partials[2 t]` (slot 0), one cut by
//    its end to `partials[2 t + 1]` (slot 1); a row that covers the whole tile
//    counts as cut by its start.
//  * K1/K2 read slot k's data row at data + k * d; K7 (kGather) at
//    data + perm[k] * d.  Loads are batched by hand: a worker issues the
//    receivers, weights and perm entries of kBatch slots, then their data
//    rows, before it adds the first.
//  * The fix-up visits every row once: an empty row gets zeros, a row cut into
//    tiles t0 .. t1 the sum partials[2 t0 + 1] + partials[2 (t0 + 1)] + ... +
//    partials[2 t1], in tile order.  No atomics: each row is summed in one
//    fixed order, so two calls agree bit for bit.
//  * A lane holds W bytes of a row's columns: V = W / sizeof(T) values.  K1/K2
//    take 16-byte loads; K7 the widest of 16, 8, 4 or 2 bytes that divides the
//    row's bytes and the base's alignment.  V then divides D, so the f32 rows
//    of `out` and `partials` take V-float stores at the same columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace csr_tiles {

constexpr int kWarp = 32;
constexpr int kBatch = 16;    // slots whose loads a worker issues before any add
constexpr int kFixBatch = 8;  // partials whose loads the fix-up issues before any add
constexpr int kLongParts = 16;  // a row of more partials is summed by a whole fix-up block
constexpr int kShares = 8;  // in this many shares (a 256-thread block has 8 workers or more)

// W bytes of a data row: the raw load, kept apart from its conversion so that
// a worker can issue several loads before it uses one.
template <typename T, int W>
struct Vec;

template <>
struct Vec<float, 16> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[N]) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Vec<float, 8> {
  static constexpr int N = 2;
  using Raw = float2;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[N]) {
    v[0] = q.x; v[1] = q.y;
  }
};

template <>
struct Vec<float, 4> {
  static constexpr int N = 1;
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[N]) { v[0] = q; }
};

// bf16: W / 2 values, unpacked pairwise
template <int W>
struct BfVec {
  static constexpr int N = W / 2;
  using Raw = typename std::conditional<
      W == 16, uint4,
      typename std::conditional<W == 8, uint2,
                                typename std::conditional<W == 4, unsigned int,
                                                          unsigned short>::type>::type>::type;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[N]) {
    if constexpr (N == 1) {
      v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&q));
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
};

template <>
struct Vec<__nv_bfloat16, 16> : BfVec<16> {};
template <>
struct Vec<__nv_bfloat16, 8> : BfVec<8> {};
template <>
struct Vec<__nv_bfloat16, 4> : BfVec<4> {};
template <>
struct Vec<__nv_bfloat16, 2> : BfVec<2> {};

// V f32 values to p (aligned to 4 V bytes, or 16 for V >= 4)
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// V f32 values from p, aligned as for store_f32
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

// One worker's tile: tile t of `tile` slots, its columns [c, c + V) of each
// row (`active` false for a lane past the row's end: it reads column 0 and
// writes nothing).  The caller has checked t < n_tiles.
template <typename T, int W, bool kWeighted, bool kGather>
__device__ __forceinline__ void tile_walk(const T* __restrict__ data,
                                          const float* __restrict__ w,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ recv,
                                          const int* __restrict__ row_ptr,
                                          float* __restrict__ out,
                                          float* __restrict__ partials, int t, int n_rows,
                                          int d, int tile, int c) {
  using L = Vec<T, W>;
  constexpr int V = L::N;
  const int n_valid = __ldg(row_ptr + n_rows);
  const int start = t * tile;
  if (start >= n_valid) return;  // the whole worker leaves together
  const int stop = min(start + tile, n_valid);
  const bool active = c < d;
  const int cc = active ? c : 0;  // an idle lane reads column 0, and drops it
  const T* col = data + cc;
  // the rows that cross the tile's start and its end
  const int first = __ldg(recv + start);
  const bool cut_start = start > 0 && __ldg(recv + start - 1) == first;
  const bool cut_end = stop < n_valid && __ldg(recv + stop) == __ldg(recv + stop - 1);
  float* const slot0 = partials + static_cast<size_t>(2 * t) * d + cc;
  float* const slot1 = slot0 + d;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  int row = first;
  bool in_first = true;  // still in the tile's first row
  for (int e0 = start; e0 < stop; e0 += kBatch) {
    // the receivers, weights and row indices of kBatch slots (a slot past
    // the tile repeats its last one and is not added), then their rows, then
    // the adds in slot order
    int r[kBatch];
    int src[kBatch];
    typename L::Raw q[kBatch];
    float we[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = min(e0 + i, stop - 1);
      r[i] = __ldg(recv + e);
      if constexpr (kGather) {
        src[i] = __ldg(perm + e);
      } else {
        src[i] = e;
      }
      if constexpr (kWeighted) we[i] = __ldg(w + e);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) q[i] = L::load(col + static_cast<size_t>(src[i]) * d);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (e0 + i < stop) {
        if (r[i] != row) {  // `row` ends inside the tile
          if (active) {
            store_f32<V>(in_first && cut_start ? slot0
                                               : out + static_cast<size_t>(row) * d + c,
                         acc);
          }
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = 0.f;
          row = r[i];
          in_first = false;
        }
        float v[V];
        L::unpack(q[i], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if constexpr (kWeighted) {
            acc[k] = fmaf(we[i], v[k], acc[k]);
          } else {
            acc[k] += v[k];
          }
        }
      }
    }
  }
  if (active) {
    store_f32<V>(in_first && cut_start ? slot0
                 : cut_end             ? slot1
                                       : out + static_cast<size_t>(row) * d + c,
                 acc);
  }
}

// Adds partials [lo, hi) of a row cut into tiles t0 .. t1 to acc, in order:
// partial 0 is slot 1 of tile t0, partial i > 0 slot 0 of tile t0 + i.
// kFixBatch loads in flight at a time.
template <int V>
__device__ __forceinline__ void add_partials(const float* __restrict__ partials, int t0, int lo,
                                             int hi, int d, int c, float (&acc)[V]) {
  for (int i0 = lo; i0 < hi; i0 += kFixBatch) {
    float q[kFixBatch][V];
#pragma unroll
    for (int i = 0; i < kFixBatch; ++i) {
      const int k = min(i0 + i, hi - 1);
      load_f32<V>(partials + static_cast<size_t>(k == 0 ? 2 * t0 + 1 : 2 * (t0 + k)) * d + c,
                  q[i]);
    }
#pragma unroll
    for (int i = 0; i < kFixBatch; ++i) {
      if (i0 + i < hi) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += q[i][j];
      }
    }
  }
}

// Rows the tiles did not finish: zeros for an empty row, the partials of a
// cut row in tile order.  One worker of `lanes` threads per row, as in the
// tile walk, so the cut rows are summed side by side (a warp that reads 32
// rows' extents and then writes the ones that need it serialises the cut rows
// of its 32, and ran twice as long on the bipartite graph's 3072 rows on an
// H100).  A row cut into more than kLongParts tiles (a hub: degree 5000 at
// tile 32 is 156 partials, 20 round trips for one worker) is summed by all
// the first kShares workers of the block instead: each adds a contiguous share
// in order, and the first worker adds the shares in share order, so the sum is
// still the same bit for bit from run to run, and the same at any number of
// lanes a worker (K7 reads a row at any alignment: its lanes, and not its
// sums, change with the load width).  Called by every thread of a block of
// kThreads threads.
template <int V, int kThreads>
__device__ __forceinline__ void fixup_rows(const float* __restrict__ partials,
                                           const int* __restrict__ row_ptr,
                                           float* __restrict__ out, int n_rows, int d, int tile,
                                           int lanes) {
  __shared__ int n_long;
  __shared__ int long_rows[kThreads];  // at most one per worker
  __shared__ float share[kThreads][V];
  const int workers = kThreads / lanes;
  const int worker = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int row = blockIdx.x * workers + worker;
  const int c = (blockIdx.y * lanes + lane) * V;
  const bool active = c < d;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  // no thread leaves before the block's hub rows are done: every worker adds a share
  if (row < n_rows) {
    const int begin = __ldg(row_ptr + row);
    const int end = __ldg(row_ptr + row + 1);
    const int t0 = begin / tile;
    // the tiles the row meets: 0 if it is empty, 1 if its tile wrote it
    const int n_parts = begin < end ? (end - 1) / tile - t0 + 1 : 0;
    if (n_parts > kLongParts) {
      if (lane == 0) long_rows[atomicAdd(&n_long, 1)] = row;  // any order: see below
    } else if (active && n_parts != 1) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      add_partials<V>(partials, t0, 0, n_parts, d, c, acc);
      store_f32<V>(out + static_cast<size_t>(row) * d + c, acc);
    }
  }
  __syncthreads();
  for (int k = 0; k < n_long; ++k) {  // the same trip count in every thread
    const int r = long_rows[k];
    const int t0 = __ldg(row_ptr + r) / tile;
    const int n_parts = (__ldg(row_ptr + r + 1) - 1) / tile - t0 + 1;
    const int per = (n_parts + kShares - 1) / kShares;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (active && worker < kShares) {
      add_partials<V>(partials, t0, min(worker * per, n_parts),
                      min((worker + 1) * per, n_parts), d, c, acc);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) share[threadIdx.x][i] = acc[i];
    __syncthreads();
    if (worker == 0 && active) {
      float sum[V];
#pragma unroll
      for (int i = 0; i < V; ++i) sum[i] = 0.f;
      for (int w = 0; w < kShares; ++w) {
#pragma unroll
        for (int i = 0; i < V; ++i) sum[i] += share[w * lanes + lane][i];
      }
      store_f32<V>(out + static_cast<size_t>(r) * d + c, sum);
    }
    __syncthreads();
  }
}

}  // namespace csr_tiles
