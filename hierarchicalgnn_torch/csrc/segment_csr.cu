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
// Bound: all three are memory-bound.  K1 reads E_valid*D*sizeof(T) + 4(N+1)
// bytes and writes 4*N*D; K2 reads 4*E_valid more for the weights; K5 reads
// 4E + 4(N+1) and writes 4N.  None does more than one add (or fma, or min)
// per element read, far below the card's ~295 operations per byte.
//
// Design, K1/K2: an edge-balanced segmented sum, cut by edges and not by rows.
//  * The valid edges [0, row_ptr[N]) are cut into tiles of `tile` consecutive
//    edges: 128, or 64 or 32 where larger tiles would leave fewer than 512
//    (the wrapper's tile_edges, from E alone).  A worker owns one tile and walks
//    its edges in order, in f32 registers, reading each edge's row from the
//    plan's receiver array.  A row that lies wholly inside the tile is written
//    straight to `out`.  A row cut by the tile's start (slot 0) or end (slot 1)
//    has its partial written to `partials[tile][slot]`; a row that covers the
//    whole tile counts as cut by its start.  A hub row of degree 5000 is thus
//    40 workers side by side, not one block: no launch lasts as long as its
//    longest row.  The grid is ceil(E / tile) tiles from E alone; a tile past
//    row_ptr[N] exits, so no host sync and no plan change is needed.
//  * A worker is `lanes` threads (a power of two up to 32), each holding 16
//    bytes of columns (8 bf16 or 4 f32).  Narrow rows (D 8 f32: 2 lanes) put
//    16 workers in a warp, so few lanes idle.  blockIdx.y picks a slice of
//    lanes * 16 bytes of columns: 256 bf16 or 128 f32 at 32 lanes.  f32 at D
//    256 is two slices side by side; no worker walks its edges twice.
//  * Loads are batched by hand: a worker issues the receiver, the weight and
//    the 16-byte data vector of kBatch (16) edges before it adds the first, so
//    a warp keeps 8 KB in flight and the walk waits for one round trip to
//    memory per 16 edges.  On a small input (E 36864 at T 128: 288 tiles)
//    those round trips, not the bytes, set the time: hence the smaller tiles.
//  * A fix-up kernel, launched from the same C entry right after, visits every
//    row once: an empty row gets zeros, a row cut into tiles t0 = begin / tile
//    .. t1 = (end - 1) / tile gets partials[t0][1] + partials[t0 + 1][0] + ...
//    + partials[t1][0], added in tile order and written once (a row of more
//    than 16 partials by the whole block, each worker a share); any other row
//    was written by its tile.  Two launches and no atomics, counters or
//    memsets: every row is summed in one fixed order, so the result is the
//    same bit for bit from run to run.  (A single launch would need the tile
//    that finishes a cut row last to find out that it is last: an atomic
//    counter per tile or a generation word as in K8, which costs more code
//    than the second launch costs time.)
//  * The partials are 2 * ceil(E / tile) rows of D f32, scratch that the
//    wrapper passes in (bf16 D 256, E 122880: 960 tiles, 1.97 MB against 61
//    MB read); only the cut rows' slots are written and read back.
// K5: one warp per row; the lanes stride over the row's edges and a shuffle
// tree reduces.
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
// K1/K2's tile kernel runs 64-thread blocks, so that the flagship's 768-960
// tiles (one warp each at D 256) spread over all 132 SMs in 384-480 blocks;
// its fix-up runs kThreads
constexpr int kTileThreads = 64;
constexpr int kBatch = 16;  // edges whose loads a worker issues before any add
constexpr int kFixBatch = 8;  // partials whose loads the fix-up issues before any add
constexpr int kLongParts = 16;  // a row of more partials is summed by a whole fix-up block

// One 16-byte vector of a data row: its raw load, kept apart from its
// conversion so that a worker can issue several loads before it uses one.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
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
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// V f32 values to p (16-byte aligned) as V / 4 vector stores.
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kTileThreads)
csr_tile_sum_kernel(const T* __restrict__ data, const float* __restrict__ w,
                    const int* __restrict__ recv, const int* __restrict__ row_ptr,
                    float* __restrict__ out, float* __restrict__ partials, int n_tiles,
                    int n_rows, int d, int tile, int lanes) {
  using L = Vec<T>;
  constexpr int V = L::N;
  const int t = blockIdx.x * (kTileThreads / lanes) + threadIdx.x / lanes;
  if (t >= n_tiles) return;
  const int n_valid = __ldg(row_ptr + n_rows);
  const int start = t * tile;
  if (start >= n_valid) return;  // the whole worker leaves together
  const int stop = min(start + tile, n_valid);
  const int c = (blockIdx.y * lanes + threadIdx.x % lanes) * V;
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
    // the loads of kBatch edges first (a slot past the tile repeats its last
    // edge and is not added), then the adds in edge order
    int r[kBatch];
    typename L::Raw q[kBatch];
    float we[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = min(e0 + i, stop - 1);
      r[i] = __ldg(recv + e);
      q[i] = L::load(col + static_cast<size_t>(e) * d);
      if constexpr (kWeighted) we[i] = __ldg(w + e);
    }
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
    float4 q[kFixBatch][V / 4];
#pragma unroll
    for (int i = 0; i < kFixBatch; ++i) {
      const int k = min(i0 + i, hi - 1);
      const float* p = partials + static_cast<size_t>(k == 0 ? 2 * t0 + 1 : 2 * (t0 + k)) * d + c;
#pragma unroll
      for (int j = 0; j < V / 4; ++j) q[i][j] = __ldg(reinterpret_cast<const float4*>(p) + j);
    }
#pragma unroll
    for (int i = 0; i < kFixBatch; ++i) {
      if (i0 + i < hi) {
#pragma unroll
        for (int j = 0; j < V / 4; ++j) {
          acc[4 * j] += q[i][j].x;
          acc[4 * j + 1] += q[i][j].y;
          acc[4 * j + 2] += q[i][j].z;
          acc[4 * j + 3] += q[i][j].w;
        }
      }
    }
  }
}

// Rows the tiles did not finish: zeros for an empty row, the partials of a
// cut row in tile order.  One worker of `lanes` threads per row, as in the
// tile kernel, so the cut rows are summed side by side (a warp that reads 32
// rows' extents and then writes the ones that need it serialises the cut rows
// of its 32, and ran twice as long on the bipartite graph's 3072 rows on an
// H100).  A row cut into more than kLongParts tiles (a hub: degree 5000 at
// tile 32 is 156 partials, 20 round trips for one worker) is summed by all
// the workers of the block instead: each adds a contiguous share in order,
// and the first worker adds the shares in worker order, so the sum is still
// the same bit for bit from run to run.  Templated like the tile kernel it
// follows, so that a trace tells K1's fix-up from K2's.
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
csr_tile_fixup_kernel(const float* __restrict__ partials, const int* __restrict__ row_ptr,
                      float* __restrict__ out, int n_rows, int d, int tile, int lanes) {
  constexpr int V = Vec<T>::N;
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
    const int per = (n_parts + workers - 1) / workers;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    if (active) {
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
      for (int w = 0; w < workers; ++w) {
#pragma unroll
        for (int i = 0; i < V; ++i) sum[i] += share[w * lanes + lane][i];
      }
      store_f32<V>(out + static_cast<size_t>(r) * d + c, sum);
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

// The tile kernel, then the fix-up, on one stream.  `tile` and `lanes` come
// from the wrapper (sorted_agg.py::csr_tiling), which also sizes `partials`
// to 2 * ceil(n_edges / tile) rows of d f32.
template <typename T, bool kWeighted>
int launch_tile_sum(const void* data, const float* w, const int* recv, const int* row_ptr,
                    float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                    int lanes, void* stream) {
  constexpr int V = Vec<T>::N;
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

int hgnn_csr_min_i32(const int* vals, const int* row_ptr, int* out, int n_rows,
                     void* stream) {
  if (n_rows > 0) {
    csr_min_i32_kernel<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(vals, row_ptr, out, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
