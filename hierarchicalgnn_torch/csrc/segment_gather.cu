// Gather-layout CSR segment sum for Hopper (sm_90a).
//
//   K7 csr_gather_tile + csr_gather_fixup  <- _segment_kernel
//                         (hierarchicalgnn_tpu/ops/pallas/segment_kernel.py:114)
//        out[i] = sum_{k in [row_ptr[i], row_ptr[i+1])} data[perm[k], :]
//
// The edge rows stay in their original, unsorted order; the layout (built
// once per graph by make_csr_layout) is a stable sort of the valid edges by
// receiver: perm[k] is the original index of the edge in slot k, recv[k] its
// receiver, and row_ptr delimits each output row's slots.
//
// What it computes, not how the TPU computed it: the Pallas version bins the
// edges into groups of 256 rows with a chunk budget, has XLA materialise
// data[perm], and multiplies by a one-hot matrix on the MXU.  Here a row's
// edges are fetched through perm inside the kernel, so no sorted copy of the
// data is ever written, there is no budget and no overflow path.
//
// Bound: memory.  It reads each valid edge row once (E_valid * D * sizeof(T)),
// 8 bytes of perm and receiver per valid slot and 4(N+1) of row_ptr, and
// writes 4*N*D; one add per element read.  The gather makes consecutive loads
// of a worker land on unrelated rows, but each is a contiguous stretch of
// D * sizeof(T) bytes.
//
// Design: K1's edge-balanced cut (csr_tiles.cuh), each slot's row loaded
// through perm.  The valid slots are cut into tiles of 128 slots (64 or 32 on
// small inputs, the wrapper's tile_edges); a worker of `lanes` threads walks a
// tile, issuing the perm entries and receivers of 16 slots, then their 16 data
// rows, before the first add, and writes each row that ends inside the tile.
// A hot row of degree 5000 is 40 workers side by side: the one-block-a-row
// kernel this replaces summed it on one SM.  The rows the tiles cut leave
// partials (two f32 rows per tile, the wrapper's cached scratch), which a
// fix-up launched right after adds in tile order; it also zeros the empty
// rows.  No atomics: two calls agree bit for bit.
//
// Any width and any base are taken.  A lane loads the widest of 16, 8, 4 or 2
// bytes that divides both the row's bytes and the base's alignment (D 100
// bf16: 200-byte rows, 8-byte loads; D 3 f32: 4-byte loads), chosen by the
// wrapper (segment_gather.load_width) and checked here.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "csr_tiles.cuh"

namespace {

using csr_tiles::kWarp;
using csr_tiles::Vec;
constexpr int kTileThreads = 64;  // the tile kernel's block, as K1's
constexpr int kThreads = 256;     // the fix-up's block

template <typename T, int W>
__global__ void __launch_bounds__(kTileThreads)
csr_gather_tile_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                       const int* __restrict__ recv, const int* __restrict__ row_ptr,
                       float* __restrict__ out, float* __restrict__ partials, int n_tiles,
                       int n_rows, int d, int tile, int lanes) {
  constexpr int V = Vec<T, W>::N;
  const int t = blockIdx.x * (kTileThreads / lanes) + threadIdx.x / lanes;
  if (t >= n_tiles) return;
  const int c = (blockIdx.y * lanes + threadIdx.x % lanes) * V;
  csr_tiles::tile_walk<T, W, false, true>(data, nullptr, perm, recv, row_ptr, out, partials,
                                          t, n_rows, d, tile, c);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
csr_gather_fixup_kernel(const float* __restrict__ partials, const int* __restrict__ row_ptr,
                        float* __restrict__ out, int n_rows, int d, int tile, int lanes) {
  csr_tiles::fixup_rows<Vec<T, W>::N, kThreads>(partials, row_ptr, out, n_rows, d, tile, lanes);
}

// The tile kernel, then the fix-up, on one stream.  `tile`, `lanes` and the
// load width W come from the wrapper (sorted_agg.csr_tiling,
// segment_gather.load_width), which also sizes `partials` to
// 2 * ceil(n_edges / tile) rows of d f32.
template <typename T, int W>
int launch_gather_sum(const void* data, const int* perm, const int* recv, const int* row_ptr,
                      float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                      int lanes, void* stream) {
  constexpr int V = Vec<T, W>::N;
  if (d % V || reinterpret_cast<uintptr_t>(data) % W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0 && d > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int slices = (d + lanes * V - 1) / (lanes * V);
    const int n_tiles = static_cast<int>((static_cast<long long>(n_edges) + tile - 1) / tile);
    if (n_tiles > 0) {
      const int per_block = kTileThreads / lanes;
      csr_gather_tile_kernel<T, W>
          <<<dim3((n_tiles + per_block - 1) / per_block, slices), kTileThreads, 0, s>>>(
              static_cast<const T*>(data), perm, recv, row_ptr, out, partials, n_tiles, n_rows,
              d, tile, lanes);
    }
    const int per_block = kThreads / lanes;
    csr_gather_fixup_kernel<T, W>
        <<<dim3((n_rows + per_block - 1) / per_block, slices), kThreads, 0, s>>>(
            partials, row_ptr, out, n_rows, d, tile, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const void* data, const int* perm, const int* recv, const int* row_ptr,
                 float* out, float* partials, int n_edges, int n_rows, int d, int tile,
                 int lanes, int width, void* stream) {
  if (tile < 1 || lanes < 1 || lanes > kWarp || (lanes & (lanes - 1)) || n_edges < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (width) {
    case 16:
      return launch_gather_sum<T, 16>(data, perm, recv, row_ptr, out, partials, n_edges, n_rows,
                                      d, tile, lanes, stream);
    case 8:
      return launch_gather_sum<T, 8>(data, perm, recv, row_ptr, out, partials, n_edges, n_rows,
                                     d, tile, lanes, stream);
    case 4:
      return launch_gather_sum<T, 4>(data, perm, recv, row_ptr, out, partials, n_edges, n_rows,
                                     d, tile, lanes, stream);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch_gather_sum<T, 2>(data, perm, recv, row_ptr, out, partials, n_edges,
                                       n_rows, d, tile, lanes, stream);
      }
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// (data, perm, recv, row_ptr, out, partials, n_edges, n_rows, d, tile, lanes, width, stream)
int hgnn_csr_gather_sum_bf16(const void* data, const int* perm, const int* recv,
                             const int* row_ptr, float* out, float* partials, int n_edges,
                             int n_rows, int d, int tile, int lanes, int width, void* stream) {
  return launch_width<__nv_bfloat16>(data, perm, recv, row_ptr, out, partials, n_edges, n_rows,
                                     d, tile, lanes, width, stream);
}

int hgnn_csr_gather_sum_f32(const void* data, const int* perm, const int* recv,
                            const int* row_ptr, float* out, float* partials, int n_edges,
                            int n_rows, int d, int tile, int lanes, int width, void* stream) {
  return launch_width<float>(data, perm, recv, row_ptr, out, partials, n_edges, n_rows, d, tile,
                             lanes, width, stream);
}

}  // extern "C"
