// HDBSCAN's two heavy parts for Hopper (sm_90a), in float64: the core
// distances and Prim's minimum spanning tree of the mutual-reachability graph.
//
//   HD1 core_distances  <- sklearn.cluster.HDBSCAN (host), reached from
//        hierarchicalgnn_tpu/evaluation/candidates.py:43; sklearn
//        hdbscan.py:340-356, kneighbors(X, k)[0][:, -1]
//        core[i] = sqrt(the k-th smallest of d2(i, j) over all j, i included)
//   HD2 prim_mst        <- the same; sklearn _linkage.pyx:111-223,
//        mst_from_data_matrix
//        from node 0, N - 1 steps: for every j not in the tree,
//        mr = max(core[cur], core[j], sqrt(d2(cur, j))); where mr < min_reach[j]
//        (strictly) min_reach[j] = mr and source[j] = cur; the next node is the
//        lowest index among the smallest min_reach; its edge
//        (source[next], next, min_reach[next]) is written in step order.
//
// Neither replaces a Pallas kernel: the JAX package runs this on the host.
// Both must give sklearn's bits, because the MST's weights tie structurally
// and another tree among the equal-weight ones changes the partition.  So
// d2 sums (x_f - y_f)^2 in feature order with a separate multiply and add
// (__dsub_rn / __dmul_rn / __dadd_rn: -O3 would contract `d += t * t` into
// an FMA, which rounds once instead of twice), and sqrt is __dsqrt_rn.
//
// HD1: one thread per query point, kCoreThreads queries a block with their
// coordinates in shared memory; all points stream through shared memory in
// tiles of kCoreTile rows, and each query keeps its K smallest d2 in
// registers by insertion (K a template argument up to kMaxK).  How many
// candidates share a value does not change the K-th value, so ties need no
// rule.  Bound: float64 operations, 3 D per pair (sub, mul, add) over the
// N (N - 1) / 2 pairs the function needs; this simple version does all N^2.
//
// HD2: one cooperative launch runs the whole loop, with no host round trip
// per step.  Block b owns `pts` consecutive points and keeps their
// coordinates, core distances and Prim state (min_reach f64, source i64,
// in_tree u8) in shared memory.  Each step: every thread updates its points
// from the current node's row, the block reduces (min_reach, index)
// lexicographically (the lower index wins a tie), thread 0 publishes the
// block's candidate (value, index, source, core, coordinates) into a
// global buffer double-buffered by step parity, and the grid meets at one
// barrier (an arrival counter: red.release, then ld.acquire until every
// block of this step has arrived).  Then every block reads all candidates
// (through L2: __ldcg) and picks the same winner, whose coordinates and core
// distance come with its candidate, so the next step needs no other read.
// Block 0 writes the edge; the owner marks the winner in its tree.  A block
// may write the other parity's buffer while a slow block still reads this
// step's: the buffer it writes at step s + 2 is read only before the
// barrier of step s + 1, so one barrier a step suffices.  Lexicographic
// (value, index) minimum is associative and commutative, so neither the
// reduction tree nor the blocks' order changes the winner.
// Bound: N - 1 dependent steps, each at least one grid barrier (the step
// floor), not the N (N - 1) / 2 pairs' float64 arithmetic.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (or the launch's
// own error).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kCoreThreads = 128;  // HD1: queries per block
constexpr int kCoreTile = 128;     // HD1: candidate rows per shared-memory tile
constexpr int kMaxK = 16;          // HD1: the largest k it keeps in registers
constexpr int kMstThreads = 256;   // HD2: threads per block
constexpr unsigned kFull = 0xffffffffu;

// d2(a, b) over d features, in feature order, rounded as sklearn's loop is
__device__ __forceinline__ double squared_distance(const double* a, int a_step,
                                                   const double* b, int d) {
  double acc = 0.0;
  for (int f = 0; f < d; ++f) {
    const double t = __dsub_rn(a[f * a_step], b[f]);
    acc = __dadd_rn(acc, __dmul_rn(t, t));
  }
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kCoreThreads)
    core_distance_kernel(const double* __restrict__ x, double* __restrict__ out, int n, int d) {
  extern __shared__ double smem[];
  double* queries = smem;                    // [d][kCoreThreads], feature-major
  double* tile = smem + d * kCoreThreads;    // [kCoreTile][d]
  const long long base = static_cast<long long>(blockIdx.x) * kCoreThreads;
  const long long i = base + threadIdx.x;
  for (int e = threadIdx.x; e < kCoreThreads * d; e += kCoreThreads) {
    const int r = e / d, f = e % d;
    queries[f * kCoreThreads + r] = base + r < n ? x[(base + r) * d + f] : 0.0;
  }
  double best[K];  // the K smallest d2 so far, ascending
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = CUDART_INF;
  for (long long start = 0; start < n; start += kCoreTile) {
    const int rows = static_cast<int>(n - start < kCoreTile ? n - start : kCoreTile);
    __syncthreads();  // the last tile is consumed, the queries are in
    for (int e = threadIdx.x; e < rows * d; e += kCoreThreads) tile[e] = x[start * d + e];
    __syncthreads();
    if (i >= n) continue;
    for (int c = 0; c < rows; ++c) {
      const double d2 = squared_distance(queries + threadIdx.x, kCoreThreads, tile + c * d, d);
      if (d2 < best[K - 1]) {
        best[K - 1] = d2;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (best[s] < best[s - 1]) {
            const double t = best[s];
            best[s] = best[s - 1];
            best[s - 1] = t;
          }
        }
      }
    }
  }
  if (i < n) out[i] = __dsqrt_rn(best[K - 1]);
}

__device__ __forceinline__ bool lex_less(double v, long long i, double best_v, long long best_i) {
  return v < best_v || (v == best_v && i < best_i);
}

// The block's lexicographic minimum of (v, i); thread 0 holds it on return.
// Starts with a write to red_v/red_i: the caller has synchronised since their
// last read.
__device__ __forceinline__ void block_argmin(double& v, long long& i, double* red_v,
                                             long long* red_i) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const double ov = __shfl_down_sync(kFull, v, off);
    const long long oi = __shfl_down_sync(kFull, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / kWarp;
    v = lane < warps ? red_v[lane] : CUDART_INF;
    i = lane < warps ? red_i[lane] : LLONG_MAX;
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const double ov = __shfl_down_sync(kFull, v, off);
      const long long oi = __shfl_down_sync(kFull, i, off);
      if (lex_less(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
  }
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_gpu_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// cand: [2][gridDim.x][4 + d] doubles: min_reach, index bits, source bits,
// core distance, coordinates.  barrier: one zeroed word.
__global__ void __launch_bounds__(kMstThreads)
    prim_mst_kernel(const double* __restrict__ x, const double* __restrict__ core,
                    long long* __restrict__ e_src, long long* __restrict__ e_dst,
                    double* __restrict__ e_dist, double* cand, unsigned* barrier, int n, int d,
                    int pts) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int grid = gridDim.x, stride = 4 + d, tid = threadIdx.x;
  double* xs = reinterpret_cast<double*>(raw);                  // [pts][d]
  double* reach = xs + static_cast<size_t>(pts) * d;             // [pts]
  double* cores = reach + pts;                                   // [pts]
  long long* sources = reinterpret_cast<long long*>(cores + pts);  // [pts]
  double* cands = reinterpret_cast<double*>(sources + pts);      // [grid][stride]
  double* red_v = cands + static_cast<size_t>(grid) * stride;     // [32]
  long long* red_i = reinterpret_cast<long long*>(red_v + kWarp);  // [32]
  int* winner = reinterpret_cast<int*>(red_i + kWarp);            // [4]
  unsigned char* in_tree = reinterpret_cast<unsigned char*>(winner + 4);  // [pts]

  const long long begin = static_cast<long long>(blockIdx.x) * pts;
  const long long left = n - begin;
  const int count = left <= 0 ? 0 : (left < pts ? static_cast<int>(left) : pts);
  for (int e = tid; e < count * d; e += kMstThreads) xs[e] = x[begin * d + e];
  for (int j = tid; j < count; j += kMstThreads) {
    reach[j] = CUDART_INF;
    cores[j] = core[begin + j];
    sources[j] = 1;  // sklearn's np.ones; every point is updated at step 0
    in_tree[j] = 0;
  }
  __syncthreads();
  if (tid == 0 && count > 0 && begin == 0) in_tree[0] = 1;
  // the current node: 0, read from x; later the winner's candidate
  const double* cur_x = x;
  double cur_core = core[0];
  long long cur = 0;
  __syncthreads();

  for (int s = 0; s < n - 1; ++s) {
    double bv = CUDART_INF;
    long long bi = LLONG_MAX;
    for (int j = tid; j < count; j += kMstThreads) {
      if (in_tree[j]) continue;
      const double dist = __dsqrt_rn(squared_distance(cur_x, 1, xs + static_cast<size_t>(j) * d, d));
      const double mr = fmax(fmax(cur_core, cores[j]), dist);
      double r = reach[j];
      if (mr < r) {
        r = mr;
        reach[j] = mr;
        sources[j] = cur;
      }
      if (lex_less(r, begin + j, bv, bi)) {
        bv = r;
        bi = begin + j;
      }
    }
    block_argmin(bv, bi, red_v, red_i);
    double* step_cands = cand + static_cast<size_t>(s & 1) * grid * stride;
    if (tid == 0) {
      double* mine = step_cands + static_cast<size_t>(blockIdx.x) * stride;
      mine[0] = bv;
      mine[1] = __longlong_as_double(bi);
      if (bi != LLONG_MAX) {
        const int j = static_cast<int>(bi - begin);
        mine[2] = __longlong_as_double(sources[j]);
        mine[3] = cores[j];
        for (int f = 0; f < d; ++f) mine[4 + f] = xs[static_cast<size_t>(j) * d + f];
      }
      __threadfence();
      red_release_gpu_add(barrier, 1u);
      const unsigned target = static_cast<unsigned>(s + 1) * static_cast<unsigned>(grid);
      while (ld_acquire_gpu(barrier) < target) {
      }
    }
    __syncthreads();
    for (int e = tid; e < grid * stride; e += kMstThreads) cands[e] = __ldcg(step_cands + e);
    __syncthreads();
    double wv = CUDART_INF;
    long long wi = LLONG_MAX;
    for (int b = tid; b < grid; b += kMstThreads) {
      const double v = cands[b * stride];
      const long long i = __double_as_longlong(cands[b * stride + 1]);
      if (lex_less(v, i, wv, wi)) {
        wv = v;
        wi = i;
      }
    }
    block_argmin(wv, wi, red_v, red_i);
    if (tid == 0) winner[0] = static_cast<int>(wi / pts);
    __syncthreads();
    const double* won = cands + static_cast<size_t>(winner[0]) * stride;
    cur = __double_as_longlong(won[1]);
    cur_core = won[3];
    cur_x = won + 4;
    if (tid == 0) {
      if (cur >= begin && cur < begin + count) in_tree[cur - begin] = 1;
      if (blockIdx.x == 0) {
        e_src[s] = __double_as_longlong(won[2]);
        e_dst[s] = cur;
        e_dist[s] = won[0];
      }
    }
    __syncthreads();
  }
}

template <int K>
int launch_core(const double* x, double* out, int n, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kCoreThreads + kCoreTile) * d * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(core_distance_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kCoreThreads - 1) / kCoreThreads;
  core_distance_kernel<K><<<blocks, kCoreThreads, smem, stream>>>(x, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [n, d] float64 row-major; out: [n] float64.  1 <= k <= min(n, 16).
int hgnn_core_distances_f64(const double* x, double* out, int n, int d, int k, void* stream) {
  if (n < 1 || d < 1 || k < 1 || k > n || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HGNN_CORE_CASE(K) \
  case K:                 \
    return launch_core<K>(x, out, n, d, s);
    HGNN_CORE_CASE(1) HGNN_CORE_CASE(2) HGNN_CORE_CASE(3) HGNN_CORE_CASE(4)
    HGNN_CORE_CASE(5) HGNN_CORE_CASE(6) HGNN_CORE_CASE(7) HGNN_CORE_CASE(8)
    HGNN_CORE_CASE(9) HGNN_CORE_CASE(10) HGNN_CORE_CASE(11) HGNN_CORE_CASE(12)
    HGNN_CORE_CASE(13) HGNN_CORE_CASE(14) HGNN_CORE_CASE(15) HGNN_CORE_CASE(16)
#undef HGNN_CORE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: [n, d] float64; core: [n] float64; src/dst: [n - 1] int64, dist:
// [n - 1] float64, written in Prim's order; cand: [2 * grid * (4 + d)]
// float64 scratch; barrier: one zeroed 32-bit word.  grid blocks of `pts`
// points each (grid * pts >= n), `smem` bytes of shared memory a block (the
// wrapper's mst_schedule); the grid must be resident at once (cooperative).
int hgnn_prim_mst_f64(const double* x, const double* core, long long* src, long long* dst,
                      double* dist, double* cand, unsigned* barrier, int n, int d, int grid,
                      int pts, int smem, void* stream) {
  if (n < 1 || d < 1 || grid < 1 || pts < 1 || static_cast<long long>(grid) * pts < n ||
      smem < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(prim_mst_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&x, &core, &src, &dst, &dist, &cand, &barrier, &n, &d, &pts};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&prim_mst_kernel), dim3(grid),
                                    dim3(kMstThreads), args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
