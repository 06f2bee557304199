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
// HD1 (core_distance_kernel<K>).  Bound: float64 operations, 3 D per pair
// over the N (N - 1) / 2 pairs the function needs; this kernel does all N^2
// (twice the bound's count).  What held the first design back was an empty
// card: one thread per query scanning all N candidates gave 166 blocks of 4
// warps on 132 SMs, too few warps to hide the latency of the dependent
// sub -> mul -> add chain.  So the candidate axis is split: the grid is
// (query blocks, S slices), each block scans 1 / S of the candidates, with
// S chosen by the wrapper so that the card holds about 32 warps an SM.  A
// thread owns kCoreQ queries (their coordinates in shared memory,
// feature-major) and takes kCoreCB candidates at a time, so each pass over
// the features reads kCoreQ + kCoreCB values from shared memory for
// 3 kCoreQ kCoreCB operations and keeps kCoreQ kCoreCB independent sums in
// registers.  Candidate tiles of kCoreTile rows arrive by cp.async into two
// buffers: the one __syncthreads a tile both publishes the new tile and
// frees the other buffer for the next copy.  Each (query, slice) keeps its K
// smallest d2 in registers by insertion (K a template argument up to kMaxK);
// the last block of a query block to arrive (an arrival counter) merges the
// S lists and writes sqrt of the K-th.  The K-th of the union of the
// slices' K smallest is the K-th overall, bit for bit: the multiset of d2
// values is the same, and how many share a value does not change the K-th.
//
// HD2 has two routes, picked by size in the wrapper, never on a failure.
//
// HD2, cluster route (prim_mst_cluster_kernel<P>).  Bound: N - 1 dependent
// steps, not the N (N - 1) / 2 pairs' float64 arithmetic; the first design
// paid a grid barrier through L2 a step (3.29 us a step on the H100).  Here
// one launch of a single thread-block cluster (16 CTAs where the card
// schedules them, else 8) runs the whole loop, and no step touches global
// memory or L2 but for the edge it writes.  CTA r owns `pts` consecutive
// points: their coordinates in its shared memory (feature-major), their Prim
// state (min_reach, core, source) in registers, P points a thread; a point in
// the tree (or none) has min_reach NaN, which is never live and never wins.
// One step:
//   1. each thread updates its points from the current node's coordinates;
//      a point whose max(core[cur], core[j]) already reaches min_reach[j]
//      cannot change (mr >= min_reach[j]), a warp none of whose points can
//      change skips the distances, and a point whose d2 already reaches
//      min_reach[j]^2 (with a margin that covers the rounding) skips the
//      square root; at width 8 (every shipped configuration's) the width is
//      a template argument, so that a point's loads are all in flight at
//      once;
//   2. redux.sync finds each warp's lexicographic (min_reach, index) minimum
//      (min_reach >= 0, so its bits order as its values do); after one
//      __syncthreads every warp reduces the 32 warps' minima to the CTA's;
//   3. the warp that holds the CTA's candidate writes its record
//      (min_reach, index, source, core, coordinates), and its lanes store it
//      with st.async into slot [step parity][r] of every CTA of the cluster,
//      16 bytes a store, each store completing on the receiver's mbarrier
//      [step parity];
//   4. one wait a step, on the CTA's own mbarrier: it completes when every
//      CTA's record of the step is in (thread 0 then re-arms it for step
//      s + 2 with the bytes it expects);
//   5. every warp reduces the cluster's candidates from its own shared
//      memory: all CTAs pick the same winner, whose coordinates and core
//      distance sit in its slot for the next step.  CTA 0 writes the edge;
//      the owner marks the winner.
// Why no cluster barrier a step: the data has to cross the cluster anyway,
// and st.async signals its own arrival, so a step waits for the data once.
// A barrier.cluster after remote stores waits for the stores'
// acknowledgements and then for the barrier, and reading the slots over
// DSMEM after it adds a remote round trip (two where the winner's
// coordinates come second) and, for one reader a CTA, a second
// __syncthreads; cp.async.bulk copies in st.async's place arrive later.
// Two parities suffice with one wait a step: a CTA sends its step s + 2
// record only after its step s + 1 wait, which needs every CTA's step s + 1
// record, which each CTA sends after all its threads have read the step s
// slots (and used them as the current node of step s + 1); the same chain
// puts every receiver's re-arming before the first store of its next phase,
// frees a CTA's own record buffer before it is written again, and keeps the
// partials of step 2 (double-buffered) from being overwritten while read.
// The lexicographic minimum is associative and commutative, so neither the
// reduction tree nor the CTAs' order changes the winner.  Capacity:
// pts <= 1024 P (P <= 4) and the coordinates within shared memory; above it
// the wrapper takes the cooperative route.
//
// HD2, cooperative route (prim_mst_kernel), for N above the cluster's
// capacity: one cooperative launch runs the whole loop.  Block b owns `pts`
// consecutive points and keeps their coordinates, core distances and Prim
// state in shared memory.  Each step the block reduces (min_reach, index),
// thread 0 publishes the block's candidate into a global buffer
// double-buffered by step parity, and the grid meets at one barrier (an
// arrival counter: red.release, then ld.acquire until every block of this
// step has arrived); every block then reads all candidates through L2
// (__ldcg) and picks the same winner.  The same two-parity argument holds.
//
// Interface: plain C, loaded with ctypes.  Each entry launches on the given
// stream, allocates nothing, and returns cudaGetLastError() (or the launch's
// own error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCoreThreads = 128;  // HD1: threads per block
constexpr int kCoreQ = 2;          // HD1: queries a thread
constexpr int kCoreCB = 4;         // HD1: candidates a thread takes per pass over the features
constexpr int kCoreTile = 64;      // HD1: candidate rows per shared-memory tile
constexpr int kCoreRows = kCoreThreads * kCoreQ;  // HD1: queries per block
constexpr int kMaxK = 16;          // HD1: the largest k it keeps in registers
constexpr int kClusterThreads = 1024;  // HD2 cluster route: threads per CTA
constexpr int kClusterWarps = kClusterThreads / kWarp;
constexpr int kMaxPerThread = 4;   // HD2 cluster route: points a thread, at most
constexpr int kMstThreads = 256;   // HD2 cooperative route: threads per block
constexpr unsigned long long kNoKey = ~0ull;  // no candidate: above every min_reach's bits
constexpr unsigned kNoIndex = 0xffffffffu;
static_assert(kClusterWarps == kWarp, "a warp reduces the CTA's partials, one a lane");
static_assert(kCoreTile % kCoreCB == 0, "a tile holds whole candidate groups");

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

// keeps the K smallest values seen, ascending
template <int K>
__device__ __forceinline__ void keep_smallest(double (&best)[K], double v) {
  if (v < best[K - 1]) {
    best[K - 1] = v;
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// grid (query blocks, slices).  part: [slices][n][K] float64 scratch (unused
// at one slice); arrivals: one zeroed word a query block.
template <int K>
__global__ void __launch_bounds__(kCoreThreads)
    core_distance_kernel(const double* __restrict__ x, double* __restrict__ out,
                         double* __restrict__ part, unsigned* __restrict__ arrivals, int n,
                         int d) {
  extern __shared__ __align__(16) double smem[];
  __shared__ bool last;
  double* queries = smem;                                      // [d][kCoreRows]
  double* tiles = smem + static_cast<size_t>(d) * kCoreRows;   // [2][kCoreTile][d]
  const int tid = threadIdx.x, slices = gridDim.y, slice = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * kCoreRows;
  const long long per = (n + slices - 1) / slices;
  const long long lo = per * slice < n ? per * slice : n;
  const long long hi = lo + per < n ? lo + per : n;
  for (int e = tid; e < kCoreRows * d; e += kCoreThreads) {
    const int r = e / d, f = e % d;
    queries[f * kCoreRows + r] = base + r < n ? x[(base + r) * d + f] : 0.0;
  }
  double best[kCoreQ][K];  // per query, the K smallest d2 of this slice, ascending
#pragma unroll
  for (int q = 0; q < kCoreQ; ++q) {
#pragma unroll
    for (int s = 0; s < K; ++s) best[q][s] = CUDART_INF;
  }
  const int tile_elems = kCoreTile * d;
  auto fetch = [&](long long start, int buf) {
    const int rows = static_cast<int>(hi - start < kCoreTile ? hi - start : kCoreTile);
    double* dst = tiles + buf * tile_elems;
    const double* src = x + start * d;
    for (int e = tid; e < rows * d; e += kCoreThreads) cp_async8(dst + e, src + e);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (lo < hi) fetch(lo, 0);
  int buf = 0;
  for (long long start = lo; start < hi; start += kCoreTile, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // this tile (and the queries) are in for every thread, and every thread
    // is done with the other buffer, which the next copy fills
    __syncthreads();
    if (start + kCoreTile < hi) fetch(start + kCoreTile, buf ^ 1);
    const int rows = static_cast<int>(hi - start < kCoreTile ? hi - start : kCoreTile);
    const double* tile = tiles + buf * tile_elems;
    for (int c0 = 0; c0 < rows; c0 += kCoreCB) {
      double acc[kCoreQ][kCoreCB];
#pragma unroll
      for (int q = 0; q < kCoreQ; ++q) {
#pragma unroll
        for (int b = 0; b < kCoreCB; ++b) acc[q][b] = 0.0;
      }
      for (int f = 0; f < d; ++f) {
        double qv[kCoreQ], cv[kCoreCB];
#pragma unroll
        for (int q = 0; q < kCoreQ; ++q) qv[q] = queries[f * kCoreRows + q * kCoreThreads + tid];
        // rows past `rows` hold stale values; their sums are never kept
#pragma unroll
        for (int b = 0; b < kCoreCB; ++b) cv[b] = tile[(c0 + b) * d + f];
#pragma unroll
        for (int q = 0; q < kCoreQ; ++q) {
#pragma unroll
          for (int b = 0; b < kCoreCB; ++b) {
            const double t = __dsub_rn(qv[q], cv[b]);
            acc[q][b] = __dadd_rn(acc[q][b], __dmul_rn(t, t));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCoreQ; ++q) {
#pragma unroll
        for (int b = 0; b < kCoreCB; ++b) {
          if (c0 + b < rows) keep_smallest(best[q], acc[q][b]);
        }
      }
    }
  }
  if (slices == 1) {
#pragma unroll
    for (int q = 0; q < kCoreQ; ++q) {
      const long long i = base + q * kCoreThreads + tid;
      if (i < n) out[i] = __dsqrt_rn(best[q][K - 1]);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kCoreQ; ++q) {
    const long long i = base + q * kCoreThreads + tid;
    if (i < n) {
#pragma unroll
      for (int s = 0; s < K; ++s) part[(slice * static_cast<long long>(n) + i) * K + s] = best[q][s];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + blockIdx.x, 1u) == static_cast<unsigned>(slices - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();  // every slice's lists are visible to this, the last block
#pragma unroll
  for (int q = 0; q < kCoreQ; ++q) {
    const long long i = base + q * kCoreThreads + tid;
    if (i >= n) continue;
    double merged[K];
#pragma unroll
    for (int s = 0; s < K; ++s) merged[s] = CUDART_INF;
    for (int sl = 0; sl < slices; ++sl) {
      const double* list = part + (sl * static_cast<long long>(n) + i) * K;
      for (int s = 0; s < K; ++s) {
        const double v = __ldcg(list + s);
        if (!(v < merged[K - 1])) break;  // the list ascends: nothing after it is kept
        keep_smallest(merged, v);
      }
    }
    out[i] = __dsqrt_rn(merged[K - 1]);
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory word in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// one arrival on this CTA's mbarrier that also expects `bytes` of remote stores
__device__ __forceinline__ void arm_barrier(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_barrier(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// d2(cx, point) for a point whose coordinates are column `row` of the
// feature-major [d][pts] array, in feature order; kD > 0 fixes d at compile
// time, so that every load of the point is in flight at once
template <int kD>
__device__ __forceinline__ double distance_from(const double* cx, const double* row, int pts,
                                                int d) {
  double acc = 0.0;
  if constexpr (kD > 0) {
#pragma unroll
    for (int f = 0; f < kD; ++f) {
      const double t = __dsub_rn(cx[f], row[static_cast<size_t>(f) * pts]);
      acc = __dadd_rn(acc, __dmul_rn(t, t));
    }
  } else {
#pragma unroll 2
    for (int f = 0; f < d; ++f) {
      const double t = __dsub_rn(cx[f], row[static_cast<size_t>(f) * pts]);
      acc = __dadd_rn(acc, __dmul_rn(t, t));
    }
  }
  return acc;
}

// The lexicographic minimum of (key, index) over the warp, in every lane.
// A key is the bits of a min_reach >= 0 (or kNoKey), which order as the
// values do; indices are distinct (or kNoIndex).
__device__ __forceinline__ void warp_argmin(unsigned long long& key, unsigned& index) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned min_hi = __reduce_min_sync(kFull, hi);
  const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
  index = __reduce_min_sync(kFull, hi == min_hi && lo == min_lo ? index : kNoIndex);
  key = static_cast<unsigned long long>(min_hi) << 32 | min_lo;
}

// One cluster of gridDim.x CTAs; CTA r owns points [r pts, (r + 1) pts).
// Shared memory (the wrapper's mst_cluster_schedule sizes it): coordinates
// [d][pts] f64 (padded to 16 bytes); slots [2][ctas][stride] u64, a record
// being (key, index | source << 32, core, coordinates), stride = 3 + d
// rounded up to an even count; this CTA's own records [2][stride]; two
// mbarriers; node 0's record [stride]; the warps' partials [2][32] keys and
// [2][32] indices.  kD: the width fixed at compile time (0: d).
template <int P, int kD>
__global__ void __launch_bounds__(kClusterThreads)
    prim_mst_cluster_kernel(const double* __restrict__ x, const double* __restrict__ core,
                            long long* __restrict__ e_src, long long* __restrict__ e_dst,
                            double* __restrict__ e_dist, int n, int d, int pts) {
  extern __shared__ __align__(16) unsigned char raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int stride = (3 + d + 1) & ~1;
  const unsigned rec_bytes = 8u * stride, step_bytes = rec_bytes * ctas;
  double* xs = reinterpret_cast<double*>(raw);
  unsigned long long* slots = reinterpret_cast<unsigned long long*>(
      xs + ((static_cast<size_t>(d) * pts + 1) & ~static_cast<size_t>(1)));
  unsigned long long* recs = slots + 2 * ctas * stride;
  unsigned long long* bars = recs + 2 * stride;
  unsigned long long* first = bars + 2;
  unsigned long long* red_key = first + stride;
  unsigned* red_index = reinterpret_cast<unsigned*>(red_key + 2 * kClusterWarps);

  const int begin = rank * pts;
  const int count = n - begin <= 0 ? 0 : (n - begin < pts ? n - begin : pts);
  for (int e = tid; e < count * d; e += kClusterThreads) {
    const int j = e / d, f = e % d;
    xs[static_cast<size_t>(f) * pts + j] = x[static_cast<size_t>(begin) * d + e];
  }
  for (int f = tid; f < d; f += kClusterThreads) first[3 + f] = __double_as_longlong(x[f]);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + b)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm_barrier(smem_addr(bars), step_bytes);  // steps 0 and 1
    arm_barrier(smem_addr(bars + 1), step_bytes);
  }
  const double in_tree = __longlong_as_double(0x7ff8000000000000ll);  // NaN: never live, never won
  double reach[P], cores[P];
  unsigned source[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = p * kClusterThreads + tid;
    reach[p] = j < count ? CUDART_INF : in_tree;  // a point that does not exist is "in the tree"
    source[p] = 1;  // sklearn's np.ones; every point is updated at step 0
    cores[p] = j < count ? core[begin + j] : 0.0;
  }
  if (begin == 0 && tid == 0) reach[0] = in_tree;  // node 0
  unsigned cur = 0;
  double cur_core = core[0];
  const unsigned long long* cur_rec = first;
  cluster_barrier();  // every CTA runs, its mbarriers are initialised, its points are in

  for (int s = 0; s < n - 1; ++s) {
    const int parity = s & 1;
    const double* cx = reinterpret_cast<const double*>(cur_rec + 3);
    // 1. update this thread's points from the current node; a warp none of
    // whose points can change skips the distances
    unsigned long long bkey = kNoKey;
    unsigned bindex = kNoIndex, bsource = 0;
    double bcore = 0.0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool live = fmax(cur_core, cores[p]) < reach[p];  // else mr >= min_reach; NaN: no
      if (__any_sync(kFull, live)) {
        const int j = p * kClusterThreads + tid;
        const double acc = distance_from<kD>(cx, xs + (j < count ? j : 0), pts, d);
        // sqrt_rn(acc) >= r (so mr >= r) once acc >= r^2, which
        // fl(fl(r r) (1 + 2^-50)) exceeds for r in [2^-500, 2^500]: no sqrt
        // for a point that cannot change
        const double r = reach[p];
        if (live && !(r >= 0x1p-500 && r <= 0x1p500 &&
                      acc >= __dmul_rn(__dmul_rn(r, r), 1.0 + 0x1p-50))) {
          const double mr = fmax(fmax(cur_core, cores[p]), __dsqrt_rn(acc));
          if (mr < r) {
            reach[p] = mr;
            source[p] = cur;
          }
        }
      }
      const unsigned long long key = static_cast<unsigned long long>(__double_as_longlong(reach[p]));
      if (key < bkey) {  // p ascends with the index: a tie keeps the lower
        bkey = key;
        bindex = static_cast<unsigned>(begin + p * kClusterThreads + tid);
        bsource = source[p];
        bcore = cores[p];
      }
    }
    // 2. the warp's minimum; one __syncthreads; every warp reduces the
    // warps' minima to the CTA's
    unsigned long long key = bkey;
    unsigned index = bindex;
    warp_argmin(key, index);
    if (lane == 0) {
      red_key[parity * kClusterWarps + warp] = key;
      red_index[parity * kClusterWarps + warp] = index;
    }
    __syncthreads();
    key = red_key[parity * kClusterWarps + lane];
    index = red_index[parity * kClusterWarps + lane];
    warp_argmin(key, index);
    // 3. the warp that holds the CTA's candidate (warp 0 where the CTA has
    // none) writes its record, then its lanes store it into slot
    // [parity][rank] of every CTA, 16 bytes a store, each completing on that
    // CTA's mbarrier [parity]
    const unsigned holder = __ballot_sync(kFull, bindex == index && (index != kNoIndex || tid == 0));
    if (holder) {
      const int from = __ffs(holder) - 1;
      const unsigned long long word =
          index | static_cast<unsigned long long>(__shfl_sync(kFull, bsource, from)) << 32;
      const double hcore = __shfl_sync(kFull, bcore, from);
      const int j = index == kNoIndex ? 0 : static_cast<int>(index) - begin;
      unsigned long long* rec = recs + parity * stride;
      for (int w = lane; w < 3 + d; w += kWarp) {
        rec[w] = w == 0   ? key
                 : w == 1 ? word
                 : w == 2 ? static_cast<unsigned long long>(__double_as_longlong(hcore))
                          : static_cast<unsigned long long>(
                                __double_as_longlong(xs[static_cast<size_t>(w - 3) * pts + j]));
      }
      __syncwarp();
      const int half = stride / 2;
      for (int e = lane; e < ctas * half; e += kWarp) {
        const int to = e / half, c = e % half;
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];\n"
            ::"r"(cluster_addr(smem_addr(slots + (parity * ctas + rank) * stride + 2 * c), to)),
            "l"(rec[2 * c]), "l"(rec[2 * c + 1]), "r"(cluster_addr(smem_addr(bars + parity), to))
            : "memory");
      }
    }
    // 4. one wait a step: every CTA's record of this step is in
    wait_barrier(smem_addr(bars + parity), (s >> 1) & 1);
    if (tid == 0) arm_barrier(smem_addr(bars + parity), step_bytes);  // for step s + 2
    // 5. every warp picks the winner from the slots in its own shared memory
    const unsigned long long* cands = slots + parity * ctas * stride;
    unsigned long long wkey = lane < ctas ? cands[lane * stride] : kNoKey;
    const unsigned long long word = lane < ctas ? cands[lane * stride + 1] : kNoIndex;
    unsigned windex = static_cast<unsigned>(word);
    warp_argmin(wkey, windex);
    const int won = __ffs(__ballot_sync(kFull, lane < ctas && static_cast<unsigned>(word) == windex)) - 1;
    const unsigned won_source = __shfl_sync(kFull, static_cast<unsigned>(word >> 32), won);
    cur = windex;
    cur_rec = cands + won * stride;
    cur_core = __longlong_as_double(static_cast<long long>(cur_rec[2]));
    const int local = static_cast<int>(cur) - begin;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (local == p * kClusterThreads + tid) reach[p] = in_tree;
    }
    if (rank == 0 && tid == 0) {
      e_src[s] = won_source;
      e_dst[s] = cur;
      e_dist[s] = __longlong_as_double(static_cast<long long>(wkey));
    }
  }
  cluster_barrier();  // no CTA leaves while a store into it may be in flight
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
int launch_core(const double* x, double* out, double* part, unsigned* arrivals, int n, int d,
                int slices, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kCoreRows + 2 * kCoreTile) * d * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(core_distance_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kCoreRows - 1) / kCoreRows, slices);
  core_distance_kernel<K><<<grid, kCoreThreads, smem, stream>>>(x, out, part, arrivals, n, d);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's launch configuration: one cluster of `ctas` CTAs.
// `attr` must outlive the returned config's use.
cudaLaunchConfig_t cluster_config(int ctas, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P, int kD>
cudaError_t allow_cluster(int ctas, int smem) {
  cudaError_t err = cudaFuncSetAttribute(prim_mst_cluster_kernel<P, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || ctas <= 8) return err;
  return cudaFuncSetAttribute(prim_mst_cluster_kernel<P, kD>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// how many clusters of `ctas` CTAs with `smem` bytes each the card holds at once
template <int P, int kD>
cudaError_t active_clusters(int ctas, int smem, int* active) {
  cudaError_t err = allow_cluster<P, kD>(ctas, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(active, prim_mst_cluster_kernel<P, kD>, &cfg);
}

template <int P, int kD>
int launch_cluster(const double* x, const double* core, long long* src, long long* dst,
                   double* dist, int n, int d, int ctas, int pts, int smem,
                   cudaStream_t stream) {
  cudaError_t err = allow_cluster<P, kD>(ctas, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(ctas, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, prim_mst_cluster_kernel<P, kD>, x, core, src, dst, dist, n, d,
                           pts);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the embedding width of every shipped configuration gets its own kernel
template <int P>
int launch_cluster_width(const double* x, const double* core, long long* src, long long* dst,
                         double* dist, int n, int d, int ctas, int pts, int smem,
                         cudaStream_t stream) {
  return d == 8 ? launch_cluster<P, 8>(x, core, src, dst, dist, n, d, ctas, pts, smem, stream)
                : launch_cluster<P, 0>(x, core, src, dst, dist, n, d, ctas, pts, smem, stream);
}

}  // namespace

extern "C" {

// x: [n, d] float64 row-major; out: [n] float64.  1 <= k <= min(n, 16).
// part: [slices][n][k] float64 scratch (unused at one slice); arrivals:
// ceil(n / 256) zeroed 32-bit words.  1 <= slices <= n.
int hgnn_core_distances_f64(const double* x, double* out, double* part, unsigned* arrivals,
                            int n, int d, int k, int slices, void* stream) {
  if (n < 1 || d < 1 || k < 1 || k > n || k > kMaxK || slices < 1 || slices > n ||
      slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define HGNN_CORE_CASE(K) \
  case K:                 \
    return launch_core<K>(x, out, part, arrivals, n, d, slices, s);
    HGNN_CORE_CASE(1) HGNN_CORE_CASE(2) HGNN_CORE_CASE(3) HGNN_CORE_CASE(4)
    HGNN_CORE_CASE(5) HGNN_CORE_CASE(6) HGNN_CORE_CASE(7) HGNN_CORE_CASE(8)
    HGNN_CORE_CASE(9) HGNN_CORE_CASE(10) HGNN_CORE_CASE(11) HGNN_CORE_CASE(12)
    HGNN_CORE_CASE(13) HGNN_CORE_CASE(14) HGNN_CORE_CASE(15) HGNN_CORE_CASE(16)
#undef HGNN_CORE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The cluster route's size: 16 CTAs where the card schedules a cluster of 16
// with `smem` bytes of shared memory a CTA, else 8.  info[0] the size taken,
// info[1] and info[2] the clusters of 16 and of 8 the card holds at once.
// Returns the query's error, or cudaErrorInvalidConfiguration where neither
// size fits.
int hgnn_prim_mst_cluster_size(int smem, int* info) {
  int wide = 0, narrow = 0;
  cudaError_t err = active_clusters<kMaxPerThread, 0>(16, smem, &wide);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = active_clusters<kMaxPerThread, 0>(8, smem, &narrow);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = wide >= 1 ? 16 : (narrow >= 1 ? 8 : 0);
  info[1] = wide;
  info[2] = narrow;
  return info[0] ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// x: [n, d] float64; core: [n] float64 (>= 0); src/dst: [n - 1] int64, dist:
// [n - 1] float64, written in Prim's order.  One cluster of `ctas` CTAs of
// `pts` points each (ctas * pts >= n, pts <= 1024 per_thread), `smem` bytes
// of shared memory a CTA (the wrapper's mst_cluster_schedule).
int hgnn_prim_mst_cluster_f64(const double* x, const double* core, long long* src,
                              long long* dst, double* dist, int n, int d, int ctas, int pts,
                              int per_thread, int smem, void* stream) {
  if (n < 1 || d < 1 || ctas < 1 || ctas > 16 || pts < 1 ||
      static_cast<long long>(ctas) * pts < n ||
      static_cast<long long>(per_thread) * kClusterThreads < pts || smem < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (per_thread) {
    case 1:
      return launch_cluster_width<1>(x, core, src, dst, dist, n, d, ctas, pts, smem, s);
    case 2:
      return launch_cluster_width<2>(x, core, src, dst, dist, n, d, ctas, pts, smem, s);
    case 3:
      return launch_cluster_width<3>(x, core, src, dst, dist, n, d, ctas, pts, smem, s);
    case 4:
      return launch_cluster_width<4>(x, core, src, dst, dist, n, d, ctas, pts, smem, s);
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
