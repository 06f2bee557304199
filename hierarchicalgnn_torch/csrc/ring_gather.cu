// All-gather of row blocks between ranks, for Hopper (sm_90a).
//
//   K8 all_gather  <- _ring_kernel
//                     (hierarchicalgnn_tpu/ops/pallas/ring_gather.py:32)
//        rank r holds x_r (block_bytes bytes); every rank q ends with
//        out_q = concat(x_0 ... x_{P-1})
//
// What it computes, not how the TPU computed it.  The Pallas kernel forwards
// blocks round a ring in both directions, ceil((P-1)/2) steps, through double
// buffers in VMEM: a TPU's ICI is a torus with two ports per axis, and its
// remote DMA runs from VMEM.  The cards of an H100 host are joined all to all
// by NVLink, so nothing needs forwarding: each byte of a rank's block is read
// once and stored straight into the matching place of every rank's output,
// its own included (push).  Stores were chosen over loads from the peers
// because a store over NVLink is posted and a load waits for its round trip.
//
// Design: bulk asynchronous copies through shared memory.  A rank's block is
// cut into a head (the bytes before the first 16-byte boundary), a bulk span
// of whole 16-byte units, and a tail.  The bulk span is cut into chunks of
// kChunk (32 KB) bytes, halved down to kMinChunk while the call has fewer
// chunks than the card holds blocks; all (rank, chunk) pairs of the call are
// dealt round the blocks of a persistent grid (one block a SM; block b takes
// pairs b, b + G, b + 2G, ...), so neither a large P nor a small block leaves
// SMs idle.  One thread of each block runs a ring of kStages chunk buffers in
// dynamic shared memory:
//   1. arm the stage's mbarrier with the chunk's bytes (arrive.expect_tx) and
//      start a 1-D bulk load (cp.async.bulk ... mbarrier::complete_tx) of the
//      chunk into it, kAhead chunks ahead of the stores (the first kAhead
//      before the entry wait: a load reads only the rank's own block);
//   2. wait on the stage's phase (parity flips at each reuse);
//   3. start P bulk stores (cp.async.bulk.global.shared::cta.bulk_group), one
//      into each rank's output, and commit them as one group;
//   4. before a stage is loaded again, cp.async.bulk.wait_group.read leaves at
//      most kStages - kAhead groups pending, so the stores that read it are
//      done with it.
// Each input byte crosses the SM once; the TMA unit writes it P times.  No
// CUtensorMap and no driver API: the 1-D form needs neither.
//
// Bytes a bulk copy cannot take (it needs 16-byte-aligned addresses on both
// sides and a multiple of 16 bytes): the heads and tails, and the whole block
// of a rank whose input and output are not equally placed against a 16-byte
// boundary, go through a vector loop in the same kernel (warps 1..7 of every
// block, grid-strided, with the widest of 16, 8, 4, 2, 1 bytes that divides
// the block's bytes and every pointer).  `gather_schedule` in
// ops/kernels/ring_gather.py is the same cut in Python.
//
// Interface.  The kernel sees its peers only through a table of device
// pointers -- each rank's input block, output and flag words -- and the range
// of ranks that its launch serves ([rank0, rank0 + n_local)).  Whether those
// pointers are allocations of this card or peer-mapped memory of other cards
// is the caller's business.  Today ONE launch serves all P ranks of a group
// (rank0 0, n_local P), so that no rank can wait for a rank whose launch has
// not started.  The launch is cooperative: the runtime refuses a grid that
// cannot be resident at once, and a resident grid cannot deadlock on its own
// flags.  One set of flag words serves one group on one stream: calls on it
// are ordered by the stream, and the caller keeps a set per stream.
//
// Synchronisation contract (what carries over from the TPU kernel's barrier
// semaphore and DMA semaphores):
//   * entry: a rank's output is written only after that rank has entered the
//     call.  Block 0 stores the call's generation into word kEnteredAt + r of
//     every peer's flags for each rank r it serves; every block waits for all
//     peers' words in the flags of the ranks it serves before its first store.
//   * arrival: after its stores have completed (cp.async.bulk.wait_group 0,
//     then fence.proxy.async, so the async proxy's writes are ordered before
//     the generic proxy's release) a block adds 1 to word 0 of every rank's
//     flags (release): it may have written into any of them.  Block 0 leaves
//     only when word 0 of each rank it serves has reached the target the
//     caller passed: the running total of gridDim.x arrivals per call.  The
//     launch therefore ends only when every block's bytes are in every
//     output.
//   * reuse: the flags are never reset.  The generation and the arrival
//     target only grow (64 bits), so a call cannot mistake an earlier call's
//     flags for its own, and there is no reset to race with.
//   * memory order: stores, then __syncthreads, __threadfence_system and a
//     red.release.sys on the flag; waiters poll with ld.acquire.sys.  System
//     scope is what ranks on several cards need; between ranks of one card it
//     costs nothing measurable beside the copy.
//   * a wait that does not end traps after kSpinLimit polls (some seconds),
//     so a lost peer, or a bulk load that never lands, fails the stream
//     instead of hanging it.
//
// Bound: memory.  P * block_bytes read, P * P * block_bytes written.
//
// Interface to the host: plain C, loaded with ctypes.  The entry launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;
constexpr int kVecThreads = kThreads - 32;  // warp 0 issues the bulk copies
constexpr int kVecBatch = 4;               // vectors per vector thread, for the grid size
constexpr int kChunk = 32768;              // bytes per bulk chunk, at most
constexpr int kMinChunk = 2048;            // ... and at least, where the blocks are small
constexpr int kStages = 6;                 // chunk buffers in shared memory
constexpr int kAhead = 3;                  // loads started ahead of the stores
constexpr int kSmemBytes = kChunk * kStages;
constexpr int kEnteredAt = 16;   // flags[kEnteredAt + q]: generation rank q entered
constexpr unsigned long long kSpinLimit = 1ull << 25;

struct PeerTable {
  const unsigned char* in[kMaxRanks];
  unsigned char* out[kMaxRanks];
  unsigned long long* flags[kMaxRanks];  // word 0: arrivals
  long long head[kMaxRanks];             // bytes before the bulk span
  long long bulk[kMaxRanks];             // bytes of the bulk span (a multiple of 16)
  int chunk_start[kMaxRanks + 1];        // first (rank, chunk) pair of each rank
  int chunk;                             // bytes per chunk of this call
  int rank0, n_local;                    // the ranks this launch serves
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_release_sys_add(unsigned long long* p,
                                                    unsigned long long v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void wait_for(const unsigned long long* flag,
                                         unsigned long long target) {
  unsigned long long polls = 0;
  while (ld_acquire_sys(flag) < target) {
    if (++polls > kSpinLimit) __trap();
    if (polls > 64) __nanosleep(128);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  unsigned long long polls = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (++polls > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* stage, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(stage)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* stage, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(stage)), "r"(bytes) : "memory");
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(PeerTable t, int n_ranks, long long block_bytes,
                  unsigned long long generation, unsigned long long arrivals_target) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int tid = threadIdx.x;
  const int n_pairs = t.chunk_start[t.n_local];
  const int n_mine = blockIdx.x < n_pairs ? (n_pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // the offset (within rank r's block) and bytes of this block's j-th pair
  auto pair = [&](int j, int& r, long long& off, uint32_t& bytes) {
    const int k = blockIdx.x + j * gridDim.x;
    int i = 0;
    while (t.chunk_start[i + 1] <= k) ++i;
    r = t.rank0 + i;
    const long long done = static_cast<long long>(k - t.chunk_start[i]) * t.chunk;
    off = t.head[r] + done;
    bytes = static_cast<uint32_t>(t.bulk[r] - done < t.chunk ? t.bulk[r] - done : t.chunk);
  };
  // a load reads only the rank's own block: it may start before the entry
  auto issue = [&](int j) {
    int r;
    long long off;
    uint32_t bytes;
    pair(j, r, off, bytes);
    uint64_t* bar = &full[j % kStages];
    mbar_expect_tx(bar, bytes);
    bulk_load(stage + (j % kStages) * t.chunk, t.in[r] + off, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < kAhead && j < n_mine; ++j) issue(j);
  }

  // entry: thread (i, q) looks after rank rank0 + i and its peer q
  if (tid < t.n_local * n_ranks) {
    const int r = t.rank0 + tid / n_ranks, q = tid % n_ranks;
    if (q != r) {
      if (blockIdx.x == 0) st_release_sys(t.flags[q] + kEnteredAt + r, generation);
      wait_for(t.flags[r] + kEnteredAt + q, generation);
    }
  }
  __syncthreads();

  if (tid == 0) {
    // the bulk spans: this block's (rank, chunk) pairs through the ring
    asm volatile("fence.proxy.async.global;" ::: "memory");
    for (int j = 0; j < n_mine; ++j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      int r;
      long long off;
      uint32_t bytes;
      pair(j, r, off, bytes);
      off += static_cast<long long>(r) * block_bytes;
      for (int q = 0; q < n_ranks; ++q) {
        bulk_store(t.out[q] + off, stage + (j % kStages) * t.chunk, bytes);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (j + kAhead < n_mine) {
        // stage (j + kAhead) % kStages was last read by group j + kAhead - kStages
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStages - kAhead) : "memory");
        issue(j + kAhead);
      }
    }
    // the stores complete (not only their reads of shared memory), then are
    // ordered before the generic proxy's release below
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    asm volatile("fence.proxy.async.global;" ::: "memory");
  } else if (tid >= 32) {
    // heads, tails and ranks the bulk copies cannot take, V bytes at a time
    const long long w0 = static_cast<long long>(blockIdx.x) * kVecThreads + (tid - 32);
    const long long stride = static_cast<long long>(gridDim.x) * kVecThreads;
    for (int i = 0; i < t.n_local; ++i) {
      const int r = t.rank0 + i;
      const V* src = reinterpret_cast<const V*>(t.in[r]);
      const long long spans[2][2] = {{0, t.head[r]}, {t.head[r] + t.bulk[r], block_bytes}};
      for (int s = 0; s < 2; ++s) {
        const long long hi = spans[s][1] / static_cast<long long>(sizeof(V));
        for (long long v = spans[s][0] / static_cast<long long>(sizeof(V)) + w0; v < hi;
             v += stride) {
          const V x = src[v];
          for (int q = 0; q < n_ranks; ++q) {
            reinterpret_cast<V*>(t.out[q] + static_cast<long long>(r) * block_bytes)[v] = x;
          }
        }
      }
    }
  }

  // arrival: this block's bytes are in every output
  __syncthreads();
  if (tid < n_ranks) {
    __threadfence_system();
    red_release_sys_add(t.flags[tid], 1ull);
  }
  // exit: the launch ends only when the outputs of the ranks it serves are complete
  if (blockIdx.x == 0 && tid < t.n_local) wait_for(t.flags[t.rank0 + tid], arrivals_target);
}

template <typename V>
int launch(const PeerTable& table, int n_ranks, long long block_bytes, long long vec_units,
           unsigned long long generation, unsigned long long arrivals_before, int device,
           int* info, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&all_gather_kernel<V>);
  // blocks of this kernel that one device holds at once, asked once per device
  constexpr int kDevices = 64;
  static int held[kDevices] = {};
  if (device < 0 || device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err;
  if (held[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(all_gather_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, all_gather_kernel<V>,
                                                        kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    held[device] = per_sm * sms;
  }
  if (held[device] < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // chunks of kChunk bytes, halved (down to kMinChunk) while the pairs are
  // fewer than the blocks the card holds
  PeerTable t = table;
  for (t.chunk = kChunk;; t.chunk /= 2) {
    for (int i = 0; i < t.n_local; ++i) {
      const long long bulk = t.bulk[t.rank0 + i];
      t.chunk_start[i + 1] = t.chunk_start[i] + static_cast<int>((bulk + t.chunk - 1) / t.chunk);
    }
    if (t.chunk <= kMinChunk || t.chunk_start[t.n_local] >= held[device]) break;
  }
  // one block per (rank, chunk) pair, or per kVecBatch vectors of every vector
  // thread, whichever asks more; at most what the card holds at once
  const long long n_pairs = t.chunk_start[t.n_local];
  const long long by_vec = (vec_units + static_cast<long long>(kVecThreads) * kVecBatch - 1) /
                           (static_cast<long long>(kVecThreads) * kVecBatch);
  long long want = n_pairs > by_vec ? n_pairs : by_vec;
  if (want < 1) want = 1;
  const int blocks = static_cast<int>(want < held[device] ? want : held[device]);
  unsigned long long target = arrivals_before + static_cast<unsigned long long>(blocks);
  void* args[] = {&t, &n_ranks, &block_bytes, &generation, &target};
  // the ring at this call's chunk size (the occupancy above is the whole ring's)
  const size_t smem = static_cast<size_t>(kStages) * t.chunk;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = blocks;
  info[1] = static_cast<int>(sizeof(V));
  info[2] = static_cast<int>(n_pairs);
  info[3] = held[device];
  info[4] = t.chunk;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in/out/flags: host arrays of n_ranks device pointers.  Launches all n_ranks
// ranks in one grid on `device` (the current one).  generation: this call's
// number on these flags (1, 2, ...); arrivals_before: what word 0 of every
// rank's flags holds when all earlier calls have ended.  info[0] <- blocks
// (each adds 1 arrival to every rank), info[1] <- bytes per vector of the
// vector loop, info[2] <- (rank, chunk) pairs of the bulk copies, info[3] <-
// blocks the card holds at once, info[4] <- bytes per chunk.
int hgnn_ring_all_gather(const void* const* in, void* const* out, void* const* flags,
                         int n_ranks, long long block_bytes,
                         unsigned long long generation, unsigned long long arrivals_before,
                         int device, int* info, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxRanks || block_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeerTable table = {};
  table.rank0 = 0;
  table.n_local = n_ranks;
  uintptr_t bits = static_cast<uintptr_t>(block_bytes);
  for (int r = 0; r < n_ranks; ++r) {
    table.in[r] = static_cast<const unsigned char*>(in[r]);
    table.out[r] = static_cast<unsigned char*>(out[r]);
    table.flags[r] = static_cast<unsigned long long*>(flags[r]);
    bits |= reinterpret_cast<uintptr_t>(in[r]) | reinterpret_cast<uintptr_t>(out[r]);
  }
  // the cut of each rank's block: a head up to the source's first 16-byte
  // boundary, whole 16-byte units, a tail -- if every destination sits as the
  // source does against 16 bytes; else all of it goes through the vector loop
  long long vec_bytes = 0;
  for (int r = 0; r < n_ranks; ++r) {
    const uintptr_t mis = reinterpret_cast<uintptr_t>(in[r]) % 16;
    bool same = true;
    for (int q = 0; q < n_ranks; ++q) {
      const uintptr_t dst = reinterpret_cast<uintptr_t>(out[q]) +
                            static_cast<uintptr_t>(r) * static_cast<uintptr_t>(block_bytes);
      same = same && dst % 16 == mis;
    }
    long long head = same ? static_cast<long long>((16 - mis) % 16) : block_bytes;
    if (head > block_bytes) head = block_bytes;
    table.head[r] = head;
    table.bulk[r] = (block_bytes - head) / 16 * 16;
    vec_bytes += block_bytes - table.bulk[r];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HGNN_LAUNCH(V)                                                                    \
  launch<V>(table, n_ranks, block_bytes, vec_bytes / static_cast<long long>(sizeof(V)), \
            generation, arrivals_before, device, info, s)
  if (bits % 16 == 0) return HGNN_LAUNCH(uint4);
  if (bits % 8 == 0) return HGNN_LAUNCH(uint2);
  if (bits % 4 == 0) return HGNN_LAUNCH(uint32_t);
  if (bits % 2 == 0) return HGNN_LAUNCH(uint16_t);
  return HGNN_LAUNCH(uint8_t);
#undef HGNN_LAUNCH
}

}  // extern "C"
