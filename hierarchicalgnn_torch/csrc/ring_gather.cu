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
// chunks than the card holds blocks -- or of kMinChunk where a call's
// launches span several cards: over NVLink the copy ran faster the smaller
// its chunks, over HBM not (the caller's plan says which); all (rank, chunk) pairs of the call are
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
// is the caller's business.  A call makes one launch per card (or per stream
// of a card), each serving that card's contiguous ranks, on the card's
// stream: a launch reads only its own ranks' inputs and stores into every
// rank's output and flags, over NVLink where the rank lies on another card
// (hgnn_enable_peer_access maps them).  The bulk stores reach a peer's memory
// through its peer-mapped address as they reach the card's own (checked
// exact over four H100s joined by NVLink).
//
// The host side of a call is one C call, whatever the number of launches.
// A layout (hgnn_k8_layout: each launch's card, stream and rank range, the
// ranks' flag words and the error word) is made once and kept by the
// caller with its flags; it holds a ring of kEventSlots events per launch.
// The cut of a call (the plan: the vector width, each launch's grid and
// chunk, each rank's head and bulk) depends only on the layout, the block's
// bytes, what each card holds and the pointers' places against 16 bytes, so
// the caller plans it once per such key (ring_gather.gather_schedule, the
// grids capped at what each card holds over the launches that share it) and
// passes it with every call; the arrival target (the running total of every
// launch's blocks) follows from it.  hgnn_ring_all_gather checks the plan
// against the pointers, then issues every launch in one loop -- switching to
// its card, launching, recording the launch's event in the slot of the
// call's generation -- and gives the caller's device back.  Launches issued
// so close together enter close together, which keeps the entry wait short
// (issued one by one, from Python, a card's grid spins for as long as the
// host takes to reach the last launch).
// hgnn_k8_ended reads a call's events: a slot reused by a later call on the
// same layout reports that call, which the same streams order after it, so
// the answer errs only towards "not yet".
//
// The launches stay cooperative.  All blocks of a grid must be resident at
// once (block 0 waits for every block's arrival, every block for the peers'
// entry), and several layouts may run on one card at once (groups on
// separate streams, the split launches of one call): a plain launch could
// leave two grids each partly resident and each waiting for the other's SMs.
// The runtime starts a cooperative grid only whole, and each grid is capped
// at its share of the card, so every launch of a call fits beside the others.
// Block 0 of each launch adds the nanoseconds it spun at the entry and the
// nanoseconds it ran to word kSpinAt and kLaunchAt of its first rank's flags
// (for measurement; two timer reads and two adds a launch).
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
//   * a wait on a flag that does not end gives up after `timeout_ns`
//     nanoseconds of %globaltimer: the waiting thread stores an error code
//     into the caller's error word (host memory mapped for the device: 1 a
//     peer never entered, 2 a peer's bytes never arrived) and its block
//     returns, without trapping, so the context stays usable and the caller
//     raises; a block that gave up at the entry first lets its loads land.
//     A bulk load that never lands still traps after kSpinLimit polls.
//
// Bound: memory.  P * block_bytes read, P * P * block_bytes written.
//
// Interface to the host: plain C, loaded with ctypes.  The entries allocate
// no device memory and return a cudaError_t (0 for success).

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
constexpr int kSpinAt = 1;       // flags[kSpinAt] of a launch's first rank: ns spun at the entry
constexpr int kLaunchAt = 2;     // flags[kLaunchAt]: ns from block 0's start to its end
constexpr int kEventSlots = 16;  // events per launch of a layout, one per call in flight
constexpr int kDevices = 64;     // cards a process may use
constexpr unsigned long long kSpinLimit = 1ull << 25;
constexpr unsigned long long kEntryTimedOut = 1, kArrivalTimedOut = 2;  // error codes

struct PeerTable {
  const unsigned char* in[kMaxRanks];
  unsigned char* out[kMaxRanks];
  unsigned long long* flags[kMaxRanks];  // word 0: arrivals
  long long head[kMaxRanks];             // bytes before the bulk span
  long long bulk[kMaxRanks];             // bytes of the bulk span (a multiple of 16)
  int chunk_start[kMaxRanks + 1];        // first (rank, chunk) pair of each rank
  int chunk;                             // bytes per chunk of this call
  int rank0, n_local;                    // the ranks this launch serves
  unsigned long long* error;             // the caller's error word
  unsigned long long timeout_ns;         // the bound of every wait on a flag
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// true once *flag >= target; false (with `code` in the error word) when that
// takes longer than the table's timeout
__device__ __forceinline__ bool wait_for(const PeerTable& t, const unsigned long long* flag,
                                         unsigned long long target, unsigned long long code) {
  unsigned long long polls = 0, deadline = 0;
  while (ld_acquire_sys(flag) < target) {
    if (++polls == 64) deadline = global_ns() + t.timeout_ns;
    if (polls > 64) {
      if (global_ns() > deadline) {
        st_release_sys(t.error, code);
        return false;
      }
      __nanosleep(128);
    }
  }
  return true;
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
  __shared__ int timed_out;
  const int tid = threadIdx.x;
  const bool timer = blockIdx.x == 0 && tid == 0;
  const unsigned long long started = timer ? global_ns() : 0;
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
    timed_out = 0;
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < kAhead && j < n_mine; ++j) issue(j);
  }
  __syncthreads();

  // entry: thread (i, q) looks after rank rank0 + i and its peer q
  if (tid < t.n_local * n_ranks) {
    const int r = t.rank0 + tid / n_ranks, q = tid % n_ranks;
    if (q != r) {
      if (blockIdx.x == 0) st_release_sys(t.flags[q] + kEnteredAt + r, generation);
      if (!wait_for(t, t.flags[r] + kEnteredAt + q, generation, kEntryTimedOut)) timed_out = 1;
    }
  }
  __syncthreads();
  if (timed_out) {
    // a peer never entered: store nothing, arrive nowhere; the loads in
    // flight land in this block's shared memory before it may leave
    if (tid == 0) {
      for (int j = 0; j < kAhead && j < n_mine; ++j) mbar_wait(&full[j], 0);
    }
    return;
  }
  if (timer) atomicAdd(t.flags[t.rank0] + kSpinAt, global_ns() - started);

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
  if (blockIdx.x == 0 && tid < t.n_local) {
    wait_for(t, t.flags[t.rank0 + tid], arrivals_target, kArrivalTimedOut);
  }
  if (blockIdx.x == 0) {
    __syncthreads();
    if (timer) atomicAdd(t.flags[t.rank0] + kLaunchAt, global_ns() - started);
  }
}

// the kernel's instantiations, by the log2 of their vector's bytes
const void* const kKernels[] = {
    reinterpret_cast<const void*>(&all_gather_kernel<uint8_t>),
    reinterpret_cast<const void*>(&all_gather_kernel<uint16_t>),
    reinterpret_cast<const void*>(&all_gather_kernel<uint32_t>),
    reinterpret_cast<const void*>(&all_gather_kernel<uint2>),
    reinterpret_cast<const void*>(&all_gather_kernel<uint4>)};

int kernel_of(long long vector) {
  for (int k = 0; k < 5; ++k) {
    if (vector == (1ll << k)) return k;
  }
  return -1;
}

// blocks of the kernel (every instantiation) that a card holds at once, 0
// until asked; asking also lets the kernel take the ring's shared memory
int g_held[kDevices];

cudaError_t prepare(int device) {
  if (g_held[device]) return cudaSuccess;
  int sms = 0, least = 1 << 30;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int k = 0; k < 5 && err == cudaSuccess; ++k) {
    int per_sm = 0;
    err = cudaFuncSetAttribute(kKernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernels[k], kThreads,
                                                          kSmemBytes);
    }
    if (per_sm < least) least = per_sm;
  }
  if (err == cudaSuccess) g_held[device] = least * sms;
  return err;
}

// One layout of launches, made once: each launch's card, stream and ranks,
// the ranks' flag words, the error word, and a ring of events per launch.
struct Layout {
  int n_launches, n_ranks;
  int device[kMaxRanks], rank0[kMaxRanks], n_local[kMaxRanks];
  cudaStream_t stream[kMaxRanks];
  cudaEvent_t ended[kMaxRanks][kEventSlots];
  unsigned long long* flags[kMaxRanks];
  unsigned long long* error;
};

void destroy(Layout* layout) {
  for (int i = 0; i < layout->n_launches; ++i) {
    if (cudaSetDevice(layout->device[i]) != cudaSuccess) continue;
    for (int s = 0; s < kEventSlots; ++s) {
      if (layout->ended[i][s]) cudaEventDestroy(layout->ended[i][s]);
    }
  }
  delete layout;
}

}  // namespace

extern "C" {

// Makes the layout of n_launches launches: launch i runs on card devices[i]
// and stream streams[i] and serves ranks [rank0s[i], rank0s[i] + n_locals[i])
// of n_ranks, in rank order, each rank on one launch.  flags: n_ranks device
// pointers to each rank's flag words (peer-mapped where another card holds
// them); error: device-visible host memory that a wait past its bound sets.
// held[i] <- blocks of the kernel that launch i's card holds at once;
// *handle <- the layout (hgnn_k8_layout_free releases it).
int hgnn_k8_layout(int n_launches, const int* devices, void* const* streams,
                   const int* rank0s, const int* n_locals, int n_ranks, void* const* flags,
                   void* error, int* held, void** handle) {
  *handle = nullptr;
  if (n_ranks < 1 || n_ranks > kMaxRanks || n_launches < 1 || n_launches > n_ranks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int next = 0;
  for (int i = 0; i < n_launches; ++i) {
    if (devices[i] < 0 || devices[i] >= kDevices || rank0s[i] != next || n_locals[i] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next += n_locals[i];
  }
  if (next != n_ranks) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layout* layout = new Layout();
  layout->n_launches = n_launches;
  layout->n_ranks = n_ranks;
  layout->error = static_cast<unsigned long long*>(error);
  for (int r = 0; r < n_ranks; ++r) {
    layout->flags[r] = static_cast<unsigned long long*>(flags[r]);
  }
  for (int i = 0; i < n_launches && err == cudaSuccess; ++i) {
    layout->device[i] = devices[i];
    layout->stream[i] = static_cast<cudaStream_t>(streams[i]);
    layout->rank0[i] = rank0s[i];
    layout->n_local[i] = n_locals[i];
    err = cudaSetDevice(devices[i]);
    if (err == cudaSuccess) err = prepare(devices[i]);
    held[i] = g_held[devices[i]];
    for (int s = 0; s < kEventSlots && err == cudaSuccess; ++s) {
      err = cudaEventCreateWithFlags(&layout->ended[i][s], cudaEventDisableTiming);
    }
  }
  if (err != cudaSuccess) {
    destroy(layout);
  } else {
    *handle = layout;
  }
  cudaSetDevice(current);
  return static_cast<int>(err);
}

int hgnn_k8_layout_free(void* handle) {
  if (handle == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  destroy(static_cast<Layout*>(handle));
  if (err == cudaSuccess) err = cudaSetDevice(current);
  return static_cast<int>(err);
}

// One call of K8 on `handle`'s layout: every launch, in one loop.  plan
// (int64): [0] bytes per vector of the vector loop, [1 + 2i] launch i's grid,
// [2 + 2i] its chunk bytes, then for every rank r, at 1 + 2 n_launches + 2r,
// its head and its bulk bytes.  in/out: n_ranks device pointers each (an
// output on another card: peer-mapped).  generation: this call's number on
// the layout's flags (1, 2, ...); target: what word 0 of every rank's flags
// holds once this call's launches have all arrived (the earlier calls'
// blocks and this call's); timeout_ns: the bound of every wait on a flag.
// issued[0] <- the launches issued (on an error, those before the failed
// one: they wait for it until their bound).
int hgnn_ring_all_gather(void* handle, const long long* plan, const void* const* in,
                         void* const* out, long long block_bytes,
                         unsigned long long generation, unsigned long long target,
                         unsigned long long timeout_ns, int* issued) {
  issued[0] = 0;
  const Layout* layout = static_cast<const Layout*>(handle);
  if (layout == nullptr || block_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ranks = layout->n_ranks, n_launches = layout->n_launches;
  const int kind = kernel_of(plan[0]);
  if (kind < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t vector = static_cast<uintptr_t>(plan[0]);
  PeerTable t = {};
  t.error = layout->error;
  t.timeout_ns = timeout_ns;
  uintptr_t bits = static_cast<uintptr_t>(block_bytes);
  for (int r = 0; r < n_ranks; ++r) {
    t.in[r] = static_cast<const unsigned char*>(in[r]);
    t.out[r] = static_cast<unsigned char*>(out[r]);
    t.flags[r] = layout->flags[r];
    bits |= reinterpret_cast<uintptr_t>(in[r]) | reinterpret_cast<uintptr_t>(out[r]);
  }
  // the plan must fit these pointers (a plan of another key would make a
  // bulk copy misaligned, and the context unusable): checked before anything
  // is issued
  if (bits % vector) return static_cast<int>(cudaErrorInvalidValue);
  const long long* cut = plan + 1 + 2 * n_launches;
  for (int r = 0; r < n_ranks; ++r) {
    const long long head = cut[2 * r], bulk = cut[2 * r + 1];
    if (head < 0 || bulk < 0 || bulk % 16 || head + bulk > block_bytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (bulk > 0) {
      bool aligned = (reinterpret_cast<uintptr_t>(in[r]) + head) % 16 == 0;
      for (int q = 0; q < n_ranks; ++q) {
        aligned = aligned && (reinterpret_cast<uintptr_t>(out[q]) +
                              static_cast<uintptr_t>(r * block_bytes + head)) % 16 == 0;
      }
      if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    }
    t.head[r] = head;
    t.bulk[r] = bulk;
  }
  for (int i = 0; i < n_launches; ++i) {
    const long long grid = plan[1 + 2 * i], chunk = plan[2 + 2 * i];
    if (grid < 1 || grid > g_held[layout->device[i]] || chunk < kMinChunk || chunk > kChunk ||
        chunk % 16) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = current;
  const int slot = static_cast<int>(generation % kEventSlots);
  for (int i = 0; i < n_launches && err == cudaSuccess; ++i) {
    t.rank0 = layout->rank0[i];
    t.n_local = layout->n_local[i];
    t.chunk = static_cast<int>(plan[2 + 2 * i]);
    for (int j = 0; j < t.n_local; ++j) {
      t.chunk_start[j + 1] = t.chunk_start[j] +
                             static_cast<int>((t.bulk[t.rank0 + j] + t.chunk - 1) / t.chunk);
    }
    if (layout->device[i] != device) {
      err = cudaSetDevice(layout->device[i]);
      if (err != cudaSuccess) break;
      device = layout->device[i];
    }
    int ranks = n_ranks;
    long long bytes = block_bytes;
    void* args[] = {&t, &ranks, &bytes, &generation, &target};
    // the ring at this launch's chunk size (the occupancy is the whole ring's)
    err = cudaLaunchCooperativeKernel(kKernels[kind], dim3(static_cast<unsigned>(plan[1 + 2 * i])),
                                      dim3(kThreads), args,
                                      static_cast<size_t>(kStages) * t.chunk, layout->stream[i]);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) break;
    issued[0] = i + 1;
    err = cudaEventRecord(layout->ended[i][slot], layout->stream[i]);
  }
  if (device != current) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Whether the first n_launches launches of call `generation` on the layout
// have ended: 0 if they have, cudaErrorNotReady if one has not (with `wait`,
// waits for them instead), another cudaError_t if a query failed.  While the
// error word is clear one event answers for all: a launch ends only once its
// ranks' arrival words reach the call's target, and every block of every
// launch adds to every rank's word after its last store, so no launch of the
// call touches an input or an output after the first has ended.
int hgnn_k8_ended(void* handle, unsigned long long generation, int n_launches, int wait) {
  const Layout* layout = static_cast<const Layout*>(handle);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slot = static_cast<int>(generation % kEventSlots);
  if (!wait && n_launches == layout->n_launches) {
    err = cudaSetDevice(layout->device[0]);
    if (err == cudaSuccess) err = cudaEventQuery(layout->ended[0][slot]);
    if (err == cudaSuccess && *static_cast<volatile unsigned long long*>(layout->error) == 0) {
      return static_cast<int>(cudaSetDevice(current));
    }
    if (err != cudaSuccess) {
      cudaSetDevice(current);
      return static_cast<int>(err);
    }
  }
  for (int i = 0; i < n_launches && i < layout->n_launches && err == cudaSuccess; ++i) {
    err = cudaSetDevice(layout->device[i]);
    if (err == cudaSuccess) {
      err = wait ? cudaEventSynchronize(layout->ended[i][slot])
                 : cudaEventQuery(layout->ended[i][slot]);
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  if (err == cudaSuccess) err = back;
  return static_cast<int>(err);
}

// Lets `device` (the current one) reach `peer`'s memory: 0 if it can now
// (also when it could already), cudaErrorPeerAccessUnsupported if the pair
// cannot reach each other.
int hgnn_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int current = -1;
  err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: not an error here
    return 0;
  }
  return static_cast<int>(err);
}

}  // extern "C"
