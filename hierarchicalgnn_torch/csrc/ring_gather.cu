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
// by NVLink, so nothing needs forwarding and nothing needs staging: each rank
// reads its own block once (16 bytes a thread) and stores every vector
// straight into the matching place of every rank's output, its own included
// (push).  Each input byte is read once and each output byte written once.
// Stores were chosen over loads from the peers because a store over NVLink is
// posted and a load waits for its round trip.
//
// Interface.  The kernel sees its peers only through a table of device
// pointers -- each rank's input block, output and flag words -- and a rank id
// (blockIdx.y).  Whether those pointers are allocations of this card or
// peer-mapped memory of other cards is the caller's business.  ONE launch
// holds all P ranks of a group (gridDim.y = P), so that no rank can wait for a
// rank whose launch has not started.  The launch is cooperative: the runtime
// refuses a grid that cannot be resident at once, and a resident grid cannot
// deadlock on its own flags.  (A rank per launch, as ranks on several cards
// need it, takes the rank id from an argument instead; that comes with the
// cards that can test it.)  One set of flag words serves one group on one
// stream: calls on it are ordered by the stream, and the caller keeps a set
// per stream.
//
// Synchronisation contract (what carries over from the TPU kernel's barrier
// semaphore and DMA semaphores):
//   * entry: a rank's output is written by a peer only after that rank has
//     entered the call.  Block 0 of rank q stores the call's generation into
//     word kEnteredAt + q of every peer's flags; every block of rank r waits
//     for all peers' words in its own (local) flags before its first store.
//   * arrival: after its stores a block adds 1 to word 0 of every peer's
//     flags (release).  Block 0 of rank q leaves only when word 0 of its own
//     flags has reached the target the caller passed: the running total of
//     (P - 1) * gridDim.x arrivals per call.  The launch of rank q therefore
//     ends only when every peer's block is in q's output.
//   * reuse: the flags are never reset.  The generation and the arrival
//     target only grow (64 bits), so a call cannot mistake an earlier call's
//     flags for its own, and there is no reset to race with.
//   * memory order: data stores, then __syncthreads, __threadfence_system and
//     a red.release.sys on the flag; waiters poll with ld.acquire.sys.
//     System scope is what ranks on several cards need; between ranks of one
//     card it costs nothing measurable beside the copy.
//   * a wait that does not end traps after kSpinLimit polls (some seconds),
//     so a lost peer fails the stream instead of hanging it.
//
// Any block size and base is taken: the launcher picks the widest of 16, 8,
// 4, 2, 1 bytes that divides the block's bytes and every pointer.
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
constexpr int kBatch = 4;        // vectors a thread keeps in flight
constexpr int kEnteredAt = 16;   // flags[kEnteredAt + q]: generation rank q entered
constexpr unsigned long long kSpinLimit = 1ull << 25;

struct PeerTable {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  unsigned long long* flags[kMaxRanks];  // word 0: arrivals
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

template <typename V>
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(PeerTable t, int n_ranks, size_t n_vec,
                  unsigned long long generation, unsigned long long arrivals_target) {
  const int rank = blockIdx.y;
  const int peer = threadIdx.x;  // threads 0..P-1 each look after one peer's flag
  const bool has_peer = peer < n_ranks && peer != rank;
  unsigned long long* mine = t.flags[rank];

  // entry: this rank is in the call, its output may be written
  if (blockIdx.x == 0 && has_peer) {
    st_release_sys(t.flags[peer] + kEnteredAt + rank, generation);
  }
  if (has_peer) wait_for(mine + kEnteredAt + peer, generation);
  __syncthreads();

  // own block, read once, into row block `rank` of every rank's output
  const V* src = static_cast<const V*>(t.in[rank]);
  const size_t base = static_cast<size_t>(rank) * n_vec;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kBatch - 1) * stride < n_vec; i += kBatch * stride) {
    V v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = src[i + b * stride];
    for (int q = 0; q < n_ranks; ++q) {
      V* dst = static_cast<V*>(t.out[q]) + base;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) dst[i + b * stride] = v[b];
    }
  }
  for (; i < n_vec; i += stride) {
    const V v = src[i];
    for (int q = 0; q < n_ranks; ++q) (static_cast<V*>(t.out[q]) + base)[i] = v;
  }

  // arrival: this block's share of the rank's block is in every output
  __syncthreads();
  if (has_peer) {
    __threadfence_system();
    red_release_sys_add(t.flags[peer], 1ull);
  }
  // exit: the rank's launch ends only when its own output is complete
  if (blockIdx.x == 0 && threadIdx.x == 0 && n_ranks > 1) wait_for(mine, arrivals_target);
}

template <typename V>
int launch(const PeerTable& table, int n_ranks, size_t block_bytes, unsigned long long generation,
           unsigned long long arrivals_before, int* info, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&all_gather_kernel<V>);
  // blocks of this kernel that one device holds at once, asked once per device
  constexpr int kDevices = 64;
  static int held[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (held[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, all_gather_kernel<V>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    held[device] = per_sm * sms;
  }
  // every block of every rank resident at once
  const int resident = held[device] / n_ranks;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  size_t n_vec = block_bytes / sizeof(V);
  size_t want = (n_vec + static_cast<size_t>(kThreads) * kBatch - 1) /
                (static_cast<size_t>(kThreads) * kBatch);
  int blocks = static_cast<int>(want < 1 ? 1 : (want > static_cast<size_t>(resident)
                                                    ? static_cast<size_t>(resident) : want));
  unsigned long long target =
      arrivals_before + static_cast<unsigned long long>(n_ranks - 1) * blocks;
  PeerTable t = table;
  void* args[] = {&t, &n_ranks, &n_vec, &generation, &target};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks, n_ranks), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = blocks;
  info[1] = static_cast<int>(sizeof(V));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in/out/flags: host arrays of n_ranks device pointers.  Launches all n_ranks
// ranks in one grid.  generation: this call's number
// on these flags (1, 2, ...); arrivals_before: what word 0 of every rank's flags
// holds when all earlier calls have ended.  info[0] <- blocks per rank (each
// adds 1 arrival to every peer), info[1] <- bytes per load.
int hgnn_ring_all_gather(const void* const* in, void* const* out, void* const* flags,
                         int n_ranks, long long block_bytes,
                         unsigned long long generation, unsigned long long arrivals_before,
                         int* info, void* stream) {
  if (n_ranks < 1 || n_ranks > kMaxRanks || block_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PeerTable table = {};
  uintptr_t bits = static_cast<uintptr_t>(block_bytes);
  for (int r = 0; r < n_ranks; ++r) {
    table.in[r] = in[r];
    table.out[r] = out[r];
    table.flags[r] = static_cast<unsigned long long*>(flags[r]);
    bits |= reinterpret_cast<uintptr_t>(in[r]) | reinterpret_cast<uintptr_t>(out[r]);
  }
  const size_t bytes = static_cast<size_t>(block_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HGNN_LAUNCH(V) \
  launch<V>(table, n_ranks, bytes, generation, arrivals_before, info, s)
  if (bits % 16 == 0) return HGNN_LAUNCH(uint4);
  if (bits % 8 == 0) return HGNN_LAUNCH(uint2);
  if (bits % 4 == 0) return HGNN_LAUNCH(uint32_t);
  if (bits % 2 == 0) return HGNN_LAUNCH(uint16_t);
  return HGNN_LAUNCH(uint8_t);
#undef HGNN_LAUNCH
}

}  // extern "C"
