// A chained scan across the blocks of one launch (decoupled look-back), shared
// by the tile set-up (csrc/tile_setup.cu, B4 · T) and the LET export walk
// (csrc/let_export.cu, B7).
//
// Each block takes its index from an atomic ticket (take_ticket), so a block
// only ever waits on blocks that are already running. For each channel of
// its scan it publishes its own aggregate as soon as it has it, then looks
// back: one warp (chain) or the whole block (block_chain) reads the status
// words of the 32 (or blockDim) blocks before it at once, combines the
// aggregates down to the nearest block that has published its inclusive
// prefix, and repeats on the ones before those if none has. The block then
// publishes its inclusive prefix. A status word packs a flag (0 none,
// 1 aggregate, 2 inclusive) above the 32-bit value, so one 64-bit store
// publishes both. The words and the ticket must be zero before the launch;
// the values are int32 and the operator is commutative (max or sum), so the
// result does not depend on the order in which blocks finish.
//
// A wait that outlasts kPatience SM cycles traps instead of hanging the card.
// A trap is a sticky error: it poisons the process's whole CUDA context, so
// every later CUDA call of the process fails, not just this launch. Waits
// are normally microseconds; one that runs long on a card shared in time
// slices or under a sanitizer can be given more room, or none, by building
// with -DCHAINED_SCAN_PATIENCE=<cycles> (0: wait without a limit).
#pragma once

#ifndef CHAINED_SCAN_PATIENCE
#define CHAINED_SCAN_PATIENCE 20000000000LL  // ~10 s at the H100's 1.98 GHz
#endif

namespace chained {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr long long kPatience = CHAINED_SCAN_PATIENCE;  // SM cycles one status word may take

struct Max {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Sum {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

// The block's index in launch order; every thread of the block gets it.
__device__ __forceinline__ int take_ticket(int* ticket) {
  __shared__ int b;
  if (threadIdx.x == 0) b = atomicAdd(ticket, 1);
  __syncthreads();
  const int out = b;
  __syncthreads();
  return out;
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long flag,
                                        int value) {
  *reinterpret_cast<volatile unsigned long long*>(word) = flag | static_cast<unsigned>(value);
}

// The status word of block k >= 0 once it holds a flag; before block 0, an
// inclusive identity.
__device__ __forceinline__ unsigned long long wait_word(const unsigned long long* status, int k,
                                                        int stride, int identity) {
  unsigned long long w = kInclusive | static_cast<unsigned>(identity);
  if (k >= 0) {
    const volatile unsigned long long* p = status + static_cast<long long>(k) * stride;
    const long long t0 = clock64();
    while (((w = *p) >> 32) == 0) {
      // a block it waits on is running (tickets), so this never lasts; a
      // status word that was not zeroed would: trap (see above), do not hang
      if (kPatience > 0 && clock64() - t0 > kPatience) __trap();
    }
  }
  return w;
}

// Called by all 32 lanes of one warp of block `block` (> 0): the exclusive
// prefix of the blocks before it on one channel, whose status words sit at
// status[k * stride] for block k. Every lane returns it. (Four words a lane
// per step, 128 blocks, measured slower on an H100: PERF.md.)
template <class Op>
__device__ int look_back(const unsigned long long* status, int block, int stride, Op op,
                         int identity) {
  const int lane = threadIdx.x & 31;
  int acc = identity;
  for (int end = block - 1;; end -= 32) {
    const unsigned long long w = wait_word(status, end - lane, stride, identity);
    const unsigned incl = __ballot_sync(kFull, (w >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;  // the nearest inclusive prefix
    int v = lane <= stop ? static_cast<int>(static_cast<unsigned>(w)) : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
    acc = op(acc, v);
    if (incl) return acc;
  }
}

// Called by all 32 lanes of one warp: publishes the block's aggregate `agg`
// on one channel (status word at status[block * stride]), looks back, and
// publishes the inclusive prefix. Returns the exclusive prefix (identity
// for block 0).
template <class Op>
__device__ int chain(unsigned long long* status, int block, int stride, int agg, Op op,
                     int identity) {
  unsigned long long* mine = status + static_cast<long long>(block) * stride;
  int carry = identity;
  if (block > 0) {
    if ((threadIdx.x & 31) == 0) publish(mine, kAggregate, agg);
    carry = look_back(status, block, stride, op, identity);
  }
  if ((threadIdx.x & 31) == 0) publish(mine, kInclusive, op(carry, agg));
  return carry;
}

// chain() for a block that scans one channel: all kThreads threads look
// back together, kThreads status words (status[k], stride 1) per step.
// `scratch` holds kThreads / 32 + 1 ints of shared memory. Every thread
// must call it; every thread returns the exclusive prefix.
template <int kThreads, class Op>
__device__ int block_chain(unsigned long long* status, int block, int agg, Op op, int identity,
                           int* scratch) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = identity;
  if (block > 0) {
    if (threadIdx.x == 0) publish(status + block, kAggregate, agg);
    for (int end = block - 1;; end -= kThreads) {
      const unsigned long long w = wait_word(status, end - static_cast<int>(threadIdx.x), 1,
                                             identity);
      // the nearest inclusive prefix: the lowest thread that holds one
      const unsigned incl = __ballot_sync(kFull, (w >> 32) == 2);
      if (lane == 0) scratch[warp] = incl ? warp * 32 + __ffs(incl) - 1 : kThreads;
      __syncthreads();
      int stop = kThreads;
      for (int i = 0; i < kWarps; ++i) stop = min(stop, scratch[i]);
      int v = static_cast<int>(threadIdx.x) <= stop ? static_cast<int>(static_cast<unsigned>(w))
                                                    : identity;
      for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
      __syncthreads();  // every thread has read the stops
      if (lane == 0) scratch[warp] = v;
      __syncthreads();
      for (int i = 0; i < kWarps; ++i) carry = op(carry, scratch[i]);
      __syncthreads();  // scratch is free again
      if (stop < kThreads) break;
    }
  }
  if (threadIdx.x == 0) publish(status + block, kInclusive, op(carry, agg));
  return carry;
}

}  // namespace chained
