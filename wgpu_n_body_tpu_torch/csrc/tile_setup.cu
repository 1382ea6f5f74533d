// The group walk's tile set-up (B4 · T) for Hopper (sm_90a).
//
// Replaces wgpu_n_body_tpu/ops/tree_walk_group.py:184 _tile_assignment and
// group_tree_forces:287-301 (the pieces, slots and spills), which the port ran
// on the card as ~60 torch launches (ops/tree_walk_group.py::tile_setup, the
// plain version this is held against: every integer equal). From the sorted
// receivers' split levels s (one byte each, written by the build kernels) it
// makes the tiles of at most g = walk_tile receivers:
//
//   lstar[i]  the depth of receiver i's tile cell: the max over the windows
//             [a, a + g) that cover i of min(s[a+1 .. a+g-1]) - 1, clamped to
//             [0, depth] (a window inside one cell shares the key prefix down
//             to that level);
//   groups    start where i = 0, lstar changes, or s[i] <= lstar[i];
//   tiles     break at each group start and every g receivers after it:
//             tile_id = (breaks up to i) - 1, slot = (i - group start) % g;
//   budget    tiles past t_cap merge into tile t_cap - 1 and are deferred.
//
// (a) tile_scan_kernel, one block per 2048 receivers, blocks in ticket order:
//     the block's split levels with a halo of g on each side go to shared
//     memory, four to a 32-bit word, and both sliding windows (a min of
//     width g - 1, then a max of width g) run there by doubling, ~2 log2(g)
//     passes over 3 KB with the per-byte SIMD min and max (__vminu4,
//     __vmaxu4) and __byte_perm for the shifts, never through device memory.
//     Two scans across blocks depend on each other: the last group start up
//     to i (a max) and the breaks up to i (a sum, whose terms need the
//     first). Both are chained scans with decoupled look-back
//     (chained_scan.cuh, the whole block looking back): a block's breaks
//     before its first group start follow arithmetically from the carried
//     group start, so its aggregate is known once the first scan's
//     look-back returns. Groups are not bounded by a block (an overfull
//     max-depth cell is one group of any length). Each warp takes 256
//     consecutive receivers, lane l the ones at l mod 32, so that the scans
//     run in warp shuffles and the stores of tile_id, slot and deferred are
//     coalesced; a break writes piece_start of its tile inside the budget.
// (b) tile_finish_kernel, a small grid over the t_cap tiles: piece_len from
//     consecutive starts, start n and length 0 for unused tiles, and the
//     slots of spilled receivers (i - the merged tile's start).
//
// What bounds it on H100: bytes. It reads n split levels and writes an int64
// tile id (an index: torch's gathers take int64 without a copy), an int32
// slot and a bool per receiver and two int32 per tile: 14n + 8 t_cap bytes,
// 56.2 MB at N=4M (0.017 ms at 3.35 TB/s). Its arithmetic is a few dozen
// shared memory operations per receiver. Every launch goes on the caller's
// stream after one memset of the scan's status words; nothing is read back.

#include <cuda_runtime.h>

#include <algorithm>

#include "chained_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                       // receivers per lane
constexpr int kItems = kThreads * kPer;       // receivers per block, 32 * kPer per warp
constexpr int kMaxTile = 512;                 // walk_tile on CUDA
constexpr int kWords = (kItems + 2 * kMaxTile) / 4 + 4;  // split levels + halo, 4 a word
constexpr int kHeader = 2;                    // status words before the scans': ticket, info

struct MinU4 {
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return __vminu4(a, b);
  }
};
struct MaxU4 {
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return __vmaxu4(a, b);
  }
};

// The four bytes [4 w + sh, 4 w + sh + 4) of the byte array packed in x.
__device__ __forceinline__ unsigned bytes_at(const unsigned* x, int w, int sh) {
  const int q = w + (sh >> 2);
  return __byte_perm(x[q], x[q + 1], 0x3210 + 0x1111 * (sh & 3));
}

__device__ __forceinline__ int byte_of(const unsigned* x, int k) {
  return (x[k >> 2] >> (8 * (k & 3))) & 0xff;
}

// Sliding window by doubling over the bytes x[0, len) packed four to a word
// in buf[src] (a byte op on four at once): afterwards the bytes of
// buf[result] are op(x[k .. k + w - 1]) for k in [0, len - w], w >= 1.
// Returns the buffer that holds it; the other one is free.
template <class Op>
__device__ int window(unsigned (*buf)[kWords], int src, int len, int w, Op op) {
  int span = 1;  // byte k of buf[src] is op over x[k .. k + span - 1]
  for (; 2 * span <= w; span <<= 1) {
    for (int i = threadIdx.x; 4 * i < len - span; i += kThreads)
      buf[src ^ 1][i] = op(buf[src][i], bytes_at(buf[src], i, span));
    __syncthreads();
    src ^= 1;
  }
  const int shift = w - span;
  for (int i = threadIdx.x; 4 * i <= len - w; i += kThreads)
    buf[src ^ 1][i] = op(buf[src][i], bytes_at(buf[src], i, shift));
  __syncthreads();
  return src ^ 1;
}

// The block's exclusive prefix for each warp of one scan whose warps'
// aggregates are `agg` (lane 31's), chained across blocks on `status`.
template <class Op>
__device__ int warp_prefix(int agg, unsigned long long* status, int block, Op op, int identity,
                           int* per_warp, int* scratch) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 31) per_warp[warp] = agg;
  __syncthreads();
  int before = identity, total = identity;
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) before = op(before, per_warp[k]);
    total = op(total, per_warp[k]);
  }
  const int carry = chained::block_chain<kThreads>(status, block, total, op, identity, scratch);
  __syncthreads();  // per_warp is free again
  return op(carry, before);
}

__global__ void __launch_bounds__(kThreads) tile_scan_kernel(
    const unsigned char* __restrict__ split, int n, int depth, int g, int t_cap,
    unsigned long long* __restrict__ words, int blocks, long long* __restrict__ tile_id,
    int* __restrict__ slot, bool* __restrict__ deferred, int* __restrict__ piece_start) {
  __shared__ unsigned buf[2][kWords];
  __shared__ unsigned lstar[kItems / 4 + 2];  // bytes: receivers base - 1 .. base + kItems - 1
  __shared__ int per_warp[kWarps];
  __shared__ int scratch[kWarps + 1];
  int* const ticket = reinterpret_cast<int*>(words);
  int* const info = reinterpret_cast<int*>(words + 1);  // tiles in all, first spilled receiver
  unsigned long long* const status = words + kHeader;   // [2][blocks]
  const int b = chained::take_ticket(ticket);
  const int base = b * kItems;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // lane's receivers: base + r for r = warp * 32 * kPer + e * 32 + lane
  const int r0 = warp * 32 * kPer + lane;

  // split levels s[base - g .. base + kItems + g), four to a word
  for (int i = t; i < kWords; i += kThreads) {
    unsigned v = 0;
    for (int c = 0; c < 4; ++c) {
      const int j = base - g + 4 * i + c;
      if (j >= 0 && j < n) v |= static_cast<unsigned>(split[j]) << (8 * c);
    }
    buf[0][i] = v;
  }
  __syncthreads();
  int s[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) s[e] = byte_of(buf[0], g + r0 + e * 32);

  if (g == 1 || n < g) {  // every cell holds g receivers / none does
    const unsigned v = (g == 1 ? depth : 0) * 0x01010101u;
    for (int i = t; i < kItems / 4 + 2; i += kThreads) lstar[i] = v;
  } else {
    // 1 + the shared depth of the windows starting at a = base - g + u, u in
    // [0, kItems + g): min(s[a+1 .. a+g-1]) where the window lies in [0, n),
    // else 0
    const int r = window(buf, 0, kItems + 2 * g, g - 1, MinU4());
    const int lo = g - base, hi = n - base;  // the u whose window lies in [0, n)
    for (int i = t; 4 * i < kItems + g; i += kThreads) {
      unsigned keep = 0;
      for (int c = 0; c < 4; ++c)
        if (4 * i + c >= lo && 4 * i + c <= hi) keep |= 0xffu << (8 * c);
      buf[r ^ 1][i] = bytes_at(buf[r], i, 1) & keep;
    }
    __syncthreads();
    // lstar[base - 1 + v]: the max over the windows a in [i - g + 1, i],
    // less 1, clamped to [0, depth]
    const int q = window(buf, r ^ 1, kItems + g, g, MaxU4());
    for (int i = t; i < kItems / 4 + 1; i += kThreads)
      lstar[i] = __vminu4(__vmaxu4(buf[q][i], 0x01010101u) - 0x01010101u, depth * 0x01010101u);
  }
  __syncthreads();

  // group starts; the first scan carries the last one (a max over the
  // warp's receivers in order, then across warps and blocks)
  bool start[kPer];
  int rs[kPer];
  int run = -1;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = base + r0 + e * 32, v = r0 + e * 32 + 1;
    const int ls = byte_of(lstar, v);
    start[e] = i < n && (i == 0 || ls != byte_of(lstar, v - 1) || s[e] <= ls);
    int x = start[e] ? i : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(chained::kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    rs[e] = run = max(run, x);
    run = __shfl_sync(chained::kFull, run, 31);
  }
  const int rs_in = warp_prefix(run, status, b, chained::Max(), -1, per_warp, scratch);

  // breaks; the second scan counts them
  const int mask = (g & (g - 1)) == 0 ? g - 1 : -1;  // x % g as x & mask for a power of 2
  auto mod_g = [&](int x) { return mask >= 0 ? x & mask : x % g; };
  bool brk[kPer];
  int tiles[kPer];
  run = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = base + r0 + e * 32;
    rs[e] = max(rs[e], rs_in);  // the last group start up to i
    brk[e] = i < n && (start[e] || mod_g(i - rs[e]) == 0);
    int x = brk[e];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(chained::kFull, x, o);
      if (lane >= o) x += y;
    }
    tiles[e] = run + x;
    run = __shfl_sync(chained::kFull, tiles[e], 31);
  }
  const int before = warp_prefix(run, status + blocks, b, chained::Sum(), 0, per_warp, scratch);

#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = base + r0 + e * 32;
    if (i >= n) break;
    const int tile = before + tiles[e] - 1;
    if (brk[e]) {
      if (tile < t_cap) piece_start[tile] = i;
      else if (tile == t_cap) info[1] = i;  // the first spilled receiver (never 0)
    }
    const bool spilled = tile >= t_cap;
    tile_id[i] = spilled ? t_cap - 1 : tile;
    slot[i] = mod_g(i - rs[e]);  // a spilled receiver's is replaced by (b)
    deferred[i] = spilled;
    if (i == n - 1) info[0] = tile + 1;
  }
}

__global__ void tile_finish_kernel(int n, int t_cap, const unsigned long long* __restrict__ words,
                                   int* __restrict__ piece_start, int* __restrict__ piece_len,
                                   int* __restrict__ slot) {
  const int* const info = reinterpret_cast<const int*>(words + 1);
  const int used = min(info[0], t_cap);
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int t = tid; t < t_cap; t += stride) {
    if (t < used) {
      piece_len[t] = (t + 1 < used ? piece_start[t + 1] : n) - piece_start[t];
    } else {
      piece_start[t] = n;
      piece_len[t] = 0;
    }
  }
  const int spill = info[1];
  if (spill > 0) {  // every tile is used: nothing above writes piece_start
    const int p0 = piece_start[t_cap - 1];
    for (int i = spill + tid; i < n; i += stride) slot[i] = i - p0;
  }
}

}  // namespace

// Bytes of scratch tile_setup_launch needs for n receivers.
extern "C" long long tile_setup_scratch_bytes(int n) {
  const long long blocks = (static_cast<long long>(n) + kItems - 1) / kItems;
  return 8 * (kHeader + 2 * blocks);
}

// The tiles of n receivers with split levels `split` (n,) uint8, on `stream`:
// tile_id (n,) int64, slot (n,) int32, deferred (n,) bool, piece_start,
// piece_len (t_cap,) int32. depth = max_depth, g = walk_tile in [1, 512], t_cap the
// tile budget. scratch: tile_setup_scratch_bytes(n) bytes, zeroed here.
// Returns the first cudaError_t (0 = success); does not synchronise.
extern "C" int tile_setup_launch(const void* split, int n, int depth, int g, int t_cap,
                                 void* scratch, void* tile_id, void* slot, void* deferred,
                                 void* piece_start, void* piece_len, int device, void* stream) {
  if (n < 0 || g < 1 || g > kMaxTile || t_cap < 1 || depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kItems - 1) / kItems;
  auto* words = static_cast<unsigned long long*>(scratch);
  err = cudaMemsetAsync(words, 0, tile_setup_scratch_bytes(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    tile_scan_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(split), n, depth, g, t_cap, words, blocks,
        static_cast<long long*>(tile_id), static_cast<int*>(slot), static_cast<bool*>(deferred),
        static_cast<int*>(piece_start));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = std::min((t_cap + kThreads - 1) / kThreads, 1024);
  tile_finish_kernel<<<grid, kThreads, 0, s>>>(n, t_cap, words, static_cast<int*>(piece_start),
                                                static_cast<int*>(piece_len),
                                                static_cast<int*>(slot));
  return static_cast<int>(cudaGetLastError());
}
