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
// Two kernels, one block per kItems consecutive receivers (kPer a thread),
// and no memset (the caller's scratch keeps one counter at zero between
// calls):
//
// (a) tile_scan_kernel: the windows, in O(1) operations per receiver
//     whatever g (van Herk / Gil-Werman). The block's split levels with a
//     halo of g on each side sit in shared memory four to a word; a prefix
//     and a suffix min (then max) over segments of the window's width
//     (rounded down to whole words) take one pass of per-byte SIMD
//     (__vminu4 / __vmaxu4) per thread over its words, one warp-shuffle
//     segmented scan and one fold over the warps; each window is then one
//     combine of a suffix and a prefix (two where the width is not a
//     multiple of 4). Six barriers for both windows, where doubling took
//     2 ceil(log2 g) (18 at g = 512). Then the group starts, a block max
//     scan (the last start before each thread) and a sum scan (the breaks
//     after the block's first start), and the block's summary: (its first
//     group start f or none, its last group start l, the breaks in
//     [f, end), its span). It writes the summary and, per thread, its start
//     bits, its last start before it and its breaks before it.
//     The last block to finish (an atomic counter it leaves at zero for
//     the next call) then runs one scan for what were two dependent ones.
//     Two adjacent summaries compose into one (the breaks between the
//     second's start and its first group start follow from the first's
//     last start: the i with (i - l) % g = 0), and a carried state (the
//     last group start mod g, the breaks so far) absorbs a summary the same
//     way. It scans the B summaries once, a contiguous run of them per
//     thread and then in order across the threads, and writes the state
//     before each block: O(B) in all, and no block waits on another's
//     progress (a decoupled look-back made each wait on the slowest of its
//     predecessors, PERF.md).
// (b) tile_emit_kernel: each block reads its state, and each receiver's
//     tile follows arithmetically. Every break writes its tile's start and
//     the previous tile's length; the last block fills the unused tiles
//     (start n, length 0). Receivers past t_cap take slot i - (the last
//     tile's start), which the block of the first spilled break publishes
//     to the later ones (blocks in ticket order; tile_scan_kernel resets
//     the ticket and that word). tile_id, slot and deferred go through
//     shared memory (a padded row per thread), so that consecutive threads
//     store consecutive receivers.
//
// What bounds it on H100: bytes. It reads n split levels and writes an int64
// tile id (an index: torch's gathers take int64 without a copy), an int32
// slot and a bool per receiver and two int32 per tile: 14n + 8 t_cap bytes,
// 56.2 MB at N=4M (0.017 ms at 3.35 TB/s); the 12 bytes per thread and 16
// per block that pass between the kernels stay in L2, as do the B summaries
// the last scan block reads and the 8-byte states it writes. Its arithmetic is a
// few dozen shared memory operations per receiver. Two launches on the
// caller's stream; nothing is read back.

#include <cuda_runtime.h>

#include <climits>

#include "chained_scan.cuh"  // kFull, kPatience

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                       // consecutive receivers per thread
constexpr int kItems = kThreads * kPer;        // receivers per block
constexpr int kMaxTile = 512;                  // walk_tile on CUDA
constexpr int kWordsX = (kItems + 2 * kMaxTile) / 4;  // split levels and halos, 4 a word
constexpr int kWordsY = (kItems + kMaxTile) / 4 + 1;  // the first window's results
constexpr int kWordsL = kItems / 4 + 1;        // lstar of receivers base - 1 .. base + kItems - 1
constexpr int kWpt = (kWordsX + kThreads - 1) / kThreads;  // words per thread in a scan
constexpr int kPad = 4;                        // words bytes_at may read past an array
constexpr int kRow = kPer + 1;                 // a thread's staged outputs, padded: no bank conflict
constexpr int kWindowWords = 3 * (kWordsX + kPad) + kWordsY + kWordsL + 2 * kPad;
constexpr int kStageWords = 2 * kThreads * kRow + kItems / 4;  // tile ids, slots, deferred
static_assert(kPer % 4 == 0 && kPer <= 16, "a thread's receivers: whole words, 16 bits");

// Per-byte min and max of four bytes packed in a word; one() on single bytes.
struct MinU4 {
  static constexpr unsigned kId = 0xffu;
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return __vminu4(a, b);
  }
  __device__ __forceinline__ static unsigned one(unsigned a, unsigned b) { return min(a, b); }
};
struct MaxU4 {
  static constexpr unsigned kId = 0u;
  __device__ __forceinline__ unsigned operator()(unsigned a, unsigned b) const {
    return __vmaxu4(a, b);
  }
  __device__ __forceinline__ static unsigned one(unsigned a, unsigned b) { return max(a, b); }
};

// The four bytes [4 w + sh, 4 w + sh + 4) of the byte array packed in x.
__device__ __forceinline__ unsigned bytes_at(const unsigned* x, int w, int sh) {
  const int q = w + (sh >> 2);
  return __byte_perm(x[q], x[q + 1], 0x3210 + 0x1111 * (sh & 3));
}

__device__ __forceinline__ unsigned bcast(unsigned byte) { return byte * 0x01010101u; }

// op over the bytes of v up to each byte (little-endian order) / from it on.
template <class Op>
__device__ __forceinline__ unsigned prefix4(unsigned v) {
  const unsigned t = Op()(v, (v << 8) | Op::kId);
  return Op()(t, (t << 16) | (Op::kId * 0x0101u));
}
template <class Op>
__device__ __forceinline__ unsigned suffix4(unsigned v) {
  const unsigned t = Op()(v, (v >> 8) | (Op::kId << 24));
  return Op()(t, (t >> 16) | (Op::kId * 0x01010000u));
}

// A segmented carry: the op over the bytes since the last segment boundary
// (bits 0-7) and whether the span holds a boundary (bit 8). Composes an
// earlier span with a later one.
template <class Op>
__device__ __forceinline__ unsigned seg(unsigned earlier, unsigned later) {
  return (later & 0x100u) ? later : ((earlier & 0x100u) | Op::one(earlier & 0xffu, later & 0xffu));
}

// The van Herk / Gil-Werman halves of a sliding window of w >= 8 bytes over
// the bytes of src[0, nw): with segments of wp = w & ~3 bytes (m = wp / 4
// words) from byte 0, P holds each byte's op from its segment's start and S
// its op to its segment's end. Every thread calls it; it ends in a barrier.
template <class Op>
__device__ void slide(const unsigned* src, int nw, int w, unsigned* P, unsigned* S,
                      unsigned (*red)[kWarps]) {
  if (w < 8) return;  // window_at reads src itself
  const int m = w >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = threadIdx.x * kWpt;
  // this thread's words' prefixes and suffixes within their segments as far
  // as the thread sees them; lead_f (lead_b) marks the words before its
  // first segment start (after its last segment end), which the carry from
  // the threads before (after) it completes
  unsigned pf[kWpt], sf[kWpt], lead_f = 0, lead_b = 0;
  unsigned f = Op::kId, bk = Op::kId;
  int r = q0 % m;
#pragma unroll
  for (int e = 0; e < kWpt; ++e) {
    pf[e] = Op::kId * 0x01010101u;
    if (q0 + e < nw) {
      if (r == 0) f = 0x100u | Op::kId;
      if (!(f & 0x100u)) lead_f |= 1u << e;
      pf[e] = Op()(prefix4<Op>(src[q0 + e]), bcast(f & 0xffu));
      f = (f & 0x100u) | (pf[e] >> 24);
    }
    r = r + 1 == m ? 0 : r + 1;
  }
  r = (q0 + kWpt - 1) % m;
#pragma unroll
  for (int e = kWpt - 1; e >= 0; --e) {
    const int q = q0 + e;
    sf[e] = Op::kId * 0x01010101u;
    if (q < nw) {
      if (r == m - 1 || q == nw - 1) bk = 0x100u | Op::kId;
      if (!(bk & 0x100u)) lead_b |= 1u << e;
      sf[e] = Op()(suffix4<Op>(src[q]), bcast(bk & 0xffu));
      bk = (bk & 0x100u) | (sf[e] & 0xffu);
    }
    r = r == 0 ? m - 1 : r - 1;
  }
  // segmented scans of the carries across the warp (forward up the lanes,
  // backward down), then across the warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned yf = __shfl_up_sync(chained::kFull, f, o);
    const unsigned yb = __shfl_down_sync(chained::kFull, bk, o);
    if (lane >= o) f = seg<Op>(yf, f);
    if (lane + o < 32) bk = seg<Op>(yb, bk);
  }
  unsigned ef = __shfl_up_sync(chained::kFull, f, 1);
  unsigned eb = __shfl_down_sync(chained::kFull, bk, 1);
  if (lane == 0) ef = Op::kId;
  if (lane == 31) eb = Op::kId;
  if (lane == 31) red[0][warp] = f;
  if (lane == 0) red[1][warp] = bk;
  __syncthreads();
  unsigned af = Op::kId, ab = Op::kId;
  for (int k = 0; k < warp; ++k) af = seg<Op>(af, red[0][k]);
  for (int k = kWarps - 1; k > warp; --k) ab = seg<Op>(ab, red[1][k]);
  const unsigned cf = bcast(seg<Op>(af, ef) & 0xffu), cb = bcast(seg<Op>(ab, eb) & 0xffu);
#pragma unroll
  for (int e = 0; e < kWpt; ++e) {
    if (q0 + e < nw) {
      P[q0 + e] = (lead_f >> e) & 1 ? Op()(pf[e], cf) : pf[e];
      S[q0 + e] = (lead_b >> e) & 1 ? Op()(sf[e], cb) : sf[e];
    }
  }
  __syncthreads();
}

// The bytes [4 i + off, 4 i + off + 4) of the window of w bytes over src:
// op(src[k .. k + w - 1]) for each, from slide()'s halves (w >= 8) or
// directly (w < 8).
template <class Op>
__device__ __forceinline__ unsigned window_at(const unsigned* src, const unsigned* P,
                                              const unsigned* S, int w, int i, int off) {
  if (w < 8) {
    unsigned a = bytes_at(src, i, off);
    for (int c = 1; c < w; ++c) a = Op()(a, bytes_at(src, i, off + c));
    return a;
  }
  const int wp = w & ~3, e = w - wp;
  unsigned a = Op()(bytes_at(S, i, off), bytes_at(P, i, off + wp - 1));
  if (e) a = Op()(a, Op()(bytes_at(S, i, off + e), bytes_at(P, i, off + e + wp - 1)));
  return a;
}

// x mod g in [0, g) for any int x; g a power of two takes the mask.
struct ModG {
  int g, mask;  // mask: g - 1 for a power of two, else -1
  __device__ __forceinline__ int operator()(int x) const {
    if (mask >= 0) return x & mask;
    const int r = x % g;
    return r < 0 ? r + g : r;
  }
};

// The i in [a, b) with (i - rs) % g == 0 (rs may be given mod g).
__device__ __forceinline__ int count_breaks(int a, int b, int rs, const ModG& mod) {
  if (b <= a) return 0;
  const int r0 = mod(a - rs);
  const int first = a + (r0 == 0 ? 0 : mod.g - r0);
  return first < b ? (b - 1 - first) / mod.g + 1 : 0;
}

// A span's summary: first and last group start (f = -1: none), the breaks
// in [f, hi), the span [lo, hi); lo = -1 is the empty span.
struct Summary {
  int f, l, k, lo, hi;
};
// The state after a span: its last group start (mod g) and the breaks so far.
struct State {
  int rs, t;
};

__device__ __forceinline__ Summary compose(const Summary& a, const Summary& b, const ModG& mod) {
  if (a.lo < 0) return b;
  if (b.lo < 0) return a;
  Summary c{b.f, b.l, b.k, a.lo, b.hi};
  if (a.f >= 0) {
    c.f = a.f;
    c.l = b.f >= 0 ? b.l : a.l;
    c.k = a.k + count_breaks(b.lo, b.f >= 0 ? b.f : b.hi, a.l, mod) + (b.f >= 0 ? b.k : 0);
  }
  return c;
}

__device__ __forceinline__ State absorb(State s, const Summary& a, const ModG& mod) {
  if (a.lo < 0) return s;
  s.t += count_breaks(a.lo, a.f >= 0 ? a.f : a.hi, s.rs, mod);
  if (a.f >= 0) {
    s.t += a.k;
    s.rs = mod(a.l);
  }
  return s;
}

__device__ __forceinline__ Summary shfl_up(const Summary& a, int o) {
  return {__shfl_up_sync(chained::kFull, a.f, o), __shfl_up_sync(chained::kFull, a.l, o),
          __shfl_up_sync(chained::kFull, a.k, o), __shfl_up_sync(chained::kFull, a.lo, o),
          __shfl_up_sync(chained::kFull, a.hi, o)};
}

__device__ __forceinline__ int span_end(int lo, int n) { return n - lo < kItems ? n : lo + kItems; }

__device__ __forceinline__ int byte_of(const unsigned* x, int k) {
  return (x[k >> 2] >> (8 * (k & 3))) & 0xff;
}

// Block k's summary, read from L2 (other blocks of this launch wrote it).
__device__ __forceinline__ Summary summary_of(const int4* sums, int k, int n) {
  const int4 v = __ldcg(sums + k);
  const int lo = k * kItems;
  return {v.x, v.y, v.z, lo, span_end(lo, n)};
}

// The last block of tile_scan_kernel: states[k] the state before block k,
// k in [0, B], from the B summaries, each thread a contiguous run of them,
// the runs composed in order across the threads (an exclusive scan).
__device__ void scan_states(const int4* sums, int B, int n, const ModG& mod, int2* states,
                            Summary* s_sum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (B + kThreads - 1) / kThreads;
  const int k0 = min(B, t * per), k1 = min(B, k0 + per);
  const Summary none{-1, -1, 0, -1, -1};
  Summary a = none;
  for (int k = k0; k < k1; ++k) a = compose(a, summary_of(sums, k, n), mod);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Summary earlier = shfl_up(a, o);
    if (lane >= o) a = compose(earlier, a, mod);
  }
  Summary before = shfl_up(a, 1);
  if (lane == 31) s_sum[warp] = a;
  __syncthreads();
  if (lane == 0) before = none;
  Summary w = none;
  for (int k = 0; k < warp; ++k) w = compose(w, s_sum[k], mod);
  State st = absorb(State{0, 0}, compose(w, before, mod), mod);
  for (int k = k0; k < k1; ++k) {
    states[k] = make_int2(st.rs, st.t);
    st = absorb(st, summary_of(sums, k, n), mod);
  }
  if (k0 < k1 && k1 == B) states[B] = make_int2(st.rs, st.t);
}

// What tile_scan_kernel hands tile_emit_kernel for each thread: its group
// start bits and its breaks before it (after the block's first start), and
// its block's last group start before it (-1: none).
struct Lane {
  unsigned starts_breaks;  // bits 0..kPer-1: starts; the breaks above them
  int rs0;
};

// 6 resident blocks an SM (at most 42 registers): measured faster than the
// compiler's 48 (PERF.md)
__global__ void __launch_bounds__(kThreads, 6) tile_scan_kernel(
    const unsigned char* __restrict__ split, int n, int depth, int g, bool aligned,
    int* __restrict__ work, int4* __restrict__ sums, int2* __restrict__ states,
    Lane* __restrict__ lanes) {
  __shared__ unsigned smem[kWindowWords];
  unsigned* const X = smem;  // split levels of base - H .. base + kItems + H
  unsigned* const P = X + kWordsX + kPad;
  unsigned* const S = P + kWordsX + kPad;
  unsigned* const Y = S + kWordsX + kPad;
  unsigned* const L = Y + kWordsY + kPad;
  __shared__ unsigned red[2][kWarps];
  __shared__ int w_last[kWarps], w_first[kWarps], w_breaks[kWarps];
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int base = b * kItems;
  const ModG mod{g, (g & (g - 1)) == 0 ? g - 1 : -1};
  const int H = (g + 3) & ~3;  // the halo, whole words
  const int origin = base - H;
  if (b == 0 && t == 0) {  // tile_emit_kernel's ticket and first spilled break
    work[0] = 0;
    work[1] = -1;
  }

  // (loops of a fixed count, unrolled: their loads are in flight together)
#pragma unroll
  for (int k = 0; k < kWpt; ++k) {
    const int q = t + k * kThreads, j = origin + 4 * q;
    if (q >= kWordsX) break;
    unsigned v = 0;
    if (aligned && j >= 0 && j <= n - 4) {
      v = __ldg(reinterpret_cast<const unsigned*>(split + j));
    } else {
      for (int c = 0; c < 4; ++c)
        if (j + c >= 0 && j + c < n) v |= static_cast<unsigned>(split[j + c]) << (8 * c);
    }
    X[q] = v;
  }
  __syncthreads();

  if (g == 1 || n < g) {  // every cell holds g receivers / none does
    const unsigned v = bcast(g == 1 ? depth : 0);
    for (int i = t; i < kWordsL; i += kThreads) L[i] = v;
  } else {
    // the windows a = base - g + u: 1 + their shared depth, min(s[a+1 .. a+g-1]),
    // where the window lies in [0, n), else 0 (u in [0, kItems + g))
    const int d = H - g, lo = g - base, hi = n - base, ny = (kItems + g + 3) / 4;
    slide<MinU4>(X, kWordsX, g - 1, P, S, red);
#pragma unroll
    for (int k = 0; k < (kWordsY + kThreads - 1) / kThreads; ++k) {
      const int i = t + k * kThreads;
      if (i >= ny) break;
      unsigned keep = 0;
      for (int c = 0; c < 4; ++c) {
        const int u = 4 * i + c;
        if (u >= lo && u <= hi && u < kItems + g) keep |= 0xffu << (8 * c);
      }
      Y[i] = window_at<MinU4>(X, P, S, g - 1, i, 1 + d) & keep;
    }
    __syncthreads();
    // lstar[base - 1 + v]: the max over the windows a in [i - g + 1, i], less
    // 1, clamped to [0, depth]
    slide<MaxU4>(Y, ny, g, P, S, red);
#pragma unroll
    for (int k = 0; k < (kWordsL + kThreads - 1) / kThreads; ++k) {
      const int i = t + k * kThreads;
      if (i >= kWordsL) break;
      L[i] = __vminu4(__vmaxu4(window_at<MaxU4>(Y, P, S, g, i, 0), 0x01010101u) - 0x01010101u,
                      bcast(depth));
    }
  }
  __syncthreads();

  // this thread's receivers i0 .. i0 + kPer - 1: group starts (bit e)
  const int i0 = base + t * kPer;
  unsigned sw[kPer / 4], lw[kPer / 4 + 1];
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) sw[k] = X[(H >> 2) + t * (kPer / 4) + k];
#pragma unroll
  for (int k = 0; k <= kPer / 4; ++k) lw[k] = L[t * (kPer / 4) + k];
  unsigned starts = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = i0 + e, ls = byte_of(lw, e + 1);
    if (i < n && (i == 0 || ls != byte_of(lw, e) || byte_of(sw, e) <= ls)) starts |= 1u << e;
  }
  // the block's last group start before this thread's receivers (a max scan)
  int x = starts ? i0 + 31 - __clz(starts) : -1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(chained::kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  const int wf = __reduce_min_sync(chained::kFull, starts ? i0 + __ffs(starts) - 1 : INT_MAX);
  int rs0 = __shfl_up_sync(chained::kFull, x, 1);
  if (lane == 31) w_last[warp] = x;
  if (lane == 0) {
    w_first[warp] = wf;
    rs0 = -1;
  }
  __syncthreads();
  for (int k = 0; k < warp; ++k) rs0 = max(rs0, w_last[k]);
  // breaks after the block's first group start (a sum scan)
  int cnt = 0;
  {
    int rs = rs0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = i0 + e;
      if ((starts >> e) & 1) rs = i;
      cnt += i < n && rs >= 0 && (rs == i || mod(i - rs) == 0);
    }
  }
  int cs = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(chained::kFull, cs, o);
    if (lane >= o) cs += y;
  }
  if (lane == 31) w_breaks[warp] = cs;
  cs -= cnt;
  __syncthreads();
  for (int k = 0; k < warp; ++k) cs += w_breaks[k];
  lanes[b * kThreads + t] = Lane{starts | (static_cast<unsigned>(cs) << kPer), rs0};
  if (t == 0) {
    int f_b = INT_MAX, l_b = -1, k_b = 0;
    for (int k = 0; k < kWarps; ++k) {
      f_b = min(f_b, w_first[k]);
      l_b = max(l_b, w_last[k]);
      k_b += w_breaks[k];
    }
    sums[b] = f_b == INT_MAX ? make_int4(-1, -1, 0, 0) : make_int4(f_b, l_b, k_b, 0);
    __threadfence();  // the summary before the count that may let the last block read it
    // work[2] wraps to zero at the last block: zero again for the next call
    s_last = atomicInc(reinterpret_cast<unsigned*>(work + 2), gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the shared windows are free: every thread read its words before the
  // barriers of the scans above
  scan_states(sums, gridDim.x, n, mod, states, reinterpret_cast<Summary*>(smem));
}

__global__ void __launch_bounds__(kThreads) tile_emit_kernel(
    int n, int g, int t_cap, int* __restrict__ work, const int4* __restrict__ sums,
    const int2* __restrict__ states, const Lane* __restrict__ lanes,
    long long* __restrict__ tile_id, int* __restrict__ slot, bool* __restrict__ deferred,
    int* __restrict__ piece_start, int* __restrict__ piece_len) {
  __shared__ unsigned smem[kStageWords];
  __shared__ int s_block, s_p0;
  const int t = threadIdx.x;
  if (t == 0) {
    s_block = atomicAdd(work, 1);  // ticket order: a block waits only on running ones
    s_p0 = -1;
  }
  __syncthreads();
  const int b = s_block;
  const int base = b * kItems, hi_b = span_end(base, n);
  const ModG mod{g, (g & (g - 1)) == 0 ? g - 1 : -1};
  const Lane me = lanes[b * kThreads + t];
  const Summary mine = summary_of(sums, b, n);
  // the states before and after this block
  const int2 in2 = states[b];
  const State in{in2.x, in2.y};
  const int t_out = states[b + 1].y;

  // each receiver's tile, slot and spill; breaks write the pieces
  const int i0 = base + t * kPer;
  const unsigned starts = me.starts_breaks & ((1u << kPer) - 1);
  const int rs0 = me.rs0, cs = static_cast<int>(me.starts_breaks >> kPer);
  int rs = rs0 >= 0 ? rs0 : in.rs;  // the last group start, mod g where it came from before
  int breaks = rs0 >= 0 ? in.t + count_breaks(base, mine.f, in.rs, mod) + cs
                        : in.t + count_breaks(base, i0, in.rs, mod);
  int tiles[kPer], slots[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = i0 + e;
    tiles[e] = INT_MAX;
    slots[e] = 0;
    if (i >= n) continue;
    const int prev_rs = rs;
    const bool st = (starts >> e) & 1;
    if (st) rs = i;
    const bool brk = st || mod(i - rs) == 0;
    breaks += brk;
    const int tile = breaks - 1;
    tiles[e] = tile;
    slots[e] = mod(i - rs);
    if (brk && tile <= t_cap) {
      const int prev = st ? i - 1 - mod(i - 1 - prev_rs) : i - mod.g;  // the previous break
      if (tile < t_cap) {
        piece_start[tile] = i;
        if (tile > 0) piece_len[tile - 1] = i - prev;
      } else {  // the first spilled receiver: the last tile runs from prev to n
        piece_len[t_cap - 1] = n - prev;
        s_p0 = prev;
        *reinterpret_cast<volatile int*>(work + 1) = prev;
      }
    }
    if (i == n - 1 && tile < t_cap) piece_len[tile] = n - (i - slots[e]);
  }
  if (t_out > t_cap) {  // receivers of this block spilled: slot = i - the last tile's start
    __syncthreads();      // s_p0, where this block holds the first spilled break
    bool spilled = false;
#pragma unroll
    for (int e = 0; e < kPer; ++e) spilled |= tiles[e] >= t_cap && tiles[e] != INT_MAX;
    if (spilled) {
      // else an earlier block (by ticket) holds it and publishes it
      int p0 = s_p0;
      if (p0 < 0) {
        const volatile int* word = work + 1;
        const long long t0 = clock64();
        while ((p0 = *word) < 0) {
          if (chained::kPatience > 0 && clock64() - t0 > chained::kPatience) __trap();
        }
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (tiles[e] >= t_cap && tiles[e] != INT_MAX) slots[e] = i0 + e - p0;
    }
  }
  // through shared memory, so that the stores are coalesced
  int* const st_tile = reinterpret_cast<int*>(smem);
  int* const st_slot = st_tile + kThreads * kRow;
  unsigned* const st_def = reinterpret_cast<unsigned*>(st_slot + kThreads * kRow);
  unsigned dw[kPer / 4];
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) dw[k] = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (tiles[e] >= t_cap && tiles[e] != INT_MAX) dw[e >> 2] |= 1u << (8 * (e & 3));
    st_tile[t * kRow + e] = min(tiles[e], t_cap - 1);
    st_slot[t * kRow + e] = slots[e];
  }
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) st_def[t * (kPer / 4) + k] = dw[k];
  __syncthreads();
  for (int r = t; r < kItems; r += kThreads) {
    const int i = base + r;
    if (i >= n) break;
    const int at = r / kPer * kRow + r % kPer;
    tile_id[i] = st_tile[at];
    slot[i] = st_slot[at];
  }
  for (int q = t; q < kItems / 4; q += kThreads) {
    const int i = base + 4 * q;
    if (i + 4 <= n) {
      reinterpret_cast<unsigned*>(deferred)[i >> 2] = st_def[q];
    } else {
      for (int c = 0; c < 4 && i + c < n; ++c) deferred[i + c] = (st_def[q] >> (8 * c)) & 1;
    }
  }
  if (hi_b == n) {  // the last block: tiles past the used ones start at n, empty
    for (int k = min(t_out, t_cap) + t; k < t_cap; k += kThreads) {
      piece_start[k] = n;
      piece_len[k] = 0;
    }
  }
}

}  // namespace

// Receivers per block of the tile set-up kernels.
extern "C" int tile_setup_block_items() { return kItems; }

// Bytes of scratch tile_setup_launch needs for n receivers.
extern "C" long long tile_setup_scratch_bytes(int n) {
  const long long blocks = n > 0 ? (static_cast<long long>(n) + kItems - 1) / kItems : 1;
  return 16 * (1 + blocks) + 8 * (blocks + 1) +
         static_cast<long long>(sizeof(Lane)) * kThreads * blocks;
}

// The tiles of n receivers with split levels `split` (n,) uint8, on `stream`:
// tile_id (n,) int64, slot (n,) int32, deferred (n,) bool, piece_start,
// piece_len (t_cap,) int32. depth = max_depth, g = walk_tile in [1, 512],
// t_cap the tile budget. scratch: tile_setup_scratch_bytes(n) bytes (or
// more), zero when first given and left so by each call for the next on the
// same stream (its third int; the kernels set the rest before they read it).
// Returns the first cudaError_t (0 = success); does not synchronise.
extern "C" int tile_setup_launch(const void* split, int n, int depth, int g, int t_cap,
                                 void* scratch, void* tile_id, void* slot, void* deferred,
                                 void* piece_start, void* piece_len, int device, void* stream) {
  if (n < 0 || g < 1 || g > kMaxTile || t_cap < 1 || depth < 0 || depth > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = n > 0 ? (n + kItems - 1) / kItems : 1;
  int* const work = static_cast<int*>(scratch);
  int4* const sums = static_cast<int4*>(scratch) + 1;  // after the 16-byte header
  int2* const states = reinterpret_cast<int2*>(sums + blocks);
  Lane* const lanes = reinterpret_cast<Lane*>(states + blocks + 1);
  const bool aligned = (reinterpret_cast<unsigned long long>(split) & 3) == 0;
  tile_scan_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const unsigned char*>(split), n, depth,
                                               g, aligned, work, sums, states, lanes);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_emit_kernel<<<blocks, kThreads, 0, s>>>(
      n, g, t_cap, work, sums, states, lanes, static_cast<long long*>(tile_id),
      static_cast<int*>(slot),
      static_cast<bool*>(deferred), static_cast<int*>(piece_start), static_cast<int*>(piece_len));
  return static_cast<int>(cudaGetLastError());
}
