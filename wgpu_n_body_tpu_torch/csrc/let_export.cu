// LET export walk (B7) for Hopper (sm_90a).
//
// Replaces wgpu_n_body_tpu/parallel/let_tree.py:148 export_walk: the XLA
// lax.while_loop (:270-375) that walks the local arena once per destination
// box, one lane per destination, one dependent row gather per emitted row,
// up to let_cap rows, and its emission (:376-505). Here the walk is not
// walked. A row's kind for a destination depends on that row alone, so the
// rows the walk would emit, and where, come from scans (the plain version,
// ops/let_export.py, is the same parallel form in torch ops):
//
//   kind     the theta test of row i against box d with the JAX roundings
//            (__fsub_rn/__fmul_rn/__fadd_rn/__fsqrt_rn, nothing contracted):
//            TERMINAL, POINT, HEADER or INTERNAL; the first three stop the
//            walk, which jumps to skip[i], so they cover rows up to skip[i];
//   visited  no stop row before i reaches past i (a max scan of the reach);
//   slots    a visited row takes one slot, a header one plus its members,
//            the self destination none (a sum scan).
//
// (a) let_export_kernel, one block per 512 arena rows in ticket order, up to
//     8 destinations per launch (one warp each in the scans; more
//     destinations take more launches). The block reads its rows once
//     (node row, count, skip), classifies them against every box held in
//     shared memory, and carries the P pairs (furthest reach, slots so far)
//     through two chained scans with decoupled look-back (chained_scan.cuh):
//     the reach first, then the slots, whose block sum needs the carried
//     reach. It then emits: the block's rows for destination d fill the
//     contiguous slots [carry_d, carry_d + total_d), so its threads write
//     consecutive slots of all destinations in one pass, each finding its
//     row by a binary search over the rows' offsets in shared memory (a
//     header's members are slots like any other: no thread loops over
//     them). Each output row is the node row,
//     the member particle, or an internal row whose pruned skip (the slot at
//     its original skip) lies in another block: that one is marked with
//     -(skip + 1), and the visited rows' slots go to a (P, rows + 1) array.
//     first / count / parts are derived from the written row exactly as the
//     receiver derives them from the wire (let_tree.py:507).
// (b) let_tail_kernel, one thread per output slot: the pruned skips, the
//     sentinel rows past each buffer's rows, n_rows = min(total, let_cap) and
//     overflow = total > let_cap (truncation keeps the DFS prefix, as the JAX
//     loop running out of buffer does).
//
// What bounds it on H100: bytes. The function's own traffic is the outputs
// (60 bytes per slot: one buffer of let_cap rows per destination), the arena
// rows some destination visits and the members it copies
// (ops/let_export.py::export_bytes). The kernels read each arena row once
// per 8 destinations (40 bytes) and move no per-(destination, row) array but
// the visited rows' slots. The design before this one (four kernels and two
// CUB scans over P x rows int32 arrays) moved ~20x the function's bytes.
// Every launch goes on the caller's stream after one memset of the scans'
// status words; nothing is allocated here, nothing is read back.

#include <cuda_runtime.h>

#include <algorithm>

#include "chained_scan.cuh"

namespace {

constexpr int kInternal = 1, kTerminal = 2, kPoint = 3, kHeader = 4;
constexpr float kFar = 1e15f;
constexpr int kThreads = 256;
constexpr int kRowsPer = 2;                  // consecutive arena rows per thread
constexpr int kRows = kThreads * kRowsPer;   // arena rows per block
constexpr int kGroup = kThreads / 32;        // destinations per launch
constexpr int kLanes = kThreads / 32;        // threads' values per lane in a warp's scan

// max(max(lo - x, x - hi), 0): the box's distance along one axis
__device__ __forceinline__ float gap(float lo, float hi, float x) {
  const float a = __fsub_rn(lo, x), b = __fsub_rn(x, hi);
  const float m = a > b ? a : b;
  return m > 0.0f ? m : 0.0f;
}

// The kind of a row (cog cm, width, no_child, count cnt) for the box
// [box[0..2], box[3..5]].
__device__ __forceinline__ int row_kind(float4 cm, float width, float no_child, int cnt,
                                        const float* box, float theta) {
  const float dx = gap(box[0], box[3], cm.x);
  const float dy = gap(box[1], box[4], cm.y);
  const float dz = gap(box[2], box[5], cm.z);
  const float dmin = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  if (width < __fmul_rn(theta, dmin)) return kTerminal;
  if (no_child > 0.0f && cnt == 1) return kPoint;
  if (no_child > 0.0f && cnt > 1) return kHeader;
  return kInternal;
}

struct Out {
  float4* nodes;  // (P, R, 2) float4: the 8-column node rows
  int* skip;
  int* first;
  int* count;
  float4* parts;
  int r_cap;
};

// One output row at slot q of buffer d, with first/count/parts derived from
// it as let_tree.py:507 derives them on the receiving side.
__device__ __forceinline__ void put(const Out& o, int d, int q, float4 cm, float4 geo,
                                    int skip_v) {
  const long long at = static_cast<long long>(d) * o.r_cap + q;
  o.nodes[2 * at] = cm;
  o.nodes[2 * at + 1] = geo;
  o.skip[at] = skip_v;
  const bool header = geo.z > 0.0f && geo.w > 0.0f;
  const bool pointish = cm.w > 0.0f && (geo.x == 0.0f || (geo.z > 0.0f && geo.w == 0.0f));
  o.first[at] = header ? q + 1 : q;
  o.count[at] = header ? static_cast<int>(geo.w) : (pointish ? 1 : 0);
  o.parts[at] = pointish ? cm : make_float4(kFar, kFar, kFar, 0.0f);
}

__device__ __forceinline__ float4 member(const float* __restrict__ src_pos,
                                         const float* __restrict__ src_mass, int j) {
  return make_float4(src_pos[3 * j], src_pos[3 * j + 1], src_pos[3 * j + 2], src_mass[j]);
}

// Exclusive scan by one warp of the kThreads values v[d][0, kThreads), each
// lane taking kLanes consecutive ones, chained across blocks on the status
// words status[k * stride]: v[d][t] becomes op(carry, the block's values
// before t). Returns (carry, the block's aggregate) in every lane.
template <class Op>
__device__ int2 warp_chained_scan(int* v, unsigned long long* status, int block, int stride,
                                  Op op, int identity) {
  const int lane = threadIdx.x & 31;
  int x[kLanes], run = identity;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int a = v[lane * kLanes + j];
    x[j] = run;
    run = op(run, a);
  }
  int incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(chained::kFull, incl, o);
    if (lane >= o) incl = op(y, incl);
  }
  int before = __shfl_up_sync(chained::kFull, incl, 1);
  if (lane == 0) before = identity;
  const int agg = __shfl_sync(chained::kFull, incl, 31);
  const int carry = chained::chain(status, block, stride, agg, op, identity);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) v[lane * kLanes + j] = op(carry, op(before, x[j]));
  return make_int2(carry, agg);
}

__global__ void __launch_bounds__(kThreads) let_export_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ skip,
    const int* __restrict__ first, const int* __restrict__ count,
    const int* __restrict__ num_nodes, const float* __restrict__ src_pos,
    const float* __restrict__ src_mass, const float* __restrict__ box_lo,
    const float* __restrict__ box_hi, int d0, int pg, int self_index, float theta, int stride,
    unsigned long long* __restrict__ words, int blocks, int* __restrict__ slot,
    int* __restrict__ totals, Out o) {
  __shared__ unsigned char kind_s[kGroup][kRows];
  __shared__ int reach_s[kGroup][kThreads];  // a thread's rows' furthest reach, then the prefix
  __shared__ int size_s[kGroup][kThreads];   // a thread's rows' slots, then the block's prefix
  __shared__ int begin_s[kGroup + 1];  // the destinations' slots to emit, back to back
  __shared__ float box_s[kGroup][6];
  __shared__ int carry_s[kGroup], total_s[kGroup];
  unsigned long long* const reach_status = words + 1;                  // [blocks][pg]
  unsigned long long* const slot_status = reach_status + blocks * pg;  // [blocks][pg]
  const int b = chained::take_ticket(reinterpret_cast<int*>(words));
  const int m = __ldg(num_nodes);
  const int base = b * kRows;
  if (base >= m) return;  // past the arena: no later block reads this one
  const int t = threadIdx.x, warp = t >> 5, r0 = t * kRowsPer;
  if (t < 6 * pg) {
    const int d = t / 6, c = t % 6;
    box_s[d][c] = c < 3 ? box_lo[3 * (d0 + d) + c] : box_hi[3 * (d0 + d) + c - 3];
  }

  __syncthreads();  // the boxes

  // the thread's rows, each read once and classified against every box; the
  // thread's furthest reach per destination
  int cnt[kRowsPer], reach[kRowsPer], far[kGroup];
#pragma unroll
  for (int d = 0; d < kGroup; ++d) far[d] = 0;
#pragma unroll
  for (int e = 0; e < kRowsPer; ++e) {
    const int i = base + r0 + e;
    cnt[e] = reach[e] = 0;
    if (i < m) {
      const float4 cm = nodes[2 * i], geo = nodes[2 * i + 1];  // geo: width, is_single, no_child
      cnt[e] = count[i];
      reach[e] = min(skip[i], stride);  // a reach past the arena covers all of it
#pragma unroll
      for (int d = 0; d < kGroup; ++d) {
        if (d < pg) {
          const int k = row_kind(cm, geo.x, geo.z, cnt[e], box_s[d], theta);
          kind_s[d][r0 + e] = static_cast<unsigned char>(k);
          if (k != kInternal) far[d] = max(far[d], reach[e]);
        }
      }
    } else {
      for (int d = 0; d < pg; ++d) kind_s[d][r0 + e] = 0;
    }
  }
#pragma unroll
  for (int d = 0; d < kGroup; ++d)
    if (d < pg) reach_s[d][t] = far[d];
  __syncthreads();
  if (warp < pg) warp_chained_scan(reach_s[warp], reach_status + warp, b, pg, chained::Max(), 0);
  __syncthreads();

  // a row is visited iff no stop row before it reaches past it
  auto slots = [&](int d, int e, int& covered) {
    const int i = base + r0 + e;
    if (i >= m) return 0;
    const int k = kind_s[d][r0 + e];
    const int s = d0 + d != self_index && covered <= i ? (k == kHeader ? 1 + cnt[e] : 1) : 0;
    if (k != kInternal) covered = max(covered, reach[e]);
    return s;
  };
  for (int d = 0; d < pg; ++d) {
    int covered = reach_s[d][t], s = 0;
#pragma unroll
    for (int e = 0; e < kRowsPer; ++e) s += slots(d, e, covered);
    size_s[d][t] = s;
  }
  __syncthreads();
  if (warp < pg) {
    const int2 ca = warp_chained_scan(size_s[warp], slot_status + warp, b, pg, chained::Sum(), 0);
    if ((t & 31) == 0) {
      carry_s[warp] = ca.x;
      total_s[warp] = ca.y;
      if (base + kRows >= m) totals[d0 + warp] = ca.x + ca.y;  // the block of row m - 1
    }
  }
  __syncthreads();

  // the visited rows' slots
  for (int d = 0; d < pg; ++d) {
    if (total_s[d] == 0) continue;  // no row of the block visited for d
    int covered = reach_s[d][t], at = size_s[d][t];
#pragma unroll
    for (int e = 0; e < kRowsPer; ++e) {
      const int s = slots(d, e, covered);
      if (s) slot[static_cast<long long>(d0 + d) * stride + base + r0 + e] = at;
      at += s;
    }
  }
  if (t == 0) {  // the block's slots inside each buffer, destinations back to back
    int all = 0;
    for (int d = 0; d < pg; ++d) {
      begin_s[d] = all;
      all += max(0, min(total_s[d], o.r_cap - carry_s[d]));
    }
    begin_s[pg] = all;
  }
  __syncthreads();

  // emission: thread k writes the block's k-th slot of all destinations,
  // finding the thread whose rows hold it by a binary search over the
  // threads' first slots, then the row among that thread's rows
  for (int k = t; k < begin_s[pg]; k += kThreads) {
    int d = 0;
    while (begin_s[d + 1] <= k) ++d;
    const int dg = d0 + d, q = carry_s[d] + k - begin_s[d];
    int lo = 0, hi = kThreads;  // size_s[d][lo] <= q < size_s[d][hi], the last being the total
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (size_s[d][mid] <= q) lo = mid;
      else hi = mid;
    }
    int r = lo * kRowsPer, at = size_s[d][lo], covered = reach_s[d][lo];
    for (;; ++r) {  // the rows of thread lo: visited iff no stop row before reaches past
      const int i = base + r, kind = kind_s[d][r];
      const int s = covered <= i ? (kind == kHeader ? 1 + count[i] : 1) : 0;
      if (q < at + s) break;
      at += s;
      if (kind != kInternal) covered = max(covered, min(skip[i], stride));
    }
    const int i = base + r, j = q - at;
    const int kind = kind_s[d][r];
    if (kind == kPoint) {
      put(o, dg, q, member(src_pos, src_mass, first[i]), make_float4(0.0f, 1.0f, 1.0f, 0.0f),
          q + 1);
    } else if (j > 0) {  // a header's member j - 1
      put(o, dg, q, member(src_pos, src_mass, first[i] + j - 1),
          make_float4(0.0f, 1.0f, 1.0f, 0.0f), q + 1);
    } else {
      const float4 row = nodes[2 * i], geo = nodes[2 * i + 1];
      if (kind == kTerminal) {
        put(o, dg, q, row, make_float4(geo.x, geo.y, 1.0f, 0.0f), q + 1);
      } else if (kind == kInternal) {  // pruned by the tail kernel
        put(o, dg, q, row, make_float4(geo.x, geo.y, 0.0f, 0.0f), -(skip[i] + 1));
      } else {
        const int c = count[i];
        put(o, dg, q, row, make_float4(geo.x, geo.y, 1.0f, static_cast<float>(c)), q + 1 + c);
      }
    }
  }
}

__global__ void let_tail_kernel(const int* __restrict__ slot, const int* __restrict__ totals,
                                const int* __restrict__ num_nodes, int p, int stride, Out o,
                                int* __restrict__ n_rows, bool* __restrict__ overflow) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(p) * o.r_cap) return;
  const int d = static_cast<int>(t / o.r_cap);
  const int q = static_cast<int>(t - static_cast<long long>(d) * o.r_cap);
  const int total = totals[d];
  const int rows = min(total, o.r_cap);
  if (q == 0) {
    n_rows[d] = rows;
    overflow[d] = total > o.r_cap;
  }
  if (q >= rows) {
    put(o, d, q, make_float4(kFar, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 1.0f, 0.0f),
        o.r_cap);
    return;
  }
  const int v = o.skip[t];
  if (v < 0) {  // an internal row: the slot at its original skip (visited, or the end)
    const int sk = -v - 1, m = __ldg(num_nodes);
    const int at = sk < m ? slot[static_cast<long long>(d) * stride + sk] : total;
    o.skip[t] = sk <= m ? min(at, o.r_cap) : o.r_cap;
  }
}

int blocks_of(int rows) { return (rows + 1 + kRows - 1) / kRows; }

}  // namespace

// Bytes of scratch let_export_launch needs for an arena of `rows` rows and
// p destinations.
extern "C" long long let_export_scratch_bytes(int rows, int p) {
  const long long groups = (p + kGroup - 1) / kGroup;
  return 8 * groups * (1 + 2LL * blocks_of(rows) * kGroup);
}

// The export of one arena to p destination boxes, on `stream`.
// Arena: nodes (rows, 8) f32, skip/first/count (rows,) int32, num_nodes an
// int32 on the device; sources src_pos (n, 3), src_mass (n,) f32; boxes
// box_lo/box_hi (p, 3) f32; self_index the destination that gets only
// sentinel rows. Scratch: let_export_scratch_bytes(rows, p) bytes (zeroed
// here), slot (p * (rows + 1)) int32, totals (p,) int32. Out: nodes
// (p, r_cap, 8) f32, skip/first/count (p, r_cap) int32, parts (p, r_cap, 4)
// f32, n_rows (p,) int32, overflow (p,) bool. The caller keeps
// p * (rows + 1 + n) below 2^31. Returns the first cudaError_t (0 = success).
extern "C" int let_export_launch(const void* nodes, const void* skip, const void* first,
                                 const void* count, const void* num_nodes, int rows,
                                 const void* src_pos, const void* src_mass,
                                 const void* box_lo, const void* box_hi, int p,
                                 int self_index, float theta, int r_cap, void* scratch,
                                 void* slot, void* totals, void* out_nodes, void* out_skip,
                                 void* out_first, void* out_count, void* out_parts,
                                 void* out_n_rows, void* out_overflow, int device, void* stream) {
  if (rows < 1 || p < 1 || r_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stride = rows + 1;
  const int blocks = blocks_of(rows);
  auto* words = static_cast<unsigned long long*>(scratch);
  err = cudaMemsetAsync(words, 0, let_export_scratch_bytes(rows, p), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Out o{static_cast<float4*>(out_nodes), static_cast<int*>(out_skip),
        static_cast<int*>(out_first), static_cast<int*>(out_count),
        static_cast<float4*>(out_parts), r_cap};
  const auto* m = static_cast<const int*>(num_nodes);
  for (int d0 = 0; d0 < p; d0 += kGroup) {
    const int pg = std::min(kGroup, p - d0);
    let_export_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(nodes), static_cast<const int*>(skip),
        static_cast<const int*>(first), static_cast<const int*>(count), m,
        static_cast<const float*>(src_pos), static_cast<const float*>(src_mass),
        static_cast<const float*>(box_lo), static_cast<const float*>(box_hi), d0, pg, self_index,
        theta, stride, words + (d0 / kGroup) * (1 + 2LL * blocks * kGroup), blocks,
        static_cast<int*>(slot), static_cast<int*>(totals), o);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const long long slots = static_cast<long long>(p) * r_cap;
  let_tail_kernel<<<static_cast<unsigned>((slots + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const int*>(slot), static_cast<const int*>(totals), m, p, stride, o,
      static_cast<int*>(out_n_rows), static_cast<bool*>(out_overflow));
  return static_cast<int>(cudaGetLastError());
}
