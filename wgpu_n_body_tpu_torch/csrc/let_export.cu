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
// 1. let_classify_kernel, one thread per arena row i, every destination d in
//    turn: the theta test of the row against d's box with the JAX roundings
//    (__fsub_rn/__fmul_rn/__fadd_rn/__fsqrt_rn, nothing contracted), the
//    row's kind (TERMINAL, POINT, HEADER, INTERNAL) and, for a stop row
//    (the first three: the walk jumps to skip[i]), skip[i] as the reach it
//    covers. The reach is written as d * K + reach (K = stride + 1), so that
//    ONE device-wide max scan over the P segments back to back is each
//    segment's own prefix max: segment d's values lie in [d K, d K + K).
// 2. CUB's DeviceScan::InclusiveScan with max: the furthest reach of the
//    stop rows up to each row.
// 3. let_size_kernel: row i is visited iff the reach of the stop rows
//    before it is <= i (no ancestor stopped the walk); a visited row takes
//    one slot, a header one plus its members; the self destination none.
// 4. CUB's DeviceScan::ExclusiveSum: each row's first slot, the segment's
//    total at its end.
// 5. let_emit_kernel, one thread per row, every destination: a visited row
//    whose slot is below let_cap writes its output row (a header also its
//    member rows, as many as fit): the node row, the member particle, the
//    pruned skip of an internal row (the slot offset found at its original
//    skip, what the JAX package computes with a rank join of two sorts),
//    and first / count / parts derived from the written row exactly as the
//    receiver derives them from the wire (let_tree.py:507).
// 6. let_tail_kernel, one thread per output slot: the sentinel rows past
//    each buffer's rows, n_rows = min(total, let_cap) and overflow = total >
//    let_cap (truncation keeps the DFS prefix, as the JAX loop running out
//    of buffer does).
//
// What bounds it on H100: bytes. The function's own traffic is the outputs
// (60 bytes per slot: 1 buffer of let_cap rows per destination) and the
// arena rows some destination visits; the kernels read each arena row once
// per call and move ~20 bytes per (destination, row) through the scans'
// P x (rows + 1) int32 arrays. The two scans are library calls (the
// toolkit's CUB); the theta decisions, the covering, the sizes and the
// emission are this file's. Every launch goes on the caller's stream,
// nothing is allocated here, nothing is read back to the host.

#include <cuda_runtime.h>

#include <cub/device/device_scan.cuh>

namespace {

constexpr int kInternal = 1, kTerminal = 2, kPoint = 3, kHeader = 4;
constexpr float kFar = 1e15f;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// max(max(lo - x, x - hi), 0): the box's distance along one axis
__device__ __forceinline__ float gap(float lo, float hi, float x) {
  const float a = __fsub_rn(lo, x), b = __fsub_rn(x, hi);
  const float m = a > b ? a : b;
  return m > 0.0f ? m : 0.0f;
}

__global__ void let_classify_kernel(const float4* __restrict__ nodes,
                                    const int* __restrict__ skip,
                                    const int* __restrict__ count,
                                    const int* __restrict__ num_nodes,
                                    const float* __restrict__ box_lo,
                                    const float* __restrict__ box_hi, int p,
                                    int stride, float theta,
                                    unsigned char* __restrict__ kind,
                                    int* __restrict__ reach) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  const int m = *num_nodes;
  const int k_seg = stride + 1;
  if (i >= m) {  // past the arena's rows (and the segment's extra column)
    for (int d = 0; d < p; ++d) {
      kind[d * stride + i] = 0;
      reach[d * stride + i] = d * k_seg;
    }
    return;
  }
  const float4 cm = nodes[2 * i];   // cog x y z, mass
  const float4 geo = nodes[2 * i + 1];  // width, is_single, no_child, col 7
  const int cnt = count[i];
  const int sk = min(skip[i], stride);  // a reach past the arena covers all of it
  for (int d = 0; d < p; ++d) {
    const float dx = gap(box_lo[3 * d], box_hi[3 * d], cm.x);
    const float dy = gap(box_lo[3 * d + 1], box_hi[3 * d + 1], cm.y);
    const float dz = gap(box_lo[3 * d + 2], box_hi[3 * d + 2], cm.z);
    const float dmin = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
    const bool ok = geo.x < __fmul_rn(theta, dmin);
    const bool near = !ok && geo.z > 0.0f;
    int k = kInternal;
    if (ok) k = kTerminal;
    else if (near && cnt == 1) k = kPoint;
    else if (near && cnt > 1) k = kHeader;
    kind[d * stride + i] = static_cast<unsigned char>(k);
    reach[d * stride + i] = d * k_seg + (k == kInternal ? 0 : sk);
  }
}

__global__ void let_size_kernel(const unsigned char* __restrict__ kind,
                                const int* __restrict__ reach_max,
                                const int* __restrict__ count,
                                const int* __restrict__ num_nodes, int p,
                                int self_index, int stride,
                                int* __restrict__ size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  const int m = *num_nodes;
  const int k_seg = stride + 1;
  for (int d = 0; d < p; ++d) {
    const int at = d * stride + i;
    int s = 0;
    if (i < m && d != self_index) {
      const int covered = i > 0 ? reach_max[at - 1] - d * k_seg : 0;
      if (covered <= i) s = kind[at] == kHeader ? 1 + count[i] : 1;
    }
    size[at] = s;
  }
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

__global__ void let_emit_kernel(const float4* __restrict__ nodes,
                                const int* __restrict__ skip,
                                const int* __restrict__ first,
                                const int* __restrict__ count,
                                const int* __restrict__ num_nodes,
                                const float* __restrict__ src_pos,
                                const float* __restrict__ src_mass,
                                const unsigned char* __restrict__ kind,
                                const int* __restrict__ size,
                                const int* __restrict__ slot, int p, int stride,
                                Out o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = *num_nodes;
  if (i >= m) return;
  for (int d = 0; d < p; ++d) {
    const int at = d * stride + i;
    if (size[at] == 0) continue;
    const int base = slot[d * stride];
    const int q = slot[at] - base;
    if (q >= o.r_cap) continue;
    const int k = kind[at];
    const float4 geo = nodes[2 * i + 1];
    if (k == kPoint) {
      put(o, d, q, member(src_pos, src_mass, first[i]), make_float4(0.0f, 1.0f, 1.0f, 0.0f),
          q + 1);
      continue;
    }
    const float4 cm = nodes[2 * i];
    if (k == kTerminal) {
      put(o, d, q, cm, make_float4(geo.x, geo.y, 1.0f, 0.0f), q + 1);
    } else if (k == kInternal) {
      const int sk = skip[i];
      const int pruned = sk <= m ? min(slot[d * stride + sk] - base, o.r_cap) : o.r_cap;
      put(o, d, q, cm, make_float4(geo.x, geo.y, 0.0f, 0.0f), pruned);
    } else {  // header, then as many of its members as fit
      const int cnt = count[i], f = first[i];
      put(o, d, q, cm, make_float4(geo.x, geo.y, 1.0f, static_cast<float>(cnt)), q + 1 + cnt);
      const int last = min(cnt, o.r_cap - 1 - q);
      for (int j = 0; j < last; ++j)
        put(o, d, q + 1 + j, member(src_pos, src_mass, f + j),
            make_float4(0.0f, 1.0f, 1.0f, 0.0f), q + 2 + j);
    }
  }
}

__global__ void let_tail_kernel(const int* __restrict__ slot, int p, int stride, Out o,
                                int* __restrict__ n_rows, bool* __restrict__ overflow) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(p) * o.r_cap) return;
  const int d = static_cast<int>(t / o.r_cap);
  const int q = static_cast<int>(t - static_cast<long long>(d) * o.r_cap);
  // the exclusive sum at the segment's extra column: every row's slots
  const int total = slot[d * stride + stride - 1] - slot[d * stride];
  const int rows = min(total, o.r_cap);
  if (q == 0) {
    n_rows[d] = rows;
    overflow[d] = total > o.r_cap;
  }
  if (q >= rows)
    put(o, d, q, make_float4(kFar, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 1.0f, 0.0f),
        o.r_cap);
}

}  // namespace

// Bytes of scratch the two scans over `items` int32 need, into *bytes.
// Launches nothing. Returns a cudaError_t (0 = success).
extern "C" int let_export_temp_bytes(int items, int device, size_t* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t a = 0, b = 0;
  err = cub::DeviceScan::InclusiveScan(nullptr, a, static_cast<const int*>(nullptr),
                                       static_cast<int*>(nullptr), MaxOp(), items);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceScan::ExclusiveSum(nullptr, b, static_cast<const int*>(nullptr),
                                      static_cast<int*>(nullptr), items);
  *bytes = a > b ? a : b;
  return static_cast<int>(err);
}

// The export of one arena to p destination boxes, on `stream`.
// Arena: nodes (rows, 8) f32, skip/first/count (rows,) int32, num_nodes an
// int32 on the device; sources src_pos (n, 3), src_mass (n,) f32; boxes
// box_lo/box_hi (p, 3) f32; self_index the destination that gets only
// sentinel rows. Scratch: kind (p * (rows + 1)) bytes, scan_a and scan_b
// (p * (rows + 1)) int32, temp of temp_bytes (let_export_temp_bytes of
// p * (rows + 1)). Out: nodes (p, r_cap, 8) f32, skip/first/count
// (p, r_cap) int32, parts (p, r_cap, 4) f32, n_rows (p,) int32,
// overflow (p,) bool. The caller keeps p * (rows + 1 + n) below 2^31.
// Returns the first cudaError_t (0 = success).
extern "C" int let_export_launch(const void* nodes, const void* skip, const void* first,
                                 const void* count, const void* num_nodes, int rows,
                                 const void* src_pos, const void* src_mass,
                                 const void* box_lo, const void* box_hi, int p,
                                 int self_index, float theta, int r_cap, void* kind,
                                 void* scan_a, void* scan_b, void* temp, size_t temp_bytes,
                                 void* out_nodes, void* out_skip, void* out_first,
                                 void* out_count, void* out_parts, void* out_n_rows,
                                 void* out_overflow, int device, void* stream) {
  if (rows < 1 || p < 1 || r_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kBlock = 256;
  const int stride = rows + 1;
  const int items = p * stride;
  const int grid = (stride + kBlock - 1) / kBlock;
  auto* kinds = static_cast<unsigned char*>(kind);
  int* a = static_cast<int*>(scan_a);
  int* b = static_cast<int*>(scan_b);
  const auto* nodes4 = static_cast<const float4*>(nodes);
  const auto* skip_i = static_cast<const int*>(skip);
  const auto* count_i = static_cast<const int*>(count);
  const auto* m = static_cast<const int*>(num_nodes);

  let_classify_kernel<<<grid, kBlock, 0, s>>>(
      nodes4, skip_i, count_i, m, static_cast<const float*>(box_lo),
      static_cast<const float*>(box_hi), p, stride, theta, kinds, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  size_t tb = temp_bytes;
  err = cub::DeviceScan::InclusiveScan(temp, tb, a, b, MaxOp(), items, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  let_size_kernel<<<grid, kBlock, 0, s>>>(kinds, b, count_i, m, p, self_index, stride, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tb = temp_bytes;
  err = cub::DeviceScan::ExclusiveSum(temp, tb, a, b, items, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Out o{static_cast<float4*>(out_nodes), static_cast<int*>(out_skip),
        static_cast<int*>(out_first), static_cast<int*>(out_count),
        static_cast<float4*>(out_parts), r_cap};
  let_emit_kernel<<<grid, kBlock, 0, s>>>(
      nodes4, skip_i, static_cast<const int*>(first), count_i, m,
      static_cast<const float*>(src_pos), static_cast<const float*>(src_mass), kinds, a, b, p,
      stride, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(p) * r_cap;
  let_tail_kernel<<<static_cast<unsigned>((slots + kBlock - 1) / kBlock), kBlock, 0, s>>>(
      b, p, stride, o, static_cast<int*>(out_n_rows), static_cast<bool*>(out_overflow));
  return static_cast<int>(cudaGetLastError());
}
