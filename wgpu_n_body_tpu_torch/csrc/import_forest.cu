// The fused LET walk's import forest (B8) for Hopper (sm_90a).
//
// Replaces wgpu_n_body_tpu/ops/import_octets.py:86 build_import_octets with
// wgpu_n_body_tpu/parallel/let_tree.py:729 compact_import_forest and the
// concatenations of sharded_tree.py:150-160 (XLA ops). The JAX fused walk
// packs the P import buffers slack-free and builds identity-mapped octet
// tables for them, which only its octet engine reads. The port's group walk
// is the skip engine for both engines (ROADMAP C), so what the fused walk
// needs is the layout alone: one forest
//
//   [local arena (base rows) | compacted import rows (cap_forest) | sentinel]
//
// whose local rows past num_nodes are inert rows that jump to the first
// import row (made anew: no walk reads them, so they are not copied) and
// whose import rows chain buffer to buffer, and one source table
//
//   [local sorted bodies (n_local) | one far massless row | compacted parts].
//
// import_forest_kernel, one thread per output row (a forest row and the
// source row of the same index). Every block computes the P buffers'
// extents and exclusive offsets, clamped to cap_forest, from imp.n_rows in
// shared memory (P is at most a few dozen: no host read, no scan kernel);
// a thread finds its buffer by a binary search over the P ends, then copies
// the row and rewrites its skip, first and count exactly as the plain
// version (parallel/let_tree.py::compact_import_forest,
// assemble_fused_forest) does: bit-equal outputs. The first P threads write
// the roots and extents, thread 0 num_nodes and the overflow flags.
//
// What bounds it on H100: bytes. It reads and writes each live local arena
// row and each kept import row once (32 + 12 bytes), each local body and
// kept part once (16 bytes), and writes the inert and sentinel rows
// without reading anything for them. Rows are copied as two 16-byte loads
// and stores per node, one per part; nothing is allocated here, nothing is
// read back.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 1024;
constexpr float kFar = 1e15f;

struct Local {  // the local arena and bodies
  const float4* nodes;
  const int* skip;
  const int* first;
  const int* count;
  const int* num_nodes;
  const bool* overflowed;
  int base;  // arena rows, its sentinel included
  const float* pos;
  const float* mass;
  int n;
};

struct Imports {  // the P import buffers of R rows
  const float4* nodes;
  const int* skip;
  const int* first;
  const int* count;
  const float4* parts;
  const int* n_rows;
  const bool* overflow;
  int p;
  int r_cap;
};

struct Out {
  float4* nodes;
  int* skip;
  int* first;
  int* count;
  int* num_nodes;
  bool* forest_overflowed;
  float* pos;
  float* mass;
  int* roots;
  int* extents;
  bool* overflow;
};

// The buffer holding compacted row jj < total: the first b with end_b > jj
// (searchsorted side="right"), at most p - 1.
__device__ int buffer_of(const int* end, int p, int jj) {
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end[mid] <= jj) lo = mid + 1; else hi = mid;
  }
  return min(lo, p - 1);
}

__global__ void __launch_bounds__(kThreads)
import_forest_kernel(Local l, Imports imp, int cap_forest, Out o, long long rows) {
  __shared__ int s_off[kMaxRanks], s_eff[kMaxRanks], s_end[kMaxRanks];
  __shared__ int s_total, s_over;
  const int p = imp.p;
  if (threadIdx.x == 0) s_over = 0;
  for (int b = threadIdx.x; b < p; b += blockDim.x) s_eff[b] = min(imp.n_rows[b], imp.r_cap);
  __syncthreads();
  for (int b = threadIdx.x; b < p; b += blockDim.x)
    if (imp.overflow[b]) s_over = 1;
  if (threadIdx.x == 0) {
    int acc = 0;  // the unclamped total: the wrapper keeps p * r_cap < 2^31
    for (int b = 0; b < p; ++b) {
      const int nb = s_eff[b];
      const int off = min(acc, cap_forest);
      const int eff = min(nb, cap_forest - off);
      s_off[b] = off;
      s_eff[b] = eff;
      s_end[b] = off + eff;
      acc += nb;
    }
    s_total = min(acc, cap_forest);
    if (acc > cap_forest) s_over = 1;
  }
  __syncthreads();

  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= rows) return;
  const int total = s_total;
  const int base = l.base;
  const int part_base = l.n + 1;
  if (j < base) {  // a local arena row
    const int k = static_cast<int>(j);
    if (k < *l.num_nodes) {
      o.nodes[2 * j] = l.nodes[2 * j];
      o.nodes[2 * j + 1] = l.nodes[2 * j + 1];
      o.skip[k] = l.skip[k];
      o.first[k] = l.first[k];
      o.count[k] = l.count[k];
    } else {  // past num_nodes: an inert row that jumps to the imports
      o.nodes[2 * j] = make_float4(kFar, 0.f, 0.f, 0.f);
      o.nodes[2 * j + 1] = make_float4(0.f, 0.f, 1.f, 0.f);
      o.skip[k] = base;
      o.first[k] = l.n;
      o.count[k] = 0;
    }
  } else if (j <= static_cast<long long>(base) + cap_forest) {  // an import or sentinel row
    const int k = static_cast<int>(j);
    const int jj = k - base;
    if (jj < total) {
      const int b = buffer_of(s_end, p, jj);
      const int off = s_off[b], eff = s_eff[b];
      const long long src = static_cast<long long>(b) * imp.r_cap + (jj - off);
      o.nodes[2 * j] = imp.nodes[2 * src];
      o.nodes[2 * j + 1] = imp.nodes[2 * src + 1];
      const int first = min(imp.first[src], eff);
      o.skip[k] = min(imp.skip[src], eff) + off + base;
      o.first[k] = first + off + part_base;
      o.count[k] = min(max(imp.count[src], 0), eff - first);
    } else {  // past the kept rows, and the final sentinel row
      o.nodes[2 * j] = make_float4(kFar, 0.f, 0.f, 0.f);
      o.nodes[2 * j + 1] = make_float4(0.f, 0.f, 1.f, 0.f);
      o.skip[k] = base + cap_forest;
      o.first[k] = part_base + (jj < cap_forest ? total : cap_forest);
      o.count[k] = 0;
    }
  }
  if (j < static_cast<long long>(part_base) + cap_forest) {  // a source row
    float4 v;
    if (j < l.n) {
      v = make_float4(l.pos[3 * j], l.pos[3 * j + 1], l.pos[3 * j + 2], l.mass[j]);
    } else if (j == l.n) {
      v = make_float4(kFar, kFar, kFar, 0.f);
    } else {
      const int jj = static_cast<int>(j) - part_base;
      if (jj < total) {
        const int b = buffer_of(s_end, p, jj);
        v = imp.parts[static_cast<long long>(b) * imp.r_cap + (jj - s_off[b])];
      } else {
        v = make_float4(kFar, kFar, kFar, 0.f);
      }
    }
    o.pos[3 * j] = v.x;
    o.pos[3 * j + 1] = v.y;
    o.pos[3 * j + 2] = v.z;
    o.mass[j] = v.w;
  }
  if (j < p) {
    o.roots[j] = s_off[j];
    o.extents[j] = s_eff[j];
  }
  if (j == 0) {
    *o.num_nodes = base + total;
    *o.overflow = s_over != 0;
    *o.forest_overflowed = s_over != 0 || *l.overflowed;
  }
}

}  // namespace

// Largest P the launcher takes (the per-buffer offsets live in shared memory).
extern "C" int import_forest_max_ranks() { return kMaxRanks; }

// The fused forest of one rank, on `stream`.
// Local: arena nodes (base, 8) f32, skip/first/count (base,) int32, num_nodes
// an int32 and overflowed a bool on the device; bodies pos (n, 3), mass (n,)
// f32. Imports: nodes (p, r_cap, 8) f32, skip/first/count (p, r_cap) int32,
// parts (p, r_cap, 4) f32, n_rows (p,) int32, overflow (p,) bool.
// Out: nodes (base + cap_forest + 1, 8) f32, skip/first/count (same rows)
// int32, num_nodes int32, forest_overflowed bool; sources pos
// (n + 1 + cap_forest, 3), mass (n + 1 + cap_forest,) f32; roots, extents
// (p,) int32; overflow bool. The caller keeps every count below 2^31.
// Returns the first cudaError_t (0 = success).
extern "C" int import_forest_launch(
    const void* l_nodes, const void* l_skip, const void* l_first, const void* l_count,
    const void* l_num_nodes, const void* l_overflowed, int base, const void* pos,
    const void* mass, int n, const void* i_nodes, const void* i_skip, const void* i_first,
    const void* i_count, const void* i_parts, const void* i_n_rows, const void* i_overflow,
    int p, int r_cap, int cap_forest, void* o_nodes, void* o_skip, void* o_first,
    void* o_count, void* o_num_nodes, void* o_forest_overflowed, void* o_pos, void* o_mass,
    void* o_roots, void* o_extents, void* o_overflow, int device, void* stream) {
  if (base < 1 || n < 0 || p < 1 || p > kMaxRanks || r_cap < 1 || cap_forest < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Local l{static_cast<const float4*>(l_nodes), static_cast<const int*>(l_skip),
                static_cast<const int*>(l_first), static_cast<const int*>(l_count),
                static_cast<const int*>(l_num_nodes), static_cast<const bool*>(l_overflowed),
                base, static_cast<const float*>(pos), static_cast<const float*>(mass), n};
  const Imports imp{static_cast<const float4*>(i_nodes), static_cast<const int*>(i_skip),
                    static_cast<const int*>(i_first), static_cast<const int*>(i_count),
                    static_cast<const float4*>(i_parts), static_cast<const int*>(i_n_rows),
                    static_cast<const bool*>(i_overflow), p, r_cap};
  const Out o{static_cast<float4*>(o_nodes), static_cast<int*>(o_skip),
              static_cast<int*>(o_first), static_cast<int*>(o_count),
              static_cast<int*>(o_num_nodes), static_cast<bool*>(o_forest_overflowed),
              static_cast<float*>(o_pos), static_cast<float*>(o_mass),
              static_cast<int*>(o_roots), static_cast<int*>(o_extents),
              static_cast<bool*>(o_overflow)};
  const long long forest_rows = static_cast<long long>(base) + cap_forest + 1;
  const long long source_rows = static_cast<long long>(n) + 1 + cap_forest;
  long long rows = forest_rows > source_rows ? forest_rows : source_rows;
  if (rows < p) rows = p;
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  import_forest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      l, imp, cap_forest, o, rows);
  return static_cast<int>(cudaGetLastError());
}
