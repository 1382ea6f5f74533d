// Per-particle Barnes-Hut theta walk for Hopper (sm_90a): one traversal per
// warp, each lane's own acceptance.
//
// Replaces the XLA while-loop wgpu_n_body_tpu/ops/tree_walk.py::tree_forces
// (the JAX package could not write it in Pallas: a TPU kernel cannot gather
// per lane). The plain torch version is ops/tree_walk.py::tree_forces; the
// wrapper is ops/tree_walk_cuda.py. It is the whole force of TreeSimHost and
// of TreeSim(walk="per_particle"), and the group walk's fallback over the
// receivers it defers (the same walk over a device list of warps that the
// group walk's lists kernels write).
//
// What every receiver computes is the stackless walk of the DFS arena:
//
//     cur = active ? 0 : num_nodes
//     while cur < num_nodes:
//         d = cog - p,  r2 = |d|^2,  dist = sqrt(r2)
//         accept (width < theta*dist):  acc += m*g*dt / (r2*dist + e) / dist * d,
//                                       cur = skip[cur]
//         terminal cell (no_child > 0): acc += the direct sum over the cell's
//                                       sorted sources [first, first + count),
//                                       self excluded by index; cur = skip[cur]
//         otherwise open:               cur = cur + 1
//
// What bounds it on H100: the special-function units, two MUFU ops per
// interaction (an rsqrt and the reciprocal of the divide) at 16 per SM per
// clock. What held the first version (one thread per receiver, each on its
// own chain) at 5% of that bound was not arithmetic: up to three dependent
// loads per lane and visit, an IEEE square root and two IEEE divides per
// interaction, and a member loop with a per-lane trip count, which the warp
// ran once for every lane that sat at a leaf while the others sat elsewhere.
//
// The design: the 32 receivers of a warp are Morton neighbours and visit
// nearly the same nodes (utils/tree_walk_study.py measures the union of
// their visits against one lane's own; PERF.md), so the warp walks the arena
// once. Each lane keeps `resume`, the node at which it is next interested: at
// the warp's node `cur` a lane is live iff cur >= resume. A live lane runs
// its own theta test. Accept: add the point-mass term, resume = skip[cur].
// Terminal cell that fails: add the cell's members, resume = skip[cur].
// Otherwise the lane wants the children. The warp goes to cur + 1 if any
// live lane wants the children, else to skip[cur] (every lane that is not
// live there accepted an ancestor, whose skip is no nearer). Every receiver
// so accepts and sums exactly the nodes and members the walk above gives it,
// in the same order, whatever its neighbours in the warp do: a row does not
// depend on which other receivers share its launch.
// - What a visit needs of a node is one 32-byte record, one sector: (cog,
//   mass*g*dt | width, skip, first, count and no_child), which
//   tree_walk_pack_kernel writes once per call from the arena's four arrays
//   (for the group walk, in the same pass, its [node | source] table: the
//   records' first halves and the source rows)
//   (a visit of those costs three sectors, and a 1M-node arena then 96 MB
//   of L2 instead of 32). The record is a warp-uniform load: one
//   transaction, not 32 chains. The next record is loaded once the vote
//   has picked it. A variant that loaded both candidates (cur + 1 and
//   skip[cur]) while `cur` was tested lost on an NVIDIA H100 80GB HBM3
//   (6.92 against 5.41 ms on the build kernels' arena, 8.96 against 6.94 ms
//   on the host-built one) and is gone: the loop is bound by the
//   instructions it issues (~45 per visit), not by the load's latency,
//   which the other warps hide.
// - A terminal cell's members are read once per warp (uniform 16-byte loads
//   of source rows that carry mass*g*dt: the [node | source] table's where
//   the caller holds it, else written by the pack kernel) and every lane
//   that needs them runs the same count: no divergent trip counts. The
//   self-masked loop runs only at the cells that hold one of the warp's own
//   receivers.
// - Weights go through csrc/pair_term.cuh (flush-to-zero rsqrt.approx and
//   div.approx, one MUFU each, as B1, B2 and B4's evaluation), and FMAs are
//   allowed: the file is built without -fmad=false.
// - The theta decision stays the plain version's bit for bit. Its first
//   guess shares the weight's rsqrt: t' = theta * (r2 * rsqrt(r2)) lies
//   within 6e-7 of the exact theta * sqrt(r2) (rsqrt.approx 2^-22.9, the
//   contracted r2 and three roundings), so a node whose width is further
//   than kMargin = 2e-6 (relative) from t' is decided. Inside the margin,
//   or where t' is NaN (r2 == 0), the lane recomputes with
//   __fmul_rn/__fadd_rn/__fsqrt_rn, which nvcc never contracts: r2
//   un-contracted, an IEEE square root, one multiply, as one torch kernel
//   per operation rounds.
// - Fill: a block is kBlock consecutive receivers, whose warps visit mostly
//   the same records, so all but the first find them in the SM's L1;
//   registers are capped so that kMinBlocks blocks are resident per SM. TMA,
//   clusters and tensor cores have nothing to offer a walk whose next
//   32-byte read depends on a vote, and are not used.
//
// An overfull max-depth cell (no_child == 2) is summed whole at its visit.
// The build clamps num_nodes to the arena and the pack kernel clamps every
// skip into (its node, the arena's last row], so an overflowed tree's walk
// stays inside the arena, moves forward and ends.

#include <cuda_runtime.h>

#include <type_traits>

#include "pair_term.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Launch shape, swept on an NVIDIA H100 80GB HBM3 by utils/tree_walk_study.py
// --sweep, which rebuilds a copy of this file with other values (PERF.md).
constexpr int kBlock = 128;     // threads per block
constexpr int kMinBlocks = 12;  // resident blocks per SM (register cap: 40)
constexpr int kUnroll = 4;      // member-loop unroll
constexpr int kPackBlock = 256;
// Relative distance from the first guess inside which the theta test is
// recomputed exactly (see the note above).
constexpr float kMargin = 2e-6f;

// One node as a visit reads it: two float4 of the packed arena.
struct Record {
  float4 cm;   // cog xyz, mass*g*dt
  float4 geo;  // width, and as bits: skip (clamped), first, (count << 2) | no_child
};

__device__ __forceinline__ Record load_record(const float4* __restrict__ rec, const int k) {
  return Record{__ldg(&rec[2 * k]), __ldg(&rec[2 * k + 1])};
}

// The arena's rows as records, (where tab is not null) the same rows as the
// node rows (cog, mass*g*dt) of the [node | source] table, and (where src is
// not null) the sorted sources as (position, mass*g*dt) rows. mass*g*dt is
// rounded once, as torch's multiply of a float32 tensor by the scalar gdt.
__global__ void __launch_bounds__(kPackBlock) tree_walk_pack_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ skip,
    const int* __restrict__ first, const int* __restrict__ count, float4* __restrict__ rec,
    float4* __restrict__ tab, const int rows, const float gdt,
    const float* __restrict__ src_pos, const float* __restrict__ src_mass,
    float4* __restrict__ src, const int n) {
  const int k = blockIdx.x * kPackBlock + threadIdx.x;
  if (k < rows) {
    const float4 cm = nodes[2 * k];    // cog xyz, mass
    const float4 geo = nodes[2 * k + 1];  // width, is_single, no_child, -
    const int no_child = geo.z > 1.5f ? 2 : (geo.z > 0.0f ? 1 : 0);
    // a walk at node k goes to k + 1 or to this: forward, and inside the arena
    const int next = max(min(skip[k], rows - 1), k + 1);
    const float4 row = make_float4(cm.x, cm.y, cm.z, __fmul_rn(cm.w, gdt));
    rec[2 * k] = row;
    rec[2 * k + 1] = make_float4(geo.x, __int_as_float(next), __int_as_float(first[k]),
                                 __int_as_float((count[k] << 2) | no_child));
    if (tab != nullptr) tab[k] = row;
  }
  if (src != nullptr && k < n)
    src[k] = make_float4(src_pos[3 * k], src_pos[3 * k + 1], src_pos[3 * k + 2],
                         __fmul_rn(src_mass[k], gdt));
}

// width < theta * sqrt(dx^2 + dy^2 + dz^2), rounded as the plain version.
__device__ __forceinline__ bool accept_exact(const float dx, const float dy, const float dz,
                                             const float width, const float theta) {
  const float r2 =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return width < __fmul_rn(theta, __fsqrt_rn(r2));
}

template <bool SELF>
__device__ __forceinline__ void sum_members(const float4* __restrict__ src, const int lo,
                                            const int hi, const int me, const float px,
                                            const float py, const float pz, const float e,
                                            float& ax, float& ay, float& az) {
#pragma unroll(kUnroll)
  for (int j = lo; j < hi; ++j)
    pair_term<SELF>(__ldg(&src[j]), px, py, pz, SELF && j == me, e, ax, ay, az);
}

// COUNTS also writes, per receiver, (accepted nodes, members summed, visits
// at which the lane was live, the warp's visits): the smoke's and the
// study's instantiation.
//
// Receivers: [0, b), each where active is null or active[i], a warp per 32
// consecutive ones; or, where warps is not null, a device list of warps:
// entry w is (first receiver, lane mask), lane l walking receiver first + l
// where bit l is set, and *n_warps entries are live (the group walk's lists
// kernels write both: the receivers of its dropped tiles, 32 consecutive
// ones of one tile per entry). A listed warp writes only its listed rows of
// out; the grid covers the list's capacity, and warps past the count return
// at once. Receiver i is source self_idx[i], or self_base + i where self_idx
// is null. Both modes run the one walk below: a row's bits do not depend on
// how its receiver was named.
template <bool COUNTS>
__global__ void __launch_bounds__(kBlock, kMinBlocks) tree_walk_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ rec,
    const float4* __restrict__ src, const int* __restrict__ num_nodes_ptr,
    const int* __restrict__ self_idx, const unsigned char* __restrict__ active,
    const int2* __restrict__ warps, const int* __restrict__ n_warps, const int self_base,
    float* __restrict__ out, int* __restrict__ counts, const int b, const int n, const int cap,
    const float theta, const float e) {
  int i = blockIdx.x * kBlock + threadIdx.x;
  bool mine;
  if (warps != nullptr) {
    const int w = i >> 5;  // one per warp
    if (w >= __ldg(n_warps)) return;
    const int2 entry = __ldg(&warps[w]);
    const int lane = threadIdx.x & 31;
    i = entry.x + lane;
    mine = (static_cast<unsigned>(entry.y) >> lane) & 1u;
  } else {
    mine = i < b && (active == nullptr || active[i]);
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  int n_far = 0, n_mem = 0, n_live = 0, n_warp = 0;
  if (__any_sync(kFull, mine)) {  // else: a warp of the deferred mask with nothing to walk
    const int num_nodes = min(__ldg(num_nodes_ptr), cap);
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    int me = -1;
    if (mine) {
      px = pos_new[3 * i + 0];
      py = pos_new[3 * i + 1];
      pz = pos_new[3 * i + 2];
      me = self_idx != nullptr ? self_idx[i] : self_base + i;
    }
    int resume = mine ? 0 : num_nodes;
    int cur = 0;
    Record a = load_record(rec, 0);  // row 0 exists: the arena has cap + 1 >= 1 rows
    while (cur < num_nodes) {
      const int n1 = cur + 1;                     // <= num_nodes <= cap: a row of the arena
      const int n2 = __float_as_int(a.geo.y);     // skip[cur], in (cur, cap]
      const bool live = cur >= resume;
      const float dx = a.cm.x - px;
      const float dy = a.cm.y - py;
      const float dz = a.cm.z - pz;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float inv_r = rsqrt_ftz(r2);
      const float t = theta * (r2 * inv_r);
      const float diff = a.geo.x - t;
      bool accept = diff < 0.0f;
      if (!(fabsf(diff) > kMargin * t)) accept = accept_exact(dx, dy, dz, a.geo.x, theta);
      const int cnt_nc = __float_as_int(a.geo.w);
      const bool terminal = (cnt_nc & 3) != 0;
      const bool far = live && accept;
      const bool near = live && !accept && terminal;
      const bool open = live && !accept && !terminal;
      if (far) {
        const float w = weight_from(a.cm.w, r2, inv_r, e);
        ax += w * dx;
        ay += w * dy;
        az += w * dz;
      }
      if (__any_sync(kFull, near)) {
        const int f = __float_as_int(a.geo.z);
        const int cnt = cnt_nc >> 2;
        const int lo = max(f, 0), hi = min(f + cnt, n);
        const bool own = near && static_cast<unsigned>(me - f) < static_cast<unsigned>(cnt);
        if (__any_sync(kFull, own)) {
          if (near) sum_members<true>(src, lo, hi, me, px, py, pz, e, ax, ay, az);
        } else {
          if (near) sum_members<false>(src, lo, hi, me, px, py, pz, e, ax, ay, az);
        }
        if (COUNTS && near) n_mem += cnt;
      }
      if (far || near) resume = n2;
      if (COUNTS) {
        n_far += far;
        n_live += live;
        ++n_warp;
      }
      cur = __any_sync(kFull, open) ? n1 : n2;
      a = load_record(rec, cur);
    }
  }
  // a receiver that is not active gets 0, as in the plain version; a listed
  // warp writes its listed rows only
  if (warps != nullptr ? mine : i < b) {
    out[3 * i + 0] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
    if (COUNTS) reinterpret_cast<int4*>(counts)[i] = make_int4(n_far, n_mem, n_live, n_warp);
  }
}

template <bool COUNTS, typename... Args>
cudaError_t launch_walk(int blocks, cudaStream_t stream, Args... args) {
  tree_walk_kernel<COUNTS><<<blocks, kBlock, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The arena as the walk reads it. nodes (rows, 8) f32; skip/first/count
// (rows,) int32; rec (rows, 8) f32 out; tab (rows, 4) f32 out, the node rows
// of the [node | source] table, or null; src_pos (n, 3), src_mass (n,) f32
// and src (n, 4) f32 out, or src null where the caller holds the source rows
// already (the table's source rows are src = tab + rows). count must stay
// below 2^29. Launches on `stream`, returns the cudaError_t of the launch (0
// on success), does not synchronise.
extern "C" int tree_walk_pack_launch(const void* nodes, const void* skip, const void* first,
                                     const void* count, void* rec, void* tab, int rows,
                                     float gdt, const void* src_pos, const void* src_mass,
                                     void* src, int n, int device, void* stream) {
  if (rows < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = src != nullptr && n > rows ? n : rows;
  tree_walk_pack_kernel<<<(items + kPackBlock - 1) / kPackBlock, kPackBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const int*>(skip),
      static_cast<const int*>(first), static_cast<const int*>(count), static_cast<float4*>(rec),
      static_cast<float4*>(tab), rows, gdt, static_cast<const float*>(src_pos),
      static_cast<const float*>(src_mass), static_cast<float4*>(src), n);
  return static_cast<int>(cudaGetLastError());
}

// pos_new (b, 3) f32 receivers; rec (rows, 8) f32 from tree_walk_pack_launch;
// src (n, 4) f32 sorted sources (position, mass*g*dt); num_nodes a device
// int32 scalar; self_idx (b,) int32, or null where receiver i is source i;
// active (b,) uint8 or null; out (b, 3) f32; counts (b, 4) int32 or null
// (null launches the instantiation without counts). Launches on `stream`,
// returns the cudaError_t of the launch (0 on success), does not
// synchronise.
extern "C" int tree_walk_launch(const void* pos_new, const void* rec, const void* src,
                                const void* num_nodes, const void* self_idx, const void* active,
                                void* out, void* counts, int b, int n, int rows, float theta,
                                float e, int device, void* stream) {
  if (b <= 0) return 0;
  if (rows < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b + kBlock - 1) / kBlock;
  const auto go = [&](auto with_counts) {
    return launch_walk<decltype(with_counts)::value>(
        blocks, static_cast<cudaStream_t>(stream), static_cast<const float*>(pos_new),
        static_cast<const float4*>(rec), static_cast<const float4*>(src),
        static_cast<const int*>(num_nodes), static_cast<const int*>(self_idx),
        static_cast<const unsigned char*>(active), static_cast<const int2*>(nullptr),
        static_cast<const int*>(nullptr), 0, static_cast<float*>(out),
        static_cast<int*>(counts), b, n, rows - 1, theta, e);
  };
  err = counts != nullptr ? go(std::true_type{}) : go(std::false_type{});
  return static_cast<int>(err);
}

// The listed receivers of pos_new (b, 3) f32: warps (capacity, 2) int32
// entries (first receiver, lane mask), of which the device int32 *n_warps
// are live; receiver i is source self_base + i; rec, src and num_nodes as
// for tree_walk_launch; out (b, 3) f32, of which only the listed rows are
// written. Launches the instantiation without counts on `stream`, one warp
// per entry of the capacity; returns the cudaError_t of the launch (0 on
// success), does not synchronise.
extern "C" int tree_walk_list_launch(const void* pos_new, const void* rec, const void* src,
                                     const void* num_nodes, const void* warps,
                                     const void* n_warps, int capacity, int self_base,
                                     void* out, int b, int n, int rows, float theta, float e,
                                     int device, void* stream) {
  if (capacity <= 0) return 0;
  if (rows < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kWarps = kBlock / 32;
  return static_cast<int>(launch_walk<false>(
      (capacity + kWarps - 1) / kWarps, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(pos_new), static_cast<const float4*>(rec),
      static_cast<const float4*>(src), static_cast<const int*>(num_nodes),
      static_cast<const int*>(nullptr), static_cast<const unsigned char*>(nullptr),
      static_cast<const int2*>(warps), static_cast<const int*>(n_warps), self_base,
      static_cast<float*>(out), static_cast<int*>(nullptr), b, n, rows - 1, theta, e));
}
