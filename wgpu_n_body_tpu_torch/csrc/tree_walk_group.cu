// Group (tile-shared) Barnes-Hut theta walk for Hopper (sm_90a): a walk
// kernel that writes each tile's interaction list, and an evaluation kernel
// that sums it.
//
// Replaces the XLA loops of wgpu_n_body_tpu/ops/tree_walk_group.py::
// group_tree_forces (skip engine, one pass; the JAX package could not write
// it in Pallas: a TPU kernel cannot gather per lane). The plain torch
// versions are ops/tree_walk_group.py::group_walk_lists (kernel a) and
// group_eval_lists (kernel b); the wrapper, ops/tree_walk_group_cuda.py,
// builds the tiles, launches both, and runs the per-particle fallback
// (csrc/tree_walk.cu) for what they defer.
//
// (a) group_lists_kernel: one warp per tile of at most walk_tile
//     Morton-adjacent receivers, four tiles per CTA. The warp reduces the
//     tile's bounding box and walks the DFS arena from the root without a
//     stack, as the JAX skip engine: per visited node
//       accept (width < theta * dmin(bbox, cog)): one row, id k, 1 step,
//           cur = skip[cur];
//       terminal cell that fails (no_child > 0): one row per member j, id
//           cap + 1 + j, one step each, cur = skip[cur];
//       internal node that fails: no row, 1 step, cur = cur + 1.
//     The ids index the combined table [node rows | source rows]. The
//     visited nodes of a stackless walk increase, so the warp reads the 32
//     nodes [cur, cur+32) at once: node k is visited iff no earlier node of
//     the window that jumps covers it (an exclusive prefix max of the jump
//     targets), and a prefix sum of the rows places each node's rows. The
//     whole warp then writes the window's rows, 32 consecutive ids per
//     store, finding each id's node by a binary search over the lanes'
//     offsets, so an opened cell costs one coalesced id per member.
//     Lists go to device memory in chunks of kChunk ids taken from a pool
//     with one atomic counter; the chunk table says where each tile's
//     chunks are. A tile whose steps exceed r_cap stops and is flagged bad;
//     one that finds the pool empty stops and is flagged pool_full; both are
//     deferred to the per-particle walk, and (a') and (b) read the two flags.
//     Step counts are exact.
//     Which tiles find the pool empty depends on the order in which warps
//     reach the counter, so the pool is sized to cover the lists of the
//     scenes measured (ops/tree_walk_group.py::pool_chunks).
//     At N=4M the lists are ~22M ids (87 MB): ~0.05 ms of HBM traffic each
//     way. The fused kernel these two replace kept the lists in shared
//     memory and made three warps of every CTA wait while one walked (half
//     of each tile's cycles, measured).
// (a') group_defer_kernel, launched with (a): the receivers (a) and the tile
//     set-up defer, as a device list for the per-particle walk
//     (csrc/tree_walk.cu's tree_walk_list_kernel): entries (first receiver,
//     lane mask) of 32 consecutive receivers of one piece, each tile's
//     taken with one atomic from a device counter. A warp reads the flags
//     and lengths of 32 tiles and lists, one tile after another, every
//     receiver of a dropped tile and, of the others, those the tile set-up
//     deferred. The set-up defers only receivers past walk_tile slots of a
//     piece and the spills it merges into the last tile, so only a piece
//     longer than walk_tile, or the last tile, reads its receivers' flags:
//     no pass over every receiver, and a step that defers none lists none.
//     It is its own kernel so that (a) keeps its registers (a tail in (a)
//     took it from 32 to 40, or spilled).
// (b) group_eval_kernel: one CTA of 128 threads per tile, receivers in
//     registers, tiles in tile order (heaviest list first did not pay for
//     its device sort at N=4M and lost on the disc scene: PERF.md). The list
//     streams through a ring of kStages shared-memory stages of kChunk rows:
//     each thread reads ids and issues 16-byte cp.async gathers of table rows
//     for a later stage while the CTA sums the current one. (TMA has no
//     gather mode and cp.async.bulk copies contiguous runs only, so a list of
//     scattered rows goes through cp.async.) While staging, each warp's
//     ballot marks the 32-row groups that hold a member of the tile's own
//     receivers: only those run the self-masked loop; every other group runs
//     the same arithmetic (pair_term) with no compare and no select.
//     The work follows the tile's receiver count, not walk_tile. A tile's
//     receivers are numbered in blocks of 32, one warp's width: block k
//     holds [32k, 32k + 32), and ceil(len / 32) blocks are live. Block k
//     goes to warp k % 4, in its register slot k / 4 (PER = 1, 2 or 4 slots
//     a thread: walk_tile <= 512), so the warps of a CTA differ by at most
//     one live block. A warp sums the list for its live slots only (the same
//     count for the whole warp, so the row loop is compiled for each count
//     and picked per stage without divergence); a warp with none stages its
//     share of rows and meets every barrier. Each receiver sums the same
//     rows in the same order through the same pair_term as when every slot
//     was summed, so its bits do not depend on the tile's length. Rotating
//     the blocks over the warps by tile index, to spread partial tiles over
//     the SM's four sub-partitions, measured 0.8-1.0% slower on an NVIDIA
//     H100 80GB HBM3 at N=4M on the disc scene (PERF.md). Under a profiler
//     the wrapper passes a counter that each CTA adds its computed pairs to
//     (rows x 32 x live blocks).
//
// Rounding: the theta test is written with __fmul_rn/__fadd_rn/__fsqrt_rn,
// so nvcc cannot contract it into FMAs and it rounds as the plain version
// (one torch kernel per operation) does: both walks open the same nodes,
// and the lists are equal id for id. The evaluation uses FMAs and the
// flush-to-zero forms of rsqrt and the approximate divide (one MUFU each,
// without the fix-ups for subnormal inputs that cost 7 of the fused
// kernel's 26 SASS instructions per pair): r2 and the denominator r2*r + e
// are normal unless two bodies lie within 1e-19 of each other. Its sums are
// compared with the plain version's to a tolerance.
//
// What bounds it on H100: (b) is special-function throughput, two MUFU
// ops per computed receiver-row pair (rsqrt; the reciprocal of the divide)
// at 16 per SM per clock: 1.0607e10 pairs with a receiver at N=4M uniform,
// 5.07 ms at 1980 MHz. Its loop issues ~16 instructions per pair, so issue
// (4 per SM per clock) binds about as tightly. The pairs it computes are
// the receivers' pairs rounded up to whole 32-receiver blocks (the last
// block of a tile is partial); a tile whose warps hold unequal numbers of
// live blocks (fewer than 128 receivers: some hold none) waits at each
// stage's barrier for its busiest warp, and only the other resident CTAs
// can take the idle warps' issue slots. (a) is latency: one dependent round of five loads per
// 32-node window, hidden by the ~64 walks resident per SM. PERF.md has
// the measurements.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "pair_term.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Launch shape, swept on an NVIDIA H100 80GB HBM3 (700 W) at N=4M uniform
// theta=0.75 (walk_tile 512) and N=2M disc theta=0.5 (walk_tile 256) by
// utils/group_walk_study.py --sweep, which rebuilds a copy of this file with
// other values of these constants (PERF.md): 2 stages with a cap of 4
// resident evaluation CTAs (126 registers at four receivers per thread) beat
// the other stage and CTA counts by ~3% at N=4M and tied on the disc; 256-row
// chunks and 4 warps per walk CTA were within ~2% of 128/512 and 2/8;
// unrolling 8 rows beat 2 and 4, and 32 at N=4M.
constexpr int kChunk = 256;     // ids per pool chunk == rows per ring stage
constexpr int kWalkWarps = 4;   // tiles per CTA of the walk kernel
constexpr int kMinBlocks = 4;   // resident evaluation CTAs per SM (register cap)
constexpr int kStages = 2;      // ring stages of kChunk rows
constexpr int kUnroll = 8;      // pair-loop unroll
constexpr int kBlock = 128;     // threads per evaluation CTA
constexpr int kMaxTile = 512;
static_assert(kBlock == 4 * 32, "the evaluation deals blocks of 32 receivers to four warps");

// ---- (a) the walk ----


__global__ void __launch_bounds__(kWalkWarps * 32) group_lists_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ nodes,
    const int* __restrict__ skip, const int* __restrict__ first,
    const int* __restrict__ count, const int* __restrict__ num_nodes_ptr,
    const int* __restrict__ piece_start, const int* __restrict__ piece_len,
    int* __restrict__ ids, int* __restrict__ pool_next, int n_chunks,
    int* __restrict__ chunks, int max_chunks, bool* __restrict__ tile_bad,
    int* __restrict__ tile_steps, int* __restrict__ tile_rows, bool* __restrict__ tile_full,
    int tiles, int g, int r_cap, int cap, float theta) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;  // whole warps
  const int len = min(piece_len[t], g);
  if (len <= 0) {  // an unused tile of the static budget
    if (lane == 0) {
      tile_bad[t] = tile_full[t] = false;
      tile_steps[t] = tile_rows[t] = 0;
    }
    return;
  }
  const int p0 = piece_start[t];

  // the tile's bounding box
  float bl[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float bh[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int s = lane; s < len; s += 32) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = pos_new[3 * (p0 + s) + c];
      bl[c] = fminf(bl[c], v);
      bh[c] = fmaxf(bh[c], v);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int o = 16; o > 0; o >>= 1) {
      bl[c] = fminf(bl[c], __shfl_xor_sync(kFull, bl[c], o));
      bh[c] = fmaxf(bh[c], __shfl_xor_sync(kFull, bh[c], o));
    }
  }

  const int num_nodes = __ldg(num_nodes_ptr);
  int* const my_chunks = chunks + static_cast<long long>(t) * max_chunks;
  int cur = 0, steps = 0, rows = 0;
  int have = 0, c_prev = -1, c_last = -1;  // chunks taken; the last two
  bool bad = false, full = false;
  while (cur < num_nodes) {
    // a window of 32 consecutive nodes from cur (cur itself is visited)
    const int k = cur + lane;
    const bool valid = k < num_nodes;
    float4 cm = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 geo = cm;
    int nskip = 0, nfirst = 0, ncnt = 0;
    if (valid) {
      cm = __ldg(&nodes[2 * k]);       // cog xyz, mass
      geo = __ldg(&nodes[2 * k + 1]);  // width, is_single, no_child, -
      nskip = __ldg(&skip[k]);
      nfirst = __ldg(&first[k]);
      ncnt = __ldg(&count[k]);
    }
    const float dx = fmaxf(fmaxf(bl[0] - cm.x, cm.x - bh[0]), 0.0f);
    const float dy = fmaxf(fmaxf(bl[1] - cm.y, cm.y - bh[1]), 0.0f);
    const float dz = fmaxf(fmaxf(bl[2] - cm.z, cm.z - bh[2]), 0.0f);
    const float d2 =
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    const bool accept = valid && geo.x < __fmul_rn(theta, __fsqrt_rn(d2));
    const bool terminal = valid && geo.z > 0.0f;
    const bool jump = accept || terminal;
    // visited iff no earlier jumping node of the window covers k
    int cover = jump ? nskip : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, cover, o);
      if (lane >= o) cover = max(cover, v);
    }
    int before = __shfl_up_sync(kFull, cover, 1);
    if (lane == 0) before = 0;
    const bool visited = valid && before <= k;
    const int cnt = max(ncnt, 1);
    const bool member = visited && !accept && terminal;
    const int my_rows = visited ? (accept ? 1 : (terminal ? cnt : 0)) : 0;
    const int my_steps = visited ? (member ? cnt : 1) : 0;
    steps += __reduce_add_sync(kFull, my_steps);
    if (steps > r_cap) {  // rows <= steps: the list never passes r_cap rows
      bad = true;
      break;
    }
    int incl = my_rows;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = incl - my_rows;
    const int wrows = __shfl_sync(kFull, incl, 31);
    const int base = accept ? k : cap + 1 + nfirst;  // the id of this lane's first row

    // the window's rows go to list positions [rows, rows + wrows), 32 at a
    // time; kChunk >= 32, so 32 positions span at most the last two chunks
    for (int q0 = 0; q0 < wrows; q0 += 32) {
      const int need = (rows + min(q0 + 32, wrows) - 1) / kChunk + 1;
      while (have < need) {
        int c = 0;
        if (lane == 0) c = atomicAdd(pool_next, 1);
        c = __shfl_sync(kFull, c, 0);
        if (c >= n_chunks) {
          full = true;
          break;
        }
        if (lane == 0) my_chunks[have] = c;
        c_prev = c_last;
        c_last = c;
        ++have;
      }
      if (full) break;
      const int q = q0 + lane;
      // the lane whose rows hold q: the last lane with excl <= q
      int src = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int e = __shfl_sync(kFull, excl, src + step);
        if (e <= q) src += step;
      }
      const int id0 = __shfl_sync(kFull, base, src);
      const int ex = __shfl_sync(kFull, excl, src);
      if (q < wrows) {
        const int at = rows + q;
        const int chunk = at / kChunk == have - 1 ? c_last : c_prev;
        ids[static_cast<long long>(chunk) * kChunk + at % kChunk] = id0 + (q - ex);
      }
    }
    if (full) break;
    rows += wrows;
    const int last = 31 - __clz(__ballot_sync(kFull, visited));
    cur = __shfl_sync(kFull, jump ? nskip : k + 1, last);
  }
  if (lane == 0) {
    tile_bad[t] = bad;
    tile_steps[t] = bad ? r_cap : steps;
    tile_rows[t] = rows;
    tile_full[t] = full;
  }
}

// ---- (a') the deferred list ----

// Lane mask of the deferred receivers among the 32 of the piece [p0, p0 +
// plen) from s0: all of them where the tile is dropped, else those the tile
// set-up deferred.
__device__ __forceinline__ unsigned deferred_lanes(bool dropped,
                                                   const bool* __restrict__ deferred, int p0,
                                                   int plen, int s0) {
  const int s = s0 + (threadIdx.x & 31);
  return __ballot_sync(kFull, s < plen && (dropped || deferred[p0 + s]));
}

// One warp per 32 tiles. A tile's entries go in piece order to positions
// taken with one atomicAdd on *defer_len. A list of ceil(n / 32) + tiles
// entries holds any tile set's: a piece of len receivers gives at most
// ceil(len / 32).
__global__ void __launch_bounds__(kWalkWarps * 32) group_defer_kernel(
    const int* __restrict__ piece_start, const int* __restrict__ piece_len,
    const bool* __restrict__ tile_bad, const bool* __restrict__ tile_full,
    const bool* __restrict__ deferred,
    int2* __restrict__ defer, int* __restrict__ defer_len, int tiles, int g) {
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * kWalkWarps + (threadIdx.x >> 5)) * 32;
  const int t = t0 + lane;
  bool dropped = false;
  int plen = 0;
  if (t < tiles) {
    dropped = tile_bad[t] || tile_full[t];
    plen = piece_len[t];
  }
  unsigned todo = __ballot_sync(kFull, t < tiles && (dropped || plen > g || t == tiles - 1));
  while (todo != 0) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const bool drop_k = __shfl_sync(kFull, dropped, k);
    const int len_k = __shfl_sync(kFull, plen, k);
    const int p0 = piece_start[t0 + k];
    int live = 0;
    for (int s0 = 0; s0 < len_k; s0 += 32)
      live += deferred_lanes(drop_k, deferred, p0, len_k, s0) != 0;
    if (live == 0) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(defer_len, live);
    at = __shfl_sync(kFull, at, 0);
    for (int s0 = 0; s0 < len_k; s0 += 32) {
      const unsigned lanes = deferred_lanes(drop_k, deferred, p0, len_k, s0);
      if (lanes == 0) continue;
      if (lane == 0) defer[at] = make_int2(p0 + s0, static_cast<int>(lanes));
      ++at;
    }
  }
}

// ---- (b) the evaluation ----

// One receiver-row pair is pair_term (csrc/pair_term.cuh, shared with the
// all-pairs kernels).
constexpr int kGroups = kChunk / 32;

// The rows of one ring stage (`groups` groups of 32) for a warp's first NQ
// register slots.
template <int NQ, int PER>
__device__ __forceinline__ void sum_stage(const float4* __restrict__ rows,
                                          const int* __restrict__ rid,
                                          const int* __restrict__ self, int groups,
                                          const float (&px)[PER], const float (&py)[PER],
                                          const float (&pz)[PER], const int (&me)[PER], float e,
                                          float (&ax)[PER], float (&ay)[PER], float (&az)[PER]) {
  for (int gr = 0; gr < groups; ++gr) {
    const float4* const g_rows = rows + gr * 32;
    if (self[gr]) {
      const int* const g_rid = rid + gr * 32;
#pragma unroll(kUnroll)
      for (int r = 0; r < 32; ++r) {
        const float4 s = g_rows[r];
        const int id = g_rid[r];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          pair_term<true>(s, px[q], py[q], pz[q], id == me[q], e, ax[q], ay[q], az[q]);
      }
    } else {
#pragma unroll(kUnroll)
      for (int r = 0; r < 32; ++r) {
        const float4 s = g_rows[r];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          pair_term<false>(s, px[q], py[q], pz[q], false, e, ax[q], ay[q], az[q]);
      }
    }
  }
}

// sum_stage for the warp's nq live slots (0 to PER; 0 sums nothing).
template <int PER, int NQ = PER>
__device__ __forceinline__ void sum_live(int nq, const float4* rows, const int* rid,
                                         const int* self, int groups, const float (&px)[PER],
                                         const float (&py)[PER], const float (&pz)[PER],
                                         const int (&me)[PER], float e, float (&ax)[PER],
                                         float (&ay)[PER], float (&az)[PER]) {
  if (nq == NQ) {
    sum_stage<NQ>(rows, rid, self, groups, px, py, pz, me, e, ax, ay, az);
  } else if constexpr (NQ > 1) {
    sum_live<PER, NQ - 1>(nq, rows, rid, self, groups, px, py, pz, me, e, ax, ay, az);
  }
}

template <int PER>
__global__ void __launch_bounds__(kBlock, kMinBlocks) group_eval_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ table,
    const int* __restrict__ ids, const int* __restrict__ chunks, int max_chunks,
    const int* __restrict__ tile_rows, const bool* __restrict__ tile_bad,
    const bool* __restrict__ tile_full, const int* __restrict__ piece_start, const int* __restrict__ piece_len,
    float* __restrict__ out, int g, int self_base, float e,
    unsigned long long* __restrict__ pairs) {
  __shared__ float4 s_row[kStages][kChunk];
  __shared__ int s_id[kStages][kChunk];
  __shared__ int s_self[kStages][kGroups];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int len = min(piece_len[t], g);
  if (len <= 0 || tile_bad[t] || tile_full[t]) return;  // empty, or deferred: B3 writes it
  const int p0 = piece_start[t];
  const int nrows = tile_rows[t];
  const int nst = (nrows + kChunk - 1) / kChunk;
  const int* const my_chunks = chunks + static_cast<long long>(t) * max_chunks;
  // ids of this tile's own receivers as sources: [lo, lo + len)
  const int lo = self_base + p0;
  // block k of 32 receivers goes to warp k % 4, slot k / 4: slot q of
  // thread tid holds receiver tid + 128 q; this warp's first nq slots are live
  const int live = (len + 31) >> 5;
  const int nq = min(PER, (live - (tid >> 5) + 3) >> 2);

  float px[PER], py[PER], pz[PER], ax[PER], ay[PER], az[PER];
  int me[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = tid + q * kBlock;
    const bool ok = s < len;
    const int i = p0 + (ok ? s : 0);
    px[q] = pos_new[3 * i + 0];
    py[q] = pos_new[3 * i + 1];
    pz[q] = pos_new[3 * i + 2];
    me[q] = ok ? lo + s : -2;  // -2 matches no id (pad rows are -1)
    ax[q] = ay[q] = az[q] = 0.0f;
  }

  // stage st of the list into ring slot st % kStages
  auto stage = [&](int st) {
    const int slot = st % kStages;
    const int* const src = ids + static_cast<long long>(my_chunks[st]) * kChunk;
#pragma unroll
    for (int r0 = 0; r0 < kChunk; r0 += kBlock) {
      const int r = r0 + tid;
      int id = -1;
      if (st * kChunk + r < nrows) {
        id = src[r];
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&s_row[slot][r]));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(table + id));
      } else {  // far and massless: adds exactly 0
        s_row[slot][r] = make_float4(1e15f, 0.0f, 0.0f, 0.0f);
      }
      s_id[slot][r] = id;
      const bool own = static_cast<unsigned>(id - lo) < static_cast<unsigned>(len);
      const unsigned any = __ballot_sync(kFull, own);
      if (lane == 0) s_self[slot][r >> 5] = any != 0;
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) stage(st);
    asm volatile("cp.async.commit_group;");
  }
  for (int st = 0; st < nst; ++st) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 2));
    __syncthreads();  // stage st is in; every thread is done with stage st - 1
    if (st + kStages - 1 < nst) stage(st + kStages - 1);
    asm volatile("cp.async.commit_group;");
    const int slot = st % kStages;
    const int groups = (min(kChunk, nrows - st * kChunk) + 31) >> 5;
    sum_live<PER>(nq, s_row[slot], s_id[slot], s_self[slot], groups, px, py, pz, me, e, ax, ay,
                  az);
  }

#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = tid + q * kBlock;
    if (s < len) {
      const int i = p0 + s;
      out[3 * i + 0] = ax[q];
      out[3 * i + 1] = ay[q];
      out[3 * i + 2] = az[q];
    }
  }
  if (pairs != nullptr && tid == 0)
    atomicAdd(pairs, static_cast<unsigned long long>(nrows) * 32ull * live);
}

// The narrowest instantiation that holds g receivers: PER = 1, 2 or 4.
template <int PER, typename... Args>
cudaError_t launch_eval(int tiles, int g, cudaStream_t stream, Args... args) {
  if constexpr (PER * kBlock < kMaxTile) {
    if (g > PER * kBlock) return launch_eval<2 * PER>(tiles, g, stream, args...);
  }
  group_eval_kernel<PER><<<tiles, kBlock, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// (a) pos_new (b, 3) f32 receivers; nodes (cap+1, 8) f32; skip/first/count
// (cap+1,) int32; num_nodes a device int32 scalar; piece_start/piece_len
// (tiles,) int32; ids (n_chunks * chunk,) int32 pool; pool_next a device
// int32 counter, zero; chunks (tiles, max_chunks) int32; tile_bad/tile_full
// (tiles,) bool, tile_steps/tile_rows (tiles,) int32 out; deferred (b,)
// bool, the tile set-up's; defer (ceil(b / 32) + tiles, 2) int32 out and
// defer_len a device int32 counter, zero: the deferred list (a'). g = walk_tile in [1, 512], chunk must equal kChunk. Launches (a)
// and (a') on `stream`, returns the cudaError_t of the launches (0 on
// success), does not synchronise.
extern "C" int group_lists_launch(const void* pos_new, const void* nodes, const void* skip,
                                  const void* first, const void* count, const void* num_nodes,
                                  const void* piece_start, const void* piece_len, void* ids,
                                  void* pool_next, int n_chunks, int chunk, void* chunks,
                                  int max_chunks, void* tile_bad, void* tile_steps,
                                  void* tile_rows, void* tile_full, const void* deferred,
                                  void* defer, void* defer_len, int tiles, int g, int r_cap,
                                  int cap, float theta, int device, void* stream) {
  if (tiles <= 0) return 0;
  if (g < 1 || g > kMaxTile || chunk != kChunk || max_chunks * kChunk < r_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (tiles + kWalkWarps - 1) / kWalkWarps;
  group_lists_kernel<<<blocks, kWalkWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_new), static_cast<const float4*>(nodes),
      static_cast<const int*>(skip), static_cast<const int*>(first),
      static_cast<const int*>(count), static_cast<const int*>(num_nodes),
      static_cast<const int*>(piece_start), static_cast<const int*>(piece_len),
      static_cast<int*>(ids), static_cast<int*>(pool_next), n_chunks,
      static_cast<int*>(chunks), max_chunks, static_cast<bool*>(tile_bad),
      static_cast<int*>(tile_steps), static_cast<int*>(tile_rows), static_cast<bool*>(tile_full),
      tiles, g, r_cap, cap, theta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kTilesPerBlock = kWalkWarps * 32;
  group_defer_kernel<<<(tiles + kTilesPerBlock - 1) / kTilesPerBlock, kWalkWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(piece_start), static_cast<const int*>(piece_len),
      static_cast<const bool*>(tile_bad), static_cast<const bool*>(tile_full),
      static_cast<const bool*>(deferred), static_cast<int2*>(defer), static_cast<int*>(defer_len), tiles, g);
  return static_cast<int>(cudaGetLastError());
}

// (b) pos_new (b, 3) f32 receivers (sorted slice starting at gid_offset);
// table (cap+1+n, 4) f32 [node cog, mass*g*dt | source position,
// mass*g*dt]; ids/chunks/tile_rows/tile_bad/tile_full from (a), a tile
// with either flag set deferred; out (b, 3) f32 (rows of deferred tiles are
// left unwritten). self_base = cap + 1 + gid_offset: the id of receiver 0 as a source. pairs: null, or a
// device uint64 that each evaluated tile adds rows x 32 x ceil(len / 32) to.
// Launches on `stream`, returns the cudaError_t of the launch, does not
// synchronise.
extern "C" int group_eval_launch(const void* pos_new, const void* table, const void* ids,
                                 const void* chunks, int max_chunks, const void* tile_rows,
                                 const void* tile_bad, const void* tile_full,
                                 const void* piece_start, const void* piece_len, void* out,
                                 int tiles, int g, int self_base, float e, void* pairs,
                                 int device, void* stream) {
  if (tiles <= 0) return 0;
  if (g < 1 || g > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_eval<1>(tiles, g, static_cast<cudaStream_t>(stream),
                       static_cast<const float*>(pos_new), static_cast<const float4*>(table),
                       static_cast<const int*>(ids), static_cast<const int*>(chunks), max_chunks,
                       static_cast<const int*>(tile_rows), static_cast<const bool*>(tile_bad),
                       static_cast<const bool*>(tile_full),
                       static_cast<const int*>(piece_start), static_cast<const int*>(piece_len),
                       static_cast<float*>(out), g, self_base, e,
                       static_cast<unsigned long long*>(pairs));
  return static_cast<int>(err);
}
