// Group (tile-shared) Barnes-Hut theta walk for Hopper (sm_90a).
//
// Replaces the XLA loops of wgpu_n_body_tpu/ops/tree_walk_group.py::
// group_tree_forces (skip engine, one pass; the JAX package could not write
// it in Pallas: a TPU kernel cannot gather per lane). The plain torch
// version is ops/tree_walk_group.py::group_walk_tiles; the wrapper,
// ops/tree_walk_group_cuda.py, builds the tiles and runs the per-particle
// fallback (csrc/tree_walk.cu) for what this kernel defers.
//
// One CTA of 128 threads per tile of at most walk_tile Morton-adjacent
// receivers, held in registers (one to four per thread: walk_tile <= 512).
// The CTA reduces the tile's bounding box, then loops:
//
//   phase A (warp 0)  walk the DFS arena from the root, appending rows to
//                     a 1024-row interaction list in shared memory, until
//                     the list is full or the walk ends;
//   phase B (all)     every thread sums its receivers against the list;
//
// so the list never leaves the SM (the JAX package writes it to HBM and
// sorts it). Per visited node, as the JAX skip engine:
//   accept (width < theta * dmin(bbox, cog)): one point-mass row (cog, mass,
//       index -1), 1 step, cur = skip[cur];
//   terminal cell that fails (no_child > 0): one member row per particle
//       (position, mass, sorted index), one step each, cur = skip[cur];
//   internal node that fails: no row, 1 step, cur = cur + 1.
// A tile whose steps exceed r_cap stops and is flagged bad; the wrapper
// defers its receivers. Step counts are exact, so the flags and counts equal
// the plain version's integer for integer.
//
// Warp-parallel skip walk. The visited nodes of a stackless walk form an
// increasing sequence, so warp 0 reads the 32 nodes [cur, cur+32) at once
// and decides each node's accept/terminal test in parallel. Node k of the
// window is visited iff no earlier node j of the window that jumps (accepts
// or is terminal) covers it (skip[j] > k): an exclusive prefix max of those
// skip targets over the warp. An inclusive scan of the rows each visited
// node emits gives its place in the list; a window that does not fit stops
// at its first node that does not, and an opened terminal cell larger than
// the room left is streamed across flushes (`pending`).
//
// Rounding: the theta test is written with __fmul_rn/__fadd_rn/__fsqrt_rn,
// so nvcc cannot contract it into FMAs and it rounds as the plain version
// (one torch kernel per operation) does: both walks open the same nodes.
// Phase B may use FMAs, rsqrtf and __fdividef: its sums are compared with
// the plain version's to a tolerance (their order differs anyway).
//
// What bounds it on H100: phase B is FP32/SFU arithmetic, ~20 instructions
// and two MUFU ops (rsqrt, reciprocal) per receiver-row pair, with the row
// read once from shared memory as a broadcast for the whole CTA. Phase A
// is latency: one dependent round of global loads per 32-node window,
// walked by one warp while the CTA's other warps wait at the barrier; the
// other CTAs resident on the SM (6 or more, by the register cap) fill those
// gaps.
// Later work: overlap A and B inside the CTA (double-buffered lists and a
// producer warp), and order tiles by density for the tail.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Measured on an NVIDIA H100 80GB HBM3 (700 W) at N=4M uniform, walk_tile
// 512 (PERF.md): 128 threads, a 1024-row list and at least 6 resident CTAs
// per SM (80 registers; 11.7 ms) beat 256 or 64 threads, a 2048-row list,
// other register caps, and a double-buffered variant with a producer warp.
constexpr int kBlock = 128;  // threads per CTA
constexpr int kMinBlocks = 6;  // resident CTAs per SM the register budget allows
constexpr int kWarps = kBlock / 32;
constexpr int kList = 1024;  // rows of the shared-memory interaction list
constexpr unsigned kFull = 0xffffffffu;

template <int PER>
__global__ void __launch_bounds__(kBlock, kMinBlocks) group_walk_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ src,
    const float4* __restrict__ nodes, const int* __restrict__ skip,
    const int* __restrict__ first, const int* __restrict__ count,
    const int* __restrict__ num_nodes_ptr, const int* __restrict__ piece_start,
    const int* __restrict__ piece_len, float* __restrict__ out,
    int* __restrict__ tile_bad, int* __restrict__ tile_steps,
    int* __restrict__ tile_rows, int g, int r_cap, int gid_offset, float theta,
    float gdt, float e) {
  __shared__ float4 s_row[kList];
  __shared__ int s_gid[kList];
  __shared__ float s_part[kWarps][6];
  __shared__ float s_box[6];
  __shared__ int s_nrows;
  __shared__ int s_done;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(piece_len[t], g);
  if (len <= 0) {  // an unused tile of the static budget
    if (tid == 0) {
      tile_bad[t] = 0;
      tile_steps[t] = 0;
      tile_rows[t] = 0;
    }
    return;
  }
  const int p0 = piece_start[t];

  // ---- receivers in registers, and the tile's bounding box ----
  float px[PER], py[PER], pz[PER], ax[PER], ay[PER], az[PER];
  int me[PER];
  float bl[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float bh[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = tid + q * kBlock;
    const bool ok = s < len;
    const int i = p0 + (ok ? s : 0);
    px[q] = pos_new[3 * i + 0];
    py[q] = pos_new[3 * i + 1];
    pz[q] = pos_new[3 * i + 2];
    me[q] = ok ? gid_offset + i : -2;  // -2 matches no row (members >= 0, nodes -1)
    ax[q] = ay[q] = az[q] = 0.0f;
    if (ok) {
      bl[0] = fminf(bl[0], px[q]);
      bl[1] = fminf(bl[1], py[q]);
      bl[2] = fminf(bl[2], pz[q]);
      bh[0] = fmaxf(bh[0], px[q]);
      bh[1] = fmaxf(bh[1], py[q]);
      bh[2] = fmaxf(bh[2], pz[q]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int o = 16; o > 0; o >>= 1) {
      bl[c] = fminf(bl[c], __shfl_xor_sync(kFull, bl[c], o));
      bh[c] = fmaxf(bh[c], __shfl_xor_sync(kFull, bh[c], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_part[warp][c] = bl[c];
      s_part[warp][3 + c] = bh[c];
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < 3; ++c) {
      float a = s_part[0][c], b = s_part[0][3 + c];
      for (int w = 1; w < kWarps; ++w) {
        a = fminf(a, s_part[w][c]);
        b = fmaxf(b, s_part[w][3 + c]);
      }
      s_box[c] = a;
      s_box[3 + c] = b;
    }
  }
  __syncthreads();

  // ---- warp 0's walk state (uniform across its lanes) ----
  const float blx = s_box[0], bly = s_box[1], blz = s_box[2];
  const float bhx = s_box[3], bhy = s_box[4], bhz = s_box[5];
  const int num_nodes = __ldg(num_nodes_ptr);
  int cur = 0, koff = 0, steps = 0, rows_total = 0;
  bool pending = false, bad = false;

  while (true) {
    if (warp == 0) {
      // ---- phase A: fill the list ----
      int nrows = 0;
      bool done = false;
      while (true) {
        if (bad || cur >= num_nodes) {
          done = true;
          break;
        }
        const int room = kList - nrows;
        if (room == 0) break;
        if (pending) {  // stream the members of the opened terminal cell `cur`
          const int f = __ldg(&first[cur]);
          const int c = max(__ldg(&count[cur]), 1);
          const int take = min(c - koff, room);
          for (int m = lane; m < take; m += 32) {
            const int j = f + koff + m;
            s_row[nrows + m] = __ldg(&src[j]);
            s_gid[nrows + m] = j;
          }
          nrows += take;
          steps += take;
          koff += take;
          if (koff == c) {
            pending = false;
            koff = 0;
            cur = __ldg(&skip[cur]);
          }
          if (steps > r_cap) bad = true;
          continue;
        }
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
        const float dx = fmaxf(fmaxf(blx - cm.x, cm.x - bhx), 0.0f);
        const float dy = fmaxf(fmaxf(bly - cm.y, cm.y - bhy), 0.0f);
        const float dz = fmaxf(fmaxf(blz - cm.z, cm.z - bhz), 0.0f);
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
        int incl = my_rows;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const int excl = incl - my_rows;
        // the window stops at its first visited node whose rows do not fit
        const unsigned over = __ballot_sync(kFull, visited && incl > room);
        const int stop = over ? __ffs(over) - 1 : 32;
        const bool take = visited && lane < stop;
        if (take && my_rows > 0) {
          const int at = nrows + excl;
          if (accept) {
            s_row[at] = cm;
            s_gid[at] = -1;
          } else {
            for (int m = 0; m < cnt; ++m) {
              s_row[at + m] = __ldg(&src[nfirst + m]);
              s_gid[at + m] = nfirst + m;
            }
          }
        }
        steps += __reduce_add_sync(kFull, take ? my_steps : 0);
        if (stop < 32) {
          nrows += __shfl_sync(kFull, excl, stop);
          pending = __shfl_sync(kFull, member ? 1 : 0, stop) != 0;
          cur += stop;
        } else {
          nrows += __shfl_sync(kFull, incl, 31);
          const int last = 31 - __clz(__ballot_sync(kFull, visited));
          cur = __shfl_sync(kFull, jump ? nskip : k + 1, last);
        }
        if (steps > r_cap) bad = true;
      }
      rows_total += nrows;
      if (lane == 0) {
        s_nrows = bad ? 0 : nrows;
        s_done = done ? 1 : 0;
      }
    }
    __syncthreads();
    const int nr = s_nrows;
    const bool fin = s_done != 0;

    // ---- phase B: every receiver against the list ----
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const float4 s = s_row[r];
      const int gj = s_gid[r];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const float dx = s.x - px[q];
        const float dy = s.y - py[q];
        const float dz = s.z - pz[q];
        const float r2 = dx * dx + dy * dy + dz * dz;
        const bool self = gj == me[q];
        const float r2s = self ? 1.0f : r2;
        const float inv_r = rsqrtf(r2s);
        const float w = __fdividef(s.w * gdt * inv_r, r2s * (r2s * inv_r) + e);
        const float ws = self ? 0.0f : w;
        ax[q] += ws * dx;
        ay[q] += ws * dy;
        az[q] += ws * dz;
      }
    }
    __syncthreads();  // the list is refilled next
    if (fin) break;
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
  if (tid == 0) {
    tile_bad[t] = bad ? 1 : 0;
    tile_steps[t] = bad ? r_cap : steps;
    tile_rows[t] = rows_total;
  }
}

// The narrowest instantiation that holds g receivers: PER = 1, 2 or 4.
constexpr int kMaxTile = 4 * kBlock;

template <int PER, typename... Args>
cudaError_t launch(int tiles, int g, cudaStream_t stream, Args... args) {
  if constexpr (PER * kBlock < kMaxTile) {
    if (g > PER * kBlock) return launch<2 * PER>(tiles, g, stream, args...);
  }
  group_walk_kernel<PER><<<tiles, kBlock, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// pos_new (b, 3) f32 receivers (sorted slice starting at gid_offset); src
// (n, 4) f32 sorted sources (x, y, z, m); nodes (cap+1, 8) f32; skip/first/
// count (cap+1,) int32; num_nodes a device int32 scalar; piece_start/
// piece_len (tiles,) int32; out (b, 3) f32 (rows of deferred receivers are
// left unwritten); tile_bad/tile_steps/tile_rows (tiles,) int32. g =
// walk_tile in [1, 512]. Launches on `stream`, returns the cudaError_t of
// the launch (0 on success), does not synchronise.
extern "C" int tree_walk_group_launch(const void* pos_new, const void* src, const void* nodes,
                                      const void* skip, const void* first, const void* count,
                                      const void* num_nodes, const void* piece_start,
                                      const void* piece_len, void* out, void* tile_bad,
                                      void* tile_steps, void* tile_rows, int tiles, int g,
                                      int r_cap, int gid_offset, float theta, float gdt,
                                      float e, int device, void* stream) {
  if (tiles <= 0) return 0;
  if (g < 1 || g > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<1>(
      tiles, g, static_cast<cudaStream_t>(stream), static_cast<const float*>(pos_new),
      static_cast<const float4*>(src), static_cast<const float4*>(nodes),
      static_cast<const int*>(skip), static_cast<const int*>(first),
      static_cast<const int*>(count), static_cast<const int*>(num_nodes),
      static_cast<const int*>(piece_start), static_cast<const int*>(piece_len),
      static_cast<float*>(out), static_cast<int*>(tile_bad), static_cast<int*>(tile_steps),
      static_cast<int*>(tile_rows), g, r_cap, gid_offset, theta, gdt, e);
  return static_cast<int>(err);
}
