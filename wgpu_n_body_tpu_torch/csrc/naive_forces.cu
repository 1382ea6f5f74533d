// All-pairs softened gravity for Hopper (sm_90a): the dx-form (B1) and the
// factored form (B2) in one source, the accumulation form a template
// parameter.
//
// Replaces the TPU kernels wgpu_n_body_tpu/ops/naive_pallas.py::_kernel
// (entry naive_forces_pallas, mxu=False) and ::_kernel_mxu (mxu=True).
// Per receiver i and every source j != i (global index; receiver i is
// source row_offset + i):
//
//     d     = p_old_j - p_new_i,   r2 = |d|^2,   inv_r = rsqrt(r2)
//     w     = mgdt_j * inv_r / (r2 * (r2 * inv_r) + e)      mgdt_j = m_j * g * dt
//     dx-form:   acc_i += w * d
//     factored:  S_i += w * p_old_j,  Sw_i += w;  acc_i = S_i - p_new_i * Sw_i
//
// The factored sum carries |p_j| instead of |p_j - p_i| and is the less
// accurate one (about 2e-4 p99 relative error in f32,
// wgpu_n_body_tpu/params.py:56-62); the TPU put it on its matrix unit,
// which has no counterpart here worth using (a thin product, and TF32
// would break Precision.HIGHEST), so both forms are FP32 FMAs. Only the
// self pair is skipped; two distinct coincident particles give NaN
// (reference parity).
//
// What bounds it on H100: the special-function units. Every pair needs
// one rsqrt and one reciprocal (the divide) at 16 per SM per clock: at
// N=262144, 6.87e10 pairs take 32.9 ms at 1980 MHz. The pair term
// (csrc/pair_term.cuh: the flush-to-zero approximations of both, no
// subnormal fix-ups, FMAs) issues 15 SASS instructions per pair in the
// dx-form and 16 factored; with the loop, the load and the grouped sum the
// main loop issues 15.84 and 16.97 at four receivers per thread (PERF.md),
// against 4 issued per SM per clock, so issue binds about as tightly.
// Device memory does not: a source is 16 bytes, read once per CTA.
//
// What the design does about it:
// - Several receivers per thread (PER = 1, 2, 4 or 8, held in registers),
//   so each broadcast source load and the loop's bookkeeping serve PER
//   pairs; tile_i receivers per CTA, at most kBlock threads, and a
//   register cap that keeps kMinBlocks CTAs resident per SM.
// - Sources are contiguous, so they stream into a ring of kStages
//   shared-memory stages of kStage sources by 1-D bulk copies
//   (cp.async.bulk, one thread, completion on an mbarrier).
// - The self-mask compare runs only on stages that hold one of the CTA's
//   own receivers (row_offset included); every other stage runs the pair
//   term with no compare and no select.
// - Two-level summation: a partial per tile_j sources, then added to the
//   total, like the TPU kernel's per-block sum followed by out_ref[:] +=.
//   This keeps the f32 error at N=262144 near the TPU kernel's. tile_j is
//   independent of the stage size. Inside the partial, each group of
//   kGroup sources is summed apart first (sum_rows).
// - The source axis is split into `splits` slices (grid y) when the
//   receiver CTAs alone would leave resident slots empty, so small N
//   fills the card; the wrapper plans the split (ops/naive_cuda.py::
//   plan_launch) so that the last wave is full. Each slice writes its sum
//   to a scratch row, and naive_reduce_kernel adds the slices in slice
//   order (no atomics: a launch gives the same bits every time) and
//   resolves the factored form, as the TPU kernel's body does at its last
//   source tile.
// - The ragged edges are masked by loop bounds, not by sentinel padding.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_term.cuh"

namespace {

// Launch shape, swept on an NVIDIA H100 80GB HBM3 (700 W) by
// utils/naive_study.py --sweep, which rebuilds a copy of this file with
// other values of these constants (PERF.md). ops/naive_cuda.py plans the
// launch with the limits naive_forces_limits reports from them.
constexpr int kBlock = 128;     // most threads per CTA (launch bounds)
constexpr int kMinBlocks = 4;   // resident CTAs per SM (register cap)
constexpr int kStage = 256;     // sources per ring stage
constexpr int kStages = 4;      // ring stages
constexpr int kUnroll = 8;      // pair-loop unroll
constexpr int kGroup = 8;       // sources summed apart before joining the partial (0: off)

static_assert(kStages >= 2, "the ring needs two stages");

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0: the bulk copy of `len` sources into a stage, completing on `bar`.
__device__ __forceinline__ void bulk_stage(float4* to, const float4* from, int len,
                                           uint64_t* bar) {
  const unsigned bytes = static_cast<unsigned>(len) * sizeof(float4);
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem(to)), "l"(from), "r"(bytes), "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One source against the thread's PER receivers, summed into u.
template <bool FACTORED, bool SELF, int PER>
__device__ __forceinline__ void add_source(const float4 s, const int j, const int (&me)[PER],
                                           const float (&px)[PER], const float (&py)[PER],
                                           const float (&pz)[PER], const float e,
                                           float4 (&u)[PER]) {
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const bool self = SELF && j == me[q];
    if constexpr (FACTORED)
      pair_term_factored<SELF>(s, px[q], py[q], pz[q], self, e, u[q]);
    else
      pair_term<SELF>(s, px[q], py[q], pz[q], self, e, u[q].x, u[q].y, u[q].z);
  }
}

// n sources of a stage, the first with global index j0, against the
// thread's PER receivers; sums into t. Each group of kGroup sources is
// summed apart and then added to t, so t takes n / kGroup rounded adds
// instead of n: a force component that cancels to ~1e-3 of its terms keeps
// its f32 error near the plain version's (smoke phase 3a holds it to rtol
// 3e-5, atol 1e-9; one granule of 1000 sources in one sum used 0.99 of
// that, PERF.md).
template <bool FACTORED, bool SELF, int PER>
__device__ __forceinline__ void sum_rows(const float4* rows, const int n, const int j0,
                                         const int (&me)[PER], const float (&px)[PER],
                                         const float (&py)[PER], const float (&pz)[PER],
                                         const float e, float4 (&t)[PER]) {
  int k = 0;
  if constexpr (kGroup > 0) {
    for (; k + kGroup <= n; k += kGroup) {
      float4 u[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) u[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        add_source<FACTORED, SELF, PER>(rows[k + g], j0 + k + g, me, px, py, pz, e, u);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        t[q].x += u[q].x;
        t[q].y += u[q].y;
        t[q].z += u[q].z;
        if constexpr (FACTORED) t[q].w += u[q].w;
      }
    }
  }
#pragma unroll(kUnroll)
  for (; k < n; ++k) add_source<FACTORED, SELF, PER>(rows[k], j0 + k, me, px, py, pz, e, t);
}

// CTA (x, y): receivers [x * blockDim.x * PER, ...) against source slice y,
// [y * slice_len, min((y + 1) * slice_len, n_src)). Thread tid holds
// receivers x * blockDim.x * PER + q * blockDim.x + tid, q < PER. With
// partial == nullptr (one slice) it writes the force to out; otherwise the
// slice's float4 sum to partial[y * n_recv + i].
template <bool FACTORED, int PER>
__global__ void __launch_bounds__(kBlock, kMinBlocks) naive_forces_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ src, float* __restrict__ out,
    float4* __restrict__ partial, int n_recv, int n_src, int row_offset, float e, int tile_j,
    int slice_len) {
  __shared__ float4 ring[kStages][kStage];  // 16-byte aligned, as the bulk copy needs
  __shared__ uint64_t bar[kStages];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int i0 = blockIdx.x * nt * PER;
  const int j_begin = blockIdx.y * slice_len;
  const int j_end = min(n_src, j_begin + slice_len);
  const int nst = (j_end - j_begin + kStage - 1) / kStage;
  // global source rows of this CTA's receivers: [g0, g1)
  const int g0 = row_offset + i0;
  const int g1 = row_offset + min(i0 + nt * PER, n_recv);

  float px[PER], py[PER], pz[PER];
  int me[PER];
  float4 t[PER], a[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + q * nt + tid;
    const bool ok = i < n_recv;
    const int r = ok ? i : 0;
    px[q] = pos_new[3 * r + 0];
    py[q] = pos_new[3 * r + 1];
    pz[q] = pos_new[3 * r + 2];
    me[q] = ok ? row_offset + i : -1;  // -1 matches no source
    t[q] = a[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  auto stage_len = [&](int st) { return min(kStage, j_end - (j_begin + st * kStage)); };
  auto stage_src = [&](int st) { return src + j_begin + st * kStage; };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&bar[s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < min(kStages, nst); ++st)
      bulk_stage(ring[st], stage_src(st), stage_len(st), &bar[st]);

  int flush = min(j_begin + tile_j, j_end);  // the end of the current tile_j granule
  for (int st = 0; st < nst; ++st) {
    const int slot = st % kStages;
    bar_wait(&bar[slot], (st / kStages) & 1);
    const int s0 = j_begin + st * kStage;
    const int len = stage_len(st);
    const bool own = s0 < g1 && g0 < s0 + len;  // the stage holds one of this CTA's receivers
    for (int k = 0; k < len;) {
      const int seg = min(len - k, flush - (s0 + k));  // up to the granule's end
      if (own)
        sum_rows<FACTORED, true, PER>(ring[slot] + k, seg, s0 + k, me, px, py, pz, e, t);
      else
        sum_rows<FACTORED, false, PER>(ring[slot] + k, seg, s0 + k, me, px, py, pz, e, t);
      k += seg;
      if (s0 + k == flush) {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          a[q].x += t[q].x;
          a[q].y += t[q].y;
          a[q].z += t[q].z;
          a[q].w += t[q].w;
          t[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        flush = min(flush + tile_j, j_end);
      }
    }
    __syncthreads();  // every thread is done with this slot
    if (tid == 0 && st + kStages < nst)
      bulk_stage(ring[slot], stage_src(st + kStages), stage_len(st + kStages), &bar[slot]);
  }

#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + q * nt + tid;
    if (i >= n_recv) continue;
    if (partial != nullptr) {
      partial[static_cast<long long>(blockIdx.y) * n_recv + i] = a[q];
    } else if (FACTORED) {
      out[3 * i + 0] = a[q].x - px[q] * a[q].w;
      out[3 * i + 1] = a[q].y - py[q] * a[q].w;
      out[3 * i + 2] = a[q].z - pz[q] * a[q].w;
    } else {
      out[3 * i + 0] = a[q].x;
      out[3 * i + 1] = a[q].y;
      out[3 * i + 2] = a[q].z;
    }
  }
}

// The slices' sums of each receiver, added in slice order, resolved.
template <bool FACTORED>
__global__ void naive_reduce_kernel(const float4* __restrict__ partial,
                                    const float* __restrict__ pos_new, float* __restrict__ out,
                                    int n_recv, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_recv) return;
  float4 a = partial[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = partial[static_cast<long long>(s) * n_recv + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  if (FACTORED) {
    out[3 * i + 0] = a.x - pos_new[3 * i + 0] * a.w;
    out[3 * i + 1] = a.y - pos_new[3 * i + 1] * a.w;
    out[3 * i + 2] = a.z - pos_new[3 * i + 2] * a.w;
  } else {
    out[3 * i + 0] = a.x;
    out[3 * i + 1] = a.y;
    out[3 * i + 2] = a.z;
  }
}

template <bool FACTORED>
int launch(const void* pos_new, const void* src, void* out, void* partial, int n_recv, int n_src,
           int row_offset, float e, int tile_j, int threads, int per, int ctas, int splits,
           int slice_len, int device, void* stream) {
  if (n_recv <= 0) return 0;
  const bool shape_ok =
      threads >= 1 && threads <= kBlock && tile_j >= 1 && splits >= 1 && slice_len >= 1 &&
      static_cast<long long>(ctas) * threads * per >= n_recv &&
      static_cast<long long>(ctas - 1) * threads * per < n_recv &&
      static_cast<long long>(splits) * slice_len >= n_src &&
      (splits == 1 || static_cast<long long>(splits - 1) * slice_len < n_src) &&
      (splits == 1 || partial != nullptr);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas, splits);
  auto* p = static_cast<const float*>(pos_new);
  auto* f4 = static_cast<const float4*>(src);
  auto* o = static_cast<float*>(out);
  auto* part = splits > 1 ? static_cast<float4*>(partial) : nullptr;
#define NAIVE_LAUNCH(PER)                                                               \
  naive_forces_kernel<FACTORED, PER><<<grid, threads, 0, s>>>(p, f4, o, part, n_recv, n_src, \
                                                              row_offset, e, tile_j, slice_len)
  switch (per) {
    case 1: NAIVE_LAUNCH(1); break;
    case 2: NAIVE_LAUNCH(2); break;
    case 4: NAIVE_LAUNCH(4); break;
    case 8: NAIVE_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NAIVE_LAUNCH
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  naive_reduce_kernel<FACTORED><<<(n_recv + 255) / 256, 256, 0, s>>>(part, p, o, n_recv, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool FACTORED>
int limits(int device, int* block, int* stage, int* per, int* resident) {
  const void* kernels[] = {reinterpret_cast<const void*>(&naive_forces_kernel<FACTORED, 1>),
                           reinterpret_cast<const void*>(&naive_forces_kernel<FACTORED, 2>),
                           reinterpret_cast<const void*>(&naive_forces_kernel<FACTORED, 4>),
                           reinterpret_cast<const void*>(&naive_forces_kernel<FACTORED, 8>)};
  *block = kBlock;
  *stage = kStage;
  cudaError_t err = cudaSetDevice(device);
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    per[k] = 1 << k;  // the cases of launch's switch
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[k], kernels[k], kBlock, 0);
  }
  return static_cast<int>(err);
}

}  // namespace

// pos_new (n_recv, 3) float32 receivers; src (n_src, 4) float32 rows
// (x, y, z, mgdt); out (n_recv, 3) float32; partial (splits, n_recv, 4)
// float32 scratch, unused (may be null) when splits == 1; all on CUDA
// device `device`. The launch plan (threads <= 128 per CTA, per receivers
// per thread in {1, 2, 4, 8}, ctas, splits, slice_len) comes from
// ops/naive_cuda.py::plan_launch; tile_j is the summation granule. Launches
// on `stream` (the slices' reduction after the main kernel when
// splits > 1) and returns the cudaError_t of the launches (0 on success).
// Does not synchronise.
extern "C" int naive_forces_launch(const void* pos_new, const void* src, void* out,
                                   void* partial, int n_recv, int n_src, int row_offset, float e,
                                   int tile_j, int threads, int per, int ctas, int splits,
                                   int slice_len, int device, void* stream) {
  return launch<false>(pos_new, src, out, partial, n_recv, n_src, row_offset, e, tile_j, threads,
                       per, ctas, splits, slice_len, device, stream);
}

// The factored form (B2); the same arguments.
extern "C" int naive_forces_mxu_launch(const void* pos_new, const void* src, void* out,
                                       void* partial, int n_recv, int n_src, int row_offset,
                                       float e, int tile_j, int threads, int per, int ctas,
                                       int splits, int slice_len, int device, void* stream) {
  return launch<true>(pos_new, src, out, partial, n_recv, n_src, row_offset, e, tile_j, threads,
                      per, ctas, splits, slice_len, device, stream);
}

// The limits ops/naive_cuda.py::plan_launch plans with, for the form
// `factored` on CUDA device `device`: most threads per CTA (*block), the
// sources of one ring stage (*stage, the fewest a slice holds), and for
// each of the 4 receivers-per-thread instantiations per[k], the CTAs of
// *block threads one SM holds at once (resident[k]). Returns the
// cudaError_t of the queries (0 on success).
extern "C" int naive_forces_limits(int factored, int device, int* block, int* stage, int* per,
                                   int* resident) {
  return factored ? limits<true>(device, block, stage, per, resident)
                  : limits<false>(device, block, stage, per, resident);
}
