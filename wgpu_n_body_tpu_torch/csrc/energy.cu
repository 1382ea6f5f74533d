// The potential energy sum_{i<j} -g m_i m_j I(r_ij) for Hopper (sm_90a): E1.
//
// Replaces wgpu_n_body_tpu/ops/energy.py:62 potential_energy (an XLA
// lax.map over blocks of receiver rows, whose elementwise body XLA fuses
// into the reduction). The port's plain version
// (ops/energy.py::potential_energy_plain) forms the same block of
// differences in device memory; at N=4M that is tens of GB per block, so
// on the card the sum runs here, with no (rows x sources) tensor at all.
//
// Pair term, float32, in two pieces split at r_s = 3a, a = e^(1/3), with
// every constant computed on the host in double (ops/energy.py
// pair_constants, the Consts below; split_pair_integral is a float32
// mirror for the CPU tests):
//
//   far,  r^2 >= r_s^2: the exact series of I(r) = INT_r^inf ds/(s^3 + e)
//       in u = e r^-3 (<= 1/27), e folded into its coefficients,
//       ri = rsqrt(r^2),  t = ri^3,
//       I = ri^2 sum_{k<kTerms} c_k t^k,  c_k = (-e)^k / (3k + 2)
//       (the terms left out are under 8.3e-9 of I at kTerms = 5);
//   near, r^2 <  r_s^2: the closed form of softened_pair_integral,
//       x  = r (2 / (a sqrt3)) - 1 / sqrt3       (x <= 5 / sqrt3)
//       I  = ln(num * (1 / den)) / (6 a^2) + (pi/2 - arctan(x)) / (a^2 sqrt3),
//       num = r^2 - a r + a^2, den = (r + a)^2,
//
// or 1/r = rsqrtf(r^2) with SOFTENED false. Only i < j counts: on the
// diagonal tile a receiver drops the sources up to itself (I(0) is finite,
// so i == j must be dropped, not masked by the value).
//
// What bounds it on H100: instruction issue. The closed form's two terms are
// each about 1/(2 a r) and cancel to about 1/(2 r^2), so it needs the
// accurate sqrtf, logf and atanf (four MUFU ops and their range reductions
// and slow-path checks: ~120 SASS instructions a pair) only to throw most
// of their digits away; the series gets the same I with one MUFU (MUFU.RSQ,
// flush-to-zero: the far loop takes it at max(r^2, r_s^2), never
// subnormal) and 14 FP32 instructions (21 flops), and is the more accurate
// of the two there. ~0.14% of a uniform cube's pairs at the default
// e = 1e-4 fall inside r_s, but a warp whose lanes split would run both.
// Device memory is nothing (16 bytes per body per tile pair, reused by 256
// receivers). No --use_fast_math (ops/cuda_build.py BASE_FLAGS): the near
// field keeps the accurate functions and an IEEE reciprocal.
//
// What the design does about it:
// - Only the upper triangle of (receiver tile, source tile) pairs, tiles
//   of kTile bodies, numbered row by row: a full i != j sum halved would
//   double the work. A launch takes the tile pairs [lo, hi) of its share
//   (ops/energy.py::share_range); the share splits tile pairs, not rows,
//   because row 0 has N-1 partners and row N-1 none.
// - One block per resident slot (persistent), each over an equal run of
//   the share's tile pairs: kPerThread = 4 receivers per thread in
//   registers (64 threads a block), reloaded when the run enters the next
//   row; the source tile staged in shared memory as float4 (x, y, z, m),
//   read as broadcasts, each shared by the thread's four pairs. Four
//   receivers and eight sources a trip were the fastest of 1, 2, 4, 8 and
//   of 4, 8, 16, 32 in turns on the card (PERF.md).
// - No branch on the far path: every pair takes the series at
//   max(r^2, r_s^2) (a near pair adds I(r_s)), and the sign bit of
//   r^2 - r_s^2 is shifted into a word per 32 sources (a funnel shift: one
//   instruction), kept in shared memory, the thread's own. After the stage
//   each thread adds the closed form less I(r_s) of its marked pairs, of
//   all its receivers in one loop. A warp runs the closed form as often as
//   its busiest lane has near pairs in the stage (~3 in a uniform scene's
//   random order) instead of once per source that any lane finds near, for
//   each receiver slot (~24).
// - Sources past the last body are staged massless at infinity (r^2 = inf:
//   I = 0, never near), so every stage is a full tile of kTile sources.
// - Two-level summation (B1's, csrc/naive_forces.cu): each thread sums its
//   m_j I(r) over one source tile in float32, then adds m_i times that
//   partial to a float64 total.
// - Each block writes its float64 total to scratch; energy_sum_kernel adds
//   them in block order. No float atomics: two launches give the same bits.
// - Tile pairs, rows and pair counts are int64 (N=262144 has 3.4e10 pairs).

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_term.cuh"  // rsqrt_ftz

namespace {

constexpr int kTile = 256;  // receivers per block = sources per stage
constexpr int kPerThread = 4;  // receivers per thread
constexpr int kThreads = kTile / kPerThread;
constexpr int kWords = kTile / 32;  // near-pair bit words per receiver and stage
constexpr int kTerms = 5;  // ops/energy.py TERMS
constexpr int kSumThreads = 256;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInf = __builtin_huge_valf();
static_assert(kTile % kPerThread == 0 && kThreads % 32 == 0, "whole warps of receivers");
static_assert(kPerThread * kWords <= 32, "one summary bit per near-pair word");

// ops/energy.py PairConstants, field by field.
struct Consts {
  float rs2;             // r_s^2
  float series[kTerms];  // (-e)^k / (3k + 2)
  float a, a2;           // e^(1/3), a^2
  float x_scale;         // 2 / (a sqrt3)
  float x_shift;         // 1 / sqrt3
  float inv_log;         // 1 / (6 a^2)
  float inv_at;          // 1 / (a^2 sqrt3)
};
constexpr int kConsts = sizeof(Consts) / sizeof(float);

// I(r) for r^2 >= r_s^2: one MUFU, the rest FP32.
__device__ __forceinline__ float far_integral(const float r2, const Consts& c) {
  const float ri = rsqrt_ftz(r2);
  const float ri2 = ri * ri;
  const float t = ri2 * ri;  // e is in the coefficients
  float p = c.series[kTerms - 1];
#pragma unroll
  for (int k = kTerms - 2; k >= 0; --k) p = fmaf(p, t, c.series[k]);
  return ri2 * p;
}

// I(r) for r^2 < r_s^2: the closed form, no division by a constant.
__device__ __forceinline__ float near_integral(const float r2, const Consts& c) {
  const float r = sqrtf(r2);
  const float at = kHalfPi - atanf(fmaf(r, c.x_scale, -c.x_shift));
  const float num = fmaf(r, r - c.a, c.a2);
  const float ra = r + c.a;
  const float log_term = logf(num * __frcp_rn(ra * ra));
  return fmaf(log_term, c.inv_log, at * c.inv_at);
}

// Row start of the triangle: tile pair (a, a) is number a*nt - a(a-1)/2.
__device__ __forceinline__ long long row_start(long long a, long long nt) {
  return a * nt - a * (a - 1) / 2;
}

// (a, b) of tile pair t: a float64 root, then whole-row corrections
// (ops/energy.py::tile_pair is the same).
__device__ void tile_pair(long long t, long long nt, long long& a, long long& b) {
  const double w = 2.0 * static_cast<double>(nt) + 1.0;
  const double disc = fmax(w * w - 8.0 * static_cast<double>(t), 0.0);
  a = static_cast<long long>((w - sqrt(disc)) * 0.5);
  a = a < 0 ? 0 : (a > nt - 1 ? nt - 1 : a);
  while (a + 1 < nt && row_start(a + 1, nt) <= t) ++a;
  while (row_start(a, nt) > t) --a;
  b = a + t - row_start(a, nt);
}

// part[q] += sum over the stage's kTile sources k of m_k I(|s_k - p_q|) for
// the thread's receivers q (tile slot tid + q kThreads); on the diagonal
// tile (DIAG) only the sources past each receiver (k > its slot: the others
// are taken at r^2 = inf, I = 0). Every pair first takes the series at
// max(r^2, r_s^2), a near pair so adding I(r_s), and the sign of
// r^2 - r_s^2 is shifted into a bit word per 32 sources (this thread's own
// words of near_bits); then each thread walks its set bits and adds the
// closed form less I(r_s) for those pairs. No branch on the far path.
template <bool SOFTENED, bool DIAG>
__device__ __forceinline__ void tile_sum(const float4* src, unsigned* near_bits, const int tid,
                                         const float (&px)[kPerThread],
                                         const float (&py)[kPerThread],
                                         const float (&pz)[kPerThread], const Consts& c,
                                         float (&part)[kPerThread]) {
  for (int w = 0; w < kWords; ++w) {
    unsigned bits[kPerThread];  // bit 31 - j: source 32 w + j is near receiver q
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) bits[q] = 0u;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int k = 32 * w + j;
      const float4 s = src[k];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const float dx = s.x - px[q], dy = s.y - py[q], dz = s.z - pz[q];
        float r2 = dx * dx + dy * dy + dz * dz;
        if (DIAG && k <= tid + q * kThreads) r2 = kInf;
        if constexpr (SOFTENED) {
          part[q] = fmaf(s.w, far_integral(fmaxf(r2, c.rs2), c), part[q]);
          bits[q] = __funnelshift_l(__float_as_uint(r2 - c.rs2), bits[q], 1);
        } else {
          part[q] = fmaf(s.w, rsqrtf(r2), part[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) near_bits[(q * kWords + w) * kThreads + tid] = bits[q];
  }
  if constexpr (SOFTENED) {
    // one loop over all of the thread's near pairs, whichever receiver they
    // belong to: a warp runs it as often as its busiest lane has near pairs,
    // not once per receiver slot for that slot's busiest lane
    const float i_s = far_integral(c.rs2, c);  // what the clamped series added
    unsigned nz = 0u;  // bit q kWords + w: word w of receiver q has a near pair
#pragma unroll
    for (int k = 0; k < kPerThread * kWords; ++k)
      nz |= static_cast<unsigned>(near_bits[k * kThreads + tid] != 0u) << k;
    unsigned b = 0u;
    int word = 0;
    while (b != 0u || nz != 0u) {
      if (b == 0u) {  // the next word that holds a near pair
        word = __ffs(nz) - 1;
        nz &= nz - 1u;
        b = near_bits[word * kThreads + tid];
      }
      const int j = __clz(b);
      b ^= 0x80000000u >> j;
      const int q = word / kWords;
      const float4 s = src[32 * (word % kWords) + j];
      float x = px[0], y = py[0], z = pz[0];
#pragma unroll
      for (int p = 1; p < kPerThread; ++p) {
        x = q == p ? px[p] : x;
        y = q == p ? py[p] : y;
        z = q == p ? pz[p] : z;
      }
      const float dx = s.x - x, dy = s.y - y, dz = s.z - z;
      const float term = near_integral(dx * dx + dy * dy + dz * dz, c) - i_s;
#pragma unroll
      for (int p = 0; p < kPerThread; ++p)
        if (q == p) part[p] = fmaf(s.w, term, part[p]);
    }
  }
}

template <bool SOFTENED>
__global__ void __launch_bounds__(kThreads) energy_kernel(const float* __restrict__ pos,
                                                          const float* __restrict__ mass,
                                                          long long n, long long nt, long long lo,
                                                          long long hi, Consts c,
                                                          double* __restrict__ partial) {
  __shared__ float4 src[kTile];
  __shared__ unsigned near_bits[kPerThread * kWords * kThreads];
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  const long long blocks = gridDim.x, g = blockIdx.x;
  const long long t0 = lo + (hi - lo) * g / blocks, t1 = lo + (hi - lo) * (g + 1) / blocks;
  double total = 0.0;
  if (t0 < t1) {
    long long a, b;
    tile_pair(t0, nt, a, b);
    long long row = -1;
    float px[kPerThread], py[kPerThread], pz[kPerThread], pm[kPerThread];
    bool live[kPerThread];
    for (long long t = t0; t < t1; ++t) {
      if (a != row) {  // the run entered receiver tile a: reload the receivers
        row = a;
#pragma unroll
        for (int q = 0; q < kPerThread; ++q) {
          const long long i = a * kTile + tid + q * kThreads;
          live[q] = i < n;  // a dead receiver's sums are made and dropped
          px[q] = live[q] ? pos[3 * i] : 0.0f;
          py[q] = live[q] ? pos[3 * i + 1] : 0.0f;
          pz[q] = live[q] ? pos[3 * i + 2] : 0.0f;
          pm[q] = live[q] ? mass[i] : 0.0f;
        }
      }
      const long long j0 = b * kTile;
      const int len = static_cast<int>(n - j0 < kTile ? n - j0 : kTile);
      __syncthreads();  // every thread is done with the previous stage
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int k = tid + q * kThreads;
        const long long j = j0 + k;
        // past the last body: massless and at infinity (r^2 = inf: I = 0, never near)
        src[k] = k < len ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j])
                         : make_float4(kInf, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
      float part[kPerThread];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) part[q] = 0.0f;
      // the diagonal tile: only the sources past each receiver (j > i)
      if (a == b)
        tile_sum<SOFTENED, true>(src, near_bits, tid, px, py, pz, c, part);
      else
        tile_sum<SOFTENED, false>(src, near_bits, tid, px, py, pz, c, part);
#pragma unroll
      for (int q = 0; q < kPerThread; ++q)
        if (live[q]) total += static_cast<double>(pm[q]) * static_cast<double>(part[q]);
      if (++b == nt) {
        ++a;
        b = a;
      }
    }
  }
  red[tid] = total;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partial[g] = red[0];
}

// out[0] = scale * the blocks' totals, added in a fixed order.
__global__ void __launch_bounds__(kSumThreads) energy_sum_kernel(
    const double* __restrict__ partial, int blocks, double scale, double* __restrict__ out) {
  __shared__ double red[kSumThreads];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int k = tid; k < blocks; k += kSumThreads) s += partial[k];
  red[tid] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) out[0] = scale * red[0];
}

// out[i] = what tile_sum adds for one source of unit mass at distance r[i]
// from receiver i: I(r[i]), or 1/r[i] unless SOFTENED. Block g takes the
// kTile receivers from r[g kTile] on, each at (-r[i], 0, 0) (so r^2 is r[i]^2
// in float32, as from the differences); its stage holds the source at the
// origin in slot g % kTile, every other slot massless at infinity, so the
// blocks meet every word and bit of the near pass.
template <bool SOFTENED>
__global__ void __launch_bounds__(kThreads) energy_probe_kernel(const float* __restrict__ r,
                                                                long long n, Consts c,
                                                                float* __restrict__ out) {
  __shared__ float4 src[kTile];
  __shared__ unsigned near_bits[kPerThread * kWords * kThreads];
  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  const int slot = static_cast<int>(blockIdx.x % kTile);
  float px[kPerThread], py[kPerThread], pz[kPerThread], part[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int k = tid + q * kThreads;
    px[q] = i0 + k < n ? -r[i0 + k] : 0.0f;
    py[q] = pz[q] = part[q] = 0.0f;
    src[k] = k == slot ? make_float4(0.0f, 0.0f, 0.0f, 1.0f) : make_float4(kInf, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  tile_sum<SOFTENED, false>(src, near_bits, tid, px, py, pz, c, part);
#pragma unroll
  for (int q = 0; q < kPerThread; ++q)
    if (i0 + tid + q * kThreads < n) out[i0 + tid + q * kThreads] = part[q];
}

// The host's constants, checked against this source's layout.
bool load_consts(const float* consts, int n_consts, Consts& c) {
  if (consts == nullptr || n_consts != kConsts) return false;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kConsts; ++k) dst[k] = consts[k];
  return true;
}

}  // namespace

// Blocks of one launch on CUDA device `device`: resident blocks per SM
// times SMs, in *blocks (the partial scratch's length). Returns the
// cudaError_t of the queries (0 on success).
extern "C" int energy_blocks(int device, int* blocks) {
  int sms = 0, per_sm = 0, per_sm_newton = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, energy_kernel<true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_newton, energy_kernel<false>,
                                                        kThreads, 0);
  *blocks = sms * (per_sm < per_sm_newton ? per_sm : per_sm_newton);
  return static_cast<int>(err);
}

// pos (n, 3) and mass (n,) float32 on CUDA device `device`; the tile pairs
// [lo, hi) of the nt (nt + 1) / 2 of tiles of kTile bodies (nt must be
// ceil(n / kTile), 0 <= lo <= hi <= its count); `blocks` blocks (at most
// energy_blocks' count, at least 1), partial (blocks,) float64 scratch;
// out (1,) float64 receives scale (= -g) times the sum of m_i m_j I(r_ij)
// (1/r_ij unless softened) over those pairs with i < j. consts: the
// n_consts floats of ops/energy.py PairConstants.flat() in host memory (a
// count other than this source's is refused). Launches energy_kernel and
// energy_sum_kernel on `stream` and returns the cudaError_t of the launches
// (0 on success). Does not synchronise.
extern "C" int energy_launch(const void* pos, const void* mass, long long n, long long lo,
                             long long hi, const float* consts, int n_consts, int softened,
                             double scale, int blocks, void* partial, void* out, int device,
                             void* stream) {
  const long long nt = (n + kTile - 1) / kTile;
  Consts c;
  if (n < 0 || lo < 0 || lo > hi || hi > nt * (nt + 1) / 2 || blocks < 1 ||
      !load_consts(consts, n_consts, c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const float*>(pos);
  auto* m = static_cast<const float*>(mass);
  auto* part = static_cast<double*>(partial);
  if (softened)
    energy_kernel<true><<<blocks, kThreads, 0, s>>>(p, m, n, nt, lo, hi, c, part);
  else
    energy_kernel<false><<<blocks, kThreads, 0, s>>>(p, m, n, nt, lo, hi, c, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  energy_sum_kernel<<<1, kSumThreads, 0, s>>>(part, blocks, scale, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = I(r[i]) (1/r[i] unless softened) as the energy kernel's tile
// pass evaluates a pair (energy_probe_kernel), for n float32 r on CUDA
// device `device`, with the same consts as energy_launch. A check of the
// pair arithmetic, not part of the energy. Launches on `stream`; returns
// the cudaError_t (0 on success).
extern "C" int energy_probe(const void* r, long long n, const float* consts, int n_consts,
                            int softened, void* out, int device, void* stream) {
  Consts c;
  if (n < 0 || !load_consts(consts, n_consts, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const auto grid = static_cast<unsigned>((n + kTile - 1) / kTile);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* rr = static_cast<const float*>(r);
  auto* o = static_cast<float*>(out);
  if (softened)
    energy_probe_kernel<true><<<grid, kThreads, 0, s>>>(rr, n, c, o);
  else
    energy_probe_kernel<false><<<grid, kThreads, 0, s>>>(rr, n, c, o);
  return static_cast<int>(cudaGetLastError());
}
