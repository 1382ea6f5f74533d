// The potential energy sum_{i<j} -g m_i m_j I(r_ij) for Hopper (sm_90a): E1.
//
// Replaces wgpu_n_body_tpu/ops/energy.py:62 potential_energy (an XLA
// lax.map over blocks of receiver rows, whose elementwise body XLA fuses
// into the reduction). The port's plain version
// (ops/energy.py::potential_energy_plain) forms the same block of
// differences in device memory; at N=4M that is tens of GB per block, so
// on the card the sum runs here, with no (rows x sources) tensor at all.
//
// Pair term, float32, following softened_pair_integral with a = e^(1/3)
// and its products computed on the host in double (the Consts below):
//
//     x  = (2r - a) / (a sqrt3)
//     at = arctan(1/x) for x > 0, else pi/2 - arctan(x)
//     I  = ln((r^2 - a r + a^2) / (r + a)^2) / (6 a^2) + at / (a^2 sqrt3)
//
// or 1/r with SOFTENED false. Only i < j counts: the diagonal tile starts
// each receiver's loop past itself (I(0) is finite, so i == j must be
// dropped, not masked by the value). The two terms of I are each about
// 1/(2 a r) and cancel to about 1/(2 r^2), so the accurate sqrtf, logf,
// atanf and IEEE divisions are used: no fast-math intrinsics, no
// --use_fast_math (ops/cuda_build.py BASE_FLAGS).
//
// What bounds it on H100: the special-function units. The softened
// integral needs 4 MUFU ops per pair (sqrt, the reciprocals of x and of the
// log's quotient, the log) at 16 per SM per clock, beside ~41 float32
// flops. The accurate functions' range reductions and the divisions'
// Newton steps add to that: 132 SASS instructions and 7 MUFU ops per pair
// in this kernel for sm_90a, so instruction issue sets its time, about five
// times that bound. Device memory is nothing (16 bytes per body per tile
// pair, reused by 256 receivers).
//
// What the design does about it:
// - Only the upper triangle of (receiver tile, source tile) pairs, tiles
//   of kTile bodies, numbered row by row: a full i != j sum halved would
//   double the work. A launch takes the tile pairs [lo, hi) of its share
//   (ops/energy.py::share_range); the share splits tile pairs, not rows,
//   because row 0 has N-1 partners and row N-1 none.
// - One block per resident slot (persistent), each over an equal run of
//   the share's tile pairs: a receiver per thread in registers, reloaded
//   when the run enters the next row; the source tile staged in shared
//   memory as float4 (x, y, z, m), read as broadcasts.
// - Two-level summation (B1's, csrc/naive_forces.cu): each thread sums its
//   m_j I(r) over one source tile in float32, then adds m_i times that
//   partial to a float64 total.
// - Each block writes its float64 total to scratch; energy_sum_kernel adds
//   them in block order. No float atomics: two launches give the same bits.
// - Tile pairs, rows and pair counts are int64 (N=262144 has 3.4e10 pairs).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 256;  // receivers per block = sources per stage
constexpr int kSumThreads = 256;
constexpr float kHalfPi = 1.57079632679489661923f;

struct Consts {
  float a;      // e^(1/3)
  float a_s3;   // a sqrt(3)
  float a2;     // a^2
  float k_log;  // 6 a^2
  float k_at;   // a^2 sqrt(3)
};

template <bool SOFTENED>
__device__ __forceinline__ float pair_integral(const float r, const Consts& c) {
  if constexpr (SOFTENED) {
    const float x = (2.0f * r - c.a) / c.a_s3;
    const bool pos = x > 0.0f;
    const float t = atanf(pos ? 1.0f / x : x);
    const float at = pos ? t : kHalfPi - t;
    const float log_term = logf((r * r - c.a * r + c.a2) / ((r + c.a) * (r + c.a)));
    return log_term / c.k_log + at / c.k_at;
  } else {
    return 1.0f / r;
  }
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

// sum over sources k in [k0, len) of the stage of m_k I(|s_k - p|).
template <bool SOFTENED>
__device__ __forceinline__ float tile_sum(const float4* src, int k0, int len, float px,
                                          float py, float pz, const Consts& c) {
  float part = 0.0f;
#pragma unroll 4
  for (int k = k0; k < len; ++k) {
    const float4 s = src[k];
    const float dx = s.x - px, dy = s.y - py, dz = s.z - pz;
    const float r = sqrtf(dx * dx + dy * dy + dz * dz);
    part += s.w * pair_integral<SOFTENED>(r, c);
  }
  return part;
}

template <bool SOFTENED>
__global__ void __launch_bounds__(kTile) energy_kernel(const float* __restrict__ pos,
                                                       const float* __restrict__ mass,
                                                       long long n, long long nt, long long lo,
                                                       long long hi, Consts c,
                                                       double* __restrict__ partial) {
  __shared__ float4 src[kTile];
  __shared__ double red[kTile];
  const int tid = threadIdx.x;
  const long long blocks = gridDim.x, g = blockIdx.x;
  const long long t0 = lo + (hi - lo) * g / blocks, t1 = lo + (hi - lo) * (g + 1) / blocks;
  double total = 0.0;
  if (t0 < t1) {
    long long a, b;
    tile_pair(t0, nt, a, b);
    long long row = -1;
    float px = 0.0f, py = 0.0f, pz = 0.0f, pm = 0.0f;
    bool live = false;
    for (long long t = t0; t < t1; ++t) {
      if (a != row) {  // the run entered receiver tile a: reload the receivers
        row = a;
        const long long i = a * kTile + tid;
        live = i < n;
        if (live) {
          px = pos[3 * i];
          py = pos[3 * i + 1];
          pz = pos[3 * i + 2];
          pm = mass[i];
        }
      }
      const long long j0 = b * kTile;
      const int len = static_cast<int>(n - j0 < kTile ? n - j0 : kTile);
      __syncthreads();  // every thread is done with the previous stage
      if (tid < len) {
        const long long j = j0 + tid;
        src[tid] = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j]);
      }
      __syncthreads();
      if (live) {
        // the diagonal tile: only the sources past the receiver (j > i)
        const float part = tile_sum<SOFTENED>(src, a == b ? tid + 1 : 0, len, px, py, pz, c);
        total += static_cast<double>(pm) * static_cast<double>(part);
      }
      if (++b == nt) {
        ++a;
        b = a;
      }
    }
  }
  red[tid] = total;
  __syncthreads();
  for (int s = kTile / 2; s > 0; s >>= 1) {
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

}  // namespace

// Blocks of one launch on CUDA device `device`: resident blocks per SM
// times SMs, in *blocks (the partial scratch's length). Returns the
// cudaError_t of the queries (0 on success).
extern "C" int energy_blocks(int device, int* blocks) {
  int sms = 0, per_sm = 0, per_sm_newton = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, energy_kernel<true>, kTile, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_newton, energy_kernel<false>,
                                                        kTile, 0);
  *blocks = sms * (per_sm < per_sm_newton ? per_sm : per_sm_newton);
  return static_cast<int>(err);
}

// pos (n, 3) and mass (n,) float32 on CUDA device `device`; the tile pairs
// [lo, hi) of the nt (nt + 1) / 2 of tiles of kTile bodies (nt must be
// ceil(n / kTile), 0 <= lo <= hi <= its count); `blocks` blocks (at most
// energy_blocks' count, at least 1), partial (blocks,) float64 scratch;
// out (1,) float64 receives scale (= -g) times the sum of m_i m_j I(r_ij)
// (1/r_ij unless softened) over those pairs with i < j. The Consts' five
// floats come from ops/energy_cuda.py. Launches energy_kernel and
// energy_sum_kernel on `stream` and returns the cudaError_t of the launches
// (0 on success). Does not synchronise.
extern "C" int energy_launch(const void* pos, const void* mass, long long n, long long lo,
                             long long hi, float a, float a_s3, float a2, float k_log,
                             float k_at, int softened, double scale, int blocks, void* partial,
                             void* out, int device, void* stream) {
  const long long nt = (n + kTile - 1) / kTile;
  if (n < 0 || lo < 0 || lo > hi || hi > nt * (nt + 1) / 2 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const Consts c{a, a_s3, a2, k_log, k_at};
  auto* p = static_cast<const float*>(pos);
  auto* m = static_cast<const float*>(mass);
  auto* part = static_cast<double*>(partial);
  if (softened)
    energy_kernel<true><<<blocks, kTile, 0, s>>>(p, m, n, nt, lo, hi, c, part);
  else
    energy_kernel<false><<<blocks, kTile, 0, s>>>(p, m, n, nt, lo, hi, c, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  energy_sum_kernel<<<1, kSumThreads, 0, s>>>(part, blocks, scale, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
