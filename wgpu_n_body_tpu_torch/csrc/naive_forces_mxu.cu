// All-pairs softened gravity, factored accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel wgpu_n_body_tpu/ops/naive_pallas.py::_kernel_mxu
// (entry naive_forces_pallas, mxu=True). The per-pair weight is the
// dx-form kernel's (csrc/naive_forces.cu), in the same order of operations:
//
//     d     = p_old_j - p_new_i
//     r2    = |d|^2
//     inv_r = rsqrt(r2)
//     r     = r2 * inv_r
//     w     = mgdt_j * inv_r / (r2 * r + e)        mgdt_j = m_j * g * dt
//
// but the sum is factored as the TPU kernel's matrix product does it:
//
//     S_xyz += w * p_old_j,   S_w += w            over every source j != i
//     a_i    = S_xyz - p_new_i * S_w               once, after the last tile
//
// Only the self pair is skipped; two distinct coincident particles give NaN
// (reference parity). The factoring is less accurate than the dx-form: the
// sum carries |p_j| instead of |p_j - p_i| (about 2e-4 p99 relative error
// in f32, wgpu_n_body_tpu/params.py:56-62).
//
// What bounds it on H100: arithmetic, as for the dx-form kernel. The TPU
// moved the multiply-accumulate onto its matrix unit with a thin
// (4 x TJ) @ (TJ x TI) product; on Hopper that shape has no tensor-core
// form worth using, and TF32 would break the TPU kernel's
// Precision.HIGHEST contract. So the four sums are FP32 FMAs on the CUDA
// cores: one more accumulator than the dx-form, the same rsqrt and IEEE
// divide per pair.
//
// What the design does about it:
// - One thread per receiver, tile_i receivers per block, the receiver and
//   its four running sums in registers for the whole sweep.
// - Sources are staged tile by tile into shared memory as float4
//   (x, y, z, mgdt) and read by every thread at once (a broadcast).
// - Two-level summation: each tile is summed into a partial that then
//   joins the running total, like the TPU kernel's per-block product
//   followed by acc_ref +=.
// - The self-mask compare runs only in blocks whose receiver rows cross
//   the tile's source columns (the TPU kernel's diagonal-block gating).
// - Built without --use_fast_math: true divide, denormals kept.

#include <cuda_runtime.h>

namespace {

template <bool MASKED>
__device__ __forceinline__ void tile_sum(const float4* tile, int len, int j0,
                                         int gi, float px, float py, float pz,
                                         float e, float4& acc) {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sw = 0.0f;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float4 s = tile[k];
    const float dx = s.x - px;
    const float dy = s.y - py;
    const float dz = s.z - pz;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const bool self = MASKED && (j0 + k == gi);
    const float inv_r = rsqrtf(self ? 1.0f : r2);
    const float r = r2 * inv_r;
    float w = s.w * inv_r / (r2 * r + e);
    if (MASKED) w = self ? 0.0f : w;
    sx += w * s.x;
    sy += w * s.y;
    sz += w * s.z;
    sw += w;
  }
  acc.x += sx;
  acc.y += sy;
  acc.z += sz;
  acc.w += sw;
}

__global__ void naive_forces_mxu_kernel(const float* __restrict__ pos_new,
                                        const float4* __restrict__ src,
                                        float* __restrict__ out, int n_recv,
                                        int n_src, int row_offset, float e,
                                        int tile_j) {
  extern __shared__ float4 tile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_recv;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (active) {
    px = pos_new[3 * i + 0];
    py = pos_new[3 * i + 1];
    pz = pos_new[3 * i + 2];
  }
  const int gi = row_offset + i;
  // global source rows of this block's receivers: [r0, r1)
  const int r0 = row_offset + blockIdx.x * blockDim.x;
  const int r1 = r0 + blockDim.x;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < n_src; j0 += tile_j) {
    const int len = min(tile_j, n_src - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < len; k += blockDim.x) tile[k] = src[j0 + k];
    __syncthreads();
    if (active) {
      if (r0 < j0 + len && j0 < r1) {
        tile_sum<true>(tile, len, j0, gi, px, py, pz, e, acc);
      } else {
        tile_sum<false>(tile, len, j0, gi, px, py, pz, e, acc);
      }
    }
  }
  if (active) {
    out[3 * i + 0] = acc.x - px * acc.w;
    out[3 * i + 1] = acc.y - py * acc.w;
    out[3 * i + 2] = acc.z - pz * acc.w;
  }
}

}  // namespace

// pos_new (n_recv, 3) float32; src (n_src, 4) float32 rows (x, y, z, mgdt);
// out (n_recv, 3) float32, all on CUDA device `device`. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success). Does
// not synchronise.
extern "C" int naive_forces_mxu_launch(const void* pos_new, const void* src,
                                       void* out, int n_recv, int n_src,
                                       int row_offset, float e, int tile_i,
                                       int tile_j, int device, void* stream) {
  if (n_recv <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_recv + tile_i - 1) / tile_i;
  const size_t smem = sizeof(float4) * static_cast<size_t>(tile_j);
  naive_forces_mxu_kernel<<<blocks, tile_i, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_new), static_cast<const float4*>(src),
      static_cast<float*>(out), n_recv, n_src, row_offset, e, tile_j);
  return static_cast<int>(cudaGetLastError());
}
