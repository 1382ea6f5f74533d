// All-pairs softened gravity for Hopper (sm_90a).
//
// Replaces the TPU kernel wgpu_n_body_tpu/ops/naive_pallas.py::_kernel
// (entry naive_forces_pallas, mxu=False). Per receiver i and every source
// j != i (global index; receiver i is source row_offset + i):
//
//     d     = p_old_j - p_new_i
//     r2    = |d|^2
//     inv_r = rsqrt(r2)
//     r     = r2 * inv_r
//     w     = mgdt_j * inv_r / (r2 * r + e)        mgdt_j = m_j * g * dt
//     acc_i += w * d
//
// in the same order of operations as the TPU kernel. Only the self pair is
// skipped; two distinct coincident particles give NaN (reference parity).
//
// What bounds it on H100: arithmetic, not memory. Each pair costs about 20
// FP32 operations, one rsqrt and one IEEE divide (the divide is a short
// sequence around a reciprocal on the special-function unit), and no
// matrix product, so tensor cores do not apply. A source is 16 bytes and is
// reused by every receiver of a block, so device memory traffic is
// (N / tile_i) * N * 16 bytes — far below the arithmetic time.
//
// What the design does about it:
// - One thread per receiver, tile_i receivers per block. The receiver's
//   position and its running sum stay in registers for the whole sweep.
// - The block walks over all sources in tiles of tile_j, each staged once
//   into shared memory as float4 (x, y, z, mgdt); every thread then reads
//   the same element at the same time (a broadcast, no bank conflicts).
//   The loop over sources lives inside the block: nothing is carried
//   between blocks, unlike the TPU grid's sequential source axis.
// - The self-mask compare runs only in blocks whose receiver rows cross
//   the tile's source columns (the TPU kernel's diagonal-block gating).
// - Two-level summation: each tile is summed into a partial that is then
//   added to the running total, like the TPU kernel's per-block lane sum
//   followed by out_ref[:] +=. This keeps the float32 error near the TPU
//   kernel's at N = 262144.
// - The ragged edge is masked by loop bounds, not by sentinel padding.
// - Built without --use_fast_math: the divide stays a true divide and
//   denormals are kept.
// Still to do in later work: several receivers per thread, TMA staging,
// warp specialisation.

#include <cuda_runtime.h>

namespace {

template <bool MASKED>
__device__ __forceinline__ void tile_sum(const float4* tile, int len, int j0,
                                         int gi, float px, float py, float pz,
                                         float e, float& ax, float& ay,
                                         float& az) {
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
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
    tx += w * dx;
    ty += w * dy;
    tz += w * dz;
  }
  ax += tx;
  ay += ty;
  az += tz;
}

__global__ void naive_forces_kernel(const float* __restrict__ pos_new,
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
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int j0 = 0; j0 < n_src; j0 += tile_j) {
    const int len = min(tile_j, n_src - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < len; k += blockDim.x) tile[k] = src[j0 + k];
    __syncthreads();
    if (active) {
      if (r0 < j0 + len && j0 < r1) {
        tile_sum<true>(tile, len, j0, gi, px, py, pz, e, ax, ay, az);
      } else {
        tile_sum<false>(tile, len, j0, gi, px, py, pz, e, ax, ay, az);
      }
    }
  }
  if (active) {
    out[3 * i + 0] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
  }
}

}  // namespace

// pos_new (n_recv, 3) float32; src (n_src, 4) float32 rows (x, y, z, mgdt);
// out (n_recv, 3) float32, all on CUDA device `device`. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success). Does
// not synchronise.
extern "C" int naive_forces_launch(const void* pos_new, const void* src,
                                   void* out, int n_recv, int n_src,
                                   int row_offset, float e, int tile_i,
                                   int tile_j, int device, void* stream) {
  if (n_recv <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_recv + tile_i - 1) / tile_i;
  const size_t smem = sizeof(float4) * static_cast<size_t>(tile_j);
  naive_forces_kernel<<<blocks, tile_i, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_new), static_cast<const float4*>(src),
      static_cast<float*>(out), n_recv, n_src, row_offset, e, tile_j);
  return static_cast<int>(cudaGetLastError());
}
