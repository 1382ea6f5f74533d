// Morton keys and their stable sort for Hopper (sm_90a).
//
// Replaces the XLA ops of wgpu_n_body_tpu/ops/morton.py::quantize and
// morton_keys (:31, :42) as ops/tree_build.py::morton_order (:146-160) runs
// them, which the port first carried as some sixty int64 torch kernels over
// (N, 3) and (N,) arrays (ops/morton.py, now the plain version). One kernel
// and one library sort:
//
// 1. morton_keys_kernel, one thread per body i:
//      bound   = max(1, max(max pos, -min pos)): the root's half width from
//                the one min/max reduction the wrapper ran (torch.aminmax),
//                equal to max(1, max |pos|) bit for bit; thread 0 writes it;
//      cell    = trunc(clamp((p + bound) * (2^depth / (2 bound)),
//                            0, 2^depth - 1)) per axis, in float32 with the
//                plain version's roundings: __fadd_rn / __fmul_rn (nothing
//                contracted into an FMA) and an IEEE divide;
//      key[i]  = the three cells' bits interleaved, x lowest: one packed key
//                of 3*depth bits, ``hi << 3*d_lo | lo`` of the JAX
//                package's (hi, lo) pair (48 bits at depth 16, 60 at 20);
//      index[i] = i, the values the sort carries.
// 2. morton_sort_launch: CUB's DeviceRadixSort::SortPairs of (key, index)
//    on bits [0, 3*depth) only: a radix sort is stable, so equal keys keep
//    index order and the sorted index is the JAX package's lexsort
//    permutation. The JAX package sorts with lax.sort outside any kernel;
//    this stays a library call (the toolkit's CUB, no package of kernels).
//    Eight-bit digits: 6 passes for a 48-bit key where torch.sort of an
//    int64 takes 8, over 12 bytes an element instead of 16.
//
// What bounds the key kernel on H100: bytes. It reads 12 and writes 12 per
// body (96 MB at N=4M, 0.029 ms at 3.35 TB/s) and does ~60 integer and 9
// float operations per body. Coalesced: the position loads of a warp are
// 384 contiguous bytes, the stores 256 and 128. Nothing is read back to the
// host, nothing is allocated here, and every launch goes on the caller's
// stream.

#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

// Bit k of v (k < 21) to bit 3k.
__device__ __forceinline__ unsigned long long spread_bits(unsigned int v) {
  unsigned long long x = v & 0x1fffffull;
  x = (x | (x << 32)) & 0x001f00000000ffffull;
  x = (x | (x << 16)) & 0x001f0000ff0000ffull;
  x = (x | (x << 8)) & 0x100f00f00f00f00full;
  x = (x | (x << 4)) & 0x10c30c30c30c30c3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

__global__ void morton_keys_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ pos_min,
                                   const float* __restrict__ pos_max,
                                   unsigned long long* __restrict__ keys,
                                   int* __restrict__ index,
                                   float* __restrict__ bound_out, int n,
                                   int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // torch.maximum(1, max |p|), NaN propagated as torch does
  const float lo = *pos_min, hi = *pos_max;
  float b = hi >= -lo ? hi : -lo;
  b = (b > 1.0f || b != b) ? b : 1.0f;
  if (i == 0) *bound_out = b;
  if (i >= n) return;
  const float side = static_cast<float>(1 << depth);
  const float scale = __fdiv_rn(side, __fmul_rn(2.0f, b));
  const float top = side - 1.0f;
  unsigned long long key = 0;
  for (int q = 0; q < 3; ++q) {
    float c = __fmul_rn(__fadd_rn(pos[3 * i + q], b), scale);
    c = c < 0.0f ? 0.0f : (c > top ? top : c);
    key |= spread_bits(__float2uint_rz(c)) << q;
  }
  keys[i] = key;
  index[i] = i;
}

}  // namespace

// The key kernel on `stream`: keys (n,) uint64 and index (n,) int32 of n
// float32 positions, and the bound, from the min and max of the positions.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int morton_keys_launch(const void* pos, const void* pos_min,
                                  const void* pos_max, void* keys, void* index,
                                  void* bound, int n, int depth, int block,
                                  int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  morton_keys_kernel<<<(n + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(pos_min),
      static_cast<const float*>(pos_max),
      static_cast<unsigned long long*>(keys), static_cast<int*>(index),
      static_cast<float*>(bound), n, depth);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch the sort of n pairs on bits [0, end_bit) needs, into
// *bytes. Launches nothing. Returns a cudaError_t (0 = success).
extern "C" int morton_sort_temp_bytes(int n, int end_bit, int device,
                                      size_t* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t b = 0;
  err = cub::DeviceRadixSort::SortPairs(
      nullptr, b, static_cast<const unsigned long long*>(nullptr),
      static_cast<unsigned long long*>(nullptr), static_cast<const int*>(nullptr),
      static_cast<int*>(nullptr), n, 0, end_bit);
  *bytes = b;
  return static_cast<int>(err);
}

// The stable sort of (keys_in, index_in) by the key's bits [0, end_bit) into
// (keys_out, perm_out), on `stream`, in `temp` of temp_bytes bytes (at least
// morton_sort_temp_bytes). Returns a cudaError_t (0 = success).
extern "C" int morton_sort_launch(void* temp, size_t temp_bytes,
                                  const void* keys_in, void* keys_out,
                                  const void* index_in, void* perm_out, int n,
                                  int end_bit, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t b = temp_bytes;
  err = cub::DeviceRadixSort::SortPairs(
      temp, b, static_cast<const unsigned long long*>(keys_in),
      static_cast<unsigned long long*>(keys_out),
      static_cast<const int*>(index_in), static_cast<int*>(perm_out), n, 0,
      end_bit, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
