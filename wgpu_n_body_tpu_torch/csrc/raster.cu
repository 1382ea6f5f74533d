// The renderer's raster (B6) for Hopper (sm_90a).
//
// Replaces the raster tiers of wgpu_n_body_tpu/runners/renderer.py:
// _device_raster_fn (:435) with _window_run_counts (:279), the compacted
// second pass _medium_raster_fn (:343), the dense third pass _big_raster_fn
// (:382), the host composite past their caps (raster_resolve, :578) and the
// u8 blend _combine_blend_u8_fn (:659). Every tier there works around the
// TPU's slow random scatter; on Hopper an integer atomicAdd is cheap and
// order-free, so the function is two kernels and a blend:
//
// 1. raster_kernel, one thread per body: the projection in float64 from the
//    float32 inputs, ((x m[r,0] + y m[r,1]) + z m[r,2]) + m[r,3] with
//    __dmul_rn / __dadd_rn, rounded once to float32 (ops/raster.py::project);
//    the cull and the pixel-space triangle in float32 with __fmul_rn /
//    __fadd_rn / __fdiv_rn in the JAX op order (ops/raster.py::triangles);
//    the pixels it may light as the JAX host tests them (ops/raster.py::
//    boxes), clipped to the frame. A box of at most kSmallBox x kSmallBox
//    pixels is tested here by the pixel-centre rule (ops/raster.py::covers)
//    and each hit is one atomicAdd into the int32 counts. A larger box (a
//    body near the lens) appends the body's index to a list of capacity N
//    through one atomic counter, so the list never overflows. A splat is
//    one atomicAdd at the truncated, clamped pixel of its centre.
// 2. raster_big_kernel, one CTA per kTile x kTile pixels, a thread per
//    pixel: the CTA streams the list through shared memory kBlock entries
//    at a time (each thread recomputes one entry's triangle and box), skips
//    entries whose box misses the pixel, counts hits in a register and adds
//    the total once. Its grid is fixed by the frame and it reads the list's
//    length on the device, so a frame never waits on the host.
// 3. blend_u8_kernel, a thread per pixel: counts -> u8 through the 256-entry
//    LUT of ops/raster.py::blend_lut_u8, a __grid_constant__ parameter
//    (constant memory).
//
// No contraction and no fast divide anywhere: the counts are bit-equal to
// the plain version and to the host render from the same positions,
// whichever kernel a triangle falls to, and integer atomics make them
// independent of the order of the adds.
//
// What bounds it on H100: bytes. A frame reads 12 B per body, writes and
// reads back 4 B per pixel and 4 B per listed body; the blend reads 4 B and
// writes 1 B per pixel. At the visualize scene (N=100000, 400x400) that is
// 3.0 MB, ~1 us at 3.35 TB/s, so a frame is launch-bound; at N=4M it is
// 49 MB. The atomics of bodies that share a pixel serialise in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kSmallBox = 8;  // a box this wide and high is drawn by its own thread
constexpr int kTile = 16;     // raster_big_kernel: kTile x kTile pixels per CTA
static_assert(kTile * kTile == kBlock, "one thread per pixel of a tile");
// ops/raster.py: POINT_EXTENT and the cull's w * (1 + POINT_EXTENT), each
// rounded once from double as numpy rounds a Python float
constexpr float kExtent = static_cast<float>(0.006);
constexpr float kLim = static_cast<float>(1.0 + 0.006);
// ops/raster.py::WINDOW - 1: wider footprints take the 1-px slack box
constexpr float kWindowEdge = 31.0f;
constexpr int kWindow = 32;
constexpr float kClamp = 16777216.0f;  // 2^24: float bounds clamped before int

struct Mat {
  float m[16];
};
struct Lut {
  unsigned char v[256];
};
struct Tri {
  bool keep;
  float cx, cy, sx, sy;
};
struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ float project_row(const Mat& M, int r, double x,
                                             double y, double z) {
  double a = __dmul_rn(x, static_cast<double>(M.m[4 * r]));
  a = __dadd_rn(a, __dmul_rn(y, static_cast<double>(M.m[4 * r + 1])));
  a = __dadd_rn(a, __dmul_rn(z, static_cast<double>(M.m[4 * r + 2])));
  return __double2float_rn(__dadd_rn(a, static_cast<double>(M.m[4 * r + 3])));
}

template <bool kSplat>
__device__ __forceinline__ Tri triangle(const float* __restrict__ pos, int i,
                                        const Mat& M, int width, int height) {
  const double x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  const float px = project_row(M, 0, x, y, z);
  const float py = project_row(M, 1, x, y, z);
  const float pz = project_row(M, 2, x, y, z);
  const float w = project_row(M, 3, x, y, z);
  const float lim = kSplat ? w : __fmul_rn(w, kLim);
  Tri t;
  // NaN fails every comparison, as in numpy
  t.keep = w > 0.0f && fabsf(px) <= lim && fabsf(py) <= lim && pz >= 0.0f &&
           pz <= w;
  const float W = static_cast<float>(width), H = static_cast<float>(height);
  t.cx = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(px, w), 1.0f), 0.5f), W);
  t.cy = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, __fdiv_rn(py, w)), 0.5f), H);
  const float sn = __fdiv_rn(kExtent, w);
  t.sx = __fmul_rn(__fmul_rn(sn, 0.5f), W);
  t.sy = __fmul_rn(__fmul_rn(sn, 0.5f), H);
  return t;
}

__device__ __forceinline__ int floor_int(float v) {
  return static_cast<int>(fminf(fmaxf(floorf(v), -kClamp), kClamp));
}

// ops/raster.py::boxes for one axis: [lo, hi] clipped to [0, size).
__device__ __forceinline__ void axis_box(float c, float s, bool small, int size,
                                         int& lo, int& hi) {
  const int a = floor_int(__fadd_rn(__fsub_rn(c, s), 0.5f));
  hi = floor_int(__fadd_rn(__fadd_rn(c, s), 0.5f)) + 1;
  if (small) {
    hi = min(hi, a + kWindow - 1);
    lo = a;
  } else {
    lo = a - 1;
  }
  lo = max(lo, 0);
  hi = min(hi, size - 1);
}

__device__ __forceinline__ Box box_of(const Tri& t, int width, int height) {
  const bool small = !(__fmul_rn(2.0f, t.sx) > kWindowEdge ||
                       __fmul_rn(2.0f, t.sy) > kWindowEdge);
  Box b;
  axis_box(t.cx, t.sx, small, width, b.x0, b.x1);
  axis_box(t.cy, t.sy, small, height, b.y0, b.y1);
  return b;
}

// ops/raster.py::covers, split by row: vy and the half-width at row gy ...
__device__ __forceinline__ bool row_of(int gy, float cy, float sx, float sy,
                                       float& hw) {
  const float vy = __fsub_rn(__fadd_rn(static_cast<float>(gy), 0.5f), cy);
  hw = __fdiv_rn(__fmul_rn(sx, __fadd_rn(vy, sy)), __fmul_rn(2.0f, sy));
  return fabsf(vy) <= sy;
}

// ... and the test of column gx against that half-width.
__device__ __forceinline__ bool col_in(int gx, float cx, float hw) {
  return fabsf(__fsub_rn(__fadd_rn(static_cast<float>(gx), 0.5f), cx)) <= hw;
}

template <bool kSplat>
__global__ void __launch_bounds__(kBlock)
    raster_kernel(const float* __restrict__ pos, int n,
                  const __grid_constant__ Mat M, int width, int height,
                  int* __restrict__ counts, int* __restrict__ list,
                  int* __restrict__ list_len) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const Tri t = triangle<kSplat>(pos, i, M, width, height);
  if (!t.keep) return;
  if (kSplat) {
    const int px = min(max(__float2int_rz(t.cx), 0), width - 1);
    const int py = min(max(__float2int_rz(t.cy), 0), height - 1);
    atomicAdd(counts + py * width + px, 1);
    return;
  }
  const Box b = box_of(t, width, height);
  if (b.x1 < b.x0 || b.y1 < b.y0) return;
  if (b.x1 - b.x0 >= kSmallBox || b.y1 - b.y0 >= kSmallBox) {
    list[atomicAdd(list_len, 1)] = i;
    return;
  }
  for (int gy = b.y0; gy <= b.y1; ++gy) {
    float hw;
    if (!row_of(gy, t.cy, t.sx, t.sy, hw)) continue;
    for (int gx = b.x0; gx <= b.x1; ++gx) {
      if (col_in(gx, t.cx, hw)) atomicAdd(counts + gy * width + gx, 1);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    raster_big_kernel(const float* __restrict__ pos,
                      const int* __restrict__ list,
                      const int* __restrict__ list_len,
                      const __grid_constant__ Mat M, int width, int height,
                      int* __restrict__ counts) {
  __shared__ float4 s_tri[kBlock];
  __shared__ int4 s_box[kBlock];
  const int gx = blockIdx.x * kTile + threadIdx.x % kTile;
  const int gy = blockIdx.y * kTile + threadIdx.x / kTile;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int n = *list_len;
  int hits = 0;
  for (int base = 0; base < n; base += kBlock) {
    const int j = base + threadIdx.x;
    int4 bx = make_int4(1, 0, 1, 0);  // empty: misses every pixel
    float4 tr = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < n) {
      const Tri t = triangle<false>(pos, list[j], M, width, height);
      const Box b = box_of(t, width, height);
      if (b.x0 <= tx0 + kTile - 1 && b.x1 >= tx0 && b.y0 <= ty0 + kTile - 1 &&
          b.y1 >= ty0) {
        bx = make_int4(b.x0, b.x1, b.y0, b.y1);
        tr = make_float4(t.cx, t.cy, t.sx, t.sy);
      }
    }
    __syncthreads();  // the previous chunk's reads are done
    s_tri[threadIdx.x] = tr;
    s_box[threadIdx.x] = bx;
    __syncthreads();
    const int m = min(kBlock, n - base);
    for (int k = 0; k < m; ++k) {
      const int4 b = s_box[k];
      if (gx < b.x || gx > b.y || gy < b.z || gy > b.w) continue;
      const float4 t = s_tri[k];
      float hw;
      if (row_of(gy, t.y, t.z, t.w, hw) && col_in(gx, t.x, hw)) ++hits;
    }
  }
  // each pixel has one owner here, and raster_kernel ended before this began
  if (hits && gx < width && gy < height) counts[gy * width + gx] += hits;
}

__global__ void __launch_bounds__(kBlock)
    blend_u8_kernel(const int* __restrict__ counts,
                    unsigned char* __restrict__ out, int npix,
                    const __grid_constant__ Lut lut) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= npix) return;
  const int c = counts[i];
  out[i] = lut.v[c < 255 ? c : 255];
}

}  // namespace

// One frame on `stream`: zero the (height, width) int32 counts and the list
// length, then raster_kernel over n float32 bodies and, for triangles,
// raster_big_kernel over the frame's tiles. view_proj is 16 host floats,
// row-major; list holds at least max(n, 1) int32. Returns the cudaError_t
// of the launches (0 = success).
extern "C" int raster_launch(const void* pos, int n, const float* view_proj,
                             int width, int height, int splat, void* counts,
                             void* list, void* list_len, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(width) * height, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(list_len, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Mat M;
  for (int k = 0; k < 16; ++k) M.m[k] = view_proj[k];
  const float* p = static_cast<const float*>(pos);
  int* c = static_cast<int*>(counts);
  int* l = static_cast<int*>(list);
  int* len = static_cast<int*>(list_len);
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    if (splat) {
      raster_kernel<true><<<grid, kBlock, 0, s>>>(p, n, M, width, height, c, l, len);
    } else {
      raster_kernel<false><<<grid, kBlock, 0, s>>>(p, n, M, width, height, c, l, len);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!splat) {
    const dim3 tiles((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
    raster_big_kernel<<<tiles, kBlock, 0, s>>>(p, l, len, M, width, height, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i] = lut[min(counts[i], 255)] for npix pixels on `stream`; lut is 256
// host bytes. Returns the cudaError_t of the launch (0 = success).
extern "C" int raster_blend_launch(const void* counts, void* out, int npix,
                                   const unsigned char* lut, int device,
                                   void* stream) {
  if (npix <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Lut L;
  for (int k = 0; k < 256; ++k) L.v[k] = lut[k];
  blend_u8_kernel<<<(npix + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<unsigned char*>(out), npix, L);
  return static_cast<int>(cudaGetLastError());
}
