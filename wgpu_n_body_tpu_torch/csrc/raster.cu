// The renderer's raster (B6) for Hopper (sm_90a).
//
// Replaces the raster tiers of wgpu_n_body_tpu/runners/renderer.py:
// _device_raster_fn (:435) with _window_run_counts (:279), the compacted
// second pass _medium_raster_fn (:343), the dense third pass _big_raster_fn
// (:382), the host composite past their caps (raster_resolve, :578) and the
// u8 blend _combine_blend_u8_fn (:659). Every tier there works around the
// TPU's slow random scatter; on Hopper an integer atomicAdd is cheap and
// order-free, so a frame is two kernels, and serve adds a blend:
//
// 1. raster_kernel, one thread per body: the projection in float64 from the
//    float32 inputs, ((x m[r,0] + y m[r,1]) + z m[r,2]) + m[r,3] with
//    __dmul_rn / __dadd_rn, rounded once to float32 (ops/raster.py::project);
//    the cull and the pixel-space triangle in float32 with __fmul_rn /
//    __fadd_rn / __fdiv_rn in the JAX op order (ops/raster.py::triangles);
//    the pixels it may light as the JAX host tests them (ops/raster.py::
//    boxes), clipped to the frame. A box of at most kSmallBox x kSmallBox
//    pixels is tested here by the pixel-centre rule (ops/raster.py::covers);
//    a larger one (a body near the lens) appends its triangle (centre and
//    half-extents, 16 bytes) to the list through one atomic counter, and is
//    drawn here like a small one only if the list is full. A splat is the
//    truncated, clamped pixel of its centre. Each hit is one atomicAdd into
//    the workspace's int32 counts: the card merges a warp's adds to one
//    address in device memory itself, where shared-memory atomics serialise
//    them (a block-private patch of counts in shared memory, and lanes merged
//    by __match_any_sync, were both measured slower: PERF.md).
// 2. raster_tile_kernel, one CTA per kTile x kTile pixels, a thread per
//    pixel: the CTA reads the list kBlock triangles at a time, keeps those
//    whose box meets its tile (a warp ballot and a prefix into shared
//    memory), and each pixel tests only those, so its work follows the area
//    the footprints cover and no CTA projects a body. It writes the frame's
//    counts (the workspace's plus its own hits) and zeroes the workspace's;
//    its last CTA zeroes the list length. The workspace, one per device,
//    stream and frame size, is left zero for the next frame: a frame needs
//    no memset.
// 3. blend_u8_kernel, a thread per pixel: counts -> u8 through the 256-entry
//    LUT of ops/raster.py::blend_lut_u8, a __grid_constant__ parameter
//    (constant memory).
//
// No contraction and no fast divide anywhere: the counts are bit-equal to
// the plain version and to the host render from the same positions,
// whichever kernel a triangle falls to, and integer atomics make
// them independent of the order of the adds.
//
// What bounds it on H100: bytes. A frame reads 12 B per body and writes 4 B
// per pixel (the record also counts reading the counts back and 4 B per
// listed body); the blend reads 4 B and writes 1 B per pixel. At the
// visualize scene (N=100000, 400x400) that is 2.6 MB, ~1 us at 3.35 TB/s, so
// a frame is launch-bound; at N=4M it is 49.6 MB.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kSmallBox = 8;  // a box this wide and high is drawn by its own thread
constexpr int kTile = 16;     // raster_tile_kernel: kTile x kTile pixels per CTA
constexpr unsigned kFull = 0xffffffffu;
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
                  int* __restrict__ acc, float4* __restrict__ tris, int cap,
                  int* __restrict__ meta) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const Tri t = triangle<kSplat>(pos, i, M, width, height);
  if (!t.keep) return;
  if (kSplat) {
    const int px = min(max(__float2int_rz(t.cx), 0), width - 1);
    const int py = min(max(__float2int_rz(t.cy), 0), height - 1);
    atomicAdd(acc + py * width + px, 1);
    return;
  }
  const Box b = box_of(t, width, height);
  if (b.x1 < b.x0 || b.y1 < b.y0) return;
  if (b.x1 - b.x0 >= kSmallBox || b.y1 - b.y0 >= kSmallBox) {
    const int slot = atomicAdd(meta, 1);
    if (slot < cap) {
      tris[slot] = make_float4(t.cx, t.cy, t.sx, t.sy);
      return;
    }  // the list is full: drawn here like a small one
  }
  for (int gy = b.y0; gy <= b.y1; ++gy) {
    float hw;
    if (!row_of(gy, t.cy, t.sx, t.sy, hw)) continue;
    for (int gx = b.x0; gx <= b.x1; ++gx) {
      if (col_in(gx, t.cx, hw)) atomicAdd(acc + gy * width + gx, 1);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    raster_tile_kernel(const float4* __restrict__ tris, int cap, int* __restrict__ meta,
                       int width, int height, int* __restrict__ acc,
                       int* __restrict__ counts) {
  __shared__ float4 s_tri[kBlock];
  __shared__ int4 s_box[kBlock];
  __shared__ int s_warp[kWarps];
  __shared__ int s_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int gx = tx0 + threadIdx.x % kTile, gy = ty0 + threadIdx.x / kTile;
  if (threadIdx.x == 0) {
    const int len = min(*meta, cap);
    s_len = len;
    // the last CTA to read the length leaves it zero for the next frame
    if (atomicAdd(meta + 1, 1) == static_cast<int>(gridDim.x * gridDim.y) - 1) {
      meta[2] = len;  // the frame's listed count, for the caller
      meta[0] = 0;
      meta[1] = 0;
    }
  }
  __syncthreads();
  const int len = s_len;
  int hits = 0;
  for (int base = 0; base < len; base += kBlock) {
    const int j = base + threadIdx.x;
    bool meets = false;
    float4 tr;
    Box b;
    if (j < len) {
      tr = tris[j];
      b = box_of(Tri{true, tr.x, tr.y, tr.z, tr.w}, width, height);
      meets = b.x0 <= tx0 + kTile - 1 && b.x1 >= tx0 && b.y0 <= ty0 + kTile - 1 && b.y1 >= ty0;
    }
    const unsigned ballot = __ballot_sync(kFull, meets);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();  // also: the previous chunk's reads of s_tri are done
    int at = __popc(ballot & ((1u << lane) - 1)), m = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) at += s_warp[k];
      m += s_warp[k];
    }
    if (meets) {
      s_tri[at] = tr;
      s_box[at] = make_int4(b.x0, b.x1, b.y0, b.y1);
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const int4 c = s_box[k];
      if (gx < c.x || gx > c.y || gy < c.z || gy > c.w) continue;
      const float4 u = s_tri[k];
      float hw;
      if (row_of(gy, u.y, u.z, u.w, hw) && col_in(gx, u.x, hw)) ++hits;
    }
  }
  if (gx < width && gy < height) {
    const int p = gy * width + gx;
    counts[p] = acc[p] + hits;
    acc[p] = 0;
  }
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

// One frame on `stream`: raster_kernel over n float32 bodies, then
// raster_tile_kernel over the frame's tiles, which writes the (height,
// width) int32 counts. view_proj is 16 host floats, row-major. The
// workspace, which every frame of this size on this stream shares and
// leaves as it found it: acc, (height, width) int32, and meta, 3 int32,
// zero when first given; tris, cap float4 (the listed triangles; a frame
// with more than cap draws the rest in raster_kernel). After the frame
// meta[2] holds its listed count and tris[0, meta[2]) its listed triangles.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int raster_launch(const void* pos, int n, const float* view_proj,
                             int width, int height, int splat, void* counts,
                             void* acc, void* tris, int cap, void* meta,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Mat M;
  for (int k = 0; k < 16; ++k) M.m[k] = view_proj[k];
  const float* p = static_cast<const float*>(pos);
  int* a = static_cast<int*>(acc);
  float4* l = static_cast<float4*>(tris);
  int* mt = static_cast<int*>(meta);
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    if (splat) {
      raster_kernel<true><<<grid, kBlock, 0, s>>>(p, n, M, width, height, a, l, cap, mt);
    } else {
      raster_kernel<false><<<grid, kBlock, 0, s>>>(p, n, M, width, height, a, l, cap, mt);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 tiles((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  raster_tile_kernel<<<tiles, kBlock, 0, s>>>(l, cap, mt, width, height, a,
                                              static_cast<int*>(counts));
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
