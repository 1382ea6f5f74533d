// Octree arena build for Hopper (sm_90a).
//
// Replaces the XLA ops of wgpu_n_body_tpu/ops/tree_build.py::build_tree
// (with ops/morton.py::split_levels and the scans of ops/scan.py), which the
// port first carried as ~300 torch kernels over (depth+1) x n level arrays
// (ops/tree_build.py::build_tree, now the plain version), and the gathers of
// ops/tree_build.py::morton_sort. From the bodies in their input order, the
// sort's permutation and the sorted packed keys (csrc/morton_keys.cu: one
// 3*depth-bit key, level L at bits [3(depth-L), 3(depth-L)+2]) it writes the
// sorted state and the DFS node arena: nodes_f32, skip, first, count,
// num_nodes, root_width, overflowed, and the split levels.
//
// The cell of a node at level L is a run of equal 3L-bit key prefixes, and
// DFS node order is lexicographic (first particle, level). Four kernels:
//
// 1. tree_reorder_kernel, one thread per sorted slot i:
//      the body perm[i]'s pos, vel, acc and mass into slot i of the sorted
//      state (the state's reorder: bit-equal to x[perm]);
//      split[i]  = first level at which key[i] differs from key[i-1]
//                  (0 for i = 0, depth+1 for equal keys): i starts a run at
//                  exactly the levels >= split[i];
//      window[i] = first level at which key[i] differs from key[i+bucket].
//    Keys are sorted, so window[i] = min(split[i+1 .. i+bucket]): the run of
//    level L that holds particles i and i+bucket holds more than `bucket`
//    particles exactly when L < window[i]. One XOR and count-leading-zeros
//    per value, whatever the bucket.
// 2. tree_count_kernel, one thread per particle i, 1024 per block:
//      t[i] = max(window[p]) over the windows [p, p+bucket] that hold i
//           = the number of levels whose run around i exceeds the bucket
//             (run sizes shrink with level, so those levels are 0..t-1);
//      c[i] = clamp(min(t, depth) - split[i] + 1, 0), the nodes whose first
//      particle is i (levels split[i] .. min(t, depth));
//      w[i] = mass, m*x, m*y, m*z as float64 (products in float32, as the
//      plain version forms them);
//    then the block's exclusive scan of c (int32) and w (float64), and the
//    block's totals.
// 3. tree_blocks_kernel, one block: the exclusive scan of the block totals.
//    The prefix at particle j is block_prefix[j / 1024] + in_block[j]; no
//    pass writes it out, the emission adds the two where it needs one.
// 4. tree_emit_kernel, one thread per arena row k (cap+1 of them):
//      rows k >= num_nodes = min(node total, cap) get the inert sentinel;
//      owner: the largest i with offset(i) <= k, by binary search over the
//        block prefixes and then inside the block (what
//        searchsorted(csum, k, right=True) picks: particles without nodes
//        share an offset with their successor, and the last of them owns);
//      level = split[i] + (k - offset(i));
//      run end: the first j > i whose level-L key prefix differs from i's.
//        The keys are sorted, so the prefix key >> 3(depth-L) is monotone:
//        a galloping search from i (1, 2, 4, ... ahead) brackets the end and
//        a binary search pins it, 2*log2(count) key loads. A leaf costs a
//        handful of loads near i, the root 2*log2(n) across the array, and
//        no table of run ends per level exists;
//      count = end - i, skip = offset(end) (unclamped, as the plain
//        version: a truncated subtree's skip may point past num_nodes),
//      totals = sums(end) - sums(i), cog = total m*p / total m (IEEE
//        divide; a singleton keeps its particle's position exactly),
//      width = root_width * 2^-level exactly, no_child 0 / 1 / 2.
//    Thread 0 also writes num_nodes, root_width and overflowed.
//
// The scans are written here and not left to a library because the
// library's is not reproducible: a decoupled-look-back scan (torch.cumsum on
// the card) groups its float64 partial sums by the timing of its blocks, so
// two builds of one input differ in the last bits wherever the sums are
// inexact. Here every sum has a fixed order (Kogge-Stone steps inside a warp,
// the 32 warp totals likewise, the block totals in fixed chunks), so a build
// is a function of its input, bit for bit.
//
// The totals repeat the plain version's arithmetic, which is the JAX
// package's float-float contract: each float64 prefix sum is split into its
// float32 rounding (hi) and the float32 rounding of the remainder (lo), and a
// range sums to (hi[b] - hi[a]) + (lo[b] - lo[a]) in float32. Given these
// prefix sums, the plain version returns the same arena bit for bit.
//
// What bounds it on H100: bytes, and few of them. The reorder reads 52 bytes
// per body (perm, the state's 40, the key) and writes 42; its loads of the
// state are gathers, local once the state is sorted from the step before.
// The build then reads 24 bytes per particle and writes 44 per arena row;
// the in-block scans add 36 per particle written once and read where a node
// begins or ends. The emission's searches are dependent loads, a few dozen
// per live row, mostly within a few cache lines of the owner; dead rows
// (half the arena at the default capacity) only store the sentinel. Nothing
// is read back to the host, nothing is allocated here, and every launch goes
// on the caller's stream.

#include <cuda_runtime.h>

namespace {

// Far position of the sentinel row and of unused arena rows
// (ops/tree_build.py::FAR).
constexpr float kFar = 1e15f;

// First level at which two packed keys differ; depth+1 when they are equal
// (ops/morton.py::diff_levels).
__device__ __forceinline__ int split_level(unsigned long long a,
                                           unsigned long long b, int depth) {
  const unsigned long long x = a ^ b;
  return x != 0 ? depth - (63 - __clzll(static_cast<long long>(x))) / 3
                : depth + 1;
}

__global__ void tree_reorder_kernel(
    const int* __restrict__ perm, const unsigned long long* __restrict__ keys,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ acc, const float* __restrict__ mass,
    float* __restrict__ pos_s, float* __restrict__ vel_s,
    float* __restrict__ acc_s, float* __restrict__ mass_s,
    unsigned char* __restrict__ split, unsigned char* __restrict__ window,
    int n, int depth, int bucket) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = static_cast<size_t>(perm[i]);
  const size_t d = 3 * static_cast<size_t>(i);
  for (int q = 0; q < 3; ++q) {
    pos_s[d + q] = pos[3 * p + q];
    vel_s[d + q] = vel[3 * p + q];
    acc_s[d + q] = acc[3 * p + q];
  }
  mass_s[i] = mass[p];
  const unsigned long long k = keys[i];
  split[i] = i == 0 ? 0 : split_level(keys[i - 1], k, depth);
  const long long j = static_cast<long long>(i) + bucket;
  window[i] = j < n ? split_level(k, keys[j], depth) : 0;
}

// Particles per block of the scans: 32 warps, one particle per thread.
constexpr int kScan = 1024;

// Exclusive scan over the block's kScan threads of c (int) and w[4]
// (float64), in a fixed order; the block's totals go to *total_c and
// total_w[0..3] (written by one thread).
__device__ __forceinline__ void block_scan(int& c, double (&w)[4], int* total_c,
                                           double* total_w) {
  __shared__ int sh_c[32];
  __shared__ double sh_w[32][4];
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto warp_scan = [&](int& ic, double (&iw)[4]) {  // inclusive, Kogge-Stone
    for (int d = 1; d < 32; d <<= 1) {
      const int vc = __shfl_up_sync(kAll, ic, d);
      double vw[4];
      for (int q = 0; q < 4; ++q) vw[q] = __shfl_up_sync(kAll, iw[q], d);
      if (lane >= d) {
        ic += vc;
        for (int q = 0; q < 4; ++q) iw[q] += vw[q];
      }
    }
  };
  auto shift = [&](int& ic, double (&iw)[4]) {  // inclusive -> exclusive
    ic = __shfl_up_sync(kAll, ic, 1);
    for (int q = 0; q < 4; ++q) iw[q] = __shfl_up_sync(kAll, iw[q], 1);
    if (lane == 0) {
      ic = 0;
      for (int q = 0; q < 4; ++q) iw[q] = 0.0;
    }
  };
  warp_scan(c, w);
  if (lane == 31) {
    sh_c[warp] = c;
    for (int q = 0; q < 4; ++q) sh_w[warp][q] = w[q];
  }
  shift(c, w);
  __syncthreads();
  if (warp == 0) {
    int tc = sh_c[lane];
    double tw[4];
    for (int q = 0; q < 4; ++q) tw[q] = sh_w[lane][q];
    warp_scan(tc, tw);
    if (lane == 31) {
      *total_c = tc;
      for (int q = 0; q < 4; ++q) total_w[q] = tw[q];
    }
    shift(tc, tw);
    sh_c[lane] = tc;
    for (int q = 0; q < 4; ++q) sh_w[lane][q] = tw[q];
  }
  __syncthreads();
  c += sh_c[warp];
  for (int q = 0; q < 4; ++q) w[q] = sh_w[warp][q] + w[q];
}

__global__ void __launch_bounds__(kScan)
tree_count_kernel(const unsigned char* __restrict__ split,
                  const unsigned char* __restrict__ window,
                  const float* __restrict__ pos,
                  const float* __restrict__ mass, int* __restrict__ in_block_c,
                  double* __restrict__ in_block_w, int* __restrict__ block_c,
                  double* __restrict__ block_w, int n, int depth, int bucket) {
  const int i = blockIdx.x * kScan + threadIdx.x;
  int c = 0;
  double w[4] = {0.0, 0.0, 0.0, 0.0};
  if (i < n) {
    // windows [p, p+bucket] inside [0, n) that hold i
    const long long p_lo = i > bucket ? i - bucket : 0;
    const long long last = static_cast<long long>(n) - 1 - bucket;
    const long long p_hi = i < last ? i : last;
    int t = 0;
    for (long long p = p_lo; p <= p_hi && t <= depth; ++p) {
      const int v = window[p];
      t = v > t ? v : t;
    }
    const int top = t < depth ? t : depth;
    c = top - static_cast<int>(split[i]) + 1;
    c = c > 0 ? c : 0;
    const float m = mass[i];
    w[0] = static_cast<double>(m);
    w[1] = static_cast<double>(__fmul_rn(m, pos[3 * i + 0]));
    w[2] = static_cast<double>(__fmul_rn(m, pos[3 * i + 1]));
    w[3] = static_cast<double>(__fmul_rn(m, pos[3 * i + 2]));
  }
  block_scan(c, w, block_c + blockIdx.x, block_w + 4 * blockIdx.x);
  if (i < n) {
    in_block_c[i] = c;
    double2* out = reinterpret_cast<double2*>(in_block_w) + 2 * static_cast<size_t>(i);
    out[0] = make_double2(w[0], w[1]);
    out[1] = make_double2(w[2], w[3]);
  }
}

// The exclusive scan of the nb block totals, entry nb the grand totals: each
// thread sums a fixed chunk of consecutive blocks in order, the threads'
// totals are scanned, and the chunk is walked again from the thread's prefix.
__global__ void __launch_bounds__(kScan)
tree_blocks_kernel(const int* __restrict__ block_c,
                   const double* __restrict__ block_w,
                   int* __restrict__ prefix_c, double* __restrict__ prefix_w,
                   int nb) {
  const int per = (nb + kScan - 1) / kScan;
  const long long lo = static_cast<long long>(threadIdx.x) * per;
  const long long hi = lo + per < nb ? lo + per : nb;
  int c = 0;
  double w[4] = {0.0, 0.0, 0.0, 0.0};
  for (long long b = lo; b < hi; ++b) {
    c += block_c[b];
    for (int q = 0; q < 4; ++q) w[q] += block_w[4 * b + q];
  }
  block_scan(c, w, prefix_c + nb, prefix_w + 4 * static_cast<size_t>(nb));
  for (long long b = lo; b < hi; ++b) {
    prefix_c[b] = c;
    for (int q = 0; q < 4; ++q) prefix_w[4 * b + q] = w[q];
    c += block_c[b];
    for (int q = 0; q < 4; ++q) w[q] += block_w[4 * b + q];
  }
}

// A range's float32 total from the float64 prefix sums at its ends, in the
// plain version's float-float arithmetic (ops/scan.py::ff_cumsum_ext).
__device__ __forceinline__ float range_total(double a, double b) {
  const float hi_a = static_cast<float>(a), hi_b = static_cast<float>(b);
  const float lo_a = static_cast<float>(a - static_cast<double>(hi_a));
  const float lo_b = static_cast<float>(b - static_cast<double>(hi_b));
  return __fadd_rn(__fsub_rn(hi_b, hi_a), __fsub_rn(lo_b, lo_a));
}

__global__ void tree_emit_kernel(
    const unsigned long long* __restrict__ keys, const float* __restrict__ pos,
    const unsigned char* __restrict__ split, const float* __restrict__ bound,
    const int* __restrict__ in_block_c, const double* __restrict__ in_block_w,
    const int* __restrict__ prefix_c, const double* __restrict__ prefix_w,
    float4* __restrict__ nodes,
    int* __restrict__ skip, int* __restrict__ first, int* __restrict__ count,
    int* __restrict__ num_nodes_out, float* __restrict__ root_width_out,
    unsigned char* __restrict__ overflowed_out, int n, int nb, int cap,
    int depth, int bucket) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > cap) return;
  const int total = prefix_c[nb];
  const int num_nodes = total < cap ? total : cap;
  const float root_width = 2.0f * bound[0];
  if (k == 0) {
    *num_nodes_out = num_nodes;
    *root_width_out = root_width;
    *overflowed_out = total > cap ? 1 : 0;
  }
  if (k >= num_nodes) {  // unused rows and the sentinel row `cap`
    nodes[2 * static_cast<size_t>(k)] = make_float4(kFar, 0.0f, 0.0f, 0.0f);
    nodes[2 * static_cast<size_t>(k) + 1] = make_float4(0.0f, 0.0f, 1.0f, 0.0f);
    skip[k] = cap;
    first[k] = n;
    count[k] = 0;
    return;
  }

  // owner: the largest i in [0, n) with offset(i) <= k; first its block
  int a = 0, b = nb - 1;
  while (a < b) {
    const int mid = a + (b - a + 1) / 2;
    if (prefix_c[mid] <= k) a = mid; else b = mid - 1;
  }
  const int rel = k - prefix_c[a];  // k among the block's nodes
  a *= kScan;
  b = (n - a < kScan ? n : a + kScan) - 1;
  while (a < b) {
    const int mid = a + (b - a + 1) / 2;
    if (in_block_c[mid] <= rel) a = mid; else b = mid - 1;
  }
  const int i = a;
  int level = static_cast<int>(split[i]) + (rel - in_block_c[i]);
  level = level < 0 ? 0 : (level > depth ? depth : level);

  // run end: the first j > i outside i's cell at `level`
  const int shift = 3 * (depth - level);
  const unsigned long long want = keys[i] >> shift;
  auto same_cell = [&](long long j) { return (keys[j] >> shift) == want; };
  long long in = i, step = 1;  // `in` is inside the cell
  while (i + step < n && same_cell(i + step)) {
    in = i + step;
    step <<= 1;
  }
  long long out = i + step < n ? i + step : n;  // outside the cell, or n
  while (out - in > 1) {
    const long long mid = in + (out - in) / 2;
    if (same_cell(mid)) in = mid; else out = mid;
  }
  const int end = static_cast<int>(out);
  const int cnt = end - i;

  // prefix sums at i and at end: the block's prefix plus the in-block scan
  const double2* inb = reinterpret_cast<const double2*>(in_block_w);
  const double2* pre = reinterpret_cast<const double2*>(prefix_w);
  auto sums_at = [&](int j, double (&v)[4]) {
    const int blk = j < n ? j / kScan : nb;
    const double2 p0 = pre[2 * static_cast<size_t>(blk)];
    const double2 p1 = pre[2 * static_cast<size_t>(blk) + 1];
    v[0] = p0.x; v[1] = p0.y; v[2] = p1.x; v[3] = p1.y;
    if (j < n) {
      const double2 e0 = inb[2 * static_cast<size_t>(j)];
      const double2 e1 = inb[2 * static_cast<size_t>(j) + 1];
      v[0] += e0.x; v[1] += e0.y; v[2] += e1.x; v[3] += e1.y;
    }
  };
  double at_i[4], at_end[4];
  sums_at(i, at_i);
  sums_at(end, at_end);
  float tot[4];
  for (int q = 0; q < 4; ++q) tot[q] = range_total(at_i[q], at_end[q]);
  const bool single = cnt == 1;
  float4 row0, row1;
  if (single) {  // the particle's exact position (tree.rs:525-529)
    row0.x = pos[3 * i + 0];
    row0.y = pos[3 * i + 1];
    row0.z = pos[3 * i + 2];
  } else {
    row0.x = tot[1] / tot[0];
    row0.y = tot[2] / tot[0];
    row0.z = tot[3] / tot[0];
  }
  row0.w = tot[0];
  row1.x = root_width * __int_as_float((127 - level) << 23);  // * 2^-level
  row1.y = single ? 1.0f : 0.0f;
  const bool terminal = cnt <= bucket || level == depth;
  row1.z = terminal ? (cnt > bucket ? 2.0f : 1.0f) : 0.0f;
  row1.w = 0.0f;
  nodes[2 * static_cast<size_t>(k)] = row0;
  nodes[2 * static_cast<size_t>(k) + 1] = row1;
  skip[k] = end < n ? prefix_c[end / kScan] + in_block_c[end] : total;
  first[k] = i;
  count[k] = cnt;
}

}  // namespace

// Particles per block of the scans: the wrapper sizes the block arrays
// (ceil(n / this) totals, one more prefix) by it.
extern "C" int tree_build_scan_block() { return kScan; }

// The reorder of n bodies into the sorted order, with the split and window
// levels of the sorted keys, on `stream`. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int tree_reorder_launch(const void* perm, const void* keys,
                                   const void* pos, const void* vel,
                                   const void* acc, const void* mass,
                                   void* pos_s, void* vel_s, void* acc_s,
                                   void* mass_s, void* split, void* window,
                                   int n, int depth, int bucket, int block,
                                   int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_reorder_kernel<<<(n + block - 1) / block, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(perm),
      static_cast<const unsigned long long*>(keys),
      static_cast<const float*>(pos), static_cast<const float*>(vel),
      static_cast<const float*>(acc), static_cast<const float*>(mass),
      static_cast<float*>(pos_s), static_cast<float*>(vel_s),
      static_cast<float*>(acc_s), static_cast<float*>(mass_s),
      static_cast<unsigned char*>(split), static_cast<unsigned char*>(window),
      n, depth, bucket);
  return static_cast<int>(cudaGetLastError());
}

// The other three kernels of one build, in order, on `stream`, after the
// reorder. Returns the cudaError_t of the first launch that failed
// (0 = success).
extern "C" int tree_build_launch(
    const void* keys, const void* pos, const void* mass,
    const void* bound, const void* split, const void* window, void* in_block_c,
    void* in_block_w, void* block_c, void* block_w, void* prefix_c,
    void* prefix_w, void* nodes, void* skip, void* first, void* count,
    void* num_nodes, void* root_width, void* overflowed, int n, int cap,
    int depth, int bucket, int block, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + kScan - 1) / kScan;
  tree_count_kernel<<<nb, kScan, 0, s>>>(
      static_cast<const unsigned char*>(split),
      static_cast<const unsigned char*>(window),
      static_cast<const float*>(pos), static_cast<const float*>(mass),
      static_cast<int*>(in_block_c), static_cast<double*>(in_block_w),
      static_cast<int*>(block_c), static_cast<double*>(block_w), n, depth,
      bucket);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_blocks_kernel<<<1, kScan, 0, s>>>(
      static_cast<const int*>(block_c), static_cast<const double*>(block_w),
      static_cast<int*>(prefix_c), static_cast<double*>(prefix_w), nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_emit_kernel<<<(cap + block) / block, block, 0, s>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const float*>(pos), static_cast<const unsigned char*>(split),
      static_cast<const float*>(bound), static_cast<const int*>(in_block_c),
      static_cast<const double*>(in_block_w),
      static_cast<const int*>(prefix_c), static_cast<const double*>(prefix_w),
      static_cast<float4*>(nodes), static_cast<int*>(skip),
      static_cast<int*>(first), static_cast<int*>(count),
      static_cast<int*>(num_nodes), static_cast<float*>(root_width),
      static_cast<unsigned char*>(overflowed), n, nb, cap, depth, bucket);
  return static_cast<int>(cudaGetLastError());
}
