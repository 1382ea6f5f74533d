// Per-particle Barnes-Hut theta walk for Hopper (sm_90a).
//
// Replaces the XLA while-loop wgpu_n_body_tpu/ops/tree_walk.py::tree_forces
// (the JAX package could not write it in Pallas: a TPU kernel cannot gather
// per lane). One thread per receiver walks the DFS arena of
// ops/tree_build.py without a stack:
//
//     cur = active ? 0 : num_nodes
//     while cur < num_nodes:
//         row = nodes[cur]                       (two float4 loads)
//         d = cog - p,  r2 = |d|^2,  dist = sqrt(r2)
//         accept (width < theta*dist):  acc += m*g*dt / (r2*dist + e) / dist * d,
//                                       cur = skip[cur]
//         terminal cell (no_child > 0): direct sum over the sorted sources
//                                       [first + koff, first + min(koff + bucket, count)),
//                                       self excluded by index; an overfull
//                                       max-depth cell (no_child == 2) stays on
//                                       the node for the next chunk, else
//                                       cur = skip[cur]
//         otherwise open:               cur = cur + 1
//
// with the JAX formulas in their order of operations, and each node's
// contribution (its own term, then its members in order) summed into a
// partial before it joins the total, as JAX's per-iteration `acc +`. The
// build clamps num_nodes to the arena, so an overflowed tree terminates.
//
// Built with -fmad=false (ops/tree_walk_cuda.py): nvcc would otherwise
// contract dx*dx + dy*dy + dz*dz and r2*dist + e into FMAs, which rounds
// differently from the plain torch version (one elementwise kernel per
// operation, never contracted) and can flip a borderline width < theta*dist
// decision. Without contraction the per-node arithmetic is the plain
// version's, operation for operation (IEEE sqrt and divide: no fast math).
//
// What bounds it on H100: dependent gathers and warp divergence, not
// arithmetic. Each step's node index comes from the previous step's row,
// so a thread waits one memory latency per node (about 300-600 cycles from
// L2, less from L1), and the 32 threads of a warp each follow their own
// path. What the design does about it:
// - Receivers come in Morton order (TreeSim sorts every step), so the
//   threads of a warp are spatial neighbours: they open and accept mostly
//   the same nodes and their loads hit the same lines of L1 and L2.
// - A node row is 32 bytes, read as two 16-byte loads through the
//   read-only path (__ldg); the arena of a 4M-particle tree (about 2M
//   rows, 64 MB) mostly stays in the 50 MB L2 for its upper levels.
// - Many warps per SM (small register footprint, 128-thread blocks) hide
//   the latency of one warp's chain behind the others'.
// Still to do in later work: the group walk (ROADMAP B4), which shares one
// traversal among a tile of receivers.

#include <cuda_runtime.h>

namespace {

__global__ void tree_walk_kernel(
    const float* __restrict__ pos_new, const float4* __restrict__ src,
    const float4* __restrict__ nodes, const int* __restrict__ skip,
    const int* __restrict__ first, const int* __restrict__ count,
    const int* __restrict__ num_nodes_ptr, const int* __restrict__ self_idx,
    const unsigned char* __restrict__ active, float* __restrict__ out, int b,
    float theta, float gdt, float e, int bucket) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const float px = pos_new[3 * i + 0];
  const float py = pos_new[3 * i + 1];
  const float pz = pos_new[3 * i + 2];
  const int me = self_idx[i];
  const int num_nodes = *num_nodes_ptr;
  int cur = (active == nullptr || active[i]) ? 0 : num_nodes;
  int koff = 0;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  while (cur < num_nodes) {
    const float4 cm = __ldg(&nodes[2 * cur]);      // cog xyz, mass
    const float4 geo = __ldg(&nodes[2 * cur + 1]);  // width, is_single, no_child, -
    const float dx = cm.x - px;
    const float dy = cm.y - py;
    const float dz = cm.z - pz;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float dist = sqrtf(r2);
    float tx = 0.0f, ty = 0.0f, tz = 0.0f;
    int nxt = cur + 1;
    if (geo.x < theta * dist) {
      const float w = cm.w * gdt / (r2 * dist + e) / dist;
      tx = w * dx;
      ty = w * dy;
      tz = w * dz;
      nxt = __ldg(&skip[cur]);
    } else if (geo.z > 0.0f) {
      const int f = __ldg(&first[cur]);
      const int cnt = __ldg(&count[cur]);
      const int end = f + min(koff + bucket, cnt);
      for (int j = f + koff; j < end; ++j) {
        if (j == me) continue;  // the self pair adds exactly 0 in the plain version
        const float4 s = __ldg(&src[j]);
        const float sdx = s.x - px;
        const float sdy = s.y - py;
        const float sdz = s.z - pz;
        const float sr2 = sdx * sdx + sdy * sdy + sdz * sdz;
        const float sd = sqrtf(sr2);
        const float sw = s.w * gdt / (sr2 * sd + e) / sd;
        tx += sw * sdx;
        ty += sw * sdy;
        tz += sw * sdz;
      }
      if (koff + bucket < cnt) {
        koff += bucket;  // overfull max-depth cell: stay for the next chunk
        nxt = cur;
      } else {
        koff = 0;
        nxt = __ldg(&skip[cur]);
      }
    }
    ax += tx;
    ay += ty;
    az += tz;
    cur = nxt;
  }
  out[3 * i + 0] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

}  // namespace

// pos_new (b, 3) f32 receivers; src (n, 4) f32 sorted sources (x, y, z, m);
// nodes (cap+1, 8) f32; skip/first/count (cap+1,) int32; num_nodes a
// device int32 scalar; self_idx (b,) int32; active (b,) uint8 or null;
// out (b, 3) f32. Launches on `stream`, returns the cudaError_t of the
// launch (0 on success), does not synchronise.
extern "C" int tree_walk_launch(const void* pos_new, const void* src,
                                const void* nodes, const void* skip,
                                const void* first, const void* count,
                                const void* num_nodes, const void* self_idx,
                                const void* active, void* out, int b,
                                float theta, float gdt, float e, int bucket,
                                int block, int device, void* stream) {
  if (b <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b + block - 1) / block;
  tree_walk_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_new), static_cast<const float4*>(src),
      static_cast<const float4*>(nodes), static_cast<const int*>(skip),
      static_cast<const int*>(first), static_cast<const int*>(count),
      static_cast<const int*>(num_nodes), static_cast<const int*>(self_idx),
      static_cast<const unsigned char*>(active), static_cast<float*>(out), b,
      theta, gdt, e, bucket);
  return static_cast<int>(cudaGetLastError());
}
