// Host-side octree build — native C++ equivalent of the reference's
// host-native tree infrastructure:
//   - BFS subdivision build      (reference: src/sims/tree.rs:417-546)
//   - bump arena allocation      (reference: src/utils/slice_alloc.rs)
//   - DFS locality sort          (reference: src/sims/tree.rs:564-602)
// plus an exporter of the DFS skip-pointer arena consumed by the device
// walk kernels (ops/tree_build.py layout).
//
// Built by wgpu_n_body_tpu_torch/native/build.py (g++ -O3 -fopenmp, into
// the package's _build/ directory) and loaded via ctypes. Used as (a) a
// parity oracle for the on-device Morton build and (b) the host half of
// the hybrid TreeSimHost backend, mirroring the reference's
// CPU-build/GPU-walk split. The same source as the JAX package's
// native/octree.cpp.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

// Matches the WGSL Octant layout, stride 52 B (tree.wgsl:1-6,32).
struct Octant {
  float cog[3] = {0, 0, 0};
  float mass = 0;
  uint32_t bodies = 0;
  uint32_t children[8] = {0, 0, 0, 0, 0, 0, 0, 0};
};
static_assert(sizeof(Octant) == 52, "Octant must match WGSL stride 52");

struct Partition {
  float center[3];
  float width;
  int64_t octant_ix;  // -1: not yet allocated
  std::vector<int64_t> particles;
  int depth;
};

// (x > cx) | (y > cy) << 1 | (z > cz) << 2   (tree.rs:549-553)
inline int decide_octant(const float* c, const float* p) {
  return int(p[0] > c[0]) | (int(p[1] > c[1]) << 1) | (int(p[2] > c[2]) << 2);
}

// +- width/4 per axis by child bit (tree.rs:556-562)
inline void shift_center(const float* c, float w, int oct, float* out) {
  out[0] = c[0] + ((oct & 1) * 2 - 1) * w / 4.0f;
  out[1] = c[1] + (((oct & 2) >> 1) * 2 - 1) * w / 4.0f;
  out[2] = c[2] + (((oct & 4) >> 2) * 2 - 1) * w / 4.0f;
}

constexpr int kMaxDepth = 64;  // the reference recurses unboundedly and
                               // would hang on exactly-coincident
                               // particles; we fail cleanly instead (-2)

}  // namespace

extern "C" {

// Builds the reference-layout octree.
//   pos:   (n,3) f32, mass: (n,) f32
//   octants: caller buffer for cap Octants (52 B each)
//   root_width_out: 2 * max(|coord|, 1.0)  (tree.rs:424-451)
// Returns number of octants written, or -1 on arena overflow.
int64_t nbody_build_tree(const float* pos, const float* mass, int64_t n,
                         Octant* octants, int64_t cap,
                         float* root_width_out) {
  if (n <= 0) return 0;
  // parallel abs-max reduce with identity 1.0 (tree.rs:424-446)
  float bound = 1.0f;
#pragma omp parallel for reduction(max : bound)
  for (int64_t i = 0; i < n; i++) {
    for (int a = 0; a < 3; a++) {
      float v = std::fabs(pos[3 * i + a]);
      if (v > bound) bound = v;
    }
  }
  *root_width_out = 2.0f * bound;

  int64_t alloc = 0;  // bump index (SliceAlloc::write analog)
  auto bump = [&](int64_t count) -> int64_t {
    int64_t ix = alloc;
    alloc += count;
    return ix;
  };

  std::deque<Partition> queue;
  Partition root;
  root.center[0] = root.center[1] = root.center[2] = 0.0f;
  root.width = 2.0f * bound;
  root.octant_ix = bump(1);
  root.depth = 0;
  root.particles.resize(size_t(n));
  for (int64_t i = 0; i < n; i++) root.particles[size_t(i)] = i;
  queue.push_back(std::move(root));

  while (!queue.empty()) {
    Partition part = std::move(queue.front());
    queue.pop_front();
    Octant oct;
    std::vector<int64_t> buckets[8];
    for (int64_t pi : part.particles) {
      const float* p = &pos[3 * pi];
      float m = mass[pi];
      oct.cog[0] += p[0] * m;
      oct.cog[1] += p[1] * m;
      oct.cog[2] += p[2] * m;
      oct.mass += m;
      buckets[decide_octant(part.center, p)].push_back(pi);
    }
    oct.bodies = uint32_t(part.particles.size());
    oct.cog[0] /= oct.mass;
    oct.cog[1] /= oct.mass;
    oct.cog[2] /= oct.mass;
    for (int c = 0; c < 8; c++) {
      size_t cnt = buckets[c].size();
      if (cnt == 0) continue;  // children[c] stays 0 = absent sentinel
      int64_t child_ix = bump(1);
      if (child_ix >= cap) return -1;
      oct.children[c] = uint32_t(child_ix);
      if (cnt == 1) {
        // leaf: cog = particle position exactly, children[0] = particle
        // index for the locality sort (tree.rs:521-534)
        Octant leaf;
        int64_t pi = buckets[c][0];
        leaf.cog[0] = pos[3 * pi];
        leaf.cog[1] = pos[3 * pi + 1];
        leaf.cog[2] = pos[3 * pi + 2];
        leaf.mass = mass[pi];
        leaf.bodies = 1;
        leaf.children[0] = uint32_t(pi);
        octants[child_ix] = leaf;
      } else if (part.depth + 1 >= kMaxDepth) {
        return -2;  // exactly-coincident cluster; reference would hang
      } else {
        Partition cp;
        shift_center(part.center, part.width, c, cp.center);
        cp.width = part.width / 2.0f;
        cp.octant_ix = child_ix;
        cp.depth = part.depth + 1;
        cp.particles = std::move(buckets[c]);
        queue.push_back(std::move(cp));
      }
    }
    octants[part.octant_ix] = oct;
  }
  return alloc;
}

// DFS locality sort (tree.rs:564-602): writes the particle order the
// reference's sort_particles produces (children visited 0..7).
static void dfs_order(const Octant* octants, uint32_t node,
                      std::vector<int64_t>& out) {
  const Octant& o = octants[node];
  if (o.bodies == 1) {
    out.push_back(int64_t(o.children[0]));
    return;
  }
  for (int c = 0; c < 8; c++) {
    if (o.children[c] != 0) dfs_order(octants, o.children[c], out);
  }
}

int64_t nbody_dfs_order(const Octant* octants, int64_t num_octants,
                        int64_t n, int64_t* order_out) {
  if (n == 0) return 0;
  if (n == 1) {  // root itself is the only body; children[0] is an octant
    order_out[0] = 0;
    return 1;
  }
  std::vector<int64_t> out;
  out.reserve(size_t(n));
  dfs_order(octants, 0, out);
  int64_t m = int64_t(out.size());
  std::memcpy(order_out, out.data(), size_t(m) * sizeof(int64_t));
  (void)num_octants;
  return m;
}

// Exports the DFS skip-pointer arena (ops/tree_build.py layout) from a
// reference-layout tree, for device walks:
//   nodes_f32: (cap+1, 8) [cog xyz, mass, width, is_single, no_child, 0]
//   skip:      (cap+1,) int32
//   first:     (cap+1,) int32 — ORIGINAL index of the node's first
//              particle (callers remap to sorted order via the DFS order)
//   count:     (cap+1,) int32 — particles in the node's subtree
// Returns the DFS node count.
// Also returns via `first` the DFS-position of each subtree's first
// particle because DFS emission visits particles in sorted order.
static int64_t emit_dfs(const Octant* octants, uint32_t node, float width,
                        float* nodes, int32_t* skip, int32_t* first,
                        int32_t* count, int64_t cap, int64_t& next,
                        int64_t& next_particle) {
  const Octant& o = octants[node];
  int64_t my = next++;
  if (my >= cap) return -1;
  float* row = &nodes[8 * my];
  row[0] = o.cog[0];
  row[1] = o.cog[1];
  row[2] = o.cog[2];
  row[3] = o.mass;
  row[4] = width;
  // NOTE: for o.bodies == 1 the children[0] is a particle index; never
  // traverse it (the reference kernel does, which is the upstream bug).
  bool is_leaf = (o.bodies == 1);
  row[5] = is_leaf ? 1.0f : 0.0f;
  row[6] = is_leaf ? 1.0f : 0.0f;
  row[7] = 0.0f;
  // particles are consumed in DFS order == the sorted order, so the
  // node's first particle's SORTED index is next_particle
  first[my] = int32_t(next_particle);
  count[my] = int32_t(o.bodies);
  if (is_leaf) {
    next_particle++;
  } else {
    for (int c = 0; c < 8; c++) {
      if (o.children[c] != 0) {
        int64_t r = emit_dfs(octants, o.children[c], width / 2.0f, nodes,
                             skip, first, count, cap, next, next_particle);
        if (r < 0) return -1;
      }
    }
  }
  skip[my] = int32_t(next);
  return my;
}

int64_t nbody_to_dfs_arena(const Octant* octants, int64_t num_octants,
                           int64_t n, const int64_t* order, float root_width,
                           float* nodes_f32, int32_t* skip, int32_t* first,
                           int32_t* count) {
  (void)order;
  // ABI: nodes/skip/first/count must hold num_octants+1 rows.
  int64_t cap = num_octants;
  auto sentinel = [&]() {
    float* srow = &nodes_f32[8 * cap];
    for (int k = 0; k < 8; k++) srow[k] = 0.0f;
    srow[0] = 1e30f;
    srow[6] = 1.0f;
    skip[cap] = int32_t(cap);
    first[cap] = int32_t(n);
    count[cap] = 0;
  };
  if (n == 1) {
    float* row = &nodes_f32[0];
    row[0] = octants[0].cog[0];
    row[1] = octants[0].cog[1];
    row[2] = octants[0].cog[2];
    row[3] = octants[0].mass;
    row[4] = root_width;
    row[5] = row[6] = 1.0f;
    row[7] = 0.0f;
    skip[0] = 1;
    first[0] = 0;
    count[0] = 1;
    sentinel();
    return 1;
  }
  int64_t next = 0, next_particle = 0;
  if (emit_dfs(octants, 0, root_width, nodes_f32, skip, first, count, cap,
               next, next_particle) < 0)
    return -1;
  sentinel();
  return next;
}

}  // extern "C"
