// Native host runtime of the PyTorch port: the port's own copy of
// native/rtnative.cpp, built with g++ into raytracer_odin_tpu_torch/build/
// at first use (io/native.py) and loaded through ctypes.
//
// Two cold-path-but-CPU-heavy pieces live here instead of Python:
//
//  1. png_unfilter — PNG row defiltering (the sequential part of PNG decode
//     that numpy can't vectorize). Replaces the decode half of the
//     reference's vendor:stb/image dependency (textures.odin:37-52).
//
//  2. bvh_build — full-sweep SAH binary BVH builder with the same
//     construction semantics as the reference (raytracer.odin:227-342):
//     per-axis sort by AABB lower bound, suffix-merged AABB buffer, SAH cost
//     area_left*i + area_right*(n-i), best axis then split; leaf threshold 4.
//     Unlike the reference's pointer tree + 64-deep traversal stack
//     (raytracer.odin:379), the output here is a *flattened, stackless* node
//     array in depth-first order with EIGHT precomputed (hit, miss) link
//     tables — one per ray-direction octant — so device traversal is the
//     branch-free loop `node = hit ? hit_link[oct][node] : miss_link[oct][node]`
//     with near-child-first ordering baked into the links (the static
//     equivalent of raytracer.odin:396-404's runtime child ordering).
//
// Exposed with a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG unfiltering.
// raw:  height rows of (1 filter byte + stride bytes)
// out:  height x stride
// ---------------------------------------------------------------------------
static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                 int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    uint8_t ftype = src[0];
    const uint8_t* line = src + 1;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) {
          uint8_t left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + left);
        }
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(line[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          int ul = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(line[i] + paeth(left, up, ul));
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// SAH BVH build.
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

static inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  V3 lo, hi;
  void merge(const Box& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float area() const {
    // Component-sum of size.xyz * size.yzx (raytracer.odin:206-209).
    float sx = hi.x - lo.x, sy = hi.y - lo.y, sz = hi.z - lo.z;
    return sx * sy + sy * sz + sz * sx;
  }
};

static const Box kEmptyBox = {
    {std::numeric_limits<float>::infinity(),
     std::numeric_limits<float>::infinity(),
     std::numeric_limits<float>::infinity()},
    {-std::numeric_limits<float>::infinity(),
     -std::numeric_limits<float>::infinity(),
     -std::numeric_limits<float>::infinity()}};

struct BuildNode {
  Box box;
  int left = -1, right = -1;  // tree children (-1 for leaf)
  int first = 0, count = 0;   // leaf triangle range (into perm)
  int axis = 0;               // split axis for octant child ordering
};

struct Builder {
  std::vector<Box> boxes;       // per-triangle AABBs, permuted in place
  std::vector<int32_t> perm;    // triangle permutation
  std::vector<Box> suffix;      // suffix-merge buffer
  std::vector<BuildNode> nodes;
  int leaf_size;

  // Build over perm[first..first+count); returns node index.
  int recurse(int first, int count) {
    if (count <= leaf_size) {
      Box box = kEmptyBox;
      for (int i = 0; i < count; ++i) box.merge(boxes[first + i]);
      BuildNode n;
      n.box = box;
      n.first = first;
      n.count = count;
      nodes.push_back(n);
      return (int)nodes.size() - 1;
    }

    float best_sah = std::numeric_limits<float>::infinity();
    int best_axis = 0, best_split = 1;
    Box total = kEmptyBox;
    for (int axis = 0; axis < 3; ++axis) {
      // Sort this range by AABB lower bound along `axis`
      // (raytracer.odin:261-263), permuting boxes and perm together.
      std::vector<int> order(count);
      for (int i = 0; i < count; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        const float* la = &boxes[first + a].lo.x;
        const float* lb = &boxes[first + b].lo.x;
        return la[axis] < lb[axis];
      });
      std::vector<Box> tb(count);
      std::vector<int32_t> tp(count);
      for (int i = 0; i < count; ++i) {
        tb[i] = boxes[first + order[i]];
        tp[i] = perm[first + order[i]];
      }
      std::copy(tb.begin(), tb.end(), boxes.begin() + first);
      std::copy(tp.begin(), tp.end(), perm.begin() + first);

      // Suffix AABBs (raytracer.odin:289-294).
      for (int i = count - 1; i >= 0; --i) {
        suffix[i] = boxes[first + i];
        if (i != count - 1) suffix[i].merge(suffix[i + 1]);
      }
      // Sweep SAH = area(prefix)*i + area(suffix)*(n-i)
      // (raytracer.odin:297-303).
      Box prefix = kEmptyBox;
      for (int i = 1; i < count; ++i) {
        prefix.merge(boxes[first + i - 1]);
        float sah = prefix.area() * (float)i +
                    suffix[i].area() * (float)(count - i);
        if (sah < best_sah) {
          best_sah = sah;
          best_axis = axis;
          best_split = i;
        }
      }
      if (axis == 2) {
        prefix.merge(boxes[first + count - 1]);
        total = prefix;
      }
      if (axis == best_axis) {
        // Keep this ordering if it stays best; cheaper than re-sorting at the
        // end like the reference does (raytracer.odin:311-317) but the split
        // produced is the same (stable sort, same keys).
      }
    }
    // Re-sort along the winning axis (last sort above was axis 2).
    if (best_axis != 2) {
      std::vector<int> order(count);
      for (int i = 0; i < count; ++i) order[i] = i;
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        const float* la = &boxes[first + a].lo.x;
        const float* lb = &boxes[first + b].lo.x;
        return la[best_axis] < lb[best_axis];
      });
      std::vector<Box> tb(count);
      std::vector<int32_t> tp(count);
      for (int i = 0; i < count; ++i) {
        tb[i] = boxes[first + order[i]];
        tp[i] = perm[first + order[i]];
      }
      std::copy(tb.begin(), tb.end(), boxes.begin() + first);
      std::copy(tp.begin(), tp.end(), perm.begin() + first);
    }

    int left = recurse(first, best_split);
    int right = recurse(first + best_split, count - best_split);
    BuildNode n;
    n.box = total;
    n.left = left;
    n.right = right;
    n.axis = best_axis;
    nodes.push_back(n);
    return (int)nodes.size() - 1;
  }
};

// Flatten to depth-first order with per-octant links.
struct Flattener {
  const std::vector<BuildNode>& nodes;
  std::vector<int32_t> sizes;  // memoized subtree node counts
  float* out_lo;
  float* out_hi;
  int32_t* out_first;
  int32_t* out_count;
  int32_t* out_links;  // [8][2][n_nodes] (hit, miss)
  int32_t n_out = 0;
  int32_t total;

  Flattener(const std::vector<BuildNode>& n, int32_t total_nodes)
      : nodes(n), total(total_nodes) {
    sizes.resize(nodes.size());
    // Children are always appended before their parent (post-order build),
    // so a forward pass fills sizes bottom-up.
    for (size_t i = 0; i < nodes.size(); ++i) {
      sizes[i] = nodes[i].left < 0
                     ? 1
                     : 1 + sizes[nodes[i].left] + sizes[nodes[i].right];
    }
  }

  // Emit subtree rooted at `id` for octant `oct`; `miss` = flat node to jump
  // to when this subtree's root AABB test fails. The flat order is canonical
  // (self, left subtree, right subtree) for every octant, so geometry arrays
  // are written only on oct==0; octant-dependent near-child-first ordering
  // (the static analogue of raytracer.odin:396-404) lives purely in the
  // (hit, miss) link tables.
  void emit(int id, int oct, int32_t miss) {
    const BuildNode& n = nodes[id];
    int32_t self = n_out++;
    if (oct == 0) {
      out_lo[self * 3 + 0] = n.box.lo.x;
      out_lo[self * 3 + 1] = n.box.lo.y;
      out_lo[self * 3 + 2] = n.box.lo.z;
      out_hi[self * 3 + 0] = n.box.hi.x;
      out_hi[self * 3 + 1] = n.box.hi.y;
      out_hi[self * 3 + 2] = n.box.hi.z;
      out_first[self] = n.left < 0 ? n.first : 0;
      out_count[self] = n.left < 0 ? n.count : 0;
    }
    int32_t* hit = out_links + ((int64_t)oct * 2 + 0) * total;
    int32_t* msl = out_links + ((int64_t)oct * 2 + 1) * total;
    if (n.left < 0) {
      // Leaf: after testing its triangles, continue at `miss` either way.
      hit[self] = miss;
      msl[self] = miss;
    } else {
      // Visit the near child first: if the ray direction is negative along
      // the split axis, that's the right (upper) child.
      bool neg = (oct >> n.axis) & 1;
      int32_t left_idx = n_out;
      int32_t right_idx = n_out + sizes[n.left];
      hit[self] = neg ? right_idx : left_idx;
      msl[self] = miss;
      // First-visited child misses into the second child; second-visited
      // child misses out of the whole subtree.
      int32_t left_miss = neg ? miss : right_idx;
      int32_t right_miss = neg ? left_idx : miss;
      emit(n.left, oct, left_miss);
      emit(n.right, oct, right_miss);
    }
  }
};

// Build BVH over n triangle AABBs.
//  in:  lo[n*3], hi[n*3], leaf_size
//  out: perm[n], node arrays sized cap >= 2n (out_n_nodes returns actual),
//       links[8*2*cap]
// Returns number of nodes, or -1 on error.
int32_t bvh_build(int32_t n, const float* lo, const float* hi,
                  int32_t leaf_size, int32_t cap, int32_t* perm,
                  float* out_lo, float* out_hi, int32_t* out_first,
                  int32_t* out_count, int32_t* out_links) {
  if (n <= 0) return 0;
  Builder b;
  b.leaf_size = leaf_size;
  b.boxes.resize(n);
  b.perm.resize(n);
  b.suffix.resize(n);
  for (int i = 0; i < n; ++i) {
    b.boxes[i] = {{lo[i * 3], lo[i * 3 + 1], lo[i * 3 + 2]},
                  {hi[i * 3], hi[i * 3 + 1], hi[i * 3 + 2]}};
    b.perm[i] = i;
  }
  int root = b.recurse(0, n);
  int32_t n_nodes = (int32_t)b.nodes.size();
  if (n_nodes > cap) return -1;
  std::copy(b.perm.begin(), b.perm.end(), perm);
  for (int oct = 0; oct < 8; ++oct) {
    Flattener f(b.nodes, n_nodes);
    f.out_lo = out_lo;
    f.out_hi = out_hi;
    f.out_first = out_first;
    f.out_count = out_count;
    f.out_links = out_links;
    f.emit(root, oct, n_nodes);  // miss sentinel = n_nodes (terminate)
  }
  return n_nodes;
}

}  // extern "C"
