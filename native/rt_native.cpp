// Native host-side runtime for the rt framework.
//
// The reference's host layer is native Rust (tobj OBJ parsing in
// src/geometry/mesh.rs, the BVH build in src/scene/bvh/tree.rs, PPM
// serialization in src/scene/render_ppm.rs); this is the C++ equivalent for
// this framework — the Python implementations remain as portable
// fallbacks and behavioral oracles (rt/scene/objloader.py, rt/scene/bvh.py,
// rt/render/ppm.py), and tests assert byte/bit equality between the two.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C native   (g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <vector>
#include <algorithm>
#include <numeric>

extern "C" {

// --------------------------------------------------------------------------
// OBJ parsing (contract of src/geometry/mesh.rs:11-61: positions + faces
// only, global indices across objects, fan triangulation, 1-based and
// negative indices)
// --------------------------------------------------------------------------

struct ObjResult {
  float*    verts;   // (n_verts * 3)
  int64_t   n_verts;
  uint32_t* indices; // (n_idx)
  int64_t   n_idx;
};

static bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

int rt_parse_obj(const char* text, int64_t len, ObjResult* out) {
  std::vector<float> verts;
  std::vector<uint32_t> idx;
  const char* p = text;
  const char* end = text + len;
  std::vector<int64_t> face;  // scratch
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    if (line_end - p >= 2 && p[0] == 'v' && p[1] == ' ') {
      char* q = const_cast<char*>(p) + 2;
      for (int k = 0; k < 3; ++k) {
        while (q < line_end && is_space(*q)) ++q;
        verts.push_back(strtof(q, &q));
      }
    } else if (line_end - p >= 2 && p[0] == 'f' && p[1] == ' ') {
      face.clear();
      const char* q = p + 2;
      while (q < line_end) {
        while (q < line_end && is_space(*q)) ++q;
        if (q >= line_end) break;
        char* e;
        long long k = strtoll(q, &e, 10);
        if (e == q) break;
        // OBJ is 1-based; negative indices are relative to current v count
        int64_t vi = k > 0 ? k - 1
                           : static_cast<int64_t>(verts.size() / 3) + k;
        face.push_back(vi);
        // skip any /vt/vn suffix up to whitespace
        q = e;
        while (q < line_end && !is_space(*q)) ++q;
      }
      for (size_t t = 1; t + 1 < face.size(); ++t) {
        idx.push_back(static_cast<uint32_t>(face[0]));
        idx.push_back(static_cast<uint32_t>(face[t]));
        idx.push_back(static_cast<uint32_t>(face[t + 1]));
      }
    }
    p = line_end + 1;
  }
  out->n_verts = static_cast<int64_t>(verts.size() / 3);
  out->n_idx = static_cast<int64_t>(idx.size());
  out->verts = static_cast<float*>(malloc(verts.size() * sizeof(float)));
  out->indices = static_cast<uint32_t*>(malloc(idx.size() * sizeof(uint32_t)));
  if ((!out->verts && !verts.empty()) || (!out->indices && !idx.empty()))
    return -1;
  if (!verts.empty())
    memcpy(out->verts, verts.data(), verts.size() * sizeof(float));
  if (!idx.empty())
    memcpy(out->indices, idx.data(), idx.size() * sizeof(uint32_t));
  return 0;
}

void rt_free(void* ptr) { free(ptr); }

// --------------------------------------------------------------------------
// BVH build (contract of src/scene/bvh/tree.rs:36-72, same as
// rt/scene/bvh.py): BFS median-split STABLE sort by centroid-sum axis
// (depth % 3), split at padded midpoint; level-reduced AABBs over the
// implicit heap; node 0 untouched.
//
// Inputs: centroid-sums (m, 3) = a+b+c per triangle (pre-sort order),
// per-triangle AABB lo/hi (m, 3).  Outputs: the permutation (m,) applied to
// triangles, and bmin/bmax (n, 3) with n = next_pow2(m) (caller allocates).
// --------------------------------------------------------------------------

static int64_t next_pow2(int64_t m) {
  if (m <= 1) return 1;
  int64_t n = 1;
  while (n < m) n <<= 1;
  return n;
}

int rt_bvh_build(const float* centroid3, const float* tri_lo,
                 const float* tri_hi, int64_t m, int64_t* order_out,
                 float* bmin_out, float* bmax_out) {
  const int64_t n = next_pow2(m);
  std::vector<int64_t> order(m);
  std::iota(order.begin(), order.end(), 0);

  // BFS queue of (i, j, depth) over padded slot ranges
  struct Range { int64_t i, j; int depth; };
  std::vector<Range> queue;
  queue.push_back({0, n, 0});
  std::vector<int64_t> scratch;
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    const Range rg = queue[qi];
    const int64_t l = rg.i, r = std::min(rg.j, m);
    if (l + 1 >= r) continue;
    const int axis = rg.depth % 3;
    std::stable_sort(order.begin() + l, order.begin() + r,
                     [&](int64_t x, int64_t y) {
                       return centroid3[x * 3 + axis] < centroid3[y * 3 + axis];
                     });
    const int64_t mid = (rg.i + rg.j) / 2;
    queue.push_back({rg.i, mid, rg.depth + 1});
    queue.push_back({mid, rg.j, rg.depth + 1});
  }
  memcpy(order_out, order.data(), m * sizeof(int64_t));

  // level-by-level AABB reduction (associative union == the reference's
  // per-triangle ancestor walk)
  const float FMAX = 3.4028235e38f;
  std::vector<float> lo(n * 3), hi(n * 3);
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      if (i < m) {
        lo[i * 3 + c] = tri_lo[order[i] * 3 + c];
        hi[i * 3 + c] = tri_hi[order[i] * 3 + c];
      } else {
        lo[i * 3 + c] = FMAX;
        hi[i * 3 + c] = -FMAX;
      }
    }
  }
  for (int64_t i = 0; i < n * 3; ++i) { bmin_out[i] = FMAX; bmax_out[i] = -FMAX; }
  int64_t size = n / 2;
  std::vector<float> nlo, nhi;
  while (size >= 1) {
    nlo.assign(size * 3, 0.f);
    nhi.assign(size * 3, 0.f);
    for (int64_t i = 0; i < size; ++i) {
      for (int c = 0; c < 3; ++c) {
        nlo[i * 3 + c] = std::min(lo[(2 * i) * 3 + c], lo[(2 * i + 1) * 3 + c]);
        nhi[i * 3 + c] = std::max(hi[(2 * i) * 3 + c], hi[(2 * i + 1) * 3 + c]);
      }
    }
    memcpy(bmin_out + size * 3, nlo.data(), size * 3 * sizeof(float));
    memcpy(bmax_out + size * 3, nhi.data(), size * 3 * sizeof(float));
    lo.swap(nlo);
    hi.swap(nhi);
    size /= 2;
  }
  return 0;
}

// --------------------------------------------------------------------------
// PPM P3 serialization (contract of src/scene/render_ppm.rs:38-57 via
// rt/render/ppm.py): header "P3\n{w} {h} 255\n", then "{r} {g} {b} " per
// pixel on one line; u8 = trunc(linear*255) saturated, NaN -> 0.
// --------------------------------------------------------------------------

int64_t rt_render_ppm(const float* image, int64_t h, int64_t w,
                      char** out_text) {
  // worst case per pixel: "255 255 255 " = 12 chars
  const int64_t header_max = 64;
  char* buf = static_cast<char*>(malloc(header_max + h * w * 12 + 1));
  if (!buf) return -1;
  int64_t pos = snprintf(buf, header_max, "P3\n%lld %lld 255\n",
                         static_cast<long long>(w), static_cast<long long>(h));
  for (int64_t i = 0; i < h * w * 3; ++i) {
    float v = image[i] * 255.0f;
    unsigned u;
    if (std::isnan(v) || v <= 0.f) u = 0;
    else if (v >= 255.f) u = 255;
    else u = static_cast<unsigned>(v);  // trunc toward zero
    pos += snprintf(buf + pos, 13, "%u ", u);
  }
  buf[pos] = '\0';
  *out_text = buf;
  return pos;
}

}  // extern "C"
