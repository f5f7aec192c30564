// Marching-tetrahedra isosurface extraction (native component).
//
// Role of PyMCubes in the reference (train_utils.py:19,1441): turn the
// device-computed SDF grid into a triangle mesh on the host. The same
// source as moda_tpu/native/marching.cpp, so both packages give the same
// mesh from the same grid. Implemented as
// marching tetrahedra (6 tets per cube) instead of table-driven marching
// cubes: no large lookup tables, watertight output, and vertices are
// deduplicated via global edge keys so downstream consumers (connected
// components, k-means bone re-init, chamfer eval) get a compact mesh.
//
// Build: moda_tpu_torch/native/__init__.py compiles it with g++ on first use
// into moda_tpu_torch/_build/.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshBuilder {
  std::vector<float> verts;
  std::vector<int32_t> tris;
  std::unordered_map<uint64_t, int32_t> edge_cache;
  const float* grid;
  int nx, ny, nz;
  float iso;

  inline float val(int64_t i) const { return grid[i]; }

  inline uint64_t edge_key(int64_t a, int64_t b) const {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | static_cast<uint64_t>(b);
  }

  // interpolated vertex on the grid edge (a, b); indices are linear.
  int32_t edge_vertex(int64_t a, int64_t b) {
    uint64_t key = edge_key(a, b);
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    float va = val(a), vb = val(b);
    float t = (iso - va) / (vb - va + 1e-20f);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    // linear index -> (x, y, z): index = (x * ny + y) * nz + z
    float ax = static_cast<float>(a / (static_cast<int64_t>(ny) * nz));
    float ay = static_cast<float>((a / nz) % ny);
    float az = static_cast<float>(a % nz);
    float bx = static_cast<float>(b / (static_cast<int64_t>(ny) * nz));
    float by = static_cast<float>((b / nz) % ny);
    float bz = static_cast<float>(b % nz);
    int32_t idx = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(ax + t * (bx - ax));
    verts.push_back(ay + t * (by - ay));
    verts.push_back(az + t * (bz - az));
    edge_cache.emplace(key, idx);
    return idx;
  }

  void emit_tri(int32_t a, int32_t b, int32_t c) {
    tris.push_back(a);
    tris.push_back(b);
    tris.push_back(c);
  }

  // process one tetrahedron given 4 linear grid-vertex indices.
  void do_tet(int64_t v0, int64_t v1, int64_t v2, int64_t v3) {
    int code = 0;
    if (val(v0) > iso) code |= 1;
    if (val(v1) > iso) code |= 2;
    if (val(v2) > iso) code |= 4;
    if (val(v3) > iso) code |= 8;
    switch (code) {
      case 0x0:
      case 0xF:
        return;
      case 0x1: tri1(v0, v1, v2, v3); return;
      case 0xE: tri1r(v0, v1, v2, v3); return;
      case 0x2: tri1(v1, v0, v3, v2); return;
      case 0xD: tri1r(v1, v0, v3, v2); return;
      case 0x4: tri1(v2, v0, v1, v3); return;
      case 0xB: tri1r(v2, v0, v1, v3); return;
      case 0x8: tri1(v3, v0, v2, v1); return;
      case 0x7: tri1r(v3, v0, v2, v1); return;
      case 0x3: quad(v0, v1, v2, v3); return;
      case 0xC: quadr(v0, v1, v2, v3); return;
      case 0x5: quad(v2, v0, v3, v1); return;
      case 0xA: quadr(v2, v0, v3, v1); return;
      case 0x6: quad(v1, v2, v0, v3); return;
      case 0x9: quadr(v1, v2, v0, v3); return;
    }
  }

  // one vertex (in) vs three (out): single triangle, oriented.
  void tri1(int64_t in, int64_t o1, int64_t o2, int64_t o3) {
    emit_tri(edge_vertex(in, o1), edge_vertex(in, o2), edge_vertex(in, o3));
  }
  void tri1r(int64_t in, int64_t o1, int64_t o2, int64_t o3) {
    emit_tri(edge_vertex(in, o1), edge_vertex(in, o3), edge_vertex(in, o2));
  }
  // two-in/two-out: quad split into 2 triangles. in: a,b out: c,d.
  void quad(int64_t a, int64_t b, int64_t c, int64_t d) {
    int32_t ac = edge_vertex(a, c), ad = edge_vertex(a, d);
    int32_t bc = edge_vertex(b, c), bd = edge_vertex(b, d);
    emit_tri(ac, ad, bd);
    emit_tri(ac, bd, bc);
  }
  void quadr(int64_t a, int64_t b, int64_t c, int64_t d) {
    int32_t ac = edge_vertex(a, c), ad = edge_vertex(a, d);
    int32_t bc = edge_vertex(b, c), bd = edge_vertex(b, d);
    emit_tri(ac, bd, ad);
    emit_tri(ac, bc, bd);
  }

  void run() {
    const int64_t sy = nz;
    const int64_t sx = static_cast<int64_t>(ny) * nz;
    for (int x = 0; x < nx - 1; ++x) {
      for (int y = 0; y < ny - 1; ++y) {
        for (int z = 0; z < nz - 1; ++z) {
          int64_t c000 = x * sx + y * sy + z;
          int64_t c100 = c000 + sx, c010 = c000 + sy, c001 = c000 + 1;
          int64_t c110 = c100 + sy, c101 = c100 + 1, c011 = c010 + 1;
          int64_t c111 = c110 + 1;
          // skip fully inside/outside cubes fast
          float v0 = val(c000);
          bool pos = v0 > iso;
          if ((val(c100) > iso) == pos && (val(c010) > iso) == pos &&
              (val(c001) > iso) == pos && (val(c110) > iso) == pos &&
              (val(c101) > iso) == pos && (val(c011) > iso) == pos &&
              (val(c111) > iso) == pos)
            continue;
          // 6-tet decomposition around diagonal c000-c111
          do_tet(c000, c100, c110, c111);
          do_tet(c000, c110, c010, c111);
          do_tet(c000, c010, c011, c111);
          do_tet(c000, c011, c001, c111);
          do_tet(c000, c001, c101, c111);
          do_tet(c000, c101, c100, c111);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees via mt_free.
int marching_tets(const float* grid, int nx, int ny, int nz, float iso,
                  float** out_verts, int32_t** out_tris, int64_t* n_verts,
                  int64_t* n_tris) {
  MeshBuilder mb;
  mb.grid = grid;
  mb.nx = nx;
  mb.ny = ny;
  mb.nz = nz;
  mb.iso = iso;
  mb.run();
  *n_verts = static_cast<int64_t>(mb.verts.size() / 3);
  *n_tris = static_cast<int64_t>(mb.tris.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_tris = static_cast<int32_t*>(std::malloc(mb.tris.size() * sizeof(int32_t)));
  if (!*out_verts || !*out_tris) return 1;
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int32_t));
  return 0;
}

void mt_free(float* v, int32_t* t) {
  std::free(v);
  std::free(t);
}
}
