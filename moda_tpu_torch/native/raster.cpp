// Z-buffer triangle rasterizer with vertex-attribute interpolation.
//
// Host-side native replacement for the reference's SoftRas CUDA extension
// in its exercised configuration (sigma 1e-12, aggr 'hard', vertex
// textures — moda.py:466-471): all call sites run under no_grad, so a
// hard z-buffer suffices. The same source as moda_tpu/native/raster.cpp,
// so both packages give the same image from the same inputs. Used for the
// reference-silhouette export of the extraction (render_vis.mesh_silhouette).
//
// Inputs: screen-space vertices [V,3] (x_px, y_px, depth>0), faces [F,3],
// per-vertex attributes [V,C]. Outputs: attr image [H,W,C], depth [H,W],
// mask [H,W]. Perspective-correct interpolation via 1/z weighting.
//
// Build: moda_tpu_torch/native/__init__.py compiles it with g++ on first use
// into moda_tpu_torch/_build/.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

void rasterize(const float* verts, int64_t n_verts, const int32_t* faces,
               int64_t n_faces, const float* attrs, int n_attr, int height,
               int width, float* out_attr, float* out_depth, float* out_mask) {
  const float INF = std::numeric_limits<float>::infinity();
  for (int64_t i = 0; i < static_cast<int64_t>(height) * width; ++i) {
    out_depth[i] = INF;
    out_mask[i] = 0.f;
  }
  for (int64_t i = 0; i < static_cast<int64_t>(height) * width * n_attr; ++i)
    out_attr[i] = 0.f;

  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[f * 3 + 0];
    const int32_t i1 = faces[f * 3 + 1];
    const int32_t i2 = faces[f * 3 + 2];
    if (i0 < 0 || i1 < 0 || i2 < 0 || i0 >= n_verts || i1 >= n_verts ||
        i2 >= n_verts)
      continue;
    const float x0 = verts[i0 * 3], y0 = verts[i0 * 3 + 1], z0 = verts[i0 * 3 + 2];
    const float x1 = verts[i1 * 3], y1 = verts[i1 * 3 + 1], z1 = verts[i1 * 3 + 2];
    const float x2 = verts[i2 * 3], y2 = verts[i2 * 3 + 1], z2 = verts[i2 * 3 + 2];
    if (z0 <= 1e-6f || z1 <= 1e-6f || z2 <= 1e-6f) continue;  // behind camera

    const float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (std::fabs(area) < 1e-12f) continue;
    const float inv_area = 1.0f / area;

    int xmin = std::max(0, static_cast<int>(std::floor(std::min({x0, x1, x2}))));
    int xmax = std::min(width - 1, static_cast<int>(std::ceil(std::max({x0, x1, x2}))));
    int ymin = std::max(0, static_cast<int>(std::floor(std::min({y0, y1, y2}))));
    int ymax = std::min(height - 1, static_cast<int>(std::ceil(std::max({y0, y1, y2}))));
    if (xmin > xmax || ymin > ymax) continue;

    const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
    for (int y = ymin; y <= ymax; ++y) {
      const float py = y + 0.5f;
      for (int x = xmin; x <= xmax; ++x) {
        const float px = x + 0.5f;
        float w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area;
        float w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        // perspective-correct weights
        const float izp = w0 * iz0 + w1 * iz1 + w2 * iz2;
        const float z = 1.0f / izp;
        const int64_t pix = static_cast<int64_t>(y) * width + x;
        if (z >= out_depth[pix]) continue;
        out_depth[pix] = z;
        out_mask[pix] = 1.f;
        const float a0 = w0 * iz0 * z, a1 = w1 * iz1 * z, a2 = w2 * iz2 * z;
        float* dst = out_attr + pix * n_attr;
        const float* s0 = attrs + static_cast<int64_t>(i0) * n_attr;
        const float* s1 = attrs + static_cast<int64_t>(i1) * n_attr;
        const float* s2 = attrs + static_cast<int64_t>(i2) * n_attr;
        for (int c = 0; c < n_attr; ++c)
          dst[c] = a0 * s0[c] + a1 * s1[c] + a2 * s2[c];
      }
    }
  }
  // infinity -> 0 depth for empty pixels
  for (int64_t i = 0; i < static_cast<int64_t>(height) * width; ++i)
    if (out_depth[i] == INF) out_depth[i] = 0.f;
}
}
