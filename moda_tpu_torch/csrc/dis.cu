// dis_patch_search: the patch inverse search of OpenCV's DIS optical flow
// (dis_flow.cpp, PatchInverseSearch_ParBody with processPatchMeanNorm and
// computeSSDMeanNorm) for one pyramid scale, on Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs this step inside cv2's
// host C++ (moda_tpu/preproc/pipeline.py::dis_flow). It is a kernel because
// its work is sequential in a way tensor ops cannot batch: with spatial
// propagation, each 8x8 patch of a pass starts from the flow its left and
// upper neighbours (right and lower ones in the backward pass) just found.
// As tensor ops that is one step per anti-diagonal per stripe per pass per
// scale, each with ~15 patch evaluations of ~20 ops: 10^5-10^6 launches a
// frame pair at 1920x1080.
//
// Design: one CTA per stripe (cv2 cuts the patch rows into 8 stripes, so
// that the result does not depend on the thread count); the CTA walks its
// stripe's anti-diagonals, one thread per patch of a diagonal, with
// __syncthreads between diagonals, the forward pass then the backward one.
// Without propagation every patch is independent: one thread per patch.
// Every sum is taken in the order of cv2's 4-lane SSE code (lane k sums
// columns k and k + 4 down the rows; lanes reduced as (l0 + l2) + (l1 + l3)),
// and the library is built with -fmad=false, so the kernel rounds exactly as
// the plain PyTorch version (dis_flow.py::patch_search_plain) does.
//
// Bound: the work per patch is ~15 evaluations of 64 bilinear samples; the
// inputs (two uint8 frames, two int16 gradients, the coarser flow and the
// structure tensor) are read once from the card's point of view, and the
// operations are float32 FMA-free arithmetic. Neither bounds it: the
// dependency chain of the diagonals does, with 8 CTAs of a few dozen
// threads on a 132-SM card. Making it fast (a warp per patch, pairs and
// directions batched into one launch) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int PSZ = 8;   // patch size (every cv2 preset's)
constexpr int BSZ = 16;  // border of the extended I1
constexpr float EPS = 0.001f;
constexpr float INF = 1e10f;

struct Scale {
  const uint8_t* I0;   // [h, w]
  const uint8_t* I1e;  // [h + 2 BSZ, w + 2 BSZ]
  const int16_t* gx;   // [h, w]
  const int16_t* gy;
  const float* st;     // [5, hs, ws]: xx, yy, xy, x, y
  float* Sx;           // [hs, ws]
  float* Sy;
  int h, w, we, hs, ws, pstr;
  float lo, hi_i, hi_j;
};

// Mean-normalized SSD of the patch at pixel (i, j) of I0 against I1 moved by
// (ux, uy); with GRAD also the gradient sums dUx, dUy.
template <bool GRAD>
__device__ float eval_patch(const Scale& s, int i, int j, float ux, float uy, float gsx,
                            float gsy, float* dux, float* duy) {
  float ii = fminf(fmaxf(((float)i + uy) + (float)BSZ, s.lo), s.hi_i);
  float jj = fminf(fmaxf(((float)j + ux) + (float)BSZ, s.lo), s.hi_j);
  float di = ii - floorf(ii), dj = jj - floorf(jj);
  float w11 = di * dj, w10 = di * (1.f - dj), w01 = (1.f - di) * dj,
        w00 = (1.f - di) * (1.f - dj);
  const uint8_t* p1 = s.I1e + (int)ii * s.we + (int)jj;
  const uint8_t* p0 = s.I0 + i * s.w + j;
  const int16_t* px = s.gx + i * s.w + j;
  const int16_t* py = s.gy + i * s.w + j;
  float asq[4] = {0.f, 0.f, 0.f, 0.f}, asum[4] = {0.f, 0.f, 0.f, 0.f};
  float ax[4] = {0.f, 0.f, 0.f, 0.f}, ay[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < PSZ; ++r) {
    const uint8_t* a = p1 + r * s.we;
    const uint8_t* b = a + s.we;
    float d[PSZ];
#pragma unroll
    for (int c = 0; c < PSZ; ++c)
      d[c] = (((w00 * (float)a[c] + w01 * (float)a[c + 1]) + w10 * (float)b[c]) +
              w11 * (float)b[c + 1]) - (float)p0[r * s.w + c];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      asq[k] = asq[k] + (d[k] * d[k] + d[k + 4] * d[k + 4]);
      asum[k] = asum[k] + (d[k] + d[k + 4]);
      if (GRAD) {
        ax[k] = ax[k] + (d[k] * (float)px[r * s.w + k] + d[k + 4] * (float)px[r * s.w + k + 4]);
        ay[k] = ay[k] + (d[k] * (float)py[r * s.w + k] + d[k + 4] * (float)py[r * s.w + k + 4]);
      }
    }
  }
  float sq = (asq[0] + asq[2]) + (asq[1] + asq[3]);
  float sm = (asum[0] + asum[2]) + (asum[1] + asum[3]);
  if (GRAD) {
    float sx = (ax[0] + ax[2]) + (ax[1] + ax[3]);
    float sy = (ay[0] + ay[2]) + (ay[1] + ay[3]);
    *dux = sx - (sm * gsx) / 64.f;
    *duy = sy - (sm * gsy) / 64.f;
  }
  return sq - (sm * sm) / 64.f;
}

// One patch of one pass: the candidates (its own flow, then the row
// neighbour nb_row and the column neighbour nb_col, -1 for none), then
// n_inner gradient-descent steps, kept if within a patch size of the start.
__device__ void search_patch(const Scale& s, int is, int js, int nb_row, int nb_col,
                             bool candidates, int n_inner) {
  const int k = is * s.ws + js, n = s.hs * s.ws;
  const int i = is * s.pstr, j = js * s.pstr;
  float ux = s.Sx[k], uy = s.Sy[k];
  if (candidates) {
    float best = eval_patch<false>(s, i, j, ux, uy, 0.f, 0.f, nullptr, nullptr);
    const int nb[2] = {nb_row, nb_col};
    for (int t = 0; t < 2; ++t) {
      if (nb[t] < 0) continue;
      float cx = s.Sx[nb[t]], cy = s.Sy[nb[t]];
      float cur = eval_patch<false>(s, i, j, cx, cy, 0.f, 0.f, nullptr, nullptr);
      if (cur < best) {
        best = cur;
        ux = cx;
        uy = cy;
      }
    }
  }
  const float xx = s.st[k], yy = s.st[n + k], xy = s.st[2 * n + k];
  const float gsx = s.st[3 * n + k], gsy = s.st[4 * n + k];
  float det = xx * yy - xy * xy;
  if (fabsf(det) < EPS) det = EPS;
  const float h11 = yy / det, h12 = -xy / det, h22 = xx / det;
  float cx = ux, cy = uy, prev = INF;
  for (int t = 0; t < n_inner; ++t) {
    float dux, duy;
    float ssd = eval_patch<true>(s, i, j, cx, cy, gsx, gsy, &dux, &duy);
    cx = cx - (h11 * dux + h12 * duy);
    cy = cy - (h12 * dux + h22 * duy);
    if (ssd >= prev) break;
    prev = ssd;
  }
  double ex = (double)(cx - ux), ey = (double)(cy - uy);
  bool keep = sqrt(ex * ex + ey * ey) <= (double)PSZ;
  s.Sx[k] = keep ? cx : ux;
  s.Sy[k] = keep ? cy : uy;
}

__device__ void init_patch(const Scale& s, const float* Ux, const float* Uy, int is, int js) {
  const int c = (is * s.pstr + PSZ / 2) * s.w + js * s.pstr + PSZ / 2;
  s.Sx[is * s.ws + js] = Ux[c];
  s.Sy[is * s.ws + js] = Uy[c];
}

// Spatial propagation: one CTA per stripe, both passes, diagonal by diagonal.
__global__ void dis_search_stripes(Scale s, const float* Ux, const float* Uy, int nstripes,
                                   int npass, int n_inner) {
  const int sz = (s.hs + nstripes - 1) / nstripes;
  const int a = min((int)blockIdx.x * sz, s.hs), b = min(((int)blockIdx.x + 1) * sz, s.hs);
  const int rows = b - a;
  if (rows <= 0) return;
  for (int t = threadIdx.x; t < rows * s.ws; t += blockDim.x)
    init_patch(s, Ux, Uy, a + t / s.ws, t % s.ws);
  __syncthreads();
  for (int pass = 0; pass < npass; ++pass) {
    const bool bwd = pass % 2 == 1;
    for (int d = 0; d < rows + s.ws - 1; ++d) {
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const int c = d - r;
        if (c < 0 || c >= s.ws) continue;
        const int is = bwd ? b - 1 - r : a + r;
        const int js = bwd ? s.ws - 1 - c : c;
        const int dir = bwd ? -1 : 1;
        const int nb_row = c > 0 ? is * s.ws + js - dir : -1;
        const int nb_col = r > 0 ? (is - dir) * s.ws + js : -1;
        search_patch(s, is, js, nb_row, nb_col, true, n_inner);
      }
      __syncthreads();
    }
  }
}

// No propagation: every patch alone.
__global__ void dis_search_patches(Scale s, const float* Ux, const float* Uy, int n_inner) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= s.hs * s.ws) return;
  init_patch(s, Ux, Uy, k / s.ws, k % s.ws);
  search_patch(s, k / s.ws, k % s.ws, -1, -1, false, n_inner);
}

}  // namespace

extern "C" int moda_dis_patch_search(const uint8_t* I0, const uint8_t* I1e, const int16_t* gx,
                                     const int16_t* gy, const float* Ux, const float* Uy,
                                     const float* st, float* Sx, float* Sy, int h, int w, int hs,
                                     int ws, int pstr, int npass, int n_inner, int nstripes,
                                     cudaStream_t stream) {
  Scale s;
  s.I0 = I0;
  s.I1e = I1e;
  s.gx = gx;
  s.gy = gy;
  s.st = st;
  s.Sx = Sx;
  s.Sy = Sy;
  s.h = h;
  s.w = w;
  s.we = w + 2 * BSZ;
  s.hs = hs;
  s.ws = ws;
  s.pstr = pstr;
  s.lo = (float)(BSZ - PSZ + 1);
  s.hi_i = (float)(BSZ + h) - 1.f;
  s.hi_j = (float)(BSZ + w) - 1.f;
  if (nstripes > 0) {
    const int sz = (hs + nstripes - 1) / nstripes;
    const int threads = std::min(1024, ((sz + 31) / 32) * 32);
    dis_search_stripes<<<nstripes, threads, 0, stream>>>(s, Ux, Uy, nstripes, npass, n_inner);
  } else {
    const int threads = 128;
    dis_search_patches<<<(hs * ws + threads - 1) / threads, threads, 0, stream>>>(s, Ux, Uy,
                                                                                 n_inner);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* moda_dis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
