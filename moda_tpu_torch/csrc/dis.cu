// dis_patch_search: the patch inverse search of OpenCV's DIS optical flow
// (dis_flow.cpp, PatchInverseSearch_ParBody with processPatchMeanNorm and
// computeSSDMeanNorm) for one pyramid scale, on Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs this step inside cv2's
// host C++ (moda_tpu/preproc/pipeline.py:60-65). It is a kernel because its
// work is sequential in a way tensor ops cannot batch: with spatial
// propagation, each 8x8 patch of a pass starts from the flow its left and
// upper neighbours (right and lower ones in the backward pass) just found.
// As tensor ops that is one step per anti-diagonal per stripe per pass per
// scale, each with ~15 patch evaluations of ~20 ops: 10^5-10^6 launches a
// frame pair at 1920x1080.
//
// Bound: neither operations nor bytes. The work per patch is ~15
// evaluations of 64 bilinear samples, and the inputs are read once from the
// card's point of view; what bounds the kernel is the chain of the
// diagonals. cv2 cuts the patch rows into 8 stripes (the result depends on
// that cut, not on the thread count), and a pass over a stripe is rows + ws
// - 1 steps, each waiting for the last: 680 steps a launch at 540 x 960.
// Each step lasts as long as its slowest patch's evaluations, one after
// another, on one of only 8 SMs.
//
// Design: one warp a patch, to cut that latency. Lane L = 4r + k holds
// pixels (r, k) and (r, k + 4) of the patch: their I0, gx and gy stay in
// registers for the patch's whole search, and an evaluation reads only the
// lane's two bilinear samples of I1. The sums are taken in the order of
// cv2's 4-lane SSE code (SSE lane k sums columns k and k + 4 down rows 0..7
// in order, then (l0 + l2) + (l1 + l3)): row r's term of SSE lane k is warp
// lane 4r + k's, and ``patch_sum`` gathers each sum's rows into one lane by
// shuffles, adds them in row order and combines the SSE lanes. A shuffle
// moves bits and the library is built with -fmad=false, so every lane holds
// the same float32 sums, bit-equal to the plain PyTorch version
// (dis_flow.py::patch_search_plain), and the candidate choice, the descent
// and its early exit are warp-uniform. With spatial propagation one CTA
// walks one stripe's anti-diagonals, forward pass then backward,
// __syncthreads between diagonals, its warp w taking the stripe's patch
// rows w, w + nwarps, ... Without propagation every patch is independent:
// one warp a patch. The launch shape is dis_flow.py::search_geometry's.
// The warps of a stripe share one SM, so its shuffle and conversion rates
// matter: the three candidates of a patch are evaluated in one pass, up to
// 8 sums travel in one 8-round transpose, and bytes and floors go through
// float arithmetic rather than the conversion unit.
//
// Left for later: the stripe's flow in shared memory (it is read and
// written in global memory, visible across the CTA's __syncthreads), and
// both directions of a frame pair in one launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PSZ = 8;         // patch size (every cv2 preset's)
constexpr int BSZ = 16;        // border of the extended I1
constexpr int MAX_WARPS = 32;  // warps a CTA at most (dis_flow.MAX_WARPS)
constexpr unsigned FULL = 0xffffffffu;
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

// A byte as a float, exactly, without the conversion unit (an eighth of the
// FP32 rate on Hopper): 2^23 + b has b in its low mantissa bits.
__device__ __forceinline__ float u8f(uint8_t b) {
  return __int_as_float(0x4B000000 | b) - 8388608.f;
}

// floor(x) of 0 <= x < 2^23 as a float and an int, the same way: x + 2^23
// rounded down is 2^23 + floor(x).
__device__ __forceinline__ void floor_u(float x, float* f, int* i) {
  const float t = __fadd_rd(x, 8388608.f);
  *f = t - 8388608.f;
  *i = __float_as_int(t) - 0x4B000000;
}

// This lane's share of the patch at pixel (i, j): pixels (r, k) and
// (r, k + 4), lane = 4r + k.
struct Lane {
  int i, j, off;  // the patch's pixel, the lane's offset in I1e's window
  float i0[2], gx[2], gy[2];
};

__device__ Lane lane_of(const Scale& s, int i, int j) {
  const int r = (threadIdx.x & 31) >> 2, k = threadIdx.x & 3;
  const int p = (i + r) * s.w + j + k;
  Lane l;
  l.i = i;
  l.j = j;
  l.off = r * s.we + k;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    l.i0[t] = (float)s.I0[p + 4 * t];
    l.gx[t] = (float)s.gx[p + 4 * t];
    l.gy[t] = (float)s.gy[p + 4 * t];
  }
  return l;
}

// y[j] <- y[(j + s) & 7] for this lane's s (0..7): three stages of selects
// with fixed indices, so that the array stays in registers.
__device__ __forceinline__ void rotate8(float (&y)[8], int s) {
#pragma unroll
  for (int m = 1; m < 8; m *= 2) {
    float z[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j] = (s & m) ? y[(j + m) & 7] : y[j];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = z[j];
  }
}

// Each x[q] (N <= 8 of them) summed over the patch as cv2's SSE code sums
// it: x[q] of warp lane 4r + k is row r's term of SSE lane k; every lane gets
// the N sums. An 8 x 8 transpose within each SSE lane's 8 warp lanes brings
// quantity g's rows to lanes 4g + k: in round t lane 4g + k reads row
// (g + t) & 7 of lane 4((g + t) & 7) + k, which offers its x[g] (a rotation
// by its row makes that a fixed index), so the 8 rounds move all N x 8 x 4
// terms; a rotation back puts the rows in order, and lane 4g + k adds them
// down rows 0..7. Then (l0 + l2) + (l1 + l3) over k, and quantity q's sum
// is broadcast from lane 4q.
template <int N>
__device__ void patch_sum(float (&x)[N]) {
  static_assert(N <= 8, "at most 8 sums at once");
  const int k = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = j < N ? x[j] : 0.f;
  rotate8(y, g);  // y[j] = x[(j + g) & 7]: round t offers y[-t & 7] = x[(g - t) & 7]
  float got[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) got[t] = __shfl_sync(FULL, y[(8 - t) & 7], 4 * ((g + t) & 7) + k);
  rotate8(got, (8 - g) & 7);  // got[r] = row r of quantity g
  float acc = got[0];
#pragma unroll
  for (int r = 1; r < PSZ; ++r) acc = acc + got[r];
  // l0 + l2 on lanes 0 and 2, l1 + l3 on 1 and 3 (float addition commutes)
  const float half = acc + __shfl_xor_sync(FULL, acc, 2);
  const float sum = half + __shfl_xor_sync(FULL, half, 1);
#pragma unroll
  for (int q = 0; q < N; ++q) x[q] = __shfl_sync(FULL, sum, 4 * q);
}

// Mean-normalized SSD of the patch against I1 moved by each of the N flows
// (ux, uy); with GRAD (N = 1) also the gradient sums dUx, dUy.
template <int N, bool GRAD>
__device__ void eval_patch(const Scale& s, const Lane& l, const float (&ux)[N],
                           const float (&uy)[N], float gsx, float gsy, float (&ssd)[N],
                           float* dux, float* duy) {
  constexpr int Q = GRAD ? 4 : 2;  // sums a flow: squares, plain, and x, y gradients
  float x[Q * N];
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const float ii = fminf(fmaxf(((float)l.i + uy[f]) + (float)BSZ, s.lo), s.hi_i);
    const float jj = fminf(fmaxf(((float)l.j + ux[f]) + (float)BSZ, s.lo), s.hi_j);
    float fi, fj;
    int ri, rj;
    floor_u(ii, &fi, &ri);
    floor_u(jj, &fj, &rj);
    const float di = ii - fi, dj = jj - fj;
    const float w11 = di * dj, w10 = di * (1.f - dj), w01 = (1.f - di) * dj,
                w00 = (1.f - di) * (1.f - dj);
    const uint8_t* a = s.I1e + ri * s.we + rj + l.off;
    const uint8_t* b = a + s.we;
    float d[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = 4 * t;
      d[t] = (((w00 * u8f(a[c]) + w01 * u8f(a[c + 1])) + w10 * u8f(b[c])) +
              w11 * u8f(b[c + 1])) - l.i0[t];
    }
    x[Q * f] = d[0] * d[0] + d[1] * d[1];
    x[Q * f + 1] = d[0] + d[1];
    if (GRAD) {
      x[Q * f + 2] = d[0] * l.gx[0] + d[1] * l.gx[1];
      x[Q * f + 3] = d[0] * l.gy[0] + d[1] * l.gy[1];
    }
  }
  patch_sum(x);
#pragma unroll
  for (int f = 0; f < N; ++f) {
    const float sm = x[Q * f + 1];
    ssd[f] = x[Q * f] - (sm * sm) / 64.f;
    if (GRAD) {
      *dux = x[Q * f + 2] - (sm * gsx) / 64.f;
      *duy = x[Q * f + 3] - (sm * gsy) / 64.f;
    }
  }
}

// One patch of one pass, by one warp, from the flow (ux, uy): the
// candidates (that flow, then the row neighbour nb_row's and the column
// neighbour nb_col's, -1 for none), then n_inner gradient-descent steps,
// kept if within a patch size of the start. Every lane computes the same
// values; lane 0 stores them.
__device__ void search_patch(const Scale& s, int is, int js, float ux, float uy, int nb_row,
                             int nb_col, bool candidates, int n_inner) {
  const int k = is * s.ws + js, n = s.hs * s.ws;
  const Lane l = lane_of(s, is * s.pstr, js * s.pstr);
  if (candidates) {
    const int nb[2] = {nb_row, nb_col};
    const float cx[3] = {ux, nb_row >= 0 ? s.Sx[nb_row] : ux, nb_col >= 0 ? s.Sx[nb_col] : ux};
    const float cy[3] = {uy, nb_row >= 0 ? s.Sy[nb_row] : uy, nb_col >= 0 ? s.Sy[nb_col] : uy};
    float ssd[3];
    eval_patch<3, false>(s, l, cx, cy, 0.f, 0.f, ssd, nullptr, nullptr);
    float best = ssd[0];
    for (int t = 1; t < 3; ++t) {
      if (nb[t - 1] >= 0 && ssd[t] < best) {
        best = ssd[t];
        ux = cx[t];
        uy = cy[t];
      }
    }
  }
  const float xx = s.st[k], yy = s.st[n + k], xy = s.st[2 * n + k];
  const float gsx = s.st[3 * n + k], gsy = s.st[4 * n + k];
  float det = xx * yy - xy * xy;
  if (fabsf(det) < EPS) det = EPS;
  const float h11 = yy / det, h12 = -xy / det, h22 = xx / det;
  float cx[1] = {ux}, cy[1] = {uy}, prev = INF;
  for (int t = 0; t < n_inner; ++t) {
    float ssd[1], dux, duy;
    eval_patch<1, true>(s, l, cx, cy, gsx, gsy, ssd, &dux, &duy);
    cx[0] = cx[0] - (h11 * dux + h12 * duy);
    cy[0] = cy[0] - (h12 * dux + h22 * duy);
    if (ssd[0] >= prev) break;
    prev = ssd[0];
  }
  const double ex = (double)(cx[0] - ux), ey = (double)(cy[0] - uy);
  const bool keep = sqrt(ex * ex + ey * ey) <= (double)PSZ;
  if ((threadIdx.x & 31) == 0) {
    s.Sx[k] = keep ? cx[0] : ux;
    s.Sy[k] = keep ? cy[0] : uy;
  }
}

// The pixel of U (the coarser flow) at the centre of patch (is, js).
__device__ int centre(const Scale& s, int is, int js) {
  return (is * s.pstr + PSZ / 2) * s.w + js * s.pstr + PSZ / 2;
}

// Spatial propagation: CTA c walks cv2's stripe of patch rows
// [c * stripe, min((c + 1) * stripe, hs)), both passes, diagonal by
// diagonal; warp w takes the stripe's rows w, w + nwarps, ...
__global__ void __launch_bounds__(32 * MAX_WARPS)
    dis_search_stripes(Scale s, const float* Ux, const float* Uy, int stripe, int npass,
                       int n_inner) {
  const int a = (int)blockIdx.x * stripe, b = min(a + stripe, s.hs);
  const int rows = b - a;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < rows * s.ws; t += blockDim.x) {
    const int is = a + t / s.ws, js = t % s.ws;
    const int c = centre(s, is, js);
    s.Sx[is * s.ws + js] = Ux[c];
    s.Sy[is * s.ws + js] = Uy[c];
  }
  __syncthreads();
  for (int pass = 0; pass < npass; ++pass) {
    const bool bwd = pass % 2 == 1;
    const int dir = bwd ? -1 : 1;
    for (int d = 0; d < rows + s.ws - 1; ++d) {
      for (int r = warp; r < rows; r += nwarps) {
        const int c = d - r;
        if (c < 0 || c >= s.ws) continue;
        const int is = bwd ? b - 1 - r : a + r;
        const int js = bwd ? s.ws - 1 - c : c;
        const int k = is * s.ws + js;
        const int nb_row = c > 0 ? k - dir : -1;
        const int nb_col = r > 0 ? k - dir * s.ws : -1;
        search_patch(s, is, js, s.Sx[k], s.Sy[k], nb_row, nb_col, true, n_inner);
      }
      __syncthreads();
    }
  }
}

// No propagation: warp k of the grid searches patch k alone.
__global__ void __launch_bounds__(32 * MAX_WARPS)
    dis_search_patches(Scale s, const float* Ux, const float* Uy, int n_inner) {
  const int k = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (k >= s.hs * s.ws) return;
  const int is = k / s.ws, js = k % s.ws, c = centre(s, is, js);
  search_patch(s, is, js, Ux[c], Uy[c], -1, -1, false, n_inner);
}

}  // namespace

// One scale's search in ctas CTAs of warps warps (dis_flow.search_geometry):
// with stripe > 0, spatial propagation over stripes of that many patch
// rows; with stripe 0, none. A ctas that does not cover the hs x ws patches
// exactly (one CTA a non-empty stripe, or a warp a patch) is refused.
extern "C" int moda_dis_patch_search(const uint8_t* I0, const uint8_t* I1e, const int16_t* gx,
                                     const int16_t* gy, const float* Ux, const float* Uy,
                                     const float* st, float* Sx, float* Sy, int h, int w, int hs,
                                     int ws, int pstr, int npass, int n_inner, int ctas,
                                     int warps, int stripe, cudaStream_t stream) {
  const long units = stripe > 0 ? hs : (long)hs * ws, per = stripe > 0 ? stripe : warps;
  if (hs < 1 || ws < 1 || warps < 1 || warps > MAX_WARPS || stripe < 0 ||
      ctas != (units + per - 1) / per)
    return (int)cudaErrorInvalidValue;
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
  if (stripe > 0)
    dis_search_stripes<<<ctas, 32 * warps, 0, stream>>>(s, Ux, Uy, stripe, npass, n_inner);
  else
    dis_search_patches<<<ctas, 32 * warps, 0, stream>>>(s, Ux, Uy, n_inner);
  return (int)cudaGetLastError();
}

extern "C" const char* moda_dis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
