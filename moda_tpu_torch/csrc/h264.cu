// The pixel half of the port's H.264 decoder (preproc/h264.py) on Hopper
// (sm_90a): three kernels, each bit-equal to its plain PyTorch version
// (h264.py::inter_plain, ::intra_plain, ::deblock_plain) and, with the
// host parse of native/h264.cpp, to what FFmpeg's h264 decoder gives
// cv2.VideoCapture.
//
// They replace no TPU kernel: the JAX package decodes video inside
// cv2.VideoCapture, on the host (moda_tpu/preproc/pipeline.py:38-57).
//
// A picture runs them in this order, since intra prediction reads the
// unfiltered picture:
//
// h264_inter: every P, B and skipped macroblock of the picture in one
// launch, one CTA a macroblock, 384 threads (256 luma samples, 64 Cb, 64
// Cr). The
// CTA dequantises its levels by the picture's LevelScale tables (its
// scaling matrices times normAdjust by qP % 6, 8.5.9: one int32 table a
// picture from the host parse, read through the cache; the intra lists for
// intra macroblocks, the inter ones for P; the Intra16x16 DC as cv2's
// libavcodec scales it on x86, by a 16-bit qmul, see residual_plain's
// luma_dc_scale), forms the chroma DC by the 2x2
// transform and runs the inverse transforms in shared memory: the 4x4 one a
// thread a row, then a column, of each of the 24 blocks; for a macroblock
// with transform_size_8x8_flag, the luma 8x8 one 32 threads a pass (4
// blocks x 8 rows, then x 8 columns; the odd terms' shifts by 1 and 2 inside
// each pass, (x + 32) >> 6 after both), chroma staying 4x4. Then each
// thread predicts its sample from each list its 4x4 block uses (a vector
// and a reference slot a list): luma by the 6-tap half-sample filter (the
// centre from the unrounded intermediates) and the quarter-sample
// averages, chroma by the 1/8-sample bilinear, coordinates clamped to the
// coded picture; combines the two (or weights the one) as its slice's
// weight table says, in 8.4.2.3's integers (the default average, explicit
// weights and offsets by ref_idx, implicit weights by the ref_idx pair),
// clipped; and writes the clipped sum with the residual. The reference
// slots are other frames of the buffer than the one written.
//
// h264_intra: the intra macroblocks, one launch a wavefront x + 2y (a
// macroblock needs its left, top-left, top and top-right neighbours done),
// one CTA a macroblock, 384 threads: I_PCM samples copied; chroma and
// Intra16x16 predicted a sample a thread; Intra4x4 block by block in
// decoding order (16 threads a block, the CTA synchronised between blocks,
// each block reading the samples the earlier ones wrote); Intra8x8 the same
// way, 4 blocks of 64 threads, one thread filtering the block's reference
// samples first (8.3.2.2.1: the top-right substituted by p[7, -1] where it
// is not available, the corner's rule by what is; block 1's top-right from
// macroblock C, block 2's from block 1, block 3's never); each plus the
// residual as h264_inter forms it.
//
// h264_deblock: the loop filter, one launch a wavefront (the top edge reads
// what the top-right macroblock's left-edge filtering wrote), one CTA a
// macroblock with an edge to filter, 32 threads: 16 luma lines and 2 x 8
// chroma lines. Vertical edges left to right, then horizontal ones top to
// bottom; a thread filters its line across each edge in turn, the CTA
// synchronised between the two directions. bS comes from the host parse;
// alpha, beta and tC0 from the average qP plus the slice's offsets
// (chroma: each side's QPc). The 8x8 transform needs nothing of its own
// here: the parse writes bS 0 on luma edges 1 and 3 of such a macroblock
// (8.7), and 4:2:0 chroma reads luma edges 0 and 2 alone.
//
// Bound: bytes. Each kernel reads its records, levels (and the LevelScale
// entries they use) and the samples it predicts from, and writes its
// macroblocks' samples (deblocking: reads and writes the filtered lines).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { K_I4 = 0, K_I8 = 1, K_I16 = 2, K_PCM = 3, K_P = 4, K_SKIP = 5 };
enum {
  F_KIND = 0, F_QP = 1, F_CQP0 = 2, F_CQP1 = 3, F_M16 = 4, F_MC = 5, F_AVAIL = 6, F_ROW = 7,
  F_MODES = 8, F_BS = 10, F_ALPHA = 18, F_BETA = 19, F_MV = 20, F_REF = 36, F_T8 = 40,
  F_MV1 = 41, F_REF1 = 57, F_RIDX = 61, F_RIDX1 = 65, F_SLICE = 69, FIELDS = 70
};
// a slice's weight table (preproc/h264.py W_*): mode (0 default, 1
// explicit, 2 implicit), logWD of luma and chroma, the explicit
// [list][ref_idx][Y, Cb, Cr][w, o], the implicit w0 [refIdxL0][refIdxL1]
enum { W_MODE = 0, W_LOGWD = 1, W_EXPLICIT = 3, W_IMPLICIT = 3 + 2 * 32 * 3 * 2,
       WT = W_IMPLICIT + 32 * 32 };
constexpr int UNUSED = 0xFF;
constexpr int L_DC = 256, L_CDC = 272, L_CAC = 280, LEVELS = 408;
// the LevelScale tables: [6 lists][qP % 6][16], then [2 lists][qP % 6][64]
constexpr int S_8X8 = 6 * 6 * 16;

__constant__ uint8_t kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                                      13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                                      26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35,
                                      35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
__constant__ uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,
                                   0,  0,  0,  4,  4,  5,  6,   7,   8,   9,   10,  12,  13,
                                   15, 17, 20, 22, 25, 28, 32,  36,  40,  45,  50,  56,  63,
                                   71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                                  11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ uint8_t kTc0[52][3] = {
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},  {0, 1, 1},  {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},  {1, 1, 2},  {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},  {2, 3, 4},  {3, 3, 5},   {3, 4, 6},   {3, 4, 6},   {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},  {5, 7, 10}, {6, 8, 11},  {6, 8, 13},  {7, 10, 14}, {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};
__constant__ uint8_t kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ uint8_t kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
__constant__ uint8_t kBlkAt[4][4] = {{0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};
// Intra4x4's top-right block: decoded (1), not (0), above (2), above-right (3)
__constant__ uint8_t kTopRight[16] = {2, 2, 1, 0, 2, 3, 1, 0, 1, 1, 1, 0, 1, 0, 1, 0};

__device__ __forceinline__ int clip255(int x) { return x < 0 ? 0 : x > 255 ? 255 : x; }
__device__ __forceinline__ int clip3(int lo, int hi, int x) { return x < lo ? lo : x > hi ? hi : x; }

// LevelScale4x4 of list ``list`` at qP and raster position ``pos``
__device__ __forceinline__ int ls4(const int32_t* __restrict__ scales, int list, int qp, int pos) {
  return scales[(6 * list + qp % 6) * 16 + pos];
}

// 8.5.12.1 (bits 4) and 8.5.13.1 (bits 6): x = c LevelScale scaled by
// 2^(qP / 6 - bits), rounded where that is below 1
__device__ __forceinline__ int dequant(int x, int q6, int bits) {
  return q6 >= bits ? x << (q6 - bits) : (x + ((1 << (bits - q6)) >> 1)) >> (bits - q6);
}

// 8.5.13.2's one-dimensional 8-point transform of x[0], x[s], ..., x[7 s]
// in place; the second pass adds the final rounding
__device__ __forceinline__ void idct8(int* x, int s, bool last) {
  const int d0 = x[0], d1 = x[s], d2 = x[2 * s], d3 = x[3 * s], d4 = x[4 * s], d5 = x[5 * s],
            d6 = x[6 * s], d7 = x[7 * s];
  const int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
  const int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  const int r = last ? 32 : 0, sh = last ? 6 : 0;
  x[0] = (b0 + b7 + r) >> sh;
  x[s] = (b2 + b5 + r) >> sh;
  x[2 * s] = (b4 + b3 + r) >> sh;
  x[3 * s] = (b6 + b1 + r) >> sh;
  x[4 * s] = (b6 - b1 + r) >> sh;
  x[5 * s] = (b4 - b3 + r) >> sh;
  x[6 * s] = (b2 - b5 + r) >> sh;
  x[7 * s] = (b0 - b7 + r) >> sh;
}

__device__ __forceinline__ int qp_chroma(int qp, int off) { return kChromaQp[clip3(0, 51, qp + off)]; }

struct Planes {
  uint8_t* y;
  uint8_t* u;
  uint8_t* v;
  int lw, lh, cw, ch;
};

__device__ Planes planes(uint8_t* frame, int mb_w, int mb_h) {
  Planes p;
  p.lw = 16 * mb_w;
  p.lh = 16 * mb_h;
  p.cw = 8 * mb_w;
  p.ch = 8 * mb_h;
  p.y = frame;
  p.u = frame + (long)p.lw * p.lh;
  p.v = p.u + (long)p.cw * p.ch;
  return p;
}

// The macroblock's 24 blocks of residual into d[24][16] (384 threads); with
// the 8x8 transform its luma as four 8x8 blocks, d[0..15] read as [4][64]
// (the level row's layout, so coefficient t stays at thread t).
__device__ void residual(const int* rec, const int16_t* __restrict__ levels,
                         const int32_t* __restrict__ scales, int (*d)[16], int t) {
  const int row = rec[F_ROW], blk = t >> 4, pos = t & 15;
  const int16_t* L = row >= 0 ? levels + (long)row * LEVELS : nullptr;
  const int qp = rec[F_QP], inter = rec[F_KIND] >= K_P, t8 = rec[F_T8];
  int v;
  if (blk < 16 && t8) {
    const int lv = L ? L[t] : 0;
    v = dequant(lv * scales[S_8X8 + (6 * inter + qp % 6) * 64 + (t & 63)], qp / 6, 6);
  } else if (blk < 16) {
    const int lv = L ? L[16 * blk + pos] : 0;
    v = dequant(lv * ls4(scales, 3 * inter, qp, pos), qp / 6, 4);
    if (pos == 0 && rec[F_KIND] == K_I16) {
      // the Intra16x16 DC of this block: (H c H) at (row, column) of blocks
      const int bi = kBlkY[blk], bj = kBlkX[blk];
      int f = 0;
      for (int k = 0; k < 4; ++k)
        for (int l = 0; l < 4; ++l) {
          const int c = L ? L[L_DC + 4 * k + l] : 0;
          // H = [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]]
          const int Hk = (bi == 0) ? 1 : (bi == 1) ? (k < 2 ? 1 : -1)
                                       : (bi == 2) ? ((k == 0 || k == 3) ? 1 : -1)
                                                   : ((k & 1) ? -1 : 1);
          const int Hl = (bj == 0) ? 1 : (bj == 1) ? (l < 2 ? 1 : -1)
                                       : (bj == 2) ? ((l == 0 || l == 3) ? 1 : -1)
                                                   : ((l & 1) ? -1 : 1);
          f += Hk * c * Hl;
        }
      // scaled as cv2's libavcodec (its x86 h264_luma_dc_dequant_idct)
      // scales it: qmul in 16 bits, or qmul >> 7 above 32767
      const int qmul = ls4(scales, 0, qp, 0) << (qp / 6 + 2);
      v = qmul <= 32767 ? (f * qmul + 128) >> 8 : (f * (qmul >> 7) + 1) >> 1;
    }
  } else {
    const int c = (blk - 16) >> 2, b = (blk - 16) & 3;
    const int qc = qp_chroma(qp, rec[F_CQP0 + c]), list = 3 * inter + 1 + c;
    if (pos == 0) {
      int a = 0, bb = 0, cc = 0, dd = 0;
      if (L) {
        a = L[L_CDC + 4 * c];
        bb = L[L_CDC + 4 * c + 1];
        cc = L[L_CDC + 4 * c + 2];
        dd = L[L_CDC + 4 * c + 3];
      }
      const int f = b == 0 ? a + bb + cc + dd : b == 1 ? a - bb + cc - dd
                  : b == 2 ? a + bb - cc - dd : a - bb - cc + dd;
      v = ((f * ls4(scales, list, qc, 0)) << (qc / 6)) >> 5;
    } else {
      const int lv = L ? L[L_CAC + 64 * c + 16 * b + pos] : 0;
      v = dequant(lv * ls4(scales, list, qc, pos), qc / 6, 4);
    }
  }
  d[blk][pos] = v;
  __syncthreads();
  int* flat = &d[0][0];
  if (t < 96 && (t >= 64 || !t8)) {  // rows of the 4x4 blocks
    int* r = &d[t >> 2][4 * (t & 3)];
    const int e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
    r[0] = e0 + e3;
    r[1] = e1 + e2;
    r[2] = e1 - e2;
    r[3] = e0 - e3;
  } else if (t < 32 && t8) {  // rows of the 8x8 blocks
    idct8(flat + 64 * (t >> 3) + 8 * (t & 7), 1, false);
  }
  __syncthreads();
  if (t < 96 && (t >= 64 || !t8)) {  // columns of the 4x4 blocks
    int* c = &d[t >> 2][t & 3];
    const int g0 = c[0] + c[8], g1 = c[0] - c[8], g2 = (c[4] >> 1) - c[12], g3 = c[4] + (c[12] >> 1);
    c[0] = (g0 + g3 + 32) >> 6;
    c[4] = (g1 + g2 + 32) >> 6;
    c[8] = (g1 - g2 + 32) >> 6;
    c[12] = (g0 - g3 + 32) >> 6;
  } else if (t < 32 && t8) {  // columns of the 8x8 blocks
    idct8(flat + 64 * (t >> 3) + (t & 7), 8, true);
  }
  __syncthreads();
}

// sample t's residual (0..255 luma raster, then Cb, then Cr)
__device__ __forceinline__ int res_at(int (*d)[16], int t, int t8) {
  if (t < 256) {
    const int x = t & 15, y = t >> 4;
    if (t8) return (&d[0][0])[64 * (2 * (y >> 3) + (x >> 3)) + 8 * (y & 7) + (x & 7)];
    return d[kBlkAt[y >> 2][x >> 2]][4 * (y & 3) + (x & 3)];
  }
  const int c = (t - 256) >> 6, q = (t - 256) & 63, x = q & 7, y = q >> 3;
  return d[16 + 4 * c + 2 * (y >> 2) + (x >> 2)][4 * (y & 3) + (x & 3)];
}

// sample t's offset in the frame of macroblock (mx, my)
__device__ __forceinline__ long offset_of(const Planes& p, int mx, int my, int t) {
  if (t < 256) return (long)(16 * my + (t >> 4)) * p.lw + 16 * mx + (t & 15);
  const int c = (t - 256) >> 6, q = (t - 256) & 63;
  return (long)p.lw * p.lh + (long)c * p.cw * p.ch + (long)(8 * my + (q >> 3)) * p.cw + 8 * mx +
         (q & 7);
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// sample t's prediction (t < 256 luma raster, else Cb, Cr) of macroblock
// (mx, my) from the frame ``pr`` by vector (vx, vy)
__device__ int predict(const Planes& pr, int mx, int my, int t, int vx, int vy) {
  if (t < 256) {
    const int xi = 16 * mx + (t & 15) + (vx >> 2), yi = 16 * my + (t >> 4) + (vy >> 2);
    int w[6][6];
    for (int r = 0; r < 6; ++r) {
      const int yy = clip3(0, pr.lh - 1, yi + r - 2);
      for (int c = 0; c < 6; ++c) w[r][c] = pr.y[(long)yy * pr.lw + clip3(0, pr.lw - 1, xi + c - 2)];
    }
    int b1[6], h1[6];
    for (int r = 0; r < 6; ++r) b1[r] = tap6(w[r][0], w[r][1], w[r][2], w[r][3], w[r][4], w[r][5]);
    for (int c = 0; c < 6; ++c) h1[c] = tap6(w[0][c], w[1][c], w[2][c], w[3][c], w[4][c], w[5][c]);
    const int G = w[2][2], H = w[2][3], M = w[3][2];
    const int b = clip255((b1[2] + 16) >> 5), s = clip255((b1[3] + 16) >> 5);
    const int h = clip255((h1[2] + 16) >> 5), m = clip255((h1[3] + 16) >> 5);
    const int j = clip255((tap6(b1[0], b1[1], b1[2], b1[3], b1[4], b1[5]) + 512) >> 10);
    switch (4 * (vy & 3) + (vx & 3)) {
      case 0: return G;
      case 1: return (G + b + 1) >> 1;
      case 2: return b;
      case 3: return (b + H + 1) >> 1;
      case 4: return (G + h + 1) >> 1;
      case 5: return (b + h + 1) >> 1;
      case 6: return (b + j + 1) >> 1;
      case 7: return (b + m + 1) >> 1;
      case 8: return h;
      case 9: return (h + j + 1) >> 1;
      case 10: return j;
      case 11: return (j + m + 1) >> 1;
      case 12: return (h + M + 1) >> 1;
      case 13: return (h + s + 1) >> 1;
      case 14: return (j + s + 1) >> 1;
      default: return (m + s + 1) >> 1;
    }
  }
  const int c = (t - 256) >> 6, q = (t - 256) & 63;
  const uint8_t* P = c ? pr.v : pr.u;
  const int x0 = 8 * mx + (q & 7) + (vx >> 3), y0 = 8 * my + (q >> 3) + (vy >> 3);
  const int fx = vx & 7, fy = vy & 7;
  const int xa = clip3(0, pr.cw - 1, x0), xb = clip3(0, pr.cw - 1, x0 + 1);
  const int ya = clip3(0, pr.ch - 1, y0), yb = clip3(0, pr.ch - 1, y0 + 1);
  return ((8 - fx) * (8 - fy) * P[(long)ya * pr.cw + xa] + fx * (8 - fy) * P[(long)ya * pr.cw + xb] +
          (8 - fx) * fy * P[(long)yb * pr.cw + xa] + fx * fy * P[(long)yb * pr.cw + xb] + 32) >> 6;
}

__global__ void __launch_bounds__(384) h264_inter_kernel(uint8_t* __restrict__ dpb, long frame_bytes,
                                                         int slot, const int32_t* __restrict__ mbs,
                                                         const int16_t* __restrict__ levels,
                                                         const int32_t* __restrict__ scales,
                                                         const int32_t* __restrict__ weights,
                                                         const int32_t* __restrict__ list,
                                                         int mb_w, int mb_h) {
  __shared__ int rec[FIELDS];
  __shared__ int d[24][16];
  const int mb = list[blockIdx.x], t = threadIdx.x;
  if (t < FIELDS) rec[t] = mbs[(long)mb * FIELDS + t];
  __syncthreads();
  residual(rec, levels, scales, d, t);
  const int mx = mb % mb_w, my = mb / mb_w;
  uint8_t* out = dpb + (long)slot * frame_bytes;
  const Planes po = planes(out, mb_w, mb_h);
  int blk;
  if (t < 256) {
    blk = kBlkAt[t >> 6][(t & 15) >> 2];
  } else {
    const int q = (t - 256) & 63;
    blk = kBlkAt[q >> 4][(q & 7) >> 1];
  }
  const int comp = t < 256 ? 0 : 1 + ((t - 256) >> 6);
  int p[2], ref[2], used[2];
  for (int l = 0; l < 2; ++l) {
    const int sl = (rec[(l ? F_REF1 : F_REF) + (blk >> 2)] >> (8 * (blk & 3))) & 0xFF;
    ref[l] = (rec[(l ? F_RIDX1 : F_RIDX) + (blk >> 2)] >> (8 * (blk & 3))) & 31;
    used[l] = sl != UNUSED;
    p[l] = 0;
    if (used[l]) {
      const int packed = rec[(l ? F_MV1 : F_MV) + blk];
      p[l] = predict(planes(dpb + (long)sl * frame_bytes, mb_w, mb_h), mx, my, t,
                     (int)(int16_t)(packed & 0xFFFF), packed >> 16);
    }
  }
  // 8.4.2.3: the weighted sample prediction
  const int32_t* wt = weights + (long)rec[F_SLICE] * WT;
  const int mode = wt[W_MODE], lw = wt[W_LOGWD + (comp > 0)];
  auto w_of = [&](int l, int k) { return wt[W_EXPLICIT + ((32 * l + ref[l]) * 3 + comp) * 2 + k]; };
  int pred;
  if (used[0] && used[1]) {
    if (mode == 0) {
      pred = (p[0] + p[1] + 1) >> 1;
    } else if (mode == 1) {
      pred = clip255(((p[0] * w_of(0, 0) + p[1] * w_of(1, 0) + (1 << lw)) >> (lw + 1)) +
                     ((w_of(0, 1) + w_of(1, 1) + 1) >> 1));
    } else {
      const int w0 = wt[W_IMPLICIT + 32 * ref[0] + ref[1]];
      pred = clip255((p[0] * w0 + p[1] * (64 - w0) + 32) >> 6);
    }
  } else {
    const int l = used[0] ? 0 : 1;
    pred = p[l];
    if (mode == 1) {
      const int w = w_of(l, 0), o = w_of(l, 1);
      pred = clip255(lw > 0 ? ((pred * w + (1 << (lw - 1))) >> lw) + o : pred * w + o);
    }
  }
  out[offset_of(po, mx, my, t)] = (uint8_t)clip255(pred + res_at(d, t, rec[F_T8]));
}

// ------------------------------------------------------------- intra
__device__ __forceinline__ int dc_of(int st, int sl, bool ta, bool la, int n4) {
  // n4 samples a side: both (sum + n4) >> log2(2 n4), one (sum + n4/2) >> log2(n4)
  const int sh = n4 == 4 ? 3 : n4 == 8 ? 4 : 5;
  if (ta && la) return (st + sl + n4) >> sh;
  if (la) return (sl + n4 / 2) >> (sh - 1);
  if (ta) return (st + n4 / 2) >> (sh - 1);
  return 128;
}

// Intra4x4 (N 4) or Intra8x8 (N 8, from filtered samples) sample (x, y):
// T[0] the corner, T[1..2N] the row above; Lf[0] the corner, Lf[1..N] the
// left column
template <int N>
__device__ int pred_nxn(const int* T, const int* Lf, bool ta, bool la, int mode, int x, int y) {
#define P(i) T[clip3(0, 2 * N, (i) + 1)]
#define Q(i) Lf[clip3(0, N, (i) + 1)]
  const int corner = (Q(0) + 2 * T[0] + P(0) + 2) >> 2;
  switch (mode) {
    case 0: return P(x);
    case 1: return Q(y);
    case 2: {
      int st = 0, sl = 0;
      for (int i = 0; i < N; ++i) {
        st += P(i);
        sl += Q(i);
      }
      return dc_of(st, sl, ta, la, N);
    }
    case 3:
      if (x == N - 1 && y == N - 1) return (P(2 * N - 2) + 3 * P(2 * N - 1) + 2) >> 2;
      return (P(x + y) + 2 * P(x + y + 1) + P(x + y + 2) + 2) >> 2;
    case 4: {
      const int dxy = x - y;
      if (dxy > 0) return (P(dxy - 2) + 2 * P(dxy - 1) + P(dxy) + 2) >> 2;
      if (dxy < 0) return (Q(-dxy - 2) + 2 * Q(-dxy - 1) + Q(-dxy) + 2) >> 2;
      return (P(0) + 2 * T[0] + Q(0) + 2) >> 2;
    }
    case 5: {
      const int z = 2 * x - y, hy = y >> 1;
      if (z >= 0 && !(z & 1)) return (P(x - hy - 1) + P(x - hy) + 1) >> 1;
      if (z > 0) return (P(x - hy - 2) + 2 * P(x - hy - 1) + P(x - hy) + 2) >> 2;
      if (z == -1) return corner;
      return (Q(y - 2 * x - 1) + 2 * Q(y - 2 * x - 2) + Q(y - 2 * x - 3) + 2) >> 2;
    }
    case 6: {
      const int z = 2 * y - x, hx = x >> 1;
      if (z >= 0 && !(z & 1)) return (Q(y - hx - 1) + Q(y - hx) + 1) >> 1;
      if (z > 0) return (Q(y - hx - 2) + 2 * Q(y - hx - 1) + Q(y - hx) + 2) >> 2;
      if (z == -1) return corner;
      return (P(x - 2 * y - 1) + 2 * P(x - 2 * y - 2) + P(x - 2 * y - 3) + 2) >> 2;
    }
    case 7: {
      const int hy = y >> 1;
      if (!(y & 1)) return (P(x + hy) + P(x + hy + 1) + 1) >> 1;
      return (P(x + hy) + 2 * P(x + hy + 1) + P(x + hy + 2) + 2) >> 2;
    }
    default: {
      const int z = x + 2 * y, hx = x >> 1;
      if (z < 2 * N - 3 && !(z & 1)) return (Q(y + hx) + Q(y + hx + 1) + 1) >> 1;
      if (z < 2 * N - 3) return (Q(y + hx) + 2 * Q(y + hx + 1) + Q(y + hx + 2) + 2) >> 2;
      if (z == 2 * N - 3) return (Q(N - 2) + 3 * Q(N - 1) + 2) >> 2;
      return Q(N - 1);
    }
  }
#undef P
#undef Q
}

// 8.3.2.2.1: Intra8x8's reference samples T (corner, 16 above, the top-right
// already substituted) and Lf (corner, 8 on the left) filtered in place, each
// read only where available
__device__ void filter8(int* T, int* Lf, bool ta, bool la, bool tla) {
  int t[16], l[8];
  for (int i = 0; i < 16; ++i) t[i] = T[i + 1];
  for (int i = 0; i < 8; ++i) l[i] = Lf[i + 1];
  const int c = T[0];
  T[1] = tla ? (c + 2 * t[0] + t[1] + 2) >> 2 : (3 * t[0] + t[1] + 2) >> 2;
  for (int i = 1; i < 15; ++i) T[i + 1] = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
  T[16] = (t[14] + 3 * t[15] + 2) >> 2;
  Lf[1] = tla ? (c + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
  for (int i = 1; i < 7; ++i) Lf[i + 1] = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
  Lf[8] = (l[6] + 3 * l[7] + 2) >> 2;
  T[0] = Lf[0] = ta && la ? (t[0] + 2 * c + l[0] + 2) >> 2
                 : ta     ? (3 * c + t[0] + 2) >> 2
                 : la     ? (3 * c + l[0] + 2) >> 2
                          : c;
}

// plane prediction of sample (x, y) of an n x n block (16: k 5; 8: k 34)
__device__ int plane_pred(const uint8_t* P, int stride, int x0, int y0, int n, int k, int x,
                          int y) {
  const int half = n / 2;
  auto top = [&](int i) { return (int)P[(long)(y0 - 1) * stride + x0 + i]; };  // i >= -1
  auto left = [&](int i) { return (int)P[(long)(y0 + i) * stride + x0 - 1]; };
  int Hs = 0, Vs = 0;
  for (int i = 0; i < half; ++i) {
    Hs += (i + 1) * (top(half + i) - top(half - 2 - i));
    Vs += (i + 1) * (left(half + i) - left(half - 2 - i));
  }
  const int a = 16 * (left(n - 1) + top(n - 1));
  const int b = (k * Hs + 32) >> 6, c = (k * Vs + 32) >> 6;
  return clip255((a + b * (x - (half - 1)) + c * (y - (half - 1)) + 16) >> 5);
}

__global__ void __launch_bounds__(384) h264_intra_kernel(uint8_t* __restrict__ frame,
                                                         const int32_t* __restrict__ mbs,
                                                         const int16_t* __restrict__ levels,
                                                         const int32_t* __restrict__ scales,
                                                         const int32_t* __restrict__ order,
                                                         int mb_w, int mb_h) {
  __shared__ int rec[FIELDS];
  __shared__ int d[24][16];
  __shared__ int T8[17], L8[9];  // an Intra8x8 block's filtered reference samples
  const int mb = order[blockIdx.x], t = threadIdx.x;
  if (t < FIELDS) rec[t] = mbs[(long)mb * FIELDS + t];
  __syncthreads();
  const Planes p = planes(frame, mb_w, mb_h);
  const int mx = mb % mb_w, my = mb / mb_w, kind = rec[F_KIND];
  if (kind == K_PCM) {
    frame[offset_of(p, mx, my, t)] = (uint8_t)levels[(long)rec[F_ROW] * LEVELS + t];
    return;
  }
  residual(rec, levels, scales, d, t);
  const int av = rec[F_AVAIL], t8 = rec[F_T8];
  const bool A = av & 1, B = av & 2, C = av & 4, D = av & 8;
  if (t >= 256) {  // chroma
    const int c = (t - 256) >> 6, q = (t - 256) & 63, x = q & 7, y = q >> 3;
    uint8_t* P = c ? p.v : p.u;
    const int x0 = 8 * mx, y0 = 8 * my, mode = rec[F_MC];
    const int yt = max(y0 - 1, 0), xl = max(x0 - 1, 0);
    int pred;
    if (mode == 0) {
      const int bx = x >> 2, by = y >> 2;
      int st = 0, sl = 0;
      for (int i = 0; i < 4; ++i) {
        st += P[(long)yt * p.cw + x0 + 4 * bx + i];
        sl += P[(long)(y0 + 4 * by + i) * p.cw + xl];
      }
      const int both = (st + sl + 4) >> 3, to = (st + 2) >> 2, lo = (sl + 2) >> 2;
      if (bx == by)
        pred = B && A ? both : A ? lo : B ? to : 128;
      else if (bx)
        pred = B ? to : A ? lo : 128;
      else
        pred = A ? lo : B ? to : 128;
    } else if (mode == 1) {
      pred = P[(long)(y0 + y) * p.cw + xl];
    } else if (mode == 2) {
      pred = P[(long)yt * p.cw + x0 + x];
    } else {
      pred = plane_pred(P, p.cw, x0, y0, 8, 34, x, y);
    }
    P[(long)(y0 + y) * p.cw + x0 + x] = (uint8_t)clip255(pred + res_at(d, t, t8));
  }
  const int x0 = 16 * mx, y0 = 16 * my;
  if (kind == K_I16) {
    if (t < 256) {
      const int x = t & 15, y = t >> 4, mode = rec[F_M16];
      const int yt = max(y0 - 1, 0), xl = max(x0 - 1, 0);
      int pred;
      if (mode == 0) {
        pred = p.y[(long)yt * p.lw + x0 + x];
      } else if (mode == 1) {
        pred = p.y[(long)(y0 + y) * p.lw + xl];
      } else if (mode == 2) {
        int st = 0, sl = 0;
        for (int i = 0; i < 16; ++i) {
          st += p.y[(long)yt * p.lw + x0 + i];
          sl += p.y[(long)(y0 + i) * p.lw + xl];
        }
        pred = dc_of(st, sl, B, A, 16);
      } else {
        pred = plane_pred(p.y, p.lw, x0, y0, 16, 5, x, y);
      }
      p.y[(long)(y0 + y) * p.lw + x0 + x] = (uint8_t)clip255(pred + res_at(d, t, t8));
    }
    return;
  }
  if (kind == K_I8) {  // Intra8x8, block by block
    for (int b8 = 0; b8 < 4; ++b8) {
      const int bx0 = x0 + 8 * (b8 & 1), by0 = y0 + 8 * (b8 >> 1);
      const bool la = (b8 & 1) ? true : A, ta = (b8 >> 1) ? true : B;
      if (t == 0) {
        const bool tra = b8 == 0 ? B : b8 == 1 ? C : b8 == 2;
        const bool tla = b8 == 0 ? D : b8 == 1 ? B : b8 == 2 ? A : true;
        const int yt = max(by0 - 1, 0), xl = max(bx0 - 1, 0);
        T8[0] = L8[0] = p.y[(long)yt * p.lw + xl];
        for (int i = 0; i < 16; ++i) T8[i + 1] = p.y[(long)yt * p.lw + min(bx0 + i, p.lw - 1)];
        if (!tra)
          for (int i = 8; i < 16; ++i) T8[i + 1] = T8[8];
        for (int i = 0; i < 8; ++i) L8[i + 1] = p.y[(long)(by0 + i) * p.lw + xl];
        filter8(T8, L8, ta, la, tla);
      }
      __syncthreads();
      if (t < 64) {
        const int x = t & 7, y = t >> 3;
        const int mode = (rec[F_MODES + (b8 >> 1)] >> (16 * (b8 & 1))) & 15;
        const int pred = pred_nxn<8>(T8, L8, ta, la, mode, x, y);
        p.y[(long)(by0 + y) * p.lw + bx0 + x] =
            (uint8_t)clip255(pred + (&d[0][0])[64 * b8 + 8 * y + x]);
      }
      __syncthreads();
    }
    return;
  }
  // Intra4x4, block by block
  for (int blk = 0; blk < 16; ++blk) {
    if (t < 16) {
      const int bx = kBlkX[blk], by = kBlkY[blk], x = t & 3, y = t >> 2;
      const int bx0 = x0 + 4 * bx, by0 = y0 + 4 * by;
      const bool la = bx ? true : A, ta = by ? true : B;
      const int tr = kTopRight[blk];
      const bool tra = tr == 2 ? B : tr == 3 ? C : tr == 1;
      const int yt = max(by0 - 1, 0), xl = max(bx0 - 1, 0);
      int T[9], Lf[5];
      T[0] = Lf[0] = p.y[(long)yt * p.lw + xl];
      for (int i = 0; i < 8; ++i) T[i + 1] = p.y[(long)yt * p.lw + min(bx0 + i, p.lw - 1)];
      if (!tra)
        for (int i = 4; i < 8; ++i) T[i + 1] = T[4];
      for (int i = 0; i < 4; ++i) Lf[i + 1] = p.y[(long)(by0 + i) * p.lw + xl];
      const int mode = (rec[F_MODES + (blk >> 3)] >> (4 * (blk & 7))) & 15;
      const int pred = pred_nxn<4>(T, Lf, ta, la, mode, x, y);
      p.y[(long)(by0 + y) * p.lw + bx0 + x] =
          (uint8_t)clip255(pred + d[blk][4 * y + x]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ deblocking
// filters one line: s[0..7] = p3 p2 p1 p0 q0 q1 q2 q3
__device__ void filter_line(int* s, int bs, int qpav, int off_a, int off_b, bool luma) {
  const int ia = clip3(0, 51, qpav + off_a), ib = clip3(0, 51, qpav + off_b);
  const int alpha = kAlpha[ia], beta = kBeta[ib];
  const int p0 = s[3], p1 = s[2], p2 = s[1], p3 = s[0], q0 = s[4], q1 = s[5], q2 = s[6], q3 = s[7];
  if (!(bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
  const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = kTc0[ia][bs - 1];
    const int tc = tc0 + (luma ? (int)ap + (int)aq : 1);
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[3] = clip255(p0 + delta);
    s[4] = clip255(q0 - delta);
    if (luma) {
      const int avg = (p0 + q0 + 1) >> 1;
      if (ap) s[2] = p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1);
      if (aq) s[5] = q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1);
    }
    return;
  }
  if (luma) {
    const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && strong) {
      s[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      s[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      s[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      s[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
      s[4] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      s[5] = (p0 + q0 + q1 + q2 + 2) >> 2;
      s[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      s[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  } else {
    s[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[4] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

__global__ void __launch_bounds__(32) h264_deblock_kernel(uint8_t* __restrict__ frame,
                                                          const int32_t* __restrict__ mbs,
                                                          const int32_t* __restrict__ order,
                                                          int mb_w, int mb_h) {
  const int mb = order[blockIdx.x], t = threadIdx.x;
  const Planes pl = planes(frame, mb_w, mb_h);
  const int mx = mb % mb_w, my = mb / mb_w;
  const int32_t* rec = mbs + (long)mb * FIELDS;
  const int qq = rec[F_QP];
  const bool luma = t < 16;
  const int c = luma ? 0 : (t - 16) >> 3, line = luma ? t : (t - 16) & 7;
  uint8_t* P = luma ? pl.y : c ? pl.v : pl.u;
  const int stride = luma ? pl.lw : pl.cw, size = luma ? 16 : 8;
  const int off = luma ? 0 : rec[F_CQP0 + c];
  for (int dir = 0; dir < 2; ++dir) {
    const int nb = dir == 0 ? (mx > 0 ? mb - 1 : mb) : (my > 0 ? mb - mb_w : mb);
    const int qn = mbs[(long)nb * FIELDS + F_QP];
    for (int e = 0; e < 4; ++e) {
      if (!luma && (e & 1)) continue;
      const int seg = luma ? line >> 2 : line >> 1;
      const int bs = (rec[F_BS + 4 * dir + e] >> (8 * seg)) & 0xFF;
      if (!bs) continue;
      const int qp_p = e == 0 ? qn : qq;
      const int qpav = luma ? (qp_p + qq + 1) >> 1
                            : (qp_chroma(qp_p, off) + qp_chroma(qq, off) + 1) >> 1;
      const int pos = luma ? 4 * e : 2 * e;
      long idx[8];
      int s[8];
      for (int k = 0; k < 8; ++k) {
        const int a = size * (dir == 0 ? mx : my) + pos + k - 4, b = size * (dir == 0 ? my : mx) + line;
        idx[k] = dir == 0 ? (long)b * stride + a : (long)a * stride + b;
        s[k] = P[idx[k]];
      }
      filter_line(s, bs, qpav, rec[F_ALPHA], rec[F_BETA], luma);
      for (int k = 1; k < 7; ++k) P[idx[k]] = (uint8_t)s[k];
    }
    __syncthreads();
  }
}

}  // namespace

// The P, B and skipped macroblocks ``list`` [n] of the picture in slot
// ``slot`` of ``dpb`` ([slots, frame_bytes] uint8): ``mbs`` int32
// [mb_w mb_h, 70] records, ``levels`` int16 [rows, 408], ``scales`` int32
// [1344] the picture's LevelScale tables, ``weights`` int32 [slices, 1411]
// its slices' weight tables.
extern "C" int moda_h264_inter(uint8_t* dpb, int64_t frame_bytes, int slot, const int32_t* mbs,
                               const int16_t* levels, const int32_t* scales,
                               const int32_t* weights, int slices, const int32_t* list, int n,
                               int mb_w, int mb_h, cudaStream_t stream) {
  if (n < 0 || mb_w < 1 || mb_h < 1 || slot < 0 || !dpb || !mbs || !scales || !weights ||
      slices < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  h264_inter_kernel<<<n, 384, 0, stream>>>(dpb, frame_bytes, slot, mbs, levels, scales, weights,
                                           list, mb_w, mb_h);
  return (int)cudaGetLastError();
}

// The intra macroblocks ``order`` of ``frame``, grouped by wavefront
// (``offsets`` [waves + 1], on the host): one launch a non-empty wavefront,
// counted in ``*launched``.
extern "C" int moda_h264_intra(uint8_t* frame, const int32_t* mbs, const int16_t* levels,
                               const int32_t* scales, const int32_t* order,
                               const int32_t* offsets, int waves, int mb_w, int mb_h,
                               cudaStream_t stream, int* launched) {
  *launched = 0;
  if (waves != mb_w + 2 * (mb_h - 1) || !frame || !mbs || !scales)
    return (int)cudaErrorInvalidValue;
  for (int w = 0; w < waves; ++w) {
    const int n = offsets[w + 1] - offsets[w];
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (!n) continue;
    h264_intra_kernel<<<n, 384, 0, stream>>>(frame, mbs, levels, scales, order + offsets[w], mb_w,
                                             mb_h);
    ++*launched;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The loop filter of ``frame`` over the macroblocks ``order`` with an edge
// to filter, grouped by wavefront as for moda_h264_intra.
extern "C" int moda_h264_deblock(uint8_t* frame, const int32_t* mbs, const int32_t* order,
                                 const int32_t* offsets, int waves, int mb_w, int mb_h,
                                 cudaStream_t stream, int* launched) {
  *launched = 0;
  if (waves != mb_w + 2 * (mb_h - 1) || !frame || !mbs) return (int)cudaErrorInvalidValue;
  for (int w = 0; w < waves; ++w) {
    const int n = offsets[w + 1] - offsets[w];
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (!n) continue;
    h264_deblock_kernel<<<n, 32, 0, stream>>>(frame, mbs, order + offsets[w], mb_w, mb_h);
    ++*launched;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* moda_h264_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
