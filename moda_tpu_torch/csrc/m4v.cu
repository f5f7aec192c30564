// The pixel half of the port's MPEG-4 Part 2 decoder (preproc/m4v.py) on
// Hopper (sm_90a): two kernels, each bit-equal to its plain PyTorch version
// (m4v.py::reconstruct_plain, ::yuv420_to_bgr_plain) and to what FFmpeg and
// swscale give cv2.VideoCapture.
//
// They replace no TPU kernel: the JAX package decodes video inside
// cv2.VideoCapture, on the host (moda_tpu/preproc/pipeline.py:38-57).
//
// m4v_reconstruct: one VOP. The host parse (native/m4v.cpp) has already
// resolved everything sequential (VLCs, vector prediction, DC and AC
// prediction), and MPEG-4 Part 2 has no in-loop filter and no pixel-domain
// intra prediction, so every macroblock is independent: one CTA a
// macroblock, 384 threads, thread 64 b + k for coefficient (then pixel) k
// of block b (0-3 luma, 4 Cb, 5 Cr). A CTA dequantises its levels (H.263:
// intra DC x dc_scaler, level 2QP +- ((QP - 1) | 1); intra blocks stored as
// int16, inter levels saturated as FFmpeg's escape 3 does), runs FFmpeg's
// 8-bit simple IDCT (rows with the DC-only shortcut, then columns; one
// thread a row, then a column, in shared memory), forms the half-pel
// prediction from the previous VOP (coordinates clamped to the
// macroblock-padded planes: unrestricted vectors as edge extension; the
// chroma vector by MPEG-4's one-vector rule; averages with the rounding
// control) and writes prediction + residual clipped to [0, 255]. It reads
// the reference frame and writes another: the frames are double-buffered,
// so no block reads a plane being written.
//
// yuv420_to_bgr: swscale's yuv420p -> BGR24 of the width x height picture
// at an even offset (its x86 SIMD yuv2rgb, limited range, the coefficients
// of BT.601 or of the matrix the caller names: chroma nearest over 2 x 2,
// products >> 16), one thread a pixel. preproc/h264.py calls it too, with
// the SPS's crop and colour matrix.
//
// Bound: bytes. A VOP reads its levels, records and (a P-VOP) the
// reference, and writes one frame; the conversion reads the picture's
// planes and writes three bytes a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;
constexpr int FIELDS = 10;  // a macroblock record: type, QP, mvx, mvy, 6 block rows
constexpr int MB_INTRA = 0;

__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }

__device__ __forceinline__ int clip255(int x) { return x < 0 ? 0 : x > 255 ? 255 : x; }

__device__ __forceinline__ int dc_scale(int qp, bool luma) {
  if (qp < 5) return 8;
  if (luma) return qp < 9 ? 2 * qp : qp < 25 ? qp + 8 : 2 * qp - 16;
  return qp < 25 ? (qp + 13) / 2 : qp - 6;
}

// ff_simple_idct_int16_8bit's idctRowCondDC: results stored as int16
__device__ void idct_row(int* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int v = wrap16(r[0] * 8);
    for (int i = 0; i < 8; ++i) r[i] = v;
    return;
  }
  int a0 = W4 * r[0] + (1 << (ROW_SHIFT - 1));
  int a1 = a0 + W6 * r[2], a2 = a0 - W6 * r[2], a3 = a0 - W2 * r[2];
  a0 += W2 * r[2];
  int b0 = W1 * r[1] + W3 * r[3], b1 = W3 * r[1] - W7 * r[3];
  int b2 = W5 * r[1] - W1 * r[3], b3 = W7 * r[1] - W5 * r[3];
  a0 += W4 * r[4] + W6 * r[6];
  a1 += -W4 * r[4] - W2 * r[6];
  a2 += -W4 * r[4] + W2 * r[6];
  a3 += W4 * r[4] - W6 * r[6];
  b0 += W5 * r[5] + W7 * r[7];
  b1 += -W1 * r[5] - W5 * r[7];
  b2 += W7 * r[5] + W3 * r[7];
  b3 += W3 * r[5] - W1 * r[7];
  r[0] = wrap16((a0 + b0) >> ROW_SHIFT);
  r[7] = wrap16((a0 - b0) >> ROW_SHIFT);
  r[1] = wrap16((a1 + b1) >> ROW_SHIFT);
  r[6] = wrap16((a1 - b1) >> ROW_SHIFT);
  r[2] = wrap16((a2 + b2) >> ROW_SHIFT);
  r[5] = wrap16((a2 - b2) >> ROW_SHIFT);
  r[3] = wrap16((a3 + b3) >> ROW_SHIFT);
  r[4] = wrap16((a3 - b3) >> ROW_SHIFT);
}

// idctSparseCol without the clip: column c of an 8 x 8 block, stride 8
__device__ void idct_col(int* c) {
  int a0 = W4 * (c[0] + ((1 << (COL_SHIFT - 1)) / W4));
  int a1 = a0 + W6 * c[16], a2 = a0 - W6 * c[16], a3 = a0 - W2 * c[16];
  a0 += W2 * c[16];
  int b0 = W1 * c[8] + W3 * c[24], b1 = W3 * c[8] - W7 * c[24];
  int b2 = W5 * c[8] - W1 * c[24], b3 = W7 * c[8] - W5 * c[24];
  a0 += W4 * c[32] + W6 * c[48];
  a1 += -W4 * c[32] - W2 * c[48];
  a2 += -W4 * c[32] + W2 * c[48];
  a3 += W4 * c[32] - W6 * c[48];
  b0 += W5 * c[40] + W7 * c[56];
  b1 += -W1 * c[40] - W5 * c[56];
  b2 += W7 * c[40] + W3 * c[56];
  b3 += W3 * c[40] - W1 * c[56];
  c[0] = (a0 + b0) >> COL_SHIFT;
  c[56] = (a0 - b0) >> COL_SHIFT;
  c[8] = (a1 + b1) >> COL_SHIFT;
  c[48] = (a1 - b1) >> COL_SHIFT;
  c[16] = (a2 + b2) >> COL_SHIFT;
  c[40] = (a2 - b2) >> COL_SHIFT;
  c[24] = (a3 + b3) >> COL_SHIFT;
  c[32] = (a3 - b3) >> COL_SHIFT;
}

// The half-pel prediction of pixel (x, y) of a w x h plane displaced by the
// half-pel vector (mx, my), coordinates clamped to the plane.
__device__ __forceinline__ int half_pel(const uint8_t* p, int w, int h, int x, int y, int mx,
                                        int my, int rounding) {
  int sx = x + (mx >> 1), sy = y + (my >> 1);
  int x0 = min(max(sx, 0), w - 1), x1 = min(max(sx + 1, 0), w - 1);
  int y0 = min(max(sy, 0), h - 1), y1 = min(max(sy + 1, 0), h - 1);
  int a = p[y0 * w + x0];
  if (mx & 1) {
    int b = p[y0 * w + x1];
    if (my & 1) return (a + b + p[y1 * w + x0] + p[y1 * w + x1] + 2 - rounding) >> 2;
    return (a + b + 1 - rounding) >> 1;
  }
  if (my & 1) return (a + p[y1 * w + x0] + 1 - rounding) >> 1;
  return a;
}

__global__ void __launch_bounds__(384) m4v_reconstruct_kernel(const uint8_t* __restrict__ ref,
                                                              const int32_t* __restrict__ mbs,
                                                              const int16_t* __restrict__ levels,
                                                              uint8_t* __restrict__ out,
                                                              int mb_w, int mb_h, int rounding) {
  __shared__ int blk[6][64];
  __shared__ int rec[FIELDS];
  const int mb = blockIdx.x, t = threadIdx.x, b = t >> 6, k = t & 63;
  if (t < FIELDS) rec[t] = mbs[(long)mb * FIELDS + t];
  __syncthreads();
  const int type = rec[0], qp = rec[1], row = rec[4 + b];
  const int L = row >= 0 ? levels[(long)row * 64 + k] : 0;
  int v;
  if (type == MB_INTRA && k == 0) {
    v = wrap16(L * dc_scale(qp, b < 4));
  } else {
    const int qadd = (qp - 1) | 1;
    v = L > 0 ? L * 2 * qp + qadd : L < 0 ? L * 2 * qp - qadd : 0;
    v = type == MB_INTRA ? wrap16(v) : min(max(v, -2048), 2047);
  }
  blk[b][k] = v;
  __syncthreads();
  if (k < 8) idct_row(&blk[b][8 * k]);
  __syncthreads();
  if (k < 8) idct_col(&blk[b][k]);
  __syncthreads();

  const int mx = mb % mb_w, my = mb / mb_w, r = k >> 3, c = k & 7;
  const int lw = 16 * mb_w, lh = 16 * mb_h, cw = 8 * mb_w, ch = 8 * mb_h;
  int x, y, w, h;
  long base;
  if (b < 4) {
    x = 16 * mx + 8 * (b & 1) + c;
    y = 16 * my + 8 * (b >> 1) + r;
    w = lw;
    h = lh;
    base = 0;
  } else {
    x = 8 * mx + c;
    y = 8 * my + r;
    w = cw;
    h = ch;
    base = (long)lw * lh + (b - 4) * (long)cw * ch;
  }
  int pix = blk[b][k];
  if (type != MB_INTRA && ref) {
    int vx = rec[2], vy = rec[3];
    if (b >= 4) {  // MPEG-4's chroma vector of a one-vector macroblock
      vx = (vx >> 1) | (vx & 1);
      vy = (vy >> 1) | (vy & 1);
    }
    pix += half_pel(ref + base, w, h, x, y, vx, vy, rounding);
  }
  out[base + (long)y * w + x] = (uint8_t)clip255(pix);
}

struct Coeffs {
  int ub, ug, vg, vr;
};

__global__ void yuv420_to_bgr_kernel(const uint8_t* __restrict__ frame, uint8_t* __restrict__ out,
                                     int lw, int lh, int width, int height, int left, int top,
                                     Coeffs k) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= width || y >= height) return;
  const int cw = lw / 2, fx = x + left, fy = y + top;
  const uint8_t* U = frame + (long)lw * lh;
  const uint8_t* V = U + (long)cw * (lh / 2);
  const int l = ((8 * frame[(long)fy * lw + fx] - 128) * 9539) >> 16;
  const int ci = (fy >> 1) * cw + (fx >> 1);
  const int u = 8 * U[ci] - 1024, v = 8 * V[ci] - 1024;
  uint8_t* o = out + ((long)y * width + x) * 3;
  o[0] = (uint8_t)clip255(l + ((u * k.ub) >> 16));
  o[1] = (uint8_t)clip255(l + ((u * k.ug) >> 16) + ((v * k.vg) >> 16));
  o[2] = (uint8_t)clip255(l + ((v * k.vr) >> 16));
}

}  // namespace

// One VOP of mb_w x mb_h macroblocks: ``mbs`` int32 [mb_w mb_h, 10],
// ``levels`` int16 [blocks, 64], ``ref`` the previous frame (null in an
// I-VOP: every macroblock is predicted from zero), ``out`` the new frame
// (both uint8, Y then U then V, macroblock-padded).
extern "C" int moda_m4v_reconstruct(const uint8_t* ref, const int32_t* mbs, const int16_t* levels,
                                    uint8_t* out, int mb_w, int mb_h, int rounding,
                                    cudaStream_t stream) {
  if (mb_w < 1 || mb_h < 1 || (rounding & ~1) || !mbs || !out) return (int)cudaErrorInvalidValue;
  m4v_reconstruct_kernel<<<mb_w * mb_h, 384, 0, stream>>>(ref, mbs, levels, out, mb_w, mb_h,
                                                          rounding);
  return (int)cudaGetLastError();
}

// The width x height picture at (left, top) (even: a 4:2:0 crop) of a
// padded frame as BGR24 [height, width, 3], with the colour matrix's
// coefficients (u -> B, u -> G, v -> G, v -> R; BT.601: 16525, -3209,
// -6660, 13075).
extern "C" int moda_yuv420_to_bgr(const uint8_t* frame, uint8_t* out, int mb_w, int mb_h,
                                  int width, int height, int left, int top, int ub, int ug,
                                  int vg, int vr, cudaStream_t stream) {
  if (width < 1 || height < 1 || left < 0 || top < 0 || (left | top) & 1 ||
      left + width > 16 * mb_w || top + height > 16 * mb_h)
    return (int)cudaErrorInvalidValue;
  dim3 grid((width + 127) / 128, height);
  yuv420_to_bgr_kernel<<<grid, 128, 0, stream>>>(frame, out, 16 * mb_w, 16 * mb_h, width, height,
                                                 left, top, Coeffs{ub, ug, vg, vr});
  return (int)cudaGetLastError();
}

extern "C" const char* moda_m4v_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
