// Fused NeRF-MLP stack for Hopper (sm_90a): forward (K1) and the
// rematerializing backward (K2), hand-written CUDA C++ with bf16 tensor-core
// products (WMMA m16n16k16, fp32 accumulation).
//
// Replaces moda_tpu/ops/fused_mlp.py::_fwd_kernel (K1) and ::_bwd_kernel
// (K2), launched there by _call_fwd / _fused_mlp_bwd through pl.pallas_call.
//
// K1 (fmlp_fwd_kernel): one CTA per block of BM_F points. The in-kernel
//   positional embed (x * 2^j is exact in fp32; sinf/cosf, never the fast
//   intrinsics: arguments reach 2^9 |x|), the per-ray code broadcast and
//   every layer of every net of the launch run with the activation tile in
//   shared memory; weights (bf16, padded and transposed by the wrapper)
//   stream from L2 one layer at a time. Bias, ReLU and sigmoid in fp32;
//   activations are rounded to bf16 exactly where the TPU kernel rounds them
//   (at each product input). Bound on the H100: tensor-core operations (the
//   trunk at 262,144 points is ~0.37 TFLOP against ~25 MB of inputs and
//   outputs). What holds it back today: the latency of the weight fragments
//   from L2, with one CTA of 8 warps per SM at the trunk's width (the fp32
//   accumulator tile takes 66 KB of shared memory).
// K2 (fmlp_bwd_kernel + fmlp_dw_kernel + fmlp_reduce_kernel): persistent
//   CTAs walk blocks of BM_B points. Each block recomputes the forward,
//   writes every layer's bf16 input activation (A) and bf16 pre-activation
//   gradient (D) to scratch, and propagates the VJP back to the embed (dx,
//   per-ray code grads, window grad). The TPU kernel carried dW/db in one
//   buffer across its sequential grid; blocks here run concurrently, so:
//     - db and dwin: per-CTA partial sums in shared memory, written once per
//       CTA, then summed by a second kernel in a fixed order;
//     - dW = A^T D: a split-K tensor-core GEMM over all points (chunks of
//       both stacks staged in shared memory by cp.async) with one fp32
//       partial per split, then the same fixed-order reduction;
//     - code grads: blocks are ray-aligned (BM_B | S or S | BM_B), so a
//       ray's sum lies inside one block or in consecutive per-block slots.
//   No atomics: results are deterministic run to run.
//   Bound: tensor-core operations (~3x the forward's) plus the A/D scratch
//   traffic (~2 x 14 KB per point for the trunk + feature launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define MAXNETS 2
#define MAXLAYERS 12
#define NTHREADS 256
#define NWARPS (NTHREADS / 32)
#define BM_F 64
#define BM_B 32

// ---------------------------------------------------------------- layouts
// Mirrored field for field by ctypes Structures in ops/fused_mlp.py.
struct LayerDesc {
  int kin;       // padded input width (rows of the padded kernel)
  int nout;      // padded output width
  int bias_off;  // offset into the concatenated padded biases / db
  int dw_off;    // offset into the concatenated padded dW
  const bf16* w; // [kin][nout] bf16, rows laid out segment by segment
  const bf16* wt; // the same, transposed [nout][kin]: the forward's B
  bf16* a;       // backward scratch: [npad][kin] input activations
  bf16* d;       // backward scratch: [npad][nout] pre-activation grads
};

struct NetDesc {
  int D, skips, W, out_ch, out_pad, sigmoid, drop_sigma, uses_ct, uses_cd, tin;
  float* out;     // [N][out_ch + !drop_sigma]
  const float* g; // cotangent, same shape (backward)
  LayerDesc layers[MAXLAYERS];
};

struct FusedDesc {
  int n, s, c, f, in_x, xp, ct, ctp, cd, cdp, nnets;
  int need_dx, need_dt, need_dwin;
  int hw, outw, accw_f, accw_b, dsw, total_bias, total_w;
  int npad, nblocks, grid, nsplit, chunk;
  const float* x;        // [N][c] raw points (f > 0) or [N][in_x]
  const float* ct_code;  // [R][ct]
  const float* cd_code;  // [R][cd]
  const float* win;      // [2fc]
  const float* bias;     // [total_bias] padded, concatenated
  float* dx;             // [N][c] or [N][in_x]
  float* part_b;         // [grid][total_bias]
  float* part_win;       // [grid][2fc]
  float* part_ct;        // [nslots][ctp]
  float* part_cd;        // [nslots][cdp]
  float* part_w;         // [nsplit][total_w]
  NetDesc nets[MAXNETS];
};

__host__ __device__ inline int align128(int b) { return (b + 127) & ~127; }

// Row strides of the shared-memory tiles that feed tensor-core products are
// padded past a multiple of 128 bytes (8 bf16, 4 fp32), so the 8 rows of a
// fragment load or store fall in different banks.
#define PADH 8
#define PADF 4

struct Smem {
  bf16 *xe, *ct, *cd, *h0, *h1, *ds, *ds2;
  float *acc, *outs, *dt, *dcd, *bacc, *wacc;
  int lx, lct, lcd, lh, lacc, lds, lds2;  // row strides (elements)
};

__host__ __device__ inline int acc_width(const FusedDesc& d, bool bwd) {
  return (bwd ? d.accw_b : d.accw_f) + PADF;
}

// byte offsets of the shared-memory buffers; returns the total size
__host__ __device__ inline int smem_layout(const FusedDesc& d, int BM, bool bwd, int* o) {
  int off = 0, i = 0;
  auto put = [&](int bytes) { o[i++] = off; off += align128(bytes); };
  put(BM * (d.xp + PADH) * 2);            // 0 xe
  put(BM * (d.ctp + PADH) * 2);           // 1 ct
  put(BM * (d.cdp + PADH) * 2);           // 2 cd
  put(BM * (d.hw + PADH) * 2);            // 3 h0
  put(BM * (d.hw + PADH) * 2);            // 4 h1
  put(BM * acc_width(d, bwd) * 4);        // 5 acc
  put(BM * d.outw * 4);                   // 6 outs
  if (bwd) {
    put(BM * (d.dsw + PADH) * 2);         // 7 ds
    put(BM * (16 + PADH) * 2);            // 8 ds2
    put(BM * (d.xp + d.ctp) * 4);          // 9 dt
    put(BM * d.cdp * 4);                   // 10 dcd
    put(d.total_bias * 4);                 // 11 bacc
    put(2 * d.f * d.c * 4 + 4);            // 12 wacc
  }
  return off;
}

__device__ inline Smem carve(const FusedDesc& d, int BM, bool bwd) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int o[13];
  smem_layout(d, BM, bwd, o);
  Smem s;
  s.xe = (bf16*)(smem_raw + o[0]);
  s.ct = (bf16*)(smem_raw + o[1]);
  s.cd = (bf16*)(smem_raw + o[2]);
  s.h0 = (bf16*)(smem_raw + o[3]);
  s.h1 = (bf16*)(smem_raw + o[4]);
  s.acc = (float*)(smem_raw + o[5]);
  s.outs = (float*)(smem_raw + o[6]);
  s.lx = d.xp + PADH;
  s.lct = d.ctp + PADH;
  s.lcd = d.cdp + PADH;
  s.lh = d.hw + PADH;
  s.lacc = acc_width(d, bwd);
  s.lds = d.dsw + PADH;
  s.lds2 = 16 + PADH;
  s.ds = s.ds2 = nullptr;
  s.dt = s.dcd = s.bacc = s.wacc = nullptr;
  if (bwd) {
    s.ds = (bf16*)(smem_raw + o[7]);
    s.ds2 = (bf16*)(smem_raw + o[8]);
    s.dt = (float*)(smem_raw + o[9]);
    s.dcd = (float*)(smem_raw + o[10]);
    s.bacc = (float*)(smem_raw + o[11]);
    s.wacc = (float*)(smem_raw + o[12]);
  }
  return s;
}

// ------------------------------------------------------------------ GEMM
// One K-segment of a block product: A [BM][k] bf16 in shared memory (row
// stride lda) times B [k][n], bf16 in global memory, given as its transpose
// [n][k] (row stride ldb): a B fragment is then 16 contiguous runs of 16
// values, read 32 bits at a time.
struct Seg {
  const bf16* a;
  int lda, k;
  const bf16* b;
  int ldb;
};

// C[BM][n] (fp32, shared, stride ldc) = sum over segments of A_seg B_seg
template <int BM>
__device__ void block_gemm(const Seg* segs, int nseg, int n, float* c, int ldc) {
  constexpr int RT = BM / 16;
  const int warp = threadIdx.x / 32;
  // B fragments come from global memory (L2): KU of them are requested
  // before the products that use them, so their latencies overlap
  constexpr int KU = 4;
  for (int tn = warp; tn < n / 16; tn += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
    for (int si = 0; si < nseg; ++si) {
      const Seg sg = segs[si];
      const bf16* bt = sg.b + (size_t)(tn * 16) * sg.ldb;
      for (int k0 = 0; k0 < sg.k; k0 += 16 * KU) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf[KU];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = k0 + 16 * u;
          if (k < sg.k) wmma::load_matrix_sync(bf[u], bt + k, sg.ldb);
        }
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int k = k0 + 16 * u;
          if (k < sg.k) {
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
              wmma::load_matrix_sync(af, sg.a + (size_t)(r * 16) * sg.lda + k, sg.lda);
              wmma::mma_sync(acc[r], af, bf[u], acc[r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
      wmma::store_matrix_sync(c + (r * 16) * ldc + tn * 16, acc[r], ldc, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------- inputs
__device__ inline float embed_col(const FusedDesc& d, int p, int k) {
  // column k of the embedded row p, in fp32 (f > 0)
  const int C = d.c;
  if (k < C) return d.x[(size_t)p * C + k];
  const int kk = k - C;
  const int j = kk / (2 * C), sl = (kk / C) & 1, ch = kk % C;
  const float xf = ldexpf(d.x[(size_t)p * C + ch], j);
  const float t = sl == 0 ? sinf(xf) : cosf(xf);
  return t * d.win[kk];
}

template <int BM>
__device__ void load_inputs(const FusedDesc& d, int row0, const Smem& s) {
  for (int i = threadIdx.x; i < BM * d.xp; i += NTHREADS) {
    const int r = i / d.xp, k = i % d.xp, p = row0 + r;
    float v = 0.0f;
    if (p < d.n && k < d.in_x) v = d.f > 0 ? embed_col(d, p, k) : d.x[(size_t)p * d.in_x + k];
    s.xe[r * s.lx + k] = __float2bfloat16_rn(v);
  }
  for (int i = threadIdx.x; i < BM * d.ctp; i += NTHREADS) {
    const int r = i / d.ctp, k = i % d.ctp, p = row0 + r;
    float v = 0.0f;
    if (p < d.n && k < d.ct) v = d.ct_code[(size_t)(p / d.s) * d.ct + k];
    s.ct[r * s.lct + k] = __float2bfloat16_rn(v);
  }
  for (int i = threadIdx.x; i < BM * d.cdp; i += NTHREADS) {
    const int r = i / d.cdp, k = i % d.cdp, p = row0 + r;
    float v = 0.0f;
    if (p < d.n && k < d.cd) v = d.cd_code[(size_t)(p / d.s) * d.cd + k];
    s.cd[r * s.lcd + k] = __float2bfloat16_rn(v);
  }
}

// copy the segments of a layer input into its A stack rows (backward), 8
// bf16 (16 bytes) at a time: every width, stride and offset is a multiple of 8
template <int BM>
__device__ void stash(const LayerDesc& L, int row0, const Seg* segs, int nseg) {
  int col = 0;
  for (int si = 0; si < nseg; ++si) {
    const Seg sg = segs[si];
    const int k8 = sg.k / 8;
    for (int i = threadIdx.x; i < BM * k8; i += NTHREADS) {
      const int r = i / k8, k = (i % k8) * 8;
      *reinterpret_cast<uint4*>(L.a + (size_t)(row0 + r) * L.kin + col + k) =
          *reinterpret_cast<const uint4*>(sg.a + r * sg.lda + k);
    }
    col += sg.k;
  }
}

// trunk-input segments shared by layer 0 and the skip layers
__device__ inline int trunk_segs(const FusedDesc& d, const NetDesc& nd, const Smem& s,
                                 const LayerDesc& L, Seg* segs) {
  int n = 0;
  segs[n++] = Seg{s.xe, s.lx, d.xp, L.wt, L.kin};
  if (nd.uses_ct) segs[n++] = Seg{s.ct, s.lct, d.ctp, L.wt + d.xp, L.kin};
  return n;
}

// ----------------------------------------------------------- net forward
// Runs one net on the loaded block. Leaves the rgb head (after sigmoid when
// the net applies it) in s.outs[BM][outw]; writes sigma/rgb to nd.out when
// WRITE_OUT. STASH writes every layer input to its A stack.
template <int BM, bool STASH, bool WRITE_OUT>
__device__ void net_forward(const FusedDesc& d, const NetDesc& nd, int row0, const Smem& s) {
  const int W = nd.W, Wd = W / 2, D = nd.D, accw = s.lacc, lh = s.lh;
  bf16* h = s.h0;
  bf16* h2 = s.h1;
  Seg segs[3];
  for (int i = 0; i < D; ++i) {
    const LayerDesc& L = nd.layers[i];
    int nseg = 0;
    if (i == 0 || ((nd.skips >> i) & 1)) nseg = trunk_segs(d, nd, s, L, segs);
    if (i > 0) segs[nseg++] = Seg{h, lh, W, L.wt + (L.kin - W), L.kin};
    if (STASH) stash<BM>(L, row0, segs, nseg);
    block_gemm<BM>(segs, nseg, W, s.acc, accw);
    __syncthreads();
    const float* b = d.bias + L.bias_off;
    for (int e = threadIdx.x; e < BM * W; e += NTHREADS) {
      const int r = e / W, cc = e % W;
      h2[r * lh + cc] = __float2bfloat16_rn(fmaxf(s.acc[r * accw + cc] + b[cc], 0.0f));
    }
    __syncthreads();
    bf16* t = h; h = h2; h2 = t;
  }
  // heads: sigma and final share the trunk output as input
  const LayerDesc& Ls = nd.layers[D];
  const LayerDesc& Lf = nd.layers[D + 1];
  const LayerDesc& Ld = nd.layers[D + 2];
  const LayerDesc& Lr = nd.layers[D + 3];
  segs[0] = Seg{h, lh, W, Lf.wt, Lf.kin};
  if (STASH) stash<BM>(Lf, row0, segs, 1);  // Ls.a aliases Lf.a
  if (!nd.drop_sigma && WRITE_OUT) {
    Seg ss = Seg{h, lh, W, Ls.wt, Ls.kin};
    block_gemm<BM>(&ss, 1, Ls.nout, s.acc, accw);
    __syncthreads();
    const int ostride = nd.out_ch + 1;
    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
      const int p = row0 + r;
      if (p < d.n) nd.out[(size_t)p * ostride + nd.out_ch] = s.acc[r * accw] + d.bias[Ls.bias_off];
    }
    __syncthreads();
  }
  block_gemm<BM>(segs, 1, W, s.acc, accw);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * W; e += NTHREADS) {
    const int r = e / W, cc = e % W;
    h2[r * lh + cc] = __float2bfloat16_rn(s.acc[r * accw + cc] + d.bias[Lf.bias_off + cc]);
  }
  __syncthreads();
  int nseg = 0;
  segs[nseg++] = Seg{h2, lh, W, Ld.wt, Ld.kin};
  if (nd.uses_cd) segs[nseg++] = Seg{s.cd, s.lcd, d.cdp, Ld.wt + W, Ld.kin};
  if (STASH) stash<BM>(Ld, row0, segs, nseg);
  block_gemm<BM>(segs, nseg, Wd, s.acc, accw);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * Wd; e += NTHREADS) {
    const int r = e / Wd, cc = e % Wd;
    h[r * lh + cc] = __float2bfloat16_rn(fmaxf(s.acc[r * accw + cc] + d.bias[Ld.bias_off + cc], 0.0f));
  }
  __syncthreads();
  segs[0] = Seg{h, lh, Wd, Lr.wt, Lr.kin};
  if (STASH) stash<BM>(Lr, row0, segs, 1);
  block_gemm<BM>(segs, 1, Lr.nout, s.acc, accw);
  __syncthreads();
  const int ostride = nd.out_ch + (nd.drop_sigma ? 0 : 1);
  for (int e = threadIdx.x; e < BM * nd.out_pad; e += NTHREADS) {
    const int r = e / nd.out_pad, j = e % nd.out_pad, p = row0 + r;
    float v = s.acc[r * accw + j] + d.bias[Lr.bias_off + j];
    if (nd.sigmoid) v = 1.0f / (1.0f + expf(-v));
    s.outs[r * d.outw + j] = v;
    if (WRITE_OUT && p < d.n && j < nd.out_ch) nd.out[(size_t)p * ostride + j] = v;
  }
  __syncthreads();
}

// -------------------------------------------------------------------- K1
__global__ void __launch_bounds__(NTHREADS) fmlp_fwd_kernel(const __grid_constant__ FusedDesc d) {
  const Smem s = carve(d, BM_F, false);
  const int row0 = blockIdx.x * BM_F;
  load_inputs<BM_F>(d, row0, s);
  __syncthreads();
  for (int n = 0; n < d.nnets; ++n) net_forward<BM_F, false, true>(d, d.nets[n], row0, s);
}

// -------------------------------------------------------------------- K2
// Turn the fp32 gradient in acc (columns col0.., n wide) into this layer's
// D: optional ReLU mask from a bf16 activation stack, per-CTA bias-grad
// accumulation (fp32), bf16 copy into ds and into the D stack.
template <int BM>
__device__ void emit_d(const FusedDesc& d, const LayerDesc& L, int row0, const Smem& s,
                       int col0, int n, const bf16* mask, int mask_ld, int mask_off,
                       bf16* ds) {
  // 8 columns (16 bytes of bf16, 32 of fp32) per thread and step: n, col0,
  // the strides and the mask offset are multiples of 8
  const int accw = s.lacc, n8 = n / 8;
  if (mask) {
    for (int e = threadIdx.x; e < BM * n8; e += NTHREADS) {
      const int r = e / n8, c = (e % n8) * 8;
      const uint4 mv =
          *reinterpret_cast<const uint4*>(mask + (size_t)(row0 + r) * mask_ld + mask_off + c);
      const bf16* m = reinterpret_cast<const bf16*>(&mv);
      float* a = s.acc + r * accw + col0 + c;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (!(__bfloat162float(m[q]) > 0.0f)) a[q] = 0.0f;
    }
    __syncthreads();
  }
  for (int cc = threadIdx.x; cc < n; cc += NTHREADS) {
    float sum = 0.0f;
    for (int r = 0; r < BM; ++r) sum += s.acc[r * accw + col0 + cc];
    s.bacc[L.bias_off + cc] += sum;
  }
  for (int e = threadIdx.x; e < BM * n8; e += NTHREADS) {
    const int r = e / n8, c = (e % n8) * 8;
    const float4* a = reinterpret_cast<const float4*>(s.acc + r * accw + col0 + c);
    const float4 lo = a[0], hi = a[1];
    uint4 pv;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&pv);
    v[0] = __floats2bfloat162_rn(lo.x, lo.y);
    v[1] = __floats2bfloat162_rn(lo.z, lo.w);
    v[2] = __floats2bfloat162_rn(hi.x, hi.y);
    v[3] = __floats2bfloat162_rn(hi.z, hi.w);
    *reinterpret_cast<uint4*>(ds + r * s.lds + c) = pv;
    *reinterpret_cast<uint4*>(L.d + (size_t)(row0 + r) * L.nout + c) = pv;
  }
  __syncthreads();
}

__device__ void net_backward(const FusedDesc& d, const NetDesc& nd, int row0, const Smem& s) {
  const int W = nd.W, Wd = W / 2, D = nd.D, accw = s.lacc, lds = s.lds;
  const LayerDesc& Ls = nd.layers[D];
  const LayerDesc& Lf = nd.layers[D + 1];
  const LayerDesc& Ld = nd.layers[D + 2];
  const LayerDesc& Lr = nd.layers[D + 3];
  const int gstride = nd.out_ch + (nd.drop_sigma ? 0 : 1);
  // rgb head: d_out = g (* s(1-s) with the recomputed sigmoid output)
  for (int e = threadIdx.x; e < BM_B * nd.out_pad; e += NTHREADS) {
    const int r = e / nd.out_pad, j = e % nd.out_pad, p = row0 + r;
    float v = 0.0f;
    if (p < d.n && j < nd.out_ch) {
      v = nd.g[(size_t)p * gstride + j];
      if (nd.sigmoid) {
        const float sg = s.outs[r * d.outw + j];
        v *= sg * (1.0f - sg);
      }
    }
    s.acc[r * accw + j] = v;
  }
  __syncthreads();
  emit_d<BM_B>(d, Lr, row0, s, 0, nd.out_pad, nullptr, 0, 0, s.ds);
  Seg sg = Seg{s.ds, lds, nd.out_pad, Lr.w, Lr.nout};
  block_gemm<BM_B>(&sg, 1, Wd, s.acc, accw);
  __syncthreads();
  emit_d<BM_B>(d, Ld, row0, s, 0, Wd, Lr.a, Lr.kin, 0, s.ds);
  // dir input = [h_final | cd code]
  sg = Seg{s.ds, lds, Wd, Ld.w, Ld.nout};
  block_gemm<BM_B>(&sg, 1, Ld.kin, s.acc, accw);
  __syncthreads();
  if (nd.uses_cd)
    for (int e = threadIdx.x; e < BM_B * d.cdp; e += NTHREADS) {
      const int r = e / d.cdp, k = e % d.cdp;
      s.dcd[e] += s.acc[r * accw + W + k];
    }
  emit_d<BM_B>(d, Lf, row0, s, 0, W, nullptr, 0, 0, s.ds);
  Seg segs[2];
  int nseg = 0;
  segs[nseg++] = Seg{s.ds, lds, W, Lf.w, Lf.nout};
  if (!nd.drop_sigma) {
    // sigma head: one live column, padded to 16
    for (int cc = threadIdx.x; cc < 16; cc += NTHREADS) {
      float sum = 0.0f;
      for (int r = 0; r < BM_B; ++r) {
        const int p = row0 + r;
        if (cc == 0 && p < d.n) sum += nd.g[(size_t)p * gstride + nd.out_ch];
      }
      s.bacc[Ls.bias_off + cc] += sum;
    }
    for (int e = threadIdx.x; e < BM_B * 16; e += NTHREADS) {
      const int r = e / 16, cc = e % 16, p = row0 + r;
      const float v = (cc == 0 && p < d.n) ? nd.g[(size_t)p * gstride + nd.out_ch] : 0.0f;
      const bf16 bv = __float2bfloat16_rn(v);
      s.ds2[r * s.lds2 + cc] = bv;
      Ls.d[(size_t)(row0 + r) * Ls.nout + cc] = bv;
    }
    __syncthreads();
    segs[nseg++] = Seg{s.ds2, s.lds2, 16, Ls.w, Ls.nout};
  }
  block_gemm<BM_B>(segs, nseg, W, s.acc, accw);
  __syncthreads();
  // trunk, last layer first; acc holds d(relu output) at column col0
  int col0 = 0;
  for (int l = D - 1; l >= 0; --l) {
    const LayerDesc& L = nd.layers[l];
    const bf16* mask;
    int mld, moff;
    if (l == D - 1) {
      mask = Lf.a; mld = Lf.kin; moff = 0;
    } else {
      const LayerDesc& Ln = nd.layers[l + 1];
      mask = Ln.a; mld = Ln.kin; moff = ((nd.skips >> (l + 1)) & 1) ? nd.tin : 0;
    }
    emit_d<BM_B>(d, L, row0, s, col0, W, mask, mld, moff, s.ds);
    const bool skip = (nd.skips >> l) & 1;
    if (l > 0 || d.need_dt) {
      sg = Seg{s.ds, lds, W, L.w, L.nout};
      block_gemm<BM_B>(&sg, 1, L.kin, s.acc, accw);
      __syncthreads();
      if (l == 0 || skip) {
        const int dtw = d.xp + d.ctp;
        for (int e = threadIdx.x; e < BM_B * nd.tin; e += NTHREADS) {
          const int r = e / nd.tin, k = e % nd.tin;
          s.dt[r * dtw + k] += s.acc[r * accw + k];
        }
        __syncthreads();
      }
      col0 = skip ? nd.tin : 0;
    }
  }
}

// per-ray sums of a per-point code gradient into its ray slots
__device__ void code_slots(const FusedDesc& d, int blk, const float* src, int ld, int off,
                           int width, float* part) {
  const int rows = d.s < BM_B ? d.s : BM_B;
  const int spb = BM_B / rows;
  const int row0 = blk * BM_B;
  for (int e = threadIdx.x; e < spb * width; e += NTHREADS) {
    const int lr = e / width, k = e % width;
    float sum = 0.0f;
    for (int q = 0; q < rows; ++q) {
      const int r = lr * rows + q;
      if (row0 + r < d.n) sum += src[r * ld + off + k];
    }
    part[(size_t)(blk * spb + lr) * width + k] = sum;
  }
}

__global__ void __launch_bounds__(NTHREADS) fmlp_bwd_kernel(const __grid_constant__ FusedDesc d) {
  const Smem s = carve(d, BM_B, true);
  const int fc2 = 2 * d.f * d.c;
  const int dtw = d.xp + d.ctp;
  for (int i = threadIdx.x; i < d.total_bias; i += NTHREADS) s.bacc[i] = 0.0f;
  for (int i = threadIdx.x; i < fc2; i += NTHREADS) s.wacc[i] = 0.0f;
  for (int blk = blockIdx.x; blk < d.nblocks; blk += gridDim.x) {
    const int row0 = blk * BM_B;
    load_inputs<BM_B>(d, row0, s);
    for (int i = threadIdx.x; i < BM_B * dtw; i += NTHREADS) s.dt[i] = 0.0f;
    for (int i = threadIdx.x; i < BM_B * d.cdp; i += NTHREADS) s.dcd[i] = 0.0f;
    __syncthreads();
    for (int n = 0; n < d.nnets; ++n) {
      net_forward<BM_B, true, false>(d, d.nets[n], row0, s);
      net_backward(d, d.nets[n], row0, s);
    }
    if (d.ct) code_slots(d, blk, s.dt, dtw, d.xp, d.ctp, d.part_ct);
    if (d.cd) code_slots(d, blk, s.dcd, d.cdp, 0, d.cdp, d.part_cd);
    if (d.f > 0) {
      const int C = d.c;
      if (d.need_dwin)
        for (int k = threadIdx.x; k < fc2; k += NTHREADS) {
          const int j = k / (2 * C), sl = (k / C) & 1, ch = k % C;
          float sum = 0.0f;
          for (int r = 0; r < BM_B; ++r) {
            const int p = row0 + r;
            if (p >= d.n) break;
            const float xf = ldexpf(d.x[(size_t)p * C + ch], j);
            sum += s.dt[r * dtw + C + k] * (sl == 0 ? sinf(xf) : cosf(xf));
          }
          s.wacc[k] += sum;
        }
      if (d.need_dx)
        for (int e = threadIdx.x; e < BM_B * C; e += NTHREADS) {
          const int r = e / C, ch = e % C, p = row0 + r;
          if (p >= d.n) continue;
          const float xv = d.x[(size_t)p * C + ch];
          float v = s.dt[r * dtw + ch];
          for (int j = 0; j < d.f; ++j) {
            const float fj = ldexpf(1.0f, j);
            const float xf = xv * fj;
            const int ks = j * 2 * C + ch, kc = ks + C;
            v += s.dt[r * dtw + C + ks] * d.win[ks] * cosf(xf) * fj;
            v -= s.dt[r * dtw + C + kc] * d.win[kc] * sinf(xf) * fj;
          }
          d.dx[(size_t)p * C + ch] = v;
        }
    } else if (d.need_dx) {
      for (int e = threadIdx.x; e < BM_B * d.in_x; e += NTHREADS) {
        const int r = e / d.in_x, k = e % d.in_x, p = row0 + r;
        if (p < d.n) d.dx[(size_t)p * d.in_x + k] = s.dt[r * dtw + k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < d.total_bias; i += NTHREADS)
    d.part_b[(size_t)blockIdx.x * d.total_bias + i] = s.bacc[i];
  for (int i = threadIdx.x; i < fc2; i += NTHREADS)
    d.part_win[(size_t)blockIdx.x * fc2 + i] = s.wacc[i];
}

// dW = A^T D over all points: split-K, one DW_T x DW_T output tile and one
// range of points per CTA, one fp32 partial per split. Chunks of DW_C points
// of A and D are copied to shared memory with cp.async, the next chunk in
// flight while the 4 warps (each a 32 x 32 quarter, 2 x 2 fragments) multiply
// the current one from shared memory.
struct GemmTask {
  int kin, nout, dw_off, tiles_n, tile_start;
  const bf16* a;
  const bf16* d;
};

struct DwDesc {
  int ntasks, total_tiles, npad, chunk, total_w;
  float* part_w;
  GemmTask t[MAXNETS * MAXLAYERS];
};

#define DW_T 64
#define DW_C 32
#define DW_LD (DW_T + PADH)

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem));
}

__global__ void __launch_bounds__(128) fmlp_dw_kernel(const __grid_constant__ DwDesc dd) {
  __shared__ __align__(128) bf16 sa[2][DW_C][DW_LD];
  __shared__ __align__(128) bf16 sd[2][DW_C][DW_LD];
  const int split = blockIdx.x / dd.total_tiles;
  const int tile = blockIdx.x % dd.total_tiles;
  int ti = 0;
  while (ti + 1 < dd.ntasks && dd.t[ti + 1].tile_start <= tile) ++ti;
  const GemmTask& t = dd.t[ti];
  const int local = tile - t.tile_start;
  const int m0 = (local / t.tiles_n) * DW_T, n0 = (local % t.tiles_n) * DW_T;
  // live rows / columns of this tile (multiples of 16)
  const int mw = min(DW_T, t.kin - m0), nw = min(DW_T, t.nout - n0);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int r0 = split * dd.chunk;
  const int nchunks = (min(dd.npad, r0 + dd.chunk) - r0) / DW_C;

  auto load = [&](int c, int buf) {
    const int p0 = r0 + c * DW_C;
    for (int i = threadIdx.x; i < DW_C * (DW_T / 8); i += 128) {
      const int r = i / (DW_T / 8), v = (i % (DW_T / 8)) * 8;
      if (v < mw) cp_async16(&sa[buf][r][v], t.a + (size_t)(p0 + r) * t.kin + m0 + v);
      if (v < nw) cp_async16(&sd[buf][r][v], t.d + (size_t)(p0 + r) * t.nout + n0 + v);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  if (nchunks > 0) load(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) {
      load(c + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DW_C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (wm + 16 * i < mw) wmma::load_matrix_sync(af[i], &sa[buf][k][wm + 16 * i], DW_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (wn + 16 * j < nw) wmma::load_matrix_sync(bfr[j], &sd[buf][k][wn + 16 * j], DW_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (wm + 16 * i < mw && wn + 16 * j < nw)
            wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = dd.part_w + (size_t)split * dd.total_w + t.dw_off;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (wm + 16 * i < mw && wn + 16 * j < nw)
        wmma::store_matrix_sync(out + (size_t)(m0 + wm + 16 * i) * t.nout + n0 + wn + 16 * j,
                                acc[i][j], t.nout, wmma::mem_row_major);
}

// out[m][e] = sum_{g<G} part[(m*G + g)][e], summed in a fixed order
__global__ void fmlp_reduce_kernel(const float* part, float* out, int M, int G, int E) {
  const size_t total = (size_t)M * E;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / E, e = i % E;
    float sum = 0.0f;
    for (int g = 0; g < G; ++g) sum += part[(m * G + g) * E + e];
    out[i] = sum;
  }
}

// ------------------------------------------------------------ host side
static int launch_reduce(const float* part, float* out, int M, int G, int E, cudaStream_t st) {
  const size_t total = (size_t)M * E;
  if (total == 0) return 0;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  fmlp_reduce_kernel<<<blocks, 256, 0, st>>>(part, out, M, G, E);
  return (int)cudaGetLastError();
}

// resident backward CTAs per SM at this launch's shared-memory size
extern "C" int moda_fmlp_bwd_blocks_per_sm(const FusedDesc* d) {
  int o[13];
  const int smem = smem_layout(*d, BM_B, true, o);
  int n = 0;
  if (cudaFuncSetAttribute(fmlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fmlp_bwd_kernel, NTHREADS, smem) !=
          cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

extern "C" int moda_fmlp_num_sms(void) {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

extern "C" const char* moda_fmlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int moda_fmlp_forward(const FusedDesc* d, void* stream) {
  int o[13];
  const int smem = smem_layout(*d, BM_F, false, o);
  cudaError_t e = cudaFuncSetAttribute(fmlp_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (d->n + BM_F - 1) / BM_F;
  fmlp_fwd_kernel<<<nblocks, NTHREADS, smem, (cudaStream_t)stream>>>(*d);
  return (int)cudaGetLastError();
}

// Backward: the block kernel, the dW GEMM, then the fixed-order reductions
// of dW, db, dwin and the per-ray code gradients into the given outputs.
extern "C" int moda_fmlp_backward(const FusedDesc* d, const DwDesc* dw, float* dw_out,
                                  float* db_out, float* dwin_out, float* dct_out,
                                  float* dcd_out, int rays, int bpr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int o[13];
  const int smem = smem_layout(*d, BM_B, true, o);
  cudaError_t e = cudaFuncSetAttribute(fmlp_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fmlp_bwd_kernel<<<d->grid, NTHREADS, smem, st>>>(*d);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int nsplit = (d->npad + dw->chunk - 1) / dw->chunk;
  fmlp_dw_kernel<<<nsplit * dw->total_tiles, 128, 0, st>>>(*dw);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = launch_reduce(d->part_w, dw_out, 1, nsplit, d->total_w, st))) return rc;
  if ((rc = launch_reduce(d->part_b, db_out, 1, d->grid, d->total_bias, st))) return rc;
  if (d->f > 0 && d->need_dwin &&
      (rc = launch_reduce(d->part_win, dwin_out, 1, d->grid, 2 * d->f * d->c, st)))
    return rc;
  if (d->ct && (rc = launch_reduce(d->part_ct, dct_out, rays, bpr, d->ctp, st))) return rc;
  if (d->cd && (rc = launch_reduce(d->part_cd, dcd_out, rays, bpr, d->cdp, st))) return rc;
  return 0;
}
