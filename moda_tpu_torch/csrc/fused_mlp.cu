// Fused NeRF-MLP stack for Hopper (sm_90a): forward (K1) and the
// rematerializing backward (K2), hand-written CUDA C++ with bf16 tensor-core
// products (WMMA m16n16k16, fp32 accumulation).
//
// Replaces moda_tpu/ops/fused_mlp.py::_fwd_kernel (K1) and ::_bwd_kernel
// (K2), launched there by _call_fwd / _fused_mlp_bwd through pl.pallas_call.
//
// Every block product (block_gemm) keeps its fp32 sums in registers: a warp
// owns 16-column tiles, stages one 16x16 fragment at a time in its own small
// fp32 tile (16 x 20 floats, 10 KB for 8 warps) and applies the product's
// epilogue (bias, ReLU, sigmoid, mask, bf16 rounding, column sums) on the
// way to the result's destination. No block-wide fp32 result tile exists.
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
//   outputs). Measured on an NVIDIA H100 80GB HBM3 at 700 W: 3.96-3.98 ms
//   at the trunk site (262,144 points), ~9% of that bound, with two CTAs of
//   8 warps per SM (128 registers, 103 KB of shared memory for the trunk
//   launch). Each warp loads its B fragments from L2 with
//   wmma::load_matrix_sync, four at a time (KU), nothing in flight across
//   layers. A ring in shared memory that copied the weights ahead of the
//   products across layers (cp.async or cp.async.bulk onto mbarriers) was
//   20-45% slower at every site: two CTAs per SM leave room for only two
//   16-row stages at the trunk, and the ring's bookkeeping cost more than
//   the latency it hid (PERF.md section 6).
// K2 (fmlp_bwd_kernel + fmlp_dw_kernel + fmlp_reduce_kernel): persistent
//   CTAs walk blocks of BM_B points. Each block recomputes the forward,
//   writes every layer's bf16 input activation (A) and bf16 pre-activation
//   gradient (D) to scratch, and propagates the VJP back to the embed (dx,
//   per-ray code grads, window grad). Each input-gradient product's epilogue
//   masks it into the layer before's D and writes that D into whichever of
//   h0/h1 the product does not read. The TPU kernel carried dW/db in one
//   buffer across its sequential grid; blocks here run concurrently, so:
//     - db and dwin: per-CTA partial sums in shared memory (a column's sum
//       over a block runs inside the warp that owns the column), written
//       once per CTA, then summed by a second kernel in a fixed order;
//     - dW = A^T D (the TPU kernel's mmT_nt products, moda_tpu/ops/
//       fused_mlp.py:245-290, accumulated over the grid at :458-478): a
//       second kernel, fmlp_dw_kernel, over the bf16 A and D stacks. Its
//       output tiles are up to 128 x 128 (a 256-wide layer is two), its
//       operands stream through a TMA ring of 128-point stages, and
//       ldmatrix.trans + mma.sync multiply them in 8 warps, a stage at a
//       time into fresh accumulators that are then added to the running
//       fp32 sums. A plan made in Python (ops/fused_mlp.py::dw_plan)
//       splits each tile's points into ranges of about equal cost; each
//       range leaves fp32 partials, and fmlp_reduce_dw_kernel sums a
//       tile's partials in a fixed order. Bound at the trunk site (262,144
//       points, 20 tasks): bytes, 3.63 GB of A and D at 3.35 TB/s =
//       ~1.08 ms (the products, 0.38 TFLOP, take 0.38 ms at peak).
//       Measured there on the same card: 2.71 ms (the split-K kernel it
//       replaced: 4.78);
//     - code grads: blocks are ray-aligned (BM_B | S or S | BM_B), so a
//       ray's sum lies inside one block or in consecutive per-block slots.
//   No atomics: results are deterministic run to run.
//   Bound: tensor-core operations (~3x the forward's) plus the A/D scratch
//   traffic (~2 x 14 KB per point for the trunk + feature launch).
//   Measured on the same card at the trunk site: 19.3 ms, of which the
//   block kernel 14.4 and the split-K dW GEMM that fmlp_dw_kernel
//   replaced 4.8. Of the block kernel's time, the
//   recomputed forward takes ~7 and the input-gradient products and their
//   epilogues ~7.4: inferred from K2 - K2s (K2s skips the recompute), not
//   read from a per-phase profile. The block kernel read 14.06-14.14 ms
//   at the trunk on that card later; with no weight traffic at all (B
//   fragments from a fixed shared tile, a measurement only) it read 9.42,
//   so the weight loads hold about a third of it and the epilogues, the
//   recompute, the per-product barriers and the embed the rest. A weight
//   ring in shared memory was 3.5-34% slower at every backward site (KC_B
//   32 rows a stage; 64 rows -1% at the trunk, +9% at vis; PERF.md
//   section 6). BM_B = 32 keeps it at 118
//   registers and 91 KB, two CTAs per SM; at 64 rows it needs 204 registers
//   (one CTA per SM) and narrow nets leave half the warps without a column
//   tile: it was slower at every backward site but the smallest (the
//   8,000-point feat grid).
// K1s/K2s (the activation-stash mode, MODA_PALLAS_STASH=1; the stash route
//   of the same two pallas_calls, moda_tpu/ops/fused_mlp.py:315-338,
//   :565-570, :597-650): K1s also writes every layer's bf16 input activation
//   to the A stacks that K2's dW GEMM reads, and K2s's block kernel then
//   skips the input load and the recomputed forward: the ReLU masks already
//   come from the A stacks, and a sigmoid head's output is rederived from
//   the stashed last hidden layer with one product. The stack is held from
//   the forward to the backward (~7.2 KB per point for the trunk + feature
//   launch) instead of being rewritten; K2s moves no more bytes than K2.

#include <cuda.h>  // CUtensorMap; its encoder is fetched from the driver at run time
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
// rows per block of K1 / K2, set by the build (ops/fused_mlp.py BM_F, BM_B)
#if !defined(BM_F) || !defined(BM_B)
#error "build with -DBM_F=<rows> -DBM_B=<rows>, as ops/fused_mlp.py::build_library does"
#endif

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
  int stashed;  // K1s: write the A stacks; K2s: read them, skip the recompute
  int hw, outw, dsw, total_bias, total_w;
  int npad, nblocks, grid;
  int rows_slot, spb;  // code-gradient slot geometry (ops/fused_mlp.py::bwd_geometry)
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
  NetDesc nets[MAXNETS];
};

__host__ __device__ inline int align128(int b) { return (b + 127) & ~127; }

// Row strides of the shared-memory tiles that feed tensor-core products are
// padded past a multiple of 128 bytes (8 bf16, 4 fp32), so the 8 rows of a
// fragment load or store fall in different banks.
#define PADH 8
#define PADF 4

// row stride of a warp's fp32 staging tile (16 rows of one 16-column tile)
#define LDT (16 + PADF)
#define NSMEM 12

struct Smem {
  bf16 *xe, *ct, *cd, *h0, *h1, *ds2;
  float *stage, *outs, *dt, *dcd, *bacc, *wacc;
  int lx, lct, lcd, lh, lds2;  // row strides (elements)
};

// Width of h0/h1. In the backward they also hold each layer's bf16 D in
// turn: a product's epilogue writes the next D into the buffer its A
// operand does not use.
__host__ __device__ inline int h_width(const FusedDesc& d, bool bwd) {
  return bwd && d.dsw > d.hw ? d.dsw : d.hw;
}

// byte offsets of the shared-memory buffers; returns the total size
__host__ __device__ inline int smem_layout(const FusedDesc& d, int BM, bool bwd, int* o) {
  int off = 0, i = 0;
  auto put = [&](int bytes) { o[i++] = off; off += align128(bytes); };
  put(BM * (d.xp + PADH) * 2);              // 0 xe
  put(BM * (d.ctp + PADH) * 2);             // 1 ct
  put(BM * (d.cdp + PADH) * 2);             // 2 cd
  put(BM * (h_width(d, bwd) + PADH) * 2);   // 3 h0
  put(BM * (h_width(d, bwd) + PADH) * 2);   // 4 h1
  put(NWARPS * 16 * LDT * 4);               // 5 stage: one fp32 tile per warp
  put(BM * d.outw * 4);                     // 6 outs
  if (bwd) {
    put(BM * (16 + PADH) * 2);              // 7 ds2
    put(BM * (d.xp + d.ctp) * 4);           // 8 dt
    put(BM * d.cdp * 4);                    // 9 dcd
    put(d.total_bias * 4);                  // 10 bacc
    put(2 * d.f * d.c * 4 + 4);             // 11 wacc
  }
  return off;
}

__device__ inline Smem carve(const FusedDesc& d, int BM, bool bwd) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int o[NSMEM];
  smem_layout(d, BM, bwd, o);
  Smem s;
  s.xe = (bf16*)(smem_raw + o[0]);
  s.ct = (bf16*)(smem_raw + o[1]);
  s.cd = (bf16*)(smem_raw + o[2]);
  s.h0 = (bf16*)(smem_raw + o[3]);
  s.h1 = (bf16*)(smem_raw + o[4]);
  s.stage = (float*)(smem_raw + o[5]);
  s.outs = (float*)(smem_raw + o[6]);
  s.lx = d.xp + PADH;
  s.lct = d.ctp + PADH;
  s.lcd = d.cdp + PADH;
  s.lh = h_width(d, bwd) + PADH;
  s.lds2 = 16 + PADH;
  s.ds2 = nullptr;
  s.dt = s.dcd = s.bacc = s.wacc = nullptr;
  if (bwd) {
    s.ds2 = (bf16*)(smem_raw + o[7]);
    s.dt = (float*)(smem_raw + o[8]);
    s.dcd = (float*)(smem_raw + o[9]);
    s.bacc = (float*)(smem_raw + o[10]);
    s.wacc = (float*)(smem_raw + o[11]);
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

// C[BM][n] = sum over segments of A_seg B_seg, never stored whole. A warp
// owns 16-column tiles of C. When a tile's K loop ends, the warp stores its
// RT fragments one at a time, rows ascending, into its own fp32 staging tile
// t [16][LDT] and calls epi.rows(t, r0, c0, csum) with the whole warp, then
// epi.cols(c0, csum). One warp owns a column, so a column sum needs no
// atomics: lane j < 16 carries column c0 + j's running sum in csum, in a
// fixed order (rows ascending).
template <int BM, typename Epi>
__device__ void block_gemm(const Seg* segs, int nseg, int n, float* stage, const Epi& epi) {
  constexpr int RT = BM / 16;
  const int warp = threadIdx.x / 32;
  float* t = stage + warp * 16 * LDT;
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
    float csum = 0.0f;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(t, acc[r], LDT, wmma::mem_row_major);
      __syncwarp();
      epi.rows(t, r * 16, tn * 16, csum);
      __syncwarp();
    }
    epi.cols(tn * 16, csum);
  }
}

// ------------------------------------------------------------- epilogues
// A lane's share of a staged tile: row lane / 2, the 8 columns from
// 8 * (lane % 2) (16 bytes of bf16, 32 of fp32).
__device__ inline int lane_row() { return (threadIdx.x % 32) >> 1; }
__device__ inline int lane_col() { return (threadIdx.x & 1) * 8; }

__device__ inline void load8(const float* p, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ inline uint4 pack8(const float* v) {
  uint4 pv;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pv);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  return pv;
}

// bias, optional ReLU, bf16 into h [BM][ld]: a hidden, final or dir layer
struct EpiAct {
  const float* b;
  bf16* h;
  int ld;
  bool relu;
  __device__ void rows(float* t, int r0, int c0, float&) const {
    const int i = lane_row(), j = lane_col();
    float v[8];
    load8(t + i * LDT + j, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[q] += b[c0 + j + q];
      if (relu) v[q] = fmaxf(v[q], 0.0f);
    }
    *reinterpret_cast<uint4*>(h + (r0 + i) * ld + c0 + j) = pack8(v);
  }
  __device__ void cols(int, float) const {}
};

// the sigma head (one live column): bias, then the output's last column
struct EpiSigma {
  float b;
  float* out;
  int stride, row0, n;
  __device__ void rows(float* t, int r0, int c0, float&) const {
    const int lane = threadIdx.x % 32, p = row0 + r0 + lane;
    if (c0 == 0 && lane < 16 && p < n) out[(size_t)p * stride] = t[lane * LDT] + b;
  }
  __device__ void cols(int, float) const {}
};

// the rgb head: bias, optional sigmoid, into outs [BM][ldo] and, when out,
// into the output's first out_ch columns
struct EpiRgb {
  const float* b;
  int sigmoid;
  float* outs;
  int ldo;
  float* out;
  int stride, out_ch, row0, n;
  __device__ void rows(float* t, int r0, int c0, float&) const {
    const int i = lane_row(), j = lane_col(), p = row0 + r0 + i;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + j + q;
      float v = t[i * LDT + j + q] + b[c];
      if (sigmoid) v = 1.0f / (1.0f + expf(-v));
      outs[(r0 + i) * ldo + c] = v;
      if (out && p < n && c < out_ch) out[(size_t)p * stride + c] = v;
    }
  }
  __device__ void cols(int, float) const {}
};

// A backward product, the gradient of a layer's input. Columns [col0,
// col0 + nd) are the D of the layer before (L): ReLU mask from the mask
// stack at the same column (the layer's own A) when mask, the fp32 column
// sum into bacc, bf16 into ds [BM][lds] and into L's D stack. Columns below
// col0 add into the trunk-input gradient dt [BM][dtw]; columns from col0 + nd
// on into the dir-code gradient dcd [BM][cdw].
struct EpiGrad {
  const LayerDesc* L;
  const bf16* mask;
  int mask_ld;
  bf16* ds;
  int lds;
  float* bacc;
  float* dt;
  int dtw;
  float* dcd;
  int cdw, col0, nd, row0;
  __device__ void rows(float* t, int r0, int c0, float& csum) const {
    const int lane = threadIdx.x % 32;
    if (c0 < col0 || c0 >= col0 + nd) {
      float* dst = c0 < col0 ? dt + c0 : dcd + (c0 - col0 - nd);
      const int ld = c0 < col0 ? dtw : cdw;
      for (int e = lane; e < 256; e += 32) {
        const int i = e >> 4, jj = e & 15;
        dst[(r0 + i) * ld + jj] += t[i * LDT + jj];
      }
      return;
    }
    const int i = lane_row(), j = lane_col(), c = c0 - col0 + j;
    const size_t p = (size_t)(row0 + r0 + i);
    float v[8];
    load8(t + i * LDT + j, v);
    if (mask) {
      const uint4 mv = *reinterpret_cast<const uint4*>(mask + p * mask_ld + c0 + j);
      const bf16* m = reinterpret_cast<const bf16*>(&mv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (!(__bfloat162float(m[q]) > 0.0f)) v[q] = 0.0f;
        t[i * LDT + j + q] = v[q];
      }
    }
    const uint4 pv = pack8(v);
    *reinterpret_cast<uint4*>(ds + (r0 + i) * lds + c) = pv;
    *reinterpret_cast<uint4*>(L->d + p * L->nout + c) = pv;
    __syncwarp();
    if (lane < 16)
      for (int ii = 0; ii < 16; ++ii) csum += t[ii * LDT + lane];
  }
  __device__ void cols(int c0, float csum) const {
    const int lane = threadIdx.x % 32;
    if (c0 >= col0 && c0 < col0 + nd && lane < 16) bacc[L->bias_off + c0 - col0 + lane] += csum;
  }
};

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
  const int W = nd.W, Wd = W / 2, D = nd.D, lh = s.lh;
  bf16* h = s.h0;
  bf16* h2 = s.h1;
  Seg segs[3];
  for (int i = 0; i < D; ++i) {
    const LayerDesc& L = nd.layers[i];
    int nseg = 0;
    if (i == 0 || ((nd.skips >> i) & 1)) nseg = trunk_segs(d, nd, s, L, segs);
    if (i > 0) segs[nseg++] = Seg{h, lh, W, L.wt + (L.kin - W), L.kin};
    if (STASH) stash<BM>(L, row0, segs, nseg);
    block_gemm<BM>(segs, nseg, W, s.stage, EpiAct{d.bias + L.bias_off, h2, lh, true});
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
    const Seg ss = Seg{h, lh, W, Ls.wt, Ls.kin};
    block_gemm<BM>(&ss, 1, Ls.nout, s.stage,
                   EpiSigma{d.bias[Ls.bias_off], nd.out + nd.out_ch, nd.out_ch + 1, row0, d.n});
  }
  block_gemm<BM>(segs, 1, W, s.stage, EpiAct{d.bias + Lf.bias_off, h2, lh, false});
  __syncthreads();
  int nseg = 0;
  segs[nseg++] = Seg{h2, lh, W, Ld.wt, Ld.kin};
  if (nd.uses_cd) segs[nseg++] = Seg{s.cd, s.lcd, d.cdp, Ld.wt + W, Ld.kin};
  if (STASH) stash<BM>(Ld, row0, segs, nseg);
  block_gemm<BM>(segs, nseg, Wd, s.stage, EpiAct{d.bias + Ld.bias_off, h, lh, true});
  __syncthreads();
  segs[0] = Seg{h, lh, Wd, Lr.wt, Lr.kin};
  if (STASH) stash<BM>(Lr, row0, segs, 1);
  block_gemm<BM>(segs, 1, Lr.nout, s.stage,
                 EpiRgb{d.bias + Lr.bias_off, nd.sigmoid, s.outs, d.outw,
                        WRITE_OUT ? nd.out : nullptr, nd.out_ch + (nd.drop_sigma ? 0 : 1),
                        nd.out_ch, row0, d.n});
  __syncthreads();
}

// -------------------------------------------------------------------- K1
__global__ void __launch_bounds__(NTHREADS) fmlp_fwd_kernel(const __grid_constant__ FusedDesc d) {
  const Smem s = carve(d, BM_F, false);
  const int row0 = blockIdx.x * BM_F;
  load_inputs<BM_F>(d, row0, s);
  __syncthreads();
  for (int n = 0; n < d.nnets; ++n) {
    if (d.stashed)
      net_forward<BM_F, true, true>(d, d.nets[n], row0, s);  // K1s
    else
      net_forward<BM_F, false, true>(d, d.nets[n], row0, s);
  }
}

// -------------------------------------------------------------------- K2
// the rgb head's pre-activation gradient: g (* s(1-s) with the recomputed
// sigmoid output)
__device__ inline float rgb_grad(const FusedDesc& d, const NetDesc& nd, const Smem& s, int row0,
                                 int r, int j) {
  const int p = row0 + r;
  if (p >= d.n || j >= nd.out_ch) return 0.0f;
  float v = nd.g[(size_t)p * (nd.out_ch + (nd.drop_sigma ? 0 : 1)) + j];
  if (nd.sigmoid) {
    const float sg = s.outs[r * d.outw + j];
    v *= sg * (1.0f - sg);
  }
  return v;
}

// The VJP of one net for the block, products from the last layer back.
// Each product's epilogue (EpiGrad) writes the D of the layer before into
// the one of h0/h1 that its A operand does not use.
__device__ void net_backward(const FusedDesc& d, const NetDesc& nd, int row0, const Smem& s) {
  const int W = nd.W, Wd = W / 2, D = nd.D, lh = s.lh, dtw = d.xp + d.ctp;
  const LayerDesc& Ls = nd.layers[D];
  const LayerDesc& Lf = nd.layers[D + 1];
  const LayerDesc& Ld = nd.layers[D + 2];
  const LayerDesc& Lr = nd.layers[D + 3];
  const int gstride = nd.out_ch + (nd.drop_sigma ? 0 : 1);
  bf16* da = s.h0;  // the current layer's D, the next product's A operand
  bf16* db = s.h1;  // the layer before's D, written by that product
  auto grad_epi = [&](const LayerDesc& L, const bf16* mask, int mask_ld, int col0, int n,
                      float* dt, float* dcd) {
    return EpiGrad{&L, mask, mask_ld, db, lh, s.bacc, dt, dtw, dcd, d.cdp, col0, n, row0};
  };
  // rgb head D, straight from the cotangent
  for (int cc = threadIdx.x; cc < nd.out_pad; cc += NTHREADS) {
    float sum = 0.0f;
    for (int r = 0; r < BM_B; ++r) sum += rgb_grad(d, nd, s, row0, r, cc);
    s.bacc[Lr.bias_off + cc] += sum;
  }
  for (int e = threadIdx.x; e < BM_B * nd.out_pad; e += NTHREADS) {
    const int r = e / nd.out_pad, j = e % nd.out_pad;
    const bf16 bv = __float2bfloat16_rn(rgb_grad(d, nd, s, row0, r, j));
    da[r * lh + j] = bv;
    Lr.d[(size_t)(row0 + r) * Lr.nout + j] = bv;
  }
  __syncthreads();
  Seg sg = Seg{da, lh, nd.out_pad, Lr.w, Lr.nout};
  block_gemm<BM_B>(&sg, 1, Wd, s.stage, grad_epi(Ld, Lr.a, Lr.kin, 0, Wd, nullptr, nullptr));
  __syncthreads();
  bf16* t = da; da = db; db = t;
  // dir input = [h_final | cd code]: the final layer's D, then the cd gradient
  sg = Seg{da, lh, Wd, Ld.w, Ld.nout};
  block_gemm<BM_B>(&sg, 1, Ld.kin, s.stage, grad_epi(Lf, nullptr, 0, 0, W, nullptr, s.dcd));
  __syncthreads();
  t = da; da = db; db = t;
  Seg segs[2];
  int nseg = 0;
  segs[nseg++] = Seg{da, lh, W, Lf.w, Lf.nout};
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
  // the gradient of the trunk output: the last hidden layer's D
  block_gemm<BM_B>(segs, nseg, W, s.stage,
                   grad_epi(nd.layers[D - 1], Lf.a, Lf.kin, 0, W, nullptr, nullptr));
  __syncthreads();
  t = da; da = db; db = t;
  // trunk, last layer first: layer l's input gradient gives layer l-1's D
  // (masked by layer l's own input) and, at layer 0 and the skip layers, the
  // trunk-input gradient in the columns below tin
  for (int l = D - 1; l >= 0; --l) {
    const LayerDesc& L = nd.layers[l];
    const bool to_dt = l == 0 || ((nd.skips >> l) & 1);
    if (l == 0 && !d.need_dt) break;
    sg = Seg{da, lh, W, L.w, L.nout};
    block_gemm<BM_B>(&sg, 1, L.kin, s.stage,
                     grad_epi(nd.layers[l > 0 ? l - 1 : 0], L.a, L.kin, to_dt ? nd.tin : 0,
                              l > 0 ? W : 0, to_dt ? s.dt : nullptr, nullptr));
    __syncthreads();
    t = da; da = db; db = t;
  }
}

// K2s: a sigmoid head's output from the stashed last hidden layer, with the
// same product and epilogue as net_forward, so it is bit-identical to the
// recomputed one. Other heads need nothing from the forward.
__device__ void rgb_from_stash(const FusedDesc& d, const NetDesc& nd, int row0, const Smem& s) {
  const LayerDesc& Lr = nd.layers[nd.D + 3];
  const int k8 = Lr.kin / 8;
  for (int i = threadIdx.x; i < BM_B * k8; i += NTHREADS) {
    const int r = i / k8, k = (i % k8) * 8;
    *reinterpret_cast<uint4*>(s.h0 + r * s.lh + k) =
        *reinterpret_cast<const uint4*>(Lr.a + (size_t)(row0 + r) * Lr.kin + k);
  }
  __syncthreads();
  const Seg sg = Seg{s.h0, s.lh, Lr.kin, Lr.wt, Lr.kin};
  block_gemm<BM_B>(&sg, 1, Lr.nout, s.stage,
                   EpiRgb{d.bias + Lr.bias_off, 1, s.outs, d.outw, nullptr, 0, 0, row0, d.n});
  __syncthreads();
}

// per-ray sums of a per-point code gradient into its ray slots
__device__ void code_slots(const FusedDesc& d, int blk, const float* src, int ld, int off,
                           int width, float* part) {
  const int rows = d.rows_slot, spb = d.spb;
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
    if (!d.stashed) load_inputs<BM_B>(d, row0, s);
    for (int i = threadIdx.x; i < BM_B * dtw; i += NTHREADS) s.dt[i] = 0.0f;
    for (int i = threadIdx.x; i < BM_B * d.cdp; i += NTHREADS) s.dcd[i] = 0.0f;
    __syncthreads();
    for (int n = 0; n < d.nnets; ++n) {
      if (!d.stashed)
        net_forward<BM_B, true, false>(d, d.nets[n], row0, s);
      else if (d.nets[n].sigmoid)
        rgb_from_stash(d, d.nets[n], row0, s);  // K2s
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

// ----------------------------------------------------------------- dW GEMM
// fmlp_dw_kernel: dW_l = A_l^T D_l for every task of a launch (one task per
// layer with a D stack), bf16 operands, fp32 sums, fp32 partials. Replaces
// the weight gradients of moda_tpu/ops/fused_mlp.py::_bwd_kernel (mmT_nt,
// :245-290), which the TPU kernel accumulated over its sequential grid
// (:458-478). Bound on the H100: bytes. Each point's A row (kin bf16) and D
// row (nout bf16) must be read once: 13.9 KB a point at the trunk + feature
// launch, 3.63 GB at 262,144 points = ~1.08 ms at 3.35 TB/s, against
// 0.38 ms for its 0.38 TFLOP of products. What the design does about it:
//   - Output tiles as wide as the layer, up to DW_TM x DW_TN = 128 x 128:
//     an A row reaches an SM once per 128 output columns and a D row once
//     per 128 input rows (the split-K kernel this replaced used 64 x 64).
//   - A ring of 3-4 stages of DW_KC = 128 points (as many as fit in the
//     block's shared memory: 3 at 128 x 128, ~192 KB) filled by TMA: thread
//     0 copies a stage as 128-point x 64-column boxes of the A and D stacks
//     (cp.async.bulk.tensor.2d through a tensor map per stack, completing
//     on the stage's mbarrier), refilling a stage as soon as the block has
//     passed the barrier that ends its use. A box lands with the
//     128-byte swizzle, so the 8 rows an ldmatrix reads fall in distinct
//     banks without padding; rows past npad (a ragged tail, or the rows a
//     K1s stack holds beyond it) and columns past the stack's width are
//     filled with zeros by the copy and never read from memory. A bulk copy
//     per tile row, a 16-byte cp.async ring issued by the warps, and
//     64-point boxes were each measured slower (PERF.md §6): the copies'
//     issue and the per-stage barriers, not the bytes, held them back.
//   - ldmatrix.trans loads the fragments (both stacks are point-major and
//     the points are the reduction dimension) and mma.sync m16n8k16
//     multiplies them; each of the 8 warps owns a 64 x 32 block of the tile.
//     A tile with fewer blocks than warps (a 64 x 64 tile has two) gives
//     each block ks warps (a power of two), which take its 16-point steps
//     in turn and write ks partials (k-slices). A stage's products sum in
//     fresh accumulators, which are then added to the running fp32 sums:
//     a tensor-core accumulator chain over tens of thousands of points
//     drifts (relative error 1.5e-4 at 36,864 points an item, measured), a
//     128-point one does not.
//   - Balanced work: ops/fused_mlp.py::dw_plan cuts each tile's points into
//     ranges of about equal cost (operand bytes plus products) so the grid
//     holds about DW_WAVES items per resident CTA, ordered so that items
//     reading the same points of a task run side by side (L2 reuse). One
//     CTA per item; each item writes its fp32 partials, and
//     fmlp_reduce_dw_kernel sums a tile's partials in order. No atomics:
//     the result is the same bits run to run, and K2s (whose A stacks K1s
//     wrote) gets K2's.
// The plan (a device int32 table) holds per tile (task, m0, n0, mw, nw,
// nsplit, part_off, ks) and per item (tile, split, p0, p1); p0 is a
// multiple of DW_KC and p1 of BM_B. Partial s * ks + z of a tile is split
// s's k-slice z.
struct GemmTask {
  int kin, nout, dw_off;
  const bf16* a;  // [>= npad][kin]: the A stack (K1s's may hold more rows)
  const bf16* d;  // [npad][nout]
};

struct DwDesc {
  int ntasks, ntiles, nitems, npad;
  int ba, bd;       // 64-column boxes a stage holds of A and of D (the launch's widest tiles)
  int nstages;      // ring stages (ops/fused_mlp.py::dw_stages)
  const int* plan;  // ntiles x 8 ints, then nitems x 4 ints (ops/fused_mlp.py::dw_plan)
  float* part_w;    // the partials, tile by tile: [nsplit * ks][mw][nw] each
  GemmTask t[MAXNETS * MAXLAYERS];
};

// the TMA descriptors of each task's A and D stack, built by the launcher
struct DwMaps {
  CUtensorMap a[MAXNETS * MAXLAYERS];
  CUtensorMap d[MAXNETS * MAXLAYERS];
};

#define DW_TM 128
#define DW_TN 128
#define DW_KC 128
#define DW_BOX 64  // columns of a TMA box: 128 bytes, the swizzle's span
#define DW_BOX_BYTES (DW_KC * DW_BOX * 2)
#define DW_WARPS 8
#define DW_THREADS (DW_WARPS * 32)

__host__ __device__ inline int dw_smem_bytes(const DwDesc& d) {
  // 1024 bytes to align the ring (the swizzle's requirement), the ring,
  // then an mbarrier a stage
  return 1024 + d.nstages * (d.ba + d.bd) * DW_BOX_BYTES + 8 * d.nstages;
}

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a lost arrival) traps after ~4 s at 2 GHz, so it fails the launch
// instead of holding the card.
__device__ inline void mbar_wait(uint64_t* b, unsigned parity) {
  const unsigned a = smem_u32(b);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// box (x: first column, y: first row) of the tensor map into shared memory
__device__ inline void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// four 8 x 8 bf16 matrices, transposed, from the rows each lane points at
__device__ inline void ldmatrix_x4_trans(unsigned* r, const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the 16 bytes at (row, column col .. col + 7) of a stage's operand whose
// boxes start at `base`: box col / 64, its 16-byte chunk XOR (row % 8)
__device__ inline const unsigned char* swz(const unsigned char* base, int row, int col) {
  return base + (col >> 6) * DW_BOX_BYTES + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

__device__ inline void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(DW_THREADS, 1)
    fmlp_dw_kernel(const __grid_constant__ DwDesc dd, const __grid_constant__ DwMaps maps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int ns = dd.nstages, stage = (dd.ba + dd.bd) * DW_BOX_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ns * stage);
  const int* item = dd.plan + 8 * dd.ntiles + 4 * blockIdx.x;
  const int* tile = dd.plan + 8 * item[0];
  const int task = tile[0], m0 = tile[1], n0 = tile[2], mw = tile[3], nw = tile[4];
  const int ks = tile[7];  // a power of two
  const int p0 = item[2], npts = item[3] - item[2];
  const int nchunks = (npts + DW_KC - 1) / DW_KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // chunk c into stage c % ns, by thread 0 (the stage's previous chunk is
  // done: every warp has passed the barrier after it)
  const int nba = (mw + DW_BOX - 1) / DW_BOX, nbd = (nw + DW_BOX - 1) / DW_BOX;
  auto issue = [&](int c) {
    const int s = c % ns;
    unsigned char* st = ring + s * stage;
    mbar_arrive_expect_tx(&full[s], (unsigned)((nba + nbd) * DW_BOX_BYTES));
    for (int b = 0; b < nba; ++b)
      tma_load(st + b * DW_BOX_BYTES, &maps.a[task], m0 + DW_BOX * b, p0 + c * DW_KC, &full[s]);
    for (int b = 0; b < nbd; ++b)
      tma_load(st + (dd.ba + b) * DW_BOX_BYTES, &maps.d[task], n0 + DW_BOX * b, p0 + c * DW_KC,
               &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(ns, nchunks); ++c) issue(c);
  }
  __syncthreads();

  // the tile's 64 x 32 blocks (4 x 4 m16n8 fragments each; fragments past
  // mw / nw do nothing): warp w takes block w % nblk and k-slice w / nblk,
  // the 16-point steps s with s % ks == w / nblk; warps past nblk * ks idle
  const int bn = (nw + 31) / 32, nblk = ((mw + 63) / 64) * bn;
  const int blk = warp % nblk, slice = warp / nblk;
  const int wm = (blk / bn) * 64, wn = (blk % bn) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  // this lane's ldmatrix row: matrix lane / 8, row lane % 8 of it
  const int lr = lane & 7, hi = lane >> 4, mid = (lane >> 3) & 1;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % ns;
    mbar_wait(&full[s], (c / ns) & 1);
    if (slice < ks) {
      const int rows = min(DW_KC, npts - c * DW_KC);
      const unsigned char* sa = ring + s * stage;
      const unsigned char* sd = sa + dd.ba * DW_BOX_BYTES;
      float part[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.0f;
      // one 16-point step at row k of the stage
      auto step = [&](int k) {
        unsigned af[4][4], bfr[4][2];
        // A^T fragment (m16 x k16) from A [k][m]: matrices (k, m),
        // (k, m+8), (k+8, m), (k+8, m+8)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (wm + 16 * i < mw)
            ldmatrix_x4_trans(af[i], swz(sa, k + lr + 8 * hi, wm + 16 * i + 8 * mid));
        // D fragments (k16 x n8) from D [k][n], two n8 at a time: matrices
        // (k, n), (k+8, n), (k, n+8), (k+8, n+8)
#pragma unroll
        for (int j = 0; j < 4; j += 2)
          if (wn + 8 * j < nw) {
            unsigned r4[4];
            ldmatrix_x4_trans(r4, swz(sd, k + lr + 8 * mid, wn + 8 * j + 8 * hi));
            bfr[j][0] = r4[0];
            bfr[j][1] = r4[1];
            bfr[j + 1][0] = r4[2];
            bfr[j + 1][1] = r4[3];
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (wm + 16 * i < mw && wn + 8 * j < nw) mma_bf16(part[i][j], af[i], bfr[j]);
      };
      if (ks == 1 && rows == DW_KC) {
#pragma unroll
        for (int k = 0; k < DW_KC; k += 16) step(k);
      } else {
        for (int k = 16 * ((slice - c * (DW_KC / 16)) & (ks - 1)); k < rows; k += 16 * ks)
          step(k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    }
    __syncthreads();
    if (threadIdx.x == 0 && c + ns < nchunks) issue(c + ns);
  }
  if (slice >= ks) return;
  // the item's partial: [mw][nw] fp32 at the tile's offset, split item[1],
  // k-slice `slice`
  float* out = dd.part_w + tile[6] + (size_t)(item[1] * ks + slice) * mw * nw;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (wm + 16 * i < mw && wn + 8 * j < nw) {
        float* o = out + (size_t)(wm + 16 * i + g) * nw + wn + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(o + 8 * nw) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
}

// a tile of dW = the sum of its partials, in split order (grid.y: tiles)
__global__ void fmlp_reduce_dw_kernel(const __grid_constant__ DwDesc dd, float* out) {
  const int* tile = dd.plan + 8 * blockIdx.y;
  const GemmTask& t = dd.t[tile[0]];
  const int mw = tile[3], nw = tile[4], nsplit = tile[5] * tile[7], elems = mw * nw;
  const float* part = dd.part_w + tile[6];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < elems; e += gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int sp = 0; sp < nsplit; ++sp) sum += part[(size_t)sp * elems + e];
    out[t.dw_off + (size_t)(tile[1] + e / nw) * t.nout + tile[2] + e % nw] = sum;
  }
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

// shared-memory bytes of K1's (bwd = 0) or K2's block kernel at this launch
extern "C" int moda_fmlp_smem_bytes(const FusedDesc* d, int bwd) {
  int o[NSMEM];
  return smem_layout(*d, bwd ? BM_B : BM_F, bwd != 0, o);
}

template <typename K>
static int blocks_per_sm(K kernel, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NTHREADS, smem) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

// resident CTAs per SM of K1's and K2's block kernel at this launch's
// shared-memory size
extern "C" int moda_fmlp_fwd_blocks_per_sm(const FusedDesc* d) {
  return blocks_per_sm(fmlp_fwd_kernel, moda_fmlp_smem_bytes(d, 0));
}

extern "C" int moda_fmlp_bwd_blocks_per_sm(const FusedDesc* d) {
  return blocks_per_sm(fmlp_bwd_kernel, moda_fmlp_smem_bytes(d, 1));
}

// shared-memory bytes and resident CTAs per SM of the dW GEMM at this launch
extern "C" int moda_fmlp_dw_smem_bytes(const DwDesc* dw) { return dw_smem_bytes(*dw); }

// Lets the dW GEMM take all of a block's shared memory, once per process
// (every launch's ring fits under that, so no launch sets it again).
static int dw_smem_attribute() {
  static const cudaError_t e = [] {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return cudaFuncSetAttribute(fmlp_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin);
  }();
  return (int)e;
}

extern "C" int moda_fmlp_dw_blocks_per_sm(const DwDesc* dw) {
  int n = 0;
  if (dw_smem_attribute() ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fmlp_dw_kernel, DW_THREADS,
                                                    dw_smem_bytes(*dw)) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

// registers a thread of K1's (0), K2's block kernel (1) or the dW GEMM (2)
extern "C" int moda_fmlp_registers(int which) {
  cudaFuncAttributes a;
  const void* k = which == 0   ? (const void*)fmlp_fwd_kernel
                  : which == 1 ? (const void*)fmlp_bwd_kernel
                               : (const void*)fmlp_dw_kernel;
  return cudaFuncGetAttributes(&a, k) == cudaSuccess ? a.numRegs : -1;
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
  const int smem = moda_fmlp_smem_bytes(d, 0);
  cudaError_t e = cudaFuncSetAttribute(fmlp_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (d->n + BM_F - 1) / BM_F;
  fmlp_fwd_kernel<<<nblocks, NTHREADS, smem, (cudaStream_t)stream>>>(*d);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a bf16 [rows][cols] stack as DW_KC-row x DW_BOX-column boxes with the
// 128-byte swizzle; reads past rows or cols fill with zeros
static int encode_stack(CUtensorMap* map, const bf16* p, int rows, int cols) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return (int)cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {DW_BOX, DW_KC}, estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p, dims, strides, box,
                            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The dW GEMM and the reduction of its partials into dw_out (each task's
// [kin][nout] at its dw_off). K2's backward launches it through here too.
static int launch_dw(const DwDesc* dw, float* dw_out, cudaStream_t st) {
  if (dw->nitems == 0) return 0;
  DwMaps maps;  // copied into the launch's parameters
  for (int j = 0; j < dw->ntasks; ++j) {
    int rc = encode_stack(&maps.a[j], dw->t[j].a, dw->npad, dw->t[j].kin);
    if (!rc) rc = encode_stack(&maps.d[j], dw->t[j].d, dw->npad, dw->t[j].nout);
    if (rc) return rc;
  }
  int rc = dw_smem_attribute();
  if (rc) return rc;
  fmlp_dw_kernel<<<dw->nitems, DW_THREADS, dw_smem_bytes(*dw), st>>>(*dw, maps);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  fmlp_reduce_dw_kernel<<<dim3((DW_TM * DW_TN + 255) / 256, dw->ntiles), 256, 0, st>>>(*dw,
                                                                                     dw_out);
  return (int)cudaGetLastError();
}

extern "C" int moda_fmlp_dw(const DwDesc* dw, float* dw_out, void* stream) {
  return launch_dw(dw, dw_out, (cudaStream_t)stream);
}

// Backward: the block kernel, the dW GEMM, then the fixed-order reductions
// of db, dwin and the per-ray code gradients into the given outputs.
extern "C" int moda_fmlp_backward(const FusedDesc* d, const DwDesc* dw, float* dw_out,
                                  float* db_out, float* dwin_out, float* dct_out,
                                  float* dcd_out, int rays, int bpr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = moda_fmlp_smem_bytes(d, 1);
  cudaError_t e = cudaFuncSetAttribute(fmlp_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fmlp_bwd_kernel<<<d->grid, NTHREADS, smem, st>>>(*d);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if ((rc = launch_dw(dw, dw_out, st))) return rc;
  if ((rc = launch_reduce(d->part_b, db_out, 1, d->grid, d->total_bias, st))) return rc;
  if (d->f > 0 && d->need_dwin &&
      (rc = launch_reduce(d->part_win, dwin_out, 1, d->grid, 2 * d->f * d->c, st)))
    return rc;
  if (d->ct && (rc = launch_reduce(d->part_ct, dct_out, rays, bpr, d->ctp, st))) return rc;
  if (d->cd && (rc = launch_reduce(d->part_cd, dcd_out, rays, bpr, d->cdp, st))) return rc;
  return 0;
}
