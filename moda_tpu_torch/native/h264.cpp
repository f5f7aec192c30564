// h264.cpp: the bitstream half of the port's H.264 (ISO/IEC 14496-10)
// decoder, host C++ loaded through ctypes (native/__init__.py). It reads
// progressive 8-bit 4:2:0 streams with CAVLC and I and P slices (the tool
// set of the Baseline and Constrained Baseline profiles) as the standard
// decodes them, which is what FFmpeg's h264 decoder gives cv2.VideoCapture:
//
// - NAL units by length prefix (an MP4's avcC, 'avc1'/'avc3'), emulation
//   prevention removed; SPS, PPS and slice headers;
// - picture order count types 0, 1 and 2, frame_num;
// - the decoded picture buffer: the sliding window, memory management
//   operations 1-4 and 6 and long-term references; P lists initialised
//   (short-term by descending PicNum, then long-term) and modified;
// - the CAVLC macroblock layer of I_NxN, the 24 I_16x16 types, I_PCM,
//   P_L0_16x16/16x8/8x16, P_8x8 and P_8x8ref0 with every sub-type, P_Skip;
//   motion vector prediction (the median, the 16x8/8x16 directional rules,
//   C replaced by D, P_Skip's zero rule), Intra4x4PredMode prediction, nC,
//   mb_qp_delta; neighbours in another slice are unavailable;
// - each macroblock's boundary strengths (bS) for the loop filter.
//
// The pixel work is the CUDA kernels' of csrc/h264.cu (or their plain
// versions): one record a macroblock (type, QP, intra modes and neighbour
// availability, bS, the slice's filter offsets, per-4x4 vectors and
// reference pictures as decoded-picture-buffer slots) and the levels of each
// macroblock with a residual.
//
// Every tool outside that set is refused with a message naming it, before
// the first macroblock of the picture; the caller adds the sample's index.
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------------ tables
// CAVLC's code tables as FFmpeg's h264_cavlc.c holds them (checked byte for
// byte against the copy in cv2's libavcodec): coeff_token by nC class
// (0-1, 2-3, 4-7, 8+) at 4 x TotalCoeff + TrailingOnes, chroma DC's the
// same way, total_zeros by TotalCoeff - 1, run_before by min(zerosLeft, 7)
// - 1. Lengths, then the codes.
static const uint8_t CT_LEN[4][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};
static const uint8_t CT_BITS[4][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2},
    {3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63}};
static const uint8_t CDC_LEN[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
static const uint8_t CDC_BITS[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
static const uint8_t TZ_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 0},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6, 0, 0},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5, 0, 0, 0},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6, 0, 0, 0, 0, 0},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6, 0, 0, 0, 0, 0, 0},
    {6, 4, 5, 3, 2, 2, 3, 3, 6, 0, 0, 0, 0, 0, 0, 0},
    {6, 6, 4, 2, 2, 3, 2, 5, 0, 0, 0, 0, 0, 0, 0, 0},
    {5, 5, 3, 2, 2, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 3, 3, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {4, 4, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
static const uint8_t TZ_BITS[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0, 0, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0, 0, 0, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 0, 1, 3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 2, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
static const uint8_t CTZ_LEN[3][4] = {
    {1, 2, 3, 3},
    {1, 2, 2, 0},
    {1, 1, 0, 0}};
static const uint8_t CTZ_BITS[3][4] = {
    {1, 1, 1, 0},
    {1, 1, 0, 0},
    {1, 0, 0, 0}};
static const uint8_t RUN_LEN[7][16] = {
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 3, 3, 3, 3, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 0}};
static const uint8_t RUN_BITS[7][16] = {
    {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 2, 3, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {3, 0, 1, 3, 2, 5, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0}};
// coded_block_pattern's me(v) mapping (Table 9-4)
const uint8_t kIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
                               16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
                               8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
                               14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
                               17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};
// zig-zag scan index -> raster position (4 x row + column) in a 4x4 block
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// luma4x4BlkIdx -> (x, y) in 4x4 units, and back
const uint8_t kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const uint8_t kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const uint8_t kBlkAt[4][4] = {{0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};  // [y][x]

// macroblock kinds in a record, and the record's fields (preproc/h264.py)
enum { K_I4 = 0, K_I16 = 1, K_PCM = 2, K_P = 3, K_SKIP = 4 };
enum {
  F_KIND = 0, F_QP = 1, F_CQP0 = 2, F_CQP1 = 3, F_M16 = 4, F_MC = 5, F_AVAIL = 6, F_ROW = 7,
  F_MODES = 8, F_BS = 10, F_ALPHA = 18, F_BETA = 19, F_MV = 20, F_REF = 36, FIELDS = 40
};
// a macroblock's levels: 16 luma blocks (raster), the Intra16x16 DC (raster
// over the blocks), chroma DC (Cb, Cr), chroma AC (Cb, Cr; 4 blocks each);
// an I_PCM macroblock's samples (256 luma, 64 Cb, 64 Cr) in the same row
const int L_DC = 256, L_CDC = 272, L_CAC = 280, LEVELS = 408;
const int MAX_SLOTS = 17;

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// A VLC as a lookup of its longest code: entry = symbol << 5 | length.
struct Vlc {
  int maxlen = 0;
  std::vector<int32_t> tab;
  void build(const uint8_t* len, const uint8_t* bits, int n) {
    maxlen = 0;
    for (int i = 0; i < n; ++i) maxlen = std::max(maxlen, (int)len[i]);
    tab.assign((size_t)1 << maxlen, -1);
    for (int i = 0; i < n; ++i) {
      if (!len[i]) continue;
      int shift = maxlen - len[i];
      for (int k = 0; k < (1 << shift); ++k) tab[((size_t)bits[i] << shift) + k] = i << 5 | len[i];
    }
  }
};

Vlc g_ct[4], g_cdc, g_tz[15], g_ctz[3], g_run[7];
std::once_flag g_once;

void build_vlcs() {
  for (int c = 0; c < 4; ++c) g_ct[c].build(CT_LEN[c], CT_BITS[c], 68);
  g_cdc.build(CDC_LEN, CDC_BITS, 20);
  for (int t = 0; t < 15; ++t) g_tz[t].build(TZ_LEN[t], TZ_BITS[t], 16 - t);
  for (int t = 0; t < 3; ++t) g_ctz[t].build(CTZ_LEN[t], CTZ_BITS[t], 4 - t);
  for (int t = 0; t < 7; ++t) g_run[t].build(RUN_LEN[t], RUN_BITS[t], t < 6 ? t + 2 : 15);
}

// ---------------------------------------------------------------- bits
// An RBSP (emulation prevention removed) with 8 zero bytes of padding.
struct Reader {
  std::vector<uint8_t> buf;
  int64_t nbits = 0, pos = 0, stop = 0;  // stop: the rbsp_stop_one_bit

  void load(const uint8_t* p, int64_t n) {
    buf.clear();
    buf.reserve(n + 8);
    int zeros = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (zeros >= 2 && p[i] == 3) {
        zeros = 0;
        continue;
      }
      zeros = p[i] ? 0 : zeros + 1;
      buf.push_back(p[i]);
    }
    nbits = 8 * (int64_t)buf.size();
    stop = 0;
    for (int64_t i = (int64_t)buf.size() - 1; i >= 0; --i)
      if (buf[i]) {
        stop = 8 * i + 7 - __builtin_ctz(buf[i]);
        break;
      }
    buf.insert(buf.end(), 8, 0);
    pos = 0;
  }
  uint64_t peek() const {
    int64_t b = pos >> 3;
    uint64_t v = 0;
    for (int k = 0; k < 8; ++k) v = v << 8 | buf[b + k];
    return v << (pos & 7);
  }
  void check() const {
    if (pos > nbits) fail("a NAL unit cut short");
  }
  uint32_t u(int n) {
    if (!n) return 0;
    uint32_t v = (uint32_t)(peek() >> (64 - n));
    pos += n;
    check();
    return v;
  }
  uint32_t ue() {
    uint64_t p = peek();
    int lz = p ? __builtin_clzll(p) : 64;
    if (lz > 31) fail("an Exp-Golomb code longer than 32 bits");
    pos += lz;
    return (uint32_t)(u(lz + 1) - 1);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  int vlc(const Vlc& v) {
    int e = v.tab[(size_t)(peek() >> (64 - v.maxlen))];
    if (e < 0) fail("a CAVLC code not in its table");
    pos += e & 31;
    check();
    return e >> 5;
  }
  bool more() const { return pos < stop; }
};

// ------------------------------------------------------------ parameters
struct Sps {
  bool valid = false;
  int log2_max_fn = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_always_zero = false;
  int off_nonref = 0, off_t2b = 0;
  std::vector<int> cycle;
  int max_refs = 0, mb_w = 0, mb_h = 0;
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;
  int matrix = 0;  // 0: BT.601 coefficients, 1: BT.709
};

struct Pps {
  bool valid = false;
  int sps_id = 0, num_ref_default = 1, init_qp = 26;
  int cqp[2] = {0, 0};
  bool deblock_ctrl = false, constrained = false;
};

Sps parse_sps(Reader& r, int* id) {
  Sps s;
  int profile = r.u(8);
  r.u(16);  // constraint flags, level_idc
  *id = r.ue();
  if (*id > 31) fail("seq_parameter_set_id %d", *id);
  if (profile == 100 || profile == 110 || profile == 122 || profile == 244 || profile == 44 ||
      profile == 83 || profile == 86 || profile == 118 || profile == 128 || profile == 138 ||
      profile == 139 || profile == 134 || profile == 135) {
    int cf = r.ue();
    if (cf == 3 && r.u(1)) fail("separate_colour_plane_flag 1 (4:4:4 coded as three planes)");
    if (cf != 1) fail("chroma_format_idc %d (only 4:2:0 is decoded)", cf);
    int bl = r.ue(), bc = r.ue();
    if (bl || bc) fail("bit depth %d/%d (only 8 bits are decoded)", bl + 8, bc + 8);
    if (r.u(1)) fail("qpprime_y_zero_transform_bypass_flag 1 (lossless coding)");
    if (r.u(1)) fail("seq_scaling_matrix_present_flag 1 (scaling matrices)");
  }
  s.log2_max_fn = r.ue() + 4;
  if (s.log2_max_fn > 16) fail("log2_max_frame_num %d", s.log2_max_fn);
  s.poc_type = r.ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = r.ue() + 4;
    if (s.log2_max_poc_lsb > 16) fail("log2_max_pic_order_cnt_lsb %d", s.log2_max_poc_lsb);
  } else if (s.poc_type == 1) {
    s.delta_always_zero = r.u(1);
    s.off_nonref = r.se();
    s.off_t2b = r.se();
    uint32_t n = r.ue();
    if (n > 255) fail("num_ref_frames_in_pic_order_cnt_cycle %u", n);
    for (uint32_t i = 0; i < n; ++i) s.cycle.push_back(r.se());
  } else if (s.poc_type != 2) {
    fail("pic_order_cnt_type %d", s.poc_type);
  }
  s.max_refs = r.ue();
  if (s.max_refs > 16) fail("max_num_ref_frames %d", s.max_refs);
  if (r.u(1)) fail("gaps_in_frame_num_value_allowed_flag 1 (gaps in frame_num)");
  s.mb_w = r.ue() + 1;
  s.mb_h = r.ue() + 1;
  if (s.mb_w > 1024 || s.mb_h > 1024) fail("a picture of %d x %d macroblocks", s.mb_w, s.mb_h);
  if (!r.u(1)) fail("frame_mbs_only_flag 0 (interlace: field or MBAFF coding)");
  r.u(1);  // direct_8x8_inference_flag
  if (r.u(1)) {
    s.crop_l = 2 * r.ue();
    s.crop_r = 2 * r.ue();
    s.crop_t = 2 * r.ue();
    s.crop_b = 2 * r.ue();
    if (s.crop_l + s.crop_r >= 16 * s.mb_w || s.crop_t + s.crop_b >= 16 * s.mb_h)
      fail("a frame crop larger than the picture");
    // FFmpeg keeps the frame's data pointers aligned: it crops fewer columns
    // on the left, and cv2 then rescales the wider picture
    if (s.crop_l % 64)
      fail("frame_crop_left_offset of %d pixels, not a multiple of 64 (cv2 rescales such a "
           "picture)", s.crop_l);
  }
  if (r.u(1)) {  // VUI: as far as the colour description
    if (r.u(1)) {
      if (r.u(8) == 255) r.u(32);  // aspect_ratio_idc Extended_SAR
    }
    if (r.u(1)) r.u(1);  // overscan
    if (r.u(1)) {        // video_signal_type_present_flag
      r.u(3);
      if (r.u(1))
        fail("video_full_range_flag 1 (full-range YUV, which cv2 converts as yuvj420p)");
      if (r.u(1)) {
        r.u(16);  // colour_primaries, transfer_characteristics
        int m = r.u(8);
        if (m == 1)
          s.matrix = 1;
        else if (m != 2 && m != 5 && m != 6)
          fail("matrix_coefficients %d (only BT.601 and BT.709 are converted)", m);
      }
    }
  }
  s.valid = true;
  return s;
}

Pps parse_pps(Reader& r, const Sps* sps, int* id) {
  Pps p;
  *id = r.ue();
  if (*id > 255) fail("pic_parameter_set_id %d", *id);
  p.sps_id = r.ue();
  if (p.sps_id > 31 || !sps[p.sps_id].valid) fail("a PPS of an SPS not seen");
  if (r.u(1)) fail("entropy_coding_mode_flag 1 (CABAC)");
  r.u(1);  // bottom_field_pic_order_in_frame_present_flag: frames only
  if (r.ue()) fail("num_slice_groups_minus1 > 0 (FMO, slice groups)");
  p.num_ref_default = r.ue() + 1;
  r.ue();
  if (p.num_ref_default > 32) fail("num_ref_idx_l0_default_active %d", p.num_ref_default);
  if (r.u(1)) fail("weighted_pred_flag 1 (weighted prediction)");
  r.u(2);  // weighted_bipred_idc: B slices only
  p.init_qp = 26 + r.se();
  r.se();  // pic_init_qs: SP/SI slices only
  p.cqp[0] = p.cqp[1] = r.se();
  if (p.cqp[0] < -12 || p.cqp[0] > 12) fail("chroma_qp_index_offset %d", p.cqp[0]);
  p.deblock_ctrl = r.u(1);
  p.constrained = r.u(1);
  if (r.u(1)) fail("redundant_pic_cnt_present_flag 1 (redundant pictures)");
  if (r.more()) {
    if (r.u(1)) fail("transform_8x8_mode_flag 1 (High profile's 8x8 transform)");
    if (r.u(1)) fail("pic_scaling_matrix_present_flag 1 (scaling matrices)");
    p.cqp[1] = r.se();
    if (p.cqp[1] < -12 || p.cqp[1] > 12) fail("second_chroma_qp_index_offset %d", p.cqp[1]);
  }
  p.valid = true;
  return p;
}

// ------------------------------------------------------------- decoder
struct Slot {
  int state = 0;  // 0 unused for reference, 1 short-term, 2 long-term
  int frame_num = 0, lt_idx = 0;
};

struct SliceHdr {
  int first_mb = 0, type = 0;  // 0 P, 2 I
  int pps_id = 0, frame_num = 0, idr_pic_id = 0, poc_lsb = 0, dpoc0 = 0;
  bool idr = false;
  int ref_idc = 0;
  int num_ref = 0;
  std::vector<std::pair<int, int>> mods;
  bool long_term_idr = false, adaptive = false;
  std::vector<std::vector<int>> mmco;
  int qp = 26, deblock_idc = 0, alpha = 0, beta = 0;
};

struct Mb {
  int slice = -1, kind = 0, qp = 0, row = -1;
  int m16 = 0, mc = 0, avail = 0;
  uint8_t tc[16], tcc[2][4];
  int8_t modes[16];
  int16_t mv[16][2];
  int8_t refidx[16], slot[16];
};

struct Output {
  int32_t* mbs;
  int64_t mb_cap;
  int16_t* levels;
  int64_t cap;
  int64_t rows = 0;
};

struct Decoder {
  Sps sps[32];
  Pps pps[256];
  int len_size = 4;
  // fixed by the first picture: the geometry, the buffer's slots, the matrix
  bool active = false;
  Sps act;
  int nslots = 0;
  Slot dpb[MAX_SLOTS];
  int max_lt = -1;  // MaxLongTermFrameIdx; -1: no long-term frame indices
  bool seen_picture = false;
  int prev_ref_fn = 0, prev_fn = 0, poc_msb_prev = 0, poc_lsb_prev = 0, fn_offset = 0;
  int last_poc = 0;
  // the picture being decoded
  std::vector<Mb> mbs;
  std::vector<SliceHdr> slices;
  int cur_slot = -1, poc = 0;
  // the current slice
  const Pps* cp = nullptr;
  int list[33];  // slots of ref_idx 0.., -1 where no picture
  int num_ref = 0;
};

int nmb(const Decoder& d) { return d.act.mb_w * d.act.mb_h; }

int pic_num(const Decoder& d, const Slot& s, int cur_fn) {
  return s.frame_num > cur_fn ? s.frame_num - (1 << d.act.log2_max_fn) : s.frame_num;
}

SliceHdr parse_slice_header(Decoder& d, Reader& r, int nal_type, int ref_idc) {
  SliceHdr h;
  h.idr = nal_type == 5;
  h.ref_idc = ref_idc;
  h.first_mb = r.ue();
  uint32_t st = r.ue();
  if (st > 9) fail("slice_type %u", st);
  st %= 5;
  if (st == 1) fail("a B slice (B-frames)");
  if (st == 3 || st == 4) fail("an %s slice", st == 3 ? "SP" : "SI");
  h.type = st;
  if (h.idr && st != 2) fail("an IDR picture with a P slice");
  h.pps_id = r.ue();
  if (h.pps_id > 255 || !d.pps[h.pps_id].valid) fail("a slice of a PPS not seen");
  const Pps& p = d.pps[h.pps_id];
  const Sps& s = d.sps[p.sps_id];
  if (!s.valid) fail("a slice of an SPS not seen");
  h.frame_num = r.u(s.log2_max_fn);
  if (h.idr) h.idr_pic_id = r.ue();
  if (s.poc_type == 0) {
    h.poc_lsb = r.u(s.log2_max_poc_lsb);
  } else if (s.poc_type == 1 && !s.delta_always_zero) {
    h.dpoc0 = r.se();
  }
  if (h.type == 0) {
    h.num_ref = p.num_ref_default;
    if (r.u(1)) h.num_ref = r.ue() + 1;
    if (h.num_ref > 16) fail("num_ref_idx_l0_active %d in a frame", h.num_ref);
    if (r.u(1)) {
      for (int k = 0;; ++k) {
        int idc = r.ue();
        if (idc == 3) break;
        if (idc > 2) fail("modification_of_pic_nums_idc %d", idc);
        if (k >= h.num_ref) fail("more reference list modifications than references");
        h.mods.push_back({idc, (int)r.ue()});
      }
    }
  }
  if (ref_idc) {
    if (h.idr) {
      r.u(1);  // no_output_of_prior_pics_flag
      h.long_term_idr = r.u(1);
    } else if ((h.adaptive = r.u(1))) {
      for (int k = 0;; ++k) {
        int op = r.ue();
        if (op == 0) break;
        if (op == 5) fail("memory_management_control_operation 5 (all references dropped)");
        if (op > 6) fail("memory_management_control_operation %d", op);
        if (k >= 66) fail("too many memory management operations");
        std::vector<int> v{op};
        if (op == 1 || op == 3) v.push_back(r.ue());
        if (op == 2) v.push_back(r.ue());
        if (op == 3 || op == 6 || op == 4) v.push_back(r.ue());
        h.mmco.push_back(v);
      }
    }
  }
  h.qp = p.init_qp + r.se();
  if (h.qp < 0 || h.qp > 51) fail("slice QP %d", h.qp);
  if (p.deblock_ctrl) {
    h.deblock_idc = r.ue();
    if (h.deblock_idc > 2) fail("disable_deblocking_filter_idc %d", h.deblock_idc);
    if (h.deblock_idc != 1) {
      h.alpha = 2 * r.se();
      h.beta = 2 * r.se();
      if (h.alpha < -12 || h.alpha > 12 || h.beta < -12 || h.beta > 12)
        fail("slice filter offsets %d, %d", h.alpha, h.beta);
    }
  }
  return h;
}

// 8.2.1: the picture's order count
int compute_poc(Decoder& d, const SliceHdr& h) {
  const Sps& s = d.act;
  int max_fn = 1 << s.log2_max_fn;
  if (s.poc_type == 0) {
    int max_lsb = 1 << s.log2_max_poc_lsb;
    int prev_msb = h.idr ? 0 : d.poc_msb_prev, prev_lsb = h.idr ? 0 : d.poc_lsb_prev;
    int msb = prev_msb;
    if (h.poc_lsb < prev_lsb && prev_lsb - h.poc_lsb >= max_lsb / 2)
      msb = prev_msb + max_lsb;
    else if (h.poc_lsb > prev_lsb && h.poc_lsb - prev_lsb > max_lsb / 2)
      msb = prev_msb - max_lsb;
    if (h.ref_idc) {
      d.poc_msb_prev = msb;
      d.poc_lsb_prev = h.poc_lsb;
    }
    return msb + h.poc_lsb;
  }
  int offset = h.idr ? 0 : d.prev_fn > h.frame_num ? d.fn_offset + max_fn : d.fn_offset;
  d.fn_offset = offset;
  if (s.poc_type == 2) {
    if (h.idr) return 0;
    return 2 * (offset + h.frame_num) - (h.ref_idc ? 0 : 1);
  }
  int n = (int)s.cycle.size();
  int abs_fn = n ? offset + h.frame_num : 0;
  if (!h.ref_idc && abs_fn > 0) abs_fn--;
  int expected = 0;
  if (abs_fn > 0) {
    int per_cycle = 0;
    for (int v : s.cycle) per_cycle += v;
    int cnt = (abs_fn - 1) / n, in = (abs_fn - 1) % n;
    expected = cnt * per_cycle;
    for (int i = 0; i <= in; ++i) expected += s.cycle[i];
  }
  if (!h.ref_idc) expected += s.off_nonref;
  int top = expected + h.dpoc0;
  int bottom = top + s.off_t2b;
  return std::min(top, bottom);
}

// 8.2.4: the slice's list 0 (slots), initialised and modified
void build_list(Decoder& d, const SliceHdr& h) {
  int cur_fn = h.frame_num;
  std::vector<int> shorts, longs;
  for (int i = 0; i < d.nslots; ++i) {
    if (d.dpb[i].state == 1) shorts.push_back(i);
    if (d.dpb[i].state == 2) longs.push_back(i);
  }
  std::sort(shorts.begin(), shorts.end(), [&](int a, int b) {
    return pic_num(d, d.dpb[a], cur_fn) > pic_num(d, d.dpb[b], cur_fn);
  });
  std::sort(longs.begin(), longs.end(),
            [&](int a, int b) { return d.dpb[a].lt_idx < d.dpb[b].lt_idx; });
  int n = h.num_ref;
  std::vector<int> l(n + 1, -1);
  int k = 0;
  for (int s : shorts)
    if (k < n) l[k++] = s;
  for (int s : longs)
    if (k < n) l[k++] = s;
  int max_pn = 1 << d.act.log2_max_fn, pred = cur_fn, idx = 0;
  for (auto& m : h.mods) {
    int pic = -1;
    if (m.first < 2) {
      int abs_diff = m.second + 1;
      if (abs_diff > max_pn) fail("abs_diff_pic_num_minus1 %d", m.second);
      int nowrap = m.first == 0 ? pred - abs_diff : pred + abs_diff;
      if (nowrap < 0) nowrap += max_pn;
      if (nowrap >= max_pn) nowrap -= max_pn;
      pred = nowrap;
      int pn = nowrap > cur_fn ? nowrap - max_pn : nowrap;
      for (int s : shorts)
        if (pic_num(d, d.dpb[s], cur_fn) == pn) pic = s;
    } else {
      for (int s : longs)
        if (d.dpb[s].lt_idx == m.second) pic = s;
    }
    if (pic < 0) fail("a reference list modification names no reference picture");
    for (int c = n; c > idx; --c) l[c] = l[c - 1];
    l[idx++] = pic;
    int w = idx;
    for (int c = idx; c <= n; ++c)
      if (l[c] != pic) l[w++] = l[c];
  }
  for (int i = 0; i < 33; ++i) d.list[i] = i < n ? l[i] : -1;
  d.num_ref = n;
}

// 8.2.5: reference marking after the picture
void mark(Decoder& d, const SliceHdr& h) {
  if (!h.ref_idc) return;
  Slot& cur = d.dpb[d.cur_slot];
  cur.frame_num = h.frame_num;
  if (h.idr) {
    for (int i = 0; i < d.nslots; ++i) d.dpb[i].state = 0;
    if (h.long_term_idr) {
      cur.state = 2;
      cur.lt_idx = 0;
      d.max_lt = 0;
    } else {
      cur.state = 1;
      d.max_lt = -1;
    }
    return;
  }
  int cur_fn = h.frame_num;
  bool cur_long = false;
  if (!h.adaptive) {
    int ns = 0, nl = 0, oldest = -1;
    for (int i = 0; i < d.nslots; ++i) {
      if (i == d.cur_slot) continue;
      if (d.dpb[i].state == 1) {
        ns++;
        if (oldest < 0 || pic_num(d, d.dpb[i], cur_fn) < pic_num(d, d.dpb[oldest], cur_fn))
          oldest = i;
      }
      nl += d.dpb[i].state == 2;
    }
    if (ns + nl >= std::max(d.act.max_refs, 1) && ns) d.dpb[oldest].state = 0;
  } else {
    for (auto& op : h.mmco) {
      auto find_short = [&](int diff) {
        int pn = cur_fn - (diff + 1);
        for (int i = 0; i < d.nslots; ++i)
          if (i != d.cur_slot && d.dpb[i].state == 1 && pic_num(d, d.dpb[i], cur_fn) == pn)
            return i;
        fail("memory_management_control_operation %d names no short-term picture", op[0]);
      };
      auto drop_long = [&](int idx, int keep) {
        for (int i = 0; i < d.nslots; ++i)
          if (i != keep && d.dpb[i].state == 2 && d.dpb[i].lt_idx == idx) d.dpb[i].state = 0;
      };
      if (op[0] == 1) {
        d.dpb[find_short(op[1])].state = 0;
      } else if (op[0] == 2) {
        bool found = false;
        for (int i = 0; i < d.nslots; ++i)
          if (i != d.cur_slot && d.dpb[i].state == 2 && d.dpb[i].lt_idx == op[1]) {
            d.dpb[i].state = 0;
            found = true;
          }
        if (!found) fail("memory_management_control_operation 2 names no long-term picture");
      } else if (op[0] == 3) {
        if (op[2] > d.max_lt) fail("a long_term_frame_idx above MaxLongTermFrameIdx");
        int s = find_short(op[1]);
        drop_long(op[2], s);
        d.dpb[s].state = 2;
        d.dpb[s].lt_idx = op[2];
      } else if (op[0] == 4) {
        d.max_lt = op[1] - 1;
        for (int i = 0; i < d.nslots; ++i)
          if (d.dpb[i].state == 2 && d.dpb[i].lt_idx > d.max_lt) d.dpb[i].state = 0;
      } else if (op[0] == 6) {
        if (op[1] > d.max_lt) fail("a long_term_frame_idx above MaxLongTermFrameIdx");
        drop_long(op[1], d.cur_slot);
        cur.state = 2;
        cur.lt_idx = op[1];
        cur_long = true;
      }
    }
  }
  if (!cur_long) cur.state = 1;
  int n = 0;
  for (int i = 0; i < d.nslots; ++i) n += d.dpb[i].state != 0;
  if (n > std::max(d.act.max_refs, 1)) fail("more reference frames than max_num_ref_frames");
}

// ------------------------------------------------------- macroblock layer
struct MbCtx {
  Decoder& d;
  Reader& r;
  Output* out;
  int slice, mb, mbx, mby;
  bool constrained;
};

bool is_intra(int kind) { return kind <= K_PCM; }

// the neighbour macroblock (dx, dy) if it is in the picture and the slice
int nb_mb(const MbCtx& c, int dx, int dy) {
  int x = c.mbx + dx, y = c.mby + dy;
  if (x < 0 || y < 0 || x >= c.d.act.mb_w) return -1;
  int n = y * c.d.act.mb_w + x;
  return c.d.mbs[n].slice == c.slice ? n : -1;
}

// ... and available to intra prediction (constrained_intra_pred_flag)
int nb_intra(const MbCtx& c, int dx, int dy) {
  int n = nb_mb(c, dx, dy);
  if (n >= 0 && c.constrained && !is_intra(c.d.mbs[n].kind)) return -1;
  return n;
}

// nC of a luma block (8.4.4.1 ... 9.2.1)
int nc_luma(const MbCtx& c, int blk) {
  int x = kBlkX[blk], y = kBlkY[blk];
  const Mb& cur = c.d.mbs[c.mb];
  int na = -1, nb = -1;
  if (x > 0) {
    na = cur.tc[kBlkAt[y][x - 1]];
  } else {
    int n = nb_mb(c, -1, 0);
    if (n >= 0) na = c.d.mbs[n].tc[kBlkAt[y][3]];
  }
  if (y > 0) {
    nb = cur.tc[kBlkAt[y - 1][x]];
  } else {
    int n = nb_mb(c, 0, -1);
    if (n >= 0) nb = c.d.mbs[n].tc[kBlkAt[3][x]];
  }
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : nb >= 0 ? nb : 0;
}

int nc_chroma(const MbCtx& c, int pl, int blk) {
  int x = blk & 1, y = blk >> 1;
  const Mb& cur = c.d.mbs[c.mb];
  int na = -1, nb = -1;
  if (x) {
    na = cur.tcc[pl][blk - 1];
  } else {
    int n = nb_mb(c, -1, 0);
    if (n >= 0) na = c.d.mbs[n].tcc[pl][2 * y + 1];
  }
  if (y) {
    nb = cur.tcc[pl][blk - 2];
  } else {
    int n = nb_mb(c, 0, -1);
    if (n >= 0) nb = c.d.mbs[n].tcc[pl][2 + x];
  }
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : nb >= 0 ? nb : 0;
}

// residual_block_cavlc: coefficients into co[start..start + maxn - 1]
int read_block(Reader& r, int nc, int* co, int maxn) {
  int tok;
  if (nc == -1) {
    tok = r.vlc(g_cdc);
  } else {
    tok = r.vlc(g_ct[nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3]);
  }
  int tc = tok >> 2, t1 = tok & 3;
  for (int i = 0; i < maxn; ++i) co[i] = 0;
  if (!tc) return 0;
  if (tc > maxn) fail("TotalCoeff %d in a block of %d", tc, maxn);
  int level[16], run[16];
  int sl = tc > 10 && t1 < 3 ? 1 : 0;
  for (int i = 0; i < tc; ++i) {
    if (i < t1) {
      level[i] = r.u(1) ? -1 : 1;
      continue;
    }
    uint64_t p = r.peek();
    int prefix = p ? __builtin_clzll(p) : 64;
    if (prefix > 31) fail("a level_prefix of %d", prefix);
    r.pos += prefix + 1;
    r.check();
    int code = std::min(15, prefix) << sl;
    int size = (prefix == 14 && sl == 0) ? 4 : prefix >= 15 ? prefix - 3 : sl;
    if (size) code += (int)r.u(size);
    if (prefix >= 15 && sl == 0) code += 15;
    if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) code += 2;
    level[i] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
    if (sl == 0) sl = 1;
    if (abs(level[i]) > (3 << (sl - 1)) && sl < 6) sl++;
  }
  int zl = 0;
  if (tc < maxn) {
    zl = maxn == 4 ? r.vlc(g_ctz[tc - 1]) : r.vlc(g_tz[tc - 1]);
    if (zl > maxn - tc) fail("total_zeros %d with TotalCoeff %d in a block of %d", zl, tc, maxn);
  }
  for (int i = 0; i < tc - 1; ++i) {
    if (zl > 0) {
      run[i] = r.vlc(g_run[std::min(zl, 7) - 1]);
      if (run[i] > zl) fail("run_before %d with %d zeros left", run[i], zl);
      zl -= run[i];
    } else {
      run[i] = 0;
    }
  }
  run[tc - 1] = zl;
  int k = -1;
  for (int i = tc - 1; i >= 0; --i) {
    k += run[i] + 1;
    co[k] = level[i];
  }
  return tc;
}

void residual(MbCtx& c, bool i16, int cbp_l, int cbp_c, int16_t* row) {
  Mb& m = c.d.mbs[c.mb];
  int co[16];
  if (i16) {
    read_block(c.r, nc_luma(c, 0), co, 16);
    for (int k = 0; k < 16; ++k) row[L_DC + kZigzag[k]] = (int16_t)co[k];
  }
  for (int blk = 0; blk < 16; ++blk) {
    if (!(cbp_l >> (blk >> 2) & 1)) continue;
    int16_t* b = row + 16 * blk;
    if (i16) {
      m.tc[blk] = read_block(c.r, nc_luma(c, blk), co, 15);
      for (int k = 0; k < 15; ++k) b[kZigzag[k + 1]] = (int16_t)co[k];
    } else {
      m.tc[blk] = read_block(c.r, nc_luma(c, blk), co, 16);
      for (int k = 0; k < 16; ++k) b[kZigzag[k]] = (int16_t)co[k];
    }
  }
  if (cbp_c) {
    for (int pl = 0; pl < 2; ++pl) {
      read_block(c.r, -1, co, 4);
      for (int k = 0; k < 4; ++k) row[L_CDC + 4 * pl + k] = (int16_t)co[k];
    }
  }
  if (cbp_c == 2) {
    for (int pl = 0; pl < 2; ++pl)
      for (int b = 0; b < 4; ++b) {
        m.tcc[pl][b] = read_block(c.r, nc_chroma(c, pl, b), co, 15);
        for (int k = 0; k < 15; ++k) row[L_CAC + 64 * pl + 16 * b + kZigzag[k + 1]] = (int16_t)co[k];
      }
  }
}

int16_t* new_row(MbCtx& c) {
  Output* o = c.out;
  if (o->rows >= o->cap) fail("more macroblocks with levels than the buffer holds");
  int16_t* row = o->levels + o->rows * LEVELS;
  memset(row, 0, LEVELS * sizeof(int16_t));
  c.d.mbs[c.mb].row = (int)o->rows++;
  return row;
}

// Intra4x4PredMode's prediction (8.3.1.1)
int pred_mode4(const MbCtx& c, int blk) {
  int x = kBlkX[blk], y = kBlkY[blk], m[2];
  for (int k = 0; k < 2; ++k) {
    int nx = x - (k == 0), ny = y - (k == 1);
    if (nx >= 0 && ny >= 0) {
      m[k] = c.d.mbs[c.mb].modes[kBlkAt[ny][nx]];
      continue;
    }
    int n = nb_intra(c, nx < 0 ? -1 : 0, ny < 0 ? -1 : 0);
    if (n < 0) return 2;
    const Mb& o = c.d.mbs[n];
    m[k] = o.kind == K_I4 ? o.modes[kBlkAt[ny & 3][nx & 3]] : 2;
  }
  return std::min(m[0], m[1]);
}

// the neighbour 4x4 block (x, y) (x in -1..4, y in -1..3, relative to the
// macroblock) for motion vector prediction: false if not available
bool mv_nb(const MbCtx& c, const bool* done, int x, int y, int* ref, int* mv) {
  int n, bx = x & 3, by = y & 3;
  if (y < 0) {
    n = x < 0 ? nb_mb(c, -1, -1) : x < 4 ? nb_mb(c, 0, -1) : nb_mb(c, 1, -1);
  } else if (x < 0) {
    n = nb_mb(c, -1, 0);
  } else if (x >= 4) {
    return false;
  } else {
    int b = kBlkAt[y][x];
    if (!done[b]) return false;
    const Mb& m = c.d.mbs[c.mb];
    *ref = m.refidx[b];
    mv[0] = m.mv[b][0];
    mv[1] = m.mv[b][1];
    return true;
  }
  if (n < 0) return false;
  const Mb& m = c.d.mbs[n];
  int b = kBlkAt[by][bx];
  *ref = m.refidx[b];
  mv[0] = m.mv[b][0];
  mv[1] = m.mv[b][1];
  return true;
}

int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// 8.4.1.3: the prediction of partition (x, y, w x h) in 4x4 units with
// reference index ref; shape 1/2: 16x8 partition 0/1, 3/4: 8x16 partition 0/1
void mvp(const MbCtx& c, const bool* done, int x, int y, int w, int ref, int shape, int* out) {
  int ra = -1, rb = -1, rc = -1, a[2] = {0, 0}, b[2] = {0, 0}, cc[2] = {0, 0};
  bool av_a = mv_nb(c, done, x - 1, y, &ra, a);
  bool av_b = mv_nb(c, done, x, y - 1, &rb, b);
  bool av_c = mv_nb(c, done, x + w, y - 1, &rc, cc);
  if (!av_c) av_c = mv_nb(c, done, x - 1, y - 1, &rc, cc);
  if (!av_a) ra = -1, a[0] = a[1] = 0;
  if (!av_b) rb = -1, b[0] = b[1] = 0;
  if (!av_c) rc = -1, cc[0] = cc[1] = 0;
  const int* pick = nullptr;
  if (shape == 1 && rb == ref) pick = b;
  if (shape == 2 && ra == ref) pick = a;
  if (shape == 3 && ra == ref) pick = a;
  if (shape == 4 && rc == ref) pick = cc;
  if (pick) {
    out[0] = pick[0];
    out[1] = pick[1];
    return;
  }
  if (!av_b && !av_c && av_a) {
    rb = rc = ra;
    b[0] = cc[0] = a[0];
    b[1] = cc[1] = a[1];
  }
  int same = (ra == ref) + (rb == ref) + (rc == ref);
  if (same == 1) {
    pick = ra == ref ? a : rb == ref ? b : cc;
    out[0] = pick[0];
    out[1] = pick[1];
    return;
  }
  out[0] = median(a[0], b[0], cc[0]);
  out[1] = median(a[1], b[1], cc[1]);
}

int wrap16(int v) { return (int16_t)(uint16_t)(v & 0xFFFF); }

void set_part(MbCtx& c, bool* done, int x, int y, int w, int h, int ref, const int* mv) {
  Mb& m = c.d.mbs[c.mb];
  for (int j = y; j < y + h; ++j)
    for (int i = x; i < x + w; ++i) {
      int b = kBlkAt[j][i];
      m.refidx[b] = (int8_t)ref;
      m.slot[b] = (int8_t)c.d.list[ref];
      m.mv[b][0] = (int16_t)mv[0];
      m.mv[b][1] = (int16_t)mv[1];
      done[b] = true;
    }
}

void check_ref(const MbCtx& c, int ref) {
  if (ref >= c.d.num_ref || c.d.list[ref] < 0)
    fail("ref_idx %d names no reference picture", ref);
}

int read_ref(MbCtx& c) {
  if (c.d.num_ref <= 1) return 0;
  int v = c.d.num_ref == 2 ? !c.r.u(1) : (int)c.r.ue();
  check_ref(c, v);
  return v;
}

void decode_skip(MbCtx& c) {
  Mb& m = c.d.mbs[c.mb];
  m.kind = K_SKIP;
  check_ref(c, 0);
  bool done[16] = {false};
  int mv[2] = {0, 0}, ra = -1, rb = -1, a[2] = {0, 0}, b[2] = {0, 0};
  bool av_a = nb_mb(c, -1, 0) >= 0 && mv_nb(c, done, -1, 0, &ra, a);
  bool av_b = nb_mb(c, 0, -1) >= 0 && mv_nb(c, done, 0, -1, &rb, b);
  if (av_a && av_b && !(ra == 0 && !a[0] && !a[1]) && !(rb == 0 && !b[0] && !b[1]))
    mvp(c, done, 0, 0, 4, 0, 0, mv);
  set_part(c, done, 0, 0, 4, 4, 0, mv);
}

// (need top, need left, need top-left) of Intra4x4 mode m
bool mode4_ok(int m, bool top, bool left, bool tl) {
  switch (m) {
    case 0: case 3: case 7: return top;
    case 1: case 8: return left;
    case 2: return true;
    default: return top && left && tl;
  }
}

void decode_mb(MbCtx& c, bool p_slice, int* qp) {
  Decoder& d = c.d;
  Mb& m = d.mbs[c.mb];
  Reader& r = c.r;
  int mbt = r.ue();
  int kind, cbp_l = 0, cbp_c = 0;
  int ptype = -1;
  if (p_slice) {
    if (mbt < 5)
      ptype = mbt;
    else
      mbt -= 5;
  }
  if (ptype < 0) {
    if (mbt > 25) fail("mb_type %d", mbt + (p_slice ? 5 : 0));
    kind = mbt == 0 ? K_I4 : mbt == 25 ? K_PCM : K_I16;
  } else {
    kind = K_P;
  }
  m.kind = kind;
  int a = nb_intra(c, -1, 0), b = nb_intra(c, 0, -1), cc = nb_intra(c, 1, -1),
      dd = nb_intra(c, -1, -1);
  m.avail = (a >= 0) | (b >= 0) << 1 | (cc >= 0) << 2 | (dd >= 0) << 3;
  if (kind == K_PCM) {
    r.pos = (r.pos + 7) & ~7LL;
    int16_t* row = new_row(c);
    for (int i = 0; i < 384; ++i) row[i] = (int16_t)r.u(8);
    memset(m.tc, 16, sizeof m.tc);
    memset(m.tcc, 16, sizeof m.tcc);
    m.qp = 0;  // the loop filter's qP of an I_PCM macroblock
    return;
  }
  if (kind == K_I4) {
    for (int blk = 0; blk < 16; ++blk) {
      int pm = pred_mode4(c, blk), mode = pm;
      if (!r.u(1)) {
        int rem = (int)r.u(3);
        mode = rem < pm ? rem : rem + 1;
      }
      m.modes[blk] = (int8_t)mode;
      int x = kBlkX[blk], y = kBlkY[blk];
      bool left = x > 0 || a >= 0, top = y > 0 || b >= 0;
      bool tl = (x > 0 && y > 0) || (x == 0 && y > 0 && a >= 0) || (x > 0 && y == 0 && b >= 0) ||
                (x == 0 && y == 0 && dd >= 0);
      if (!mode4_ok(mode, top, left, tl))
        fail("Intra4x4 mode %d needs samples that are not available", mode);
    }
  }
  if (kind == K_I16) {
    m.m16 = (mbt - 1) & 3;
    cbp_c = ((mbt - 1) >> 2) % 3;
    cbp_l = mbt >= 13 ? 15 : 0;
    bool ok = m.m16 == 2 || (m.m16 == 0 && b >= 0) || (m.m16 == 1 && a >= 0) ||
              (m.m16 == 3 && a >= 0 && b >= 0 && dd >= 0);
    if (!ok) fail("Intra16x16 mode %d needs samples that are not available", m.m16);
  }
  if (kind != K_P) {
    m.mc = r.ue();
    bool ok = m.mc == 0 || (m.mc == 1 && a >= 0) || (m.mc == 2 && b >= 0) ||
              (m.mc == 3 && a >= 0 && b >= 0 && dd >= 0);
    if (m.mc > 3 || !ok) fail("intra chroma mode %d needs samples that are not available", m.mc);
  } else {
    bool done[16] = {false};
    if (ptype < 3) {
      int n = ptype == 0 ? 1 : 2, ref[2], mvd[2][2];
      for (int p = 0; p < n; ++p) ref[p] = read_ref(c);
      if (d.num_ref <= 1)
        for (int p = 0; p < n; ++p) check_ref(c, ref[p]);
      for (int p = 0; p < n; ++p) {
        mvd[p][0] = r.se();
        mvd[p][1] = r.se();
      }
      for (int p = 0; p < n; ++p) {
        int x = ptype == 2 ? 2 * p : 0, y = ptype == 1 ? 2 * p : 0;
        int w = ptype == 2 ? 2 : 4, h = ptype == 1 ? 2 : 4;
        int shape = ptype == 1 ? 1 + p : ptype == 2 ? 3 + p : 0;
        int pr[2], mv[2];
        mvp(c, done, x, y, w, ref[p], shape, pr);
        mv[0] = wrap16(pr[0] + mvd[p][0]);
        mv[1] = wrap16(pr[1] + mvd[p][1]);
        set_part(c, done, x, y, w, h, ref[p], mv);
      }
    } else {
      int sub[4], ref[4];
      for (int i = 0; i < 4; ++i) {
        sub[i] = r.ue();
        if (sub[i] > 3) fail("sub_mb_type %d in a P macroblock", sub[i]);
      }
      for (int i = 0; i < 4; ++i) ref[i] = ptype == 3 ? read_ref(c) : 0;
      for (int i = 0; i < 4; ++i) check_ref(c, ref[i]);
      int mvd[16][2], nmv = 0;
      for (int i = 0; i < 4; ++i) {
        int np = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
        for (int k = 0; k < np; ++k) {
          mvd[nmv][0] = r.se();
          mvd[nmv][1] = r.se();
          nmv++;
        }
      }
      nmv = 0;
      for (int i = 0; i < 4; ++i) {
        int x0 = 2 * (i & 1), y0 = 2 * (i >> 1);
        int np = sub[i] == 0 ? 1 : sub[i] == 3 ? 4 : 2;
        int w = sub[i] == 0 || sub[i] == 1 ? 2 : 1, h = sub[i] == 0 || sub[i] == 2 ? 2 : 1;
        for (int k = 0; k < np; ++k) {
          int x = x0 + (sub[i] == 2 || sub[i] == 3 ? (k & 1) : 0);
          int y = y0 + (sub[i] == 1 ? k : sub[i] == 3 ? (k >> 1) : 0);
          int pr[2], mv[2];
          mvp(c, done, x, y, w, ref[i], 0, pr);
          mv[0] = wrap16(pr[0] + mvd[nmv][0]);
          mv[1] = wrap16(pr[1] + mvd[nmv][1]);
          nmv++;
          set_part(c, done, x, y, w, h, ref[i], mv);
        }
      }
    }
  }
  if (kind != K_I16) {
    int code = r.ue();
    if (code > 47) fail("coded_block_pattern code %d", code);
    int cbp = kind == K_I4 ? kIntraCbp[code] : kInterCbp[code];
    cbp_l = cbp & 15;
    cbp_c = cbp >> 4;
  }
  if (cbp_l || cbp_c || kind == K_I16) {
    int dq = r.se();
    if (dq < -26 || dq > 25) fail("mb_qp_delta %d", dq);
    *qp = (*qp + dq + 52) % 52;
    m.qp = *qp;
    residual(c, kind == K_I16, cbp_l, cbp_c, new_row(c));
  } else {
    m.qp = *qp;
  }
}

void decode_slice_data(Decoder& d, Reader& r, const SliceHdr& h, int slice, Output* out) {
  int n = nmb(d), mb = h.first_mb, qp = h.qp;
  const Pps& p = d.pps[h.pps_id];
  MbCtx c{d, r, out, slice, 0, 0, 0, p.constrained};
  bool p_slice = h.type == 0;
  auto start = [&](int addr) {
    if (addr >= n) fail("a slice runs past the picture's last macroblock");
    if (d.mbs[addr].slice >= 0) fail("a macroblock in two slices");
    Mb& m = d.mbs[addr];
    m = Mb();
    m.slice = slice;
    memset(m.tc, 0, sizeof m.tc);
    memset(m.tcc, 0, sizeof m.tcc);
    memset(m.modes, 2, sizeof m.modes);
    memset(m.mv, 0, sizeof m.mv);
    memset(m.refidx, -1, sizeof m.refidx);
    memset(m.slot, -1, sizeof m.slot);
    c.mb = addr;
    c.mbx = addr % d.act.mb_w;
    c.mby = addr / d.act.mb_w;
  };
  bool more = true;
  while (more) {
    if (p_slice) {
      uint32_t skip = r.ue();
      for (uint32_t k = 0; k < skip; ++k) {
        start(mb);
        d.mbs[mb].qp = qp;
        decode_skip(c);
        mb++;
      }
      if (skip && !r.more()) break;
    }
    start(mb);
    decode_mb(c, p_slice, &qp);
    mb++;
    more = r.more();
  }
}

// ------------------------------------------------------------- output
void finish_picture(Decoder& d, Output* out) {
  int n = nmb(d), W = d.act.mb_w;
  for (int i = 0; i < n; ++i)
    if (d.mbs[i].slice < 0) fail("macroblock %d is in no slice", i);
  if (!out) return;
  if (out->mb_cap < n) fail("the record buffer holds fewer macroblocks than the picture");
  for (int i = 0; i < n; ++i) {
    const Mb& q = d.mbs[i];
    const SliceHdr& sh = d.slices[q.slice];
    const Pps& p = d.pps[sh.pps_id];
    int32_t* rec = out->mbs + (int64_t)i * FIELDS;
    memset(rec, 0, FIELDS * sizeof(int32_t));
    rec[F_KIND] = q.kind;
    rec[F_QP] = q.qp;
    rec[F_CQP0] = p.cqp[0];
    rec[F_CQP1] = p.cqp[1];
    rec[F_M16] = q.m16;
    rec[F_MC] = q.mc;
    rec[F_AVAIL] = q.avail;
    rec[F_ROW] = q.row;
    for (int b = 0; b < 16; ++b) rec[F_MODES + (b >> 3)] |= (q.modes[b] & 15) << (4 * (b & 7));
    rec[F_ALPHA] = sh.alpha;
    rec[F_BETA] = sh.beta;
    for (int b = 0; b < 16; ++b) {
      rec[F_MV + b] = (int32_t)((uint32_t)(uint16_t)q.mv[b][0] | (uint32_t)(uint16_t)q.mv[b][1] << 16);
      rec[F_REF + (b >> 2)] |= (int32_t)((uint32_t)(uint8_t)q.slot[b] << (8 * (b & 3)));
    }
    // boundary strengths (8.7.2.1): [direction][edge] x 4 segments
    int x = i % W, y = i / W;
    for (int dir = 0; dir < 2; ++dir) {
      int pn = dir == 0 ? (x > 0 ? i - 1 : -1) : (y > 0 ? i - W : -1);
      bool edge0 = pn >= 0 && sh.deblock_idc != 1 &&
                   !(sh.deblock_idc == 2 && d.mbs[pn].slice != q.slice);
      for (int e = 0; e < 4; ++e) {
        uint32_t packed = 0;
        for (int k = 0; k < 4; ++k) {
          int bq = dir == 0 ? kBlkAt[k][e] : kBlkAt[e][k];
          int bs = 0;
          if (sh.deblock_idc != 1 && (e > 0 || edge0)) {
            const Mb& pm = e > 0 ? q : d.mbs[pn];
            int bp = e > 0 ? (dir == 0 ? kBlkAt[k][e - 1] : kBlkAt[e - 1][k])
                           : (dir == 0 ? kBlkAt[k][3] : kBlkAt[3][k]);
            bool intra = is_intra(pm.kind) || is_intra(q.kind);
            if (intra)
              bs = e == 0 ? 4 : 3;
            else if (pm.tc[bp] || q.tc[bq])
              bs = 2;
            else if (pm.slot[bp] != q.slot[bq] || abs(pm.mv[bp][0] - q.mv[bq][0]) >= 4 ||
                     abs(pm.mv[bp][1] - q.mv[bq][1]) >= 4)
              bs = 1;
          }
          packed |= (uint32_t)bs << (8 * k);
        }
        rec[F_BS + 4 * dir + e] = (int32_t)packed;
      }
    }
  }
}

// Calls fn(type, ref_idc, nal, len) for each length-prefixed NAL unit of a
// sample, until fn returns false.
template <class F>
void for_each_nal(const Decoder& d, const uint8_t* data, int64_t n, F fn) {
  int64_t pos = 0;
  while (pos < n) {
    if (pos + d.len_size > n) fail("a NAL unit length runs past the sample");
    int64_t len = 0;
    for (int k = 0; k < d.len_size; ++k) len = len << 8 | data[pos + k];
    pos += d.len_size;
    if (len < 1 || pos + len > n) fail("a NAL unit of %lld bytes runs past the sample", (long long)len);
    const uint8_t* nal = data + pos;
    pos += len;
    if (!fn(nal[0] & 31, nal[0] >> 5 & 3, nal, len)) return;
  }
}

// Stores an SPS (type 7) or PPS (type 8) read from ``r``.
void store_parameter_set(Decoder& d, Reader& r, int type) {
  int id;
  if (type == 7) {
    Sps s = parse_sps(r, &id);
    d.sps[id] = s;
  } else {
    Pps p = parse_pps(r, d.sps, &id);
    d.pps[id] = p;
  }
}

// Parses one sample (an access unit). pic: [0] the picture's slot (-1: no
// picture in the sample), [1] IDR, [2] POC, [3] frame_num, [4] a reference,
// [5] slices, [6] slice types (1 I, 2 P).
int64_t parse_sample(Decoder& d, const uint8_t* data, int64_t n, bool headers_only,
                     int32_t* pic, Output* out) {
  std::call_once(g_once, build_vlcs);
  for (int k = 0; k < 8; ++k) pic[k] = 0;
  pic[0] = -1;
  Reader r;
  bool started = false;
  int types = 0;
  SliceHdr first;
  int expect_mb = 0;
  d.slices.clear();
  for_each_nal(d, data, n, [&](int type, int ref_idc, const uint8_t* nal, int64_t len) {
    if (type == 2 || type == 3 || type == 4) fail("data partitioning (NAL unit type %d)", type);
    if (type != 1 && type != 5 && type != 7 && type != 8) return true;
    r.load(nal + 1, len - 1);
    if (type == 7 || type == 8) {
      store_parameter_set(d, r, type);
      return true;
    }
    SliceHdr h = parse_slice_header(d, r, type, ref_idc);
    const Pps& p = d.pps[h.pps_id];
    const Sps& s = d.sps[p.sps_id];
    if (!started) {
      if (!d.seen_picture && !h.idr) fail("a first picture that is not an IDR picture");
      if (!d.active) {
        d.act = s;
        d.active = true;
        d.nslots = std::max(s.max_refs, 1) + 1;
      } else if (s.mb_w != d.act.mb_w || s.mb_h != d.act.mb_h || s.crop_l != d.act.crop_l ||
                 s.crop_r != d.act.crop_r || s.crop_t != d.act.crop_t ||
                 s.crop_b != d.act.crop_b || s.matrix != d.act.matrix) {
        fail("a later SPS of another size or colour matrix");
      } else if (std::max(s.max_refs, 1) + 1 > d.nslots) {
        fail("a later SPS with more reference frames");
      } else {
        int keep = d.nslots;
        d.act = s;
        d.nslots = keep;
      }
      int max_fn = 1 << s.log2_max_fn;
      if (!h.idr && h.frame_num != d.prev_ref_fn && h.frame_num != (d.prev_ref_fn + 1) % max_fn)
        fail("a gap in frame_num (%d after %d)", h.frame_num, d.prev_ref_fn);
      if (h.idr && h.frame_num) fail("an IDR picture with frame_num %d", h.frame_num);
      d.poc = compute_poc(d, h);
      if (d.seen_picture && !h.idr && d.poc <= d.last_poc)
        fail("picture order count %d after %d: an output order that differs from the "
             "decoding order (B-frame reordering)", d.poc, d.last_poc);
      d.cur_slot = -1;
      for (int i = 0; i < d.nslots && d.cur_slot < 0; ++i)
        if (h.idr || d.dpb[i].state == 0) d.cur_slot = i;
      if (d.cur_slot < 0) fail("no free picture buffer");
      d.mbs.assign(nmb(d), Mb());
      started = true;
      first = h;
    } else {
      if (h.frame_num != first.frame_num || h.idr != first.idr || h.poc_lsb != first.poc_lsb ||
          (h.ref_idc != 0) != (first.ref_idc != 0) || h.pps_id != first.pps_id)
        fail("two pictures in one sample");
      if (h.first_mb < expect_mb) fail("arbitrary slice order (slice at macroblock %d after "
                                       "one ending at %d)", h.first_mb, expect_mb);
    }
    if (h.first_mb >= nmb(d)) fail("first_mb_in_slice %d", h.first_mb);
    types |= h.type == 2 ? 1 : 2;
    int slice = (int)d.slices.size();
    d.slices.push_back(h);
    if (h.type == 0) {
      if (h.idr) fail("a P slice in an IDR picture");
      build_list(d, h);
    } else {
      d.num_ref = 0;
    }
    if (!headers_only) {
      decode_slice_data(d, r, h, slice, out);
      int end = h.first_mb;
      while (end < nmb(d) && d.mbs[end].slice == slice) end++;
      expect_mb = end;
    } else {
      expect_mb = h.first_mb + 1;
    }
      return true;
  });
  if (!started) return 0;
  if (!headers_only) finish_picture(d, out);
  mark(d, first);
  if (first.ref_idc) d.prev_ref_fn = first.frame_num;
  if (first.idr && !first.ref_idc) fail("an IDR picture with nal_ref_idc 0");
  d.prev_fn = first.frame_num;
  d.last_poc = d.poc;
  d.seen_picture = true;
  pic[0] = d.cur_slot;
  pic[1] = first.idr;
  pic[2] = d.poc;
  pic[3] = first.frame_num;
  pic[4] = first.ref_idc != 0;
  pic[5] = (int)d.slices.size();
  pic[6] = types;
  return out ? out->rows : 0;
}

void copy_error(const Error& e, char* err, int errlen) {
  if (errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
}

}  // namespace

extern "C" {

void* h264_open() { return new Decoder(); }

void h264_close(void* h) { delete (Decoder*)h; }

// An avcC (AVCDecoderConfigurationRecord): the NAL length size and the
// parameter sets.
int h264_config(void* h, const uint8_t* data, int64_t n, char* err, int errlen) {
  Decoder& d = *(Decoder*)h;
  try {
    if (n < 7 || data[0] != 1) fail("an avcC that is not configurationVersion 1");
    d.len_size = (data[4] & 3) + 1;
    if (d.len_size == 3) fail("an avcC with 3-byte NAL lengths");
    int64_t pos = 6;
    Reader r;
    for (int kind = 0; kind < 2; ++kind) {
      int count = kind == 0 ? data[5] & 31 : (pos < n ? data[pos++] : 0);
      for (int k = 0; k < count; ++k) {
        if (pos + 2 > n) fail("an avcC cut short");
        int len = data[pos] << 8 | data[pos + 1];
        pos += 2;
        if (len < 1 || pos + len > n) fail("an avcC cut short");
        r.load(data + pos + 1, len - 1);
        store_parameter_set(d, r, kind == 0 ? 7 : 8);
        pos += len;
      }
    }
    return 0;
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}

// info: mb_w, mb_h, width, height (cropped), crop left, crop top, slots,
// colour matrix (0 BT.601, 1 BT.709) of the active SPS; -1 before the first
// picture
int h264_info(void* h, int32_t* info) {
  const Decoder& d = *(Decoder*)h;
  const Sps& s = d.act;
  info[0] = s.mb_w;
  info[1] = s.mb_h;
  info[2] = 16 * s.mb_w - s.crop_l - s.crop_r;
  info[3] = 16 * s.mb_h - s.crop_t - s.crop_b;
  info[4] = s.crop_l;
  info[5] = s.crop_t;
  info[6] = d.nslots;
  info[7] = s.matrix;
  return d.active ? 0 : -1;
}

// The geometry the sample's first slice will have (info as h264_info),
// from the parameter sets seen so far and the sample's own: 0, or 1 where
// the sample holds no slice, or -1 with the reason in err. Nothing but the
// parameter sets changes.
int h264_peek(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Decoder& d = *(Decoder*)h;
  try {
    Reader r;
    bool found = false;
    for_each_nal(d, data, n, [&](int type, int, const uint8_t* nal, int64_t len) {
      if (type != 1 && type != 5 && type != 7 && type != 8) return true;
      r.load(nal + 1, len - 1);
      if (type == 7 || type == 8) {
        store_parameter_set(d, r, type);
        return true;
      }
      r.ue();
      r.ue();
      int pid = r.ue();
      if (pid > 255 || !d.pps[pid].valid) fail("a slice of a PPS not seen");
      const Sps& s = d.sps[d.pps[pid].sps_id];
      info[0] = s.mb_w;
      info[1] = s.mb_h;
      info[2] = 16 * s.mb_w - s.crop_l - s.crop_r;
      info[3] = 16 * s.mb_h - s.crop_t - s.crop_b;
      info[4] = s.crop_l;
      info[5] = s.crop_t;
      info[6] = d.active ? d.nslots : std::max(s.max_refs, 1) + 1;
      info[7] = s.matrix;
      found = true;
      return false;
    });
    return found ? 0 : 1;
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}

// Parses one sample. With headers_only, the parameter sets, slice headers,
// order counts, reference marking and lists alone; else also the
// macroblocks: ``mbs`` gets [mb_w * mb_h, 40] records (at most mb_cap),
// ``levels`` [rows, 408] (at most cap rows). Returns the rows written, or -1
// with the reason in err.
int64_t h264_parse(void* h, const uint8_t* data, int64_t n, int headers_only, int32_t* pic,
                   int32_t* mbs, int64_t mb_cap, int16_t* levels, int64_t cap, char* err,
                   int errlen) {
  Decoder& d = *(Decoder*)h;
  try {
    Output o{mbs, mb_cap, levels, cap};
    return parse_sample(d, data, n, headers_only != 0, pic, headers_only ? nullptr : &o);
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}
}
