// m4v.cpp: the bitstream half of the port's MPEG-4 Part 2 (ISO/IEC 14496-2)
// video decoder, host C++ loaded through ctypes (native/__init__.py). It
// parses what FFmpeg's mpeg4 encoder writes at its defaults (OpenCV's
// VideoWriter for 'mp4v', 'XVID', 'DIVX', 'FMP4', 'DX50'): Simple Profile,
// rectangular, progressive, 8-bit, H.263 quantisation, I- and P-VOPs with
// one vector a macroblock. It reads each VOP as FFmpeg's mpeg4videodec.c
// does (header fields, MCBPC/CBPY/dquant, the median vector prediction
// with its edge rules, the DC size VLCs and the gradient DC prediction, the
// AC prediction rescaled by the QP ratio, the TCOEF VLCs with escapes 1-3)
// and hands the pixel work to the two CUDA kernels of csrc/m4v.cu (or their
// plain versions): per macroblock its type, QP and vector, per coded block
// its quantised levels in raster order.
//
// What FFmpeg decodes with other tools or with bug workarounds is refused
// with a message naming it: the caller adds the sample's index.
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------------ tables
// FFmpeg's (libavcodec/mpeg4data.h, h263data.c, mpegvideodata.c), which are
// the standard's Tables B-1..B-17: {code, length}.
const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltH[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                           13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                           30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                           46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltV[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                           41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                           51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                           53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint8_t kMv[33][2] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                            {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                            {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                            {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                            {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// symbol = (intra+Q ? 4 : 0) | cbpc; 8 is stuffing
const uint8_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// symbol = 4 x (inter, intra, inter+Q, intra+Q, inter4v, stuffing, inter4v+Q) + cbpc
const uint8_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4},  {2, 4},  {5, 6},  {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3},  {7, 7},
    {6, 7}, {5, 9},  {4, 6},  {4, 9},  {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7},  {5, 8},
    {1, 9}, {0, 0},  {0, 0},  {0, 0},  {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4},  {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4}, {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
// LMAX of each run, last = 0 then last = 1 (the run/level order of the
// tables above: each run's levels 1..LMAX in turn)
const int kInterLmax0[27] = {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1,
                             1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterLmax1[41] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kIntraLmax0[15] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1};
const int kIntraLmax1[21] = {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kQuantTab[4] = {-1, -2, 1, 2};
const int kEscape = 102;

enum { MB_INTRA = 0, MB_INTER = 1, MB_SKIP = 2 };
enum { F_TYPE, F_QP, F_MVX, F_MVY, F_BLK };  // the fields of a macroblock record
const int kMbFields = F_BLK + 6;

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

// --------------------------------------------------------------- bit reader
struct Bits {
  const uint8_t* p;
  int64_t nbits, pos = 0;
  Bits(const uint8_t* d, int64_t n) : p(d), nbits(8 * n) {}
  uint32_t peek(int n) const {  // n <= 32; bits past the end read as 0
    uint64_t v = 0;
    int64_t byte = pos >> 3;
    for (int k = 0; k < 5; ++k) {
      v <<= 8;
      if (byte + k < (nbits >> 3)) v |= p[byte + k];
    }
    return n ? (uint32_t)((v << (24 + (pos & 7))) >> (64 - n)) : 0;
  }
  uint32_t get(int n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int bit() { return (int)get(1); }
  int64_t left() const { return nbits - pos; }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
};

// A VLC as one lookup table over its longest code: symbol and length.
struct Vlc {
  int maxlen = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  template <typename T>
  void build(const T (*codes)[2], int n) {
    for (int i = 0; i < n; ++i)
      if (codes[i][1] > maxlen) maxlen = codes[i][1];
    sym.assign((size_t)1 << maxlen, -1);
    len.assign((size_t)1 << maxlen, 0);
    for (int i = 0; i < n; ++i) {
      int l = codes[i][1];
      if (!l) continue;
      uint32_t first = (uint32_t)codes[i][0] << (maxlen - l), count = 1u << (maxlen - l);
      for (uint32_t k = 0; k < count; ++k) {
        sym[first + k] = (int16_t)i;
        len[first + k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b) const {
    uint32_t v = b.peek(maxlen);
    if (!len[v]) return -1;
    b.pos += len[v];
    return sym[v];
  }
};

struct RlTable {
  Vlc vlc;
  int run[102], level[102], last[102];
  int lmax[2][64], rmax[2][64];
  void build(const uint16_t (*codes)[2], const int* lmax0, int n0, const int* lmax1, int n1) {
    vlc.build(codes, 103);
    memset(lmax, 0, sizeof lmax);
    memset(rmax, 0, sizeof rmax);
    int k = 0;
    for (int l = 0; l < 2; ++l) {
      const int* lm = l ? lmax1 : lmax0;
      for (int r = 0; r < (l ? n1 : n0); ++r)
        for (int v = 1; v <= lm[r]; ++v, ++k) {
          run[k] = r;
          level[k] = v;
          last[k] = l;
          lmax[l][r] = v;
          if (r > rmax[l][v]) rmax[l][v] = r;
        }
    }
  }
};

struct Tables {
  Vlc mv, intra_mcbpc, inter_mcbpc, cbpy, dc_lum, dc_chrom;
  RlTable inter, intra;
  Tables() {
    mv.build(kMv, 33);
    intra_mcbpc.build(kIntraMcbpc, 9);
    inter_mcbpc.build(kInterMcbpc, 28);
    cbpy.build(kCbpy, 16);
    dc_lum.build(kDcLum, 13);
    dc_chrom.build(kDcChrom, 13);
    inter.build(kInterVlc, kInterLmax0, 27, kInterLmax1, 41);
    intra.build(kIntraVlc, kIntraLmax0, 15, kIntraLmax1, 21);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int dc_scale(int qp, bool luma) {  // ff_mpeg4_{y,c}_dc_scale_table
  if (qp < 5) return 8;
  if (luma) return qp < 9 ? 2 * qp : qp < 25 ? qp + 8 : 2 * qp - 16;
  return qp < 25 ? (qp + 13) / 2 : qp - 6;
}

int mid_pred(int a, int b, int c) {
  if (a > b) {
    int t = a;
    a = b;
    b = t;
  }
  return c < a ? a : c > b ? b : c;
}

// ------------------------------------------------------------------ state
struct Decoder {
  char tag[5];  // the container's fourcc in upper case, as FFmpeg's h263dec keeps it
  bool vol = false;
  int vo_type = 0, vol_control = 0, width = 0, height = 0, mb_w = 0, mb_h = 0, tib = 1;
  int lavc_build = -1, xvid_build = -1, divx_version = -1;
  bool checked_workarounds = false;
};

// The first bytes of a user-data string, as FFmpeg's decode_user_data reads
// them (up to 255 bytes, stopping before 23 zero bits).
std::string user_data(Bits& b) {
  std::string s;
  while (s.size() < 255 && b.left() > 0 && b.peek(23) != 0) s.push_back((char)b.get(8));
  return s;
}

void parse_user_data(Decoder& d, Bits& b) {
  std::string s = user_data(b);
  int ver = 0, ver2 = 0, ver3 = 0, build = 0;
  char last = 0;
  if (sscanf(s.c_str(), "DivX%dBuild%d%c", &ver, &build, &last) >= 2 ||
      sscanf(s.c_str(), "DivX%db%d%c", &ver, &build, &last) >= 2)
    fail("user data '%.40s' names a DivX encoder: FFmpeg decodes DivX streams with bug "
         "workarounds; not decoded", s.c_str());
  if (sscanf(s.c_str(), "XviD%d", &build) == 1)
    fail("user data '%.40s' names an XviD encoder: FFmpeg decodes XviD streams with Xvid's "
         "IDCT and bug workarounds; not decoded", s.c_str());
  if (sscanf(s.c_str(), "Lavc%d.%d.%d", &ver, &ver2, &ver3) == 3) {
    if (ver > 0xFF) ver = 0xFF;
    if (ver2 > 0xFF) ver2 = 0xFF;
    if (ver3 > 0xFF) ver3 = 0xFF;
    d.lavc_build = (ver << 16) + (ver2 << 8) + ver3;
  } else if (s.compare(0, 5, "FFmpe") == 0 || s == "ffmpeg") {
    fail("user data '%.40s' names an early FFmpeg build: FFmpeg decodes its streams with bug "
         "workarounds; not decoded", s.c_str());
  }
  int lb = d.lavc_build;
  if (lb >= 0 && (lb <= 4712 || ((lb & 0xFF) >= 100 && lb > 3621476 && lb < 3752552 &&
                                 (lb < 3752037 || lb > 3752191))))
    fail("user data '%.40s' names an FFmpeg build whose streams FFmpeg decodes with bug "
         "workarounds; not decoded", s.c_str());
}

void parse_visual_object(Bits& b) {
  if (b.bit()) b.get(7);  // visual_object_verid, priority
  int type = b.get(4);
  if (type != 1) fail("visual object type %d (not video): not decoded", type);
  if (b.bit()) {  // video_signal_type
    b.get(3);     // video_format
    if (b.bit()) fail("video_signal_type with full-range samples: not decoded");
  }
}

void parse_vol(Decoder& d, Bits& b) {
  b.get(1);  // random_accessible_vol
  d.vo_type = b.get(8);
  int verid = 1;
  if (b.bit()) {
    verid = b.get(4);
    b.get(3);
  }
  if (b.get(4) == 15) b.get(16);  // aspect_ratio_info: extended PAR
  d.vol_control = b.bit();
  if (d.vol_control) {
    int chroma = b.get(2);
    if (chroma != 1) fail("chroma_format %d (not 4:2:0): not decoded", chroma);
    b.get(1);  // low_delay
    if (b.bit()) b.get(79);  // vbv_parameters
  }
  int shape = b.get(2);
  if (shape != 0) fail("a VOL of shape %d (not rectangular): not decoded", shape);
  b.get(1);
  int res = b.get(16);
  if (!res) fail("a VOL with vop_time_increment_resolution 0");
  int tib = 0;
  for (int v = res - 1; v; v >>= 1) ++tib;
  d.tib = tib < 1 ? 1 : tib;
  b.get(1);
  if (b.bit()) b.get(d.tib);  // fixed_vop_rate
  b.get(1);
  int w = b.get(13);
  b.get(1);
  int h = b.get(13);
  b.get(1);
  if (!w || !h) fail("a VOL of %d x %d", w, h);
  if (b.bit()) fail("interlaced VOL: not decoded");
  b.get(1);  // obmc_disable: FFmpeg ignores it
  int sprite = verid == 1 ? b.get(1) : b.get(2);
  if (sprite) fail("sprite_enable %d (static sprites or GMC, S-VOPs): not decoded", sprite);
  if (b.bit()) fail("not_8_bit: a VOL of other than 8-bit samples: not decoded");
  if (b.bit()) fail("quant_type 1 (MPEG quantisation matrices): not decoded");
  if (verid != 1 && b.bit()) fail("quarter_sample (quarter-pel motion): not decoded");
  if (!b.bit()) fail("complexity estimation headers: not decoded");
  if (!b.bit()) fail("resync markers (resync_marker_disable 0): not decoded");
  if (b.bit()) fail("data partitioning (and reversible VLC): not decoded");
  if (verid != 1) {
    if (b.bit()) fail("newpred (a verid-2 tool): not decoded");
    if (b.bit()) fail("reduced-resolution VOPs (a verid-2 tool): not decoded");
  }
  if (b.bit()) fail("scalability: not decoded");
  if (b.left() < 0) fail("a VOL header cut short");
  if (d.vol && (w != d.width || h != d.height))
    fail("the VOL changes size from %d x %d to %d x %d: not decoded", d.width, d.height, w, h);
  d.vol = true;
  d.width = w;
  d.height = h;
  d.mb_w = (w + 15) / 16;
  d.mb_h = (h + 15) / 16;
}

// FFmpeg's ff_mpeg4_workaround_bugs, for the stream kinds it flags by the
// container's fourcc when no user data names the encoder.
void check_workarounds(Decoder& d) {
  if (d.checked_workarounds) return;
  d.checked_workarounds = true;
  if (d.xvid_build >= 0 || d.divx_version >= 0 || d.lavc_build >= 0) return;
  static const char* xvid[] = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"};
  for (const char* t : xvid)
    if (!strcmp(d.tag, t))
      fail("fourcc %s with no user data naming the encoder: FFmpeg decodes it as an XviD "
           "stream (Xvid's IDCT, bug workarounds); not decoded", d.tag);
  if (!strcmp(d.tag, "DIVX") && d.vo_type == 0 && !d.vol_control)
    fail("fourcc DIVX, video_object_type 0, no vol_control_parameters and no user data: "
         "FFmpeg decodes it as DivX 4 (bug workarounds); not decoded");
}

// ------------------------------------------------------------ one VOP
struct Vop {
  int type = -1;  // 0 I, 1 P, -1 not coded
  int rounding = 0, qp = 0, fcode = 1, dc_thr = 99;
};

struct Output {
  int32_t* mbs;     // [mb_cap, kMbFields]
  int64_t mb_cap;
  int16_t* levels;  // [cap, 64]
  int64_t cap, nblk = 0;
};

struct Frame {  // the intra predictors of one VOP
  int mb_w, mb_h;
  std::vector<int> dc;          // [3][...] dequantised DC of each block, 1024 outside
  std::vector<int16_t> ac;      // [...][16]: column 0 rows 1-7, row 0 columns 1-7
  std::vector<int> qp, mvx, mvy;
  int off[3], stride[3];
  Frame(int w, int h) : mb_w(w), mb_h(h) {
    stride[0] = 2 * w;
    stride[1] = stride[2] = w;
    off[0] = 0;
    off[1] = 4 * w * h;
    off[2] = off[1] + w * h;
    dc.assign(off[2] + w * h, 1024);
    ac.assign((size_t)(off[2] + w * h) * 16, 0);
    qp.assign(w * h, 0);
    mvx.assign(w * h, 0);
    mvy.assign(w * h, 0);
  }
  // index of block n of macroblock (x, y) shifted by (dx, dy) blocks; -1 outside
  int index(int n, int x, int y, int dx, int dy) const {
    int p = n < 4 ? 0 : n - 3;
    int bx = n < 4 ? 2 * x + (n & 1) : x, by = n < 4 ? 2 * y + (n >> 1) : y;
    bx += dx;
    by += dy;
    int bw = n < 4 ? 2 * mb_w : mb_w, bh = n < 4 ? 2 * mb_h : mb_h;
    if (bx < 0 || by < 0 || bx >= bw || by >= bh) return -1;
    return off[p] + by * stride[p] + bx;
  }
};

struct Mb {
  int x, y, qp, ac_pred;
};

// ff_mpeg4_pred_dc: the predicted quantised DC and the direction (0 left, 1
// top); stores the block's dequantised DC (level + pred, times the scale).
int pred_dc(Frame& f, const Mb& m, int n, int* dir) {
  int scale = dc_scale(m.qp, n < 4);
  int ia = f.index(n, m.x, m.y, -1, 0), ib = f.index(n, m.x, m.y, -1, -1),
      ic = f.index(n, m.x, m.y, 0, -1);
  int a = ia < 0 ? 1024 : f.dc[ia], b = ib < 0 ? 1024 : f.dc[ib], c = ic < 0 ? 1024 : f.dc[ic];
  int pred;
  if (abs(a - b) < abs(b - c)) {
    pred = c;
    *dir = 1;
  } else {
    pred = a;
    *dir = 0;
  }
  return (pred + (scale >> 1)) / scale;
}

void store_dc(Frame& f, const Mb& m, int n, int level) {
  level *= dc_scale(m.qp, n < 4);
  if (level & ~2047) level = level < 0 ? 0 : 2047;
  f.dc[f.index(n, m.x, m.y, 0, 0)] = level;
}

int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// ff_mpeg4_pred_ac on a block in raster order
void pred_ac(Frame& f, const Mb& m, int16_t* blk, int n, int dir) {
  int16_t* self = &f.ac[(size_t)f.index(n, m.x, m.y, 0, 0) * 16];
  if (m.ac_pred) {
    if (dir == 0) {
      int i = f.index(n, m.x, m.y, -1, 0);
      const int16_t* v = i < 0 ? nullptr : &f.ac[(size_t)i * 16];
      int q = m.x > 0 ? f.qp[m.y * f.mb_w + m.x - 1] : m.qp;
      for (int k = 1; k < 8; ++k) {
        int a = v ? v[k] : 0;
        if (!(m.x == 0 || m.qp == q || n == 1 || n == 3)) a = rounded_div(a * q, m.qp);
        blk[k << 3] = (int16_t)(blk[k << 3] + a);
      }
    } else {
      int i = f.index(n, m.x, m.y, 0, -1);
      const int16_t* v = i < 0 ? nullptr : &f.ac[(size_t)i * 16];
      int q = m.y > 0 ? f.qp[(m.y - 1) * f.mb_w + m.x] : m.qp;
      for (int k = 1; k < 8; ++k) {
        int a = v ? v[k + 8] : 0;
        if (!(m.y == 0 || m.qp == q || n == 2 || n == 3)) a = rounded_div(a * q, m.qp);
        blk[k] = (int16_t)(blk[k] + a);
      }
    }
  }
  for (int k = 1; k < 8; ++k) {
    self[k] = blk[k << 3];
    self[8 + k] = blk[k];
  }
}

// TCOEF of one block from scan position i + 1 on, into blk (raster order)
void read_coefs(Bits& b, const RlTable& rl, const uint8_t* scan, int16_t* blk, int i) {
  for (;;) {
    int s = rl.vlc.read(b);
    if (s < 0) fail("an invalid TCOEF code at bit %lld", (long long)b.pos);
    int run, level, last;
    if (s != kEscape) {
      run = rl.run[s];
      level = rl.level[s];
      last = rl.last[s];
      if (b.bit()) level = -level;
    } else if (!b.peek(1) || b.peek(2) == 2) {
      int esc = b.bit() ? (b.get(1), 2) : 1;  // '0': level offset; '10': run offset
      s = rl.vlc.read(b);
      if (s < 0 || s == kEscape) fail("an invalid escaped TCOEF code at bit %lld",
                                      (long long)b.pos);
      run = rl.run[s];
      level = rl.level[s];
      last = rl.last[s];
      if (esc == 1)
        level += rl.lmax[last][run];
      else
        run += rl.rmax[last][level] + 1;
      if (b.bit()) level = -level;
    } else {  // '11': fixed-length last, run, level
      b.get(2);
      last = b.bit();
      run = b.get(6);
      b.get(1);
      level = (int)b.get(12);
      if (level & 0x800) level -= 0x1000;
      b.get(1);
    }
    i += run + 1;
    if (i > 63) fail("more than 64 coefficients in a block at bit %lld", (long long)b.pos);
    blk[scan[i]] = (int16_t)level;
    if (last) return;
  }
}

int read_dc(Bits& b, int n) {
  const Tables& t = tables();
  int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(b);
  if (size < 0 || size > 9) fail("an invalid DC size code at bit %lld", (long long)b.pos);
  if (!size) return 0;
  int v = (int)b.get(size);
  if (!(v >> (size - 1))) v -= (1 << size) - 1;
  if (size > 8) b.get(1);  // marker
  return v;
}

int16_t* new_block(Output& o) {
  if (o.nblk >= o.cap) fail("more coded blocks than macroblocks allow");
  int16_t* blk = o.levels + 64 * o.nblk++;
  memset(blk, 0, 64 * sizeof(int16_t));
  return blk;
}

void intra_mb(Bits& b, Frame& f, Output& o, Mb& m, int cbpc, bool dquant, const Vop& v,
              int32_t* rec, int* qscale) {
  const Tables& t = tables();
  m.ac_pred = b.bit();
  int cbpy = t.cbpy.read(b);
  if (cbpy < 0) fail("an invalid CBPY code at bit %lld", (long long)b.pos);
  int cbp = (cbpc & 3) | (cbpy << 2);
  bool dc_vlc = *qscale < v.dc_thr;  // before dquant, as FFmpeg reads it
  if (dquant) {
    *qscale += kQuantTab[b.get(2)];
    *qscale = *qscale < 1 ? 1 : *qscale > 31 ? 31 : *qscale;
  }
  m.qp = *qscale;
  f.qp[m.y * f.mb_w + m.x] = m.qp;
  rec[F_TYPE] = MB_INTRA;
  rec[F_QP] = m.qp;
  for (int n = 0; n < 6; ++n, cbp <<= 1) {
    int16_t* blk = new_block(o);
    rec[F_BLK + n] = (int32_t)(o.nblk - 1);
    int dir, i;
    int pred = pred_dc(f, m, n, &dir);
    if (dc_vlc) {
      blk[0] = (int16_t)(read_dc(b, n) + pred);
      store_dc(f, m, n, blk[0]);
      i = 0;
    } else {
      i = -1;
    }
    const uint8_t* scan = !m.ac_pred ? kZigzag : dir == 0 ? kAltV : kAltH;
    if (cbp & 32) read_coefs(b, t.intra, scan, blk, i);
    if (!dc_vlc) {
      blk[0] = (int16_t)(blk[0] + pred);
      store_dc(f, m, n, blk[0]);
    }
    pred_ac(f, m, blk, n, dir);
  }
}

int read_mv(Bits& b, int pred, int fcode) {  // ff_h263_decode_motion
  int code = tables().mv.read(b);
  if (code < 0) fail("an invalid motion vector code at bit %lld", (long long)b.pos);
  if (code == 0) return pred;
  int sign = b.bit(), shift = fcode - 1, val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= b.get(shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + fcode;  // modulo decoding into [-32, 32) << (fcode - 1)
  return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
}

void decode_mbs(Bits& b, const Decoder& d, const Vop& v, Output& o) {
  const Tables& t = tables();
  if ((int64_t)d.mb_w * d.mb_h > o.mb_cap)
    fail("a VOP of %d x %d macroblocks, more than the %lld records given", d.mb_w, d.mb_h,
         (long long)o.mb_cap);
  Frame f(d.mb_w, d.mb_h);
  int qscale = v.qp;
  for (int y = 0; y < d.mb_h; ++y)
    for (int x = 0; x < d.mb_w; ++x) {
      int32_t* rec = o.mbs + (size_t)(y * d.mb_w + x) * kMbFields;
      for (int k = 0; k < kMbFields; ++k) rec[k] = k >= F_BLK ? -1 : 0;
      Mb m{x, y, qscale, 0};
      if (b.left() <= 0) fail("the VOP ends before macroblock (%d, %d)", x, y);
      if (v.type == 0) {
        int cbpc;
        do {
          cbpc = t.intra_mcbpc.read(b);
          if (cbpc < 0) fail("an invalid I MCBPC code at macroblock (%d, %d)", x, y);
        } while (cbpc == 8);
        intra_mb(b, f, o, m, cbpc, cbpc & 4, v, rec, &qscale);
        continue;
      }
      int cbpc;
      bool skipped = false;
      do {
        if (b.bit()) {
          skipped = true;
          break;
        }
        cbpc = t.inter_mcbpc.read(b);
        if (cbpc < 0) fail("an invalid P MCBPC code at macroblock (%d, %d)", x, y);
      } while (cbpc == 20);
      f.qp[y * d.mb_w + x] = qscale;
      if (skipped) {
        rec[F_TYPE] = MB_SKIP;
        rec[F_QP] = qscale;
        continue;
      }
      bool dquant = cbpc & 8;
      if (cbpc & 4) {
        intra_mb(b, f, o, m, cbpc, dquant, v, rec, &qscale);
        continue;
      }
      if (cbpc & 16) fail("a macroblock with four motion vectors (INTER4V) at (%d, %d): "
                          "not decoded", x, y);
      int cbpy = t.cbpy.read(b);
      if (cbpy < 0) fail("an invalid CBPY code at macroblock (%d, %d)", x, y);
      int cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
      if (dquant) {
        qscale += kQuantTab[b.get(2)];
        qscale = qscale < 1 ? 1 : qscale > 31 ? 31 : qscale;
      }
      f.qp[y * d.mb_w + x] = qscale;
      // ff_h263_pred_motion for a 16x16 vector: left, above, above-right
      int px, py;
      auto at = [&](int xx, int yy, int c) {
        if (xx < 0 || xx >= d.mb_w || yy < 0) return 0;
        return c ? f.mvy[yy * d.mb_w + xx] : f.mvx[yy * d.mb_w + xx];
      };
      if (y == 0) {
        px = x == 0 ? 0 : at(x - 1, y, 0);
        py = x == 0 ? 0 : at(x - 1, y, 1);
      } else {
        px = mid_pred(at(x - 1, y, 0), at(x, y - 1, 0), at(x + 1, y - 1, 0));
        py = mid_pred(at(x - 1, y, 1), at(x, y - 1, 1), at(x + 1, y - 1, 1));
      }
      int mx = read_mv(b, px, v.fcode), my = read_mv(b, py, v.fcode);
      f.mvx[y * d.mb_w + x] = mx;
      f.mvy[y * d.mb_w + x] = my;
      rec[F_TYPE] = MB_INTER;
      rec[F_QP] = qscale;
      rec[F_MVX] = mx;
      rec[F_MVY] = my;
      for (int n = 0; n < 6; ++n, cbp <<= 1)
        if (cbp & 32) {
          int16_t* blk = new_block(o);
          rec[F_BLK + n] = (int32_t)(o.nblk - 1);
          read_coefs(b, t.inter, kZigzag, blk, -1);
        }
    }
  if (b.left() < 0) fail("the VOP's macroblocks run past the end of the sample");
}

// Parses one sample: its headers and its VOP (all but the macroblocks when
// ``out`` is null). Returns the VOP, or type -2 for a sample without one.
Vop parse_sample(Decoder& d, const uint8_t* data, int64_t n, Output* out) {
  Bits b(data, n);
  if (n >= 3 && (b.peek(22) == 0x20))
    fail("a short video header (H.263 baseline) sample: not decoded");
  int64_t i = 0;
  Vop v;
  v.type = -2;
  while (true) {
    while (i + 3 < n && !(data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1)) ++i;
    if (i + 3 >= n) return v;
    int code = data[i + 3];
    Bits h(data, n);
    h.pos = 8 * (i + 4);
    if (code >= 0x20 && code <= 0x2F) {
      parse_vol(d, h);
    } else if (code == 0xB0) {
      int pl = h.get(8);
      if (pl >> 4 == 14) fail("the Simple Studio profile: not decoded");
    } else if (code == 0xB5) {
      parse_visual_object(h);
    } else if (code == 0xB2) {
      parse_user_data(d, h);
    } else if (code == 0xB6) {
      if (!d.vol) fail("a VOP before any VOL header");
      check_workarounds(d);
      int type = h.get(2);
      if (type == 2) fail("a B-VOP: not decoded");
      if (type == 3) fail("an S-VOP (sprite/GMC): not decoded");
      while (h.bit()) {  // modulo_time_base
      }
      h.get(1);
      h.get(d.tib);
      h.get(1);
      if (!h.bit()) {  // vop_coded 0
        v.type = -1;
        return v;
      }
      v.type = type;
      v.rounding = type == 1 ? h.bit() : 0;
      v.dc_thr = kDcThreshold[h.get(3)];
      v.qp = h.get(5);
      if (!v.qp) fail("a VOP with quantiser 0");
      v.fcode = type == 1 ? h.get(3) : 1;
      if (!v.fcode) fail("a P-VOP with fcode 0");
      if (h.left() < 0) fail("a VOP header cut short");
      if (out) {
        decode_mbs(h, d, v, *out);
        // another VOP after this one: a packed bitstream
        for (int64_t k = (h.pos + 7) >> 3; k + 3 < n; ++k)
          if (!data[k] && !data[k + 1] && data[k + 2] == 1 && data[k + 3] == 0xB6)
            fail("two VOPs in one sample (a packed bitstream): not decoded");
      }
      return v;
    }
    i += 4;
  }
}

void copy_error(const Error& e, char* err, int errlen) {
  if (errlen > 0) snprintf(err, errlen, "%s", e.msg.c_str());
}

}  // namespace

extern "C" {

// A decoder for a track whose container fourcc is ``fourcc`` (4 bytes).
void* m4v_open(const char* fourcc) {
  Decoder* d = new Decoder();
  for (int k = 0; k < 4; ++k) {
    char c = fourcc[k];
    d->tag[k] = c >= 'a' && c <= 'z' ? (char)(c - 32) : c;
  }
  d->tag[4] = 0;
  return d;
}

void m4v_close(void* h) { delete (Decoder*)h; }

// Headers outside the samples (an MP4's esds DecoderSpecificInfo).
int m4v_config(void* h, const uint8_t* data, int64_t n, char* err, int errlen) {
  try {
    parse_sample(*(Decoder*)h, data, n, nullptr);
    return 0;
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}

// info: width, height, mb_w, mb_h of the last VOL (-1 before any)
int m4v_info(void* h, int32_t* info) {
  const Decoder& d = *(Decoder*)h;
  info[0] = d.width;
  info[1] = d.height;
  info[2] = d.mb_w;
  info[3] = d.mb_h;
  return d.vol ? 0 : -1;
}

// Parses one sample. vop: type (0 I, 1 P, -1 not coded, -2 none), rounding,
// QP, fcode. With mbs null only the headers are read; else mbs gets
// [mb_w * mb_h, 10] records (type 0 intra / 1 inter / 2 not coded, QP, the
// vector in half pels, each block's row in levels or -1), at most mb_cap
// of them, and levels up to cap blocks of 64 quantised levels in raster
// order. Returns the blocks written, or -1 with the reason in err.
int64_t m4v_parse(void* h, const uint8_t* data, int64_t n, int32_t* vop, int32_t* mbs,
                  int64_t mb_cap, int16_t* levels, int64_t cap, char* err, int errlen) {
  Decoder& d = *(Decoder*)h;
  try {
    Output o{mbs, mb_cap, levels, cap};
    Vop v = parse_sample(d, data, n, mbs ? &o : nullptr);
    vop[0] = v.type;
    vop[1] = v.rounding;
    vop[2] = v.qp;
    vop[3] = v.fcode;
    return o.nblk;
  } catch (const Error& e) {
    copy_error(e, err, errlen);
    return -1;
  }
}
}
