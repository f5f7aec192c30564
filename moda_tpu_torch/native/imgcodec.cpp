// Image decoding and resampling for the frame reader, without an image
// library: the role cv2 plays in moda_tpu/data/frames.py (imread, resize,
// remap), with the semantics of the cv2 build the JAX package runs against
// (libjpeg-turbo for JPEG, libpng for PNG, OpenCV's resize and remap).
//
// - jpeg_size / jpeg_decode: baseline sequential JPEG (SOF0/SOF1, Huffman,
//   8-bit, 1 or 3 components, sampling factors up to 2x2, DRI restarts,
//   interleaved or per-component scans). It follows libjpeg-turbo's default
//   decode: the "islow" integer IDCT (jidctint.c) with its range limiting,
//   "fancy" triangular chroma upsampling (jdsample.c: h2v1, h1v2, h2v2, with
//   the edge rows and columns replicated as jdmainct.c does), and the
//   fixed-point YCbCr->RGB tables of jdcolor.c. Grey output is the Y plane,
//   as libjpeg's JCS_GRAYSCALE output of a YCbCr file. Progressive, lossless,
//   hierarchical and arithmetic-coded files are refused with the SOF marker.
// - png_unfilter: the five PNG row filters (None, Sub, Up, Avg, Paeth) on
//   inflated scanlines; inflate itself stays in Python's zlib.
// - resize_f32: cv2.resize on float32 images with any channel count.
//   INTER_LINEAR: half-pixel centres, border replicated, no antialiasing when
//   shrinking; INTER_NEAREST: source index floor(dst * scale).
// - resize_u8: cv2.resize INTER_LINEAR on uint8 images with any channel
//   count, in OpenCV's fixed point (not its float path): 11-bit weights
//   rounded from the float fractions, the horizontal pass in int32, the
//   vertical pass as its SIMD kernel computes it for every column,
//   ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) rounded by 2 bits.
//   An exact 2x shrink on both axes is OpenCV's INTER_AREA: the 2x2 mean
//   rounded half up.
// - remap_f32: cv2.remap with float maps and BORDER_CONSTANT 0, any channel
//   count. INTER_LINEAR: bilinear weights from the map's fractional part; as
//   in OpenCV 5, that fraction is exact for images of 1, 3 and 4 channels
//   and rounded to 1/32 pixel (INTER_TAB_SIZE, OpenCV 4's rule for every
//   count) for the others, such as 2-channel flow; a tap outside the image
//   contributes 0. INTER_NEAREST: the map rounded half to even (cvRound), 0
//   outside the image. A planar layout [C, H, W] gives per plane what
//   cv2.remap gives on each [H, W] plane alone, with the map read once.
//
// Every function is pure and reentrant: the loader's threads call them
// concurrently (ctypes releases the GIL around a call).
//
// Build: moda_tpu_torch/native/__init__.py compiles it with g++ on first use
// into moda_tpu_torch/_build/.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------------ JPEG

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct JpegError {
  std::string msg;
};

struct Huffman {
  // canonical code tables (jdhuff.c's maxcode/valoffset form)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  bool defined = false;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;   // Huffman table ids of the current scan
  int pred = 0;         // DC predictor
  int bw = 0, bh = 0;   // blocks per row / column of the padded plane
  std::vector<int16_t> coef;  // [bh][bw][64] dequantization-free coefficients
};

struct Jpeg {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart = 0;
  bool have_sof = false;
  int adobe = -1;  // Adobe APP14 transform flag, -1 when absent
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  // bit reader of the entropy-coded segment
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;
  bool header_only = false;  // parse up to the frame header, allocate nothing

  int byte() {
    if (pos >= n) throw JpegError{"unexpected end of JPEG data"};
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // entropy-coded bits; at a marker or the end, zeros (libjpeg's behaviour
  // on a truncated segment)
  void fill() {
    while (bitcnt <= 24) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          int nxt = pos + 1 < n ? data[pos + 1] : 0;
          if (nxt == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bitbuf |= static_cast<uint32_t>(b) << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    int r = static_cast<int>(bitbuf >> (32 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return r;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    if (!t.defined) throw JpegError{"scan uses an undefined Huffman table"};
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | bit();
      if (code <= t.maxcode[l]) return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    throw JpegError{"corrupt Huffman code in JPEG data"};
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }

  void read_dqt(int len) {
    int64_t end = pos + len - 2;
    while (pos < end) {
      int pq = byte();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) throw JpegError{"bad quantization table id"};
      for (int i = 0; i < 64; ++i) qt[tq][kZigzag[i]] = static_cast<uint16_t>(prec ? word() : byte());
      qt_defined[tq] = true;
    }
  }

  void read_dht(int len) {
    int64_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) throw JpegError{"bad Huffman table id"};
      Huffman& t = tc ? ac[th] : dc[th];
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        counts[l] = byte();
        total += counts[l];
      }
      if (total > 256) throw JpegError{"bad Huffman table"};
      for (int i = 0; i < total; ++i) t.vals[i] = static_cast<uint8_t>(byte());
      int code = 0, k = 0;
      for (int l = 1; l <= 16; ++l) {
        if (counts[l]) {
          t.valoffset[l] = k - code;
          code += counts[l];
          k += counts[l];
          t.maxcode[l] = code - 1;
        } else {
          t.maxcode[l] = -1;
        }
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.defined = true;
    }
  }

  void read_sof(int len, int marker) {
    if (marker != 0xC0 && marker != 0xC1) {
      char buf[160];
      const char* kind = marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE
                             ? "progressive"
                         : marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF
                             ? "lossless"
                             : "hierarchical or arithmetic-coded";
      std::snprintf(buf, sizeof buf,
                    "unsupported JPEG: SOF%d (0xFF%02X, %s); only baseline and extended "
                    "sequential Huffman (SOF0, SOF1) are decoded",
                    marker - 0xC0, marker, kind);
      throw JpegError{buf};
    }
    if (have_sof) throw JpegError{"more than one SOF marker"};
    int prec = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (prec != 8) throw JpegError{"unsupported JPEG: " + std::to_string(prec) + "-bit samples"};
    if (ncomp != 1 && ncomp != 3)
      throw JpegError{"unsupported JPEG: " + std::to_string(ncomp) + " components"};
    if (width <= 0 || height <= 0) throw JpegError{"JPEG without image size (DNL not supported)"};
    // OpenCV's default limit on decoded pixels (CV_IO_MAX_IMAGE_PIXELS)
    if (static_cast<int64_t>(width) * height > (int64_t{1} << 30))
      throw JpegError{"JPEG image too large"};
    if (len != 8 + 3 * ncomp) throw JpegError{"bad SOF length"};
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = byte();
      int hv = byte();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = byte();
      if (comp[i].h < 1 || comp[i].h > 2 || comp[i].v < 1 || comp[i].v > 2)
        throw JpegError{"unsupported JPEG sampling factors (above 2x2)"};
      if (comp[i].tq > 3) throw JpegError{"bad quantization table id"};
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    if (ncomp == 1) comp[0].h = comp[0].v = hmax = vmax = 1;  // a lone component is one block an MCU
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      comp[i].bw = mcux * comp[i].h;
      comp[i].bh = mcuy * comp[i].v;
      if (!header_only) comp[i].coef.assign(static_cast<size_t>(comp[i].bw) * comp[i].bh * 64, 0);
    }
    have_sof = true;
  }

  void decode_block(Component& c, int16_t* blk) {
    int t = decode(dc[c.td]);
    if (t > 11) throw JpegError{"corrupt DC coefficient in JPEG data"};
    int diff = t ? extend(bits(t), t) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode(ac[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;  // end of block
        k += 16;
        continue;
      }
      k += r;
      if (k > 63) throw JpegError{"corrupt AC coefficient run in JPEG data"};
      blk[kZigzag[k]] = static_cast<int16_t>(extend(bits(s), s));
      ++k;
    }
  }

  // After a restart interval: byte-align, expect RSTn, reset predictors.
  void restart_marker(Component** sc, int ns) {
    reset_bits();
    // skip to the marker
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF) break;
      ++pos;
    }
    if (pos + 1 < n && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
  }

  void read_sos(int len) {
    if (!have_sof) throw JpegError{"SOS before SOF"};
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) throw JpegError{"bad SOS header"};
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cid = byte(), tt = byte();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) throw JpegError{"SOS names an unknown component"};
      sc[i]->td = tt >> 4;
      sc[i]->ta = tt & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) throw JpegError{"bad Huffman table id"};
      sc[i]->pred = 0;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) throw JpegError{"unsupported JPEG: spectral selection"};
    reset_bits();
    int todo = restart;
    if (ns == 1) {
      // non-interleaved: one block an MCU over the component's own extent
      Component& c = *sc[0];
      int cw = (width * c.h + hmax - 1) / hmax, ch = (height * c.v + vmax - 1) / vmax;
      int nbx = (cw + 7) / 8, nby = (ch + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart && todo == 0) {
            restart_marker(sc, ns);
            todo = restart;
          }
          decode_block(c, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
          if (restart) --todo;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart && todo == 0) {
            restart_marker(sc, ns);
            todo = restart;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                int by = my * c.v + y, bx = mx * c.h + x;
                decode_block(c, &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64]);
              }
          }
          if (restart) --todo;
        }
    }
    // leave the entropy-coded segment: continue at the next marker
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      ++pos;
  }

  // parse markers; with header_only, stop after SOF
  void parse(bool header) {
    header_only = header;
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw JpegError{"not a JPEG file"};
    pos = 2;
    bool scanned = false;
    while (pos < n) {
      int b = byte();
      if (b != 0xFF) continue;  // garbage between markers
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m == 0xD9) break;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = word();
      if (len < 2 || pos + len - 2 > n) throw JpegError{"bad JPEG marker length"};
      int64_t next = pos + len - 2;
      if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xDD) {
        restart = word();
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(len, m);
        if (header_only) return;
      } else if (m == 0xCC) {
        throw JpegError{"unsupported JPEG: arithmetic-coding conditioning (DAC)"};
      } else if (m == 0xDA) {
        read_sos(len);
        scanned = true;
        continue;  // read_sos leaves pos at the next marker
      } else if (m == 0xEE && len >= 14) {
        if (std::memcmp(data + pos, "Adobe", 5) == 0) adobe = data[pos + 11];
      }
      pos = next;
    }
    if (!have_sof) throw JpegError{"JPEG without a frame header"};
    if (!header_only && !scanned) throw JpegError{"JPEG without a scan"};
  }
};

// jidctint.c's jpeg_idct_islow: 8x8 integer IDCT, output range-limited
const int kConstBits = 13, kPass1Bits = 2;
inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }
inline uint8_t idct_limit(int64_t x) {
  // libjpeg's post-IDCT table: the value masked to 10 bits, read as signed,
  // offset by 128 and clamped to [0, 255]
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, sh));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, sh));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, sh));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, sh));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, sh));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, sh));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, sh));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// jdsample.c's upsamplers, from a component plane (dw x dh valid samples,
// row stride ps) to the full-resolution plane (W x H, stride W). Rows past
// dh repeat the last one and the row above row 0 is row 0 (jdmainct.c).
void upsample(const uint8_t* p, int ps, int dw, int dh, int fh, int fv, uint8_t* out, int W,
              int H) {
  auto row = [&](int r) { return p + static_cast<size_t>(std::min(std::max(r, 0), dh - 1)) * ps; };
  std::vector<int> tmp(static_cast<size_t>(dw));
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * W;
    if (fh == 1 && fv == 1) {
      std::memcpy(o, row(y), W);
      continue;
    }
    if (fv == 1) {  // h2v1
      const uint8_t* in = row(y);
      if (dw <= 2) {
        for (int x = 0; x < W; ++x) o[x] = in[x / 2];
        continue;
      }
      std::vector<uint8_t> line(static_cast<size_t>(2 * dw));
      uint8_t* q = line.data();
      int v = in[0];
      *q++ = static_cast<uint8_t>(v);
      *q++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        v = in[c] * 3;
        *q++ = static_cast<uint8_t>((v + in[c - 1] + 1) >> 2);
        *q++ = static_cast<uint8_t>((v + in[c + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      *q++ = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      *q++ = static_cast<uint8_t>(v);
      std::memcpy(o, line.data(), W);
      continue;
    }
    // vertical factor 2: the nearer input row and the next nearer one
    int r = y / 2;
    bool upper = (y % 2) == 0;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = row(upper ? r - 1 : r + 1);
    if (fh == 1) {  // h1v2
      int bias = upper ? 1 : 2;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      continue;
    }
    // h2v2
    if (dw <= 2) {  // no fancy upsampling on narrow planes: plain replication
      for (int x = 0; x < W; ++x) o[x] = in0[x / 2];
      continue;
    }
    for (int c = 0; c < dw; ++c) tmp[c] = in0[c] * 3 + in1[c];
    std::vector<uint8_t> line(static_cast<size_t>(2 * dw));
    uint8_t* q = line.data();
    *q++ = static_cast<uint8_t>((tmp[0] * 4 + 8) >> 4);
    *q++ = static_cast<uint8_t>((tmp[0] * 3 + tmp[1] + 7) >> 4);
    for (int c = 1; c < dw - 1; ++c) {
      *q++ = static_cast<uint8_t>((tmp[c] * 3 + tmp[c - 1] + 8) >> 4);
      *q++ = static_cast<uint8_t>((tmp[c] * 3 + tmp[c + 1] + 7) >> 4);
    }
    *q++ = static_cast<uint8_t>((tmp[dw - 1] * 3 + tmp[dw - 2] + 8) >> 4);
    *q++ = static_cast<uint8_t>((tmp[dw - 1] * 4 + 7) >> 4);
    std::memcpy(o, line.data(), W);
  }
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), static_cast<size_t>(errlen - 1));
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Image size and component count of a JPEG; 0 on success, -1 with a
// message in err.
int jpeg_size(const uint8_t* data, int64_t n, int* height, int* width, int* ncomp, char* err,
              int errlen) {
  try {
    Jpeg j{data, n};
    j.parse(true);  // allocates nothing
    *height = j.height;
    *width = j.width;
    *ncomp = j.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// Decode into out [H, W, channels] uint8, channels 1 (grey = the Y plane)
// or 3 (RGB). 0 on success, -1 with a message in err.
int jpeg_decode(const uint8_t* data, int64_t n, int channels, uint8_t* out, int height, int width,
                char* err, int errlen) {
  try {
    Jpeg j{data, n};
    j.parse(false);
    if (j.height != height || j.width != width) throw JpegError{"JPEG size changed"};
    for (int i = 0; i < j.ncomp; ++i)
      if (!j.qt_defined[j.comp[i].tq]) throw JpegError{"undefined quantization table"};
    const int W = j.width, H = j.height;
    int nplanes = channels == 1 ? 1 : j.ncomp;
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(nplanes));
    for (int i = 0; i < nplanes; ++i) {
      Component& c = j.comp[i];
      int ps = c.bw * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(ps) * c.bh * 8);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], j.qt[c.tq],
                     &plane[static_cast<size_t>(by) * 8 * ps + bx * 8], ps);
      int dw = (W * c.h + j.hmax - 1) / j.hmax, dh = (H * c.v + j.vmax - 1) / j.vmax;
      full[i].resize(static_cast<size_t>(W) * H);
      upsample(plane.data(), ps, dw, dh, j.hmax / c.h, j.vmax / c.v, full[i].data(), W, H);
    }
    const size_t P = static_cast<size_t>(W) * H;
    if (channels == 1) {
      std::memcpy(out, full[0].data(), P);
      return 0;
    }
    if (nplanes == 1) {
      for (size_t p = 0; p < P; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[0][p];
      return 0;
    }
    // RGB files: an Adobe marker with transform 0, or components named R, G, B
    bool rgb = j.adobe == 0 || (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B');
    if (rgb) {
      for (size_t p = 0; p < P; ++p)
        for (int k = 0; k < 3; ++k) out[3 * p + k] = full[k][p];
      return 0;
    }
    // jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t{1} << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + half) >> 16);
      cb_b[i] = static_cast<int>((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    for (size_t p = 0; p < P; ++p) {
      int y = full[0][p], cb = full[1][p], cr = full[2][p];
      out[3 * p] = clamp255(y + cr_r[cr]);
      out[3 * p + 1] = clamp255(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * p + 2] = clamp255(y + cb_b[cb]);
    }
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory decoding JPEG");
    return -1;
  }
}

// PNG scanline unfiltering: raw holds h rows of 1 + rowbytes bytes (the
// filter type, then the filtered bytes); out gets h x rowbytes. bpp is the
// filter's byte distance (bytes per complete pixel, at least 1). Returns 0,
// or -1 for an unknown filter type.
int png_unfilter(const uint8_t* raw, int64_t h, int64_t rowbytes, int bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (rowbytes + 1);
    int ft = src[0];
    ++src;
    uint8_t* dst = out + y * rowbytes;
    const uint8_t* up = y > 0 ? out + (y - 1) * rowbytes : nullptr;
    for (int64_t x = 0; x < rowbytes; ++x) {
      int a = x >= bpp ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      dst[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

// cv2.resize of a float32 image [sh, sw, cn] to [dh, dw, cn].
// interp 0: INTER_NEAREST, 1: INTER_LINEAR.
void resize_f32(const float* src, int sh, int sw, int cn, float* dst, int dh, int dw,
                int interp) {
  const double scale_x = 1.0 / (static_cast<double>(dw) / sw);
  const double scale_y = 1.0 / (static_cast<double>(dh) / sh);
  if (interp == 0) {
    std::vector<int> xo(static_cast<size_t>(dw));
    for (int x = 0; x < dw; ++x)
      xo[x] = std::min(static_cast<int>(std::floor(x * scale_x)), sw - 1);
    for (int y = 0; y < dh; ++y) {
      int sy = std::min(static_cast<int>(std::floor(y * scale_y)), sh - 1);
      const float* s = src + static_cast<size_t>(sy) * sw * cn;
      float* d = dst + static_cast<size_t>(y) * dw * cn;
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < cn; ++k) d[x * cn + k] = s[xo[x] * cn + k];
    }
    return;
  }
  // half-pixel centres; an index past either border is clamped with weight 0
  auto coefs = [](int d, int s, double scale, std::vector<int>& idx, std::vector<float>& a) {
    idx.resize(static_cast<size_t>(d));
    a.resize(static_cast<size_t>(d));
    for (int i = 0; i < d; ++i) {
      float f = static_cast<float>((i + 0.5) * scale - 0.5);
      int si = static_cast<int>(std::floor(f));
      f -= si;
      if (si < 0) {
        f = 0.f;
        si = 0;
      }
      if (si >= s - 1) {
        f = 0.f;
        si = s - 1;
      }
      idx[i] = si;
      a[i] = f;
    }
  };
  std::vector<int> xi, yi;
  std::vector<float> xa, ya;
  coefs(dw, sw, scale_x, xi, xa);
  coefs(dh, sh, scale_y, yi, ya);
  std::vector<float> r0(static_cast<size_t>(dw) * cn), r1(static_cast<size_t>(dw) * cn);
  auto hrow = [&](int sy, float* r) {
    const float* s = src + static_cast<size_t>(sy) * sw * cn;
    for (int x = 0; x < dw; ++x) {
      int x0 = xi[x], x1 = std::min(x0 + 1, sw - 1);
      float a1 = xa[x], a0 = 1.f - a1;
      for (int k = 0; k < cn; ++k) r[x * cn + k] = s[x0 * cn + k] * a0 + s[x1 * cn + k] * a1;
    }
  };
  for (int y = 0; y < dh; ++y) {
    int y0 = yi[y], y1 = std::min(y0 + 1, sh - 1);
    float b1 = ya[y], b0 = 1.f - b1;
    hrow(y0, r0.data());
    hrow(y1, r1.data());
    float* d = dst + static_cast<size_t>(y) * dw * cn;
    for (int i = 0; i < dw * cn; ++i) d[i] = r0[i] * b0 + r1[i] * b1;
  }
}

// The source index and its weights (11 fraction bits) of each destination
// column or row, as cv2.resize computes them for INTER_LINEAR on 8-bit
// images. Columns past a border take that border's pixel with weight 1;
// rows keep their index and fraction, and the caller clamps the two rows
// read (so a border row is weighted by the two rounded weights, as in
// OpenCV). fp-contract off keeps (d + 0.5) * scale - 0.5 two roundings.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
static void linear_u8_coefs(int d, int s, bool clamp, std::vector<int>& idx,
                            std::vector<int>& a0, std::vector<int>& a1) {
  const double scale = 1.0 / (static_cast<double>(d) / s);
  idx.resize(static_cast<size_t>(d));
  a0.resize(static_cast<size_t>(d));
  a1.resize(static_cast<size_t>(d));
  for (int i = 0; i < d; ++i) {
    float f = static_cast<float>((i + 0.5) * scale - 0.5);
    int si = static_cast<int>(std::floor(f));
    f -= static_cast<float>(si);
    if (clamp && si < 0) {
      f = 0.f;
      si = 0;
    }
    if (clamp && si >= s - 1) {
      f = 0.f;
      si = s - 1;
    }
    idx[i] = si;
    // saturate_cast<short>: round half to even
    a0[i] = static_cast<int>(std::nearbyint((1.f - f) * 2048.f));
    a1[i] = static_cast<int>(std::nearbyint(f * 2048.f));
  }
}
#pragma GCC pop_options

// cv2.resize(INTER_LINEAR) of a uint8 image [sh, sw, cn] to [dh, dw, cn].
void resize_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst, int dh, int dw) {
  const size_t srow = static_cast<size_t>(sw) * cn, drow = static_cast<size_t>(dw) * cn;
  if (sw == 2 * dw && sh == 2 * dh) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* s0 = src + 2 * y * srow;
      const uint8_t* s1 = s0 + srow;
      uint8_t* d = dst + y * drow;
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < cn; ++k) {
          const size_t o = static_cast<size_t>(2 * x) * cn + k;
          d[x * cn + k] = static_cast<uint8_t>((s0[o] + s0[o + cn] + s1[o] + s1[o + cn] + 2) >> 2);
        }
    }
    return;
  }
  std::vector<int> xi, xa0, xa1, yi, ya0, ya1;
  linear_u8_coefs(dw, sw, true, xi, xa0, xa1);
  linear_u8_coefs(dh, sh, false, yi, ya0, ya1);
  std::vector<int32_t> r0(drow), r1(drow);
  auto hrow = [&](int sy, int32_t* r) {
    const uint8_t* s = src + static_cast<size_t>(sy) * srow;
    for (int x = 0; x < dw; ++x) {
      const int x0 = xi[x] * cn, x1 = std::min(xi[x] + 1, sw - 1) * cn;
      for (int k = 0; k < cn; ++k) r[x * cn + k] = s[x0 + k] * xa0[x] + s[x1 + k] * xa1[x];
    }
  };
  for (int y = 0; y < dh; ++y) {
    hrow(std::min(std::max(yi[y], 0), sh - 1), r0.data());
    hrow(std::min(std::max(yi[y] + 1, 0), sh - 1), r1.data());
    const int b0 = ya0[y], b1 = ya1[y];
    uint8_t* d = dst + y * drow;
    for (size_t i = 0; i < drow; ++i) {
      const int v = (((r0[i] >> 4) * b0) >> 16) + (((r1[i] >> 4) * b1) >> 16);
      d[i] = clamp255((v + 2) >> 2);
    }
  }
}

// cv2.remap of a float32 image through float maps mx, my [npix] with
// BORDER_CONSTANT 0. planar 0: src [sh, sw, cn] -> dst [npix, cn]; planar 1:
// src [cn, sh, sw] -> dst [cn, npix]. interp 0: INTER_NEAREST, 1:
// INTER_LINEAR; quantized: the fraction rounded to 1/32 pixel (the caller
// decides, as cv2 does by channel count).
void remap_f32(const float* src, int sh, int sw, int cn, int planar, const float* mx,
               const float* my, int64_t npix, float* dst, int interp, int quantized) {
  const int64_t cs = planar ? 1 : cn, ps = planar ? static_cast<int64_t>(sh) * sw : 1;
  const int64_t dcs = planar ? 1 : cn, dps = planar ? npix : 1;
  auto at = [&](int y, int x) { return src + (static_cast<int64_t>(y) * sw + x) * cs; };
  for (int64_t p = 0; p < npix; ++p) {
    float* d = dst + p * dcs;
    float x = mx[p], y = my[p];
    // NaN and values past the int range land outside the image
    if (!(std::fabs(x) < 2e9f && std::fabs(y) < 2e9f)) {
      for (int k = 0; k < cn; ++k) d[k * dps] = 0.f;
      continue;
    }
    if (interp == 0) {
      // cvRound: round half to even (the default rounding mode)
      long sx = std::lrint(x), sy = std::lrint(y);
      if (sx >= 0 && sx < sw && sy >= 0 && sy < sh) {
        const float* s = at(static_cast<int>(sy), static_cast<int>(sx));
        for (int k = 0; k < cn; ++k) d[k * dps] = s[k * ps];
      } else {
        for (int k = 0; k < cn; ++k) d[k * dps] = 0.f;
      }
      continue;
    }
    int x0, y0;
    float ax, ay;
    if (quantized) {
      // cvRound(x * 32): the integer part and a 1/32 step of the fraction
      long X = std::lrint(x * 32.f), Y = std::lrint(y * 32.f);
      x0 = static_cast<int>(X >> 5);
      y0 = static_cast<int>(Y >> 5);
      ax = static_cast<float>(X & 31) / 32.f;
      ay = static_cast<float>(Y & 31) / 32.f;
    } else {
      float fx0 = std::floor(x), fy0 = std::floor(y);
      x0 = static_cast<int>(fx0);
      y0 = static_cast<int>(fy0);
      ax = x - fx0;
      ay = y - fy0;
    }
    const float w0 = (1.f - ay) * (1.f - ax), w1 = (1.f - ay) * ax, w2 = ay * (1.f - ax),
                w3 = ay * ax;
    if (x0 >= 0 && x0 + 1 < sw && y0 >= 0 && y0 + 1 < sh) {
      const float* s0 = at(y0, x0);
      const float* s1 = at(y0 + 1, x0);
      for (int k = 0; k < cn; ++k) {
        const int64_t o = k * ps;
        d[k * dps] = s0[o] * w0 + s0[o + cs] * w1 + s1[o] * w2 + s1[o + cs] * w3;
      }
      continue;
    }
    // a tap outside the image contributes 0
    const float w[4] = {w0, w1, w2, w3};
    const int xs[4] = {x0, x0 + 1, x0, x0 + 1}, ys[4] = {y0, y0, y0 + 1, y0 + 1};
    for (int k = 0; k < cn; ++k) d[k * dps] = 0.f;
    for (int t = 0; t < 4; ++t) {
      if (xs[t] < 0 || xs[t] >= sw || ys[t] < 0 || ys[t] >= sh) continue;
      const float* s = at(ys[t], xs[t]);
      for (int k = 0; k < cn; ++k) d[k * dps] += s[k * ps] * w[t];
    }
  }
}

}  // extern "C"
