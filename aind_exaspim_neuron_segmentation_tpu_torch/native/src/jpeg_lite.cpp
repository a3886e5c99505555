// JPEG (ITU T.81 sequential/progressive DCT, 8- and 12-bit) decoder.
//
// The reference ingests TIFF through tifffile (reference
// img_util.py:100-121), whose compressed-strip decoding delegates to
// imagecodecs (libjpeg) for compression 7 ("new-style JPEG") pages.
// This file provides the native equivalent for io/tiff_lite.py:
// grayscale and YCbCr/RGB 3-component streams, 4:4:4 / 4:2:2 / 4:2:0 /
// 4:1:1 subsampling, restart markers, interleaved and non-interleaved
// scans, and TIFF's abbreviated-stream convention (DQT/DHT/DRI supplied
// separately via the JPEGTables tag, processed here as a prelude
// stream). Progressive mode (SOF2, T.81 G.2) decodes through
// coefficient-domain scan accumulation: DC/AC first passes and
// successive-approximation refinement (EOB runs, correction bits --
// the same algorithm as libjpeg's jdphuff.c) build per-block zigzag
// coefficients across scans, dequantized + IDCT'd once at EOI.
// Sample precision 8 (u8 output) and 12 (u16 output, T.81 extended
// sequential / progressive) are both decoded; arithmetic coding
// (SOF9+) and hierarchical modes are rejected with distinct error
// codes -- they do not appear in the scientific-TIFF corpus this
// layer targets.
//
// Error codes (negative returns):
//   -1 malformed stream / unexpected marker structure
//   -2 unsupported SOF (arithmetic/lossless/hierarchical)
//   -3 unsupported precision (only 8- and 12-bit)
//   -4 unsupported component count or sampling factors
//   -5 missing quantization/Huffman table referenced by a scan
//   -6 truncated entropy-coded data
//   -7 restart-marker desynchronization

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "common.hpp"

namespace {

struct HuffTable {
  bool present = false;
  // Canonical decode tables (T.81 F.2.2.3).
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t values[256];
  // Fast path: codes of length <= 8 resolved by one 8-bit peek.
  int16_t fast_sym[256];  // -1 = slow path
  uint8_t fast_len[256];

  void build(const uint8_t counts[16], const uint8_t* vals, int n_vals) {
    present = true;
    std::memcpy(values, vals, n_vals);
    int code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      code += counts[len - 1];
      k += counts[len - 1];
      maxcode[len] = code - 1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel: lengths > 16 never match
    for (int i = 0; i < 256; ++i) fast_sym[i] = -1;
    code = 0;
    k = 0;
    for (int len = 1; len <= 8; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        const int first = code << (8 - len);
        for (int fill = 0; fill < (1 << (8 - len)); ++fill) {
          fast_sym[first + fill] = values[k];
          fast_len[first + fill] = static_cast<uint8_t>(len);
        }
      }
      code <<= 1;
    }
  }
};

// Entropy-coded-segment bit reader: removes 0xFF00 stuffing, stops at
// any real marker (RSTn handled by the caller via resync()).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t buf = 0;
  int bits = 0;

  BitReader(const uint8_t* data, const uint8_t* e) : p(data), end(e) {}

  void fill() {
    while (bits <= 24) {
      if (p >= end || (*p == 0xFF && !(p + 1 < end && p[1] == 0x00))) {
        // End of data or a real marker: zero-pad (libjpeg convention --
        // the final MCU's last bits legitimately sit right before EOI,
        // so padding must not be an error; the caller resyncs at
        // markers).
        bits += 8;
        continue;
      }
      const uint8_t b = *p;
      p += b == 0xFF ? 2 : 1;  // 0xFF00 stuffing encodes literal 0xFF
      buf |= static_cast<uint32_t>(b) << (24 - bits);
      bits += 8;
    }
  }

  int peek8() {
    if (bits < 8) fill();
    return static_cast<int>(buf >> 24);
  }

  void consume(int n) {
    buf <<= n;
    bits -= n;
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = static_cast<int>(buf >> (32 - n));
    consume(n);
    return v;
  }

  // Byte-align and step over an expected RSTn marker. Returns the
  // marker's low nibble, or -1 if the next bytes are not RSTn.
  int resync() {
    buf = 0;
    bits = 0;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) {
      ++p;  // tolerate pre-marker pad bytes (T.81 allows 0xFF fill)
    }
    if (p + 1 >= end) return -1;
    const int n = p[1] & 0x0F;
    p += 2;
    return n;
  }
};

inline int huff_decode(BitReader& br, const HuffTable& h) {
  const int look = br.peek8();
  if (h.fast_sym[look] >= 0) {
    br.consume(h.fast_len[look]);
    return h.fast_sym[look];
  }
  int code = br.get_bits(8);
  for (int len = 8; len <= 16; ++len) {
    if (len > 8) code = (code << 1) | br.get_bits(1);
    if (code <= h.maxcode[len]) {
      return h.values[h.valptr[len] + code - h.mincode[len]];
    }
  }
  return -1;
}

// T.81 F.2.2.1 EXTEND: map magnitude-category bits to a signed value.
inline int extend(int v, int t) {
  return (t && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Separable float IDCT with precomputed cosine basis; output is
// level-shifted (+2^(P-1)) and clamped to the P-bit sample range
// (P = 8 or 12). Float accuracy sits within +-1 of the T.81 reference
// ideal (tests tolerance-match Pillow's libjpeg integer IDCT on the
// same 8-bit streams and a scipy float-IDCT oracle for 12-bit).
struct Idct {
  float basis[8][8];  // basis[x][u] = C(u)/2 * cos((2x+1)u pi/16)

  Idct() {
    for (int x = 0; x < 8; ++x) {
      for (int u = 0; u < 8; ++u) {
        const double cu = u == 0 ? 1.0 / std::sqrt(2.0) : 1.0;
        basis[x][u] = static_cast<float>(
            0.5 * cu * std::cos((2 * x + 1) * u * M_PI / 16.0));
      }
    }
  }

  void run(const int32_t coef[64], uint16_t* out, int stride, int center,
           int maxv) const {
    float tmp[64];
    for (int y = 0; y < 8; ++y) {  // rows: sum over u
      for (int x = 0; x < 8; ++x) {
        float s = 0.0f;
        for (int u = 0; u < 8; ++u) s += basis[x][u] * coef[y * 8 + u];
        tmp[y * 8 + x] = s;
      }
    }
    for (int x = 0; x < 8; ++x) {  // cols: sum over v
      for (int y = 0; y < 8; ++y) {
        float s = 0.0f;
        for (int v = 0; v < 8; ++v) s += basis[y][v] * tmp[v * 8 + x];
        const int q = static_cast<int>(std::lround(s)) + center;
        out[y * stride + x] =
            static_cast<uint16_t>(q < 0 ? 0 : (q > maxv ? maxv : q));
      }
    }
  }
};

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;          // quant table id
  int td = 0, ta = 0;  // huff table ids (set per scan)
  int dc_pred = 0;
  int plane_w = 0, plane_h = 0;  // padded to whole blocks
  std::vector<uint16_t> plane;  // P-bit samples (u8 range when P == 8)
  // Progressive mode: per-block coefficients in ZIGZAG order (scans
  // address spectral bands Ss..Se), raw (pre-quant) values accumulated
  // across scans; block (by, bx) lives at ((by * plane_w/8) + bx) * 64.
  std::vector<int32_t> coefs;
};

struct Decoder {
  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  HuffTable huff_dc[4], huff_ac[4];
  int restart_interval = 0;
  int height = 0, width = 0, ncomp = 0;
  int precision = 8;  // sample precision P (8 or 12)
  int hmax = 1, vmax = 1;
  Component comps[4];
  bool have_frame = false;
  bool progressive = false;
  uint32_t eobrun = 0;  // progressive AC end-of-band run (T.81 G.1.2.2)
  Idct idct;

  // Parse marker segments. scan_mode: false = tables-only prelude
  // (JPEGTables), true = full stream (decode scans). Returns 0 or a
  // negative error code.
  int64_t parse(const uint8_t* data, int64_t n, bool scan_mode) {
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) return -1;  // SOI
    p += 2;
    while (p + 4 <= end) {
      if (p[0] != 0xFF) return -1;
      const int marker = p[1];
      p += 2;
      if (marker == 0xD9) return 0;               // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (p + 2 > end) return -1;
      const int seg_len = (p[0] << 8) | p[1];
      if (seg_len < 2 || p + seg_len > end) return -1;
      const uint8_t* seg = p + 2;
      const int body = seg_len - 2;
      p += seg_len;
      switch (marker) {
        case 0xDB: {  // DQT
          const uint8_t* q = seg;
          while (q < seg + body) {
            const int prec = q[0] >> 4, id = q[0] & 0x0F;
            if (id > 3) return -1;
            // 64 entries of 1 or 2 bytes must fit inside the segment
            // (a truncated DQT would otherwise read past the buffer).
            if (q + 1 + (prec ? 128 : 64) > seg + body) return -1;
            ++q;
            for (int i = 0; i < 64; ++i) {
              uint16_t val;
              if (prec) {
                val = static_cast<uint16_t>((q[0] << 8) | q[1]);
                q += 2;
              } else {
                val = *q++;
              }
              qt[id][kZigzag[i]] = val;
            }
            qt_present[id] = true;
          }
          break;
        }
        case 0xC4: {  // DHT
          const uint8_t* q = seg;
          while (q + 17 <= seg + body) {
            const int cls = q[0] >> 4, id = q[0] & 0x0F;
            if (id > 3) return -1;
            const uint8_t* counts = q + 1;
            int total = 0;
            for (int i = 0; i < 16; ++i) total += counts[i];
            if (total > 256 || q + 17 + total > seg + body) return -1;
            (cls ? huff_ac[id] : huff_dc[id]).build(counts, q + 17, total);
            q += 17 + total;
          }
          break;
        }
        case 0xDD:  // DRI: 2-byte restart interval
          if (body < 2) return -1;
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        case 0xC0:
        case 0xC1:
        case 0xC2: {  // SOF0 baseline / SOF1 ext. sequential / SOF2 prog.
          if (have_frame) return -1;
          if (body < 6) return -1;
          progressive = marker == 0xC2;
          if (seg[0] != 8 && seg[0] != 12) return -3;
          precision = seg[0];
          height = (seg[1] << 8) | seg[2];
          width = (seg[3] << 8) | seg[4];
          ncomp = seg[5];
          if (ncomp < 1 || ncomp > 4 || body < 6 + 3 * ncomp) return -4;
          for (int c = 0; c < ncomp; ++c) {
            Component& comp = comps[c];
            comp.id = seg[6 + 3 * c];
            comp.h = seg[7 + 3 * c] >> 4;
            comp.v = seg[7 + 3 * c] & 0x0F;
            comp.tq = seg[8 + 3 * c];
            if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4 ||
                comp.tq > 3) {
              return -4;
            }
            hmax = comp.h > hmax ? comp.h : hmax;
            vmax = comp.v > vmax ? comp.v : vmax;
          }
          have_frame = true;
          for (int c = 0; c < ncomp; ++c) {
            Component& comp = comps[c];
            // Component raster, padded to whole 8x8 blocks AND to the
            // frame's MCU grid (interleaved scans decode edge blocks).
            const int64_t cw = (int64_t(width) * comp.h + hmax - 1) / hmax;
            const int64_t ch = (int64_t(height) * comp.v + vmax - 1) / vmax;
            const int64_t mcux = (width + 8 * hmax - 1) / (8 * hmax);
            const int64_t mcuy = (height + 8 * vmax - 1) / (8 * vmax);
            int64_t bw = (cw + 7) / 8, bh = (ch + 7) / 8;
            if (mcux * comp.h > bw) bw = mcux * comp.h;
            if (mcuy * comp.v > bh) bh = mcuy * comp.v;
            comp.plane_w = static_cast<int>(bw * 8);
            comp.plane_h = static_cast<int>(bh * 8);
            comp.plane.assign(
                static_cast<size_t>(comp.plane_w) * comp.plane_h, 0);
            if (progressive) {
              comp.coefs.assign(static_cast<size_t>(bw) * bh * 64, 0);
            }
          }
          break;
        }
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return -2;  // progressive / lossless / arithmetic
        case 0xDA: {  // SOS
          if (!scan_mode || !have_frame) return -1;
          if (body < 1) return -1;  // ns byte itself must exist
          const int ns = seg[0];
          if (ns < 1 || ns > 4 || body < 1 + 2 * ns + 3) return -1;
          int scan_comps[4];
          for (int s = 0; s < ns; ++s) {
            const int cid = seg[1 + 2 * s];
            int idx = -1;
            for (int c = 0; c < ncomp; ++c) {
              if (comps[c].id == cid) idx = c;
            }
            if (idx < 0) return -1;
            scan_comps[s] = idx;
            comps[idx].td = seg[2 + 2 * s] >> 4;
            comps[idx].ta = seg[2 + 2 * s] & 0x0F;
          }
          int64_t rc;
          if (progressive) {
            const int ss = seg[1 + 2 * ns];
            const int se = seg[2 + 2 * ns];
            const int ah = seg[3 + 2 * ns] >> 4;
            const int al = seg[3 + 2 * ns] & 0x0F;
            rc = decode_scan_prog(p, end, scan_comps, ns, ss, se, ah, al,
                                  &p);
          } else {
            rc = decode_scan(p, end, scan_comps, ns, &p);
          }
          if (rc < 0) return rc;
          break;
        }
        default:
          break;  // APPn, COM, others: skip
      }
    }
    // Tables-only streams may simply end (JPEGTables content often has
    // EOI, but tolerate its absence); full streams must hit EOI above
    // or at least have decoded a frame.
    return scan_mode && !have_frame ? -1 : 0;
  }

  int decode_block(BitReader& br, Component& c, uint16_t* dst,
                   int stride) {
    const HuffTable& hd = huff_dc[c.td];
    const HuffTable& ha = huff_ac[c.ta];
    if (!hd.present || !ha.present || !qt_present[c.tq]) return -5;
    const uint16_t* q = qt[c.tq];
    int32_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const int t = huff_decode(br, hd);
    if (t < 0 || t > 15) return -6;
    const int diff = extend(br.get_bits(t), t);
    c.dc_pred += diff;
    coef[0] = c.dc_pred * static_cast<int32_t>(q[0]);
    for (int k = 1; k < 64;) {
      const int rs = huff_decode(br, ha);
      if (rs < 0) return -6;
      const int r = rs >> 4, s = rs & 0x0F;
      if (s == 0) {
        if (r == 15) {
          k += 16;  // ZRL
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return -6;
      const int nat = kZigzag[k];
      coef[nat] = extend(br.get_bits(s), s) * static_cast<int32_t>(q[nat]);
      ++k;
    }
    idct.run(coef, dst, stride, 1 << (precision - 1),
             (1 << precision) - 1);
    return 0;
  }

  int64_t decode_scan(const uint8_t* p, const uint8_t* end,
                      const int* scan_comps, int ns, const uint8_t** out_p) {
    BitReader br(p, end);
    int64_t n_mcus, mcus_x = 0;
    if (ns == 1) {
      // Non-interleaved: MCU = one block of the single component.
      Component& c = comps[scan_comps[0]];
      const int64_t cw = (int64_t(width) * c.h + hmax - 1) / hmax;
      const int64_t ch = (int64_t(height) * c.v + vmax - 1) / vmax;
      mcus_x = (cw + 7) / 8;
      n_mcus = mcus_x * ((ch + 7) / 8);
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      n_mcus = mcus_x * ((height + 8 * vmax - 1) / (8 * vmax));
    }
    for (int s = 0; s < ns; ++s) comps[scan_comps[s]].dc_pred = 0;
    int next_rst = 0;
    for (int64_t m = 0; m < n_mcus; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        const int got = br.resync();
        if (got < 0) return -6;
        if (got != next_rst) return -7;
        next_rst = (next_rst + 1) & 7;
        for (int s = 0; s < ns; ++s) comps[scan_comps[s]].dc_pred = 0;
      }
      const int64_t my = m / mcus_x, mx = m % mcus_x;
      for (int s = 0; s < ns; ++s) {
        Component& c = comps[scan_comps[s]];
        const int bh = ns == 1 ? 1 : c.v;
        const int bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            const int64_t y0 = ns == 1 ? my * 8 : (my * c.v + by) * 8;
            const int64_t x0 = ns == 1 ? mx * 8 : (mx * c.h + bx) * 8;
            uint16_t* dst = c.plane.data() + y0 * c.plane_w + x0;
            const int rc = decode_block(br, c, dst, c.plane_w);
            if (rc < 0) return rc;
          }
        }
      }
    }
    // Step past the entropy data to the next marker for the parser.
    const uint8_t* q = br.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7))) {
      ++q;
    }
    *out_p = q;
    return 0;
  }

  // One progressive scan (T.81 G.2; algorithm and corner cases mirror
  // libjpeg jdphuff.c): DC scans (Ss == 0, interleaved or not) decode
  // the DC first pass (Ah == 0, successive-approximation shift Al) or
  // one refinement bit per block; AC scans (single-component by spec)
  // fill the spectral band [Ss, Se] with EOB-run skipping, or refine
  // already-nonzero coefficients with correction bits.
  int64_t decode_scan_prog(const uint8_t* p, const uint8_t* end,
                           const int* scan_comps, int ns, int ss, int se,
                           int ah, int al, const uint8_t** out_p) {
    if (ss > 63 || se > 63 || ss > se || al > 13 ||
        (ss == 0 && se != 0) || (ss > 0 && ns != 1)) {
      return -1;
    }
    BitReader br(p, end);
    int64_t n_units, units_x;
    if (ns == 1) {
      const Component& c0 = comps[scan_comps[0]];
      const int64_t cw = (int64_t(width) * c0.h + hmax - 1) / hmax;
      const int64_t ch = (int64_t(height) * c0.v + vmax - 1) / vmax;
      units_x = (cw + 7) / 8;
      n_units = units_x * ((ch + 7) / 8);
    } else {
      units_x = (width + 8 * hmax - 1) / (8 * hmax);
      n_units = units_x * ((height + 8 * vmax - 1) / (8 * vmax));
    }
    for (int s = 0; s < ns; ++s) comps[scan_comps[s]].dc_pred = 0;
    eobrun = 0;
    int next_rst = 0;
    for (int64_t m = 0; m < n_units; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        const int got = br.resync();
        if (got < 0) return -6;
        if (got != next_rst) return -7;
        next_rst = (next_rst + 1) & 7;
        for (int s = 0; s < ns; ++s) comps[scan_comps[s]].dc_pred = 0;
        eobrun = 0;
      }
      const int64_t uy = m / units_x, ux = m % units_x;
      if (ss == 0) {  // DC scan (the only interleavable kind)
        for (int s = 0; s < ns; ++s) {
          Component& c = comps[scan_comps[s]];
          const int bh_n = ns == 1 ? 1 : c.v;
          const int bw_n = ns == 1 ? 1 : c.h;
          for (int by = 0; by < bh_n; ++by) {
            for (int bx = 0; bx < bw_n; ++bx) {
              const int64_t bys = ns == 1 ? uy : uy * c.v + by;
              const int64_t bxs = ns == 1 ? ux : ux * c.h + bx;
              int32_t* coef =
                  c.coefs.data() + (bys * (c.plane_w / 8) + bxs) * 64;
              if (ah == 0) {
                const HuffTable& hd = huff_dc[c.td];
                if (!hd.present) return -5;
                const int t = huff_decode(br, hd);
                if (t < 0 || t > 15) return -6;
                c.dc_pred += extend(br.get_bits(t), t);
                coef[0] = c.dc_pred * (1 << al);
              } else if (br.get_bits(1)) {
                coef[0] |= 1 << al;  // refinement bit
              }
            }
          }
        }
        continue;
      }
      // AC scan: one block of the single component per unit.
      Component& c = comps[scan_comps[0]];
      int32_t* coef = c.coefs.data() + (uy * (c.plane_w / 8) + ux) * 64;
      const HuffTable& ha = huff_ac[c.ta];
      if (!ha.present) return -5;
      if (ah == 0) {  // first pass over this band
        if (eobrun > 0) {
          --eobrun;
          continue;
        }
        for (int k = ss; k <= se;) {
          const int rs = huff_decode(br, ha);
          if (rs < 0) return -6;
          const int r = rs >> 4, sbits = rs & 0x0F;
          if (sbits == 0) {
            if (r != 15) {  // EOBn: run of blocks ending here
              eobrun = (1u << r) - 1;
              if (r) eobrun += static_cast<uint32_t>(br.get_bits(r));
              break;
            }
            k += 16;  // ZRL
          } else {
            k += r;
            if (k > se) return -6;
            coef[k] = extend(br.get_bits(sbits), sbits) * (1 << al);
            ++k;
          }
        }
        continue;
      }
      // Refinement pass: correction bits for already-nonzero
      // coefficients; newly-significant coefficients carry +-(1<<Al).
      const int32_t p1 = 1 << al;
      const int32_t m1 = -(1 << al);
      int k = ss;
      if (eobrun == 0) {
        while (k <= se) {
          const int rs = huff_decode(br, ha);
          if (rs < 0) return -6;
          int r = rs >> 4;
          const int sbits = rs & 0x0F;
          int32_t newval = 0;
          if (sbits == 0) {
            if (r != 15) {
              eobrun = 1u << r;
              if (r) eobrun += static_cast<uint32_t>(br.get_bits(r));
              break;
            }
          } else {
            if (sbits != 1) return -6;  // refinement emits 1-bit cats
            newval = br.get_bits(1) ? p1 : m1;
          }
          while (k <= se) {
            int32_t& cc = coef[k];
            if (cc != 0) {
              if (br.get_bits(1) && (cc & p1) == 0) {
                cc += cc >= 0 ? p1 : m1;
              }
            } else {
              if (r == 0) break;
              --r;
            }
            ++k;
          }
          if (newval != 0 && k <= se) coef[k] = newval;
          ++k;
        }
      }
      if (eobrun > 0) {  // tail of an EOB run still refines nonzeros
        while (k <= se) {
          int32_t& cc = coef[k];
          if (cc != 0 && br.get_bits(1) && (cc & p1) == 0) {
            cc += cc >= 0 ? p1 : m1;
          }
          ++k;
        }
        --eobrun;
      }
    }
    const uint8_t* q = br.p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 &&
                            !(q[1] >= 0xD0 && q[1] <= 0xD7))) {
      ++q;
    }
    *out_p = q;
    return 0;
  }

  // Progressive finish: dequantize the accumulated zigzag coefficients
  // and IDCT every block into the component planes (the step baseline
  // scans perform inline).
  int64_t finish_progressive() {
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comps[ci];
      if (!qt_present[c.tq]) return -5;
      const uint16_t* q = qt[c.tq];
      const int bw = c.plane_w / 8, bh = c.plane_h / 8;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          const int32_t* zz =
              c.coefs.data() + (static_cast<int64_t>(by) * bw + bx) * 64;
          int32_t nat[64];
          for (int k = 0; k < 64; ++k) {
            nat[kZigzag[k]] =
                zz[k] * static_cast<int32_t>(q[kZigzag[k]]);
          }
          idct.run(nat, c.plane.data() + (by * 8) * c.plane_w + bx * 8,
                   c.plane_w, 1 << (precision - 1),
                   (1 << precision) - 1);
        }
      }
    }
    return 0;
  }

  // Upsample one component to frame resolution with libjpeg's default
  // resamplers: triangle ("fancy") filters for the 2x1-horizontal and
  // 2x2 cases -- including their exact edge special cases and rounding
  // constants -- and nearest replication for every other ratio (the
  // same selection jinit_upsampler makes). Matching libjpeg here keeps
  // the decoder within +-2 of the reference tifffile/imagecodecs
  // stack on subsampled streams, not just 4:4:4.
  std::vector<uint16_t> upsample(const Component& c) const {
    const int cw = (width * c.h + hmax - 1) / hmax;
    const int ch = (height * c.v + vmax - 1) / vmax;
    std::vector<uint16_t> up(static_cast<size_t>(width) * height);
    auto S = [&](int y, int x) -> int {
      x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
      y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
      return c.plane[static_cast<size_t>(y) * c.plane_w + x];
    };
    const bool h2 = c.h * 2 == hmax && hmax % c.h == 0;
    const bool v1 = c.v == vmax;
    const bool v2 = c.v * 2 == vmax && vmax % c.v == 0;
    if (c.h == hmax && v1) {
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
          up[static_cast<size_t>(y) * width + x] =
              static_cast<uint16_t>(S(y, x));
        }
      }
    } else if (h2 && v1) {  // h2v1 fancy: 3/4 nearer + 1/4 further
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
          const int i = x >> 1;
          const int v3 = 3 * S(y, i);
          up[static_cast<size_t>(y) * width + x] = static_cast<uint16_t>(
              (x & 1) ? (v3 + S(y, i + 1) + 2) >> 2
                      : (v3 + S(y, i - 1) + 1) >> 2);
        }
      }
    } else if (h2 && v2) {  // h2v2 fancy: 9/16, 3/16, 3/16, 1/16
      std::vector<int> colsum(cw);
      for (int y = 0; y < height; ++y) {
        const int near = y >> 1;
        const int far = (y & 1) ? near + 1 : near - 1;
        for (int i = 0; i < cw; ++i) {
          colsum[i] = 3 * S(near, i) + S(far, i);
        }
        auto C = [&](int i) {
          return colsum[i < 0 ? 0 : (i >= cw ? cw - 1 : i)];
        };
        for (int x = 0; x < width; ++x) {
          const int i = x >> 1;
          up[static_cast<size_t>(y) * width + x] = static_cast<uint16_t>(
              (x & 1) ? (3 * colsum[i] + C(i + 1) + 7) >> 4
                      : (3 * colsum[i] + C(i - 1) + 8) >> 4);
        }
      }
    } else {  // replication (libjpeg int_upsample) for 1x2, 4x1, ...
      for (int y = 0; y < height; ++y) {
        const int sy = y * c.v / vmax;
        for (int x = 0; x < width; ++x) {
          up[static_cast<size_t>(y) * width + x] =
              static_cast<uint16_t>(S(sy, x * c.h / hmax));
        }
      }
    }
    return up;
  }

  // Emit interleaved output (height x width x ncomp) from the
  // upsampled planes; color==1 converts YCbCr->RGB (BT.601 full
  // range, the JFIF convention libjpeg applies; chroma centered at
  // 2^(P-1) for P-bit samples). T = uint8_t for 8-bit streams,
  // uint16_t (native-endian) for 12-bit.
  template <typename T>
  void emit_t(int color, T* out) const {
    const int center = 1 << (precision - 1);
    const int maxv = (1 << precision) - 1;
    std::vector<std::vector<uint16_t>> planes;
    planes.reserve(ncomp);
    for (int c = 0; c < ncomp; ++c) planes.push_back(upsample(comps[c]));
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        uint16_t px[4];
        for (int c = 0; c < ncomp; ++c) {
          px[c] = planes[c][static_cast<size_t>(y) * width + x];
        }
        T* dst = out + (static_cast<int64_t>(y) * width + x) * ncomp;
        if (color == 1 && ncomp >= 3) {
          const float Y = px[0];
          const float cb = static_cast<float>(px[1] - center);
          const float cr = static_cast<float>(px[2] - center);
          const float r = Y + 1.402f * cr;
          const float g = Y - 0.344136f * cb - 0.714136f * cr;
          const float b = Y + 1.772f * cb;
          const auto clamp = [maxv](float v) {
            const int i = static_cast<int>(std::lround(v));
            return static_cast<T>(i < 0 ? 0 : (i > maxv ? maxv : i));
          };
          dst[0] = clamp(r);
          dst[1] = clamp(g);
          dst[2] = clamp(b);
          for (int c = 3; c < ncomp; ++c) dst[c] = static_cast<T>(px[c]);
        } else {
          for (int c = 0; c < ncomp; ++c) dst[c] = static_cast<T>(px[c]);
        }
      }
    }
  }

  void emit(int color, uint8_t* out) const {
    if (precision > 8) {
      emit_t(color, reinterpret_cast<uint16_t*>(out));
    } else {
      emit_t(color, out);
    }
  }
};

int64_t run(const uint8_t* data, int64_t n, const uint8_t* tables,
            int64_t nt, Decoder& dec) {
  if (tables != nullptr && nt > 0) {
    const int64_t rc = dec.parse(tables, nt, /*scan_mode=*/false);
    if (rc < 0) return rc;
  }
  return dec.parse(data, n, /*scan_mode=*/true);
}

}  // namespace

// Dimensions of a JPEG stream: info = {height, width, ncomp,
// precision}. `tables` (nullable) is a TIFF JPEGTables abbreviated
// stream. Returns 0 or a negative error code (header only -- entropy
// data is not decoded).
EXA_API int64_t exa_jpeg_info(const uint8_t* data, int64_t n,
                              const uint8_t* tables, int64_t nt,
                              int64_t* info) {
  // Frame headers precede entropy data, so parse until SOF by scanning
  // markers without decoding scans: reuse the table parser, stopping
  // at SOS.
  Decoder dec;
  if (tables != nullptr && nt > 0) {
    const int64_t rc = dec.parse(tables, nt, false);
    if (rc < 0) return rc;
  }
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) return -1;
  p += 2;
  while (p + 4 <= end) {
    if (p[0] != 0xFF) return -1;
    const int marker = p[1];
    p += 2;
    if (marker == 0xD9) break;
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    const int seg_len = (p[0] << 8) | p[1];
    if (seg_len < 2 || p + seg_len > end) return -1;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
      if (seg_len < 8) return -1;  // precision + dims + ncomp = 6 body
      const uint8_t* seg = p + 2;
      if (seg[0] != 8 && seg[0] != 12) return -3;
      info[0] = (seg[1] << 8) | seg[2];
      info[1] = (seg[3] << 8) | seg[4];
      info[2] = seg[5];
      info[3] = seg[0];
      return 0;
    }
    if (marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      return -2;
    }
    p += seg_len;
  }
  return -1;
}

// Decode a complete (or TIFF-abbreviated) baseline JPEG stream into
// caller-allocated `out` (height*width*ncomp elements, interleaved:
// u8 for 8-bit streams, native-endian u16 for 12-bit -- size by
// exa_jpeg_info's precision).
// color: 0 = emit stored component values, 1 = YCbCr->RGB, -1 = auto
// (3-component streams convert, others pass through -- libjpeg's
// default). Returns 0 or a negative error code.
EXA_API int64_t exa_jpeg_decode(const uint8_t* data, int64_t n,
                                const uint8_t* tables, int64_t nt,
                                int32_t color, uint8_t* out) {
  Decoder dec;
  const int64_t rc = run(data, n, tables, nt, dec);
  if (rc < 0) return rc;
  if (dec.progressive) {
    const int64_t rc2 = dec.finish_progressive();
    if (rc2 < 0) return rc2;
  }
  const int eff_color = color == -1 ? (dec.ncomp == 3 ? 1 : 0) : color;
  dec.emit(eff_color, out);
  return 0;
}
