// Baseline JPEG codec for the host data path, with a plain C interface.
//
// It computes what libjpeg-turbo 3.1 computes (the library that OpenCV's
// cv2.imread / cv2.imdecode / cv2.imencode link), bit for bit:
//   decoder  sequential Huffman (SOF0, SOF1) and progressive Huffman (SOF2:
//            DC first and refinement scans, AC first and refinement scans
//            with EOB runs, jdphuff.c), 8-bit, 1, 3 or 4 components, any
//            integral sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1), restart
//            intervals, interleaved or not, Huffman tables redefined between
//            scans; the whole stream is read before output, as
//            jpeg_start_decompress reads a multi-scan file; the islow IDCT
//            (jidctint.c), the fancy upsampling of jdsample.c (h2v1, h1v2,
//            h2v2 with their rounding biases, replication otherwise), the
//            fixed-point YCbCr->RGB tables of jdcolor.c and its YCCK->CMYK
//            conversion; output BGR or gray as OpenCV asks for it
//            (JCS_EXT_BGR / JCS_GRAYSCALE, and for 4 components JCS_CMYK
//            through OpenCV's icvCvt_CMYK2BGR_8u_C4C3R /
//            icvCvt_CMYK2Gray_8u_C4C1R of Adobe's inverted CMYK), and the
//            EXIF orientation tag for the caller to apply.
//   encoder  baseline, the Annex K Huffman tables, IJG quality scaling
//            (jcparam.c), the fixed-point RGB->YCbCr of jccolor.c, the
//            downsamplers of jcsample.c, the islow forward DCT (jfdctint.c)
//            and libjpeg-turbo's reciprocal quantization (jcdctmgr.c, 16-bit
//            DCT elements as in its SIMD build), with the JFIF APP0 header
//            and the marker order of jcmarker.c.
// Arithmetic-coded, 12-bit, lossless and hierarchical streams are refused as
// unsupported, and so is a progressive stream that leaves one of the first
// ten coefficients of a component unrefined, which libjpeg would output
// through its block smoothing (jdcoefct.c decompress_smooth_data). No state
// is global: every call owns its buffers, so loader threads call it at once.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (no -ffast-math, no -march=native:
// the codec is integer code and gives the same bytes on every x86-64 host).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0, kCorrupt = 1, kUnsupported = 2;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Fail{code, msg}; }

// zigzag position -> natural (row-major) index; 16 extra entries of 63 catch
// a run length that overshoots in a corrupt stream, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// islow DCT constants (jidctint.c / jfdctint.c), CONST_BITS 13
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                  F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// post-IDCT range limit: the value centred on 0, masked to 10 bits, as
// IDCT_range_limit of jdmaster.c (a wrapped value past +-512 folds back)
inline uint8_t idct_limit(int64_t x) {
  int v = int(x) & 1023;
  if (v < 128) return uint8_t(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return uint8_t(v - 896);
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// fixed-point colour tables, SCALEBITS 16 (jdcolor.c, jccolor.c)
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
inline int64_t fix(double x) { return int64_t(x * (1 << kScaleBits) + 0.5); }

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t rgb_ycc[8 * 256];  // R_Y G_Y B_Y R_CB G_CB B_CB(=R_CR) G_CR B_CR
  ColorTables() {
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
      rgb_ycc[0 * 256 + i] = fix(0.29900) * i;
      rgb_ycc[1 * 256 + i] = fix(0.58700) * i;
      rgb_ycc[2 * 256 + i] = fix(0.11400) * i + kOneHalf;
      rgb_ycc[3 * 256 + i] = -fix(0.16874) * i;
      rgb_ycc[4 * 256 + i] = -fix(0.33126) * i;
      rgb_ycc[5 * 256 + i] = fix(0.50000) * i + (int64_t(128) << kScaleBits) + kOneHalf - 1;
      rgb_ycc[6 * 256 + i] = -fix(0.41869) * i;
      rgb_ycc[7 * 256 + i] = -fix(0.08131) * i;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables tables;  // built once, read-only, thread-safe init
  return tables;
}

inline int rgb_to_y(const ColorTables& t, int r, int g, int b) {
  return int((t.rgb_ycc[r] + t.rgb_ycc[256 + g] + t.rgb_ycc[512 + b]) >> kScaleBits);
}

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int64_t maxcode[18] = {};
  int valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 = longer code

  void derive() {  // jpeg_make_d_derived_tbl
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int numsymbols = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (p < numsymbols) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (int64_t(code) >= (int64_t(1) << si)) fail(kCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFFL;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--)
          look[lookbits++] = uint16_t((l << 8) | vals[p]);
      }
    }
    defined = true;
  }
};

// Entropy-coded data reader: unstuffs 0xFF00, stops at a marker and then
// feeds zero bits, counting them, so that reading past the real data is seen.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0, fake = 0;
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (d[pos] != 0xFF) {
          byte = d[pos++];
        } else if (pos + 1 < n && d[pos + 1] == 0x00) {
          byte = 0xFF;
          pos += 2;
        } else {
          at_marker = true;
        }
      }
      if (at_marker) fake += 8;
      acc |= uint64_t(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (nbits < k) fill();
    return uint32_t(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    nbits -= k;
    if (nbits < fake) fail(kCorrupt, "premature end of the entropy-coded data");
  }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = int(peek(k));
    skip(k);
    return v;
  }
  // drop the bits left in the buffer and any unread bytes before the marker
  void reset_to_marker() {
    acc = 0;
    nbits = fake = 0;
    at_marker = false;
  }
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  uint32_t look = br.peek(kLookBits);
  int entry = t.look[look];
  if (entry) {
    br.skip(entry >> 8);
    return entry & 0xFF;
  }
  int l = kLookBits + 1;
  int64_t code = br.peek(l);
  while (l <= 16 && code > t.maxcode[l]) {
    l++;
    code = br.peek(l);
  }
  if (l > 16) fail(kCorrupt, "corrupt Huffman code");
  br.skip(l);
  return t.vals[(t.valoffset[l] + int(code)) & 0xFF];
}

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks holding the component's samples
  int bw_pad = 0, bh_pad = 0;  // blocks the interleaved MCUs cover
  int dw = 0, dh = 0;          // downsampled width and height in samples
  int dc_pred = 0;
  bool latched = false;
  uint16_t q[64] = {};
  std::vector<int16_t> coef;   // bh_pad x bw_pad blocks of 64, natural order
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64] = {};
  bool qt_def[4] = {};
  HuffTable dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  int restart_interval = 0, orientation = 1;
  bool frame = false, progressive = false, saw_jfif = false, saw_adobe = false, any_scan = false;
  int adobe_transform = 0;
  // the current scan's spectral selection and successive approximation, and
  // the progressive decoder's end-of-band run
  int ss = 0, se = 63, ah = 0, al = 0, eobrun = 0;
  // a component's coefficients by zigzag index: the Al of the last scan that
  // coded it, -1 before any (cinfo->coef_bits)
  int coef_bits[4][64];

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {
    for (auto& row : coef_bits)
      for (int& b : row) b = -1;
  }

  int u8() {
    if (pos >= n) fail(kCorrupt, "premature end of the JPEG stream");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {  // skips fill bytes and any garbage before a marker
    for (;;) {
      int c = u8();
      if (c != 0xFF) continue;
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8(), prec = pq_tq >> 4, id = pq_tq & 15;
      if (id > 3 || prec > 1) fail(kCorrupt, "bad DQT segment");
      for (int k = 0; k < 64; k++) qt[id][kNatural[k]] = uint16_t(prec ? u16() : u8());
      qt_def[id] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8(), cls = tc_th >> 4, id = tc_th & 15;
      if (cls > 1 || id > 3) fail(kCorrupt, "bad DHT segment");
      HuffTable& t = cls ? ac[id] : dc[id];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; l++) count += (t.bits[l] = uint8_t(u8()));
      if (count > 256 || pos + count > end) fail(kCorrupt, "bad DHT segment");
      std::memset(t.vals, 0, sizeof(t.vals));
      for (int i = 0; i < count; i++) t.vals[i] = uint8_t(u8());
      t.derive();
    }
  }

  void read_sof(size_t end, bool is_progressive) {
    if (frame) fail(kCorrupt, "two SOF markers");
    progressive = is_progressive;
    int precision = u8();
    if (precision != 8) fail(kUnsupported, std::to_string(precision) + "-bit JPEG (8-bit samples only)");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail(kUnsupported, "a frame height given by a DNL marker");
    if (width == 0) fail(kCorrupt, "a frame of width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(kUnsupported, "a JPEG of " + std::to_string(ncomp) + " components");
    if (pos + 3 * size_t(ncomp) > end) fail(kCorrupt, "bad SOF segment");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(kCorrupt, "bad sampling factors");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail(kCorrupt, "fractional sampling factors");
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.bh = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.bw_pad = mcux * c.h;
      c.bh_pad = mcuy * c.v;
      c.coef.assign(size_t(c.bw_pad) * c.bh_pad * 64, 0);
    }
    frame = true;
  }

  void read_app(int marker, size_t end) {
    size_t len = end - pos;
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && len > 6 && std::memcmp(p, "Exif\0\0", 6) == 0 && orientation == 1)
      orientation = exif_orientation(p + 6, len - 6);
  }

  static int exif_orientation(const uint8_t* t, size_t len) {
    if (len < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto r16 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(t[o] | (t[o + 1] << 8)) : uint32_t((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (r16(o) | (r16(o + 2) << 16)) : ((r16(o) << 16) | r16(o + 2));
    };
    if (r16(2) != 42) return 1;
    size_t ifd = r32(4);
    if (ifd + 2 > len) return 1;
    uint32_t count = r16(ifd);
    for (uint32_t i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > len) break;
      if (r16(e) == 0x0112) {
        uint32_t v = r16(e + 8);
        return (v >= 1 && v <= 8) ? int(v) : 1;
      }
    }
    return 1;
  }

  void read_sos(size_t end) {
    if (!frame) fail(kCorrupt, "SOS before SOF");
    int ns = u8();
    if (ns < 1 || ns > 4 || pos + 2 * size_t(ns) + 3 > end) fail(kCorrupt, "bad SOS segment");
    Component* sc[4];
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tables = u8();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == cid) c = &comp[k];
      if (!c) fail(kCorrupt, "SOS names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) fail(kCorrupt, "bad SOS table numbers");
      sc[i] = c;
      blocks_in_mcu += c->h * c->v;
    }
    ss = u8();
    se = u8();
    int ahal = u8();
    ah = ahal >> 4;
    al = ahal & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || ahal != 0) fail(kCorrupt, "bad spectral selection in a sequential scan");
    } else {  // the checks of jdphuff.c start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13 || bad) fail(kCorrupt, "bad progression parameters");
    }
    if (ns > 1 && blocks_in_mcu > 10) fail(kCorrupt, "too many blocks in an MCU");
    pos = end;
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      // a sequential scan and a DC first scan read the DC table, an AC scan
      // the AC table, a DC refinement none
      bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss != 0;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        fail(kCorrupt, "a scan uses an undefined Huffman table");
      if (!c->latched) {  // latch_quant_tables: a component's table is read at its first scan
        if (!qt_def[c->tq]) fail(kCorrupt, "a scan uses an undefined quantization table");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      c->dc_pred = 0;
      if (progressive)
        for (int k = ss; k <= se; k++) coef_bits[c - comp][k] = al;
    }
    eobrun = 0;
    decode_scan(sc, ns);
    any_scan = true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const HuffTable& dct = dc[c.td];
    const HuffTable& act = ac[c.ta];
    int s = decode_huff(br, dct);
    if (s) {
      if (s > 15) fail(kCorrupt, "bad DC difference size");
      s = extend(br.get(s), s);
    }
    c.dc_pred += s;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // DC first scan (jdphuff.c decode_mcu_DC_first): the difference, scaled by Al
  void decode_dc_first(BitReader& br, Component& c, int16_t* blk) {
    int s = decode_huff(br, dc[c.td]);
    if (s) {
      if (s > 15) fail(kCorrupt, "bad DC difference size");
      s = extend(br.get(s), s);
    }
    c.dc_pred += s;
    blk[0] = int16_t(int(unsigned(c.dc_pred) << al));
  }

  // DC refinement (decode_mcu_DC_refine): one bit at position Al
  void decode_dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  // AC first scan of one component (decode_mcu_AC_first): the band Ss..Se
  // scaled by Al, or one block of an end-of-band run
  void decode_ac_first(BitReader& br, const Component& c, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffTable& act = ac[c.ta];
    for (int k = ss; k <= se; k++) {
      int rs = decode_huff(br, act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(int(unsigned(extend(br.get(s), s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {  // EOBr: a run of 2^r + r appended bits blocks, this one included
        eobrun = (1 << r) + br.get(r) - 1;
        break;
      }
    }
  }

  // AC refinement (decode_mcu_AC_refine): correction bits for the nonzero
  // coefficients of the band, new coefficients of +-2^Al, end-of-band runs
  void decode_ac_refine(BitReader& br, const Component& c, int16_t* blk) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0) coef = int16_t(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      const HuffTable& act = ac[c.ta];
      for (; k <= se; k++) {
        int rs = decode_huff(br, act);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a newly nonzero coefficient; its size is 1 in a valid stream
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + br.get(r);
          break;
        }
        // pass the nonzero coefficients (correcting each) and r zero ones
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {  // the rest of the band: correction bits only
      for (; k <= se; k++) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  void decode_any(BitReader& br, Component& c, int16_t* blk) {
    if (!progressive) decode_block(br, c, blk);
    else if (ss == 0 && ah == 0) decode_dc_first(br, c, blk);
    else if (ss == 0) decode_dc_refine(br, blk);
    else if (ah == 0) decode_ac_first(br, c, blk);
    else decode_ac_refine(br, c, blk);
  }

  void decode_scan(Component** sc, int ns) {
    BitReader br(d, n, pos);
    int restarts_to_go = restart_interval, next_rst = 0;
    auto mcu_restart = [&]() {
      if (!restart_interval) return;
      if (restarts_to_go == 0) {
        br.reset_to_marker();
        size_t p = br.pos;
        while (p < n && d[p] != 0xFF) p++;  // garbage before the marker
        while (p < n && d[p] == 0xFF) p++;
        if (p >= n || d[p] != 0xD0 + next_rst) fail(kCorrupt, "missing or wrong restart marker");
        br.pos = p + 1;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++) {
          mcu_restart();
          decode_any(br, c, &c.coef[(size_t(by) * c.bw_pad + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          mcu_restart();
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int yy = 0; yy < c.v; yy++)
              for (int xx = 0; xx < c.h; xx++) {
                size_t b = size_t(my * c.v + yy) * c.bw_pad + size_t(mx * c.h + xx);
                decode_any(br, c, &c.coef[b * 64]);
              }
          }
        }
    }
    pos = br.pos;  // the marker after the scan (fill bits before it dropped)
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail(kCorrupt, "not a JPEG stream (no SOI)");
    pos = 2;
    for (;;) {
      if (pos >= n) fail(kCorrupt, "premature end of the JPEG stream (no EOI)");
      int m = next_marker();
      if (m == 0xD9) {
        if (!any_scan) fail(kCorrupt, "EOI before any scan");
        if (progressive && block_smoothing()) {
          fail(kUnsupported, "a progressive JPEG whose scans leave one of the first ten "
                             "coefficients unrefined (libjpeg's block smoothing)");
        }
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t len = size_t(u16());
      if (len < 2 || pos + len - 2 > n) fail(kCorrupt, "a marker segment runs past the end");
      size_t end = pos + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: read_sof(end, false); break;
        case 0xC2: read_sof(end, true); break;
        case 0xC3: fail(kUnsupported, "lossless JPEG");
        case 0xC5: case 0xC6: case 0xC7: fail(kUnsupported, "hierarchical JPEG");
        case 0xC9: case 0xCA: case 0xCB: fail(kUnsupported, "arithmetic-coded JPEG");
        case 0xCD: case 0xCE: case 0xCF: fail(kUnsupported, "hierarchical arithmetic-coded JPEG");
        case 0xC4: read_dht(end); break;
        case 0xCC: fail(kUnsupported, "arithmetic-coded JPEG");
        case 0xDB: read_dqt(end); break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA: read_sos(end); continue;  // pos now at the marker after the scan
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m, end);
          break;  // COM, DNL, DHP, EXP, JPGn: skipped
      }
      pos = end;
    }
  }

  // whether libjpeg would output through decompress_smooth_data
  // (jdcoefct.c smoothing_ok): every component's quantization table latched
  // with nonzero DC and first nine AC values, its DC at least partly known,
  // and some component with one of the zigzag coefficients 1..9 not fully
  // refined. A complete scan script never meets it.
  bool block_smoothing() const {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      if (!comp[i].latched) return false;
      for (int p : kPos)
        if (comp[i].q[p] == 0) return false;
      if (coef_bits[i][0] < 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || coef_bits[i][k] != 0;
    }
    return useful;
  }

  // islow IDCT of one block into an 8x8 window of `out` (jidctint.c)
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
    int64_t ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int64_t* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int64_t dcval = int64_t(ip[0]) * qp[0] * (1 << kPass1Bits);
        for (int k = 0; k < 8; k++) wp[8 * k] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      wp[0] = int(descale(tmp10 + tmp3, sh));
      wp[56] = int(descale(tmp10 - tmp3, sh));
      wp[8] = int(descale(tmp11 + tmp2, sh));
      wp[48] = int(descale(tmp11 - tmp2, sh));
      wp[16] = int(descale(tmp12 + tmp1, sh));
      wp[40] = int(descale(tmp12 - tmp1, sh));
      wp[24] = int(descale(tmp13 + tmp0, sh));
      wp[32] = int(descale(tmp13 - tmp0, sh));
    }
    for (int row = 0; row < 8; row++) {
      const int64_t* wp = ws + 8 * row;
      uint8_t* op = out + row * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
        for (int k = 0; k < 8; k++) op[k] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits), tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits + kPass1Bits + 3;
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

  // the component's samples: bh*8 rows of bw*8 columns
  std::vector<uint8_t> component_plane(const Component& c) const {
    size_t stride = size_t(c.bw) * 8;
    std::vector<uint8_t> plane(stride * size_t(c.bh) * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(&c.coef[(size_t(by) * c.bw_pad + bx) * 64], c.q,
                   &plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride);
    return plane;
  }

  // the component upsampled to width x height (jdsample.c, with the context
  // rows of jdmainct.c: the first real row above the top, the last real row
  // below the bottom)
  std::vector<uint8_t> upsampled(const Component& c) const {
    std::vector<uint8_t> plane = component_plane(c);
    const size_t stride = size_t(c.bw) * 8;
    const int hf = hmax / c.h, vf = vmax / c.v;
    std::vector<uint8_t> out(size_t(width) * height);
    auto row = [&](int y) -> const uint8_t* {
      y = y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y;
      return &plane[size_t(y) * stride];
    };
    const int dw = c.dw;
    std::vector<int> colsum(size_t(dw) + 1);
    for (int y = 0; y < height; y++) {
      uint8_t* op = &out[size_t(y) * width];
      if (hf == 1 && vf == 1) {
        std::memcpy(op, row(y), size_t(width));
      } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* ip = row(y);
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          if (!(x & 1)) op[x] = uint8_t(i == 0 ? ip[0] : (ip[i] * 3 + ip[i - 1] + 1) >> 2);
          else op[x] = uint8_t(i == dw - 1 ? ip[i] : (ip[i] * 3 + ip[i + 1] + 2) >> 2);
        }
      } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) op[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
        int i = y >> 1;
        const uint8_t* near = row(i);
        const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
        for (int k = 0; k < dw; k++) colsum[k] = near[k] * 3 + far[k];
        for (int x = 0; x < width; x++) {
          int k = x >> 1;
          if (!(x & 1)) op[x] = uint8_t(k == 0 ? (colsum[0] * 4 + 8) >> 4
                                               : (colsum[k] * 3 + colsum[k - 1] + 8) >> 4);
          else op[x] = uint8_t(k == dw - 1 ? (colsum[k] * 4 + 7) >> 4
                                           : (colsum[k] * 3 + colsum[k + 1] + 7) >> 4);
        }
      } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
        const uint8_t* ip = row(y / vf);
        for (int x = 0; x < width; x++) op[x] = ip[x / hf];
      }
    }
    return out;
  }

  // OpenCV's CMYK -> BGR and CMYK -> gray of the inverted (Adobe) CMYK that
  // libjpeg outputs (icvCvt_CMYK2BGR_8u_C4C3R, icvCvt_CMYK2Gray_8u_C4C1R)
  static inline int cmyk_channel(int x, int k) { return k - (((255 - x) * k) >> 8); }

  // 4 components: CMYK, or YCCK (Adobe transform other than 0) converted to
  // CMYK first (jdcolor.c ycck_cmyk_convert)
  void output_cmyk(bool gray, uint8_t* out) const {
    const size_t npix = size_t(width) * height;
    const ColorTables& t = color_tables();
    const bool ycck = saw_adobe && adobe_transform != 0;
    std::vector<uint8_t> c0 = upsampled(comp[0]), c1 = upsampled(comp[1]), c2 = upsampled(comp[2]),
                         c3 = upsampled(comp[3]);
    for (size_t i = 0; i < npix; i++) {
      int c = c0[i], m = c1[i], y = c2[i], k = c3[i];
      if (ycck) {
        int luma = c, cb = m, cr = y;
        c = clamp255(255 - (luma + t.cr_r[cr]));
        m = clamp255(255 - (luma + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits)));
        y = clamp255(255 - (luma + t.cb_b[cb]));
      }
      int r = cmyk_channel(c, k), g = cmyk_channel(m, k), b = cmyk_channel(y, k);
      if (gray) {
        out[i] = uint8_t((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
      } else {
        out[3 * i] = uint8_t(b);
        out[3 * i + 1] = uint8_t(g);
        out[3 * i + 2] = uint8_t(r);
      }
    }
  }

  // RGB (colour transform 0) or YCbCr
  bool is_rgb() const {
    if (ncomp != 3 || saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return false;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  void output(bool gray, uint8_t* out) const {
    const size_t npix = size_t(width) * height;
    const ColorTables& t = color_tables();
    if (ncomp == 4) {
      output_cmyk(gray, out);
      return;
    }
    if (ncomp == 1 || (gray && !is_rgb())) {  // the Y plane; replicated for colour
      std::vector<uint8_t> y = upsampled(comp[0]);
      if (gray) {
        std::memcpy(out, y.data(), npix);
      } else {
        for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      }
      return;
    }
    std::vector<uint8_t> c0 = upsampled(comp[0]), c1 = upsampled(comp[1]), c2 = upsampled(comp[2]);
    if (is_rgb()) {
      for (size_t i = 0; i < npix; i++) {
        if (gray) out[i] = uint8_t(rgb_to_y(t, c0[i], c1[i], c2[i]));
        else out[3 * i] = c2[i], out[3 * i + 1] = c1[i], out[3 * i + 2] = c0[i];
      }
      return;
    }
    for (size_t i = 0; i < npix; i++) {  // ycc_rgb_convert, written as BGR
      int y = c0[i], cb = c1[i], cr = c2[i];
      out[3 * i + 2] = clamp255(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
      out[3 * i + 0] = clamp255(y + t.cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

const uint8_t kStdLumaQuant[64] = {  // natural order (jcparam.c)
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K tables (jstdhuff.c): bits[0] unused, then counts of lengths 1..16
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {  // jpeg_make_c_derived_tbl
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint32_t code[256] = {};
  uint8_t size[256] = {};
  EncTable(const uint8_t* b, const uint8_t* v) : bits(b), vals(v), nvals(0) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    nvals = p;
    int c = 0, si = huffsize[0];
    p = 0;
    while (p < nvals) {
      while (p < nvals && huffsize[p] == si) huffcode[p++] = c++;
      c <<= 1;
      si++;
    }
    for (p = 0; p < nvals; p++) {
      code[vals[p]] = uint32_t(huffcode[p]);
      size[vals[p]] = uint8_t(huffsize[p]);
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with ones
    if (nbits > 0) put(0x7F, 7);
    nbits = 0;
    acc = 0;
  }
};

struct EncComponent {
  int id = 0, h = 1, v = 1, tq = 0, tbl = 0;
  int bw = 0, bh = 0;           // width_in_blocks, height_in_blocks
  int cols = 0, rows = 0;       // the padded, downsampled plane
  std::vector<uint8_t> plane;
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

// libjpeg-turbo's compute_reciprocal for 16-bit DCT elements
void reciprocal(uint16_t divisor, uint16_t* recip, uint16_t* corr, int* shift) {
  int b = 0;
  while ((1 << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = uint32_t((uint64_t(1) << r) / divisor);
  uint32_t fr = uint32_t((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  *recip = uint16_t(fq);
  *corr = uint16_t(c);
  *shift = r;
}

// islow forward DCT (jfdctint.c) of centred samples, in place
void fdct_islow(int* data) {
  for (int row = 0; row < 8; row++) {
    int* p = data + 8 * row;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[2] = int(descale(z1 + tmp13 * F0_765, kConstBits - kPass1Bits));
    p[6] = int(descale(z1 + tmp12 * -F1_847, kConstBits - kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, kConstBits - kPass1Bits));
    p[5] = int(descale(tmp5 + z2 + z4, kConstBits - kPass1Bits));
    p[3] = int(descale(tmp6 + z2 + z3, kConstBits - kPass1Bits));
    p[1] = int(descale(tmp7 + z1 + z4, kConstBits - kPass1Bits));
  }
  for (int col = 0; col < 8; col++) {
    int* p = data + col;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[16] = int(descale(z1 + tmp13 * F0_765, kConstBits + kPass1Bits));
    p[48] = int(descale(z1 + tmp12 * -F1_847, kConstBits + kPass1Bits));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, kConstBits + kPass1Bits));
    p[40] = int(descale(tmp5 + z2 + z4, kConstBits + kPass1Bits));
    p[24] = int(descale(tmp6 + z2 + z3, kConstBits + kPass1Bits));
    p[8] = int(descale(tmp7 + z1 + z4, kConstBits + kPass1Bits));
  }
}

std::vector<uint8_t> encode(const uint8_t* img, int width, int height, int channels,
                            int quality, int h0, int v0, int restart_interval) {
  if (width < 1 || height < 1 || width > 65500 || height > 65500)
    fail(kCorrupt, "image size out of the JPEG range");
  if (channels != 1 && channels != 3) fail(kCorrupt, "1 or 3 channels expected");
  if (h0 < 1 || h0 > 4 || v0 < 1 || v0 > 4) fail(kCorrupt, "bad sampling factors");
  if (restart_interval < 0 || restart_interval > 65535) fail(kCorrupt, "bad restart interval");
  quality = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qtab[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long((t ? kStdChromaQuant : kStdLumaQuant)[i]) * scale + 50L) / 100L;
      qtab[t][i] = uint16_t(v <= 0 ? 1 : v > 255 ? 255 : v);
    }
  const int ncomp = channels;
  const int hmax = ncomp == 1 ? 1 : h0, vmax = ncomp == 1 ? 1 : v0;
  std::vector<EncComponent> comps;
  for (int i = 0; i < ncomp; i++) {
    EncComponent c;
    c.id = i + 1;
    c.h = i == 0 ? hmax : 1;
    c.v = i == 0 ? vmax : 1;
    c.tq = c.tbl = i == 0 ? 0 : 1;
    c.bw = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
    c.bh = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
    comps.push_back(std::move(c));
  }
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  // colour conversion at full size, rows padded to a whole row group by
  // replication (jcprepct.c expand_bottom_edge)
  const int rows_full = (height + vmax - 1) / vmax * vmax;
  const ColorTables& t = color_tables();
  std::vector<std::vector<uint8_t>> full(ncomp, std::vector<uint8_t>(size_t(width) * rows_full));
  for (int y = 0; y < rows_full; y++) {
    const uint8_t* ip = img + size_t(y < height ? y : height - 1) * width * channels;
    size_t o = size_t(y) * width;
    if (ncomp == 1) {
      std::memcpy(&full[0][o], ip, size_t(width));
      continue;
    }
    for (int x = 0; x < width; x++) {
      int b = ip[3 * x], g = ip[3 * x + 1], r = ip[3 * x + 2];
      const int64_t* tb = t.rgb_ycc;
      full[0][o + x] = uint8_t((tb[r] + tb[256 + g] + tb[512 + b]) >> kScaleBits);
      full[1][o + x] = uint8_t((tb[768 + r] + tb[1024 + g] + tb[1280 + b]) >> kScaleBits);
      full[2][o + x] = uint8_t((tb[1280 + r] + tb[1536 + g] + tb[1792 + b]) >> kScaleBits);
    }
  }

  // downsampling (jcsample.c) after expand_right_edge, then rows padded to
  // whole iMCU rows by replicating the last one
  for (int ci = 0; ci < ncomp; ci++) {
    EncComponent& c = comps[ci];
    const int hf = hmax / c.h, vf = vmax / c.v;
    c.cols = c.bw * 8;
    const int ds_rows = rows_full / vf;
    c.rows = mcuy * c.v * 8;
    c.plane.assign(size_t(c.cols) * c.rows, 0);
    auto in = [&](int y, int x) -> int {  // expand_right_edge: the last column repeats
      return full[ci][size_t(y) * width + size_t(x < width ? x : width - 1)];
    };
    for (int y = 0; y < ds_rows; y++) {
      uint8_t* op = &c.plane[size_t(y) * c.cols];
      if (hf == 1 && vf == 1) {
        for (int x = 0; x < c.cols; x++) op[x] = uint8_t(in(y, x));
      } else if (hf == 2 && vf == 1) {  // h2v1_downsample: bias 0, 1, 0, 1, ...
        int bias = 0;
        for (int x = 0; x < c.cols; x++) {
          op[x] = uint8_t((in(y, 2 * x) + in(y, 2 * x + 1) + bias) >> 1);
          bias ^= 1;
        }
      } else if (hf == 2 && vf == 2) {  // h2v2_downsample: bias 1, 2, 1, 2, ...
        int bias = 1;
        for (int x = 0; x < c.cols; x++) {
          op[x] = uint8_t((in(2 * y, 2 * x) + in(2 * y, 2 * x + 1) + in(2 * y + 1, 2 * x) +
                           in(2 * y + 1, 2 * x + 1) + bias) >> 2);
          bias ^= 3;
        }
      } else {  // int_downsample
        const int numpix = hf * vf;
        for (int x = 0; x < c.cols; x++) {
          int sum = 0;
          for (int v = 0; v < vf; v++)
            for (int h = 0; h < hf; h++) sum += in(y * vf + v, x * hf + h);
          op[x] = uint8_t((sum + numpix / 2) / numpix);
        }
      }
    }
    for (int y = ds_rows; y < c.rows; y++)
      std::memcpy(&c.plane[size_t(y) * c.cols], &c.plane[size_t(ds_rows - 1) * c.cols], size_t(c.cols));
  }

  // divisors: quantval << 3 for the islow DCT
  uint16_t recip[2][64], corr[2][64];
  int shift[2][64];
  for (int tb = 0; tb < 2; tb++)
    for (int i = 0; i < 64; i++) reciprocal(uint16_t(qtab[tb][i] << 3), &recip[tb][i], &corr[tb][i], &shift[tb][i]);

  EncTable dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
  EncTable dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t> o;
  o.reserve(size_t(width) * height * channels / 4 + 1024);
  // SOI, JFIF APP0 1.01, no units, density 1x1, no thumbnail
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
  for (int tb = 0; tb < (ncomp == 1 ? 1 : 2); tb++) {  // one DQT per table
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(tb));
    for (int k = 0; k < 64; k++) o.push_back(uint8_t(qtab[tb][kNatural[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(uint8_t(ncomp));
  for (const EncComponent& c : comps) {
    o.push_back(uint8_t(c.id));
    o.push_back(uint8_t((c.h << 4) | c.v));
    o.push_back(uint8_t(c.tq));
  }
  auto dht = [&](int index, const EncTable& tb) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + tb.nvals);
    o.push_back(uint8_t(index));
    o.insert(o.end(), tb.bits + 1, tb.bits + 17);
    o.insert(o.end(), tb.vals, tb.vals + tb.nvals);
  };
  dht(0x00, dcl);
  dht(0x10, acl);
  if (ncomp == 3) {
    dht(0x01, dcc);
    dht(0x11, acc);
  }
  if (restart_interval) {
    o.push_back(0xFF);
    o.push_back(0xDD);
    put16(o, 4);
    put16(o, restart_interval);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back(uint8_t(ncomp));
  for (const EncComponent& c : comps) {
    o.push_back(uint8_t(c.id));
    o.push_back(uint8_t(c.tbl ? 0x11 : 0x00));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int restarts_to_go = restart_interval, next_rst = 0;
  int block[64];
  int16_t q[64];
  auto encode_block = [&](const int16_t* blk, int& dc_pred, const EncTable& dct, const EncTable& act) {
    int temp = blk[0] - dc_pred, temp2 = temp;
    dc_pred = blk[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dct.code[nbits], dct.size[nbits]);
    if (nbits) bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int i = (r << 4) + nbits;
      bw.put(act.code[i], act.size[i]);
      bw.put(uint32_t(temp2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(act.code[0], act.size[0]);
  };
  // forward DCT and quantization of the block at (bx, by) into q
  auto make_block = [&](const EncComponent& c, int bx, int by) {
    for (int yy = 0; yy < 8; yy++) {
      const uint8_t* ip = &c.plane[size_t(by * 8 + yy) * c.cols + size_t(bx) * 8];
      for (int xx = 0; xx < 8; xx++) block[8 * yy + xx] = int(ip[xx]) - 128;
    }
    fdct_islow(block);
    for (int i = 0; i < 64; i++) {  // quantize with 16-bit DCT elements
      int tb = c.tq;
      int v = int(int16_t(block[i]));
      bool neg = v < 0;
      uint32_t a = uint32_t(neg ? -v : v) & 0xFFFF;
      uint32_t prod = ((a + corr[tb][i]) & 0xFFFF) * uint32_t(recip[tb][i]);
      int res = int(uint16_t(prod >> shift[tb][i]));
      q[i] = int16_t(neg ? -res : res);
    }
  };
  std::vector<int16_t> mcu_blocks(64 * 10);
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          bw.flush();
          o.push_back(0xFF);
          o.push_back(uint8_t(0xD0 + next_rst));
          last_dc[0] = last_dc[1] = last_dc[2] = 0;
        }
      }
      int blkn = 0;
      for (int ci = 0; ci < ncomp; ci++) {
        const EncComponent& c = comps[ci];
        for (int yy = 0; yy < c.v; yy++) {
          int by = my * c.v + yy;
          for (int xx = 0; xx < c.h; xx++) {
            int bx = mx * c.h + xx;
            int16_t* dst = &mcu_blocks[size_t(blkn) * 64];
            if (by < c.bh && bx < c.bw) {
              make_block(c, bx, by);
              std::memcpy(dst, q, sizeof(q));
            } else {  // dummy block (jccoefct.c): zero AC and a copied DC
              std::memset(dst, 0, 64 * sizeof(int16_t));
              // past the right edge: the DC of the block to its left; in a
              // row past the bottom: the DC of the last block of the row above
              dst[0] = by < c.bh ? dst[-64] : mcu_blocks[size_t(blkn - xx - 1) * 64];
            }
            blkn++;
          }
        }
      }
      blkn = 0;
      for (int ci = 0; ci < ncomp; ci++) {
        const EncComponent& c = comps[ci];
        for (int k = 0; k < c.h * c.v; k++, blkn++)
          encode_block(&mcu_blocks[size_t(blkn) * 64], last_dc[ci], c.tbl ? dcc : dcl, c.tbl ? acc : acl);
      }
      if (restart_interval) {
        if (restarts_to_go == 0) {
          restarts_to_go = restart_interval;
          next_rst = (next_rst + 1) & 7;
        }
        restarts_to_go--;
      }
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void copy_error(const Fail& f, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, f.msg.c_str(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes a JPEG stream into a malloc'd buffer (free with gdr_jpeg_free):
// gray != 0 gives [H, W] as cv2.IMREAD_GRAYSCALE, else [H, W, 3] BGR as
// cv2.IMREAD_COLOR, before the EXIF orientation. info receives height,
// width, channels and the EXIF orientation (1..8). Returns 0, or 1 for a
// corrupt stream and 2 for an unsupported process, with the reason in err.
int gdr_jpeg_decode(const uint8_t* data, size_t size, int gray, uint8_t** out, int32_t* info,
                    char* err, int errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, size);
    dec.parse();
    if (!dec.frame) fail(kCorrupt, "no SOF marker");
    size_t bytes = size_t(dec.width) * dec.height * (gray ? 1 : 3);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(bytes));
    if (!buf) fail(kCorrupt, "out of memory");
    try {
      dec.output(gray != 0, buf);
    } catch (...) {
      std::free(buf);
      throw;
    }
    *out = buf;
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = gray ? 1 : 3;
    info[3] = dec.orientation;
    return kOk;
  } catch (const Fail& f) {
    copy_error(f, err, errlen);
    return f.code;
  } catch (const std::bad_alloc&) {
    copy_error(Fail{kCorrupt, "out of memory"}, err, errlen);
    return kCorrupt;
  }
}

// Encodes a [H, W] gray or [H, W, 3] BGR uint8 image (rows packed) as a
// baseline JFIF stream into a malloc'd buffer (free with gdr_jpeg_free).
// (h0, v0) are the luma sampling factors of a colour image: (2, 2) 4:2:0,
// (2, 1) 4:2:2, (1, 1) 4:4:4, (1, 2) 4:4:0, (4, 1) 4:1:1.
int gdr_jpeg_encode(const uint8_t* img, int width, int height, int channels, int quality, int h0,
                    int v0, int restart_interval, uint8_t** out, size_t* out_len, char* err,
                    int errlen) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> o = encode(img, width, height, channels, quality, h0, v0, restart_interval);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(o.size()));
    if (!buf) fail(kCorrupt, "out of memory");
    std::memcpy(buf, o.data(), o.size());
    *out = buf;
    *out_len = o.size();
    return kOk;
  } catch (const Fail& f) {
    copy_error(f, err, errlen);
    return f.code;
  } catch (const std::bad_alloc&) {
    copy_error(Fail{kCorrupt, "out of memory"}, err, errlen);
    return kCorrupt;
  }
}

void gdr_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
