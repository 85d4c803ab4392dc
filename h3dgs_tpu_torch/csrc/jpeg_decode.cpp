// Baseline, extended-sequential and progressive Huffman JPEG decoding
// (ITU-T T.81) for h3dgs_tpu_torch/io/jpeg.py, whose marker parser hands
// over the frame, the quantisation tables and each scan's entropy-coded
// bytes, Huffman tables and spectral / successive-approximation bands.
// Everything after the headers runs here: Huffman decoding with restart
// markers of every scan into one coefficient buffer (the four progressive
// scan kinds as jdphuff.c decodes them), DC prediction, dequantisation
// and libjpeg's ISLOW integer IDCT (jidctint.c), upsampling as
// libjpeg-turbo does it by default (jdsample.c: "fancy" triangle filters
// for 2x horizontal, 2x2 and 2x vertical factors, replication for other
// integer factors) and jdcolor.c's fixed-point YCbCr -> RGB. The result
// is bit-equal to libjpeg-turbo's default decode (what PIL and OpenCV
// return). Built by h3dgs_tpu_torch/native.py with the host's C++
// compiler; plain C++17.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Zigzag index -> natural (row-major) index, with 16 extra entries of 63
// so that a corrupt run length past the block's end stays inside it
// (libjpeg's jpeg_natural_order does the same).
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kFastBits = 9;
constexpr int kTableBytes = 16 + 256;  // code counts, then symbols

// Status bits returned to the caller (a corrupt stream decodes on, as
// libjpeg's does, with these as its warnings).
constexpr int64_t kShort = 1;    // entropy data ran out: zeros were read
constexpr int64_t kBadCode = 2;  // a bit pattern that is no Huffman code

struct Huffman {
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol, 0: longer
  int32_t maxcode[18];            // largest code of each length, or -1
  int32_t valoffset[18];          // symbol index minus first code
  uint8_t values[256];

  // Canonical codes from the 16 counts (T.81 annex C). False for a table
  // whose codes do not fit their lengths (libjpeg's JERR_BAD_HUFF_TABLE).
  bool build(const uint8_t* table) {
    std::memset(fast, 0, sizeof(fast));
    std::memcpy(values, table + 16, 256);
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      const int count = table[len - 1];
      if (k + count > 256) return false;
      valoffset[len] = k - code;
      for (int i = 0; i < count; ++i, ++code, ++k) {
        if (len <= kFastBits) {
          const int shift = kFastBits - len;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] =
                static_cast<uint16_t>((len << 8) | values[k]);
        }
      }
      maxcode[len] = count ? code - 1 : -1;
      if (code >= (1 << len)) return false;
      code <<= 1;
    }
    maxcode[17] = INT32_MAX;
    return true;
  }
};

// The entropy-coded bytes of one scan, [pos, end), read MSB first. 0xFF
// 0x00 is a data byte 0xFF; 0xFF followed by anything else is a marker,
// where reading stops and zeros are supplied from then on (libjpeg's
// "premature end of data segment"), never reading past `end`.
struct BitReader {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t buf = 0;   // bits, left-aligned
  int nbits = 0;
  int padded = 0;     // zero bits appended after the data ran out
  bool stopped = false;

  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!stopped) {
        if (pos >= end) {
          stopped = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          int64_t q = pos + 1;
          while (q < end && data[q] == 0xFF) ++q;  // fill bytes
          if (q < end && data[q] == 0x00) {
            byte = 0xFF;
            pos = q + 1;
          } else {
            stopped = true;  // a marker: pos stays on its first 0xFF
          }
        }
      }
      if (stopped) padded += 8;
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }

  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }

  int bits(int n) {
    if (n == 0) return 0;
    const int v = peek(n);
    skip(n);
    return v;
  }

  bool ran_short() const { return padded > nbits; }

  // A restart: drop the buffered bits, skip to the next marker and, when
  // it is RSTn (any n), step past it; any other marker stays unread, so
  // the intervals after it read zeros.
  void restart() {
    buf = 0;
    nbits = 0;
    padded = 0;
    stopped = false;
    for (int64_t p = pos; p < end; ++p) {
      if (data[p] != 0xFF) continue;
      int64_t q = p + 1;
      while (q < end && data[q] == 0xFF) ++q;
      if (q >= end) break;
      if (data[q] == 0x00) {
        p = q;
        continue;
      }
      pos = (data[q] >= 0xD0 && data[q] <= 0xD7) ? q + 1 : p;
      return;
    }
    pos = end;
  }
};

// One Huffman symbol; a pattern that is no code consumes 17 bits and
// gives symbol 0, as libjpeg's jpeg_huff_decode does.
inline int decode_symbol(BitReader& br, const Huffman& h, int64_t* status) {
  const int look = br.peek(16);
  const int entry = h.fast[look >> (16 - kFastBits)];
  if (entry) {
    br.skip(entry >> 8);
    return entry & 0xFF;
  }
  for (int len = kFastBits + 1; len <= 16; ++len) {
    const int code = look >> (16 - len);
    if (code <= h.maxcode[len]) {
      br.skip(len);
      return h.values[(code + h.valoffset[len]) & 0xFF];
    }
  }
  br.peek(17);
  br.skip(17);
  *status |= kBadCode;
  return 0;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// One 8x8 block: the DC difference and the AC run/size pairs.
inline void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac,
                         int32_t* last_dc, int16_t* block, int64_t* status) {
  int s = decode_symbol(br, dc, status);
  const int diff = s ? extend(br.bits(s), s) : 0;
  // libjpeg keeps the predictor in an int and stores it as a JCOEF;
  // unsigned arithmetic wraps where a corrupt stream would overflow.
  *last_dc = static_cast<int32_t>(static_cast<uint32_t>(*last_dc) +
                                  static_cast<uint32_t>(diff));
  block[0] = static_cast<int16_t>(*last_dc);
  for (int k = 1; k < 64; ++k) {
    const int rs = decode_symbol(br, ac, status);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// ---- progressive scans (jdphuff.c) ----

// A coefficient shifted left by `al` as libjpeg's LEFT_SHIFT does it (in
// unsigned arithmetic), stored as a 16-bit JCOEF.
inline int16_t shifted(int32_t v, int al) {
  return static_cast<int16_t>(static_cast<uint32_t>(v) << al);
}

// The first bits of a DC coefficient: the difference from the predictor,
// shifted by Al (decode_mcu_DC_first).
inline void dc_first(BitReader& br, const Huffman& dc, int al,
                     int32_t* last_dc, int16_t* block, int64_t* status) {
  const int s = decode_symbol(br, dc, status);
  const int diff = s ? extend(br.bits(s), s) : 0;
  *last_dc = static_cast<int32_t>(static_cast<uint32_t>(*last_dc) +
                                  static_cast<uint32_t>(diff));
  block[0] = shifted(*last_dc, al);
}

// One more bit of a DC coefficient (decode_mcu_DC_refine).
inline void dc_refine(BitReader& br, int al, int16_t* block) {
  if (br.bits(1)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
}

// The first bits of the AC band [ss, se] (decode_mcu_AC_first): run/size
// pairs, ZRL, and EOB runs that end this band in the next blocks too.
inline void ac_first(BitReader& br, const Huffman& ac, int ss, int se,
                     int al, int* eobrun, int16_t* block, int64_t* status) {
  if (*eobrun > 0) {
    --*eobrun;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    const int rs = decode_symbol(br, ac, status);
    const int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = shifted(extend(br.bits(s), s), al);
    } else if (r == 15) {
      k += 15;
    } else {
      *eobrun = (1 << r) + br.bits(r) - 1;
      break;
    }
  }
}

// A correction bit for a nonzero coefficient: 1 adds the bit at Al to its
// magnitude (once).
inline void correct(BitReader& br, int16_t* coef, int p1) {
  if (br.bits(1) && (*coef & p1) == 0)
    *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef - p1);
}

// One more bit of the AC band [ss, se] (decode_mcu_AC_refine): new
// coefficients of +-1 << Al after runs of still-zero ones, correction bits
// for those already nonzero, and EOB runs that still correct the band.
inline void ac_refine(BitReader& br, const Huffman& ac, int ss, int se,
                      int al, int* eobrun, int16_t* block, int64_t* status) {
  const int p1 = 1 << al;
  int k = ss;
  if (*eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = decode_symbol(br, ac, status);
      int r = rs >> 4, s = rs & 15;
      if (s) {  // a size other than 1 is libjpeg's warning; read on
        s = br.bits(1) ? p1 : -p1;
      } else if (r != 15) {
        *eobrun = (1 << r) + br.bits(r);
        break;
      }
      // Past the nonzero coefficients (correcting them) and r zeros.
      do {
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          correct(br, coef, p1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (*eobrun > 0) {
    for (; k <= se; ++k)
      if (block[kNatural[k]] != 0) correct(br, block + kNatural[k], p1);
    --*eobrun;
  }
}

// ---- ISLOW inverse DCT (jidctint.c) ----
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// libjpeg's IDCT range limit: the value's low 10 bits, read as signed,
// plus 128, clamped to [0, 255].
inline uint8_t idct_limit(int64_t x) {
  const int64_t y = ((x + 512) & 1023) - 512 + 128;
  return static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
}

// The 1-D even/odd butterfly shared by both passes: in[0..7] at stride
// `step`; out[i] = descale(result, shift).
template <typename In, typename Out, typename Store>
inline void idct_1d(const In* in, int step, Out* out, int ostep, int shift,
                    Store store) {
  int64_t z2 = in[2 * step], z3 = in[6 * step];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  const int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
  const int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  z2 = in[0];
  z3 = in[4 * step];
  const int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
  const int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  int64_t o0 = in[7 * step], o1 = in[5 * step], o2 = in[3 * step],
          o3 = in[1 * step];
  z1 = o0 + o3;
  z2 = o1 + o2;
  z3 = o0 + o2;
  int64_t z4 = o1 + o3;
  const int64_t z5 = (z3 + z4) * FIX_1_175875602;
  o0 *= FIX_0_298631336;
  o1 *= FIX_2_053119869;
  o2 *= FIX_3_072711026;
  o3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;

  store(out[0 * ostep], descale(tmp10 + o3, shift));
  store(out[7 * ostep], descale(tmp10 - o3, shift));
  store(out[1 * ostep], descale(tmp11 + o2, shift));
  store(out[6 * ostep], descale(tmp11 - o2, shift));
  store(out[2 * ostep], descale(tmp12 + o1, shift));
  store(out[5 * ostep], descale(tmp12 - o1, shift));
  store(out[3 * ostep], descale(tmp13 + o0, shift));
  store(out[4 * ostep], descale(tmp13 - o0, shift));
}

// Dequantise and inverse-transform one block into 8 rows of `out` at
// `stride`, with jidctint.c's shortcuts for a column or row whose AC terms
// are all zero (they give the full butterfly's values).
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int64_t stride) {
  int64_t in[64];
  int64_t ws[64];
  for (int i = 0; i < 64; ++i)
    in[i] = static_cast<int64_t>(coef[i]) * static_cast<int64_t>(quant[i]);
  for (int c = 0; c < 8; ++c) {  // columns
    if (!(in[8 + c] | in[16 + c] | in[24 + c] | in[32 + c] | in[40 + c] |
          in[48 + c] | in[56 + c])) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = in[c] * (1 << kPass1Bits);
      continue;
    }
    idct_1d(in + c, 8, ws + c, 8, kConstBits - kPass1Bits,
            [](int64_t& o, int64_t v) { o = v; });
  }
  for (int r = 0; r < 8; ++r) {  // rows
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      std::memset(o, idct_limit(descale(w[0], kPass1Bits + 3)), 8);
      continue;
    }
    idct_1d(w, 1, o, 1, kConstBits + kPass1Bits + 3,
            [](uint8_t& v, int64_t x) { v = idct_limit(x); });
  }
}

// ---- colour (jdcolor.c) ----
struct ColourTables {
  int32_t cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColourTables() {
    auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    const int64_t half = int64_t{1} << 15;
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int32_t>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int32_t>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

enum Method { kFull, kH2V1, kH2V2, kH1V2, kReplicate };

struct Plane {
  std::vector<uint8_t> px;  // IDCT output, blocks_w * 8 wide
  int64_t stride, dw, dh;   // row stride; the component's real size
  int rh, rv;               // upsampling factors
  Method method;
  std::vector<uint8_t> row;  // one upsampled row
  std::vector<int32_t> sums;  // h2v2: one row of column sums
};

// Output row y of a component, upsampled to the full width (or more).
const uint8_t* upsampled_row(Plane& p, int64_t y, int64_t width) {
  const int64_t dw = p.dw;
  uint8_t* out = p.row.data();
  switch (p.method) {
    case kFull:
      return p.px.data() + y * p.stride;
    case kH2V1: {  // h2v1_fancy_upsample
      const uint8_t* in = p.px.data() + y * p.stride;
      out[0] = in[0];
      out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int64_t j = 1; j < dw - 1; ++j) {
        const int v = in[j] * 3;
        out[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
        out[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
      }
      out[2 * dw - 2] =
          static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = in[dw - 1];
      return out;
    }
    case kH2V2:
    case kH1V2: {
      // The nearer input row and the next nearer one (above for even
      // output rows, below for odd), edge rows repeated.
      const int64_t r = y >> 1;
      int64_t n = (y & 1) ? r + 1 : r - 1;
      n = n < 0 ? 0 : (n > p.dh - 1 ? p.dh - 1 : n);
      const uint8_t* in0 = p.px.data() + r * p.stride;
      const uint8_t* in1 = p.px.data() + n * p.stride;
      if (p.method == kH1V2) {  // h1v2_fancy_upsample
        const int bias = (y & 1) ? 2 : 1;
        for (int64_t j = 0; j < dw; ++j)
          out[j] = static_cast<uint8_t>((in0[j] * 3 + in1[j] + bias) >> 2);
        return out;
      }
      // h2v2_fancy_upsample: column sums 3 * nearer + next nearer, then
      // 3/4 and 1/4 of the nearer and next nearer column sums.
      int32_t* sum = p.sums.data();
      for (int64_t j = 0; j < dw; ++j) sum[j] = in0[j] * 3 + in1[j];
      out[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
      for (int64_t j = 1; j < dw; ++j)
        out[2 * j] = static_cast<uint8_t>((sum[j] * 3 + sum[j - 1] + 8) >> 4);
      for (int64_t j = 0; j < dw - 1; ++j)
        out[2 * j + 1] =
            static_cast<uint8_t>((sum[j] * 3 + sum[j + 1] + 7) >> 4);
      out[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
      return out;
    }
    case kReplicate: {
      const uint8_t* in = p.px.data() + (y / p.rv) * p.stride;
      for (int64_t x = 0; x < width; ++x) out[x] = in[x / p.rh];
      return out;
    }
  }
  return out;
}

}  // namespace

// frame: width, height, number of components (1 or 3), colour (0 gray,
// 1 YCbCr, 2 RGB), gray output (0 or 1), then each component's h and v
// sampling factors. quant: each component's 64 quantisation values in
// natural order. scans: per scan 16 values: start and end of its entropy
// bytes in `data`, restart interval (0: none), number of components,
// their (up to 4) indices, then progressive (0 or 1), Ss, Se, Ah, Al. huff:
// per scan, for each of its components, the DC then the AC table, each 16
// code counts and 256 symbols (a table the scan does not use is not
// read). Every scan fills one coefficient buffer; the image is made from
// it after the last. out: [height,
// width, 3] (or [height, width] for one component or gray output) uint8.
// Returns the status bits (0: clean) or, for arguments the caller should
// have refused, -1 (frame) or -2 (a Huffman table).
extern "C" int64_t h3dgs_jpeg_decode(const uint8_t* data, int64_t size,
                                     const int32_t* frame,
                                     const uint16_t* quant, int64_t n_scans,
                                     const int64_t* scans,
                                     const uint8_t* huff, uint8_t* out) {
  const int64_t width = frame[0], height = frame[1];
  const int ncomp = frame[2], colour = frame[3], gray_out = frame[4];
  if (width <= 0 || height <= 0 || (ncomp != 1 && ncomp != 3))
    return -1;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    const int h = frame[5 + 2 * c], v = frame[6 + 2 * c];
    if (h < 1 || h > 4 || v < 1 || v > 4) return -1;
    hmax = h > hmax ? h : hmax;
    vmax = v > vmax ? v : vmax;
  }
  for (int c = 0; c < ncomp; ++c)  // only integer upsampling factors
    if (hmax % frame[5 + 2 * c] || vmax % frame[6 + 2 * c]) return -1;
  const int64_t mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int64_t mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  // Coefficients of every block, MCU-padded, per component.
  std::vector<std::vector<int16_t>> coef(ncomp);
  std::vector<int64_t> bw(ncomp), bh(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bw[c] = mcux * frame[5 + 2 * c];
    bh[c] = mcuy * frame[6 + 2 * c];
    coef[c].assign(bw[c] * bh[c] * 64, 0);
  }

  int64_t status = 0;
  for (int64_t s = 0; s < n_scans; ++s) {
    const int64_t* sc = scans + 16 * s;
    const int64_t start = sc[0], end = sc[1], restart = sc[2];
    const int ns = static_cast<int>(sc[3]);
    const bool prog = sc[8] != 0;
    const int ss = static_cast<int>(sc[9]), se = static_cast<int>(sc[10]);
    const int ah = static_cast<int>(sc[11]), al = static_cast<int>(sc[12]);
    if (start < 0 || end < start || end > size || ns < 1 || ns > ncomp)
      return -1;
    if (prog && (al > 13 || (ah && al != ah - 1) ||
                 (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))))
      return -1;
    // The tables a scan reads: both (sequential), the DC table (first DC
    // scans), the AC table (AC scans), none (DC refinements).
    const bool use_dc = !prog || (ss == 0 && ah == 0);
    const bool use_ac = !prog || ss > 0;
    int comp[4];
    Huffman dc[4], ac[4];
    for (int i = 0; i < ns; ++i) {
      comp[i] = static_cast<int>(sc[4 + i]);
      if (comp[i] < 0 || comp[i] >= ncomp) return -1;
      const uint8_t* t = huff + (s * 4 + i) * 2 * kTableBytes;
      if ((use_dc && !dc[i].build(t)) ||
          (use_ac && !ac[i].build(t + kTableBytes)))
        return -2;
      int n_dc = 0;
      for (int len = 0; len < 16; ++len) n_dc += t[len];
      for (int k = 0; use_dc && k < n_dc; ++k)  // DC categories above 15
        if (t[16 + k] > 15) return -2;
    }
    BitReader br{data, start, end};
    int32_t last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    // One block of this scan, whichever its kind.
    auto block_of = [&](int i, int16_t* block) {
      if (!prog)
        decode_block(br, dc[i], ac[i], &last_dc[i], block, &status);
      else if (ss == 0 && ah == 0)
        dc_first(br, dc[i], al, &last_dc[i], block, &status);
      else if (ss == 0)
        dc_refine(br, al, block);
      else if (ah == 0)
        ac_first(br, ac[i], ss, se, al, &eobrun, block, &status);
      else
        ac_refine(br, ac[i], ss, se, al, &eobrun, block, &status);
    };
    // A scan of one component is not interleaved: its MCU is one block,
    // over the component's own ceil(size / 8) blocks.
    int64_t units_x = mcux, units;
    if (ns == 1) {
      const int c = comp[0];
      const int64_t dw =
          (width * frame[5 + 2 * c] + hmax - 1) / hmax;
      const int64_t dh =
          (height * frame[6 + 2 * c] + vmax - 1) / vmax;
      units_x = (dw + 7) / 8;
      units = units_x * ((dh + 7) / 8);
    } else {
      units = mcux * mcuy;
    }
    for (int64_t m = 0; m < units; ++m) {
      if (restart > 0 && m > 0 && m % restart == 0) {
        if (br.ran_short()) status |= kShort;
        br.restart();
        last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
        eobrun = 0;
      }
      const int64_t my = m / units_x, mx = m % units_x;
      if (ns == 1) {
        const int c = comp[0];
        block_of(0, coef[c].data() + (my * bw[c] + mx) * 64);
        continue;
      }
      for (int i = 0; i < ns; ++i) {
        const int c = comp[i];
        const int h = frame[5 + 2 * c], v = frame[6 + 2 * c];
        for (int yy = 0; yy < v; ++yy)
          for (int xx = 0; xx < h; ++xx)
            block_of(i, coef[c].data() +
                            ((my * v + yy) * bw[c] + mx * h + xx) * 64);
      }
    }
    if (br.ran_short()) status |= kShort;
  }

  // Inverse DCT, then each component's upsampling method.
  const bool luma_only = gray_out && colour == 1;
  const int used = luma_only ? 1 : ncomp;
  std::vector<Plane> planes(used);
  for (int c = 0; c < used; ++c) {
    Plane& p = planes[c];
    const int h = frame[5 + 2 * c], v = frame[6 + 2 * c];
    p.stride = bw[c] * 8;
    p.px.assign(p.stride * bh[c] * 8, 0);
    for (int64_t by = 0; by < bh[c]; ++by)
      for (int64_t bx = 0; bx < bw[c]; ++bx)
        idct_islow(coef[c].data() + (by * bw[c] + bx) * 64, quant + 64 * c,
                   p.px.data() + by * 8 * p.stride + bx * 8, p.stride);
    std::vector<int16_t>().swap(coef[c]);
    p.dw = (width * h + hmax - 1) / hmax;
    p.dh = (height * v + vmax - 1) / vmax;
    p.rh = hmax / h;
    p.rv = vmax / v;
    if (p.rh == 1 && p.rv == 1)
      p.method = kFull;
    else if (p.rh == 2 && p.rv == 1)
      p.method = p.dw > 2 ? kH2V1 : kReplicate;
    else if (p.rh == 2 && p.rv == 2)
      p.method = p.dw > 2 ? kH2V2 : kReplicate;
    else if (p.rh == 1 && p.rv == 2)
      p.method = kH1V2;
    else
      p.method = kReplicate;
    p.row.assign(p.dw * p.rh + width, 0);
    p.sums.assign(p.dw, 0);
  }

  static const ColourTables tab;
  const int out_ch = (ncomp == 1 || gray_out) ? 1 : 3;
  for (int64_t y = 0; y < height; ++y) {
    uint8_t* o = out + y * width * out_ch;
    const uint8_t* r0 = upsampled_row(planes[0], y, width);
    if (used == 1) {
      std::memcpy(o, r0, width);
      continue;
    }
    const uint8_t* r1 = upsampled_row(planes[1], y, width);
    const uint8_t* r2 = upsampled_row(planes[2], y, width);
    if (colour == 2 && gray_out) {  // rgb_gray_convert
      for (int64_t x = 0; x < width; ++x)
        o[x] = static_cast<uint8_t>(
            (19595 * r0[x] + 38470 * r1[x] + 7471 * r2[x] + 32768) >> 16);
    } else if (colour == 2) {
      for (int64_t x = 0; x < width; ++x) {
        o[3 * x] = r0[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r2[x];
      }
    } else {  // ycc_rgb_convert
      for (int64_t x = 0; x < width; ++x) {
        const int yv = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp255(yv + tab.cr_r[cr]);
        o[3 * x + 1] = clamp255(
            yv + static_cast<int>((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yv + tab.cb_b[cb]);
      }
    }
  }
  return status;
}
