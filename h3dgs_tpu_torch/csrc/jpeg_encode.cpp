// Baseline Huffman JPEG encoding (ITU-T T.81) for
// h3dgs_tpu_torch/io/jpeg_encode.py, which writes the headers and hands
// over the samples, the quantisation tables and the Huffman codes.
// Everything between the headers and EOI is made here, as libjpeg-turbo's
// compressor makes it at the settings PIL and OpenCV use: jccolor.c's
// fixed-point RGB -> YCbCr, jcsample.c's h2v2_downsample with its
// alternating bias and edge replication, jfdctint.c's ISLOW forward DCT,
// jcdctmgr.c's quantisation (divide by 8 Q, round half away from zero),
// jccoefct.c's dummy blocks past a component's own blocks, and jchuff.c's
// Huffman coding with 0xFF 0x00 stuffing and 1-bits padding the last
// byte. The result is bit-equal to libjpeg-turbo's. Built by
// h3dgs_tpu_torch/native.py with the host's C++ compiler; plain C++17.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Zigzag index -> natural (row-major) index.
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---- colour (jccolor.c) ----
// jccolor.c's tables hold FIX(c) * i for each coefficient c, so the sums
// below are its table sums: Y rounds by ONE_HALF, Cb and Cr add
// CBCR_OFFSET + ONE_HALF - 1.
constexpr int32_t fix(double x) {
  return static_cast<int32_t>(x * 65536.0 + 0.5);
}
constexpr int32_t kRY = fix(0.29900), kGY = fix(0.58700), kBY = fix(0.11400);
constexpr int32_t kRCb = fix(0.16874), kGCb = fix(0.33126);
constexpr int32_t kHalf = fix(0.50000);  // B's Cb and R's Cr factor
constexpr int32_t kGCr = fix(0.41869), kBCr = fix(0.08131);
constexpr int32_t kOneHalf = 1 << 15, kCbCrOffset = 128 << 16;

// ---- ISLOW forward DCT (jfdctint.c) ----
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// One 1-D pass of jpeg_fdct_islow over 8 lanes at once: lane l transforms
// x[0..7][l] into y[0..7][l]. Rows (first) keep PASS1_BITS of extra
// precision, columns remove it. 32 bits hold every term for 8-bit
// samples (libjpeg-turbo's SIMD forward DCT computes in 32 bits too).
template <bool kFirst>
inline void fdct_lanes(const int32_t (*x)[8], int32_t (*y)[8]) {
  constexpr int n = kFirst ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
  constexpr int32_t round = 1 << (n - 1);
  for (int l = 0; l < 8; ++l) {
    const int32_t tmp0 = x[0][l] + x[7][l], tmp7 = x[0][l] - x[7][l];
    const int32_t tmp1 = x[1][l] + x[6][l], tmp6 = x[1][l] - x[6][l];
    const int32_t tmp2 = x[2][l] + x[5][l], tmp5 = x[2][l] - x[5][l];
    const int32_t tmp3 = x[3][l] + x[4][l], tmp4 = x[3][l] - x[4][l];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    if (kFirst) {
      y[0][l] = (tmp10 + tmp11) * (1 << kPass1Bits);
      y[4][l] = (tmp10 - tmp11) * (1 << kPass1Bits);
    } else {
      y[0][l] = (tmp10 + tmp11 + (1 << (kPass1Bits - 1))) >> kPass1Bits;
      y[4][l] = (tmp10 - tmp11 + (1 << (kPass1Bits - 1))) >> kPass1Bits;
    }
    const int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    y[2][l] = (z1 + tmp13 * FIX_0_765366865 + round) >> n;
    y[6][l] = (z1 - tmp12 * FIX_1_847759065 + round) >> n;
    const int32_t o1 = tmp4 + tmp7, o2 = tmp5 + tmp6;
    const int32_t o3 = tmp4 + tmp6, o4 = tmp5 + tmp7;
    const int32_t z5 = (o3 + o4) * FIX_1_175875602;
    const int32_t w1 = o1 * -FIX_0_899976223, w2 = o2 * -FIX_2_562915447;
    const int32_t w3 = o3 * -FIX_1_961570560 + z5;
    const int32_t w4 = o4 * -FIX_0_390180644 + z5;
    y[7][l] = (tmp4 * FIX_0_298631336 + w1 + w3 + round) >> n;
    y[5][l] = (tmp5 * FIX_2_053119869 + w2 + w4 + round) >> n;
    y[3][l] = (tmp6 * FIX_3_072711026 + w2 + w3 + round) >> n;
    y[1][l] = (tmp7 * FIX_1_501321110 + w1 + w4 + round) >> n;
  }
}

// Quantisation by d = 8 Q, rounded half away from zero: floor((|x| + d /
// 2) / d) as floor((|x| + d / 2) * (1 / d) + 1e-6) in double. Exact: the
// product is within 1e-11 of the quotient, and a quotient below an
// integer is at least 1 / d >= 1 / 2040 below it.
struct Divisors {
  int32_t half[64];  // natural order
  double inv[64];
};

// The 8x8 block at `plane` (rows `stride` apart), transformed and
// quantised into `out` (zigzag order).
void fdct_quantise(const uint8_t* plane, int64_t stride, const Divisors& q,
                   int32_t* out) {
  alignas(32) int32_t a[8][8], b[8][8];
  for (int r = 0; r < 8; ++r)  // lanes = rows: a[c][r] = sample (r, c)
    for (int c = 0; c < 8; ++c) a[c][r] = plane[r * stride + c] - 128;
  fdct_lanes<true>(a, b);  // b[k][r]: row r's coefficient k
  for (int r = 0; r < 8; ++r)  // lanes = columns: a[r][k] = b[k][r]
    for (int k = 0; k < 8; ++k) a[r][k] = b[k][r];
  fdct_lanes<false>(a, b);  // b[u][k]: coefficient (u, k), natural order
  alignas(32) int32_t v[64];
  const int32_t* flat = &b[0][0];
  for (int n = 0; n < 64; ++n) {
    const int32_t x = flat[n];
    const int32_t m = (x < 0 ? -x : x) + q.half[n];
    const int32_t t = static_cast<int32_t>(m * q.inv[n] + 1e-6);
    v[n] = x < 0 ? -t : t;
  }
  for (int k = 0; k < 64; ++k) out[k] = v[kNatural[k]];
}

// ---- Huffman coding (jchuff.c) ----
struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;  // pending bits, right-aligned
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;
  }
  // The low `size` bits of `code` (at most 32).
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((uint64_t{1} << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      byte(static_cast<uint8_t>(acc >> nbits));
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits) put(0x7F, 8 - nbits);
  }
};

inline int bit_count(int32_t v) {
  const uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

struct Table {
  const uint32_t* code;
  const uint8_t* size;
};

// A symbol's code followed by `s` extra bits (the value's low bits, one
// less for a negative value): at most 16 + 11 bits.
inline void put_symbol(BitWriter& bw, const Table& t, int symbol, int32_t v,
                       int s) {
  const uint32_t extra = static_cast<uint32_t>(v < 0 ? v - 1 : v) &
                         ((uint32_t{1} << s) - 1);
  bw.put((t.code[symbol] << s) | extra, t.size[symbol] + s);
}

void encode_block(BitWriter& bw, const int32_t* z, int32_t* last_dc,
                  const Table& dc, const Table& ac) {
  const int32_t diff = z[0] - *last_dc;
  *last_dc = z[0];
  const int s = bit_count(diff);
  put_symbol(bw, dc, s, diff, s);
  uint64_t nonzero = 0;  // bit k: z[k] != 0, for k >= 1
  for (int k = 1; k < 64; ++k)
    nonzero |= static_cast<uint64_t>(z[k] != 0) << k;
  int last = 0;
  while (nonzero) {
    const int k = __builtin_ctzll(nonzero);
    nonzero &= nonzero - 1;
    int run = k - last - 1;
    for (; run > 15; run -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
    const int sk = bit_count(z[k]);
    put_symbol(bw, ac, (run << 4) | sk, z[k], sk);
    last = k;
  }
  if (last < 63) bw.put(ac.code[0], ac.size[0]);
}

// A component's samples padded by edge replication to [rows, cols].
struct Plane {
  std::vector<uint8_t> px;
  int64_t rows = 0, cols = 0;
  uint8_t* row(int64_t y) { return px.data() + y * cols; }
  void pad(int64_t real_rows, int64_t real_cols) {
    for (int64_t y = 0; y < real_rows; ++y) {
      uint8_t* r = row(y);
      std::memset(r + real_cols, r[real_cols - 1], cols - real_cols);
    }
    for (int64_t y = real_rows; y < rows; ++y)
      std::memcpy(row(y), row(real_rows - 1), cols);
  }
};

}  // namespace

// img: [height, width, channels] uint8 (channels 3: RGB, 1: gray).
// quant: the luma then the chroma table, 64 values each, natural order.
// codes / sizes: [4][256] Huffman codes and lengths per symbol, for DC
// luma, AC luma, DC chroma, AC chroma. Writes the entropy-coded segment
// (stuffed, padded) to out and returns its length; -1 for arguments the
// caller should have refused, -2 when `capacity` bytes do not hold it.
extern "C" int64_t h3dgs_jpeg_encode(const uint8_t* img, int64_t width,
                                     int64_t height, int64_t channels,
                                     const uint16_t* quant,
                                     const uint32_t* codes,
                                     const uint8_t* sizes, uint8_t* out,
                                     int64_t capacity) {
  if (width < 1 || height < 1 || (channels != 1 && channels != 3)) return -1;
  Divisors divs[2];
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 64; ++k) {
      const int32_t d = 8 * quant[64 * t + k];
      if (d == 0) return -1;
      divs[t].half[k] = d / 2;
      divs[t].inv[k] = 1.0 / d;
    }
  const Table dc_l{codes, sizes}, ac_l{codes + 256, sizes + 256},
      dc_c{codes + 512, sizes + 512}, ac_c{codes + 768, sizes + 768};
  BitWriter bw{out, capacity};
  int32_t z[64];
  const int64_t bw_y = (width + 7) / 8, bh_y = (height + 7) / 8;

  if (channels == 1) {  // one component: its own blocks, in raster order
    Plane y;
    y.rows = bh_y * 8;
    y.cols = bw_y * 8;
    y.px.resize(y.rows * y.cols);
    for (int64_t r = 0; r < height; ++r)
      std::memcpy(y.row(r), img + r * width, width);
    y.pad(height, width);
    int32_t last = 0;
    for (int64_t by = 0; by < bh_y; ++by)
      for (int64_t bx = 0; bx < bw_y; ++bx) {
        fdct_quantise(y.row(by * 8) + bx * 8, y.cols, divs[0], z);
        encode_block(bw, z, &last, dc_l, ac_l);
      }
    bw.flush();
    return bw.overflow ? -2 : bw.n;
  }

  // YCbCr 4:2:0: Y on its own blocks, Cb and Cr at half size.
  const int64_t mw = (width + 15) / 16, mh = (height + 15) / 16;
  Plane y, cb, cr;
  y.rows = bh_y * 8;
  y.cols = bw_y * 8;
  y.px.resize(y.rows * y.cols);
  // Full-size chroma, padded on the right to 2 * 8 * mw and to an even
  // row count, before the downsampling.
  Plane full[2];
  for (Plane& f : full) {
    f.rows = height + (height & 1);
    f.cols = 16 * mw;
    f.px.resize(f.rows * f.cols);
  }
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* in = img + r * width * 3;
    uint8_t *oy = y.row(r), *ob = full[0].row(r), *orr = full[1].row(r);
    for (int64_t x = 0; x < width; ++x) {
      const int32_t R = in[3 * x], G = in[3 * x + 1], B = in[3 * x + 2];
      oy[x] = static_cast<uint8_t>((kRY * R + kGY * G + kBY * B + kOneHalf)
                                   >> 16);
      ob[x] = static_cast<uint8_t>((-kRCb * R - kGCb * G + kHalf * B +
                                    kCbCrOffset + kOneHalf - 1) >> 16);
      orr[x] = static_cast<uint8_t>((kHalf * R - kGCr * G - kBCr * B +
                                     kCbCrOffset + kOneHalf - 1) >> 16);
    }
  }
  y.pad(height, width);
  const int64_t half_rows = (height + 1) / 2;
  for (int i = 0; i < 2; ++i) {
    full[i].pad(height, width);
    Plane& d = i ? cr : cb;
    d.rows = mh * 8;
    d.cols = mw * 8;
    d.px.resize(d.rows * d.cols);
    for (int64_t r = 0; r < half_rows; ++r) {
      const uint8_t* a = full[i].row(2 * r);
      const uint8_t* b = full[i].row(2 * r + 1);
      uint8_t* o = d.row(r);
      for (int64_t x = 0; x < d.cols; ++x)  // bias 1, 2, 1, 2, ...
        o[x] = static_cast<uint8_t>((a[2 * x] + a[2 * x + 1] + b[2 * x] +
                                     b[2 * x + 1] + 1 + (x & 1)) >> 2);
    }
    d.pad(half_rows, d.cols);
    std::vector<uint8_t>().swap(full[i].px);
  }

  int32_t last[3] = {0, 0, 0};
  int32_t dc_above[2];  // DCs of the MCU's upper row (for dummy rows)
  for (int64_t my = 0; my < mh; ++my) {
    for (int64_t mx = 0; mx < mw; ++mx) {
      for (int yy = 0; yy < 2; ++yy) {
        const int64_t by = 2 * my + yy;
        for (int xx = 0; xx < 2; ++xx) {
          const int64_t bx = 2 * mx + xx;
          if (by < bh_y && bx < bw_y) {
            fdct_quantise(y.row(by * 8) + bx * 8, y.cols, divs[0], z);
          } else {
            // A dummy block (jccoefct.c): zero, with the DC of the block
            // before it in this row, or in a dummy row of the MCU's last
            // block above.
            const int32_t dc = by < bh_y ? z[0] : dc_above[1];
            std::memset(z, 0, sizeof(z));
            z[0] = dc;
          }
          if (yy == 0) dc_above[xx] = z[0];
          encode_block(bw, z, &last[0], dc_l, ac_l);
        }
      }
      for (int i = 0; i < 2; ++i) {
        const Plane& d = i ? cr : cb;
        fdct_quantise(d.px.data() + my * 8 * d.cols + mx * 8, d.cols, divs[1],
                      z);
        encode_block(bw, z, &last[1 + i], dc_c, ac_c);
      }
    }
  }
  bw.flush();
  return bw.overflow ? -2 : bw.n;
}
