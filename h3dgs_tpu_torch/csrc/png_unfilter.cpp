// PNG scanline unfiltering (PNG specification, section 9) for
// h3dgs_tpu_torch/io/image.py: the host loop that PIL and OpenCV run in C,
// built by h3dgs_tpu_torch/native.py with the host's C++ compiler.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// One row of Sub (1), Average (3) or Paeth (4). `prev` is the row above
// (zeros for the first row); n is a multiple of BPP, the bytes of a
// pixel. The left (a) and upper-left (c) neighbours stay in registers:
// the only loop-carried chain is a pixel's byte k on the one before.
template <int TYPE, int BPP>
void unfilter_row(const uint8_t* in, const uint8_t* prev, uint8_t* row,
                  int64_t n) {
  int a[BPP] = {0};
  int c[BPP] = {0};
  for (int64_t i = 0; i < n; i += BPP) {
    for (int k = 0; k < BPP; ++k) {
      const int b = prev[i + k];
      int pred;
      if (TYPE == 1) {
        pred = a[k];
      } else if (TYPE == 3) {
        pred = (a[k] + b) >> 1;
      } else {
        const int pa = std::abs(b - c[k]);
        const int pb = std::abs(a[k] - c[k]);
        const int pc = std::abs(a[k] + b - 2 * c[k]);
        // a if pa is the least, else b if pb <= pc, else c; selected by
        // masks, not branches (the choice is data-dependent noise).
        const int use_a = -static_cast<int>((pa <= pb) & (pa <= pc));
        const int use_b = -static_cast<int>(pb <= pc) & ~use_a;
        pred = (a[k] & use_a) | (b & use_b) | (c[k] & ~(use_a | use_b));
      }
      const int x = (in[i + k] + pred) & 255;
      row[i + k] = static_cast<uint8_t>(x);
      a[k] = x;
      c[k] = b;
    }
  }
}

template <int TYPE>
bool unfilter_typed(const uint8_t* in, const uint8_t* prev, uint8_t* row,
                    int64_t n, int64_t bpp) {
  switch (bpp) {
    case 1: unfilter_row<TYPE, 1>(in, prev, row, n); return true;
    case 2: unfilter_row<TYPE, 2>(in, prev, row, n); return true;
    case 3: unfilter_row<TYPE, 3>(in, prev, row, n); return true;
    case 4: unfilter_row<TYPE, 4>(in, prev, row, n); return true;
    case 6: unfilter_row<TYPE, 6>(in, prev, row, n); return true;
    case 8: unfilter_row<TYPE, 8>(in, prev, row, n); return true;
    default: return false;
  }
}

}  // namespace

// data: `height` rows of one filter byte followed by `row_bytes` filtered
// bytes; bpp: bytes per pixel (1, 2, 3, 4, 6 or 8: the PNG formats that
// image.py reads). Writes the [height, row_bytes] reconstructed bytes to
// `out`. Returns -1; the index of the first row whose filter type is not
// 0-4 (the rows before it are written); or -2 for another bpp.
extern "C" int64_t h3dgs_png_unfilter(const uint8_t* data, int64_t height,
                                      int64_t row_bytes, int64_t bpp,
                                      uint8_t* out) {
  const std::vector<uint8_t> zeros(row_bytes, 0);
  const uint8_t* prev = zeros.data();  // the row above
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* in = data + r * (row_bytes + 1) + 1;
    uint8_t* row = out + r * row_bytes;
    bool ok = true;
    switch (in[-1]) {
      case 0:  // None
        std::memcpy(row, in, row_bytes);
        break;
      case 1:  // Sub
        ok = unfilter_typed<1>(in, prev, row, row_bytes, bpp);
        break;
      case 2:  // Up
        for (int64_t i = 0; i < row_bytes; ++i) row[i] = in[i] + prev[i];
        break;
      case 3:  // Average
        ok = unfilter_typed<3>(in, prev, row, row_bytes, bpp);
        break;
      case 4:  // Paeth
        ok = unfilter_typed<4>(in, prev, row, row_bytes, bpp);
        break;
      default:
        return r;
    }
    if (!ok) return -2;
    prev = row;
  }
  return -1;
}
