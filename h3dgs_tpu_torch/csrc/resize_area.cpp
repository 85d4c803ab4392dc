// OpenCV's INTER_AREA resize of float32 images (modules/imgproc/src/
// resize.cpp) for h3dgs_tpu_torch/preprocess/imgproc.py, built by
// h3dgs_tpu_torch/native.py with the host's C++ compiler. The taps of each
// axis (source indices and float32 weights, computed in imgproc.py) are
// applied to columns and then to rows, one product and one add at a time
// in float32, as OpenCV accumulates: the result is OpenCV's bit for bit.
#include <cstdint>
#include <vector>

// A fused multiply-add rounds once where OpenCV rounds twice.
#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

namespace {

// One source row through the column taps: out[d * cn + c] = sum over k of
// row[idx[d, k] * cn + c] * w[d, k], in tap order.
void filter_row(const float* row, int64_t cn, const int64_t* idx,
                const float* w, int64_t dw, int64_t kx, float* out) {
  for (int64_t d = 0; d < dw; ++d) {
    const int64_t* id = idx + d * kx;
    const float* wd = w + d * kx;
    float* o = out + d * cn;
    for (int64_t c = 0; c < cn; ++c) {
      float acc = row[id[0] * cn + c] * wd[0];
      for (int64_t k = 1; k < kx; ++k) {
        const float term = row[id[k] * cn + c] * wd[k];
        acc = acc + term;
      }
      o[c] = acc;
    }
  }
}

}  // namespace

// src: [sh, sw, cn] float32; xidx / xw: [dw, kx] column taps; yidx / yw:
// [dh, ky] row taps (source indices rising with the destination index).
// Writes [dh, dw, cn] float32 to dst. Returns 0, or -1 for a tap out of
// range.
extern "C" int64_t h3dgs_resize_taps(const float* src, int64_t sh,
                                     int64_t sw, int64_t cn,
                                     const int64_t* xidx, const float* xw,
                                     int64_t dw, int64_t kx,
                                     const int64_t* yidx, const float* yw,
                                     int64_t dh, int64_t ky, float* dst) {
  for (int64_t i = 0; i < dw * kx; ++i)
    if (xidx[i] < 0 || xidx[i] >= sw) return -1;
  for (int64_t i = 0; i < dh * ky; ++i)
    if (yidx[i] < 0 || yidx[i] >= sh) return -1;
  // The rows of a destination row lie within ky + 1 consecutive source
  // rows of the last ones filtered: keep that many filtered rows, each in
  // the slot of its index modulo the count.
  const int64_t slots = ky + 1;
  const int64_t n = dw * cn;
  std::vector<float> rows(slots * n);
  std::vector<int64_t> held(slots, -1);
  for (int64_t d = 0; d < dh; ++d) {
    const int64_t* id = yidx + d * ky;
    const float* wd = yw + d * ky;
    float* o = dst + d * n;
    for (int64_t k = 0; k < ky; ++k) {
      const int64_t s = id[k] % slots;
      if (held[s] != id[k]) {
        filter_row(src + id[k] * sw * cn, cn, xidx, xw, dw, kx,
                   rows.data() + s * n);
        held[s] = id[k];
      }
    }
    const float* r0 = rows.data() + (id[0] % slots) * n;
    for (int64_t i = 0; i < n; ++i) o[i] = r0[i] * wd[0];
    for (int64_t k = 1; k < ky; ++k) {
      const float* r = rows.data() + (id[k] % slots) * n;
      const float wk = wd[k];
      for (int64_t i = 0; i < n; ++i) {
        const float term = r[i] * wk;
        o[i] = o[i] + term;
      }
    }
  }
  return 0;
}
