// Shared by the blend kernels (blend_fwd.cu, blend_bwd.cu): the packed
// per-Gaussian row and the pre-pass that writes it, the cp.async staging
// helpers and the conservative per-footprint cull.
//
// Packed row, 12 float32 = three 16-byte vectors per Gaussian:
//   [0] mx, my, opacity, inv_depth   [1] ca, cb, cc, 0   [2] r, g, b, 0
// An entry is staged with three 16-byte cp.async copies of its Gaussian's
// row; the alpha test reads vectors 0 and 1 (two 16-byte shared loads) and
// vector 2 only when the entry contributes. The rows are written by
// pack_kernel, a pre-pass of K1's launch, into a [N, 12] buffer that the
// wrapper allocates and keeps for K2 (ops/blend.py). K2's gradient rows
// ([N, 12], ops/blend.py:unpack_grads) use the same layout.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace blend {

constexpr int kTile = 16;
constexpr int kRowVec = 3;  // float4 per packed row
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;

// Cull margins (the same constants as ops/blend.py:cull_plain). kCullAbs
// covers the rounding of logf, expf and the alpha product; kCullRel times
// S = ca DX^2 + cc DY^2 bounds the rounding of the float32 power over the
// footprint; kDetRel times (ca cc + cb^2) the cancellation in the
// determinant; kCullSlack the roundings of the two compared products.
constexpr float kCullAbs = 1e-3f;
constexpr float kCullRel = 2e-6f;
constexpr float kDetRel = 1e-6f;
constexpr float kCullSlack = 1.00001f;

// The per-Gaussian columns the rows are packed from.
struct Columns {
  const float* means2d;    // [N, 2]
  const float* conic;      // [N, 3]
  const float* rgb;        // [N, 3]
  const float* opacity;    // [N]
  const float* inv_depth;  // [N]
};

constexpr int kPackBlock = 256;

// Pack the columns into rows. A thread reads one Gaussian (neighbouring
// threads read neighbouring addresses of each column) and puts its row
// into shared memory; the block then writes its 256 rows as one contiguous
// run of 16-byte vectors.
__global__ void __launch_bounds__(kPackBlock)
pack_kernel(const Columns in, int n, float4* __restrict__ pack) {
  __shared__ __align__(16) float4 s_rows[kPackBlock * kRowVec];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kPackBlock;
  const size_t g = static_cast<size_t>(base) + tid;
  if (g < static_cast<size_t>(n)) {
    s_rows[tid * kRowVec] = make_float4(
        in.means2d[2 * g], in.means2d[2 * g + 1], in.opacity[g],
        in.inv_depth[g]);
    s_rows[tid * kRowVec + 1] = make_float4(
        in.conic[3 * g], in.conic[3 * g + 1], in.conic[3 * g + 2], 0.0f);
    s_rows[tid * kRowVec + 2] = make_float4(
        in.rgb[3 * g], in.rgb[3 * g + 1], in.rgb[3 * g + 2], 0.0f);
  }
  __syncthreads();
  const int rows = min(kPackBlock, n - base);
  float4* dst = pack + static_cast<size_t>(base) * kRowVec;
  for (int i = tid; i < rows * kRowVec; i += kPackBlock) dst[i] = s_rows[i];
}

inline void launch_pack(const Columns& in, int n, float* pack,
                        cudaStream_t stream) {
  if (n > 0) {
    pack_kernel<<<(n + kPackBlock - 1) / kPackBlock, kPackBlock, 0, stream>>>(
        in, n, reinterpret_cast<float4*>(pack));
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Start the copy of Gaussian g's packed row into a shared-memory slot
// (nothing for g < 0: a slot past the tile's range).
__device__ __forceinline__ void stage_row(float4* slot, const float4* pack,
                                          int g) {
  if (g < 0) return;
  const float4* src = pack + static_cast<size_t>(g) * kRowVec;
  cp_async16(slot, src);
  cp_async16(slot + 1, src + 1);
  cp_async16(slot + 2, src + 2);
}

// True only if no pixel of the footprint [x0, x1] x [y0, y1] (pixel
// coordinates, inclusive) can pass the exact test
//   power <= 0 and min(0.99, opacity * expf(power)) >= 1/255.
// A pixel that passes has q = -power <= L + (rounding), L = ln(255 o).
// For a positive definite conic the least q over a column at distance dx
// from the mean is dx^2 det / (2 cc) (and dy^2 det / (2 ca) over a row),
// so the footprint is culled when its nearest column or row already
// exceeds L plus the margin. Anything in doubt (NaN, non-positive
// determinant) is not culled.
__device__ __forceinline__ bool cull_footprint(const float4 a, const float4 b,
                                               float x0, float x1, float y0,
                                               float y1) {
  const float dx0 = x0 - a.x, dx1 = a.x - x1;
  const float dy0 = y0 - a.y, dy1 = a.y - y1;
  const float dx_min = fmaxf(0.0f, fmaxf(dx0, dx1));
  const float dy_min = fmaxf(0.0f, fmaxf(dy0, dy1));
  const float dx_max = fmaxf(fabsf(dx0), fabsf(dx1));
  const float dy_max = fmaxf(fabsf(dy0), fabsf(dy1));
  const float s = b.x * dx_max * dx_max + b.z * dy_max * dy_max;
  const float lm = logf(255.0f * a.z) + (kCullAbs + kCullRel * s);
  if (lm < 0.0f) return true;  // opacity below 1/255: alpha < 1/255 always
  const float ac = b.x * b.z, bb = b.y * b.y;
  const float det_lo = (ac - bb) - kDetRel * (ac + bb);
  if (!(b.x > 0.0f && b.z > 0.0f && det_lo > 0.0f)) return false;
  const bool out_x = dx_min * dx_min * det_lo > 2.0f * b.z * lm * kCullSlack;
  const bool out_y = dy_min * dy_min * det_lo > 2.0f * b.x * lm * kCullSlack;
  return out_x || out_y;
}

// The exact per-pixel alpha test of one staged entry, without the state
// that the walk carries (T), so that the kernels can evaluate two entries
// side by side before they update T in order. ok: the entry contributes
// (live, power <= 0, alpha >= 1/255). expf is taken whatever the power;
// ok masks what it gives for a positive one.
struct PairEval {
  bool ok;
  float dx, dy, ex, alpha_raw, alpha;
  float ca, cb, cc, inv_depth;
};

__device__ __forceinline__ PairEval eval_pair(const float4* rows, int j,
                                              bool live, float fx,
                                              float fy) {
  const float4 a = rows[j * kRowVec];      // mx, my, opacity, inv_depth
  const float4 q = rows[j * kRowVec + 1];  // ca, cb, cc
  PairEval p;
  p.dx = fx - a.x;
  p.dy = fy - a.y;
  p.ca = q.x;
  p.cb = q.y;
  p.cc = q.z;
  p.inv_depth = a.w;
  const float power = -0.5f * (p.ca * p.dx * p.dx + p.cc * p.dy * p.dy)
                      - p.cb * p.dx * p.dy;
  p.ex = expf(power);
  p.alpha_raw = a.z * p.ex;
  p.alpha = fminf(kAlphaMax, p.alpha_raw);
  p.ok = live && power <= 0.0f && p.alpha >= kAlphaEps;
  return p;
}

}  // namespace blend
