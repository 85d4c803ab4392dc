// Blend backward (K2): per-Gaussian gradients of the front-to-back alpha
// blend, from the pixel cotangents of color, inverse depth and final
// transmittance.
//
// Replaces the TPU kernel h3dgs_tpu/ops/pallas_blend.py:_bwd_kernel
// (launched by pallas_blend_bwd through _blend_bwd, its entries summed per
// Gaussian by scatter_entry_grads in "add" mode). Written from the blend's
// contract, as K1 was: none of the owner segments, MXU prefix scans,
// backward truncation / compaction or segsum is carried over.
//
// For a pixel with cotangent g = (g_r, g_g, g_b, g_invd) on the color and
// inverse depth before background, and g_T on its final transmittance
// T_fin, each contributing entry k (alpha_k, T_k = T before k, attributes
// a_k = (r, g, b, invd)) gets
//   d_alpha_k = T_k (g.a_k) - (S_k + g_T T_fin) / (1 - alpha_k),
//   S_k = sum_{j>k} (g.a_j) alpha_j T_j          (a running suffix sum),
// the terms of pallas_blend.py:653-654. d_alpha is not chained further
// where the raw alpha o*exp(power) >= 0.99 (the clamp, l.663); otherwise
//   d_opacity = d_alpha exp(power),  d_power = d_alpha o exp(power),
// and d_power goes to means2d and the conic as in l.697-705. Colors and
// inverse depth get alpha_k T_k g. Entries past a pixel's last
// contributing entry, or skipped by the power > 0 / alpha < 1/255 tests,
// add nothing (the sparse-Adam mask reads exact zeros).
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel.
// The block takes the largest last-entry index of its pixels (K1's fourth
// output) and walks the tile's entries back to front from there, in
// batches of 256 staged in shared memory as K1 stages them. Each pixel
// starts from its own final T and recovers T_k = T_{k+1} / (1 - alpha_k)
// by division. The 10 per-entry values are summed over the warp's 32
// pixels with __shfl_down_sync (only when some lane contributed), and lane
// 0 atomicAdds them into f32 [N, 10] per-Gaussian accumulators that the
// wrapper zeroes.
//
// What bounds it on the H100: each evaluated (entry, pixel) pair costs
// about 20 FP32 operations to recompute alpha (one expf) and about 40 more
// when the entry contributes (67 TFLOP/s); the bytes it must move are the
// referenced Gaussians (40 B read, 40 B of gradient written), 4 B per
// entry and 28 B read per pixel (3.35 TB/s). The operations bind. The warp
// reduction (50 shuffles per entry per warp) and the atomics (10 per entry
// per warp) are overhead on top of that bound. Compiled without
// --use_fast_math (expf, IEEE division) to keep parity with the plain
// version. Speed work -- skipping warps past their last index, a
// block-level reduction before the atomics -- is for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kGrads = 10;  // mx, my, ca, cb, cc, r, g, b, opacity, invdepth
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kBlock)
blend_bwd_kernel(const float* __restrict__ means2d,    // [N, 2]
                 const float* __restrict__ conic,      // [N, 3]
                 const float* __restrict__ rgb,        // [N, 3]
                 const float* __restrict__ opacity,    // [N]
                 const float* __restrict__ inv_depth,  // [N]
                 const int* __restrict__ gauss_idx,    // [D]
                 const int* __restrict__ tile_start,   // [T]
                 int height, int width, int tiles_x,
                 const float* __restrict__ final_t,    // [H, W]
                 const int* __restrict__ last_entry,   // [H, W]
                 const float* __restrict__ g_color,    // [3, H, W]
                 const float* __restrict__ g_invd,     // [H, W]
                 const float* __restrict__ g_trans,    // [H, W]
                 float* __restrict__ grads) {          // [N, 10]
  __shared__ float s_mx[kBlock], s_my[kBlock];
  __shared__ float s_ca[kBlock], s_cb[kBlock], s_cc[kBlock];
  __shared__ float s_op[kBlock], s_id[kBlock];
  __shared__ float s_r[kBlock], s_g[kBlock], s_b[kBlock];
  __shared__ int s_gi[kBlock];
  __shared__ int s_max_last;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = (tile % tiles_x) * kTile + tid % kTile;
  const int py = (tile / tiles_x) * kTile + tid / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_start[tile];

  int last = -1;
  float T = 1.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f, gt = 0.0f;
  if (inside) {
    const int hw = height * width;
    const int p = py * width + px;
    last = last_entry[p];
    T = final_t[p];
    gr = g_color[p];
    gg = g_color[hw + p];
    gb = g_color[2 * hw + p];
    gd = g_invd[p];
    gt = g_trans[p];
  }
  const float gt_tfin = gt * T;
  float suffix = 0.0f;  // S_k: sum over later contributing entries

  if (tid == 0) s_max_last = -1;
  __syncthreads();
  if (last >= 0) atomicMax(&s_max_last, last);
  __syncthreads();
  const int top = s_max_last;  // the same for every thread of the block

  for (int hi = top; hi >= start; hi -= kBlock) {
    const int lo = max(start, hi - kBlock + 1);
    const int n = hi - lo + 1;
    // The previous batch's readers are done before it is overwritten.
    __syncthreads();
    if (tid < n) {
      const int g = gauss_idx[lo + tid];
      s_gi[tid] = g;
      s_mx[tid] = means2d[2 * g];
      s_my[tid] = means2d[2 * g + 1];
      s_ca[tid] = conic[3 * g];
      s_cb[tid] = conic[3 * g + 1];
      s_cc[tid] = conic[3 * g + 2];
      s_op[tid] = opacity[g];
      s_id[tid] = inv_depth[g];
      s_r[tid] = rgb[3 * g];
      s_g[tid] = rgb[3 * g + 1];
      s_b[tid] = rgb[3 * g + 2];
    }
    __syncthreads();
    // Uniform loop: every lane reaches the warp shuffles below.
    for (int j = n - 1; j >= 0; --j) {
      float v[kGrads];
#pragma unroll
      for (int i = 0; i < kGrads; ++i) v[i] = 0.0f;
      bool contrib = false;
      if (lo + j <= last) {
        const float dx = fx - s_mx[j];
        const float dy = fy - s_my[j];
        const float ca = s_ca[j], cb = s_cb[j], cc = s_cc[j];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy)
                            - cb * dx * dy;
        if (power <= 0.0f) {
          const float e = expf(power);
          const float alpha_raw = s_op[j] * e;
          const float alpha = fminf(kAlphaMax, alpha_raw);
          if (alpha >= kAlphaEps) {
            contrib = true;
            const float one_minus = 1.0f - alpha;
            T = T / one_minus;                 // T before entry k
            const float ga = gr * s_r[j] + gg * s_g[j] + gb * s_b[j]
                             + gd * s_id[j];
            const float w = alpha * T;
            const float d_alpha = T * ga - (suffix + gt_tfin) / one_minus;
            suffix += ga * w;
            v[5] = w * gr;
            v[6] = w * gg;
            v[7] = w * gb;
            v[9] = w * gd;
            if (alpha_raw < kAlphaMax) {
              const float d_power = d_alpha * alpha_raw;
              v[0] = d_power * (ca * dx + cb * dy);
              v[1] = d_power * (cc * dy + cb * dx);
              v[2] = d_power * (-0.5f * dx * dx);
              v[3] = d_power * (-dx * dy);
              v[4] = d_power * (-0.5f * dy * dy);
              v[8] = d_alpha * e;
            }
          }
        }
      }
      if (__any_sync(kFullMask, contrib)) {
#pragma unroll
        for (int i = 0; i < kGrads; ++i) v[i] = warp_sum(v[i]);
        if (lane == 0) {
          float* dst = grads + kGrads * s_gi[j];
#pragma unroll
          for (int i = 0; i < kGrads; ++i) atomicAdd(dst + i, v[i]);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError() after the launch. The
// caller zeroes ``grads`` first.
extern "C" int blend_bwd_launch(const float* means2d, const float* conic,
                                const float* rgb, const float* opacity,
                                const float* inv_depth, const int* gauss_idx,
                                const int* tile_start, int n_tiles,
                                int tiles_x, int height, int width,
                                const float* final_t, const int* last_entry,
                                const float* g_color, const float* g_invd,
                                const float* g_trans, float* grads,
                                void* stream) {
  if (n_tiles > 0) {
    blend_bwd_kernel<<<n_tiles, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        means2d, conic, rgb, opacity, inv_depth, gauss_idx, tile_start,
        height, width, tiles_x, final_t, last_entry, g_color, g_invd,
        g_trans, grads);
  }
  return static_cast<int>(cudaGetLastError());
}
