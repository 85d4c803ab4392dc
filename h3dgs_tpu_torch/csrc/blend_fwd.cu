// Blend forward (K1): front-to-back alpha blending of depth-sorted
// Gaussian entries into 16x16 pixel tiles.
//
// Replaces the TPU kernel h3dgs_tpu/ops/pallas_blend.py:_fwd_kernel
// (launched by pallas_blend_fwd through blend_entries / _blend_fwd). It is
// written from the blend's numerical contract (ops/rasterize.py:186-228,
// ops/reference.py:30-85 of the JAX package), not from the Pallas kernel:
// none of the TPU layout machinery (quanta, owner groups, MXU prefix
// scans, VMEM carries, chunk-combine scatter) is carried over.
//
// Per pixel, for each entry of its tile in depth order:
//   power = -1/2 (a dx^2 + c dy^2) - b dx dy;   skip if power > 0
//   alpha = min(0.99, o * expf(power));         skip if alpha < 1/255
//   if T (1 - alpha) < 1e-4: the pixel is done (break, T unchanged)
//   C += rgb alpha T;  D += invdepth alpha T;  T *= 1 - alpha
// Outputs: color [3,H,W] (before background), inverse depth [1,H,W],
// final T [H,W], and the index of each pixel's last contributing entry
// [H,W] (-1: none), from which the backward kernel (K2) will walk back.
//
// Design: one block of 256 threads per tile, one thread per pixel. The
// block walks its [start, start + count) entry range in batches of 256:
// one thread per entry gathers the entry's Gaussian into shared memory in
// struct-of-arrays form (~11 KB), then every pixel blends the batch.
// __syncthreads_count ends the walk once every pixel of the tile is done;
// pixels past the image edge load entries but start as done.
//
// What bounds it on the H100: each evaluated (entry, pixel) pair costs
// about 20 FP32 operations including one expf (67 TFLOP/s), each entry
// reads about 44 bytes and each pixel writes 24 (3.35 TB/s). With 256
// pixels per entry the operations bind unless tiles are very shallow.
// Compiled without --use_fast_math so expf (not __expf) keeps parity with
// the plain version. Speed work -- warp-level culling of entries that miss
// a warp's pixels, and a cooperative load of the next batch while the
// current one blends -- is for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;

__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float* __restrict__ means2d,    // [N, 2]
                 const float* __restrict__ conic,      // [N, 3]
                 const float* __restrict__ rgb,        // [N, 3]
                 const float* __restrict__ opacity,    // [N]
                 const float* __restrict__ inv_depth,  // [N]
                 const int* __restrict__ gauss_idx,    // [D]
                 const int* __restrict__ tile_start,   // [T]
                 const int* __restrict__ tile_count,   // [T]
                 int height, int width, int tiles_x,
                 float* __restrict__ out_color,        // [3, H, W]
                 float* __restrict__ out_invdepth,     // [H, W]
                 float* __restrict__ out_trans,        // [H, W]
                 int* __restrict__ out_last) {         // [H, W]
  __shared__ float s_mx[kBlock], s_my[kBlock];
  __shared__ float s_ca[kBlock], s_cb[kBlock], s_cc[kBlock];
  __shared__ float s_op[kBlock], s_id[kBlock];
  __shared__ float s_r[kBlock], s_g[kBlock], s_b[kBlock];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (tile % tiles_x) * kTile + tid % kTile;
  const int py = (tile / tiles_x) * kTile + tid / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  bool done = !inside;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dsum = 0.0f;
  int last = -1;

  for (int base = 0; base < count; base += kBlock) {
    // Uniform across the block: every thread reaches it, and all see the
    // same count, so the break is uniform too.
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + tid;
    if (k < count) {
      const int g = gauss_idx[start + k];
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
    const int n = min(kBlock, count - base);
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float dx = fx - s_mx[j];
        const float dy = fy - s_my[j];
        const float power = -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy)
                            - s_cb[j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, s_op[j] * expf(power));
        if (alpha < kAlphaEps) continue;
        const float next_T = T * (1.0f - alpha);
        if (next_T < kTransEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        c0 += w * s_r[j];
        c1 += w * s_g[j];
        c2 += w * s_b[j];
        dsum += w * s_id[j];
        T = next_T;
        last = start + base + j;
      }
    }
    // The next batch overwrites shared memory.
    __syncthreads();
  }

  if (inside) {
    const int hw = height * width;
    const int p = py * width + px;
    out_color[p] = c0;
    out_color[hw + p] = c1;
    out_color[2 * hw + p] = c2;
    out_invdepth[p] = dsum;
    out_trans[p] = T;
    out_last[p] = last;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int blend_fwd_launch(const float* means2d, const float* conic,
                                const float* rgb, const float* opacity,
                                const float* inv_depth, const int* gauss_idx,
                                const int* tile_start, const int* tile_count,
                                int n_tiles, int tiles_x, int height,
                                int width, float* out_color,
                                float* out_invdepth, float* out_trans,
                                int* out_last, void* stream) {
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        means2d, conic, rgb, opacity, inv_depth, gauss_idx, tile_start,
        tile_count, height, width, tiles_x, out_color, out_invdepth,
        out_trans, out_last);
  }
  return static_cast<int>(cudaGetLastError());
}
