// Fused photometric loss (K3): (1-l) mean|x-y| + l (1 - mean SSIM) over a
// [3, H, W] prediction x and target y, and its gradient with respect to x.
//
// Replaces the TPU kernel h3dgs_tpu/ops/pallas_ssim.py:_ssim_kernel
// (launched by _run through _fused_loss / fused_photometric_loss). The
// math is that module's (l.13-30): with G the 11-tap sigma-1.5 Gaussian
// window and zero padding,
//   u = G*x, v = G*y, P = G*x^2, Q = G*y^2, R = G*xy,
//   A1 = 2uv + c1, A2 = 2(R - uv) + c2, B1 = u^2 + v^2 + c1,
//   B2 = max((P - u^2) + (Q - v^2) + c2, c2 / 2)     (the clamp, l.151),
//   map = A1 A2 / (B1 B2),
//   c_u = s (2v (A2 - A1) / (B1 B2) - 2u map (1/B1 - 1/B2)),
//   c_P = s (-map / B2), c_R = s (2 A1 / (B1 B2)), s = -l / (3HW),
//   grad = G*c_u + 2x (G*c_P) + y (G*c_R) + (1-l) sign(x-y) / (3HW).
//
// Design (simple and correct first), three launches on one stream:
//   A. per 32x32 output tile of one channel: x and y with a 5-pixel halo
//      (zero outside the image) in shared memory; the five fields blurred
//      along rows then columns; the map; c_u, c_P, c_R written to global
//      memory (zero outside the image by construction of B's loads); the
//      block's sums of |x-y| and of the map, reduced in a fixed tree order.
//   B. per tile: the three coefficient fields with the same halo scheme,
//      blurred once more, and the gradient assembled.
//   C. one block sums the per-block partials in a fixed order (double), so
//      the loss is deterministic, and writes it.
// The window weights are computed on the host exactly as _window() and
// copied into __constant__ memory before the launches. float32 throughout
// (no TF32, no fast math), built with -fmad=false (ops/kernels.py) so each
// product and sum rounds as in the plain version's separate PyTorch
// kernels: the variance terms cancel, and the loss is held to the plain
// version within 1e-6.
//
// What bounds it on the H100: about 400 FP32 operations per channel pixel
// (8 blurred fields x 2 passes x 11 taps x 2, plus the map and the
// coefficients) against 67 TFLOP/s, and 36 bytes per pixel (x and y read,
// the gradient written) against 3.35 TB/s: the operations bind. Launch A
// writes and launch B reads back 36 B per pixel of coefficient fields;
// fusing A and B behind a 10-pixel halo removes that traffic and is later
// speed work.
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;
constexpr int kRad = kWin / 2;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kHaloW = kTileW + 2 * kRad;
constexpr int kHaloH = kTileH + 2 * kRad;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsPerThread = kTileH / kThreadsY;
// c1 = 0.01^2 and c2 = 0.03^2 rounded once to float32, as the plain
// version's Python constants are.
constexpr float kC1 = 1.0e-4f;
constexpr float kC2 = 9.0e-4f;

__constant__ float c_win[kWin];

// Fixed-order tree sum of one value per thread; the result is valid in
// thread 0. ``buf`` holds kThreads floats.
__device__ float block_sum(float v, float* buf) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] += buf[tid + s];
    __syncthreads();
  }
  return buf[0];
}

__device__ __forceinline__ float load_or_zero(const float* img, int gy,
                                              int gx, int h, int w) {
  return (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
ssim_fields_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   int h, int w, float coef_scale,
                   float* __restrict__ c_u, float* __restrict__ c_p,
                   float* __restrict__ c_r, float* __restrict__ partial) {
  __shared__ float sx[kHaloH][kHaloW];
  __shared__ float sy[kHaloH][kHaloW];
  __shared__ float vb[5][kTileH][kHaloW];   // column-blurred fields
  __shared__ float red[kThreads];

  const int ch = blockIdx.z;
  const int ox = blockIdx.x * kTileW;
  const int oy = blockIdx.y * kTileH;
  const size_t base = static_cast<size_t>(ch) * h * w;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int r = i / kHaloW, c = i % kHaloW;
    sx[r][c] = load_or_zero(x + base, oy - kRad + r, ox - kRad + c, h, w);
    sy[r][c] = load_or_zero(y + base, oy - kRad + r, ox - kRad + c, h, w);
  }
  __syncthreads();

  // Blur along the rows (H) first, as utils/losses._blur does.
  for (int i = tid; i < kTileH * kHaloW; i += kThreads) {
    const int r = i / kHaloW, c = i % kHaloW;
    float u = 0.0f, v = 0.0f, p = 0.0f, q = 0.0f, s = 0.0f;
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const float wj = c_win[j];
      const float a = sx[r + j][c];
      const float b = sy[r + j][c];
      u += wj * a;
      v += wj * b;
      p += wj * (a * a);
      q += wj * (b * b);
      s += wj * (a * b);
    }
    vb[0][r][c] = u;
    vb[1][r][c] = v;
    vb[2][r][c] = p;
    vb[3][r][c] = q;
    vb[4][r][c] = s;
  }
  __syncthreads();

  float l1 = 0.0f, ss = 0.0f;
  const int c = threadIdx.x;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + kThreadsY * k;
    const int gy = oy + r, gx = ox + c;
    float f[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) acc += c_win[j] * vb[m][r][c + j];
      f[m] = acc;
    }
    if (gy < h && gx < w) {
      const float u = f[0], v = f[1];
      const float a1 = 2.0f * u * v + kC1;
      const float a2 = 2.0f * (f[4] - u * v) + kC2;
      const float b1 = u * u + v * v + kC1;
      const float b2 = fmaxf((f[2] - u * u) + (f[3] - v * v) + kC2,
                             0.5f * kC2);
      const float inv_b1 = 1.0f / b1;
      const float inv_b2 = 1.0f / b2;
      const float inv_d = inv_b1 * inv_b2;
      const float smap = a1 * a2 * inv_d;
      const size_t o = base + static_cast<size_t>(gy) * w + gx;
      c_u[o] = coef_scale * (2.0f * v * (a2 - a1) * inv_d
                             - 2.0f * u * smap * (inv_b1 - inv_b2));
      c_p[o] = coef_scale * (-smap * inv_b2);
      c_r[o] = coef_scale * (2.0f * a1 * inv_d);
      l1 += fabsf(sx[r + kRad][c + kRad] - sy[r + kRad][c + kRad]);
      ss += smap;
    }
  }
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                  + blockIdx.x;
  const float l1_sum = block_sum(l1, red);
  __syncthreads();
  const float ss_sum = block_sum(ss, red);
  if (tid == 0) {
    partial[2 * blk] = l1_sum;
    partial[2 * blk + 1] = ss_sum;
  }
}

__global__ void __launch_bounds__(kThreads)
ssim_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ c_u, const float* __restrict__ c_p,
                 const float* __restrict__ c_r, int h, int w,
                 float l1_scale, float* __restrict__ grad) {
  __shared__ float sc[3][kHaloH][kHaloW];
  __shared__ float vb[3][kTileH][kHaloW];

  const int ch = blockIdx.z;
  const int ox = blockIdx.x * kTileW;
  const int oy = blockIdx.y * kTileH;
  const size_t base = static_cast<size_t>(ch) * h * w;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  for (int i = tid; i < kHaloH * kHaloW; i += kThreads) {
    const int r = i / kHaloW, c = i % kHaloW;
    const int gy = oy - kRad + r, gx = ox - kRad + c;
    sc[0][r][c] = load_or_zero(c_u + base, gy, gx, h, w);
    sc[1][r][c] = load_or_zero(c_p + base, gy, gx, h, w);
    sc[2][r][c] = load_or_zero(c_r + base, gy, gx, h, w);
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kHaloW; i += kThreads) {
    const int r = i / kHaloW, c = i % kHaloW;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) acc += c_win[j] * sc[m][r + j][c];
      vb[m][r][c] = acc;
    }
  }
  __syncthreads();

  const int c = threadIdx.x;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + kThreadsY * k;
    const int gy = oy + r, gx = ox + c;
    if (gy >= h || gx >= w) continue;
    float f[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) acc += c_win[j] * vb[m][r][c + j];
      f[m] = acc;
    }
    const size_t o = base + static_cast<size_t>(gy) * w + gx;
    const float xv = x[o], yv = y[o];
    const float d = xv - yv;
    const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    grad[o] = f[0] + 2.0f * xv * f[1] + yv * f[2] + l1_scale * sgn;
  }
}

__global__ void __launch_bounds__(kThreads)
ssim_loss_kernel(const float* __restrict__ partial, int n_blocks,
                 double inv_n, double lam, float* __restrict__ loss) {
  __shared__ double buf[2][kThreads];
  const int tid = threadIdx.x;
  double l1 = 0.0, ss = 0.0;
  for (int i = tid; i < n_blocks; i += kThreads) {
    l1 += static_cast<double>(partial[2 * i]);
    ss += static_cast<double>(partial[2 * i + 1]);
  }
  buf[0][tid] = l1;
  buf[1][tid] = ss;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      buf[0][tid] += buf[0][tid + s];
      buf[1][tid] += buf[1][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    loss[0] = static_cast<float>((1.0 - lam) * buf[0][0] * inv_n
                                 + lam * (1.0 - buf[1][0] * inv_n));
  }
}

}  // namespace

// Number of per-block partial pairs launch A writes for an h x w image.
extern "C" int ssim_num_blocks(int h, int w) {
  return 3 * ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
}

// Plain C entry point for ctypes. ``window`` is the host's 11 weights.
// Scratch (c_u, c_p, c_r: [3, h, w]; partial: [2 * ssim_num_blocks]) and
// outputs (grad [3, h, w], loss [1]) are allocated by the caller. Launches
// on the caller's stream, does not synchronise, and returns the first CUDA
// error (0 for none).
extern "C" int ssim_launch(const float* pred, const float* target, int h,
                           int w, float lam, const float* window,
                           float* c_u, float* c_p, float* c_r,
                           float* partial, float* grad, float* loss,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_win, window,
                                            kWin * sizeof(float), 0,
                                            cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, 3);
  const double n = 3.0 * static_cast<double>(h) * static_cast<double>(w);
  ssim_fields_kernel<<<grid, block, 0, stream>>>(
      pred, target, h, w, static_cast<float>(-lam / n), c_u, c_p, c_r,
      partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_grad_kernel<<<grid, block, 0, stream>>>(
      pred, target, c_u, c_p, c_r, h, w,
      static_cast<float>((1.0 - lam) / n), grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_loss_kernel<<<1, kThreads, 0, stream>>>(
      partial, static_cast<int>(grid.x * grid.y * grid.z), 1.0 / n,
      static_cast<double>(lam), loss);
  return static_cast<int>(cudaGetLastError());
}
