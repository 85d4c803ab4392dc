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
// What bounds it on the H100: about 400 FP32 operations per channel pixel
// (8 blurred fields x 2 passes x 11 taps x 2, plus the map and the
// coefficients) against 67 TFLOP/s; 12 bytes per channel pixel (x and y
// read, the gradient written) against 3.35 TB/s is the smaller time. The
// operations bind, so the design spends its effort on instruction slots
// and shared-memory loads, and keeps the coefficient fields out of global
// memory altogether.
//
// Design: ONE launch. A block of kThreads threads owns a strip of one
// channel, kThreads columns wide and rows_per_block + 21 rows tall, and
// walks down it one image row a step; thread t owns column
// ox - 10 + t. The two blurs of the gradient reach 10 pixels, so the
// inner kThreads - 20 columns and rows_per_block rows are the block's
// outputs and the rim is recomputed by its neighbours. Per step:
//   1. the thread's x and y of the new row (loaded a step ahead) go to a
//      shared row buffer, with the coefficient row the previous step
//      finished; one __syncthreads();
//   2. the five fields are blurred along the row from the shared x and y
//      (22 shared loads for 55 multiply-adds: the products x^2, y^2, xy
//      are recomputed per tap, which costs the same issue slots as
//      loading them would and less shared memory);
//   3. the blur down the column is a sliding window in registers in
//      scatter form: the row's value is added with tap j into the
//      accumulator of output row i + 5 - j, 11 accumulators per field in a
//      ring that the step's phase (step mod 11, a compile-time constant of
//      the walk unrolled over the window) indexes statically; the
//      accumulator of row i - 5 is then complete. No shared load at all
//      for this pass, and no register moves (a ring that shifts inside a
//      loop body not unrolled costs 88 MOVs a step: measured, dropped);
//   4. the map and the three coefficients of row i - 5 (zero outside the
//      image, which is the second blur's zero padding);
//   5. the same two passes over the three coefficients of row i - 6: along
//      the row from shared memory (33 loads), down the column in a second
//      register ring; row i - 11 of the gradient is complete and stored.
// Buffers are double (step parity), so one barrier a step suffices. The
// 11 taps arrive as a by-value kernel argument (the constant bank), no
// copy per call. The two sums are kept per thread in float32 over at most
// 11 rows and then in float64; a block writes its float64 partials, takes
// a ticket (atomicAdd after __threadfence()), and the last block sums all
// partials in index order, so the loss is deterministic. The launch zeroes
// the ticket on the stream first, so a launch that failed or was cut short
// leaves nothing behind for the next.
//
// Rounding. The blur accumulations are fused multiply-adds (__fmaf_rn, one
// rounding each, in the plain version's tap order). Everything that
// cancels or divides -- the variance terms (P - u^2) + (Q - v^2) and
// R - uv, the map and the coefficient algebra -- is written with
// __fmul_rn / __fadd_rn / __fsub_rn / __frcp_rn in the plain version's
// order, so the compiler cannot contract it. The kernel is not bit-equal
// to the plain version: it blurs along the row first and the plain version
// down the column first, and its taps round once where the plain version's
// round twice (with separate roundings it is still not equal, and a third
// slower). It is held to the reference's kernel test's bounds against the
// plain version on that test's images, and on trained and dark images to
// the float64 plain version (chip_smoke.py, tests/test_torch_cuda.py).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;
constexpr int kRad = kWin / 2;
constexpr int kHalo = 2 * kRad;                 // two blurs deep
constexpr int kThreads = 128;                   // strip columns per block
constexpr int kTileW = kThreads - 2 * kHalo;    // output columns per block
constexpr int kRowLen = kThreads + 2 * kRad;    // shared row, 5 pads a side
constexpr int kMinBlocksPerSM = 3;
// c1 = 0.01^2 and c2 = 0.03^2 rounded once to float32, as the plain
// version's Python constants are.
constexpr float kC1 = 1.0e-4f;
constexpr float kC2 = 9.0e-4f;

struct Taps {
  float w[kWin];
};

// One parity's shared rows: x, y and the three coefficient fields, each
// with five zero pads a side; a thread reaches all of them from one base
// address with immediate offsets.
struct Rows {
  float f[5][kRowLen];
};
constexpr int kRowsFloats = 5 * kRowLen;

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
ssim_fused_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  int h, int w, int rows_per_block, Taps taps,
                  float coef_scale, float l1_scale, double inv_n, double lam,
                  float* __restrict__ grad, double* __restrict__ partial,
                  unsigned int* __restrict__ ticket,
                  float* __restrict__ loss) {
  __shared__ Rows buf[2];
  __shared__ double red[2][kThreads];
  __shared__ bool is_last;

  const int t = threadIdx.x;
  const int ox = blockIdx.x * kTileW;
  const int oy = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, h - oy);
  const int gx = ox - kHalo + t;
  const bool col_in = gx >= 0 && gx < w;
  const bool col_owned = t >= kHalo && t < kThreads - kHalo && gx < w;

  // The five columns either side of the strip read as zero; they feed
  // only the strip's rim, which no output of this block depends on.
  if (t < kRad) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int k = 0; k < 5; ++k)
        buf[b].f[k][t] = buf[b].f[k][kRowLen - 1 - t] = 0.0f;
    }
  }
  float* const mine = &buf[0].f[0][t + kRad];

  // Element offset of (row i + 1, column gx) in the channel, carried from
  // step to step (it leaves the image above and below: tested, never
  // dereferenced there).
  const long long chan = static_cast<long long>(blockIdx.z) * h * w;
  long long next = chan + static_cast<long long>(oy - kHalo) * w + gx;
  const long long back = static_cast<long long>(kHalo + 3) * w;

  float a1[5][kWin] = {};    // column rings of u, v, P, Q, R
  float a2[3][kWin] = {};    // column rings of G*c_u, G*c_P, G*c_R
  float cu = 0.0f, cp = 0.0f, cr = 0.0f;   // coefficients of row i - 6
  float xn = 0.0f, yn = 0.0f;
  if (col_in && oy - kHalo >= 0) {
    xn = x[next];
    yn = y[next];
  }
  next += w;
  double l1_sum = 0.0, ss_sum = 0.0;

  // Step s takes input row i = oy - 10 + s, finishes the fields of row
  // i - 5 and the gradient of row i - 11. The walk is unrolled over the
  // window so that the rings' slots are compile-time registers.
  const int steps = rows + 2 * kHalo + 1;
  for (int s0 = 0; s0 < steps; s0 += kWin) {
    float l1 = 0.0f, ss = 0.0f;
#pragma unroll
    for (int p = 0; p < kWin; ++p) {        // p = s mod 11, static
      const int s = s0 + p;
      if (s < steps) {                      // uniform over the block
        float* const m = mine + (s & 1) * kRowsFloats;
        const float xv = xn, yv = yn;
        m[0] = xv;
        m[kRowLen] = yv;
        m[2 * kRowLen] = cu;
        m[3 * kRowLen] = cp;
        m[4 * kRowLen] = cr;
        // Row i is the block's own for kHalo <= s < kHalo + rows.
        if (col_owned && s >= kHalo && s < kHalo + rows)
          l1 += fabsf(xv - yv);
        xn = yn = 0.0f;
        if (col_in && static_cast<unsigned>(oy - kHalo + s + 1)
                          < static_cast<unsigned>(h)) {
          xn = x[next];
          yn = y[next];
        }
        next += w;
        __syncthreads();

        // Stage 1 along the row.
        const float* const r = m - kRad;
        float hu = 0.0f, hv = 0.0f, hp = 0.0f, hq = 0.0f, hr = 0.0f;
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          const float wj = taps.w[j];
          const float a = r[j];
          const float c = r[kRowLen + j];
          hu = __fmaf_rn(wj, a, hu);
          hv = __fmaf_rn(wj, c, hv);
          hp = __fmaf_rn(wj, __fmul_rn(a, a), hp);
          hq = __fmaf_rn(wj, __fmul_rn(c, c), hq);
          hr = __fmaf_rn(wj, __fmul_rn(a, c), hr);
        }
        // Stage 1 down the column: tap j of row i lands in row i + 5 - j.
        // Tap 0 opens a slot (the one the step before emptied), so it is
        // a product, not a sum onto a zeroed register.
        a1[0][(p + kRad) % kWin] = __fmul_rn(taps.w[0], hu);
        a1[1][(p + kRad) % kWin] = __fmul_rn(taps.w[0], hv);
        a1[2][(p + kRad) % kWin] = __fmul_rn(taps.w[0], hp);
        a1[3][(p + kRad) % kWin] = __fmul_rn(taps.w[0], hq);
        a1[4][(p + kRad) % kWin] = __fmul_rn(taps.w[0], hr);
#pragma unroll
        for (int j = 1; j < kWin; ++j) {
          const int slot = (p + kRad - j + kWin) % kWin;
          const float wj = taps.w[j];
          a1[0][slot] = __fmaf_rn(wj, hu, a1[0][slot]);
          a1[1][slot] = __fmaf_rn(wj, hv, a1[1][slot]);
          a1[2][slot] = __fmaf_rn(wj, hp, a1[2][slot]);
          a1[3][slot] = __fmaf_rn(wj, hq, a1[3][slot]);
          a1[4][slot] = __fmaf_rn(wj, hr, a1[4][slot]);
        }
        const int d1 = (p + kRad + 1) % kWin;   // row i - 5 is complete
        const float u = a1[0][d1], v = a1[1][d1];
        const float fp2 = a1[2][d1], fq2 = a1[3][d1], fr2 = a1[4][d1];

        // The map and the coefficients of row i - 5; zero outside the
        // image and before the ring has seen 11 rows.
        cu = cp = cr = 0.0f;
        if (s >= kHalo && col_in
            && static_cast<unsigned>(oy - kHalo - kRad + s)
                   < static_cast<unsigned>(h)) {
          const float uv = __fmul_rn(u, v);
          const float uu = __fmul_rn(u, u);
          const float vv = __fmul_rn(v, v);
          const float A1 = __fadd_rn(__fmul_rn(2.0f, uv), kC1);
          const float A2 = __fadd_rn(__fmul_rn(2.0f, __fsub_rn(fr2, uv)),
                                     kC2);
          const float B1 = __fadd_rn(__fadd_rn(uu, vv), kC1);
          const float B2 = fmaxf(
              __fadd_rn(__fadd_rn(__fsub_rn(fp2, uu), __fsub_rn(fq2, vv)),
                        kC2),
              0.5f * kC2);
          const float inv_b1 = __frcp_rn(B1);
          const float inv_b2 = __frcp_rn(B2);
          const float inv_d = __fmul_rn(inv_b1, inv_b2);
          const float smap = __fmul_rn(__fmul_rn(A1, A2), inv_d);
          cu = __fmul_rn(
              coef_scale,
              __fsub_rn(
                  __fmul_rn(__fmul_rn(__fmul_rn(2.0f, v), __fsub_rn(A2, A1)),
                            inv_d),
                  __fmul_rn(__fmul_rn(__fmul_rn(2.0f, u), smap),
                            __fsub_rn(inv_b1, inv_b2))));
          cp = __fmul_rn(coef_scale, __fmul_rn(-smap, inv_b2));
          cr = __fmul_rn(coef_scale, __fmul_rn(__fmul_rn(2.0f, A1), inv_d));
          if (col_owned && s >= kHalo + kRad && s < kHalo + kRad + rows)
            ss += smap;
        }

        // Stage 2 along the row, over the coefficients of row i - 6.
        float gu = 0.0f, gp = 0.0f, gr = 0.0f;
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          const float wj = taps.w[j];
          gu = __fmaf_rn(wj, r[2 * kRowLen + j], gu);
          gp = __fmaf_rn(wj, r[3 * kRowLen + j], gp);
          gr = __fmaf_rn(wj, r[4 * kRowLen + j], gr);
        }
        // Stage 2 down the column: tap j of row i - 6 lands in row
        // i - 1 - j; row i - 11 is complete, in slot p.
        a2[0][(p + kWin - 1) % kWin] = __fmul_rn(taps.w[0], gu);
        a2[1][(p + kWin - 1) % kWin] = __fmul_rn(taps.w[0], gp);
        a2[2][(p + kWin - 1) % kWin] = __fmul_rn(taps.w[0], gr);
#pragma unroll
        for (int j = 1; j < kWin; ++j) {
          const int slot = (p + kWin - 1 - j) % kWin;
          const float wj = taps.w[j];
          a2[0][slot] = __fmaf_rn(wj, gu, a2[0][slot]);
          a2[1][slot] = __fmaf_rn(wj, gp, a2[1][slot]);
          a2[2][slot] = __fmaf_rn(wj, gr, a2[2][slot]);
        }
        const float fu = a2[0][p], fp = a2[1][p], fr = a2[2][p];

        if (s > 2 * kHalo && col_owned) {
          const long long o = next - back;     // (row i - 11, column gx)
          const float xo = x[o], yo = y[o];
          const float d = xo - yo;
          const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
          grad[o] = __fadd_rn(
              __fadd_rn(__fadd_rn(fu, __fmul_rn(__fmul_rn(2.0f, xo), fp)),
                        __fmul_rn(yo, fr)),
              __fmul_rn(l1_scale, sgn));
        }
      }
    }
    l1_sum += static_cast<double>(l1);
    ss_sum += static_cast<double>(ss);
  }

  // Block sums in a fixed tree order, then the ticket.
  red[0][t] = l1_sum;
  red[1][t] = ss_sum;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) {
      red[0][t] += red[0][t + k];
      red[1][t] += red[1][t + k];
    }
    __syncthreads();
  }
  const unsigned int n_blocks = gridDim.x * gridDim.y * gridDim.z;
  if (t == 0) {
    const unsigned int blk =
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[2 * blk] = red[0][0];
    partial[2 * blk + 1] = red[1][0];
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last block to finish: every partial, in index order.
  __threadfence();
  double l1_all = 0.0, ss_all = 0.0;
  for (unsigned int k = t; k < n_blocks; k += kThreads) {
    l1_all += __ldcg(partial + 2 * k);
    ss_all += __ldcg(partial + 2 * k + 1);
  }
  red[0][t] = l1_all;
  red[1][t] = ss_all;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) {
      red[0][t] += red[0][t + k];
      red[1][t] += red[1][t + k];
    }
    __syncthreads();
  }
  if (t == 0) {
    loss[0] = static_cast<float>((1.0 - lam) * red[0][0] * inv_n
                                 + lam * (1.0 - red[1][0] * inv_n));
  }
}

}  // namespace

// Output columns a block owns: the wrapper sizes the grid from it.
extern "C" int ssim_tile_width() { return kTileW; }

// (resident blocks per SM, threads per block) on the current device.
extern "C" int ssim_occupancy(int* blocks_per_sm, int* threads) {
  *threads = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fused_kernel, kThreads, 0));
}

// Plain C entry point for ctypes. ``window`` is the host's 11 weights,
// passed on to the kernel by value. ``partial`` ([2 * blocks] float64) and
// ``ticket`` ([1] uint32, zeroed here on the stream before the launch) are
// the caller's scratch, ``grad`` [3, h, w] and ``loss`` [1] its outputs. The grid is ceil(w / ssim_tile_width()) x
// ceil(h / rows_per_block) x 3. Launches on the caller's stream, does not
// synchronise, and returns the first CUDA error (0 for none).
extern "C" int ssim_launch(const float* pred, const float* target, int h,
                           int w, int rows_per_block, double lam,
                           const float* window, double* partial,
                           unsigned int* ticket, float* grad, float* loss,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Taps taps;
  for (int j = 0; j < kWin; ++j) taps.w[j] = window[j];
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + rows_per_block - 1) / rows_per_block, 3);
  const double n = 3.0 * static_cast<double>(h) * static_cast<double>(w);
  const cudaError_t err =
      cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_fused_kernel<<<grid, kThreads, 0, stream>>>(
      pred, target, h, w, rows_per_block, taps,
      static_cast<float>(-lam / n), static_cast<float>((1.0 - lam) / n),
      1.0 / n, lam, grad, partial, ticket, loss);
  return static_cast<int>(cudaGetLastError());
}
