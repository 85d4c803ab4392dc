// Gaussian projection (K4): the forward (project_fwd_kernel) and its
// backward (project_bwd_kernel), one thread per Gaussian row each.
//
// Replaces no TPU kernel: the JAX package projects with XLA
// (h3dgs_tpu/ops/projection.py:project_gaussians), and the port first
// wrote the same per-component arithmetic as plain torch ops
// (ops/projection.py:project_plain). On the card that was ~420 launches
// a forward and ~780 an autograd backward (every select of a component
// gets a full-size zero buffer in the backward, which autograd then
// accumulates), ~49 KB of device traffic a row at SH degree 3, and about
// half of a training step's launches. The 3DGS-family rasterizers do the
// same work in two hand-written kernels (preprocessCUDA with
// computeColorFromSH, and their backward).
//
// What it computes is ops/projection.py:project_plain, term for term and
// in its order: the view and clip transforms, ndc2pix, the normalised
// quaternion's rotation, Sigma = (R S)(R S)^T, the tan-clamped Jacobian
// (1.3 tan(fov / 2)), cov2d = J W Sigma W^T J^T + 0.3 I, the det > 0
// guard, the conic, radius ceil(3 sqrt(lambda1)), the near (0.2) and
// opacity (1/255) culls, and the SH colour + 0.5 clamped at 0. Compiled
// with -fmad=false (ops/kernels.py), so that every product and sum rounds
// once as torch's separate elementwise ops do; the camera's focal lengths
// are formed as torch forms them (reciprocal, then a product).
//
// The backward recomputes those terms from the inputs and applies the
// closed-form adjoint of each (ops/projection.py:project_backward_plain is
// the same formulas in torch, held there against autograd). It saves no
// per-row intermediate. Its subgradients are torch's: a clamp passes the
// gradient where min <= x <= max, clamp_min where x >= min, the det > 0
// guard blocks the inverse determinant's gradient, and the +eps of the
// quaternion's norm and the 1e-12 floor of the view direction's norm are
// kept. A null incoming gradient is zero.
//
// What bounds it on the H100: bytes. At SH degree 3 the forward reads
// 236 B a row (means 12, scales 12, quaternion 16, opacity 4, SH 192)
// and writes 41 (means2d 8, conic 12, rgb 12, depth 4, radius 4, valid
// 1); the backward reads 268 (the inputs but the opacity, and the
// incoming gradients 36) and writes 232. About 300 and 1,000 FP32
// operations a row are far below the 67 TFLOP/s line. At the training
// step's 1.10M rows that is ~0.30 + ~0.55 GB, ~0.09 + ~0.16 ms at
// 3.35 TB/s.
//
// Design. A block of 128 threads owns 128 consecutive rows. Its SH rows
// (192 B each at degree 3) are copied into shared memory by the whole
// block, neighbouring threads on neighbouring words, so a warp's loads
// are coalesced; each thread then reads its own row there, at an odd
// pitch so that the 32 threads of a warp hit 32 banks. The backward
// writes its SH gradient into the same tile and the block stores it the
// same way, zero past the degree's coefficients. The other rows (12-16 B)
// are read and written by their own thread: a warp's accesses cover
// contiguous 256-512 B spans. The camera is staged once a block in shared
// memory. Every per-row input may lie at any row stride with its
// components adjacent (the cut's columns are views of a wider table), and
// so may each incoming gradient (K2 hands them out as views of its
// 12-float rows), so the wrapper copies nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

// SH constants: the plain version's float64 constants rounded once to
// float32, as torch rounds a Python scalar.
constexpr float kC0 = float(0.28209479177387814);
constexpr float kC1 = float(0.4886025119029199);
constexpr float kC2_0 = float(1.0925484305920792);
constexpr float kC2_1 = float(-1.0925484305920792);
constexpr float kC2_2 = float(0.31539156525252005);
constexpr float kC2_3 = float(-1.0925484305920792);
constexpr float kC2_4 = float(0.5462742152960396);
constexpr float kC3_0 = float(-0.5900435899266435);
constexpr float kC3_1 = float(2.890611442640554);
constexpr float kC3_2 = float(-0.4570457994644658);
constexpr float kC3_3 = float(0.3731763325901154);
constexpr float kC3_4 = float(-0.4570457994644658);
constexpr float kC3_5 = float(1.445305721320277);
constexpr float kC3_6 = float(-0.5900435899266435);
constexpr float kC4_0 = float(2.5033429417967046);
constexpr float kC4_1 = float(-1.7701307697799304);
constexpr float kC4_2 = float(0.9461746957575601);
constexpr float kC4_3 = float(-0.6690465435572892);
constexpr float kC4_4 = float(0.10578554691520431);
constexpr float kC4_5 = float(-0.6690465435572892);
constexpr float kC4_6 = float(0.47308734787878004);
constexpr float kC4_7 = float(-1.7701307697799304);
constexpr float kC4_8 = float(0.6258357354491761);
constexpr float kNearZ = 0.2f;
constexpr float kDilation = 0.3f;
constexpr float kAlphaMin = float(1.0 / 255.0);

// Coefficients of a degree (0 for colours given, DEG = -1), and the
// shared tile's pitch in floats: odd, so a warp's rows hit 32 banks.
template <int DEG>
struct Sh {
  static constexpr int kCoefs = DEG < 0 ? 0 : (DEG + 1) * (DEG + 1);
  static constexpr int kFloats = 3 * kCoefs;
  static constexpr int kPitch = kFloats | 1;
};

struct Cam {
  float view[16];   // world -> camera, row-major
  float proj[16];   // full projection, row-major
  float center[3];
  float fx, fy, limx, limy, width, height;
};

// Per-row inputs: a pointer and its row stride in floats.
struct Rows {
  const float* p;
  long long stride;
};

__device__ void stage_camera(Cam& cam, const float* view, const float* proj,
                             const float* center, const float* tanx,
                             const float* tany, int width, int height) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam.view[t] = view[t];
    cam.proj[t] = proj[t];
  }
  if (t < 3) cam.center[t] = center[t];
  if (t == 0) {
    const float tx = *tanx, ty = *tany;
    // Camera.focal_x: width / (2 tan) is reciprocal(2 tan) * width.
    cam.fx = (1.0f / (2.0f * tx)) * float(width);
    cam.fy = (1.0f / (2.0f * ty)) * float(height);
    cam.limx = 1.3f * tx;
    cam.limy = 1.3f * ty;
    cam.width = float(width);
    cam.height = float(height);
  }
}

// The block's SH rows [r0, r0 + rows) into the tile, coalesced.
template <int DEG>
__device__ void stage_sh(float* tile, const float* shs, long long stride,
                         long long r0, int rows) {
  constexpr int F = Sh<DEG>::kFloats, P = Sh<DEG>::kPitch;
  const float* base = shs + r0 * stride;
  for (int idx = threadIdx.x; idx < rows * F; idx += kBlock) {
    const int r = idx / F, j = idx - r * F;
    tile[r * P + j] = base[r * stride + j];
  }
}

// A row's mean, scales and quaternion, read before the block's barrier so
// that the loads fly while the SH tile is staged.
struct RowIn {
  float mean[3], scl[3], quat[4];
};

__device__ __forceinline__ void load_row(RowIn& in, const Rows& means,
                                         const Rows& scales,
                                         const Rows& quats, long long i) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    in.mean[k] = means.p[i * means.stride + k];
    in.scl[k] = scales.p[i * scales.stride + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) in.quat[k] = quats.p[i * quats.stride + k];
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // torch.clamp: NaN stays NaN.
  return v < lo ? lo : (v > hi ? hi : v);
}

// The projection's terms up to the conic (project_plain's _geometry).
struct Geo {
  float x, y, z;                  // the mean
  float pvx, pvy, depth, hx, hy, inv_w;
  float qn[4], norm;              // normalised quaternion, raw norm
  float r[3][3], s[3], l[3][3], sig[3][3];
  float tqx, tqy, tcx, tcy, tx, ty, inv_z, inv_z2;
  float j00, j02, j11, j12;
  float m0[3], m1[3], cm0[3], cm1[3];
  float a, b, c, det, inv_det;
  bool det_ok;
};

__device__ __forceinline__ float affine(const float* row, float x, float y,
                                        float z) {
  return row[0] * x + row[1] * y + row[2] * z + row[3];
}

__device__ __forceinline__ void geometry(Geo& g, const Cam& cam,
                                         const float* mean, const float* scl,
                                         const float* quat, float mod) {
  g.x = mean[0];
  g.y = mean[1];
  g.z = mean[2];
  g.pvx = affine(cam.view, g.x, g.y, g.z);
  g.pvy = affine(cam.view + 4, g.x, g.y, g.z);
  g.depth = affine(cam.view + 8, g.x, g.y, g.z);
  g.hx = affine(cam.proj, g.x, g.y, g.z);
  g.hy = affine(cam.proj + 4, g.x, g.y, g.z);
  const float hw = affine(cam.proj + 12, g.x, g.y, g.z);
  g.inv_w = 1.0f / (hw + 1e-7f);

  const float q0 = quat[0], q1 = quat[1], q2 = quat[2], q3 = quat[3];
  // torch.sum over the four squares on the card adds (0 + 2) + (1 + 3).
  g.norm = sqrtf((q0 * q0 + q2 * q2) + (q1 * q1 + q3 * q3) + 1e-12f);
  const float qw = q0 / g.norm, qx = q1 / g.norm, qy = q2 / g.norm,
              qz = q3 / g.norm;
  g.qn[0] = qw;
  g.qn[1] = qx;
  g.qn[2] = qy;
  g.qn[3] = qz;
  g.r[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.r[0][1] = 2.0f * (qx * qy - qw * qz);
  g.r[0][2] = 2.0f * (qx * qz + qw * qy);
  g.r[1][0] = 2.0f * (qx * qy + qw * qz);
  g.r[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.r[1][2] = 2.0f * (qy * qz - qw * qx);
  g.r[2][0] = 2.0f * (qx * qz - qw * qy);
  g.r[2][1] = 2.0f * (qy * qz + qw * qx);
  g.r[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
  for (int k = 0; k < 3; ++k) g.s[k] = mod * scl[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) g.l[i][k] = g.r[i][k] * g.s[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = i; k < 3; ++k) {
      g.sig[i][k] = g.l[i][0] * g.l[k][0] + g.l[i][1] * g.l[k][1] +
                    g.l[i][2] * g.l[k][2];
      g.sig[k][i] = g.sig[i][k];
    }

  const float z = g.depth;
  g.tqx = g.pvx / z;
  g.tqy = g.pvy / z;
  g.tcx = clamp_nan(g.tqx, -cam.limx, cam.limx);
  g.tcy = clamp_nan(g.tqy, -cam.limy, cam.limy);
  g.tx = g.tcx * z;
  g.ty = g.tcy * z;
  g.inv_z = 1.0f / z;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.j00 = cam.fx * g.inv_z;
  g.j02 = -cam.fx * g.tx * g.inv_z2;
  g.j11 = cam.fy * g.inv_z;
  g.j12 = -cam.fy * g.ty * g.inv_z2;
  const float* w = cam.view;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.m0[k] = g.j00 * w[k] + g.j02 * w[8 + k];
    g.m1[k] = g.j11 * w[4 + k] + g.j12 * w[8 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.cm0[k] = g.sig[k][0] * g.m0[0] + g.sig[k][1] * g.m0[1] +
               g.sig[k][2] * g.m0[2];
    g.cm1[k] = g.sig[k][0] * g.m1[0] + g.sig[k][1] * g.m1[1] +
               g.sig[k][2] * g.m1[2];
  }
  g.a = g.m0[0] * g.cm0[0] + g.m0[1] * g.cm0[1] + g.m0[2] * g.cm0[2] +
        kDilation;
  g.b = g.m0[0] * g.cm1[0] + g.m0[1] * g.cm1[1] + g.m0[2] * g.cm1[2];
  g.c = g.m1[0] * g.cm1[0] + g.m1[1] * g.cm1[1] + g.m1[2] * g.cm1[2] +
        kDilation;
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det > 0.0f;
  g.inv_det = g.det_ok ? 1.0f / g.det : 0.0f;
}

// The SH basis at a unit direction, project_plain's _sh_basis.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = kC0;
  if constexpr (DEG >= 1) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2_0 * xy;
    b[5] = kC2_1 * yz;
    b[6] = kC2_2 * (2.0f * zz - xx - yy);
    b[7] = kC2_3 * xz;
    b[8] = kC2_4 * (xx - yy);
    if constexpr (DEG >= 3) {
      b[9] = kC3_0 * y * (3.0f * xx - yy);
      b[10] = kC3_1 * xy * z;
      b[11] = kC3_2 * y * (4.0f * zz - xx - yy);
      b[12] = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC3_4 * x * (4.0f * zz - xx - yy);
      b[14] = kC3_5 * z * (xx - yy);
      b[15] = kC3_6 * x * (xx - 3.0f * yy);
    }
    if constexpr (DEG >= 4) {
      b[16] = kC4_0 * xy * (xx - yy);
      b[17] = kC4_1 * yz * (3.0f * xx - yy);
      b[18] = kC4_2 * xy * (7.0f * zz - 1.0f);
      b[19] = kC4_3 * yz * (7.0f * zz - 3.0f);
      b[20] = kC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = kC4_5 * xz * (7.0f * zz - 3.0f);
      b[22] = kC4_6 * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = kC4_7 * xz * (xx - 3.0f * yy);
      b[24] = kC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// d/d(x, y, z) of sum_i gb[i] basis[i]: ops/projection.py:_sh_basis_grad.
template <int DEG>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z,
                                              const float* gb, float& gx,
                                              float& gy, float& gz) {
  gx = gy = gz = 0.0f;
  if constexpr (DEG >= 1) {
    gx = -kC1 * gb[3];
    gy = -kC1 * gb[1];
    gz = kC1 * gb[2];
  }
  if constexpr (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += kC2_0 * y * gb[4] - 2.0f * kC2_2 * x * gb[6] +
          kC2_3 * z * gb[7] + 2.0f * kC2_4 * x * gb[8];
    gy += kC2_0 * x * gb[4] + kC2_1 * z * gb[5] -
          2.0f * kC2_2 * y * gb[6] - 2.0f * kC2_4 * y * gb[8];
    gz += kC2_1 * y * gb[5] + 4.0f * kC2_2 * z * gb[6] +
          kC2_3 * x * gb[7];
    if constexpr (DEG >= 3) {
      gx += kC3_0 * 6.0f * xy * gb[9] + kC3_1 * yz * gb[10] -
            kC3_2 * 2.0f * xy * gb[11] - kC3_3 * 6.0f * xz * gb[12] +
            kC3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
            kC3_5 * 2.0f * xz * gb[14] + kC3_6 * 3.0f * (xx - yy) * gb[15];
      gy += kC3_0 * 3.0f * (xx - yy) * gb[9] + kC3_1 * xz * gb[10] +
            kC3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11] -
            kC3_3 * 6.0f * yz * gb[12] - kC3_4 * 2.0f * xy * gb[13] -
            kC3_5 * 2.0f * yz * gb[14] - kC3_6 * 6.0f * xy * gb[15];
      gz += kC3_1 * xy * gb[10] + kC3_2 * 8.0f * yz * gb[11] +
            kC3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
            kC3_4 * 8.0f * xz * gb[13] + kC3_5 * (xx - yy) * gb[14];
    }
    if constexpr (DEG >= 4) {
      const float z7m1 = 7.0f * zz - 1.0f, z7m3 = 7.0f * zz - 3.0f;
      gx += kC4_0 * y * (3.0f * xx - yy) * gb[16] +
            kC4_1 * 6.0f * xy * z * gb[17] + kC4_2 * y * z7m1 * gb[18] +
            kC4_5 * z * z7m3 * gb[21] + kC4_6 * 2.0f * x * z7m1 * gb[22] +
            kC4_7 * 3.0f * z * (xx - yy) * gb[23] +
            kC4_8 * 4.0f * x * (xx - 3.0f * yy) * gb[24];
      gy += kC4_0 * x * (xx - 3.0f * yy) * gb[16] +
            kC4_1 * 3.0f * z * (xx - yy) * gb[17] +
            kC4_2 * x * z7m1 * gb[18] + kC4_3 * z * z7m3 * gb[19] -
            kC4_6 * 2.0f * y * z7m1 * gb[22] -
            kC4_7 * 6.0f * xy * z * gb[23] +
            kC4_8 * 4.0f * y * (yy - 3.0f * xx) * gb[24];
      gz += kC4_1 * y * (3.0f * xx - yy) * gb[17] +
            kC4_2 * 14.0f * xy * z * gb[18] +
            kC4_3 * y * (21.0f * zz - 3.0f) * gb[19] +
            kC4_4 * z * (140.0f * zz - 60.0f) * gb[20] +
            kC4_5 * x * (21.0f * zz - 3.0f) * gb[21] +
            kC4_6 * 14.0f * z * (xx - yy) * gb[22] +
            kC4_7 * x * (xx - 3.0f * yy) * gb[23];
    }
  }
}

// The offset from the camera centre and its floored inverse norm.
__device__ __forceinline__ void view_dir(const Cam& cam, const Geo& g,
                                         float* d, float& nrm,
                                         float& inv_n) {
  d[0] = g.x - cam.center[0];
  d[1] = g.y - cam.center[1];
  d[2] = g.z - cam.center[2];
  nrm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  inv_n = 1.0f / (nrm < 1e-12f ? 1e-12f : nrm);
}

struct FwdArgs {
  Rows means, scales, quats, opac, shs;
  const float *view, *proj, *center, *tanx, *tany;
  int width, height;
  float mod;
  float *means2d, *conic, *rgb, *depth;
  int* radius;
  uint8_t* valid;
};

template <int DEG>
__global__ void __launch_bounds__(kBlock)
    project_fwd_kernel(FwdArgs a, int n) {
  constexpr int NB = Sh<DEG>::kCoefs, P = Sh<DEG>::kPitch;
  __shared__ Cam cam;
  __shared__ float tile[DEG >= 0 ? kBlock * P : 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long left = n - r0;
  const int rows = left < kBlock ? static_cast<int>(left) : kBlock;
  stage_camera(cam, a.view, a.proj, a.center, a.tanx, a.tany, a.width,
               a.height);
  const int t = threadIdx.x;
  const long long i = r0 + t;
  RowIn in;
  float opac = 0.0f;
  if (t < rows) {
    load_row(in, a.means, a.scales, a.quats, i);
    opac = a.opac.p[i * a.opac.stride];
  }
  if constexpr (DEG >= 0) stage_sh<DEG>(tile, a.shs.p, a.shs.stride, r0, rows);
  __syncthreads();
  if (t >= rows) return;

  Geo g;
  geometry(g, cam, in.mean, in.scl, in.quat, a.mod);
  a.means2d[2 * i] = ((g.hx * g.inv_w + 1.0f) * cam.width - 1.0f) * 0.5f;
  a.means2d[2 * i + 1] = ((g.hy * g.inv_w + 1.0f) * cam.height - 1.0f) * 0.5f;
  a.conic[3 * i] = g.c * g.inv_det;
  a.conic[3 * i + 1] = -g.b * g.inv_det;
  a.conic[3 * i + 2] = g.a * g.inv_det;
  a.depth[i] = g.depth;

  const float mid = 0.5f * (g.a + g.c);
  float spread = mid * mid - g.det;
  spread = spread < 0.1f ? 0.1f : spread;
  const float lambda1 = mid + sqrtf(spread);
  const float radius_f = ceilf(3.0f * sqrtf(lambda1));
  const bool valid = (g.depth > kNearZ) && g.det_ok && (radius_f > 0.0f) &&
                     (opac >= kAlphaMin);
  a.radius[i] = valid ? static_cast<int>(radius_f) : 0;
  a.valid[i] = valid;

  if constexpr (DEG >= 0) {
    float d[3], nrm, inv_n;
    view_dir(cam, g, d, nrm, inv_n);
    float b[NB > 0 ? NB : 1];
    sh_basis<DEG>(d[0] * inv_n, d[1] * inv_n, d[2] * inv_n, b);
    const float* sh = tile + t * P;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = b[0] * sh[ch];
#pragma unroll
      for (int k = 1; k < NB; ++k) acc = acc + b[k] * sh[3 * k + ch];
      const float v = acc + 0.5f;
      a.rgb[3 * i + ch] = v < 0.0f ? 0.0f : v;
    }
  }
}

struct BwdArgs {
  Rows means, scales, quats, shs;
  int k;                          // coefficients in a row of shs
  const float *view, *proj, *center, *tanx, *tany;
  int width, height;
  float mod;
  Rows g_means2d, g_conic, g_rgb, g_depth;   // p == nullptr: zero
  float *out_means, *out_scales, *out_quats, *out_shs;
};

__device__ __forceinline__ float grad_at(const Rows& g, long long i, int c) {
  return g.p == nullptr ? 0.0f : g.p[i * g.stride + c];
}

template <int DEG>
__global__ void __launch_bounds__(kBlock)
    project_bwd_kernel(BwdArgs a, int n) {
  constexpr int NB = Sh<DEG>::kCoefs, F = Sh<DEG>::kFloats;
  constexpr int P = Sh<DEG>::kPitch;
  __shared__ Cam cam;
  __shared__ float tile[DEG >= 0 ? kBlock * P : 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long left = n - r0;
  const int rows = left < kBlock ? static_cast<int>(left) : kBlock;
  stage_camera(cam, a.view, a.proj, a.center, a.tanx, a.tany, a.width,
               a.height);
  const int t = threadIdx.x;
  const long long i = r0 + t;
  RowIn in;
  if (t < rows) load_row(in, a.means, a.scales, a.quats, i);
  if constexpr (DEG >= 0) stage_sh<DEG>(tile, a.shs.p, a.shs.stride, r0, rows);
  __syncthreads();
  if (t < rows) {
    Geo g;
    geometry(g, cam, in.mean, in.scl, in.quat, a.mod);
    const float* V = cam.view;
    const float* Pm = cam.proj;

    // means2d = ((h inv_w + 1) size - 1) / 2, inv_w = 1 / (hw + 1e-7).
    const float u = grad_at(a.g_means2d, i, 0) * 0.5f * cam.width;
    const float v = grad_at(a.g_means2d, i, 1) * 0.5f * cam.height;
    const float g_hx = u * g.inv_w, g_hy = v * g.inv_w;
    const float g_hw = -(u * g.hx + v * g.hy) * (g.inv_w * g.inv_w);

    // conic = (c, -b, a) inv_det; det > 0 guards the inverse.
    const float gc0 = grad_at(a.g_conic, i, 0);
    const float gc1 = grad_at(a.g_conic, i, 1);
    const float gc2 = grad_at(a.g_conic, i, 2);
    const float g_inv_det = gc0 * g.c - gc1 * g.b + gc2 * g.a;
    const float g_det =
        g.det_ok ? -g_inv_det * (g.inv_det * g.inv_det) : 0.0f;
    const float g_a = gc2 * g.inv_det + g_det * g.c;
    const float g_b = -gc1 * g.inv_det - 2.0f * g_det * g.b;
    const float g_c = gc0 * g.inv_det + g_det * g.a;

    // cov2d = M Sigma M^T with cm = Sigma m.
    float g_cm0[3], g_cm1[3], g_m0[3], g_m1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_cm0[k] = g_a * g.m0[k];
      g_cm1[k] = g_b * g.m0[k] + g_c * g.m1[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_m0[k] = g_a * g.cm0[k] + g_b * g.cm1[k] +
                (g.sig[k][0] * g_cm0[0] + g.sig[k][1] * g_cm0[1] +
                 g.sig[k][2] * g_cm0[2]);
      g_m1[k] = g_c * g.cm1[k] +
                (g.sig[k][0] * g_cm1[0] + g.sig[k][1] * g_cm1[1] +
                 g.sig[k][2] * g_cm1[2]);
    }
    // Sigma = L L^T: gs is the gradient of its entries, both halves.
    float gs[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gs[r][k] = g_cm0[r] * g.m0[k] + g_cm1[r] * g.m1[k] +
                   g_cm0[k] * g.m0[r] + g_cm1[k] * g.m1[r];
    float g_r[3][3], g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float g_l = gs[r][0] * g.l[0][j] + gs[r][1] * g.l[1][j] +
                          gs[r][2] * g.l[2][j];
        g_r[r][j] = g_l * g.s[j];
        g_s[j] += g_l * g.r[r][j];
      }
    float* out_s = a.out_scales + 3 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) out_s[k] = g_s[k] * a.mod;

    // R(q), q = raw / sqrt(|raw|^2 + eps).
    const float qw = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
    float gq[4];
    gq[0] = 2.0f * (-qz * g_r[0][1] + qy * g_r[0][2] + qz * g_r[1][0] -
                    qx * g_r[1][2] - qy * g_r[2][0] + qx * g_r[2][1]);
    gq[1] = 2.0f * (qy * g_r[0][1] + qz * g_r[0][2] + qy * g_r[1][0] -
                    2.0f * qx * g_r[1][1] - qw * g_r[1][2] + qz * g_r[2][0] +
                    qw * g_r[2][1] - 2.0f * qx * g_r[2][2]);
    gq[2] = 2.0f * (-2.0f * qy * g_r[0][0] + qx * g_r[0][1] +
                    qw * g_r[0][2] + qx * g_r[1][0] + qz * g_r[1][2] -
                    qw * g_r[2][0] + qz * g_r[2][1] - 2.0f * qy * g_r[2][2]);
    gq[3] = 2.0f * (-2.0f * qz * g_r[0][0] - qw * g_r[0][1] +
                    qx * g_r[0][2] + qw * g_r[1][0] - 2.0f * qz * g_r[1][1] +
                    qy * g_r[1][2] + qx * g_r[2][0] + qy * g_r[2][1]);
    const float dot =
        gq[0] * qw + gq[1] * qx + gq[2] * qy + gq[3] * qz;
    float* out_q = a.out_quats + 4 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) out_q[k] = (gq[k] - g.qn[k] * dot) / g.norm;

    // M = J W; J at t = clamp(pv / z, -lim, lim) z.
    float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_j00 += g_m0[k] * V[k];
      g_j02 += g_m0[k] * V[8 + k];
      g_j11 += g_m1[k] * V[4 + k];
      g_j12 += g_m1[k] * V[8 + k];
    }
    const float g_tx = g_j02 * -cam.fx * g.inv_z2;
    const float g_ty = g_j12 * -cam.fy * g.inv_z2;
    const float g_iz2 = g_j02 * -cam.fx * g.tx + g_j12 * -cam.fy * g.ty;
    const float g_iz = g_j00 * cam.fx + g_j11 * cam.fy +
                       2.0f * g.inv_z * g_iz2;
    const float z = g.depth;
    const bool in_x = g.tqx >= -cam.limx && g.tqx <= cam.limx;
    const bool in_y = g.tqy >= -cam.limy && g.tqy <= cam.limy;
    const float g_tqx = in_x ? g_tx * z : 0.0f;
    const float g_tqy = in_y ? g_ty * z : 0.0f;
    const float g_z = -g_iz * (g.inv_z * g.inv_z) + g_tx * g.tcx +
                      g_ty * g.tcy - (g_tqx * g.tqx + g_tqy * g.tqy) / z;
    const float g_pvx = g_tqx / z, g_pvy = g_tqy / z;
    const float g_pz = grad_at(a.g_depth, i, 0) + g_z;
    float gm[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gm[k] = g_pvx * V[k] + g_pvy * V[4 + k] + g_pz * V[8 + k] +
              g_hx * Pm[k] + g_hy * Pm[4 + k] + g_hw * Pm[12 + k];

    if constexpr (DEG >= 0) {
      float d[3], nrm, inv_n;
      view_dir(cam, g, d, nrm, inv_n);
      const float x = d[0] * inv_n, y = d[1] * inv_n, zd = d[2] * inv_n;
      float b[NB > 0 ? NB : 1], gb[NB > 0 ? NB : 1];
      sh_basis<DEG>(x, y, zd, b);
      float* sh = tile + t * P;
      float g_acc[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float acc = b[0] * sh[ch];
#pragma unroll
        for (int k = 1; k < NB; ++k) acc = acc + b[k] * sh[3 * k + ch];
        // clamp_min(acc + 0.5, 0) passes the gradient where >= 0.
        g_acc[ch] = acc + 0.5f >= 0.0f ? grad_at(a.g_rgb, i, ch) : 0.0f;
      }
#pragma unroll
      for (int k = 1; k < NB; ++k)
        gb[k] = sh[3 * k] * g_acc[0] + sh[3 * k + 1] * g_acc[1] +
                sh[3 * k + 2] * g_acc[2];
      // The row's SH gradient replaces its SH in the tile.
#pragma unroll
      for (int k = 0; k < NB; ++k)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) sh[3 * k + ch] = b[k] * g_acc[ch];
      float gdx, gdy, gdz;
      sh_basis_grad<DEG>(x, y, zd, gb, gdx, gdy, gdz);
      // dir = d inv_n, inv_n = 1 / max(|d|, 1e-12).
      const float g_inv_n = gdx * d[0] + gdy * d[1] + gdz * d[2];
      const float g_nrm =
          nrm >= 1e-12f ? -g_inv_n * (inv_n * inv_n) : 0.0f;
      const float g_sq = g_nrm / (2.0f * nrm);
      gm[0] += gdx * inv_n + 2.0f * d[0] * g_sq;
      gm[1] += gdy * inv_n + 2.0f * d[1] * g_sq;
      gm[2] += gdz * inv_n + 2.0f * d[2] * g_sq;
    }
    float* out_m = a.out_means + 3 * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) out_m[k] = gm[k];
  }
  if constexpr (DEG >= 0) {
    // Store the block's SH gradient rows [K, 3], zero past the degree.
    __syncthreads();
    const int row = 3 * a.k;
    float* base = a.out_shs + r0 * row;
    for (int idx = threadIdx.x; idx < rows * row; idx += kBlock) {
      const int r = idx / row, j = idx - r * row;
      base[idx] = j < F ? tile[r * P + j] : 0.0f;
    }
  }
}

template <int DEG>
int launch_fwd(const FwdArgs& a, int n, cudaStream_t s) {
  project_fwd_kernel<DEG><<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch_bwd(const BwdArgs& a, int n, cudaStream_t s) {
  project_bwd_kernel<DEG><<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes (ops/projection.py). ``degree`` is the
// SH degree 0-4, or -1 when colours are given (no SH read, no rgb
// written). Each per-row input comes with its row stride in floats; the
// camera is five device pointers (view [4,4], full projection [4,4],
// centre [3], tan(fovx / 2), tan(fovy / 2)). Outputs are contiguous.
// Launch on the caller's stream, do not synchronise, and return the CUDA
// error of the launch (0 for none); an unsupported degree returns
// cudaErrorInvalidValue.
extern "C" int project_fwd_launch(
    int degree, int n, const float* means, long long means_stride,
    const float* scales, long long scales_stride, const float* quats,
    long long quats_stride, const float* opac, long long opac_stride,
    const float* shs, long long shs_stride, const float* view,
    const float* proj, const float* center, const float* tanx,
    const float* tany, int width, int height, float scale_modifier,
    float* means2d, float* conic, float* rgb, float* depth, int* radius,
    uint8_t* valid, void* stream) {
  const FwdArgs a{{means, means_stride}, {scales, scales_stride},
                  {quats, quats_stride}, {opac, opac_stride},
                  {shs, shs_stride},     view, proj, center, tanx, tany,
                  width, height, scale_modifier, means2d, conic, rgb, depth,
                  radius, valid};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case -1: return launch_fwd<-1>(a, n, s);
    case 0: return launch_fwd<0>(a, n, s);
    case 1: return launch_fwd<1>(a, n, s);
    case 2: return launch_fwd<2>(a, n, s);
    case 3: return launch_fwd<3>(a, n, s);
    case 4: return launch_fwd<4>(a, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ``k`` is the coefficients in a row of shs (and of its gradient, written
// contiguous [n, k, 3]); incoming gradients are (pointer, row stride),
// a null pointer for zero.
extern "C" int project_bwd_launch(
    int degree, int n, const float* means, long long means_stride,
    const float* scales, long long scales_stride, const float* quats,
    long long quats_stride, const float* shs, long long shs_stride, int k,
    const float* view, const float* proj, const float* center,
    const float* tanx, const float* tany, int width, int height,
    float scale_modifier, const float* g_means2d, long long g_means2d_stride,
    const float* g_conic, long long g_conic_stride, const float* g_rgb,
    long long g_rgb_stride, const float* g_depth, long long g_depth_stride,
    float* out_means, float* out_scales, float* out_quats, float* out_shs,
    void* stream) {
  const BwdArgs a{{means, means_stride},
                  {scales, scales_stride},
                  {quats, quats_stride},
                  {shs, shs_stride},
                  k,
                  view,
                  proj,
                  center,
                  tanx,
                  tany,
                  width,
                  height,
                  scale_modifier,
                  {g_means2d, g_means2d_stride},
                  {g_conic, g_conic_stride},
                  {g_rgb, g_rgb_stride},
                  {g_depth, g_depth_stride},
                  out_means,
                  out_scales,
                  out_quats,
                  out_shs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case -1: return launch_bwd<-1>(a, n, s);
    case 0: return launch_bwd<0>(a, n, s);
    case 1: return launch_bwd<1>(a, n, s);
    case 2: return launch_bwd<2>(a, n, s);
    case 3: return launch_bwd<3>(a, n, s);
    case 4: return launch_bwd<4>(a, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
