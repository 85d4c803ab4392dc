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
// What bounds it on the H100: each evaluated (entry, pixel) pair costs
// about 20 FP32 operations to recompute alpha (one expf) and about 40 more
// when the entry contributes (67 TFLOP/s); the bytes it must move are the
// referenced Gaussians (40 B read, 40 B of gradient written), 4 B per
// entry and 28 B read per pixel (3.35 TB/s). The operations bind. What
// the kernel really spends beyond them is the sum over pixels (cross-lane
// shuffles and atomics per (entry, warp)), the alpha test of the four
// fifths of a tile's pairs that do not contribute, and latency: the launch
// ends when its deepest tile does, and that tile's walk is one dependent
// chain per warp (more than half of the launch at the training view).
//
// Design. One block of 256 threads per 16x16 tile, one thread per pixel,
// blocks taking the tiles deepest first (tile_order); a warp owns a
// compact 8x4 pixel footprint. The block takes the largest last-entry
// index of its pixels (K1's fourth output) and walks the tile's entries
// back to front from there in batches of 128, staged as packed rows
// (blend_common.cuh; K1's launch wrote them) by 16-byte cp.async copies
// into a ring of three batches: the next two batches are in flight while
// this one is walked. Within a batch each warp goes alone: it starts at
// its own largest last index (a warp whose pixels all ended earlier skips
// the batch), takes 32 entries at a time, culls those that provably miss
// its footprint (cull_footprint: only what the exact test would skip) and
// evaluates the survivors back to front. Each pixel starts from its final
// T and recovers T_k = T_{k+1} / (1 - alpha_k) by IEEE division. The
// survivors are taken two at a time: their alpha tests run side by side,
// then T and the suffix sum step over them in order. If any lane
// contributed to either, the warp reduces the 2 x 10 values (in the
// gradient row's layout, padded to 2 x 16) by recursive halving -- each
// step exchanges half of the values still held, 31 shuffles for two
// entries in place of 100, those of a step independent of one another --
// which leaves value l on lane l; the lanes add them to the batch's
// [128, 12] accumulator in shared memory. After the batch one
// thread per entry flushes its row to the [N, 12] gradient with three
// float4 atomicAdds (rows that stayed zero are not flushed): one set of
// atomics per (tile, entry), not per (warp, entry). Compiled without
// --use_fast_math (expf, IEEE division) to keep parity with the plain
// version.
#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kBlock = kTile * kTile;
constexpr int kBatch = 128;   // entries per staged batch
constexpr int kStages = 3;
constexpr int kFootW = 8, kFootH = 4;  // a warp's pixels
constexpr int kRow = 4 * kRowVec;      // floats per gradient row
constexpr int kMinBlocks = 5;          // resident blocks per SM asked for

// Sum v[0..31] over the warp's 32 lanes by recursive halving: each step
// exchanges the half of the values that the lane does not keep, 31
// shuffles in all, the shuffles of a step independent of one another.
// Returns, on lane l, the sum of value number l.
__device__ __forceinline__ float transpose_sum(const float (&v)[32],
                                               int lane) {
  float r16[16], r8[8], r4[4], r2[2];
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4,
             up2 = lane & 2, up1 = lane & 1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float send = up16 ? v[i] : v[i + 16];
    const float keep = up16 ? v[i + 16] : v[i];
    r16[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = up8 ? r16[i] : r16[i + 8];
    const float keep = up8 ? r16[i + 8] : r16[i];
    r8[i] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up4 ? r8[i] : r8[i + 4];
    const float keep = up4 ? r8[i + 4] : r8[i];
    r4[i] = keep + __shfl_xor_sync(kFullMask, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up2 ? r4[i] : r4[i + 2];
    const float keep = up2 ? r4[i + 2] : r4[i];
    r2[i] = keep + __shfl_xor_sync(kFullMask, send, 2);
  }
  const float send = up1 ? r2[0] : r2[1];
  const float keep = up1 ? r2[1] : r2[0];
  return keep + __shfl_xor_sync(kFullMask, send, 1);
}

// One contributing entry's gradient values for this pixel into v[0..11]
// (the gradient row's layout: mx my opacity invd | ca cb cc - | r g b -),
// and the pixel's T and suffix sum stepped back over the entry.
__device__ __forceinline__ void backprop_entry(const PairEval& e,
                                               const float4 col, float gr,
                                               float gg, float gb, float gd,
                                               float gt_tfin, float& T,
                                               float& suffix, float* v) {
  const float one_minus = 1.0f - e.alpha;
  T = T / one_minus;  // T before entry k
  const float ga = gr * col.x + gg * col.y + gb * col.z + gd * e.inv_depth;
  const float w = e.alpha * T;
  const float d_alpha = T * ga - (suffix + gt_tfin) / one_minus;
  suffix += ga * w;
  v[8] = w * gr;
  v[9] = w * gg;
  v[10] = w * gb;
  v[3] = w * gd;
  if (e.alpha_raw < kAlphaMax) {
    const float d_power = d_alpha * e.alpha_raw;
    v[0] = d_power * (e.ca * e.dx + e.cb * e.dy);
    v[1] = d_power * (e.cc * e.dy + e.cb * e.dx);
    v[4] = d_power * (-0.5f * e.dx * e.dx);
    v[5] = d_power * (-e.dx * e.dy);
    v[6] = d_power * (-0.5f * e.dy * e.dy);
    v[2] = d_alpha * e.ex;
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
blend_bwd_kernel(const float4* __restrict__ pack,      // [N, 3] rows
                 const int* __restrict__ gauss_idx,    // [D]
                 const int* __restrict__ tile_start,   // [T]
                 const long long* __restrict__ tile_order,  // [T]
                 int height, int width, int tiles_x,
                 const float* __restrict__ final_t,    // [H, W]
                 const int* __restrict__ last_entry,   // [H, W]
                 const float* __restrict__ g_color,    // [3, H, W]
                 const float* __restrict__ g_invd,     // [H, W]
                 const float* __restrict__ g_trans,    // [H, W]
                 float* __restrict__ grads) {          // [N, 12]
  __shared__ __align__(16) float4 s_rows[kStages][kBatch * kRowVec];
  __shared__ __align__(16) float s_acc[kBatch * kRow];
  __shared__ int s_top;

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int foot_x = (tile % tiles_x) * kTile + (warp & 1) * kFootW;
  const int foot_y = (tile / tiles_x) * kTile + (warp >> 1) * kFootH;
  const int px = foot_x + (lane & 7);
  const int py = foot_y + (lane >> 3);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float x0 = static_cast<float>(foot_x);
  const float x1 = static_cast<float>(foot_x + kFootW - 1);
  const float y0 = static_cast<float>(foot_y);
  const float y1 = static_cast<float>(foot_y + kFootH - 1);
  const int start = tile_start[tile];

  int last = -1;
  float T = 1.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f, gt = 0.0f;
  if (px < width && py < height) {
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
  const int warp_top = __reduce_max_sync(kFullMask, last);

  if (tid == 0) s_top = -1;
  if (tid < kBatch) {
#pragma unroll
    for (int i = 0; i < kRow; ++i) s_acc[tid * kRow + i] = 0.0f;
  }
  __syncthreads();
  if (lane == 0 && warp_top >= 0) atomicMax(&s_top, warp_top);
  __syncthreads();
  const int top = s_top;  // the same for every thread of the block
  if (top < start) return;  // no pixel of the tile has an entry

  // Batch k covers entries (hi_k - kBatch, hi_k] above start, hi_0 = top;
  // slot s of a batch holds entry lo + s, staged and later flushed by
  // thread s (threads past the batch size get no entry).
  const int n_batches = (top - start) / kBatch + 1;
  auto entry_of = [&](int k) {
    const int hi = top - k * kBatch;
    const int lo = max(start, hi - kBatch + 1);
    return (k < n_batches && lo + tid <= hi) ? gauss_idx[lo + tid] : -1;
  };

  int g_cur = entry_of(0);
  int g_next = entry_of(1);
  stage_row(&s_rows[0][tid * kRowVec], pack, g_cur);
  cp_async_commit();
  stage_row(&s_rows[1][tid * kRowVec], pack, g_next);
  cp_async_commit();
  int g_ahead = entry_of(2);

  for (int b = 0; b < n_batches; ++b) {
    const int hi = top - b * kBatch;
    const int lo = max(start, hi - kBatch + 1);
    cp_async_wait<1>();  // this thread's copies of batch b have landed
    // Everyone's copies of batch b are visible; every warp has left batch
    // b - 1, whose slot is restaged below; its flush has zeroed s_acc.
    __syncthreads();
    stage_row(&s_rows[(b + 2) % kStages][tid * kRowVec], pack, g_ahead);
    cp_async_commit();
    const int g_staged = g_ahead;
    g_ahead = entry_of(b + 3);

    const float4* rows = s_rows[b % kStages];
    // The warp starts at its own largest last index: chunk [c - 31, c].
    for (int c = min(hi, warp_top) - lo; c >= 0; c -= 32) {
      const int mine = c - 31 + lane;
      bool keep = false;
      if (mine >= 0) {
        keep = !cull_footprint(rows[mine * kRowVec],
                               rows[mine * kRowVec + 1], x0, x1, y0, y1);
      }
      unsigned survivors = __ballot_sync(kFullMask, keep);
      // Two survivors at a time, back to front: their alpha tests are
      // independent and overlap, T and the suffix sum step over them in
      // order, and one reduction of 2 x 16 values sums both.
      while (survivors) {
        const int bit0 = 31 - __clz(survivors);
        survivors &= ~(1u << bit0);
        const bool two = survivors != 0;
        const int bit1 = two ? 31 - __clz(survivors) : bit0;
        survivors &= ~(1u << bit1);
        const int j0 = c - 31 + bit0, j1 = c - 31 + bit1;
        const PairEval e0 = eval_pair(rows, j0, lo + j0 <= last, fx, fy);
        const PairEval e1 = eval_pair(rows, j1, two && lo + j1 <= last, fx,
                                      fy);
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = 0.0f;
        if (e0.ok) {
          backprop_entry(e0, rows[j0 * kRowVec + 2], gr, gg, gb, gd, gt_tfin,
                         T, suffix, v);
        }
        if (e1.ok) {
          backprop_entry(e1, rows[j1 * kRowVec + 2], gr, gg, gb, gd, gt_tfin,
                         T, suffix, v + 16);
        }
        if (__any_sync(kFullMask, e0.ok || e1.ok)) {
          // Lane l holds value l & 15 of entry j0 (l < 16) or j1.
          const float sum = transpose_sum(v, lane);
          const int slot = lane & 15;
          if (slot < kRow && (lane < 16 || two)) {
            atomicAdd(&s_acc[(lane < 16 ? j0 : j1) * kRow + slot], sum);
          }
        }
      }
    }

    __syncthreads();  // every warp's sums of batch b are in s_acc
    if (g_cur >= 0) {
      float4* acc = reinterpret_cast<float4*>(s_acc) + tid * kRowVec;
      const float4 r0 = acc[0], r1 = acc[1], r2 = acc[2];
      const bool any = r0.x != 0.0f || r0.y != 0.0f || r0.z != 0.0f
                       || r0.w != 0.0f || r1.x != 0.0f || r1.y != 0.0f
                       || r1.z != 0.0f || r2.x != 0.0f || r2.y != 0.0f
                       || r2.z != 0.0f;
      if (any) {
        float4* dst = reinterpret_cast<float4*>(grads)
                      + static_cast<size_t>(g_cur) * kRowVec;
        atomicAdd(dst, r0);
        atomicAdd(dst + 1, r1);
        atomicAdd(dst + 2, r2);
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        acc[0] = z;
        acc[1] = z;
        acc[2] = z;
      }
    }
    g_cur = g_next;
    g_next = g_staged;
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C entry points for ctypes. The launch goes to the caller's stream,
// does not synchronise, and returns cudaGetLastError() after the launch.
// ``pack`` is the [N, 12] row buffer: K1's launch has filled it when
// ``do_pack`` is 0; otherwise the pack pre-pass fills it here from the
// columns. The caller zeroes ``grads`` ([N, 12] float32) first.
extern "C" int blend_bwd_launch(const float* means2d, const float* conic,
                                const float* rgb, const float* opacity,
                                const float* inv_depth, int n_gaussians,
                                float* pack, int do_pack,
                                const int* gauss_idx, const int* tile_start,
                                const long long* tile_order, int n_tiles,
                                int tiles_x, int height, int width,
                                const float* final_t, const int* last_entry,
                                const float* g_color, const float* g_invd,
                                const float* g_trans, float* grads,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (do_pack) {
    launch_pack(Columns{means2d, conic, rgb, opacity, inv_depth},
                n_gaussians, pack, s);
  }
  if (n_tiles > 0) {
    blend_bwd_kernel<<<n_tiles, kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(pack), gauss_idx, tile_start,
        tile_order, height, width, tiles_x, final_t, last_entry, g_color,
        g_invd, g_trans, grads);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM and threads per block, as the runtime computes
// them for this kernel on the current device.
extern "C" int blend_bwd_occupancy(int* blocks_per_sm, int* threads) {
  *threads = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, blend_bwd_kernel, kBlock, 0));
}
