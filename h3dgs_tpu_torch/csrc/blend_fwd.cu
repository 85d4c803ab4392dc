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
// [H,W] (-1: none), from which the backward kernel (K2) walks back.
//
// What bounds it on the H100: each evaluated (entry, pixel) pair costs
// about 20 FP32 operations including one expf (67 TFLOP/s), each entry
// reads 52 bytes and each pixel writes 24 (3.35 TB/s); the operations
// bind. What the kernel really spends is instruction slots on pairs that
// cannot contribute (about a fifth of a tile's pairs do), and latency:
// the launch ends when its deepest tile does, and that tile's walk is one
// dependent chain per warp.
//
// Design. The launch is two kernels: a pre-pass packs the per-Gaussian
// columns into 48-byte rows (blend_common.cuh), which K2 reads again,
// then the blend. One block of 256 threads per tile, one thread per
// pixel; blocks take the tiles deepest first (tile_order), so the deep
// tiles start first and do not form the launch's tail. Each warp owns a
// compact 8x4 pixel footprint. Entries are staged in batches of 256: one
// thread starts three 16-byte cp.async copies of an entry's row into a
// ring of three batches, so the copies of the next two batches fly while
// this one is blended, with one block barrier per batch (the barrier also
// counts the finished pixels and ends the walk once all 256 are done). A
// warp takes a batch 32 entries at a time: each lane tests one entry
// against the warp's footprint with the conservative cull (it may only
// skip what the exact per-pixel test would skip), a ballot collects the
// survivors, and only those are evaluated per pixel, in depth order, two
// at a time (their alpha tests are independent and overlap; T is then
// updated in order), with two 16-byte shared loads for the test and the
// colour row only on contribution. Compiled without --use_fast_math so
// expf (not __expf) keeps parity with the plain version.
#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kBlock = kTile * kTile;
constexpr int kBatch = kBlock;  // one staged entry per thread
constexpr int kStages = 3;
constexpr int kFootW = 8, kFootH = 4;  // a warp's pixels

// One evaluated entry into the pixel's running sums: the pixel is done,
// without the entry contributing, once T (1 - alpha) would drop below 1e-4.
__device__ __forceinline__ void blend_entry(const PairEval& e,
                                            const float4* rows, int j,
                                            int entry, float& T, float& c0,
                                            float& c1, float& c2,
                                            float& dsum, int& last,
                                            bool& done) {
  if (!e.ok) return;
  const float next_T = T * (1.0f - e.alpha);
  if (next_T < kTransEps) {
    done = true;
    return;
  }
  const float4 c = rows[j * kRowVec + 2];  // r, g, b
  const float w = e.alpha * T;
  c0 += w * c.x;
  c1 += w * c.y;
  c2 += w * c.z;
  dsum += w * e.inv_depth;
  T = next_T;
  last = entry;
}

__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float4* __restrict__ pack,      // [N, 3] rows
                 const int* __restrict__ gauss_idx,    // [D]
                 const int* __restrict__ tile_start,   // [T]
                 const int* __restrict__ tile_count,   // [T]
                 const long long* __restrict__ tile_order,  // [T]
                 int height, int width, int tiles_x,
                 float* __restrict__ out_color,        // [3, H, W]
                 float* __restrict__ out_invdepth,     // [H, W]
                 float* __restrict__ out_trans,        // [H, W]
                 int* __restrict__ out_last) {         // [H, W]
  __shared__ __align__(16) float4 s_rows[kStages][kBatch * kRowVec];

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int foot_x = (tile % tiles_x) * kTile + (warp & 1) * kFootW;
  const int foot_y = (tile / tiles_x) * kTile + (warp >> 1) * kFootH;
  const int px = foot_x + (lane & 7);
  const int py = foot_y + (lane >> 3);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float x0 = static_cast<float>(foot_x);
  const float x1 = static_cast<float>(foot_x + kFootW - 1);
  const float y0 = static_cast<float>(foot_y);
  const float y1 = static_cast<float>(foot_y + kFootH - 1);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int n_batches = (count + kBatch - 1) / kBatch;

  // This thread's entry of batch k (-1 past the tile's range).
  auto entry_of = [&](int k) {
    const int e = k * kBatch + tid;
    return e < count ? gauss_idx[start + e] : -1;
  };

  bool done = !inside;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dsum = 0.0f;
  int last = -1;

  // Two batches in flight before the walk; the index of the third is
  // fetched ahead so that its copies start without waiting for it.
  stage_row(&s_rows[0][tid * kRowVec], pack, entry_of(0));
  cp_async_commit();
  stage_row(&s_rows[1][tid * kRowVec], pack, entry_of(1));
  cp_async_commit();
  int g_ahead = entry_of(2);

  for (int b = 0; b < n_batches; ++b) {
    cp_async_wait<1>();  // this thread's copies of batch b have landed
    // One barrier per batch: everyone's copies of batch b are visible,
    // every warp has left batch b - 1 (whose slot is restaged below), and
    // the walk ends once every pixel of the tile is done. Uniform: all
    // threads see the same count.
    if (__syncthreads_count(done) == kBlock) break;
    stage_row(&s_rows[(b + 2) % kStages][tid * kRowVec], pack, g_ahead);
    cp_async_commit();
    g_ahead = entry_of(b + 3);

    const float4* rows = s_rows[b % kStages];
    const int n = min(kBatch, count - b * kBatch);
    const int entry0 = start + b * kBatch;
    for (int base = 0; base < n; base += 32) {
      if (__all_sync(kFullMask, done)) break;
      const int mine = base + lane;
      bool keep = false;
      if (mine < n) {
        keep = !cull_footprint(rows[mine * kRowVec],
                               rows[mine * kRowVec + 1], x0, x1, y0, y1);
      }
      unsigned survivors = __ballot_sync(kFullMask, keep);
      // Two survivors at a time: their alpha tests are independent and
      // overlap; T is then updated in depth order.
      while (survivors) {
        const int j0 = base + __ffs(survivors) - 1;
        survivors &= survivors - 1;
        const bool two = survivors != 0;
        const int j1 = two ? base + __ffs(survivors) - 1 : j0;
        survivors &= survivors - 1;
        if (done) continue;
        const PairEval e0 = eval_pair(rows, j0, true, fx, fy);
        const PairEval e1 = eval_pair(rows, j1, two, fx, fy);
        blend_entry(e0, rows, j0, entry0 + j0, T, c0, c1, c2, dsum, last,
                    done);
        if (!done) {
          blend_entry(e1, rows, j1, entry0 + j1, T, c0, c1, c2, dsum, last,
                      done);
        }
      }
    }
  }
  cp_async_wait<0>();

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

// Plain C entry points for ctypes. The launch goes to the caller's stream,
// does not synchronise, and returns cudaGetLastError() after the launches:
// the pack pre-pass, which fills ``pack`` ([N, 12] float32, allocated by
// the caller and kept for K2), then the blend.
extern "C" int blend_fwd_launch(const float* means2d, const float* conic,
                                const float* rgb, const float* opacity,
                                const float* inv_depth, int n_gaussians,
                                float* pack, const int* gauss_idx,
                                const int* tile_start, const int* tile_count,
                                const long long* tile_order, int n_tiles,
                                int tiles_x, int height, int width,
                                float* out_color, float* out_invdepth,
                                float* out_trans, int* out_last,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_pack(Columns{means2d, conic, rgb, opacity, inv_depth}, n_gaussians,
              pack, s);
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(pack), gauss_idx, tile_start,
        tile_count, tile_order, height, width, tiles_x, out_color,
        out_invdepth, out_trans, out_last);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM and threads per block, as the runtime computes
// them for this kernel on the current device.
extern "C" int blend_fwd_occupancy(int* blocks_per_sm, int* threads) {
  *threads = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, blend_fwd_kernel, kBlock, 0));
}
