// Multilevel FPN ROIAlign for Hopper (sm_90a): the forward and its gradient
// w.r.t. the levels, span kernels both (span_common.cuh holds what they share
// with the single-level kernel of roi_align_single.cu).
//
// WHAT THEY COMPUTE
//
// The forward replaces the TPU kernels _ml_kernel_prew
// (u2seg_tpu/ops/roi_align_pallas.py:435, the default) and _ml_kernel (:225,
// U2SEG_POOL_PREW=0): both compute
//   out[roi, py, px, c] = mean over the r x r samples of bin (py, px) of the
//   bilinear interpolation of the ROI's routed level at that sample,
// with the window geometry of the JAX reference multilevel_roi_align_ref
// (:985). The backward replaces _ml_bwd_kernel (:1074): the exact transpose,
//   grad[lvl(roi)][b(roi), y, x, c] = sum over rois, in ascending index, of
//                                    sum over bins of wy * wx * g[roi, py, px, c]
// into f32 gradient levels at their true dims. The Pallas kernel adds ROI
// after ROI in grid order (a read-add-write of each window), so its
// gradients repeat exactly; this one sums in the same order and repeats too.
//
// Routing (level with the window-fit bump and the virtual 2x-pooled top
// level), window origins and bin geometry come from the plain twin of
// _ml_prep in u2seg_torch/ops/roi_align_ml.py, run as torch ops on the
// device before the launch, as the JAX package also runs them outside its
// kernel. The TPU blocking (DMA tiers, warmup groups, the row-concatenated
// atlas, block-diagonal grouping) is not carried over: it is value-neutral.
//
// The window clip. Each sample's clamped coordinate is expressed relative to
// the ROI's window origin and clipped into [0, win-1] (roi_align_pallas.py
// :579-580 and :937), so a sample beyond the window takes the edge cell. The
// routing keeps every span within the window (a span <= 28 cells fits the
// 32 x 40 window with its halo and the 8-aligned x origin), so the clip
// changes a value only for boxes longer than 28 cells even on the virtual
// level (> 1792 px at stride 64). The kernels honour the clip all the same,
// with the reference's own origins, so they equal the reference on every box.
//
// THE SPAN DESIGN (both kernels; span_common.cuh has the parts they share)
//
// Dense per-axis pooled weights, the streamed-weight form of the TPU's K1
// (_pooled_axis_weights_host), built in shared memory with the window clip
// above as the tap rule (ClipRule): taps outside the true level dims or the
// window weigh 0, samples clipped onto one edge cell add up there. The
// backward is the forward's transpose. The forward runs one block per (ROI,
// chunk of 64 channels), the backward one per (tile of a level, chunk).
//
// Forward: span_forward of span_common.cuh. The wrapper picks a 24 KB stage
// buffer with 128 threads for 7 x 7 outputs and 48 KB with 256 threads for
// 14 x 14, by measurement. At 64 bf16 channels 24 KB hold 192 cells: all 7
// rows of a 13 x 13 span go in one group, a 30 x 30 span takes 5. The buffer
// has a fixed size so that no launch waits on a device-to-host read and 8
// (7 x 7) or 4 (14 x 14) blocks stay resident per SM; sizing it for the whole
// 32 x 40 window (160 KB) would leave one. A bin taller than the buffer (a bin
// more than ~5 cells high under a full-width span: boxes of thousands of
// pixels on the virtual level) reads global memory. One block per (ROI,
// chunk) rebuilds the tables in every chunk's block; an early build with one
// block per ROI looping over its chunks was slower (no reading of it was
// kept), so the wide grid stays.
//
// Backward: a gather, not a scatter. Every cell of every gradient level is
// written once, by one thread, which adds up the ROIs whose span covers it in
// ascending ROI index (the Pallas grid's order), so the result is one fixed
// function of the inputs: two runs give the same bits, and it runs under
// torch.use_deterministic_algorithms(True). The levels are cut into tiles of
// kTile x kTile cells per image. Two launches:
// - the routing pass (roi_align_ml_backward_route_kernel), one block per ROI,
//   builds the ROI's tables from roi_f with build_dense (the forward's tap
//   rule) and the per-cell bin ranges, stores them as the ROI's record in
//   global memory, and writes a key tile * R + roi for each tile its span
//   meets; the wrapper sorts the keys (torch.sort), which lists every tile's
//   ROIs in ascending index;
// - the gather (roi_align_ml_backward_kernel), one block per (tile, chunk of
//   64 channels), walks its tile's list: per ROI it copies with 16-byte
//   cp.async the ROI's record and the cotangent g[roi, py, px, chunk] of the
//   bins that touch a cell of the tile into a ring of stages in shared
//   memory, the next ROI's copies in flight while it adds one (two stages
//   where two fit in 64 KB: s <= 10; one at s=14, so that 4 blocks fit an
//   SM), and each thread, owning 4 channels of 4 cells, adds that ROI's
//   contribution (Wy * (sum over px of Wx * g), bins in a fixed order) into
//   f32 registers. It stores once after the last ROI; cells that no ROI
//   touches get the zeros of that same store, so no zero fill runs before it.
// The tables are built once per ROI instead of once per (tile, chunk): an
// earlier form of this gather that rebuilt them in every block took 0.668 ms
// at s=7, R=1024 (the `k3` phase of chip_smoke.py); this one takes 0.458 ms
// for its three steps there, and a ring of four stages at s=7 and two at
// s=14 (112 KB) was slower in another call (0.518 and 0.373 ms against
// 0.458 and 0.296). The time is that of the longest lists: a tile of the
// coarsest real level (p5) is met by up to 65 of the 1024 ROIs, one after
// another.
//
// Bound on this card: bytes, for both. The forward moves s*s*C output values
// and the distinct level cells it touches per ROI, for ~2 * 12 flops per
// output value; the backward reads g once and must write every gradient cell
// once. What the span design pays above the bound. Forward: the spans of
// neighbouring ROIs overlap, so the blocks read ~3x the distinct cells (from
// L2 for the most part), and each 8-channel output value costs some 300
// instructions (per tap one 16-byte shared load, 8 bf16 unpacks, 8 FMAs) in
// small blocks that run tables, copy and compute one after another.
// Backward: a ROI that covers k tiles has its record and the bins at a
// tile's edge copied up to k times per chunk, and each block walks its ROIs
// one after another (copy, add) with __syncthreads between them.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "span_common.cuh"

namespace {

using namespace span;

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;       // s * r along one axis
constexpr int kThreads = 256;         // largest block (the backward's)

// Passed by value as a __grid_constant__ parameter: indexing a plain by-value
// struct with the ROI's level makes every thread copy all 128 bytes to its
// stack first.
struct LevelTable {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// ---------------------------------------------------------------------------
// The tap rule of these kernels (the window clip)
// ---------------------------------------------------------------------------

struct ClipRule {   // one axis of one ROI
  float c0, bin, size, win_last;
  int origin, dim;

  // Window-local coordinate of sample i (of s * r), clamped into the level
  // and then into the window. Returns whether the sample lies inside the
  // level at all.
  __device__ __forceinline__ bool sample(int i, int r, float* local) const {
    const float rel = static_cast<float>(i / r) +
                      (static_cast<float>(i % r) + 0.5f) / static_cast<float>(r);
    const float coord = c0 + rel * bin;
    const float cc = fminf(fmaxf(coord, 0.0f), size - 1.0f);
    *local = fminf(fmaxf(cc - static_cast<float>(origin), 0.0f), win_last);
    return coord >= -1.0f && coord <= size;
  }

  // Tap k (0 or 1) of a sample: its window-local cell and its bilinear weight
  // with the 1/r mean folded in; 0 for a tap outside the window or the true
  // level dims.
  __device__ __forceinline__ float tap(float local, bool inside, int k, int r,
                                       int* cell_local) const {
    const float t = floorf(local) + static_cast<float>(k);
    *cell_local = static_cast<int>(t);
    const float w = fmaxf(0.0f, 1.0f - fabsf(local - t));
    const bool ok = inside && t <= win_last && origin + *cell_local < dim;
    return ok ? w / static_cast<float>(r) : 0.0f;
  }
};

__device__ __forceinline__ ClipRule clip_rule(
    const int* __restrict__ roi_i, const float* __restrict__ roi_f, int roi,
    int axis, int height, int width, int win_y, int win_x) {
  ClipRule a;
  a.c0 = roi_f[roi * 4 + axis];
  a.bin = roi_f[roi * 4 + 2 + axis];
  a.origin = roi_i[roi * 4 + 1 + axis];
  a.dim = axis ? width : height;
  a.size = static_cast<float>(a.dim);
  a.win_last = static_cast<float>((axis ? win_x : win_y) - 1);
  return a;
}

// Per window cell, the bins whose [bin_lo, bin_hi] holds it. Ends with a
// __syncthreads().
__device__ __forceinline__ void build_cell_ranges(const Tables& tb, int s,
                                                  int win_y, int win_x) {
  for (int i = threadIdx.x; i < win_y + win_x; i += blockDim.x) {
    const int axis = i >= win_y;
    const int cell = i - axis * win_y;
    int lo = s, hi = -1;
    for (int b = 0; b < s; ++b) {
      if (tb.bin_lo[axis * s + b] <= cell && cell <= tb.bin_hi[axis * s + b]) {
        lo = min(lo, b);
        hi = max(hi, b);
      }
    }
    tb.cell_lo[i] = lo;
    tb.cell_hi[i] = hi;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// FORWARD
// ---------------------------------------------------------------------------

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
roi_align_ml_kernel(const __grid_constant__ LevelTable levels,
                    const int* __restrict__ roi_i,    // (R, 4): lvl, oy, ox, b
                    const float* __restrict__ roi_f,  // (R, 4): y0, x0, bin_h, bin_w
                    Tout* __restrict__ out,           // (R, s, s, C)
                    int channels, int s, int r, int win_y, int win_x,
                    int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = carve_tables(smem + stage_bytes, s, win_y, win_x);

  const int roi = blockIdx.x;
  const int lvl = roi_i[roi * 4 + 0];
  const int oy = roi_i[roi * 4 + 1];
  const int ox = roi_i[roi * 4 + 2];
  const int b = roi_i[roi * 4 + 3];
  const int height = levels.h[lvl];
  const int width = levels.w[lvl];
  build_dense(tb, [&](int axis) {
    return clip_rule(roi_i, roi_f, roi, axis, height, width, win_y, win_x);
  }, s, r, win_y, win_x);
  const int row_elems = width * channels;           // a level row; < 2^31 elements
  const Tin* window = static_cast<const Tin*>(levels.ptr[lvl]) +
                      (static_cast<size_t>(b) * height + oy) * row_elems +
                      static_cast<size_t>(ox) * channels;
  span_forward<false>(tb, reinterpret_cast<Tin*>(smem), stage_bytes, window, row_elems,
                      out + static_cast<size_t>(roi) * s * s * channels, channels, s,
                      win_y, win_x);
}

// ---------------------------------------------------------------------------
// BACKWARD
// ---------------------------------------------------------------------------

constexpr int kTile = 8;                         // cells per side of a gradient tile
constexpr int kTileCells = kTile * kTile;
constexpr int kCellsPerThread = kTileCells * (kChunk / 4) / kThreads;   // 4
constexpr int kPrepThreads = 64;                 // the routing pass: >= 2 s for s <= 32
constexpr int kRingBytes = 64 * 1024;            // the backward's ring of stages
constexpr int kMaxStages = 2;
static_assert(kTileCells * (kChunk / 4) % kThreads == 0, "a thread owns whole cells");

// Tiles per image of a level of h x w cells.
__host__ __device__ __forceinline__ int tiles_of(int h, int w) {
  return ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
}

// Tiles that a span of at most win cells can meet along one axis.
__host__ __device__ constexpr int slots_of(int win) { return (win - 1) / kTile + 2; }

// One ROI's record: its Tables (span_common.cuh's layout), 16-byte rounded.
__host__ __device__ constexpr int record_bytes(int s, int win_y, int win_x) {
  return (table_bytes(s, win_y, win_x) + 15) / 16 * 16;
}

// What one backward block stages per ROI: the cotangent of its bins for a
// chunk ([s * s][kChunk] f32), then the ROI's record.
__host__ __device__ constexpr int stage_bytes_of(int s, int win_y, int win_x) {
  return s * s * kChunk * static_cast<int>(sizeof(float)) + record_bytes(s, win_y, win_x);
}

// Stages in the ring: as many as fit in kRingBytes, 1 to kMaxStages.
__host__ __device__ constexpr int backward_stages(int s, int win_y, int win_x) {
  return kRingBytes / stage_bytes_of(s, win_y, win_x) < 1 ? 1
         : kRingBytes / stage_bytes_of(s, win_y, win_x) > kMaxStages
             ? kMaxStages
             : kRingBytes / stage_bytes_of(s, win_y, win_x);
}

// The routing pass: one block per ROI builds the ROI's tables from roi_f
// (build_dense with the window clip, then the per-cell bin ranges), stores
// them as the ROI's record, and writes one key, tile * R + roi, for each tile
// of the ROI's level and image that its span meets; its other slots get the
// sentinel tiles * R. The wrapper sorts the keys (torch.sort), which lists the
// ROIs of every tile in ascending index.
__global__ void __launch_bounds__(kPrepThreads)
roi_align_ml_backward_route_kernel(const __grid_constant__ LevelTable levels,
                                   int num_levels, int batch,
                                   const int* __restrict__ roi_i,
                                   const float* __restrict__ roi_f, int num_rois,
                                   int s, int r, int win_y, int win_x, int num_tiles,
                                   unsigned char* __restrict__ records,
                                   long long* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = carve_tables(smem, s, win_y, win_x);
  const int roi = blockIdx.x;
  const int lvl = roi_i[roi * 4 + 0];
  const int oy = roi_i[roi * 4 + 1];
  const int ox = roi_i[roi * 4 + 2];
  const int b = roi_i[roi * 4 + 3];
  const int height = levels.h[lvl];
  const int width = levels.w[lvl];
  build_dense(tb, [&](int axis) {
    return clip_rule(roi_i, roi_f, roi, axis, height, width, win_y, win_x);
  }, s, r, win_y, win_x);
  build_cell_ranges(tb, s, win_y, win_x);
  const unsigned int* src = reinterpret_cast<const unsigned int*>(smem);
  unsigned int* dst = reinterpret_cast<unsigned int*>(
      records + static_cast<size_t>(roi) * record_bytes(s, win_y, win_x));
  for (int i = threadIdx.x; i < table_bytes(s, win_y, win_x) / 4; i += blockDim.x) {
    dst[i] = src[i];
  }
  const Span sp = span_of(tb, s, win_y, win_x);
  const bool live = sp.y_lo <= sp.y_hi && sp.x_lo <= sp.x_hi;
  int first = 0;                                    // the level's first tile
  for (int l = 0; l < lvl; ++l) first += batch * tiles_of(levels.h[l], levels.w[l]);
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const int ty0 = (oy + sp.y_lo) / kTile, ty1 = (oy + sp.y_hi) / kTile;
  const int tx0 = (ox + sp.x_lo) / kTile, tx1 = (ox + sp.x_hi) / kTile;
  const int ny = slots_of(win_y), nx = slots_of(win_x);
  long long* out = keys + static_cast<size_t>(roi) * ny * nx;
  for (int i = threadIdx.x; i < ny * nx; i += blockDim.x) {
    const int ty = ty0 + i / nx;
    const int tx = tx0 + i % nx;
    const long long tile = first + (static_cast<long long>(b) * tiles_y + ty) * tiles_x + tx;
    out[i] = (live && ty <= ty1 && tx <= tx1) ? tile * num_rois + roi
                                              : static_cast<long long>(num_tiles) * num_rois;
  }
}

// The gather: one block per (tile, chunk of channels); see the header note.
__global__ void __launch_bounds__(kThreads, 4)
roi_align_ml_backward_kernel(const __grid_constant__ LevelTable grads,   // f32 outputs
                             int num_levels, int batch,
                             const int* __restrict__ roi_i,
                             const unsigned char* __restrict__ records,
                             const float* __restrict__ g,           // (R, s, s, C)
                             const int* __restrict__ tile_start,    // (tiles + 1)
                             const int* __restrict__ tile_rois,     // ROIs by tile, ascending
                             int channels, int s, int win_y, int win_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVecs = kChunk / 4;                 // float4 per cell of the chunk
  constexpr int kSlots = kThreads / kVecs;          // a thread's cells: slot, slot + 16, ...
  const int bins_bytes = s * s * kChunk * static_cast<int>(sizeof(float));
  const int rec = record_bytes(s, win_y, win_x);
  const int stage = bins_bytes + rec;
  const int stages = backward_stages(s, win_y, win_x);

  // the block's tile: level, image, first row and column (levels in order,
  // then images, then tile rows and columns)
  int t = blockIdx.x, lvl = 0;
  while (lvl < num_levels - 1 && t >= batch * tiles_of(grads.h[lvl], grads.w[lvl])) {
    t -= batch * tiles_of(grads.h[lvl], grads.w[lvl]);
    ++lvl;
  }
  const int height = grads.h[lvl];
  const int width = grads.w[lvl];
  const int tiles_x = (width + kTile - 1) / kTile;
  const int per_image = tiles_of(height, width);
  const int b = t / per_image;
  const int y0 = (t - b * per_image) / tiles_x * kTile;
  const int x0 = (t - b * per_image) % tiles_x * kTile;

  const int c0 = blockIdx.y * kChunk;
  const int cn = min(kChunk, channels - c0);
  const int vec = threadIdx.x % kVecs;
  const int slot = threadIdx.x / kVecs;
  const bool has_vec = vec < cn / 4;

  // Copies ROI tile_rois[i]'s record and the cotangent of its bins that
  // touch a cell of the tile into stage buf of the ring (16-byte cp.async;
  // the bins' ranges are read from the record in global memory), as one
  // group of copies.
  auto stage_roi = [&](int i, int buf) {
    const int roi = tile_rois[i];
    unsigned char* base = smem + buf * stage;
    const unsigned char* src = records + static_cast<size_t>(roi) * rec;
    for (int k = threadIdx.x; k < rec / 16; k += kThreads) {
      __pipeline_memcpy_async(base + bins_bytes + k * 16, src + k * 16, 16);
    }
    const int* bin_lo = reinterpret_cast<const int*>(src) + s * (win_y + win_x);
    const int* bin_hi = bin_lo + 2 * s;
    const int ty_lo = y0 - roi_i[roi * 4 + 1], ty_hi = ty_lo + kTile - 1;
    const int tx_lo = x0 - roi_i[roi * 4 + 2], tx_hi = tx_lo + kTile - 1;
    const float* g_roi = g + static_cast<size_t>(roi) * s * s * channels + c0;
    float* bins = reinterpret_cast<float*>(base);
    for (int item = threadIdx.x; item < s * s * kVecs; item += kThreads) {
      const int v = item % kVecs;
      const int bin = item / kVecs;
      const int py = bin / s;
      const int px = bin - py * s;
      if (v < cn / 4 && __ldg(bin_lo + py) <= ty_hi && __ldg(bin_hi + py) >= ty_lo &&
          __ldg(bin_lo + s + px) <= tx_hi && __ldg(bin_hi + s + px) >= tx_lo) {
        __pipeline_memcpy_async(bins + bin * kChunk + v * 4,
                                g_roi + static_cast<size_t>(bin) * channels + v * 4, 16);
      }
    }
    __pipeline_commit();
  };

  float4 acc[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // The ring: the copies of the next stages - 1 ROIs fly while one is added.
  // A group is committed for every slot, empty past the list's end, so that
  // waiting for all but the newest stages - 1 groups waits for ROI i's.
  const int first = tile_start[blockIdx.x];
  const int last = tile_start[blockIdx.x + 1];
  for (int j = 0; j < stages - 1; ++j) {
    if (first + j < last) {
      stage_roi(first + j, j);
    } else {
      __pipeline_commit();
    }
  }
  for (int i = first; i < last; ++i) {
    const int buf = (i - first) % stages;
    const int ahead = i + stages - 1;               // into the stage freed last round
    if (ahead < last) {
      stage_roi(ahead, (ahead - first) % stages);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(stages - 1);
    __syncthreads();
    const float* bins_v = reinterpret_cast<const float*>(smem + buf * stage) + vec * 4;
    const Tables tb = carve_tables(smem + buf * stage + bins_bytes, s, win_y, win_x);
    const int roi = tile_rois[i];
    const int ty_lo = y0 - roi_i[roi * 4 + 1];      // the tile's first row, window-local
    const int tx_lo = x0 - roi_i[roi * 4 + 2];
    if (has_vec) {
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) {
        const int cell = slot + k * kSlots;
        const int y = ty_lo + cell / kTile;         // window-local
        const int x = tx_lo + cell % kTile;
        if (y < 0 || y >= win_y || x < 0 || x >= win_x) continue;
        const int py_lo = tb.cell_lo[y], py_hi = tb.cell_hi[y];
        const int px_lo = tb.cell_lo[win_y + x], px_hi = tb.cell_hi[win_y + x];
        if (py_hi < py_lo || px_hi < px_lo) continue;   // no bin touches this cell
        float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int py = py_lo; py <= py_hi; ++py) {
          const float a = tb.wy[py * win_y + y];
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int px = px_lo; px <= px_hi; ++px) {
            const float w = tb.wx[px * win_x + x];
            const float4 v = *reinterpret_cast<const float4*>(bins_v + (py * s + px) * kChunk);
            sum.x += w * v.x;
            sum.y += w * v.y;
            sum.z += w * v.z;
            sum.w += w * v.w;
          }
          part.x += a * sum.x;
          part.y += a * sum.y;
          part.z += a * sum.z;
          part.w += a * sum.w;
        }
        acc[k].x += part.x;                           // this ROI after the ones before
        acc[k].y += part.y;
        acc[k].z += part.z;
        acc[k].w += part.w;
      }
    }
    __syncthreads();   // this stage is filled again next round
  }
  if (!has_vec) return;
  float* level = static_cast<float*>(const_cast<void*>(grads.ptr[lvl]));
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int cell = slot + k * kSlots;
    const int y = y0 + cell / kTile;
    const int x = x0 + cell % kTile;
    if (y < height && x < width) {
      *reinterpret_cast<float4*>(
          level + ((static_cast<size_t>(b) * height + y) * width + x) * channels + c0 +
          vec * 4) = acc[k];
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct PoolArgs {
  LevelTable levels;
  const int* roi_i;
  const float* roi_f;
  int num_rois, channels, s, r, win_y, win_x;
  int threads, stage_bytes;        // forward only
  cudaStream_t stream;
};

int forward_smem_bytes(int s, int win_y, int win_x, int stage_bytes) {
  return stage_bytes + table_bytes(s, win_y, win_x);
}

int backward_smem_bytes(int s, int win_y, int win_x) {
  return backward_stages(s, win_y, win_x) * stage_bytes_of(s, win_y, win_x);
}

bool span_args_ok(const PoolArgs& a) {
  return a.s >= 1 && a.r >= 1 && a.s * a.r <= kMaxSamples && a.win_y >= 1 &&
         a.win_x >= 1 && a.channels >= 8 && a.channels % 8 == 0 &&
         a.threads % 32 == 0 && a.threads >= 2 * a.s && a.threads >= 32 &&
         a.threads <= kThreads && (a.channels + kChunk - 1) / kChunk <= 65535;
}

template <typename Tin, typename Tout>
cudaError_t launch_forward(const PoolArgs& a, void* out) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_ml_kernel<Tin, Tout>;
  // the buffer holds at least one row of the widest span
  if (a.stage_bytes % 16 != 0 ||
      a.stage_bytes < a.win_x * kChunk * static_cast<int>(sizeof(Tin))) {
    return cudaErrorInvalidValue;
  }
  const int smem = forward_smem_bytes(a.s, a.win_y, a.win_x, a.stage_bytes);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(a.num_rois, (a.channels + kChunk - 1) / kChunk);
  kernel<<<grid, a.threads, smem, a.stream>>>(
      a.levels, a.roi_i, a.roi_f, static_cast<Tout*>(out), a.channels, a.s, a.r,
      a.win_y, a.win_x, a.stage_bytes);
  return cudaGetLastError();
}

struct Routing {   // the per-tile ROI lists and the ROIs' records
  const unsigned char* records;
  const int* tile_start;
  const int* tile_rois;
  int num_tiles;
};

long long count_tiles(const LevelTable& t, int num_levels, int batch) {
  long long tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    tiles += static_cast<long long>(batch) * tiles_of(t.h[l], t.w[l]);
  }
  return tiles;
}

cudaError_t launch_route(const PoolArgs& a, int num_levels, int batch, int num_tiles,
                         unsigned char* records, long long* keys) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_ml_backward_route_kernel;
  const int smem = table_bytes(a.s, a.win_y, a.win_x);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_rois, kPrepThreads, smem, a.stream>>>(
      a.levels, num_levels, batch, a.roi_i, a.roi_f, a.num_rois, a.s, a.r, a.win_y,
      a.win_x, num_tiles, records, keys);
  return cudaGetLastError();
}

cudaError_t launch_backward(const PoolArgs& a, int num_levels, int batch, const float* g,
                            const Routing& route) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_ml_backward_kernel;
  const int smem = backward_smem_bytes(a.s, a.win_y, a.win_x);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(route.num_tiles, (a.channels + kChunk - 1) / kChunk);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.levels, num_levels, batch, a.roi_i, route.records, g, route.tile_start,
      route.tile_rois, a.channels, a.s, a.win_y, a.win_x);
  return cudaGetLastError();
}

bool fill_levels(LevelTable* t, const int64_t* ptrs, const int* hs, const int* ws,
                 int num_levels) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  *t = LevelTable{};
  for (int l = 0; l < num_levels; ++l) {
    t->ptr[l] = reinterpret_cast<const void*>(ptrs[l]);
    t->h[l] = hs[l];
    t->w[l] = ws[l];
  }
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. threads: block size, a multiple of
// 32 in [max(32, 2 s), 256]; stage_bytes: the block's buffer of staged level
// cells, a multiple of 16 that holds at least win_x cells of a chunk (the
// wrapper passes what its forward_plan(s) measured to be fastest). Levels, roi tables and out are 16-byte
// aligned, channels a multiple of 8. Returns a cudaError_t value.
extern "C" int u2seg_roi_align_ml_forward(
    const int64_t* level_ptrs, const int* level_h, const int* level_w,
    int num_levels, const int* roi_i, const float* roi_f, void* out,
    int num_rois, int channels, int s, int r, int win_y, int win_x,
    int dtype_in, int dtype_out, int threads, int stage_bytes, void* stream) {
  PoolArgs a = {};
  if (!fill_levels(&a.levels, level_ptrs, level_h, level_w, num_levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.roi_i = roi_i;
  a.roi_f = roi_f;
  a.num_rois = num_rois;
  a.channels = channels;
  a.s = s;
  a.r = r;
  a.win_y = win_y;
  a.win_x = win_x;
  a.threads = threads;
  a.stage_bytes = stage_bytes;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!span_args_ok(a) || dtype_in < 0 || dtype_in > 1 || dtype_out < 0 || dtype_out > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  if (dtype_in == 0 && dtype_out == 0) {
    err = launch_forward<float, float>(a, out);
  } else if (dtype_in == 0) {
    err = launch_forward<float, __nv_bfloat16>(a, out);
  } else if (dtype_out == 0) {
    err = launch_forward<__nv_bfloat16, float>(a, out);
  } else {
    err = launch_forward<__nv_bfloat16, __nv_bfloat16>(a, out);
  }
  return static_cast<int>(err);
}

// The two launches of the gradient of the forward w.r.t. the levels (one
// call of the wrapper, K3). Tiles have kTile x kTile cells of one level and
// image and are numbered by level, image, tile row and column; there are
// num_tiles of them (checked against the level dims).
//
// 1. u2seg_roi_align_ml_backward_route: per ROI its record
//    (u2seg_roi_align_ml_backward_layout gives the bytes; records 16-byte
//    aligned) and its slots of int64 keys, tile * num_rois + roi for each tile
//    its span meets, num_tiles * num_rois in the others. num_rois >= 1.
// 2. The wrapper sorts the keys: tile_rois (int32) lists the ROIs of tile t
//    at tile_rois[tile_start[t] .. tile_start[t + 1]) in ascending index.
// 3. u2seg_roi_align_ml_backward: grad_ptrs are num_levels f32 buffers
//    (batch, h_l, w_l, channels), 16-byte aligned, every element of which is
//    written (they need not be initialised); g is the (num_rois, s, s,
//    channels) f32 cotangent.
// Return a cudaError_t value.
extern "C" int u2seg_roi_align_ml_backward_route(
    const int* level_h, const int* level_w, int num_levels, int batch, const int* roi_i,
    const float* roi_f, int num_rois, int s, int r, int win_y, int win_x, int num_tiles,
    void* records, void* keys, void* stream) {
  PoolArgs a = {};
  const int64_t no_ptrs[kMaxLevels] = {};       // the routing reads dims only
  if (!fill_levels(&a.levels, no_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      num_rois < 1 || count_tiles(a.levels, num_levels, batch) != num_tiles ||
      static_cast<long long>(num_tiles) * num_rois >= (1LL << 62)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.roi_i = roi_i;
  a.roi_f = roi_f;
  a.num_rois = num_rois;
  a.channels = 8;
  a.s = s;
  a.r = r;
  a.win_y = win_y;
  a.win_x = win_x;
  a.threads = kThreads;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!span_args_ok(a) || 2 * s > kPrepThreads) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_route(a, num_levels, batch, num_tiles,
                                       static_cast<unsigned char*>(records),
                                       static_cast<long long*>(keys)));
}

extern "C" int u2seg_roi_align_ml_backward(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w,
    int num_levels, int batch, const int* roi_i, const void* records,
    const float* g, const int* tile_start, const int* tile_rois, int num_tiles,
    int num_rois, int channels, int s, int win_y, int win_x, void* stream) {
  PoolArgs a = {};
  if (!fill_levels(&a.levels, grad_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      num_rois < 0 || count_tiles(a.levels, num_levels, batch) != num_tiles ||
      num_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.roi_i = roi_i;
  a.num_rois = num_rois;
  a.channels = channels;
  a.s = s;
  a.r = 1;
  a.win_y = win_y;
  a.win_x = win_x;
  a.threads = kThreads;
  a.stream = static_cast<cudaStream_t>(stream);
  if (!span_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_backward(
      a, num_levels, batch, g,
      Routing{static_cast<const unsigned char*>(records), tile_start, tile_rois, num_tiles}));
}

// The backward's layout: out[0] the tile side in cells, out[1] the key slots
// per ROI, out[2] the bytes of a ROI's record.
extern "C" void u2seg_roi_align_ml_backward_layout(int s, int win_y, int win_x, int* out) {
  out[0] = kTile;
  out[1] = slots_of(win_y) * slots_of(win_x);
  out[2] = record_bytes(s, win_y, win_x);
}

// Dynamic shared memory of one block of the span kernels, in bytes.
extern "C" int u2seg_roi_align_ml_smem_bytes(int backward, int s, int win_y,
                                             int win_x, int stage_bytes) {
  return backward ? backward_smem_bytes(s, win_y, win_x)
                  : forward_smem_bytes(s, win_y, win_x, stage_bytes);
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
