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
// gradients repeat exactly; this one adds in a fixed order of its own and
// repeats too: the ROIs of a cell in ascending index, cut into segments of at
// most kSegment, each segment's ROIs in order, then the segments in order.
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
// written by one thread of one block in one fixed order of adds, so the
// result is one fixed function of the inputs: two runs give the same bits,
// and it runs under torch.use_deterministic_algorithms(True). No atomic
// decides a value (the gather's work counter decides only which block adds
// an item). The levels are cut into tiles of kTile x kTile cells per image.
// Six launches:
// - routing (roi_align_ml_backward_route_kernel), one block per ROI: the
//   ROI's tables from roi_f with build_dense (the forward's tap rule) and
//   the per-cell bin ranges, stored as its record; its span in tiles; and,
//   per tile it meets, the list entry roi << kPairBits | the bins that touch
//   the tile and the tile's place in the ROI's window;
// - count and fill (roi_align_ml_backward_list_kernel), a counting sort: a
//   warp per tile walks the ROIs' spans in ascending index with ballots,
//   first to count each tile's ROIs, then to write its list in that order;
// - plan (roi_align_ml_backward_plan_kernel), one block: the lists' starts
//   (a scan of the counts); each list cut into segments of kSegment ROIs,
//   one work item each, ordered by descending ROI count (a counting sort
//   over the kSegment + 1 counts, ties by tile), so the heaviest items start
//   first; segment 0 of a tile stores into the level, segments 1.. into
//   partial slots of a scratch buffer, whose tiles the plan lists as folds;
// - gather (roi_align_ml_backward_kernel), a persistent grid (3 blocks an
//   SM) that takes the work items in the plan's order from a counter, so
//   that a free block takes the next: one producer warp stages each ROI's
//   record (a bulk copy) and the rows of cotangent bins that touch the tile
//   (one tensor copy per row of up to kBoxBins bins, over a tensor map of g)
//   into a ring of kStages slots, each on a full and an empty mbarrier;
//   eight consumer warps add each ROI's Wy * (sum over px of Wx * g) into
//   f32 registers (a thread owns 4 channels of 4 cells) and store the item
//   once; no block-wide barrier per ROI, and an item of no ROI stores zeros;
// - fold (roi_align_ml_backward_fold_kernel): a cut tile's partials added, in
//   segment order, to what its segment 0 stored.
//
// What was measured on the way (device ms of the whole call at the `k3`
// phase's shapes, s=7 R=1024 / s=14 R=256 / a pile of 200 large ROIs at s=7,
// each against its predecessor in one call; u2seg_torch/dev/
// time_roi_align_backward.py times a build's launches and variants of it):
// the ordered gather before this design 0.4814 / 0.3154, its torch.sort of
// keys 0.0799 / 0.0974 of that; routing + counting sort + plan + a static
// persistent gather (one bulk copy per bin, 4 blocks an SM) 0.2288 /
// 0.1537 / 0.1492; the counter instead of a static round of items, at 3
// blocks an SM (at 4 the adds spill) 0.2098 / 0.1316 / 0.1270 (at 4:
// 0.2488 / 0.1831 / 0.1786); tensor copies of whole bin rows and 8 tiles a
// count/fill block 0.1964 / 0.1280 / 0.1243. Not taken: 16-byte cp.async by
// the producer's lanes (0.2335 / 0.1546 / 0.1310), rings of 4 or 6 slots
// (no gain or slower), 8 or 32 ROIs a segment (within 2-4%), the record
// transposed to copy only the tile's rows and columns (4 copies for 1:
// slower), the column sums shared by a thread's 4 cells (bit-equal, slower
// at 2 and 3 blocks an SM). Where the gather's time goes (builds that skip
// work): its stores alone 0.066 / 0.064 / 0.065, without the adds 0.104 /
// 0.087 / 0.071, without the bin copies 0.153 / 0.102 / 0.088, whole 0.157 /
// 0.103 / 0.089: the f32 writes, then the adds' dependent FMA chains over
// the many bins of small ROIs, then the pieces' hand-over.

// Bound on this card: bytes, for both. The forward moves s*s*C output values
// and the distinct level cells it touches per ROI, for ~2 * 12 flops per
// output value; the backward reads g once and must write every gradient cell
// once. What the span design pays above the bound. Forward: the spans of
// neighbouring ROIs overlap, so the blocks read ~3x the distinct cells (from
// L2 for the most part), and each 8-channel output value costs some 300
// instructions (per tap one 16-byte shared load, 8 bf16 unpacks, 8 FMAs) in
// small blocks that run tables, copy and compute one after another.
// Backward: a ROI that covers k tiles has its record and the bins at a
// tile's edge copied up to k times per chunk, and a cut tile's partials are
// written and read once more (the scratch bytes, reported beside the bound).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int kSegment = 16;                     // ROIs of a tile list per work item
constexpr int kConsumers = 256;                  // threads that add (8 warps)
constexpr int kGatherThreads = kConsumers + 32;  // + the producer warp
constexpr int kCellsPerThread = kTileCells * (kChunk / 4) / kConsumers;   // 4
constexpr int kPrepThreads = 64;                 // the routing pass: >= 2 s for s <= 32
constexpr int kPlanThreads = 1024;               // the plan: one block
constexpr int kListThreads = 256;                // the counting sort: a warp per tile
constexpr int kListTiles = 8;                    // tiles per block
constexpr int kListStage = 2048;                 // ROI spans in shared memory at a time
constexpr int kFoldThreads = 256;
constexpr int kStages = 3;                       // the gather's ring of pieces
constexpr int kRingBytes = 55296;                // its slots
constexpr int kHeaderBytes = 32;                 // a piece's header (below)
constexpr int kPreambleBytes =                   // full[], empty[]; headers; 128-aligned
    (kStages * (16 + kHeaderBytes) + 127) / 128 * 128;
constexpr int kBinBytes = kChunk * static_cast<int>(sizeof(float));
constexpr int kBoxBins = 8;                      // bins of a row per tensor copy
// A list entry of a tile: roi << kPairBits | the pair's geometry (below).
constexpr int kPairBits = 34;
static_assert(kTileCells * (kChunk / 4) % kConsumers == 0, "a thread owns whole cells");
static_assert(kSegment <= 32, "the producer warp holds a segment's entries, one per lane");

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

// A slot: the ROI's record, then rows of bins of f32 cotangent (kChunk
// channels each), a row a whole number of kBoxBins, all 128-byte aligned
// (a tensor copy's destination must be).
__host__ __device__ constexpr int record_area(int s, int win_y, int win_x) {
  return (record_bytes(s, win_y, win_x) + 127) / 128 * 128;
}

// Bins a row of the widest rectangle takes: s rounded up to kBoxBins.
__host__ __device__ constexpr int row_bins_of(int n) { return (n + kBoxBins - 1) / kBoxBins * kBoxBins; }

// The bins a slot holds: what is left of kRingBytes / kStages after the
// record, in whole boxes, at least one row of the widest rectangle and at
// most all its rows.
__host__ __device__ constexpr int slot_bins(int s, int win_y, int win_x) {
  return (kRingBytes / kStages - record_area(s, win_y, win_x)) / kBinBytes / kBoxBins *
                     kBoxBins < row_bins_of(s)
             ? row_bins_of(s)
         : (kRingBytes / kStages - record_area(s, win_y, win_x)) / kBinBytes / kBoxBins *
                     kBoxBins > row_bins_of(s) * s
             ? row_bins_of(s) * s
             : (kRingBytes / kStages - record_area(s, win_y, win_x)) / kBinBytes / kBoxBins *
                   kBoxBins;
}

__host__ __device__ constexpr int slot_bytes(int s, int win_y, int win_x) {
  return record_area(s, win_y, win_x) + slot_bins(s, win_y, win_x) * kBinBytes;
}

// The geometry of a (tile, ROI) pair, the low kPairBits of its entry: the
// bins that touch the tile (rows py0 .. py0 + ny - 1, columns px0 .. px0 +
// nx - 1; ny or nx 0 where none does) and the tile's first cell in the ROI's
// window (ty, tx in [-7, 47], stored + 8).
struct Pair {
  int py0, ny, px0, nx, ty, tx;
};

__host__ __device__ __forceinline__ long long pack_pair(const Pair& p) {
  return static_cast<long long>(p.py0) | static_cast<long long>(p.ny) << 5 |
         static_cast<long long>(p.px0) << 11 | static_cast<long long>(p.nx) << 16 |
         static_cast<long long>(p.ty + 8) << 22 | static_cast<long long>(p.tx + 8) << 28;
}

__device__ __forceinline__ Pair unpack_pair(long long key) {
  const unsigned int v = static_cast<unsigned int>(key);     // bits 0-31
  const unsigned int hi = static_cast<unsigned int>(key >> 32) & 3u;
  Pair p;
  p.py0 = v & 31;
  p.ny = (v >> 5) & 63;
  p.px0 = (v >> 11) & 31;
  p.nx = (v >> 16) & 63;
  p.ty = static_cast<int>((v >> 22) & 63) - 8;
  p.tx = static_cast<int>((v >> 28) | hi << 4) - 8;
  return p;
}

// The bins of one axis whose cells [lo, hi] overlap the tile's cells
// [t, t + kTile - 1] (window-local): first and count.
__device__ __forceinline__ void bins_touching(const int* bin_lo, const int* bin_hi, int s,
                                              int t, int* first, int* count) {
  int a = s, b = -1;
  for (int k = 0; k < s; ++k) {
    if (bin_lo[k] <= t + kTile - 1 && bin_hi[k] >= t) {
      a = min(a, k);
      b = max(b, k);
    }
  }
  *first = b < a ? 0 : a;
  *count = b < a ? 0 : b - a + 1;
}

// The routing pass: one block per ROI builds the ROI's tables from roi_f
// (build_dense with the window clip, then the per-cell bin ranges), stores
// them as the ROI's record, and for the tiles of its level and image that
// its span meets, the span in tiles (spans: level * batch + image, or -1 for
// a ROI of no weight; first | last tile row << 16; first | last column <<
// 16) and, in slot (tile row - first) * slots_of(win_x) + column - first, the
// entry roi << kPairBits | the pair's geometry that the tile's list gets.
__global__ void __launch_bounds__(kPrepThreads)
roi_align_ml_backward_route_kernel(const __grid_constant__ LevelTable levels,
                                   int batch, const int* __restrict__ roi_i,
                                   const float* __restrict__ roi_f, int s, int r,
                                   int win_y, int win_x, unsigned char* __restrict__ records,
                                   int4* __restrict__ spans, long long* __restrict__ words) {
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
  const int ty0 = (oy + sp.y_lo) / kTile, ty1 = (oy + sp.y_hi) / kTile;
  const int tx0 = (ox + sp.x_lo) / kTile, tx1 = (ox + sp.x_hi) / kTile;
  if (threadIdx.x == 0) {
    spans[roi] = live ? make_int4(lvl * batch + b, ty0 | ty1 << 16, tx0 | tx1 << 16, 0)
                      : make_int4(-1, 0, 0, 0);
  }
  const int ny = slots_of(win_y), nx = slots_of(win_x);
  long long* out = words + static_cast<size_t>(roi) * ny * nx;
  for (int i = threadIdx.x; i < ny * nx && live; i += blockDim.x) {
    const int ty = ty0 + i / nx;
    const int tx = tx0 + i % nx;
    if (ty > ty1 || tx > tx1) continue;
    Pair p;
    p.ty = ty * kTile - oy;
    p.tx = tx * kTile - ox;
    bins_touching(tb.bin_lo, tb.bin_hi, s, p.ty, &p.py0, &p.ny);
    bins_touching(tb.bin_lo + s, tb.bin_hi + s, s, p.tx, &p.px0, &p.nx);
    out[i] = static_cast<long long>(roi) << kPairBits | pack_pair(p);
  }
}

// The tile's level, image and first cell (tiles numbered by level, image,
// tile row and column).
struct TileAt {
  int lvl, b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(const LevelTable& grads, int num_levels, int batch,
                                          int t) {
  int lvl = 0;
  while (lvl < num_levels - 1 && t >= batch * tiles_of(grads.h[lvl], grads.w[lvl])) {
    t -= batch * tiles_of(grads.h[lvl], grads.w[lvl]);
    ++lvl;
  }
  const int tiles_x = (grads.w[lvl] + kTile - 1) / kTile;
  const int per_image = tiles_of(grads.h[lvl], grads.w[lvl]);
  TileAt a;
  a.lvl = lvl;
  a.b = t / per_image;
  a.y0 = (t - a.b * per_image) / tiles_x * kTile;
  a.x0 = (t - a.b * per_image) % tiles_x * kTile;
  return a;
}

// The counting sort of the (tile, ROI) pairs, two launches of one kernel
// around the plan: a warp per tile walks the ROIs' spans in ascending
// index, 32 at a time (staged in shared memory), and a ballot finds the ROIs
// that meet each of its tiles. kFill = false: each tile's count. kFill =
// true: the tile's list, from tile_start on, gets those ROIs' entries in that
// order (their rank from the ballot). No atomics: each count and each list
// entry is written by one thread.
template <bool kFill>
__global__ void __launch_bounds__(kListThreads)
roi_align_ml_backward_list_kernel(const __grid_constant__ LevelTable levels,
                                  int num_levels, int batch, int num_tiles,
                                  const int4* __restrict__ spans, int num_rois, int slots_x,
                                  int slots, int* __restrict__ tile_count,
                                  const int* __restrict__ tile_start,
                                  const long long* __restrict__ words,
                                  long long* __restrict__ lists) {
  __shared__ int4 staged[kListStage];
  constexpr int kPerWarp = kListTiles / (kListThreads / 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  int key[kPerWarp], ty[kPerWarp], tx[kPerWarp], n[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int tile = blockIdx.x * kListTiles + warp * kPerWarp + j;
    key[j] = -2;                                    // meets no span
    ty[j] = tx[j] = n[j] = 0;
    if (tile < num_tiles) {
      const TileAt at = tile_at(levels, num_levels, batch, tile);
      key[j] = at.lvl * batch + at.b;
      ty[j] = at.y0 / kTile;
      tx[j] = at.x0 / kTile;
      if (kFill) n[j] = tile_start[tile];
    }
  }
  for (int c0 = 0; c0 < num_rois; c0 += kListStage) {
    const int m = min(kListStage, num_rois - c0);
    __syncthreads();                                // the last stage is read
    for (int i = threadIdx.x; i < m; i += kListThreads) staged[i] = spans[c0 + i];
    __syncthreads();
    for (int i0 = 0; i0 < m; i0 += 32) {
      const int i = i0 + lane;
      const int4 sp = i < m ? staged[i] : make_int4(-1, 0, 0, 0);
      const int ty0 = sp.y & 0xffff, ty1 = sp.y >> 16;
      const int tx0 = sp.z & 0xffff, tx1 = sp.z >> 16;
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const bool hit = sp.x == key[j] && ty0 <= ty[j] && ty[j] <= ty1 && tx0 <= tx[j] &&
                         tx[j] <= tx1;
        const unsigned int mask = __ballot_sync(0xffffffffu, hit);
        if (kFill && hit) {
          const int slot = (ty[j] - ty0) * slots_x + tx[j] - tx0;
          lists[n[j] + __popc(mask & ((1u << lane) - 1u))] =
              words[static_cast<size_t>(c0 + i) * slots + slot];
        }
        n[j] += __popc(mask);
      }
    }
  }
  if (!kFill && lane == 0) {
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int tile = blockIdx.x * kListTiles + warp * kPerWarp + j;
      if (tile < num_tiles) tile_count[tile] = n[j];
    }
  }
}

// Exclusive prefix sum over the block (blockDim.x a multiple of 32, at most
// 1024); *total gets the sum. Uses warp_sums[32]; ends with a __syncthreads.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int n = blockDim.x >> 5;
    int w = lane < n ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;                            // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before;
}

// The plan, one block: from the tiles' counts, the list starts (an
// exclusive scan), then the work items (tile, first list entry, ROI count,
// partial slot) in descending count, ties by tile and segment, by a
// counting sort over the kSegment + 1 counts, and the folds (tile, first
// partial slot, partials) of the tiles cut into more than one segment, in
// tile order. Segment 0 of a tile stores into the gradient level (slot -1),
// segment k >= 1 into partial slot first + k - 1. No atomics: every entry is
// written by one thread. counts[0] gets the items, counts[1] the folds.
__global__ void __launch_bounds__(kPlanThreads)
roi_align_ml_backward_plan_kernel(const int* __restrict__ tile_count, int num_tiles,
                                  int* __restrict__ tile_start, int4* __restrict__ items,
                                  int4* __restrict__ folds, int* __restrict__ counts) {
  extern __shared__ __align__(16) int hist[];     // [(kSegment + 1) * kPlanThreads], [32]
  int* warp_sums = hist + (kSegment + 1) * kPlanThreads;
  const int t = threadIdx.x;
  for (int i = t; i < (kSegment + 1) * kPlanThreads; i += kPlanThreads) hist[i] = 0;
  // per thread, a run of consecutive tiles: its items per count (count c
  // at hist[(kSegment - c) * kPlanThreads + t]), entries, partial slots, folds
  const int per = (num_tiles + kPlanThreads - 1) / kPlanThreads;
  const int t0 = min(num_tiles, t * per), t1 = min(num_tiles, t0 + per);
  __syncthreads();
  int entries = 0, partials = 0, n_folds = 0;
  for (int u = t0; u < t1; ++u) {
    const int n = tile_count[u];
    entries += n;
    hist[t] += n / kSegment;
    if (n % kSegment || n == 0) hist[(kSegment - n % kSegment) * kPlanThreads + t] += 1;
    if (n > kSegment) {
      partials += (n - 1) / kSegment;
      n_folds += 1;
    }
  }
  int total_entries, total_partials, total_folds;
  int start = block_scan(entries, warp_sums, &total_entries);
  int slot = block_scan(partials, warp_sums, &total_partials);
  int fold = block_scan(n_folds, warp_sums, &total_folds);
  // exclusive scan of hist in its order (count kSegment first)
  int* run = hist + t * (kSegment + 1);
  int sum = 0;
  for (int k = 0; k <= kSegment; ++k) sum += run[k];
  int n_items;
  int acc = block_scan(sum, warp_sums, &n_items);
  for (int k = 0; k <= kSegment; ++k) {
    const int v = run[k];
    run[k] = acc;
    acc += v;
  }
  __syncthreads();
  // the run's list starts, items and folds
  for (int u = t0; u < t1; ++u) {
    const int n = tile_count[u];
    tile_start[u] = start;
    const int segs = n == 0 ? 1 : (n + kSegment - 1) / kSegment;
    for (int k = 0; k < segs; ++k) {
      const int len = min(kSegment, n - k * kSegment);
      int* pos = hist + (kSegment - len) * kPlanThreads + t;
      items[*pos] = make_int4(u, start + k * kSegment, len, k ? slot + k - 1 : -1);
      *pos += 1;
    }
    if (segs > 1) {
      folds[fold++] = make_int4(u, slot, segs - 1, 0);
      slot += segs - 1;
    }
    start += n;
  }
  if (t == 0) {
    tile_start[num_tiles] = total_entries;
    counts[0] = n_items;
    counts[1] = total_folds;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\tmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "\t@!done bra WAIT;\n}" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
// A bulk copy of bytes (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory that completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A tensor copy of one box of the cotangent, g viewed as (R * s rows, s
// bins, C channels): kChunk channels from c0 of kBoxBins bins from px of
// row y (bins past s and channels past C come as zeros), 128-byte aligned
// destination, completing on bar.
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map, int c0, int px,
                                         int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(px), "r"(y),
        "r"(smem_addr(bar))
      : "memory");
}

// What the producer tells the consumers of one piece (beside its slot).
struct Header {
  int tile, slot, c0;    // the work: its tile, partial slot (-1: the level), channels
  int flags;             // kFirst | kLast piece of the work, kDone: no more work
  int ty, tx;            // the tile's first cell in the ROI's window
  int rows;              // bin rows pa .. pb - 1 | px0 << 16
  int stride;            // bins a staged row takes
};
constexpr int kFirst = 1, kLast = 2, kDone = 4;
static_assert(sizeof(Header) == kHeaderBytes, "the preamble's layout");

// The gather: a persistent grid takes the work (item, chunk of 64 channels)
// in the plan's order from a counter (counts[2], zeroed before it runs): a
// block that is done asks for the next, so heavy items start first and the
// rest spread over whichever blocks are free. Which block adds an item never
// changes a value. One producer warp takes the works and stages, piece by
// piece, each ROI's record (a bulk copy) and the rows of its bins that touch
// the tile (a tensor copy per kBoxBins bins of a row; a piece: as many whole
// rows as a slot holds) into a ring of kStages slots, on a full and an empty
// mbarrier each; the header of a piece tells the consumers what it is (a
// work of no ROIs is one piece with no bins). The eight consumer warps add
// each piece into f32 registers (a thread owns 4 channels of 4 cells: Wy *
// (sum over px of Wx * g), bins in a fixed order) and store the work's sum
// once, into the gradient level (segment 0) or its partial slot.
__global__ void __launch_bounds__(kGatherThreads, 3)
roi_align_ml_backward_kernel(const __grid_constant__ LevelTable grads,   // f32 outputs
                             int num_levels, int batch,
                             const unsigned char* __restrict__ records,
                             const __grid_constant__ CUtensorMap g_map,   // (R, s, s, C)
                             const long long* __restrict__ lists,   // the tiles' entries
                             const int4* __restrict__ items,
                             int* __restrict__ counts,              // items, folds, next
                             float* __restrict__ partials,          // (slots, 64, C)
                             int channels, int s, int win_y, int win_x) {
  extern __shared__ __align__(128) unsigned char gather_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(gather_smem);
  uint64_t* empty = full + kStages;
  Header* headers = reinterpret_cast<Header*>(gather_smem + 16 * kStages);
  unsigned char* ring = gather_smem + kPreambleBytes;
  const int rec = record_bytes(s, win_y, win_x);
  const int area = record_area(s, win_y, win_x);
  const int slot_size = slot_bytes(s, win_y, win_x);
  const int cap = slot_bins(s, win_y, win_x);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int chunks = (channels + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  int q = 0;                                        // pieces through the ring so far
  if (threadIdx.x >= kConsumers) {                  // the producer warp
    const int n_work = counts[0] * chunks;
    // the next work and its item are asked for while this one is staged
    int w = 0;
    if (lane == 0) w = atomicAdd(counts + 2, 1);
    w = __shfl_sync(0xffffffffu, w, 0);
    int4 it = w < n_work ? items[w / chunks] : make_int4(0, 0, 0, 0);
    for (;;) {
      if (w >= n_work) {                            // tell the consumers, then stop
        const int st = q % kStages;
        mbar_wait(empty + st, ((q / kStages) & 1) ^ 1);
        if (lane == 0) {
          headers[st].flags = kDone;
          mbar_arrive(full + st);
        }
        return;
      }
      const int c0 = (w % chunks) * kChunk;
      const long long entry = lane < it.z ? lists[it.y + lane] : 0;
      int w_next = 0;
      if (lane == 0) w_next = atomicAdd(counts + 2, 1);
      w_next = __shfl_sync(0xffffffffu, w_next, 0);
      const int4 it_next = w_next < n_work ? items[w_next / chunks] : make_int4(0, 0, 0, 0);
      for (int k = 0; k < max(it.z, 1); ++k) {
        const long long kk = __shfl_sync(0xffffffffu, entry, k);
        const int roi = static_cast<int>(kk >> kPairBits);
        const Pair p = it.z ? unpack_pair(kk) : Pair{0, 0, 0, 0, 0, 0};
        const int stride = row_bins_of(p.nx);        // bins a staged row takes
        const int per = max(1, cap / max(1, stride));  // bin rows a piece holds
        const int pieces = (p.ny == 0 || p.nx == 0) ? 1 : (p.ny + per - 1) / per;
        for (int piece = 0; piece < pieces; ++piece, ++q) {
          const int st = q % kStages;
          mbar_wait(empty + st, ((q / kStages) & 1) ^ 1);
          const int pa = p.py0 + piece * per;
          const int pb = min(p.py0 + p.ny, pa + per);
          const int n_rows = (p.ny == 0 || p.nx == 0) ? 0 : pb - pa;
          unsigned char* base = ring + st * slot_size;
          if (lane == 0) {
            const bool last = k + 1 >= it.z && piece == pieces - 1;
            headers[st] = Header{it.x, it.w, c0, (k == 0 && piece == 0) | (last ? kLast : 0),
                                 p.ty, p.tx, n_rows ? (pa | pb << 8 | p.px0 << 16) : 0, stride};
            if (n_rows) {
              mbar_arrive_expect(full + st, rec + n_rows * stride * kBinBytes);
            } else {
              mbar_arrive(full + st);                 // nothing to copy
            }
          }
          __syncwarp();
          if (n_rows) {
            if (lane == 0) bulk_copy(base, records + static_cast<size_t>(roi) * rec, rec, full + st);
            float* bins = reinterpret_cast<float*>(base + area);
            const int boxes = stride / kBoxBins;    // per row
            for (int i = lane; i < n_rows * boxes; i += 32) {
              const int r = i / boxes, b = i - r * boxes;
              box_copy(bins + (r * stride + b * kBoxBins) * kChunk, &g_map, c0,
                       p.px0 + b * kBoxBins, roi * s + pa + r, full + st);
            }
          }
        }
      }
      w = w_next;
      it = it_next;
    }
  }

  // the consumers
  constexpr int kVecs = kChunk / 4;                 // float4 per cell of the chunk
  constexpr int kSlots = kConsumers / kVecs;        // a thread's cells: slot, slot + 16, ...
  const int vec = threadIdx.x % kVecs;
  const int cslot = threadIdx.x / kVecs;
  float4 acc[kCellsPerThread];
  for (;;) {
    const int st = q % kStages;
    mbar_wait(full + st, (q / kStages) & 1);
    const Header h = headers[st];
    if (h.flags & kDone) return;
    if (h.flags & kFirst) {
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    const bool has_vec = vec < min(kChunk, channels - h.c0) / 4;
    const int pa = h.rows & 255, pb = (h.rows >> 8) & 255, px0 = h.rows >> 16;
    if (has_vec && pa < pb) {
      const unsigned char* base = ring + st * slot_size;
      const Tables tb = carve_tables(const_cast<unsigned char*>(base), s, win_y, win_x);
      const float* bins_v = reinterpret_cast<const float*>(base + area) + vec * 4;
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) {
        const int cell = cslot + k * kSlots;
        const int y = h.ty + cell / kTile;          // window-local
        const int x = h.tx + cell % kTile;
        if (y < 0 || y >= win_y || x < 0 || x >= win_x) continue;
        const int py_lo = max(tb.cell_lo[y], pa), py_hi = min(tb.cell_hi[y], pb - 1);
        const int px_lo = tb.cell_lo[win_y + x], px_hi = tb.cell_hi[win_y + x];
        if (py_hi < py_lo || px_hi < px_lo) continue;   // no bin of the piece touches it
        float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int py = py_lo; py <= py_hi; ++py) {
          const float a = tb.wy[py * win_y + y];
          const float* row = bins_v + ((py - pa) * h.stride - px0) * kChunk;
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int px = px_lo; px <= px_hi; ++px) {
            const float wv = tb.wx[px * win_x + x];
            const float4 v = *reinterpret_cast<const float4*>(row + px * kChunk);
            sum.x += wv * v.x;
            sum.y += wv * v.y;
            sum.z += wv * v.z;
            sum.w += wv * v.w;
          }
          part.x += a * sum.x;
          part.y += a * sum.y;
          part.z += a * sum.z;
          part.w += a * sum.w;
        }
        acc[k].x += part.x;                         // this piece after the ones before
        acc[k].y += part.y;
        acc[k].z += part.z;
        acc[k].w += part.w;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    ++q;
    if (!(h.flags & kLast) || !has_vec) continue;
    const TileAt at = tile_at(grads, num_levels, batch, h.tile);
    const int height = grads.h[at.lvl], width = grads.w[at.lvl];
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k) {
      const int cell = cslot + k * kSlots;
      const int y = at.y0 + cell / kTile;
      const int x = at.x0 + cell % kTile;
      if (h.slot >= 0) {
        *reinterpret_cast<float4*>(partials + (static_cast<size_t>(h.slot) * kTileCells + cell) *
                                                  channels + h.c0 + vec * 4) = acc[k];
      } else if (y < height && x < width) {
        float* level = static_cast<float*>(const_cast<void*>(grads.ptr[at.lvl]));
        *reinterpret_cast<float4*>(
            level + ((static_cast<size_t>(at.b) * height + y) * width + x) * channels + h.c0 +
            vec * 4) = acc[k];
      }
    }
  }
}

// The fold: per (tile cut into segments, chunk), the gradient cells segment
// 0 stored, plus the tile's partials in segment order, stored once.
__global__ void __launch_bounds__(kFoldThreads)
roi_align_ml_backward_fold_kernel(const __grid_constant__ LevelTable grads,
                                  int num_levels, int batch,
                                  const int4* __restrict__ folds,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ partials, int channels) {
  constexpr int kVecs = kChunk / 4;
  constexpr int kSlots = kFoldThreads / kVecs;
  const int chunks = (channels + kChunk - 1) / kChunk;
  const int n_work = counts[1] * chunks;
  const int vec = threadIdx.x % kVecs;
  const int cslot = threadIdx.x / kVecs;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int4 f = folds[w / chunks];               // tile, first slot, partials
    const int c0 = (w % chunks) * kChunk;
    if (vec >= min(kChunk, channels - c0) / 4) continue;
    const TileAt at = tile_at(grads, num_levels, batch, f.x);
    const int height = grads.h[at.lvl], width = grads.w[at.lvl];
    float* level = static_cast<float*>(const_cast<void*>(grads.ptr[at.lvl]));
    for (int cell = cslot; cell < kTileCells; cell += kSlots) {
      const int y = at.y0 + cell / kTile;
      const int x = at.x0 + cell % kTile;
      if (y >= height || x >= width) continue;
      float4* out = reinterpret_cast<float4*>(
          level + ((static_cast<size_t>(at.b) * height + y) * width + x) * channels + c0 +
          vec * 4);
      float4 acc = *out;
      for (int k = 0; k < f.z; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            partials + (static_cast<size_t>(f.y + k) * kTileCells + cell) * channels + c0 +
            vec * 4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *out = acc;
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
  return kPreambleBytes + kStages * slot_bytes(s, win_y, win_x);
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

long long count_tiles(const LevelTable& t, int num_levels, int batch) {
  long long tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    tiles += static_cast<long long>(batch) * tiles_of(t.h[l], t.w[l]);
  }
  return tiles;
}

cudaError_t launch_route(const PoolArgs& a, int batch, unsigned char* records, int4* spans,
                         long long* words) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_ml_backward_route_kernel;
  const int smem = table_bytes(a.s, a.win_y, a.win_x);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_rois, kPrepThreads, smem, a.stream>>>(a.levels, batch, a.roi_i, a.roi_f, a.s,
                                                      a.r, a.win_y, a.win_x, records, spans,
                                                      words);
  return cudaGetLastError();
}

// Blocks of a persistent grid: as many as stay resident on the device at
// once (per device, cached), at most work.
cudaError_t resident_blocks(const void* kernel, int threads, int smem, long long work,
                            int* cache, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (!cache[device]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    cache[device] = std::max(1, sms * per_sm);
  }
  *blocks = static_cast<int>(std::min<long long>(cache[device], std::max(1LL, work)));
  return cudaSuccess;
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

// The launches of the gradient of the forward w.r.t. the levels (one call
// of the wrapper, K3). Tiles have kTile x kTile cells of one level and image
// and are numbered by level, image, tile row and column; there are num_tiles
// of them (checked against the level dims). num_rois < 2^29.
//
// 1. u2seg_roi_align_ml_backward_route: per ROI its record
//    (u2seg_roi_align_ml_backward_layout gives the bytes; records 16-byte
//    aligned), its span in tiles (int4) and its slots of int64 list entries
//    (slots_of(win_y) * slots_of(win_x) per ROI). num_rois >= 1.
// 2. u2seg_roi_align_ml_backward_lists(fill = 0): tile_count (int32 per
//    tile), the ROIs that meet each tile.
// 3. u2seg_roi_align_ml_backward_plan: tile_start (num_tiles + 1 int32), the
//    work items (int4: tile, first list entry, ROIs, partial slot or -1), the
//    folds (int4: tile, first partial slot, partials, 0) and counts (int32:
//    items, folds).
// 4. u2seg_roi_align_ml_backward_lists(fill = 1): the tiles' lists (int64
//    entries from tile_start on, ROIs in ascending index).
// 5. u2seg_roi_align_ml_backward: the gather over the items (counts[2] its
//    work counter, zeroed first). grad_ptrs are
//    num_levels f32 buffers (batch, h_l, w_l, channels), 16-byte aligned,
//    every element of which is written (they need not be initialised); g is
//    the (num_rois, s, s, channels) f32 cotangent; partials the (slots, 64,
//    channels) f32 scratch of segments 1, 2, ... of the tiles cut into more
//    than one.
// 6. u2seg_roi_align_ml_backward_fold: adds each cut tile's partials into
//    the cells its segment 0 stored.
// Return a cudaError_t value.
extern "C" int u2seg_roi_align_ml_backward_route(
    const int* level_h, const int* level_w, int num_levels, int batch, const int* roi_i,
    const float* roi_f, int num_rois, int s, int r, int win_y, int win_x, void* records,
    void* spans, void* words, void* stream) {
  PoolArgs a = {};
  const int64_t no_ptrs[kMaxLevels] = {};       // the routing reads dims only
  if (!fill_levels(&a.levels, no_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      num_rois < 1 || num_rois >= (1 << (63 - kPairBits))) {
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
  return static_cast<int>(launch_route(a, batch, static_cast<unsigned char*>(records),
                                       static_cast<int4*>(spans),
                                       static_cast<long long*>(words)));
}

extern "C" int u2seg_roi_align_ml_backward_lists(
    int fill, const int* level_h, const int* level_w, int num_levels, int batch,
    int num_tiles, const void* spans, int num_rois, int win_y, int win_x, void* tile_count,
    const void* tile_start, const void* words, void* lists, void* stream) {
  LevelTable levels;
  const int64_t no_ptrs[kMaxLevels] = {};
  if (!fill_levels(&levels, no_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      num_rois < 0 || num_tiles < 1 || count_tiles(levels, num_levels, batch) != num_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fill ? roi_align_ml_backward_list_kernel<true>
                     : roi_align_ml_backward_list_kernel<false>;
  const int blocks = (num_tiles + kListTiles - 1) / kListTiles;
  kernel<<<blocks, kListThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, num_levels, batch, num_tiles, static_cast<const int4*>(spans), num_rois,
      slots_of(win_x), slots_of(win_y) * slots_of(win_x), static_cast<int*>(tile_count),
      static_cast<const int*>(tile_start), static_cast<const long long*>(words),
      static_cast<long long*>(lists));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int u2seg_roi_align_ml_backward_plan(const void* tile_count, int num_tiles,
                                                void* tile_start, void* items, void* folds,
                                                void* counts, void* stream) {
  static bool allowed[kMaxDevices] = {};
  if (num_tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = roi_align_ml_backward_plan_kernel;
  const int smem = ((kSegment + 1) * kPlanThreads + 32) * static_cast<int>(sizeof(int));
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kPlanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_count), num_tiles, static_cast<int*>(tile_start),
      static_cast<int4*>(items), static_cast<int4*>(folds), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The tensor map of the cotangent g (num_rois, s, s, channels) f32 for the
// gather's box copies: (R * s rows, s bins, channels), boxes of kChunk
// channels by kBoxBins bins of one row. cuTensorMapEncodeTiled is looked up
// through the runtime's entry-point query, so nothing links against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t cotangent_map(const float* g, int num_rois, int s, int channels, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  *map = CUtensorMap{};
  if (num_rois == 0) return cudaSuccess;             // no copy reads it
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(channels), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(num_rois) * s};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(channels) * sizeof(float),
                                 static_cast<cuuint64_t>(s) * channels * sizeof(float)};
  const cuuint32_t box[3] = {kChunk, kBoxBins, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(g),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

extern "C" int u2seg_roi_align_ml_backward(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w, int num_levels,
    int batch, const void* records, const float* g, const void* lists, const void* items,
    void* counts, void* partials, int max_items, int num_tiles, int num_rois, int channels,
    int s, int win_y, int win_x, void* stream) {
  static bool allowed[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  PoolArgs a = {};
  if (!fill_levels(&a.levels, grad_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      count_tiles(a.levels, num_levels, batch) != num_tiles || num_tiles < 1 ||
      max_items < num_tiles || num_rois < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.channels = channels;
  a.s = s;
  a.r = 1;
  a.win_y = win_y;
  a.win_x = win_x;
  a.threads = kThreads;
  if (!span_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = roi_align_ml_backward_kernel;
  const int smem = backward_smem_bytes(s, win_y, win_x);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (channels + kChunk - 1) / kChunk;
  int blocks = 0;
  err = resident_blocks(reinterpret_cast<const void*>(kernel), kGatherThreads, smem,
                        static_cast<long long>(max_items) * chunks, resident, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap g_map;
  err = cotangent_map(g, num_rois, s, channels, &g_map);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(static_cast<int*>(counts) + 2, 0, sizeof(int),
                        static_cast<cudaStream_t>(stream));     // the work counter
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kGatherThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a.levels, num_levels, batch, static_cast<const unsigned char*>(records), g_map,
      static_cast<const long long*>(lists), static_cast<const int4*>(items),
      static_cast<int*>(counts), static_cast<float*>(partials), channels, s, win_y, win_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int u2seg_roi_align_ml_backward_fold(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w, int num_levels,
    int batch, const void* folds, const void* counts, const void* partials, int max_folds,
    int num_tiles, int channels, void* stream) {
  static int resident[kMaxDevices] = {};
  LevelTable levels;
  if (!fill_levels(&levels, grad_ptrs, level_h, level_w, num_levels) || batch < 1 ||
      count_tiles(levels, num_levels, batch) != num_tiles || channels < 8 ||
      channels % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_folds < 1) return static_cast<int>(cudaSuccess);
  auto kernel = roi_align_ml_backward_fold_kernel;
  int blocks = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), kFoldThreads, 0,
                                    static_cast<long long>(max_folds) *
                                        ((channels + kChunk - 1) / kChunk),
                                    resident, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, num_levels, batch, static_cast<const int4*>(folds),
      static_cast<const int*>(counts), static_cast<const float*>(partials), channels);
  return static_cast<int>(cudaGetLastError());
}

// The backward's layout: out[0] the tile side in cells, out[1] the key slots
// per ROI, out[2] the bytes of a ROI's record, out[3] the ROIs of a segment,
// out[4] the ring's slots, out[5] the bins a slot holds, out[6] a list
// entry's pair bits.
extern "C" void u2seg_roi_align_ml_backward_layout(int s, int win_y, int win_x, int* out) {
  out[0] = kTile;
  out[1] = slots_of(win_y) * slots_of(win_x);
  out[2] = record_bytes(s, win_y, win_x);
  out[3] = kSegment;
  out[4] = kStages;
  out[5] = slot_bins(s, win_y, win_x);
  out[6] = kPairBits;
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
