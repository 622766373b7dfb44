// Multilevel FPN ROIAlign for Hopper (sm_90a): the forward and its gradient
// w.r.t. the levels, each in two designs: the span kernels that the port
// launches, and the first kernels (suffix _v1), kept only as the yardstick the
// span kernels are timed against (python3 chip_smoke.py --phases k1,k3).
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
//   grad[lvl(roi)][b(roi), y, x, c] += wy * wx * g[roi, py, px, c]
// into zero-initialised f32 gradient levels at their true dims (the launcher
// zeroes them).
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
// THE SPAN DESIGN (both kernels)
//
// Dense per-axis pooled weights. For one ROI
//   out[py, px, c] = sum_y sum_x Wy[py, y] * Wx[px, x] * F[y, x, c],
// where Wy (s x win_y) and Wx (s x win_x) hold the bilinear tap weights with
// the r-sample mean folded in, indexed by window cell: the streamed-weight
// form of the TPU's K1 (_pooled_axis_weights_host). The backward is its
// transpose. Every block builds both tables once in shared memory from the
// tap arithmetic below (same f32 op order as the v1 tap tables; taps outside
// the true level dims or the window weigh 0; samples clipped onto one edge
// cell add up there), with, per bin, the first and last cell of non-zero
// weight. Every such cell lies inside the window AND inside the true level
// dims, so the ROI's span (the box of all of them) is at most win_y x win_x
// cells and is read or written without a bounds test.
//
// Work split: one block per (ROI, chunk of kChunk = 64 channels), so one cell
// of a chunk is 128-256 contiguous bytes and every global access is a 16-byte
// vector with neighbouring threads on neighbouring addresses. Levels are NHWC
// and C-contiguous; C is a multiple of 8 and all storage 16-byte aligned (the
// wrapper checks). The last chunk may be ragged (C % 64 != 0).
//
// Forward. The block walks the output rows in groups: as many consecutive bin
// rows as have their level rows fit the block's stage buffer (a launch
// parameter; the wrapper picks 24 KB with 128 threads for 7 x 7 outputs and
// 48 KB with 256 threads for 14 x 14, by measurement). At 64 bf16 channels 24
// KB hold 192 cells: all 7 rows of a 13 x 13 span go in one group, a 30 x 30
// span takes 5. It copies the group's rows of the span into shared memory once
// with 16-byte cp.async, then each thread owns 8 channels of one output
// value: for each row y of its bin it sums Wx[px, x] * F[y, x] over the bin's
// columns in registers (x pass), adds Wy[py, y] times that (y pass), and
// writes the value once with 16-byte stores in the output dtype. The buffer
// has a fixed size so that no launch waits on a device-to-host read and 8
// (7 x 7) or 4 (14 x 14) blocks stay resident per SM; sizing it for the whole
// 32 x 40 window (160 KB) would leave one. A single bin whose rows do not fit (a bin more than ~5
// cells high under a full-width span: boxes of thousands of pixels on the
// virtual level) reads its cells from global memory with the same arithmetic.
// One block per (ROI, chunk) rebuilds the tables in every chunk's block; an
// early build with one block per ROI looping over its chunks was slower (no
// reading of it was kept), so the wide grid stays.
//
// Backward. The block copies the ROI's cotangent tile g[:, :, chunk] (s x s x
// chunk f32) into shared memory with 16-byte cp.async while it builds the
// tables, then each thread owns 4 channels of one span cell (y, x): it sums
// Wx[px, x] * g[py, px] over the bins that touch column x, Wy[py, y] times
// that over the bins that touch row y, and makes ONE 16-byte
// atomicAdd(float4*) into the gradient level. Cells no bin touches add
// nothing. A two-pass form that keeps the intermediate t[y, px, c] in shared
// memory was not built or measured: sized for the worst span (win_y x s x 64
// f32) it would at least double the block's shared memory, and a cell is
// touched by only 2-3 bins per axis. Atomic adds land in an order that
// changes from run to run, so two runs differ in the last bits.
//
// Bound on this card: bytes, for both. The forward moves s*s*C output values
// and the distinct level cells it touches per ROI, for ~2 * 12 flops per
// output value; the backward reads g once and must write every gradient cell
// once (the zero fill). What the span design pays above the bound. Forward:
// the spans of neighbouring ROIs overlap, so the blocks read ~3x the distinct
// cells (from L2 for the most part), and each 8-channel output value costs
// some 300 instructions (per tap one 16-byte shared load, 8 bf16 unpacks, 8
// FMAs) in small blocks that run tables, copy and compute one after another.
// Backward: one 16-byte atomic per (span cell, 4 channels) is still a
// read-modify-write in L2 (chip_smoke.py prints their count), after a zero
// fill that alone costs most of the bound.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;       // s * r along one axis
constexpr int kThreadsV1 = 128;       // v1: channel pairs per block
constexpr int kThreads = 256;         // span kernels: largest block (the backward's)
constexpr int kChunk = 64;            // span kernels: channels per block
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kMaxDynamicSmem = 232448;   // 227 KB, the most a block can opt in to
constexpr int kMaxDevices = 64;

// Passed by value. The span kernels take it as a __grid_constant__ parameter:
// indexing a plain by-value struct with the ROI's level makes every thread
// copy all 128 bytes to its stack first (the v1 kernels still do).
struct LevelTable {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// ---------------------------------------------------------------------------
// Tap arithmetic, shared by every kernel of this file
// ---------------------------------------------------------------------------

struct AxisGeom {
  float c0, bin, size, win_last;
  int origin, dim;
};

__device__ __forceinline__ AxisGeom axis_geom(
    const int* __restrict__ roi_i, const float* __restrict__ roi_f, int roi,
    int axis, int height, int width, int win_y, int win_x) {
  AxisGeom a;
  a.c0 = roi_f[roi * 4 + axis];
  a.bin = roi_f[roi * 4 + 2 + axis];
  a.origin = roi_i[roi * 4 + 1 + axis];
  a.dim = axis ? width : height;
  a.size = static_cast<float>(a.dim);
  a.win_last = static_cast<float>((axis ? win_x : win_y) - 1);
  return a;
}

// Window-local coordinate of sample i (of s * r) along one axis, clamped into
// the level and then into the window. Returns whether the sample lies inside
// the level at all.
__device__ __forceinline__ bool sample_local(const AxisGeom& a, int i, int r,
                                             float* local) {
  const float rel = static_cast<float>(i / r) +
                    (static_cast<float>(i % r) + 0.5f) / static_cast<float>(r);
  const float coord = a.c0 + rel * a.bin;
  const float cc = fminf(fmaxf(coord, 0.0f), a.size - 1.0f);
  *local = fminf(fmaxf(cc - static_cast<float>(a.origin), 0.0f), a.win_last);
  return coord >= -1.0f && coord <= a.size;
}

// Tap k (0 or 1) of a sample: its window-local cell and its bilinear weight
// with the 1/r mean folded in; 0 for a tap outside the window or the true
// level dims.
__device__ __forceinline__ float tap_weight(const AxisGeom& a, float local,
                                            bool inside, int k, int r,
                                            int* cell_local) {
  const float t = floorf(local) + static_cast<float>(k);
  *cell_local = static_cast<int>(t);
  const float w = fmaxf(0.0f, 1.0f - fabsf(local - t));
  const bool ok = inside && t <= a.win_last && a.origin + *cell_local < a.dim;
  return ok ? w / static_cast<float>(r) : 0.0f;
}

// ---------------------------------------------------------------------------
// Dense pooled weights of one ROI in shared memory (span kernels)
// ---------------------------------------------------------------------------

struct Tables {
  float* wy;      // (s, win_y): Wy[py, y], window-local y
  float* wx;      // (s, win_x), directly behind wy
  int* bin_lo;    // (2, s): first window cell of non-zero weight per bin; win if none
  int* bin_hi;    // (2, s): last such cell; -1 if none
  int* cell_lo;   // (win_y + win_x): first bin that touches the cell (backward)
  int* cell_hi;   // last such bin; -1 if none
};

__host__ __device__ constexpr int table_bytes(int s, int win_y, int win_x) {
  return 4 * (s * (win_y + win_x) + 4 * s + 2 * (win_y + win_x));
}

__device__ __forceinline__ Tables carve_tables(unsigned char* p, int s,
                                               int win_y, int win_x) {
  Tables t;
  t.wy = reinterpret_cast<float*>(p);
  t.wx = t.wy + s * win_y;
  t.bin_lo = reinterpret_cast<int*>(t.wx + s * win_x);
  t.bin_hi = t.bin_lo + 2 * s;
  t.cell_lo = t.bin_hi + 2 * s;
  t.cell_hi = t.cell_lo + win_y + win_x;
  return t;
}

// Fills wy, wx, bin_lo, bin_hi: one thread per (axis, bin) adds the bin's 2r
// taps into its row, so no two threads write one entry. Needs blockDim.x >=
// 2 * s. Ends with a __syncthreads().
__device__ __forceinline__ void build_dense(
    const Tables& tb, const int* __restrict__ roi_i,
    const float* __restrict__ roi_f, int roi, int height, int width, int s,
    int r, int win_y, int win_x) {
  const int n_w = s * (win_y + win_x);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) tb.wy[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x < 2 * s) {
    const int axis = threadIdx.x / s;   // 0: y, 1: x
    const int bin = threadIdx.x - axis * s;
    const AxisGeom a = axis_geom(roi_i, roi_f, roi, axis, height, width, win_y, win_x);
    const int win = axis ? win_x : win_y;
    float* row = (axis ? tb.wx : tb.wy) + bin * win;
    int lo = win, hi = -1;
    for (int i = bin * r; i < bin * r + r; ++i) {
      float local;
      const bool inside = sample_local(a, i, r, &local);
      for (int k = 0; k < 2; ++k) {
        int cell;
        const float w = tap_weight(a, local, inside, k, r, &cell);
        if (w > 0.0f) {
          row[cell] += w;
          lo = min(lo, cell);
          hi = max(hi, cell);
        }
      }
    }
    tb.bin_lo[threadIdx.x] = lo;
    tb.bin_hi[threadIdx.x] = hi;
  }
  __syncthreads();
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

struct Span {   // window-local, inclusive; lo > hi when no cell has weight
  int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ Span span_of(const Tables& tb, int s, int win_y,
                                        int win_x) {
  Span sp = {win_y, -1, win_x, -1};
  for (int b = 0; b < s; ++b) {
    sp.y_lo = min(sp.y_lo, tb.bin_lo[b]);
    sp.y_hi = max(sp.y_hi, tb.bin_hi[b]);
    sp.x_lo = min(sp.x_lo, tb.bin_lo[s + b]);
    sp.x_hi = max(sp.x_hi, tb.bin_hi[s + b]);
  }
  return sp;
}

// ---------------------------------------------------------------------------
// 8-channel loads and stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // bf16 is the upper half of an f32
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                            pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// ---------------------------------------------------------------------------
// FORWARD, span design
// ---------------------------------------------------------------------------

// acc += sum_y wy[y] * (sum_x wx[x] * cells[y, x]) over the bin's rows and
// columns (window-local, inclusive). cells points at the 8 channels of cell
// (y_base, x_base); rows are row_pitch and cells cell_pitch elements apart
// (a window of a level is far below 2^31 elements).
template <typename Tin>
__device__ __forceinline__ void accumulate(
    float acc[8], const Tin* cells, int row_pitch, int cell_pitch, int y_base,
    int x_base, const float* wy, const float* wx, int y_lo, int y_hi, int x_lo,
    int x_hi) {
  const Tin* row = cells + (y_lo - y_base) * row_pitch + (x_lo - x_base) * cell_pitch;
  for (int y = y_lo; y <= y_hi; ++y, row += row_pitch) {
    float sum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const Tin* cell = row;
    for (int x = x_lo; x <= x_hi; ++x, cell += cell_pitch) {
      const float b = wx[x];
      float v[8];
      load8(cell, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[j] += b * v[j];
    }
    const float a = wy[y];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += a * sum[j];
  }
}

// floor(n / d) for 0 <= n < 2^16, 1 <= d < 2^16, with inv = inverse_of(d):
// ceil(2^32 / d), which is 2^32 itself for d = 1 and kept as 0.
__device__ __forceinline__ unsigned int inverse_of(int d) {
  return d == 1 ? 0u : 0xffffffffu / static_cast<unsigned int>(d) + 1u;
}
__device__ __forceinline__ int fast_div(int n, unsigned int inv) {
  return inv ? static_cast<int>(__umulhi(static_cast<unsigned int>(n), inv)) : n;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
roi_align_ml_kernel(const __grid_constant__ LevelTable levels,
                    const int* __restrict__ roi_i,    // (R, 4): lvl, oy, ox, b
                    const float* __restrict__ roi_f,  // (R, 4): y0, x0, bin_h, bin_w
                    Tout* __restrict__ out,           // (R, s, s, C)
                    int channels, int s, int r, int win_y, int win_x,
                    int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVecElems = 16 / sizeof(Tin);       // elements per 16-byte vector
  constexpr int kVecs = kChunk / kVecElems;         // vectors per staged cell
  constexpr int kUnits = kChunk / 8;                // 8-channel output units per cell
  Tin* stage = reinterpret_cast<Tin*>(smem);        // [row][x][kChunk]
  const Tables tb = carve_tables(smem + stage_bytes, s, win_y, win_x);

  const int roi = blockIdx.x;
  const int lvl = roi_i[roi * 4 + 0];
  const int oy = roi_i[roi * 4 + 1];
  const int ox = roi_i[roi * 4 + 2];
  const int b = roi_i[roi * 4 + 3];
  const int height = levels.h[lvl];
  const int width = levels.w[lvl];
  build_dense(tb, roi_i, roi_f, roi, height, width, s, r, win_y, win_x);
  const Span sp = span_of(tb, s, win_y, win_x);
  const bool empty = sp.y_hi < sp.y_lo || sp.x_hi < sp.x_lo;   // no cell has weight

  const int unit = threadIdx.x % kUnits;
  const int slot = threadIdx.x / kUnits;
  const int slots = blockDim.x / kUnits;
  const int vec = threadIdx.x % kVecs;
  const int vslot = threadIdx.x / kVecs;
  const int vslots = blockDim.x / kVecs;
  const int span_x = empty ? 1 : sp.x_hi - sp.x_lo + 1;
  const int rows_cap = stage_bytes / (kChunk * static_cast<int>(sizeof(Tin))) / span_x;
  const unsigned int inv_span_x = inverse_of(span_x);
  const unsigned int inv_s = inverse_of(s);
  const int row_elems = width * channels;           // a level row; < 2^31 elements
  // cell (window row 0, span column 0), channel 0
  const Tin* level0 = static_cast<const Tin*>(levels.ptr[lvl]) +
                      (static_cast<size_t>(b) * height + oy) * row_elems +
                      static_cast<size_t>(ox + sp.x_lo) * channels;

  const int c0 = blockIdx.y * kChunk;
  const int cn = min(kChunk, channels - c0);        // ragged last chunk
  const bool has_unit = unit < cn / 8;
  const bool has_vec = vec < cn / kVecElems;
  const Tin* level = level0 + c0;
  Tout* out_roi = out + static_cast<size_t>(roi) * s * s * channels + c0 + unit * 8;
  if (empty) {
    const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int o = slot; o < s * s && has_unit; o += slots) {
      store8(out_roi + static_cast<size_t>(o) * channels, zero);
    }
    return;
  }
  int py = 0;
  while (py < s) {
    // the group: bin rows [py, pe) whose level rows [lo, hi] fit the buffer
    int lo = win_y, hi = -1, pe = py;
    while (pe < s) {
      const int nlo = min(lo, tb.bin_lo[pe]);
      const int nhi = max(hi, tb.bin_hi[pe]);
      if (pe > py && nhi - nlo + 1 > rows_cap) break;
      lo = nlo;
      hi = nhi;
      ++pe;
    }
    const bool staged = hi - lo + 1 <= rows_cap;    // false: one bin taller than the buffer
    if (staged && hi >= lo) {
      const int n_cells = (hi - lo + 1) * span_x;
      for (int cell = vslot; cell < n_cells && has_vec; cell += vslots) {
        const int yr = fast_div(cell, inv_span_x);
        const int xr = cell - yr * span_x;
        __pipeline_memcpy_async(
            stage + cell * kChunk + vec * kVecElems,
            level + (lo + yr) * row_elems + xr * channels + vec * kVecElems, 16);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int n_out = (pe - py) * s;
    for (int o = slot; o < n_out && has_unit; o += slots) {
      const int row_o = fast_div(o, inv_s);
      const int bin_y = py + row_o;
      const int bin_x = o - row_o * s;
      const float* wy = tb.wy + bin_y * win_y;
      const float* wx = tb.wx + bin_x * win_x;
      const int y_lo = tb.bin_lo[bin_y], y_hi = tb.bin_hi[bin_y];
      const int x_lo = tb.bin_lo[s + bin_x], x_hi = tb.bin_hi[s + bin_x];
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (staged) {
        accumulate(acc, stage + unit * 8, span_x * kChunk, kChunk, lo, sp.x_lo, wy,
                   wx, y_lo, y_hi, x_lo, x_hi);
      } else {
        accumulate(acc, level + unit * 8, row_elems, channels, 0, sp.x_lo, wy, wx,
                   y_lo, y_hi, x_lo, x_hi);
      }
      store8(out_roi + (static_cast<size_t>(bin_y) * s + bin_x) * channels, acc);
    }
    __syncthreads();   // the next group's copies overwrite the buffer
    py = pe;
  }
}

// ---------------------------------------------------------------------------
// BACKWARD, span design
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
roi_align_ml_backward_kernel(const __grid_constant__ LevelTable grads,   // f32, zeroed
                             const int* __restrict__ roi_i,
                             const float* __restrict__ roi_f,
                             const float* __restrict__ g,   // (R, s, s, C)
                             int channels, int s, int r, int win_y, int win_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVecs = kChunk / 4;                 // float4 per cell of the chunk
  float* tile = reinterpret_cast<float*>(smem);     // g[roi, :, :, chunk]: [s*s][kChunk]
  const Tables tb = carve_tables(
      smem + static_cast<size_t>(s) * s * kChunk * sizeof(float), s, win_y, win_x);

  const int roi = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int cn = min(kChunk, channels - c0);
  const int vec = threadIdx.x % kVecs;
  const int slot = threadIdx.x / kVecs;
  const int slots = blockDim.x / kVecs;
  const bool has_vec = vec < cn / 4;

  // the cotangent tile does not depend on the tables: start its copy first
  const float* g_roi = g + static_cast<size_t>(roi) * s * s * channels + c0 + vec * 4;
  for (int cell = slot; cell < s * s && has_vec; cell += slots) {
    __pipeline_memcpy_async(tile + cell * kChunk + vec * 4,
                            g_roi + static_cast<size_t>(cell) * channels, 16);
  }
  __pipeline_commit();

  const int lvl = roi_i[roi * 4 + 0];
  const int oy = roi_i[roi * 4 + 1];
  const int ox = roi_i[roi * 4 + 2];
  const int b = roi_i[roi * 4 + 3];
  const int height = grads.h[lvl];
  const int width = grads.w[lvl];
  build_dense(tb, roi_i, roi_f, roi, height, width, s, r, win_y, win_x);
  build_cell_ranges(tb, s, win_y, win_x);
  __pipeline_wait_prior(0);
  __syncthreads();

  const Span sp = span_of(tb, s, win_y, win_x);
  if (sp.y_hi < sp.y_lo || sp.x_hi < sp.x_lo || !has_vec) return;
  const int span_x = sp.x_hi - sp.x_lo + 1;
  const int n_cells = (sp.y_hi - sp.y_lo + 1) * span_x;
  const unsigned int inv_span_x = inverse_of(span_x);
  const size_t row_stride = static_cast<size_t>(width) * channels;
  const int row_elems = width * channels;           // a level row; < 2^31 elements
  float* level = static_cast<float*>(const_cast<void*>(grads.ptr[lvl])) +
                 (static_cast<size_t>(b) * height + oy + sp.y_lo) * row_stride +
                 static_cast<size_t>(ox + sp.x_lo) * channels + c0 + vec * 4;
  const float* tile_v = tile + vec * 4;
  for (int cell = slot; cell < n_cells; cell += slots) {
    const int yr = fast_div(cell, inv_span_x);
    const int xr = cell - yr * span_x;
    const int y = sp.y_lo + yr;
    const int x = sp.x_lo + xr;
    const int py_lo = tb.cell_lo[y], py_hi = tb.cell_hi[y];
    const int px_lo = tb.cell_lo[win_y + x], px_hi = tb.cell_hi[win_y + x];
    if (py_hi < py_lo || px_hi < px_lo) continue;   // no bin touches this cell
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int py = py_lo; py <= py_hi; ++py) {
      const float a = tb.wy[py * win_y + y];
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int px = px_lo; px <= px_hi; ++px) {
        const float w = tb.wx[px * win_x + x];
        const float4 v = *reinterpret_cast<const float4*>(tile_v + (py * s + px) * kChunk);
        sum.x += w * v.x;
        sum.y += w * v.y;
        sum.z += w * v.z;
        sum.w += w * v.w;
      }
      acc.x += a * sum.x;
      acc.y += a * sum.y;
      acc.z += a * sum.z;
      acc.w += a * sum.w;
    }
    atomicAdd(reinterpret_cast<float4*>(level + yr * row_elems + xr * channels), acc);
  }
}

// ---------------------------------------------------------------------------
// The first kernels (v1): one block per (ROI, output row), a thread per
// channel pair, per-sample tap tables, 4- or 8-byte loads of every tap from
// L1/L2 in the forward and one 8-byte atomic per non-zero tap in the
// backward. Timed beside the span kernels; nothing else launches them.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Per-axis tap tables of one ROI in shared memory: for each of the s*r sample
// coordinates along y (axis 0) and x (axis 1), the two level cells it reads
// and their weights. A tap of weight 0 gets cell 0. Ends with a
// __syncthreads().
__device__ __forceinline__ void build_taps(
    int (*tap_cell)[kMaxSamples][2], float (*tap_w)[kMaxSamples][2],
    const int* __restrict__ roi_i, const float* __restrict__ roi_f, int roi,
    int height, int width, int s, int r, int win_y, int win_x) {
  const int n = s * r;
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
    const int axis = t / n;  // 0: y, 1: x
    const int i = t - axis * n;
    const AxisGeom a = axis_geom(roi_i, roi_f, roi, axis, height, width, win_y, win_x);
    float local;
    const bool inside = sample_local(a, i, r, &local);
    for (int k = 0; k < 2; ++k) {
      int cell;
      const float w = tap_weight(a, local, inside, k, r, &cell);
      tap_cell[axis][i][k] = w != 0.0f ? a.origin + cell : 0;
      tap_w[axis][i][k] = w;
    }
  }
  __syncthreads();
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreadsV1)
roi_align_ml_kernel_v1(LevelTable levels, const int* __restrict__ roi_i,
                       const float* __restrict__ roi_f, Tout* __restrict__ out,
                       int channels, int s, int r, int win_y, int win_x) {
  __shared__ int tap_cell[2][kMaxSamples][2];   // [axis][sample][tap]
  __shared__ float tap_w[2][kMaxSamples][2];

  const int roi = blockIdx.x;
  const int py = blockIdx.z;
  const int lvl = roi_i[roi * 4 + 0];
  const int b = roi_i[roi * 4 + 3];
  const int height = levels.h[lvl];
  const int width = levels.w[lvl];

  build_taps(tap_cell, tap_w, roi_i, roi_f, roi, height, width, s, r, win_y, win_x);

  const size_t row_stride = static_cast<size_t>(width) * channels;
  const Tin* base = static_cast<const Tin*>(levels.ptr[lvl]) +
                    static_cast<size_t>(b) * height * row_stride;
  const int pairs = channels / 2;
  for (int cp = blockIdx.y * blockDim.x + threadIdx.x; cp < pairs;
       cp += gridDim.y * blockDim.x) {
    const int c = 2 * cp;
    for (int px = 0; px < s; ++px) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int sy = 0; sy < r; ++sy) {
        const int iy = py * r + sy;
        for (int ty = 0; ty < 2; ++ty) {
          const float wy = tap_w[0][iy][ty];
          if (wy == 0.0f) continue;
          const Tin* row = base + tap_cell[0][iy][ty] * row_stride + c;
          for (int sx = 0; sx < r; ++sx) {
            const int ix = px * r + sx;
            for (int tx = 0; tx < 2; ++tx) {
              const float wx = tap_w[1][ix][tx];
              if (wx == 0.0f) continue;
              const float2 v = load2(row + static_cast<size_t>(tap_cell[1][ix][tx]) * channels);
              const float wgt = wy * wx;
              a0 += wgt * v.x;
              a1 += wgt * v.y;
            }
          }
        }
      }
      store2(out + ((static_cast<size_t>(roi) * s + py) * s + px) * channels + c, a0, a1);
    }
  }
}

__global__ void __launch_bounds__(kThreadsV1)
roi_align_ml_backward_kernel_v1(LevelTable grads,   // f32, zero-initialised
                                const int* __restrict__ roi_i,
                                const float* __restrict__ roi_f,
                                const float* __restrict__ g,   // (R, s, s, C)
                                int channels, int s, int r, int win_y, int win_x) {
  __shared__ int tap_cell[2][kMaxSamples][2];
  __shared__ float tap_w[2][kMaxSamples][2];

  const int roi = blockIdx.x;
  const int py = blockIdx.z;
  const int lvl = roi_i[roi * 4 + 0];
  const int b = roi_i[roi * 4 + 3];
  const int height = grads.h[lvl];
  const int width = grads.w[lvl];
  build_taps(tap_cell, tap_w, roi_i, roi_f, roi, height, width, s, r, win_y, win_x);

  const size_t row_stride = static_cast<size_t>(width) * channels;
  float* base = static_cast<float*>(const_cast<void*>(grads.ptr[lvl])) +
                static_cast<size_t>(b) * height * row_stride;
  const int pairs = channels / 2;
  for (int cp = blockIdx.y * blockDim.x + threadIdx.x; cp < pairs;
       cp += gridDim.y * blockDim.x) {
    const int c = 2 * cp;
    for (int px = 0; px < s; ++px) {
      const float2 gv = load2(g + ((static_cast<size_t>(roi) * s + py) * s + px) * channels + c);
      for (int sy = 0; sy < r; ++sy) {
        const int iy = py * r + sy;
        for (int ty = 0; ty < 2; ++ty) {
          const float wy = tap_w[0][iy][ty];
          if (wy == 0.0f) continue;
          float* row = base + tap_cell[0][iy][ty] * row_stride + c;
          for (int sx = 0; sx < r; ++sx) {
            const int ix = px * r + sx;
            for (int tx = 0; tx < 2; ++tx) {
              const float wx = tap_w[1][ix][tx];
              if (wx == 0.0f) continue;
              const float wgt = wy * wx;
              atomicAdd(reinterpret_cast<float2*>(
                            row + static_cast<size_t>(tap_cell[1][ix][tx]) * channels),
                        make_float2(wgt * gv.x, wgt * gv.y));
            }
          }
        }
      }
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

// Dynamic shared memory above 48 KB has to be allowed per kernel and device;
// done is the calling instantiation's own flag array, so it is set once.
cudaError_t allow_dynamic_smem(const void* kernel, int bytes, bool* done) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  if (bytes > kMaxDynamicSmem) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (!done[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

int forward_smem_bytes(int s, int win_y, int win_x, int stage_bytes) {
  return stage_bytes + table_bytes(s, win_y, win_x);
}

int backward_smem_bytes(int s, int win_y, int win_x) {
  return s * s * kChunk * static_cast<int>(sizeof(float)) + table_bytes(s, win_y, win_x);
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

cudaError_t launch_backward(const PoolArgs& a, const float* g) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_ml_backward_kernel;
  const int smem = backward_smem_bytes(a.s, a.win_y, a.win_x);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(a.num_rois, (a.channels + kChunk - 1) / kChunk);
  kernel<<<grid, a.threads, smem, a.stream>>>(
      a.levels, a.roi_i, a.roi_f, g, a.channels, a.s, a.r, a.win_y, a.win_x);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_forward_v1(const PoolArgs& a, void* out) {
  const int pairs = a.channels / 2;
  dim3 grid(a.num_rois, (pairs + kThreadsV1 - 1) / kThreadsV1, a.s);
  roi_align_ml_kernel_v1<Tin, Tout><<<grid, kThreadsV1, 0, a.stream>>>(
      a.levels, a.roi_i, a.roi_f, static_cast<Tout*>(out), a.channels, a.s, a.r,
      a.win_y, a.win_x);
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

// Zeroes the f32 gradient levels on the stream.
cudaError_t zero_levels(const LevelTable& t, int num_levels, int batch, int channels,
                        cudaStream_t stream) {
  for (int l = 0; l < num_levels; ++l) {
    const size_t bytes = static_cast<size_t>(batch) * t.h[l] * t.w[l] * channels *
                         sizeof(float);
    if (bytes == 0) continue;
    cudaError_t err = cudaMemsetAsync(const_cast<void*>(t.ptr[l]), 0, bytes, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// version 0: the span kernel; 1: the v1 kernel (threads and stage_bytes unused).
int forward_any(int version, const int64_t* level_ptrs, const int* level_h,
                const int* level_w, int num_levels, const int* roi_i,
                const float* roi_f, void* out, int num_rois, int channels, int s,
                int r, int win_y, int win_x, int dtype_in, int dtype_out,
                int threads, int stage_bytes, void* stream) {
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
  const bool ok = version == 0
                      ? span_args_ok(a)
                      : (s >= 1 && r >= 1 && s * r <= kMaxSamples && channels >= 2 &&
                         channels % 2 == 0 && s <= 65535);
  if (!ok || dtype_in < 0 || dtype_in > 1 || dtype_out < 0 || dtype_out > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  if (version == 0) {
    if (dtype_in == 0 && dtype_out == 0) {
      err = launch_forward<float, float>(a, out);
    } else if (dtype_in == 0) {
      err = launch_forward<float, __nv_bfloat16>(a, out);
    } else if (dtype_out == 0) {
      err = launch_forward<__nv_bfloat16, float>(a, out);
    } else {
      err = launch_forward<__nv_bfloat16, __nv_bfloat16>(a, out);
    }
  } else {
    if (dtype_in == 0 && dtype_out == 0) {
      err = launch_forward_v1<float, float>(a, out);
    } else if (dtype_in == 0) {
      err = launch_forward_v1<float, __nv_bfloat16>(a, out);
    } else if (dtype_out == 0) {
      err = launch_forward_v1<__nv_bfloat16, float>(a, out);
    } else {
      err = launch_forward_v1<__nv_bfloat16, __nv_bfloat16>(a, out);
    }
  }
  return static_cast<int>(err);
}

int backward_any(int version, const int64_t* grad_ptrs, const int* level_h,
                 const int* level_w, int num_levels, int batch, const int* roi_i,
                 const float* roi_f, const float* g, int num_rois, int channels,
                 int s, int r, int win_y, int win_x, void* stream) {
  PoolArgs a = {};
  if (!fill_levels(&a.levels, grad_ptrs, level_h, level_w, num_levels) || batch < 1) {
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
  a.threads = kThreads;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool ok = version == 0
                      ? span_args_ok(a)
                      : (s >= 1 && r >= 1 && s * r <= kMaxSamples && channels >= 2 &&
                         channels % 2 == 0 && s <= 65535);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = zero_levels(a.levels, num_levels, batch, channels, a.stream);
  if (err != cudaSuccess || num_rois == 0) return static_cast<int>(err);
  if (version == 0) {
    err = launch_backward(a, g);
  } else {
    const int pairs = channels / 2;
    dim3 grid(num_rois, (pairs + kThreadsV1 - 1) / kThreadsV1, s);
    roi_align_ml_backward_kernel_v1<<<grid, kThreadsV1, 0, a.stream>>>(
        a.levels, roi_i, roi_f, g, channels, s, r, win_y, win_x);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
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
  return forward_any(0, level_ptrs, level_h, level_w, num_levels, roi_i, roi_f, out,
                     num_rois, channels, s, r, win_y, win_x, dtype_in, dtype_out,
                     threads, stage_bytes, stream);
}

// Gradient of the forward w.r.t. the levels. grad_ptrs are num_levels f32
// buffers (batch, h_l, w_l, channels), 16-byte aligned; they need not be
// initialised: this call zeroes them on the stream, then accumulates.
// g is the (num_rois, s, s, channels) f32 cotangent. Returns a cudaError_t.
extern "C" int u2seg_roi_align_ml_backward(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w,
    int num_levels, int batch, const int* roi_i, const float* roi_f,
    const float* g, int num_rois, int channels, int s, int r, int win_y,
    int win_x, void* stream) {
  return backward_any(0, grad_ptrs, level_h, level_w, num_levels, batch, roi_i,
                      roi_f, g, num_rois, channels, s, r, win_y, win_x, stream);
}

// The v1 kernels, for timing beside the span kernels (even channels, 8-byte
// aligned storage).
extern "C" int u2seg_roi_align_ml_forward_v1(
    const int64_t* level_ptrs, const int* level_h, const int* level_w,
    int num_levels, const int* roi_i, const float* roi_f, void* out,
    int num_rois, int channels, int s, int r, int win_y, int win_x,
    int dtype_in, int dtype_out, void* stream) {
  return forward_any(1, level_ptrs, level_h, level_w, num_levels, roi_i, roi_f, out,
                     num_rois, channels, s, r, win_y, win_x, dtype_in, dtype_out, 0,
                     0, stream);
}

extern "C" int u2seg_roi_align_ml_backward_v1(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w,
    int num_levels, int batch, const int* roi_i, const float* roi_f,
    const float* g, int num_rois, int channels, int s, int r, int win_y,
    int win_x, void* stream) {
  return backward_any(1, grad_ptrs, level_h, level_w, num_levels, batch, roi_i,
                      roi_f, g, num_rois, channels, s, r, win_y, win_x, stream);
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
