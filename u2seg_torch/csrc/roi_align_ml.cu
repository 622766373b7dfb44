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
// THE SPAN DESIGN (both kernels; span_common.cuh has the parts they share)
//
// Dense per-axis pooled weights, the streamed-weight form of the TPU's K1
// (_pooled_axis_weights_host), built in shared memory with the window clip
// above as the tap rule (ClipRule): taps outside the true level dims or the
// window weigh 0, samples clipped onto one edge cell add up there. The
// backward is the forward's transpose. One block per (ROI, chunk of 64
// channels).
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
  build_dense(tb, [&](int axis) {
    return clip_rule(roi_i, roi_f, roi, axis, height, width, win_y, win_x);
  }, s, r, win_y, win_x);
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

// Gradient of the forward w.r.t. the levels. grad_ptrs are num_levels f32
// buffers (batch, h_l, w_l, channels), 16-byte aligned; they need not be
// initialised: this call zeroes them on the stream, then accumulates.
// g is the (num_rois, s, s, channels) f32 cotangent. Returns a cudaError_t.
extern "C" int u2seg_roi_align_ml_backward(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w,
    int num_levels, int batch, const int* roi_i, const float* roi_f,
    const float* g, int num_rois, int channels, int s, int r, int win_y,
    int win_x, void* stream) {
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
  if (!span_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = zero_levels(a.levels, num_levels, batch, channels, a.stream);
  if (err != cudaSuccess || num_rois == 0) return static_cast<int>(err);
  return static_cast<int>(launch_backward(a, g));
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
