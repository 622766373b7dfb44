// Multilevel FPN ROIAlign for Hopper (sm_90a): the forward and, further down,
// its gradient w.r.t. the levels.
//
// FORWARD
//
// Replaces the TPU kernels _ml_kernel_prew (u2seg_tpu/ops/roi_align_pallas.py:435,
// the default) and _ml_kernel (:225, U2SEG_POOL_PREW=0): both compute
//   out[roi, py, px, c] = mean over the r x r samples of bin (py, px) of the
//   bilinear interpolation of the ROI's routed level at that sample,
// with the window geometry of the JAX reference multilevel_roi_align_ref
// (:985). This kernel computes the bilinear tap weights in registers from
// per-ROI scalars, which is K2's form; K1 streamed the same weights in.
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
// level (> 1792 px at stride 64). The kernel honours the clip all the same,
// with the reference's own origins, so it equals the reference on every box.
//
// Layout and work split. Levels are NHWC (channels-last) and C-contiguous.
// One block per (ROI, output row): its threads first build the per-axis tap
// tables (two cells and two weights per sample, the 1/r mean folded in, taps
// outside the true level dims or the window given weight 0) in shared
// memory; then each thread owns a pair of channels and, for every bin of
// its row, accumulates the <= 4 r^2 taps in f32 from coalesced 4- or 8-byte
// loads. The output (R, s, s, C) is written once, in the output dtype.
//
// Bound on this card: bytes. Per ROI it moves s*s*C output values and reads
// the touched feature cells (at most (s*r+1)^2 cells of C values, far fewer
// distinct ones), for 8 r^2 flops per output value: with C = 256 that is
// about 8 flops per bf16 byte, far below the H100's ~295 flops/byte ridge.
// At s=7, R=1000, C=256 in bf16 the output alone is 25 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // s * r along one axis
constexpr int kThreads = 128;    // channel pairs per block

struct LevelTable {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

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
// and their bilinear weights with the 1/r mean folded in. A tap outside the
// true level dims or the window gets weight 0 (and cell 0). Ends with a
// __syncthreads().
__device__ __forceinline__ void build_taps(
    int (*tap_cell)[kMaxSamples][2], float (*tap_w)[kMaxSamples][2],
    const int* __restrict__ roi_i, const float* __restrict__ roi_f, int roi,
    int height, int width, int s, int r, int win_y, int win_x) {
  const int n = s * r;
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
    const int axis = t / n;  // 0: y, 1: x
    const int i = t - axis * n;
    const float c0 = roi_f[roi * 4 + axis];
    const float bin = roi_f[roi * 4 + 2 + axis];
    const int origin = roi_i[roi * 4 + 1 + axis];
    const int dim = axis ? width : height;
    const float size = static_cast<float>(dim);
    const float win_last = static_cast<float>((axis ? win_x : win_y) - 1);
    const float rel = static_cast<float>(i / r) +
                      (static_cast<float>(i % r) + 0.5f) / static_cast<float>(r);
    const float coord = c0 + rel * bin;
    const bool inside = coord >= -1.0f && coord <= size;
    const float cc = fminf(fmaxf(coord, 0.0f), size - 1.0f);
    const float local = fminf(fmaxf(cc - static_cast<float>(origin), 0.0f), win_last);
    const float t0 = floorf(local);
    for (int k = 0; k < 2; ++k) {
      const float cell_local = t0 + static_cast<float>(k);
      const int cell = origin + static_cast<int>(cell_local);
      float w = fmaxf(0.0f, 1.0f - fabsf(local - cell_local));
      const bool ok = inside && cell_local <= win_last && cell < dim;
      tap_cell[axis][i][k] = ok ? cell : 0;
      tap_w[axis][i][k] = ok ? w / static_cast<float>(r) : 0.0f;
    }
  }
  __syncthreads();
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
roi_align_ml_kernel(LevelTable levels,
                    const int* __restrict__ roi_i,    // (R, 4): lvl, oy, ox, b
                    const float* __restrict__ roi_f,  // (R, 4): y0, x0, bin_h, bin_w
                    Tout* __restrict__ out,           // (R, s, s, C)
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

// BACKWARD (gradient w.r.t. the levels)
//
// Replaces the TPU kernel _ml_bwd_kernel (u2seg_tpu/ops/roi_align_pallas.py
// :1074): the exact transpose of the forward above. With g the (R, s, s, C)
// f32 cotangent of the pooled output,
//   grad[lvl(roi)][b(roi), y, x, c] += wy * wx * g[roi, py, px, c]
// for every tap (y, wy) of a sample row of bin row py and every tap (x, wx)
// of a sample column of bin column px: the same tap tables as the forward,
// 1/r folded into each axis, so the r x r mean's 1/r^2 is in the product.
//
// The TPU kernel is a serial read-add-write chain of whole windows over a
// sequential grid, with per-axis small-window tiers that change no value.
// Here blocks run in no order, so the sums meet in f32 atomics instead: one
// block per (ROI, output row), each thread owns a channel pair and adds
// wy * wx * g into the zero-initialised f32 gradient levels at their true
// dims, one 8-byte vector atomic per non-zero tap. The launcher zeroes the
// gradient levels itself. Atomic adds land in an order that changes from run
// to run, so two runs differ in the last bits of an f32 sum.
//
// Bound on this card: bytes. It reads g once and must write every gradient
// cell once (the zero fill), for 2 r^2 * 4 flops per g value; the atomics'
// read-modify-write traffic in L2 is what this simple design pays on top.

__global__ void __launch_bounds__(kThreads)
roi_align_ml_backward_kernel(LevelTable grads,   // f32, zero-initialised
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
          const int y = tap_cell[0][iy][ty];
          if (y >= height) continue;   // bounds guard; the tap table already clears these
          float* row = base + y * row_stride + c;
          for (int sx = 0; sx < r; ++sx) {
            const int ix = px * r + sx;
            for (int tx = 0; tx < 2; ++tx) {
              const float wx = tap_w[1][ix][tx];
              if (wx == 0.0f) continue;
              const int x = tap_cell[1][ix][tx];
              if (x >= width) continue;
              const float wgt = wy * wx;
              atomicAdd(reinterpret_cast<float2*>(row + static_cast<size_t>(x) * channels),
                        make_float2(wgt * gv.x, wgt * gv.y));
            }
          }
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
void launch(const LevelTable& levels, const int* roi_i, const float* roi_f,
            void* out, int num_rois, int channels, int s, int r, int win_y,
            int win_x, cudaStream_t stream) {
  const int pairs = channels / 2;
  dim3 grid(num_rois, (pairs + kThreads - 1) / kThreads, s);
  roi_align_ml_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      levels, roi_i, roi_f, static_cast<Tout*>(out), channels, s, r, win_y,
      win_x);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
extern "C" int u2seg_roi_align_ml_forward(
    const int64_t* level_ptrs, const int* level_h, const int* level_w,
    int num_levels, const int* roi_i, const float* roi_f, void* out,
    int num_rois, int channels, int s, int r, int win_y, int win_x,
    int dtype_in, int dtype_out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || s < 1 || r < 1 ||
      s * r > kMaxSamples || channels < 2 || channels % 2 != 0 || s > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelTable levels = {};
  for (int l = 0; l < num_levels; ++l) {
    levels.ptr[l] = reinterpret_cast<const void*>(level_ptrs[l]);
    levels.h[l] = level_h[l];
    levels.w[l] = level_w[l];
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_in == 0 && dtype_out == 0) {
    launch<float, float>(levels, roi_i, roi_f, out, num_rois, channels, s, r, win_y, win_x, st);
  } else if (dtype_in == 0 && dtype_out == 1) {
    launch<float, __nv_bfloat16>(levels, roi_i, roi_f, out, num_rois, channels, s, r, win_y, win_x, st);
  } else if (dtype_in == 1 && dtype_out == 0) {
    launch<__nv_bfloat16, float>(levels, roi_i, roi_f, out, num_rois, channels, s, r, win_y, win_x, st);
  } else if (dtype_in == 1 && dtype_out == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(levels, roi_i, roi_f, out, num_rois, channels, s, r, win_y, win_x, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Gradient of the forward w.r.t. the levels. grad_ptrs are num_levels f32
// buffers (batch, h_l, w_l, channels), 8-byte aligned; they need not be
// initialised: this call zeroes them on the stream, then accumulates.
// g is the (num_rois, s, s, channels) f32 cotangent. Returns a cudaError_t.
extern "C" int u2seg_roi_align_ml_backward(
    const int64_t* grad_ptrs, const int* level_h, const int* level_w,
    int num_levels, int batch, const int* roi_i, const float* roi_f,
    const float* g, int num_rois, int channels, int s, int r, int win_y,
    int win_x, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || s < 1 || r < 1 ||
      s * r > kMaxSamples || channels < 2 || channels % 2 != 0 || s > 65535 ||
      batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LevelTable grads = {};
  for (int l = 0; l < num_levels; ++l) {
    grads.ptr[l] = reinterpret_cast<const void*>(grad_ptrs[l]);
    grads.h[l] = level_h[l];
    grads.w[l] = level_w[l];
    const size_t bytes = static_cast<size_t>(batch) * level_h[l] * level_w[l] *
                         channels * sizeof(float);
    if (bytes == 0) continue;
    cudaError_t err = cudaMemsetAsync(const_cast<void*>(grads.ptr[l]), 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  const int pairs = channels / 2;
  dim3 grid(num_rois, (pairs + kThreads - 1) / kThreads, s);
  roi_align_ml_backward_kernel<<<grid, kThreads, 0, st>>>(
      grads, roi_i, roi_f, g, channels, s, r, win_y, win_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
