// Multilevel FPN ROIAlign forward for Hopper (sm_90a).
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
  const int n = s * r;
  const int lvl = roi_i[roi * 4 + 0];
  const int b = roi_i[roi * 4 + 3];
  const int height = levels.h[lvl];
  const int width = levels.w[lvl];

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

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
