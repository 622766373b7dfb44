// Single-level aligned ROIAlign from one fixed window per ROI, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _roi_align_kernel (u2seg_tpu/ops/roi_align_pallas.py
// :62, called through roi_align_pallas, :147-204). Per ROI that kernel copies
// one win x win (40 x 40) spatial window of the (B, H, W, C) feature map,
// builds the separable bilinear weight matrices Wy, Wx (s*r, win) as
// relu(1 - |local - cell|) over the window's cells, computes
// Wy @ window @ Wx^T, and the caller averages the r x r samples of each bin:
//   out[roi, py, px, c] = 1/r^2 * sum over the samples (iy, ix) of bin
//     (py, px) of sum_{i,j} wy[iy, i] * wx[ix, j] * F[b, oy + i, ox + j, c].
//
// What is kept exactly, because it decides values:
// - a sample outside [-1, size] contributes 0; inside, it is clamped into
//   [0, size - 1] and then expressed relative to the window origin;
// - the window origins come from the wrapper (floor(first sample) - 1,
//   clipped to [0, size - win], x aligned DOWN to a multiple of 8, which was
//   a TPU copy rule but moves the window);
// - a sample whose local coordinate falls outside the window's cells
//   0..win-1 gets NO weight (not an edge clamp, unlike the multilevel
//   kernel): a box longer than the window loses its far samples;
// - f32 accumulation and f32 output for every input type.
//
// What is not carried over: the window copy into fast memory and the two
// dense (s*r, win) products. Each sample has at most two non-zero weights
// per axis, so the kernel keeps per-axis tap tables (two cells, two weights,
// 1/r folded in) in shared memory and reads the <= 4 r^2 taps of a bin
// straight from the NHWC map.
//
// Work split, as the multilevel kernel's: one block per (ROI, output row);
// each thread owns a pair of channels (coalesced 4-byte bf16x2 or 8-byte
// f32x2 loads) and walks the row's s bins.
//
// Bound on this card: bytes. Per ROI it writes s*s*C f32 values and reads
// the touched cells, for 8 r^2 flops per output value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 64;  // s * r along one axis
constexpr int kThreads = 128;    // channel pairs per block

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
roi_align_single_kernel(const Tin* __restrict__ feat,     // (B, H, W, C)
                        const int* __restrict__ origin,   // (R, 2): oy, ox
                        const int* __restrict__ batch,    // (R,)
                        const float* __restrict__ meta,   // (R, 4): y0, x0, bin_h, bin_w
                        float* __restrict__ out,          // (R, s, s, C)
                        int height, int width, int channels, int s, int r,
                        int win) {
  __shared__ int tap_cell[2][kMaxSamples][2];   // [axis][sample][tap]
  __shared__ float tap_w[2][kMaxSamples][2];

  const int roi = blockIdx.x;
  const int py = blockIdx.z;
  const int n = s * r;
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
    const int axis = t / n;  // 0: y, 1: x
    const int i = t - axis * n;
    const float c0 = meta[roi * 4 + axis];
    const float bin = meta[roi * 4 + 2 + axis];
    const int org = origin[roi * 2 + axis];
    const int dim = axis ? width : height;
    const float size = static_cast<float>(dim);
    const float rel = static_cast<float>(i / r) +
                      (static_cast<float>(i % r) + 0.5f) / static_cast<float>(r);
    const float coord = c0 + rel * bin;
    const bool inside = coord >= -1.0f && coord <= size;
    const float cc = fminf(fmaxf(coord, 0.0f), size - 1.0f);
    const float local = cc - static_cast<float>(org);
    const float t0 = floorf(local);
    for (int k = 0; k < 2; ++k) {
      const float cell_local = t0 + static_cast<float>(k);
      const float w = fmaxf(0.0f, 1.0f - fabsf(local - cell_local));
      // a cell outside the window's 0..win-1 has no weight; the map guard
      // cannot fire while H, W >= win (the launcher checks) and is kept for
      // memory safety
      const bool in_win = cell_local >= 0.0f &&
                          cell_local <= static_cast<float>(win - 1);
      const int cell = in_win ? org + static_cast<int>(cell_local) : 0;
      const bool ok = inside && in_win && cell >= 0 && cell < dim;
      tap_cell[axis][i][k] = ok ? cell : 0;
      tap_w[axis][i][k] = ok ? w / static_cast<float>(r) : 0.0f;
    }
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(width) * channels;
  const Tin* base = feat + static_cast<size_t>(batch[roi]) * height * row_stride;
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
      *reinterpret_cast<float2*>(
          out + ((static_cast<size_t>(roi) * s + py) * s + px) * channels + c) =
          make_float2(a0, a1);
    }
  }
}

}  // namespace

// dtype_in: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
extern "C" int u2seg_roi_align_single_forward(
    const void* feat, int batch_size, int height, int width, int channels,
    const int* origin, const int* batch, const float* meta, float* out,
    int num_rois, int s, int r, int win, int dtype_in, void* stream) {
  if (s < 1 || r < 1 || s * r > kMaxSamples || channels < 2 ||
      channels % 2 != 0 || s > 65535 || batch_size < 1 || win < 1 ||
      height < win || width < win) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = channels / 2;
  dim3 grid(num_rois, (pairs + kThreads - 1) / kThreads, s);
  if (dtype_in == 0) {
    roi_align_single_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(feat), origin, batch, meta, out, height,
        width, channels, s, r, win);
  } else if (dtype_in == 1) {
    roi_align_single_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), origin, batch, meta, out,
        height, width, channels, s, r, win);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
