// Single-level aligned ROIAlign from one fixed window per ROI, for Hopper
// (sm_90a): a span kernel (span_common.cuh) with the window kernel's own tap
// rule.
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
// - a tap whose window-local cell falls outside 0..win-1 gets NO weight (not
//   the multilevel kernel's edge clip): a box longer than the window loses
//   its far samples;
// - f32 accumulation and f32 output for every input type.
//
// The design is the multilevel forward's (span_common.cuh): the r-sample mean
// is folded into dense per-axis weights Wy, Wx (s x win) that each block
// builds once in shared memory with the tap rule above (WindowRule); one
// block per (ROI, chunk of 64 channels) copies the rows of the ROI's span
// (the box of all cells of non-zero weight: inside the window and inside the
// map, up to 40 x 40 cells) into a fixed stage buffer with 16-byte cp.async,
// group of output rows by group, and each thread computes 8 channels of one
// output value (x pass in registers, then y pass) and writes them with two
// 16-byte streaming stores. A bin taller than the buffer reads global memory
// with the same arithmetic. Block size and buffer come from the wrapper
// (launch_plan), by measurement.
//
// Bound on this card: bytes. Per ROI it writes s*s*C f32 values (200 MB at
// s=14 for 1000 ROIs at C=256, four times L2) and reads the touched cells of
// a map that L2 holds, for about 2 * 12 flops per output value. Streaming
// stores keep the output from evicting the map from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "span_common.cuh"

namespace {

using namespace span;

constexpr int kMaxSamples = 64;  // s * r along one axis
constexpr int kThreads = 256;    // largest block

struct WindowRule {   // one axis of one ROI
  float c0, bin, size;
  int origin, dim, win;

  // Window-local coordinate of sample i (of s * r), clamped into the map but
  // not into the window. Returns whether the sample lies inside [-1, size].
  __device__ __forceinline__ bool sample(int i, int r, float* local) const {
    const float rel = static_cast<float>(i / r) +
                      (static_cast<float>(i % r) + 0.5f) / static_cast<float>(r);
    const float coord = c0 + rel * bin;
    const float cc = fminf(fmaxf(coord, 0.0f), size - 1.0f);
    *local = cc - static_cast<float>(origin);
    return coord >= -1.0f && coord <= size;
  }

  // Tap k (0 or 1): its window-local cell and its weight with the 1/r mean
  // folded in; 0 for a cell outside the window's 0..win-1. The map guard
  // cannot fire while H, W >= win and the origins are the wrapper's; it keeps
  // every span inside the map whatever the origins are.
  __device__ __forceinline__ float tap(float local, bool inside, int k, int r,
                                       int* cell) const {
    const float t = floorf(local) + static_cast<float>(k);
    const float w = fmaxf(0.0f, 1.0f - fabsf(local - t));
    const bool in_win = t >= 0.0f && t <= static_cast<float>(win - 1);
    *cell = in_win ? static_cast<int>(t) : 0;
    const bool ok = inside && in_win && origin + *cell >= 0 && origin + *cell < dim;
    return ok ? w / static_cast<float>(r) : 0.0f;
  }
};

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
roi_align_single_kernel(const Tin* __restrict__ feat,     // (B, H, W, C)
                        const int* __restrict__ origin,   // (R, 2): oy, ox
                        const int* __restrict__ batch,    // (R,)
                        const float* __restrict__ meta,   // (R, 4): y0, x0, bin_h, bin_w
                        float* __restrict__ out,          // (R, s, s, C)
                        int height, int width, int channels, int s, int r,
                        int win, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tables tb = carve_tables(smem + stage_bytes, s, win, win);

  const int roi = blockIdx.x;
  const int oy = origin[roi * 2];
  const int ox = origin[roi * 2 + 1];
  build_dense(tb, [&](int axis) {
    WindowRule a;
    a.c0 = meta[roi * 4 + axis];
    a.bin = meta[roi * 4 + 2 + axis];
    a.origin = axis ? ox : oy;
    a.dim = axis ? width : height;
    a.size = static_cast<float>(a.dim);
    a.win = win;
    return a;
  }, s, r, win, win);
  const int row_elems = width * channels;           // a map row; < 2^31 elements
  const Tin* window = feat + (static_cast<size_t>(batch[roi]) * height + oy) * row_elems +
                      static_cast<size_t>(ox) * channels;
  span_forward<true>(tb, reinterpret_cast<Tin*>(smem), stage_bytes, window, row_elems,
                     out + static_cast<size_t>(roi) * s * s * channels, channels, s, win,
                     win);
}

int smem_bytes(int s, int win, int stage_bytes) {
  return stage_bytes + table_bytes(s, win, win);
}

template <typename Tin>
cudaError_t launch(const void* feat, int height, int width, int channels,
                   const int* origin, const int* batch, const float* meta, float* out,
                   int num_rois, int s, int r, int win, int threads, int stage_bytes,
                   cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  auto kernel = roi_align_single_kernel<Tin>;
  // the buffer holds at least one row of the widest span
  if (stage_bytes % 16 != 0 || stage_bytes < win * kChunk * static_cast<int>(sizeof(Tin))) {
    return cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(s, win, stage_bytes);
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(num_rois, (channels + kChunk - 1) / kChunk);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const Tin*>(feat), origin, batch,
                                          meta, out, height, width, channels, s, r, win,
                                          stage_bytes);
  return cudaGetLastError();
}

}  // namespace

// dtype_in: 0 = float32, 1 = bfloat16. threads: block size, a multiple of 32
// in [max(32, 2 s), 256]; stage_bytes: the block's buffer of staged map cells,
// a multiple of 16 that holds at least win cells of a chunk (the wrapper
// passes its launch_plan(s)). feat and out are 16-byte aligned, channels a
// multiple of 8, H and W at least win. Returns a cudaError_t value.
extern "C" int u2seg_roi_align_single_forward(
    const void* feat, int batch_size, int height, int width, int channels,
    const int* origin, const int* batch, const float* meta, float* out,
    int num_rois, int s, int r, int win, int dtype_in, int threads,
    int stage_bytes, void* stream) {
  if (s < 1 || r < 1 || s * r > kMaxSamples || channels < 8 || channels % 8 != 0 ||
      (channels + kChunk - 1) / kChunk > 65535 || batch_size < 1 || win < 1 ||
      height < win || width < win || threads % 32 != 0 || threads < 32 ||
      threads < 2 * s || threads > kThreads || dtype_in < 0 || dtype_in > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype_in == 0
          ? launch<float>(feat, height, width, channels, origin, batch, meta, out,
                          num_rois, s, r, win, threads, stage_bytes, st)
          : launch<__nv_bfloat16>(feat, height, width, channels, origin, batch, meta,
                                  out, num_rois, s, r, win, threads, stage_bytes, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one block, in bytes.
extern "C" int u2seg_roi_align_single_smem_bytes(int s, int win, int stage_bytes) {
  return smem_bytes(s, win, stage_bytes);
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
