// Window-read probe for Hopper (sm_90a): what do per-ROI window reads out of
// an NHWC feature pyramid reach in bytes per second?
//
// Replaces the two TPU probe kernels kernel_3d and kernel_flat
// (dev/profile_dma_flat.py:50 and :70, launched at :109). Each copies G
// windows per grid step out of a bf16 map and reduces them to an (8, 128)
// f32 checksum: element e of the flattened window (row-major over
// (wy, wx, C)) is added to slot e mod 1024, over the G windows of the step.
//   window_sum_3d:   window (wy, wx, C) out of (B, H, W, C); the x origin is
//                    aligned DOWN to a multiple of 8 (the TPU's copy rule,
//                    kept because it decides which cells are read);
//   window_sum_flat: window (wy, wx*C) out of (B, H, W*C) at element offset
//                    ox*C; no alignment.
// The TPU probe writes every step's checksum to the same output block, so
// it returns the LAST group's; here every group writes its own row of
// (N/G, 8, 128), which makes the whole run checkable, and the last row is
// the TPU probe's result.
//
// Design. One block per group, 256 threads. A thread reads 16 bytes (8 bf16)
// per load, neighbouring threads neighbouring addresses; it strides over the
// window by 256 vectors, so vector q always falls on slots 8 * (q mod 128)
// .. + 7: the thread keeps 8 f32 sums in registers for the whole group and
// the two halves of the block meet once in shared memory. Origins are
// clamped into the map (memory safety; the plain version clamps too).
// cp.async / TMA bulk copies are left to the redesign of the pooler.
//
// Bound on this card: bytes (one add per 2 bytes read).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 1024;          // the (8, 128) checksum
constexpr int kVec = 8;               // bf16 values per 16-byte load
constexpr int kSlotGroups = kSlots / kVec;

__device__ __forceinline__ void add_vec(float (&acc)[kVec], const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    acc[2 * k] += v.x;
    acc[2 * k + 1] += v.y;
  }
}

__device__ __forceinline__ void write_checksum(float (&acc)[kVec], float* out_row) {
  __shared__ float red[kSlots];
  const int group = threadIdx.x % kSlotGroups;
  if (threadIdx.x >= kSlotGroups) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) red[group * kVec + k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kSlotGroups) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      out_row[group * kVec + k] = acc[k] + red[group * kVec + k];
    }
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
window_sum_3d_kernel(const __nv_bfloat16* __restrict__ feat,   // (B, H, W, C)
                     const int* __restrict__ oy, const int* __restrict__ ox,
                     const int* __restrict__ bi, float* __restrict__ out,
                     int batch, int height, int width, int channels, int g,
                     int wy, int wx) {
  float acc[kVec] = {};
  const int cvecs = channels / kVec;        // vectors per cell
  const int total = wy * wx * cvecs;        // vectors per window
  for (int j = 0; j < g; ++j) {
    const int roi = blockIdx.x * g + j;
    const int b = clampi(bi[roi], 0, batch - 1);
    const int y0 = clampi(oy[roi], 0, height - wy);
    const int x0 = clampi(ox[roi], 0, width - wx) & ~7;
    const __nv_bfloat16* base =
        feat + ((static_cast<size_t>(b) * height + y0) * width + x0) * channels;
    for (int q = threadIdx.x; q < total; q += kThreads) {
      const int cv = q % cvecs;
      const int cell = q / cvecs;
      const int x = cell % wx;
      const int y = cell / wx;
      add_vec(acc, base + (static_cast<size_t>(y) * width + x) * channels + cv * kVec);
    }
  }
  write_checksum(acc, out + static_cast<size_t>(blockIdx.x) * kSlots);
}

__global__ void __launch_bounds__(kThreads)
window_sum_flat_kernel(const __nv_bfloat16* __restrict__ feat,   // (B, H, L)
                       const int* __restrict__ oy, const int* __restrict__ ox,
                       const int* __restrict__ bi, float* __restrict__ out,
                       int batch, int height, int row_len, int channels, int g,
                       int wy, int wx) {
  float acc[kVec] = {};
  const int span = wx * channels;           // elements per window row
  const int rvecs = span / kVec;            // vectors per window row
  const int total = wy * rvecs;
  for (int j = 0; j < g; ++j) {
    const int roi = blockIdx.x * g + j;
    const int b = clampi(bi[roi], 0, batch - 1);
    const int y0 = clampi(oy[roi], 0, height - wy);
    const int e0 = clampi(ox[roi] * channels, 0, row_len - span);
    const __nv_bfloat16* base =
        feat + (static_cast<size_t>(b) * height + y0) * row_len + e0;
    for (int q = threadIdx.x; q < total; q += kThreads) {
      const int v = q % rvecs;
      const int y = q / rvecs;
      add_vec(acc, base + static_cast<size_t>(y) * row_len + v * kVec);
    }
  }
  write_checksum(acc, out + static_cast<size_t>(blockIdx.x) * kSlots);
}

bool bad_args(int batch, int height, int width, int channels, int n, int g,
              int wy, int wx) {
  return batch < 1 || channels < kVec || channels % kVec != 0 || g < 1 ||
         n < 0 || n % g != 0 || wy < 1 || wx < 1 || wy > height || wx > width ||
         (static_cast<long long>(wy) * wx * channels) % kSlots != 0;
}

}  // namespace

// feat: bf16 (batch, height, width, channels), 16-byte aligned; oy, ox, bi:
// (n,) int32; out: f32 (n / g, 8, 128). Returns a cudaError_t value.
extern "C" int u2seg_window_sum_3d(
    const void* feat, int batch, int height, int width, int channels,
    const int* oy, const int* ox, const int* bi, int n, int g, int wy, int wx,
    float* out, void* stream) {
  if (bad_args(batch, height, width, channels, n, g, wy, wx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  window_sum_3d_kernel<<<n / g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat), oy, ox, bi, out, batch, height,
      width, channels, g, wy, wx);
  return static_cast<int>(cudaGetLastError());
}

// As above on the (batch, height, width * channels) view of the same map:
// the window starts at element ox * channels of its rows.
extern "C" int u2seg_window_sum_flat(
    const void* feat, int batch, int height, int width, int channels,
    const int* oy, const int* ox, const int* bi, int n, int g, int wy, int wx,
    float* out, void* stream) {
  if (bad_args(batch, height, width, channels, n, g, wy, wx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  window_sum_flat_kernel<<<n / g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(feat), oy, ox, bi, out, batch, height,
      width * channels, channels, g, wy, wx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
