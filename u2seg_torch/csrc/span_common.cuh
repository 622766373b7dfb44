// Device code shared by the span kernels: the multilevel ROIAlign forward and
// backward (roi_align_ml.cu) and the single-level window ROIAlign
// (roi_align_single.cu). Everything here is independent of how a sample's
// taps are weighted; each source brings its own tap rule to build_dense.
//
// For one ROI the pooled output is
//   out[py, px, c] = sum_y sum_x Wy[py, y] * Wx[px, x] * F[y, x, c]
// over the cells of the ROI's window, with Wy (s x win_y) and Wx (s x win_x)
// the dense per-axis weights (bilinear taps, r-sample mean folded in). A
// block builds both tables once in shared memory, with per bin the first and
// last cell of non-zero weight; the ROI's *span* is the box of all such cells.
// A tap rule gives weight only to cells inside the window and inside the map,
// so a span is read or written without a bounds test.
//
// One block serves one (ROI, chunk of kChunk = 64 channels): one cell of a
// chunk is 128-256 contiguous bytes and every global access is a 16-byte
// vector, neighbouring threads on neighbouring addresses. Maps are NHWC and
// C-contiguous, C a multiple of 8 and all storage 16-byte aligned (the
// wrappers check). The last chunk may be ragged (C % 64 != 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace span {

constexpr int kChunk = 64;                // channels per block
constexpr int kStaticSmemLimit = 48 * 1024;
constexpr int kMaxDynamicSmem = 232448;   // 227 KB, the most a block can opt in to
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// Dense pooled weights of one ROI in shared memory
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
// taps into its row, so no two threads write one entry. rule_of(axis) (0: y,
// 1: x) gives the tap rule of one axis, an object with
//   bool sample(int i, int r, float* local): the window-local coordinate of
//     sample i (of s * r), and whether the sample lies inside the map at all;
//   float tap(float local, bool inside, int k, int r, int* cell): tap k (0 or
//     1) of that sample, its window-local cell and its weight with the 1/r
//     mean folded in; 0 for a tap the rule drops. A tap of non-zero weight
//     must lie inside the window and inside the map.
// Needs blockDim.x >= 2 * s. Ends with a __syncthreads().
template <typename RuleOf>
__device__ __forceinline__ void build_dense(const Tables& tb, RuleOf rule_of, int s,
                                            int r, int win_y, int win_x) {
  const int n_w = s * (win_y + win_x);
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) tb.wy[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x < 2 * s) {
    const int axis = threadIdx.x / s;   // 0: y, 1: x
    const int bin = threadIdx.x - axis * s;
    const auto rule = rule_of(axis);
    const int win = axis ? win_x : win_y;
    float* row = (axis ? tb.wx : tb.wy) + bin * win;
    int lo = win, hi = -1;
    for (int i = bin * r; i < bin * r + r; ++i) {
      float local;
      const bool inside = rule.sample(i, r, &local);
      for (int k = 0; k < 2; ++k) {
        int cell;
        const float w = rule.tap(local, inside, k, r, &cell);
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
// Streaming (evict-first) stores: an output far larger than L2 then does not
// push the map out of it.
__device__ __forceinline__ void store8_streaming(float* p, const float v[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + 4), make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                            pack2(v[4], v[5]), pack2(v[6], v[7]));
}
template <bool kStreaming, typename Tout>
__device__ __forceinline__ void store_out(Tout* p, const float v[8]) {
  if constexpr (kStreaming) {
    store8_streaming(p, v);
  } else {
    store8(p, v);
  }
}

// ---------------------------------------------------------------------------
// The forward over one ROI's span
// ---------------------------------------------------------------------------

// acc += sum_y wy[y] * (sum_x wx[x] * cells[y, x]) over the bin's rows and
// columns (window-local, inclusive). cells points at the 8 channels of cell
// (y_base, x_base); rows are row_pitch and cells cell_pitch elements apart
// (a window of a map is far below 2^31 elements).
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

// The pooled output of one ROI for the block's chunk of channels
// (blockIdx.y), from the tables build_dense left. window points at channel 0
// of the window's cell (0, 0); map rows are row_elems elements apart. out_roi
// points at the ROI's (s, s, channels) output. stage is the block's buffer of
// stage_bytes (a multiple of 16 that holds a row of win_x cells of a chunk).
//
// The block walks the output rows in groups: as many consecutive bin rows as
// have their map rows fit the stage buffer. It copies the group's rows of the
// span into the buffer once with 16-byte cp.async, then each thread owns 8
// channels of one output value: for each row y of its bin it sums
// Wx[px, x] * F[y, x] over the bin's columns in registers (x pass), adds
// Wy[py, y] times that (y pass), and writes the value once with 16-byte
// stores. A single bin whose rows do not fit the buffer reads its cells from
// global memory with the same arithmetic. kStreaming: streaming f32 stores.
template <bool kStreaming, typename Tin, typename Tout>
__device__ __forceinline__ void span_forward(const Tables& tb, Tin* stage, int stage_bytes,
                                             const Tin* window, int row_elems,
                                             Tout* out_roi, int channels, int s,
                                             int win_y, int win_x) {
  constexpr int kVecElems = 16 / sizeof(Tin);       // elements per 16-byte vector
  constexpr int kVecs = kChunk / kVecElems;         // vectors per staged cell
  constexpr int kUnits = kChunk / 8;                // 8-channel output units per cell
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

  const int c0 = blockIdx.y * kChunk;
  const int cn = min(kChunk, channels - c0);        // ragged last chunk
  const bool has_unit = unit < cn / 8;
  const bool has_vec = vec < cn / kVecElems;
  // cell (window row 0, span column 0), the chunk's channel 0
  const Tin* level = window + sp.x_lo * channels + c0;
  out_roi += c0 + unit * 8;
  if (empty) {
    const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int o = slot; o < s * s && has_unit; o += slots) {
      store_out<kStreaming>(out_roi + static_cast<size_t>(o) * channels, zero);
    }
    return;
  }
  int py = 0;
  while (py < s) {
    // the group: bin rows [py, pe) whose map rows [lo, hi] fit the buffer
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
      store_out<kStreaming>(out_roi + (static_cast<size_t>(bin_y) * s + bin_x) * channels, acc);
    }
    __syncthreads();   // the next group's copies overwrite the buffer
    py = pe;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Dynamic shared memory above 48 KB has to be allowed per kernel and device;
// done is the calling instantiation's own flag array, so it is set once.
inline cudaError_t allow_dynamic_smem(const void* kernel, int bytes, bool* done) {
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

}  // namespace span
