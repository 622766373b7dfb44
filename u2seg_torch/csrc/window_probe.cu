// Window-read probe for Hopper (sm_90a): N windows of an NHWC bf16 map, each
// reduced to an (8, 128) f32 checksum, with each map byte read from device
// memory once.
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
// Origins are clamped into the map (b to [0, B), oy to [0, H - wy], ox to
// [0, W - wx]; the 3d alignment after the clamp). The TPU probe writes every
// step's checksum to the same output block, so it returns the LAST group's;
// here every group writes its own row of (N/G, 8, 128), which makes the
// whole run checkable, and the last row is the TPU probe's result.
//
// What the design rests on. Element e = (y * wx + x) * C + c of a window
// (y, x relative to its origin) goes to slot e mod 1024 in both modes. When
// wx * C is a multiple of 1024 (the one condition beyond the plain
// version's), the slot does not depend on y: it is (x * C + c) mod 1024. So a
// window's checksum is its column-strip sums (each column summed over the
// window's wy rows) folded by column: column x of the window adds into slot
// (x * C + c) mod 1024. Windows that start on the same row of the same image
// share their strips, and one pass down the map makes every row's strips.
//
// Bound on this card: bytes. Reading every window from device memory would
// move the overlapping window bytes, 5.24 GB at the probe's 32 x 40 shape, 20
// times the 262 MB of map the windows touch. This form reads the map once,
// writes and reads the partial table (2 x 32.8 MB at N = 8000) and writes the
// output.
//
// Routing, window_route_kernel (one block per image): order lists the
// windows by (image, clamped oy) and ascending index; row_start[b * H + oy]
// is where the list of (b, oy) starts in it (B * H + 1 entries). A counting
// sort without atomics: warp w of the block takes the w-th of 32 equal runs
// of the window indices, 32 windows at a time; __match_any_sync ranks each
// window of the block's image among those of its row in the run so far, and
// the warp keeps its own count per row; a block scan over (row, warp) makes
// the starts; every window is then placed. The image's offset counts the
// windows of earlier images. profile_window_read.py::window_routing is its
// plain version (torch ops).
//
// Stage A, window_strips_kernel: one block per (image, chunk of 8 channels,
// column band), in two roles. Stream warps: each thread owns one column of
// the band and the chunk's 8 channels, 16 bytes per map row. It walks the
// rows top to bottom: rows reach shared memory through 16-byte cp.async,
// kAhead rows in flight, into a ring of wy + kAhead + 1 rows; a thread copies
// and reads only its own column, so the ring needs no barrier. The strip sum
// of the last wy rows is kept running in f32 registers: add the row that
// enters, subtract the row that leaves (the ring still holds it). Running,
// not afresh: a fresh sum of wy rows per row costs wy adds per element (~4.4
// G adds at the probe's shapes) where the running sum costs two, and its
// rounding (strips of magnitude ~6, ulp ~5e-7, at most H steps) stays far
// inside the probe's tolerance. When row y = oy + wy - 1 has been added, the
// strips of origin oy are complete and, if windows start on row oy, the
// stream warps publish them to one of two strip buffers. Fold warps
// (kFoldThreads): for every such row in turn, each task of (window of (b,
// oy) whose origin the band owns, column residue r mod D with D = 1024 /
// gcd(C, 1024), 4 of the 8 channels) sums the window's columns of that
// residue in ascending x and writes 4 values of the window's row of the
// partial table P (N, D * C): P[n, r * C + c]. Two mbarriers per buffer hand
// it back and forth (full: the stream threads arrive, the fold warps wait;
// empty: the reverse), so the stream warps run on while a row is folded and
// no stream warp waits for another. The band carries a halo of wx - 1
// columns, so it folds whole windows; the fold warps stage the image's
// window records (index, clamped x origin) in shared memory in runs. Every
// element of P has one writer; no atomics. The ring of the whole width fills
// most of shared memory, so an SM holds one block and kAhead rows in flight
// per thread: that, not the bytes, bounds the pass.
//
// Stage B, window_groups_kernel: out[g, s] = sum over the G windows of group
// g in ascending index, and over k in ascending order, of P[n, s + 1024 k].
//
// Each map byte is read from device memory once per (chunk, band): once in
// all when the ring of the whole width fits in shared memory (one band, as at
// the probe's shapes), else the halo columns once more per band. Sums run in a
// fixed order, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "span_common.cuh"   // allow_dynamic_smem, kMaxDynamicSmem

namespace {

constexpr int kSlots = 1024;          // the (8, 128) checksum
constexpr int kVec = 8;               // channels per block: one 16-byte bf16 vector a cell
constexpr int kQuads = kVec / 4;      // float4 per cell of a strip buffer
constexpr int kLogQuads = 1;
constexpr int kAhead = 4;             // map rows in flight per thread
constexpr int kFoldThreads = 128;     // the fold warps of a block
constexpr int kMaxColumns = 1024 - kFoldThreads;   // columns per band
constexpr int kFoldBar = 1;           // the fold warps' named barrier (0 is __syncthreads)
constexpr int kBarBytes = 32;         // the strip buffers' mbarriers: full[2], empty[2]
constexpr int kMinRecords = 64;       // window records staged at a time, at least
constexpr int kMaxRecords = 2048;     // and at most
constexpr int kGroupThreads = 256;
constexpr int kRouteThreads = 1024;   // 32 warps, one run of windows each
constexpr int kMaxRows = 1536;        // H: the routing's counts per (row, warp) in shared memory

struct Plan {
  int cells;      // columns a band reads (owned origins + halo)
  int own;        // origins a band owns
  int bands;
  int ring;       // map rows in the ring
  int records;    // window records staged at a time
  int smem;       // dynamic shared memory bytes
};

// Shared memory of a block: four mbarriers (32 B), the ring (ring x cells x
// 16 B), two strip buffers (2 x cells x 32 B), the records (records x 8 B),
// the image's row starts ((H + 1) x 4 B). A single band when the whole width
// fits; else bands as wide as fit. Mirrored by
// profile_window_read.py::check_kernel_shapes (one owned column with
// kMinRecords records).
bool make_plan(int height, int width, int wy, int wx, Plan* p) {
  const long long ring = static_cast<long long>(wy) + kAhead + 1;
  const long long per_cell = ring * kVec * 2 + 2 * kVec * 4;
  const long long fixed =
      static_cast<long long>(height + 1) * 4 + kMinRecords * 8 + kBarBytes;
  if (fixed >= span::kMaxDynamicSmem) return false;
  const long long cap =
      std::min<long long>(kMaxColumns, (span::kMaxDynamicSmem - fixed) / per_cell);
  const int origins = width - wx + 1;
  if (cap >= width) {
    p->cells = width;
    p->own = origins;
    p->bands = 1;
  } else {
    p->own = static_cast<int>(cap) - (wx - 1);
    if (p->own < 1) return false;
    p->bands = (origins + p->own - 1) / p->own;
    p->cells = p->own + wx - 1;
  }
  p->ring = static_cast<int>(ring);
  const long long core =
      p->cells * per_cell + static_cast<long long>(height + 1) * 4 + kBarBytes;
  p->records = static_cast<int>(
      std::min<long long>(kMaxRecords, (span::kMaxDynamicSmem - core) / 8));
  p->smem = static_cast<int>(core + p->records * 8LL);
  return true;
}

struct StripArgs {
  const __nv_bfloat16* feat;   // (B, H, W, C)
  const int* ox;               // (N,) raw x origins
  const int* row_start;        // (B * H + 1,)
  const int* order;            // (N,)
  float* partial;              // (N, D * C)
  int height, width, channels, wy, wx;
  int align;                   // 1: 3d (x origin aligned down to 8)
  int slot_period;             // D = 1024 / gcd(C, 1024), a power of two
  int log_period;
  Plan plan;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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
// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\tmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "\t@!done bra WAIT;\n}" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// The stream warps' part: the running strips of the band's columns, published
// for every origin row that has windows. Row j of those goes to strip buffer
// j & 1 once the fold warps have emptied it (empty[j & 1]), and full[j & 1]
// says that it is there; a stream warp waits for no other stream warp.
__device__ __forceinline__ void stream_rows(const StripArgs& a, const int* rs, uint4* ring,
                                            float4* strips, uint64_t* full, uint64_t* empty,
                                            int b, int band_lo) {
  const Plan& pl = a.plan;
  const int t = threadIdx.x;
  const int x = band_lo + t;
  const bool live = t < pl.cells && x < a.width;
  const size_t row_elems = static_cast<size_t>(a.width) * a.channels;
  const __nv_bfloat16* col = a.feat + (static_cast<size_t>(b) * a.height * a.width +
                                       (live ? x : 0)) * a.channels + blockIdx.x * kVec;
  for (int k = 0; k < kAhead; ++k) {
    if (live && k < a.height) {
      __pipeline_memcpy_async(ring + k * pl.cells + t, col + k * row_elems, 16);
    }
    __pipeline_commit();
  }
  float s[kVec] = {};
  int j = 0;                                 // origin rows published so far
  for (int y = 0; y < a.height; ++y) {
    __pipeline_wait_prior(kAhead - 1);       // this thread's row y has landed
    if (live) {
      const uint4 in = ring[(y % pl.ring) * pl.cells + t];
      const __nv_bfloat162* hin = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
      for (int k = 0; k < kVec / 2; ++k) {
        const float2 v = __bfloat1622float2(hin[k]);
        s[2 * k] += v.x;
        s[2 * k + 1] += v.y;
      }
      if (y >= a.wy) {
        const uint4 out = ring[((y - a.wy) % pl.ring) * pl.cells + t];
        const __nv_bfloat162* hout = reinterpret_cast<const __nv_bfloat162*>(&out);
#pragma unroll
        for (int k = 0; k < kVec / 2; ++k) {
          const float2 v = __bfloat1622float2(hout[k]);
          s[2 * k] -= v.x;
          s[2 * k + 1] -= v.y;
        }
      }
    }
    // row y + kAhead goes where row y - wy - 1 was: subtracted one row ago
    const int next = y + kAhead;
    if (live && next < a.height) {
      __pipeline_memcpy_async(ring + (next % pl.ring) * pl.cells + t, col + next * row_elems, 16);
    }
    __pipeline_commit();

    const int oy = y - a.wy + 1;
    if (oy < 0 || rs[oy] == rs[oy + 1]) continue;   // no window starts on row oy
    const int k = j & 1;
    if (j >= 2) mbar_wait(empty + k, ((j >> 1) - 1) & 1);   // folded two rows ago
    float4* sb = strips + k * kQuads * pl.cells;
    if (t < pl.cells) {
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        sb[kQuads * t + u] = make_float4(s[4 * u], s[4 * u + 1], s[4 * u + 2], s[4 * u + 3]);
      }
    }
    mbar_arrive(full + k);
    ++j;
  }
}

// The fold warps' part: every window of every published origin row, in
// turn; f is the thread's index among the fold warps.
__device__ __forceinline__ void fold_rows(const StripArgs& a, const int* rs, int2* rec,
                                          const float4* strips, uint64_t* full,
                                          uint64_t* empty, int band_lo, int f) {
  const Plan& pl = a.plan;
  const int own_hi = min(band_lo + pl.own, a.width - a.wx + 1);
  const int D = a.slot_period;
  const size_t p_width = static_cast<size_t>(D) * a.channels;
  const int c0 = blockIdx.x * kVec;
  int seg_lo = rs[0], seg_hi = rs[0];        // records staged: order[seg_lo, seg_hi)
  int j = 0;
  for (int oy = 0; oy + a.wy <= a.height; ++oy) {
    const int lo = rs[oy], hi = rs[oy + 1];
    if (lo == hi) continue;
    const int k = j & 1;
    mbar_wait(full + k, (j >> 1) & 1);
    const float4* sb = strips + k * kQuads * pl.cells;
    int p = lo;
    while (true) {
      if (p >= seg_hi) {                      // stage the next run of records
        bar_sync(kFoldBar, kFoldThreads);     // the last run is read
        seg_lo = p;
        seg_hi = min(p + pl.records, rs[a.height]);
        for (int i = f; i < seg_hi - seg_lo; i += kFoldThreads) {
          const int n = a.order[seg_lo + i];
          int x0 = clampi(a.ox[n], 0, a.width - a.wx);
          if (a.align) x0 &= ~7;
          rec[i] = make_int2(n, x0);
        }
        bar_sync(kFoldBar, kFoldThreads);
      }
      const int q = min(hi, seg_hi);
      // one task per (window, residue r, 4 of the 8 channels)
      const int tasks = (q - p) << (a.log_period + kLogQuads);
      for (int task = f; task < tasks; task += kFoldThreads) {
        const int2 w = rec[p - seg_lo + (task >> (a.log_period + kLogQuads))];
        if (w.y < band_lo || w.y >= own_hi) continue;   // another band's window
        const int u = task & (kQuads - 1);
        const int r = (task >> kLogQuads) & (D - 1);
        const int first = w.y - band_lo + r, end = w.y - band_lo + a.wx;
        float4 acc = sb[kQuads * first + u];
        for (int c = first + D; c < end; c += D) {
          const float4 v = sb[kQuads * c + u];
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
        reinterpret_cast<float4*>(a.partial + static_cast<size_t>(w.x) * p_width +
                                  r * a.channels + c0)[u] = acc;
      }
      p = q;
      if (p >= hi) break;
    }
    mbar_arrive(empty + k);                   // the stream warps may reuse it
    ++j;
  }
}

// blockDim.x = the stream warps (cells rounded up to 32) + kFoldThreads.
__global__ void __launch_bounds__(1024)
window_strips_kernel(const __grid_constant__ StripArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& pl = a.plan;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);            // [2]
  uint64_t* empty = full + 2;                                    // [2]
  uint4* ring = reinterpret_cast<uint4*>(smem + kBarBytes);      // [ring][cells]
  float4* strips = reinterpret_cast<float4*>(ring + pl.ring * pl.cells);  // [2][cells]
  int2* rec = reinterpret_cast<int2*>(strips + 2 * kQuads * pl.cells);   // [records]
  int* rs = reinterpret_cast<int*>(rec + pl.records);            // [height + 1]
  const int b = blockIdx.y;
  const int band_lo = blockIdx.z * pl.own;
  const int streams = blockDim.x - kFoldThreads;
  for (int i = threadIdx.x; i <= a.height; i += blockDim.x) {
    rs[i] = a.row_start[static_cast<size_t>(b) * a.height + i];
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(full + k, streams);
      mbar_init(empty + k, kFoldThreads);
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < streams) {
    stream_rows(a, rs, ring, strips, full, empty, b, band_lo);
  } else {
    fold_rows(a, rs, rec, strips, full, empty, band_lo, threadIdx.x - streams);
  }
}

__global__ void __launch_bounds__(kGroupThreads)
window_groups_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int groups, int g, int p_width) {
  const int idx = blockIdx.x * kGroupThreads + threadIdx.x;   // (group, 4 slots)
  if (idx >= groups * (kSlots / 4)) return;
  const int grp = idx / (kSlots / 4);
  const int s4 = (idx % (kSlots / 4)) * 4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < g; ++j) {
    const float* row = partial + (static_cast<size_t>(grp) * g + j) * p_width;
    for (int k = 0; k < p_width; k += kSlots) {
      const float4 v = *reinterpret_cast<const float4*>(row + k + s4);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(grp) * kSlots + s4) = acc;
}

__global__ void __launch_bounds__(kRouteThreads)
window_route_kernel(const int* __restrict__ oy, const int* __restrict__ bi, int n,
                    int batch, int height, int wy, int* __restrict__ row_start,
                    int* __restrict__ order, int* __restrict__ rank) {
  extern __shared__ int route_smem[];
  int* cnt = route_smem;                     // [height][32]: counts, then starts
  int* part = cnt + height * 32;             // [33]: warp sums, then the image's offset
  int* low = part + 33;                      // [32]: each warp's windows of earlier images
  const int image = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int run = (n + 31) / 32;
  const int run_lo = min(warp * run, n), run_hi = min(run_lo + run, n);
  for (int k = t; k < height * 32; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  int below = 0;                             // windows of earlier images
  for (int i0 = run_lo; i0 < run_hi; i0 += 32) {
    const int i = i0 + lane;
    int row = -1;
    if (i < run_hi) {
      const int b = clampi(bi[i], 0, batch - 1);
      below += b < image;
      if (b == image) row = clampi(oy[i], 0, height - wy);
    }
    const unsigned same = __match_any_sync(0xffffffffu, row);
    const int before = __popc(same & ((1u << lane) - 1u));
    const int c = row >= 0 ? cnt[row * 32 + warp] : 0;
    __syncwarp();
    if (row >= 0) {
      rank[i] = c + before;
      if (before == 0) cnt[row * 32 + warp] = c + __popc(same);   // the row's first lane
    }
    __syncwarp();
  }
  // the image's offset, and an exclusive scan of the counts in (row, warp)
  // order: thread t owns entries [lo, hi)
  for (int d = 16; d > 0; d >>= 1) below += __shfl_down_sync(0xffffffffu, below, d);
  if (lane == 0) low[warp] = below;
  __syncthreads();                           // every count is final
  const int entries = height * 32;
  const int per = (entries + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, entries), hi = min(lo + per, entries);
  int local = 0;
  for (int k = lo; k < hi; ++k) local += cnt[k];
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = part[lane], img = low[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    for (int d = 16; d > 0; d >>= 1) img += __shfl_down_sync(0xffffffffu, img, d);
    __syncwarp();
    part[lane] = w;                          // inclusive over warps
    if (lane == 0) part[32] = img;
  }
  __syncthreads();
  const int offset = part[32];
  int start = offset + (warp ? part[warp - 1] : 0) + incl - local;
  for (int k = lo; k < hi; ++k) {
    const int c = cnt[k];
    cnt[k] = start;
    if ((k & 31) == 0) row_start[static_cast<size_t>(image) * height + (k >> 5)] = start;
    start += c;
  }
  if (image == batch - 1 && t == 0) row_start[static_cast<size_t>(batch) * height] = n;
  __syncthreads();
  for (int i0 = run_lo; i0 < run_hi; i0 += 32) {
    const int i = i0 + lane;
    if (i < run_hi && clampi(bi[i], 0, batch - 1) == image) {
      order[cnt[clampi(oy[i], 0, height - wy) * 32 + warp] + rank[i]] = i;
    }
  }
}

int gcd(int u, int v) {
  while (v) {
    const int r = u % v;
    u = v;
    v = r;
  }
  return u;
}

bool bad_args(int batch, int height, int width, int channels, int n, int g,
              int wy, int wx) {
  return batch < 1 || height < 1 || width < 1 || channels < kVec ||
         channels % kVec != 0 || g < 1 || n < 0 || n % g != 0 || wy < 1 ||
         wx < 1 || wy > height || wx > width ||
         (static_cast<long long>(wx) * channels) % kSlots != 0 ||
         height > kMaxRows;
}

int window_sum(const void* feat, int batch, int height, int width, int channels,
               const int* oy, const int* ox, const int* bi, int n, int g, int wy, int wx,
               int* row_start, int* order, int* rank, float* partial, float* out,
               void* stream, int align) {
  Plan plan;
  if (bad_args(batch, height, width, channels, n, g, wy, wx) ||
      !make_plan(height, width, wy, wx, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  static bool allowed[span::kMaxDevices] = {}, route_allowed[span::kMaxDevices] = {};
  cudaError_t err = span::allow_dynamic_smem(
      reinterpret_cast<const void*>(window_strips_kernel), plan.smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int route_smem = (height * 32 + 65) * 4;
  err = span::allow_dynamic_smem(reinterpret_cast<const void*>(window_route_kernel),
                                 route_smem, route_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int period = kSlots / gcd(channels, kSlots);
  int log_period = 0;
  while ((1 << log_period) < period) ++log_period;
  StripArgs a{static_cast<const __nv_bfloat16*>(feat), ox, row_start, order, partial,
              height, width, channels, wy, wx, align, period, log_period, plan};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  window_route_kernel<<<batch, kRouteThreads, route_smem, st>>>(oy, bi, n, batch, height, wy,
                                                             row_start, order, rank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (plan.cells + 31) / 32 * 32 + kFoldThreads;
  window_strips_kernel<<<dim3(channels / kVec, batch, plan.bands), threads, plan.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = n / g;
  const int blocks = (groups * (kSlots / 4) + kGroupThreads - 1) / kGroupThreads;
  window_groups_kernel<<<blocks, kGroupThreads, 0, st>>>(partial, out, groups, g,
                                                         period * channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat: bf16 (batch, height, width, channels), 16-byte aligned; oy, ox, bi:
// (n,) int32 raw origins; row_start (batch * height + 1,), order (n,) and
// rank (n,) int32: the routing's lists and scratch (see the header note);
// partial: f32 (n, D * channels) scratch, every element written; out: f32
// (n / g, 8, 128). Needs channels a multiple of 8, wx * channels a multiple
// of 1024, height <= kMaxRows and a ring that fits in shared memory.
// Three launches on the stream: routing, strips, groups. Returns a
// cudaError_t value.
extern "C" int u2seg_window_sum_3d(
    const void* feat, int batch, int height, int width, int channels,
    const int* oy, const int* ox, const int* bi, int n, int g, int wy, int wx,
    int* row_start, int* order, int* rank, float* partial, float* out, void* stream) {
  return window_sum(feat, batch, height, width, channels, oy, ox, bi, n, g, wy, wx,
                    row_start, order, rank, partial, out, stream, 1);
}

// As above on the (batch, height, width * channels) view of the same map:
// the window starts at element ox * channels of its rows.
extern "C" int u2seg_window_sum_flat(
    const void* feat, int batch, int height, int width, int channels,
    const int* oy, const int* ox, const int* bi, int n, int g, int wy, int wx,
    int* row_start, int* order, int* rank, float* partial, float* out, void* stream) {
  return window_sum(feat, batch, height, width, channels, oy, ox, bi, n, g, wy, wx,
                    row_start, order, rank, partial, out, stream, 0);
}

extern "C" const char* u2seg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
