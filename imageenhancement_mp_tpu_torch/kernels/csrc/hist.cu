// Histogram-family kernels for u8 planes: the per-plane 256-bin histogram,
// cv2's equalizeHist LUT built from it (in the histogram kernel's epilogue,
// or from a histogram in memory), and the 256-entry LUT apply (u8 tables;
// wider tables; K tables at once).
//
// Each exported function launches on the caller's stream, allocates nothing,
// and returns the cudaError_t of cudaGetLastError() right after its launch.
// Built with -fmad=false and without --use_fast_math: every rounding below
// is the one written (int->f32 conversion to nearest, IEEE division and
// product, rintf half-to-even).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_count.cuh"

namespace {

constexpr int kThreads = 256;
// Bytes one block covers in the streaming kernels: 256 threads x 16 vectors
// of 16 B.  Planes larger than this get several blocks each.
constexpr int64_t kBytesPerBlock = int64_t(kThreads) * 16 * 16;
constexpr int64_t kMaxGridY = 65535;  // planes beyond it stride over gridDim.y

// A plane's bytes as an unaligned head, a body of 16-byte vectors and a tail.
struct Split {
  int64_t head;        // bytes before the first 16-byte boundary
  int64_t nvec;        // uint4 vectors in the body
  int64_t tail_start;  // first byte after the body
};

__device__ __forceinline__ Split split_plane(const uint8_t* p, int64_t n) {
  int64_t head = int64_t((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  if (head > n) head = n;
  const int64_t nvec = (n - head) >> 4;
  return {head, nvec, head + (nvec << 4)};
}

int blocks_per_plane(int64_t n) {
  int64_t b = (n + kBytesPerBlock - 1) / kBytesPerBlock;
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return int(b);
}

// ---------------------------------------------------------------------------
// hist256: replaces the JAX package's kernels/hist.py::hist256_pallas
// (the nibble one-hot MXU dot, whose f32 accumulation forced 2^17-pixel
// stripes), and with a LUT output the histogram and LUT phases of
// equalize_hist_pallas, which builds cv2's LUT in the same pallas_call
// (kernels/hist.py:549-572).  The bound is device memory: 1 B/px read
// once.  A block counts a grid-strided share of one plane's 16-byte
// vectors through hist_count.cuh (kHistLoads loads a group, the next group
// loaded while one is counted), its head and tail bytes through shared
// atomics.  The plane's blocks then hand their bins to the last of them
// (hist_count.cuh::last_of_group), which writes the plane's histogram row
// whole (`hist`, when given) and its equalize LUT row (`lut`, when given):
// no zeroed output and no second launch.  kernels/hist.py::hist256_plan
// sizes the grid to the card's resident blocks.  The counts are integers,
// so the result does not depend on which block arrives last.
// Pooled equalizeHist (the JAX package's ops/histogram.py::
// equalize_hist_global_planes) is the same handoff with larger groups:
// with `groups` = C < B, plane b belongs to group b % C (the as_planes
// layout of [N, H, W, C] frames, frame-major and channel-minor), a group's
// members are all the blocks of its B / C planes, and its last block writes
// the group's row from the counts of all of them (the LUT of total =
// (B / C) * n pixels).  groups = B is the per-plane case.
// ---------------------------------------------------------------------------

// Vectors a thread loads at a time (2 in flight with the next group; the
// A/B timed 3 within 4 % of it).
constexpr int kHistLoads = 1;

__global__ void __launch_bounds__(kCountThreads, 3)
hist256_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ hist,
               uint8_t* __restrict__ lut, uint32_t* __restrict__ partial,
               int32_t* __restrict__ tickets, int64_t B, int64_t n, int64_t groups) {
  extern __shared__ __align__(16) uint32_t count_smem[];
  const int tid = threadIdx.x;
  const int64_t g0 = int64_t(blockIdx.x) * kCountThreads;
  const int64_t stride = int64_t(gridDim.x) * kCountThreads;
  HistCounter c;

  // planes stride over gridDim.y, so any number of planes fits the grid;
  // each group has its own ticket and scratch rows, one row a member (a
  // block of one of its planes)
  const int members = int(B / groups) * int(gridDim.x);
  const int32_t total = int32_t(B / groups * n);
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    c.begin(count_smem);
    __syncthreads();

    const uint8_t* p = x + b * n;
    const Split s = split_plane(p, n);
    const uint4* pv = reinterpret_cast<const uint4*>(p + s.head);
    int64_t i = g0 + tid;
    count_vectors<kHistLoads>(c, [&](VecGroup<kHistLoads>& grp) {
#pragma unroll
      for (int u = 0; u < kHistLoads; ++u) {
        grp.ok[u] = i < s.nvec;
        grp.v[u] = grp.ok[u] ? __ldg(pv + i) : make_uint4(0, 0, 0, 0);
        i += stride;
      }
    });
    for (int64_t j = g0 + tid; j < s.head; j += stride) c.add_one(p[j]);
    for (int64_t j = s.tail_start + g0 + tid; j < n; j += stride) c.add_one(p[j]);
    __syncthreads();

    uint32_t sum = c.bin_total();
    const int64_t g = b % groups;
    const int member = int(b / groups) * int(gridDim.x) + int(blockIdx.x);
    if (last_of_group(sum, partial + g * members * 256, member, members, tickets + g)) {
      if (hist) hist[g * 256 + tid] = int32_t(sum);
      if (lut) lut[g * 256 + tid] = equalize_lut_entry(int32_t(sum), total);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// equalize_lut256: the equalize LUT of histograms already in memory (the
// JAX package's ops/histogram.py::equalize_lut for callers that hold a
// histogram: a pooled one, or one passed in).  One block of 256 threads per
// histogram through hist_count.cuh::equalize_lut_entry; the work is 256
// values, so launch latency bounds it.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
equalize_lut256_kernel(const int32_t* __restrict__ hist, uint8_t* __restrict__ lut,
                       int32_t total) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  lut[i] = equalize_lut_entry(hist[i], total);
}

// ---------------------------------------------------------------------------
// apply_lut256: replaces the JAX package's kernels/hist.py::
// apply_lut256_pallas for u8 tables (two 128-lane vreg gathers + select on the
// TPU).  Bound by device memory at 2 B/px.  The block stages its plane's table
// in shared memory and maps 16 B per thread per load; when input and output
// are not equally aligned it maps byte by byte.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t map4(const uint8_t* tab, uint32_t w) {
  return uint32_t(tab[w & 255u]) | (uint32_t(tab[(w >> 8) & 255u]) << 8) |
         (uint32_t(tab[(w >> 16) & 255u]) << 16) | (uint32_t(tab[w >> 24]) << 24);
}

__global__ void __launch_bounds__(kThreads)
apply_lut256_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ luts,
                    int64_t lut_stride, uint8_t* __restrict__ out, int64_t B, int64_t n) {
  __shared__ uint8_t tab[256];
  const int tid = threadIdx.x;
  const int64_t g = int64_t(blockIdx.x) * kThreads + tid;
  const int64_t stride = int64_t(gridDim.x) * kThreads;

  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous plane's reads of tab are done
    tab[tid] = luts[b * lut_stride + tid];
    __syncthreads();

    const uint8_t* p = x + b * n;
    uint8_t* q = out + b * n;
    Split s = split_plane(p, n);
    if ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) & 15) {
      s = {n, 0, n};  // mismatched alignment: the whole plane is "head"
    }
    const uint4* pv = reinterpret_cast<const uint4*>(p + s.head);
    uint4* qv = reinterpret_cast<uint4*>(q + s.head);
    for (int64_t i = g; i < s.nvec; i += stride) {
      const uint4 v = pv[i];
      qv[i] = make_uint4(map4(tab, v.x), map4(tab, v.y), map4(tab, v.z), map4(tab, v.w));
    }
    for (int64_t i = g; i < s.head; i += stride) q[i] = tab[p[i]];
    for (int64_t i = s.tail_start + g; i < n; i += stride) q[i] = tab[p[i]];
  }
}

// ---------------------------------------------------------------------------
// lut_multi_kernel<T>: K tables of 256 entries per plane applied to the same
// u8 planes, out[k][b] = luts[b][k][x[b]], entries of 1, 2 or 4 bytes copied
// bit for bit (u8; u16/i16; i32/f32 -- NaN payloads, infinities and
// subnormals included).  It serves apply_luts_multi, which replaces the JAX
// package's kernels/hist.py::apply_luts_multi_pallas (K one-hot products
// per pixel stripe), for K >= 2 and for u8 tables; K = 1 with wider tables
// goes to lut_wide_kernel below.  Each pixel is read once for up to
// kMaxTables tables; a larger K loops over chunks of tables.
// Bound by device memory: 1 B/px read plus K * sizeof(T) B/px written.  The
// block stages its plane's chunk of tables in dynamic shared memory (at most
// kMaxTables * 1 KB).  Each thread reads the 16 / sizeof(T) pixels whose
// outputs fill one 16-byte vector per table (a uint4 of u8 pixels for u8
// tables, a uint2 for 16-bit ones, a uint32 for 32-bit ones), so the lanes
// of a warp load and store neighbouring vectors: a first version that read
// 16 pixels per thread for every table type wrote f32 tables in four
// 16-byte stores 64 bytes apart per lane and ran K = 9 at 37 % of its bound.
// Where an output row is not as aligned as its input, the plane goes pixel
// by pixel.
// ---------------------------------------------------------------------------

constexpr int kMaxTables = 32;

// The table entries at the pixels of one input vector, as one 16-byte vector.
__device__ __forceinline__ uint4 map_vec(const uint8_t* tab, uint4 v) {
  return make_uint4(map4(tab, v.x), map4(tab, v.y), map4(tab, v.z), map4(tab, v.w));
}

__device__ __forceinline__ uint32_t pair16(const uint16_t* tab, uint32_t w, int shift) {
  return uint32_t(tab[(w >> shift) & 255u]) | (uint32_t(tab[(w >> (shift + 8)) & 255u]) << 16);
}

__device__ __forceinline__ uint4 map_vec(const uint16_t* tab, uint2 v) {
  return make_uint4(pair16(tab, v.x, 0), pair16(tab, v.x, 16), pair16(tab, v.y, 0),
                    pair16(tab, v.y, 16));
}

__device__ __forceinline__ uint4 map_vec(const uint32_t* tab, uint32_t w) {
  return make_uint4(tab[w & 255u], tab[(w >> 8) & 255u], tab[(w >> 16) & 255u], tab[w >> 24]);
}

// The input vector whose pixels' entries fill one 16-byte output vector.
template <typename T> struct InVec;
template <> struct InVec<uint8_t> { using type = uint4; };
template <> struct InVec<uint16_t> { using type = uint2; };
template <> struct InVec<uint32_t> { using type = uint32_t; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_multi_kernel(const uint8_t* __restrict__ x, const T* __restrict__ luts, int64_t plane_stride,
                 int K, T* __restrict__ out, int64_t B, int64_t n) {
  using In = typename InVec<T>::type;
  constexpr int64_t kPx = 16 / sizeof(T);  // pixels per vector
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int64_t g = int64_t(blockIdx.x) * kThreads + tid;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t kstride = B * n;  // elements from table k's output to table k+1's

  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* p = x + b * n;
    // a head up to the input's first 16-byte boundary, a body of whole
    // vectors, a tail
    const int64_t head0 = split_plane(p, n).head;
    const In* pv = reinterpret_cast<const In*>(p + head0);
    for (int c0 = 0; c0 < K; c0 += kMaxTables) {
      const int kc = min(kMaxTables, K - c0);
      __syncthreads();  // the previous chunk's reads of tab are done
      const T* src = luts + b * plane_stride + int64_t(c0) * 256;
      for (int i = tid; i < kc * 256; i += kThreads) tab[i] = src[i];
      __syncthreads();

      T* q = out + (int64_t(c0) * B + b) * n;
      int64_t head = head0, nvec = (n - head0) / kPx;
      if ((reinterpret_cast<uintptr_t>(q + head) | uintptr_t(kstride * int64_t(sizeof(T)))) & 15)
        head = n, nvec = 0;  // outputs not aligned like the input: the whole plane is "head"
      for (int64_t i = g; i < nvec; i += stride) {
        const In v = pv[i];
        for (int k = 0; k < kc; ++k)
          reinterpret_cast<uint4*>(q + k * kstride + head)[i] = map_vec(tab + k * 256, v);
      }
      for (int64_t i = g; i < head; i += stride) {
        const uint8_t v = p[i];
        for (int k = 0; k < kc; ++k) q[k * kstride + i] = tab[k * 256 + v];
      }
      for (int64_t i = head + nvec * kPx + g; i < n; i += stride) {
        const uint8_t v = p[i];
        for (int k = 0; k < kc; ++k) q[k * kstride + i] = tab[k * 256 + v];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// lut_wide_kernel<T>: one table of 256 entries of 2 or 4 bytes per plane (or
// one shared), out[b] = luts[b][x[b]], entries copied bit for bit.  It
// serves apply_lut256_wide, which replaces the JAX package's kernels/
// hist.py::apply_lut256_pallas for u16/i16/i32/f32 tables (on the TPU a
// one-hot bilinear product on the MXU at HIGHEST precision, exact only for
// integer entries below 2^24), and apply_luts_multi at K = 1.  Bound by
// device memory: 1 B/px read and sizeof(T) B/px written.
//
// Each lane loads one 16-byte vector of 16 pixels, so a warp's load covers
// 512 contiguous pixels, a chunk; its outputs are G = sizeof(T) 16-byte
// vectors.  The warp writes the chunk's 32 * G output vectors in G store
// instructions of 512 contiguous bytes: in store k, lane l writes output
// vector 32k + l, whose pixels are piece l % G (4-byte word, or 8-byte pair
// for 2-byte entries) of lane 32k / G + l / G's vector.  G shuffle rounds
// move the pieces: in round m, lane l fetches the piece for store
// (l % G + m) % G, and the lane it reads from, s, serves only it, with its
// piece (s / (32 / G) - m) % G; tests/test_torch_lut_lanes.py mirrors the
// schedule.  kWideLoads chunks are in flight per warp, so a lane has 64
// bytes of loads outstanding where lut_multi_kernel's K = 1 lanes had 4 or
// 8.  Heads, tails and planes whose output is not as aligned as their
// input go pixel by pixel.
// ---------------------------------------------------------------------------

// Chosen by A/B (tools/torch_hist_profile.py --ablut, PERF.md §6): 4 chunks
// in flight a warp and 8 blocks per SM of an H100 (132 SMs) in the grid
// beat 1, 2 or 8 chunks and 2, 4 or 16 blocks; streaming stores (__stcs)
// beat plain ones.
constexpr int kWideLoads = 4;             // chunks in flight per warp
constexpr int kWideGrid = 8 * 132;        // blocks in the grid, over all planes
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// Store the chunk whose 16 pixels this lane loaded (v), as output vectors
// [0, nout) of dst: G stores of 512 contiguous bytes.
__device__ __forceinline__ void wide_chunk(const uint32_t* tab, uint4 v, uint4* dst,
                                           int64_t nout, int lane) {
  const int a = lane >> 3, j = lane & 3;
  uint32_t got[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = (j + m) & 3;
    got[m] = __shfl_sync(0xffffffffu, pick4(v.x, v.y, v.z, v.w, (a - m) & 3),
                         8 * k + (lane >> 2));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = pick4(got[0], got[1], got[2], got[3], (k - j) & 3);
    if (32 * k + lane < nout) __stcs(dst + 32 * k + lane, map_vec(tab, w));
  }
}

__device__ __forceinline__ void wide_chunk(const uint16_t* tab, uint4 v, uint4* dst,
                                           int64_t nout, int lane) {
  const int a = lane >> 4, j = lane & 1;
  uint2 got[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int k = (j + m) & 1, src = 16 * k + (lane >> 1);
    const bool lo = ((a - m) & 1) == 0;
    got[m].x = __shfl_sync(0xffffffffu, lo ? v.x : v.z, src);
    got[m].y = __shfl_sync(0xffffffffu, lo ? v.y : v.w, src);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint2 w = ((k - j) & 1) == 0 ? got[0] : got[1];
    if (32 * k + lane < nout) __stcs(dst + 32 * k + lane, map_vec(tab, w));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lut_wide_kernel(const uint8_t* __restrict__ x, const T* __restrict__ luts, int64_t lut_stride,
                T* __restrict__ out, int64_t B, int64_t n) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "2- or 4-byte entries");
  constexpr int G = sizeof(T);
  __shared__ T tab[256];
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t g = int64_t(blockIdx.x) * kThreads + tid;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t warp0 = g >> 5, nwarps = stride >> 5;

  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous plane's reads of tab are done
    tab[tid] = luts[b * lut_stride + tid];
    __syncthreads();

    const uint8_t* p = x + b * n;
    T* q = out + b * n;
    Split s = split_plane(p, n);
    if (reinterpret_cast<uintptr_t>(q + s.head) & 15) s = {n, 0, n};  // pixel by pixel
    const uint4* pv = reinterpret_cast<const uint4*>(p + s.head);
    uint4* qv = reinterpret_cast<uint4*>(q + s.head);
    const int64_t nchunks = (s.nvec + 31) >> 5;
    for (int64_t c0 = warp0; c0 < nchunks; c0 += nwarps * kWideLoads) {
      uint4 v[kWideLoads];
#pragma unroll
      for (int u = 0; u < kWideLoads; ++u) {
        const int64_t i = ((c0 + u * nwarps) << 5) + lane;
        v[u] = i < s.nvec ? __ldg(pv + i) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kWideLoads; ++u) {
        const int64_t c = c0 + u * nwarps;  // the same for the whole warp
        if (c < nchunks)
          wide_chunk(tab, v[u], qv + c * 32 * G, (s.nvec - (c << 5)) * G, lane);
      }
    }
    for (int64_t i = g; i < s.head; i += stride) q[i] = tab[p[i]];
    for (int64_t i = s.tail_start + g; i < n; i += stride) q[i] = tab[p[i]];
  }
}

template <typename T>
int launch_lut_multi(const uint8_t* x, const void* luts, int64_t plane_stride, int64_t K,
                     void* out, int64_t B, int64_t n, cudaStream_t stream) {
  const dim3 grid(blocks_per_plane(n), unsigned(B < kMaxGridY ? B : kMaxGridY));
  const size_t smem = size_t(K < kMaxTables ? K : kMaxTables) * 256 * sizeof(T);
  lut_multi_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, static_cast<const T*>(luts), plane_stride, int(K), static_cast<T*>(out), B, n);
  return int(cudaGetLastError());
}

int launch_lut_bytes(const uint8_t* x, const void* luts, int64_t plane_stride, int64_t K,
                     void* out, int64_t B, int64_t n, int32_t elem_bytes, cudaStream_t stream) {
  if (B < 1 || n < 1 || K < 1 || K > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (K == 1 && elem_bytes > 1) {
    const int64_t grid_y = B < kMaxGridY ? B : kMaxGridY;
    // a wave of kWideGrid blocks over all planes, at most a chunk per warp
    const int64_t per_plane = std::max<int64_t>(
        1, std::min<int64_t>(kWideGrid / grid_y, ((n >> 9) + kWarps) / kWarps));
    const dim3 grid(static_cast<unsigned>(per_plane), static_cast<unsigned>(grid_y));
    if (elem_bytes == 2)
      lut_wide_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
          x, static_cast<const uint16_t*>(luts), plane_stride, static_cast<uint16_t*>(out), B, n);
    else if (elem_bytes == 4)
      lut_wide_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
          x, static_cast<const uint32_t*>(luts), plane_stride, static_cast<uint32_t*>(out), B, n);
    else
      return int(cudaErrorInvalidValue);
    return int(cudaGetLastError());
  }
  switch (elem_bytes) {
    case 1: return launch_lut_multi<uint8_t>(x, luts, plane_stride, K, out, B, n, stream);
    case 2: return launch_lut_multi<uint16_t>(x, luts, plane_stride, K, out, B, n, stream);
    case 4: return launch_lut_multi<uint32_t>(x, luts, plane_stride, K, out, B, n, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// x: [B, n] u8 contiguous; hist: [groups, 256] int32 and lut: [groups,
// 256] u8, each written whole where not null, row g from the planes b with
// b % groups == g (groups divides B; groups = B: one row a plane, the
// group's pixels below 2^31); a grid of blocks x grid_y (blocks per plane,
// and grid_y <= min(B, 65535): planes stride over it), from
// kernels/hist.py::hist256_plan.  With (B / groups) * blocks > 1, partial:
// [groups, (B / groups) * blocks, 256] u32 scratch and tickets: groups int32
// counters at 0 (left at 0), both unused (may be null) otherwise.
int launch_hist256(const uint8_t* x, int32_t* hist, uint8_t* lut, uint32_t* partial,
                   int32_t* tickets, int64_t B, int64_t n, int64_t groups, int64_t blocks,
                   int64_t grid_y, cudaStream_t stream) {
  if (B < 1 || n < 1 || groups < 1 || B % groups || n > 0x7fffffffLL / (B / groups) ||
      blocks < 1 || blocks > 0x7fffffffLL / (B / groups) || grid_y < 1 || grid_y > B ||
      grid_y > kMaxGridY ||
      ((B / groups) * blocks > 1 && (partial == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(grid_y));
  hist256_kernel<<<grid, kCountThreads, HistCounter::kSmemBytes, stream>>>(
      x, hist, lut, partial, tickets, B, n, groups);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ie_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// The histograms of x ([B, n] u8 contiguous) into hist ([B, 256] int32,
// written whole); grid, partial and tickets as for launch_hist256.
int ie_hist256(const uint8_t* x, int32_t* hist, int64_t B, int64_t n, int64_t blocks,
               int64_t grid_y, uint32_t* partial, int32_t* tickets, cudaStream_t stream) {
  if (hist == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist256(x, hist, nullptr, partial, tickets, B, n, B, blocks, grid_y, stream);
}

// cv2's equalizeHist LUTs into lut ([groups, 256] u8) in one launch, no
// histogram kept: row g from the pooled counts of the planes b with b %
// groups == g (groups = B: each plane's own LUT); grid, partial and
// tickets as for launch_hist256.
int ie_hist256_lut(const uint8_t* x, uint8_t* lut, int64_t B, int64_t n, int64_t groups,
                   int64_t blocks, int64_t grid_y, uint32_t* partial, int32_t* tickets,
                   cudaStream_t stream) {
  if (lut == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist256(x, nullptr, lut, partial, tickets, B, n, groups, blocks, grid_y, stream);
}

// hist: [B, 256] int32 with each row summing to total; lut: [B, 256] u8.
int ie_equalize_lut256(const int32_t* hist, uint8_t* lut, int64_t B, int64_t total,
                       cudaStream_t stream) {
  if (B < 1 || B > 0x7fffffffLL || total < 0 || total > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  equalize_lut256_kernel<<<unsigned(B), 256, 0, stream>>>(hist, lut, int32_t(total));
  return int(cudaGetLastError());
}

// x, out: [B, n] u8 contiguous; luts: row b at luts + b * lut_stride
// (lut_stride 0 shares one table, 256 gives one per plane).
int ie_apply_lut256(const uint8_t* x, const uint8_t* luts, int64_t lut_stride, uint8_t* out,
                    int64_t B, int64_t n, cudaStream_t stream) {
  if (B < 1 || n < 1) return int(cudaErrorInvalidValue);
  const dim3 grid(blocks_per_plane(n), unsigned(B < kMaxGridY ? B : kMaxGridY));
  apply_lut256_kernel<<<grid, kThreads, 0, stream>>>(x, luts, lut_stride, out, B, n);
  return int(cudaGetLastError());
}

// x: [B, n] u8 contiguous; luts: 256 entries of elem_bytes (2 or 4) bytes
// for plane b at luts + b * lut_stride entries (0: one shared table, 256:
// one per plane); out: [B, n] entries of the same size.
int ie_apply_lut256_wide(const uint8_t* x, const void* luts, int64_t lut_stride, void* out,
                         int64_t B, int64_t n, int32_t elem_bytes, cudaStream_t stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return int(cudaErrorInvalidValue);
  return launch_lut_bytes(x, luts, lut_stride, 1, out, B, n, elem_bytes, stream);
}

// x: [B, n] u8 contiguous; luts: [B, K, 256] entries of elem_bytes (1, 2 or
// 4) bytes; out: [K, B, n] entries of the same size.
int ie_apply_luts_multi(const uint8_t* x, const void* luts, int64_t K, void* out, int64_t B,
                        int64_t n, int32_t elem_bytes, cudaStream_t stream) {
  return launch_lut_bytes(x, luts, K * 256, K, out, B, n, elem_bytes, stream);
}

}  // extern "C"
