// median_kernel<T, K>: cv2.medianBlur with K in {3, 5} on u8, u16 or i16
// planes, replicate border, exact.
//
// Replaces the JAX package's kernels/median.py::median_blur_pallas
// (_median_kernel: double-buffered row stripes with a host edge-pad, taps
// widened to int32 on the VPU, the networks of kernels/networks.py).
//
// What bounds it on this card: integer min/max issue, not memory (2 B/px for
// u8).  The TPU's forgetful selection, 168 compare-exchanges per pixel with
// nothing shared between neighbours, is replaced by the schedules of
// median_networks.cuh (generated and proved by kernels/median_networks.py):
// a thread computes 2 x 2 outputs in each of two 16-bit lanes, sorting and
// merging the column cores its windows share once; at K = 5 that is 268
// operations for 8 pixels, one VIMNMX (or VIMNMX3) instruction each.
//
// Design: one block of 16 x 16 threads per 32 x 64 output tile of one plane.
// The block stages the tile and its K - 1 halo in shared memory with clamped
// indices (the replicate border, so no host pad), four elements per thread
// and step.  Each thread reads its (K + 1)-row footprint 32 (u8) or 64
// (16-bit) bits at a time, forms the lane pairs with byte permutes, runs the
// tile schedule and stores its 2 x 4 outputs, one vector store per row where
// the row is whole and aligned.  Ragged edges are masked; every shape takes
// this route.  (plane, row tile) items stride over a capped gridDim.y, so
// neither planes nor rows are capped.

#include <cstdint>
#include <cuda_runtime.h>

#include "median_networks.cuh"

namespace {

constexpr int kThreadsX = 16, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileW = 4 * kThreadsX;  // 64 output columns, 4 per thread
constexpr int kTileH = 2 * kThreadsY;  // 32 output rows, 2 per thread
constexpr int kPitch = kTileW + 4;     // the K - 1 <= 4 halo; a multiple of 4 elements
constexpr int64_t kMaxGridY = 65535;   // (plane, row tile) pairs beyond it stride over gridDim.y

// u8 (widened) and u16 order as unsigned 16-bit lanes, i16 as signed ones
template <typename T>
struct LanesOf {
  using type = LanesU16;
};
template <>
struct LanesOf<int16_t> {
  using type = LanesS16;
};

// four staged elements in one shared-memory store
__device__ __forceinline__ void store_group(uint8_t* dst, const uint8_t (&v)[4]) {
  *reinterpret_cast<uint32_t*>(dst) =
      uint32_t(v[0]) | uint32_t(v[1]) << 8 | uint32_t(v[2]) << 16 | uint32_t(v[3]) << 24;
}

template <typename T16>
__device__ __forceinline__ void store_group(T16* dst, const T16 (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(uint32_t(uint16_t(v[0])) | uint32_t(uint16_t(v[1])) << 16,
                 uint32_t(uint16_t(v[2])) | uint32_t(uint16_t(v[3])) << 16);
}

// the four outputs of one row of a thread's tile: columns 0, 1 in lane 0 of
// o[0], o[1] and columns 2, 3 in lane 1; n of them lie inside the plane
__device__ __forceinline__ void store_row(uint8_t* dst, const uint32_t (&o)[2], int n) {
  const uint32_t w = __byte_perm(o[0], o[1], 0x6240);
  if (n >= 4 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
    for (int e = 0; e < 4 && e < n; ++e) dst[e] = uint8_t(w >> (8 * e));
  }
}

template <typename T16>
__device__ __forceinline__ void store_row(T16* dst, const uint32_t (&o)[2], int n) {
  const uint32_t lo = __byte_perm(o[0], o[1], 0x5410), hi = __byte_perm(o[0], o[1], 0x7632);
  if (n >= 4 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  } else {
    for (int e = 0; e < 4 && e < n; ++e) dst[e] = T16((e < 2 ? lo : hi) >> (16 * (e & 1)));
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
median_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t B, int H, int W) {
  constexpr int R = K / 2;
  constexpr int kInH = kTileH + 2 * R;
  constexpr int kGroups = kPitch / 4;
  using V = typename LanesOf<T>::type;
  __shared__ __align__(16) T tile[kInH][kPitch];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int x0 = blockIdx.x * kTileW;
  const int xx = x0 + 4 * tx;
  const int64_t nty = (H + kTileH - 1) / kTileH;

  // (plane, row tile) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int64_t plane = b * int64_t(H) * W;
    // tile[rr][cc] holds row y0 - R + rr, column x0 - R + cc, clamped
    for (int i = tid; i < kInH * kGroups; i += kThreads) {
      const int rr = i / kGroups, g = i - rr * kGroups;
      const T* row = x + plane + int64_t(min(max(y0 - R + rr, 0), H - 1)) * W;
      const int c0 = x0 - R + 4 * g;
      T v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = row[min(max(c0 + e, 0), W - 1)];
      store_group(&tile[rr][4 * g], v);
    }
    __syncthreads();

    // outputs (y0 + 2 ty + r, xx + c): window rows 2 ty + r .. and columns
    // 4 tx + c .. of the tile, so footprint (r, j) is tile (2 ty + r, 4 tx + j)
    typename V::T t[K + 1][K + 1];
#pragma unroll
    for (int r = 0; r < K + 1; ++r) {
      uint32_t q[6];
      lane_pairs(&tile[2 * ty + r][4 * tx], q);
#pragma unroll
      for (int j = 0; j < K + 1; ++j) t[r][j] = q[j];
    }
    uint32_t o[2][2];
    median_tile<K, V>(t, o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = y0 + 2 * ty + r;
      if (y < H && xx < W) store_row(out + plane + int64_t(y) * W + xx, o[r], W - xx);
    }
    __syncthreads();  // the next item overwrites the tile
  }
}

template <typename T>
int launch_median(const void* x, void* out, int64_t B, int64_t H, int64_t W, int32_t ksize,
                  cudaStream_t stream) {
  const int64_t items = B * ((H + kTileH - 1) / kTileH);
  const dim3 grid(unsigned((W + kTileW - 1) / kTileW),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (ksize == 3) {
    median_kernel<T, 3><<<grid, kThreads, 0, stream>>>(xp, op, B, int(H), int(W));
  } else {
    median_kernel<T, 5><<<grid, kThreads, 0, stream>>>(xp, op, B, int(H), int(W));
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [B, H, W] contiguous; dtype 0 = u8, 1 = u16, 2 = i16; ksize 3 or 5.
int ie_median(const void* x, void* out, int64_t B, int64_t H, int64_t W, int32_t dtype,
              int32_t ksize, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || W > 0x7fffffffLL - kTileW || H > 0x7fffffffLL - kTileH ||
      (ksize != 3 && ksize != 5))
    return int(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_median<uint8_t>(x, out, B, H, W, ksize, stream);
    case 1: return launch_median<uint16_t>(x, out, B, H, W, ksize, stream);
    case 2: return launch_median<int16_t>(x, out, B, H, W, ksize, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
