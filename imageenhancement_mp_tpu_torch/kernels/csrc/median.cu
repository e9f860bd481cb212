// median_kernel<T, K>: cv2.medianBlur with K in {3, 5} on u8, u16 or i16
// planes, replicate border, exact.
//
// Replaces the JAX package's kernels/median.py::median_blur_pallas
// (_median_kernel: double-buffered row stripes with a host edge-pad, taps
// widened to int32 on the VPU, the networks of kernels/networks.py).
//
// What bounds it on this card: integer min/max throughput, not memory.  The
// 5x5 selection below is 168 compare-exchanges, about 336 integer min/max per
// pixel, against 2 B/px (u8) of traffic; the 3x3 network is 19.  Design: one
// block per 16x64 output tile of one plane.  The block stages the tile and
// its K-1 halo in shared memory with clamped indices (the replicate border,
// so no host pad), then each thread takes its K*K taps from shared memory
// into registers and runs the network on them.  The networks are fully
// unrolled with compile-time indices, so the taps stay in registers; ptxas's
// report (nvcc.log) shows whether any spill.
//
// The networks are in median_networks.cuh, shared with fused.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "median_networks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kRowStep = kThreads / kTileW;       // 4 rows apart
constexpr int kRowsPerThread = kTileH / kRowStep;  // 4 outputs per thread
constexpr int64_t kMaxGridY = 65535;  // (plane, row tile) pairs beyond it stride over gridDim.y

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
median_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t B, int H, int W) {
  constexpr int R = K / 2;
  constexpr int kInH = kTileH + 2 * R, kInW = kTileW + 2 * R;
  __shared__ T tile[kInH][kInW];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int c = tid % kTileW, r0 = tid / kTileW;
  const int xx = x0 + c;
  const int64_t nty = (H + kTileH - 1) / kTileH;

  // (plane, row tile) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int64_t plane = b * int64_t(H) * W;
    for (int i = tid; i < kInH * kInW; i += kThreads) {
      const int rr = i / kInW, cc = i - rr * kInW;
      const int sy = min(max(y0 - R + rr, 0), H - 1);
      const int sx = min(max(x0 - R + cc, 0), W - 1);
      tile[rr][cc] = x[plane + int64_t(sy) * W + sx];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = r0 + k * kRowStep;
      const int y = y0 + r;
      if (y < H && xx < W) {
        const int m = median_window<K>(&tile[r][c], kInW);
        out[plane + int64_t(y) * W + xx] = T(m);
      }
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
