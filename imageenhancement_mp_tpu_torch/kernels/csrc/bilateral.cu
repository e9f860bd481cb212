// bilateral_gray_kernel: cv2.bilateralFilter on u8 gray planes, REFLECT_101
// border, any disc radius 1..25, exact against ref/ops.py::bilateral_filter.
//
// Replaces the JAX package's kernels/bilateral.py::bilateral_gray_pallas
// (_bilateral_jit: row stripes with host-built halo side arrays, lane rolls
// plus recomputed 128-lane edge strips, the f32 LUT through a two-vreg
// dynamic-gather chain; W % 128 == 0, H % 8 == 0, radius <= 8 only, the rest
// on a per-offset XLA loop).  Here one kernel takes every shape and radius.
//
// What bounds it on this card: the disc walk, not memory.  At d = 9 a pixel
// visits 49 offsets, each a shared-memory byte load, a shared-memory LUT
// gather and five f32 operations, against 2 B/px of device traffic.  Design:
// one block per 16x64 output tile of one plane.  The block stages the tile
// and its radius-deep halo in shared memory as bytes, through reflect101
// (numpy's repeated reflection, so planes smaller than the disc are exact),
// with the 256-entry f32 colour LUT and the disc beside it: each offset
// (i, j, w0) as the flat shared-memory delta i * in_w + j and its f32 space
// weight, in the disc order of ops/bilateral.py::bilateral_offsets.  Each
// thread keeps num and den of four outputs (rows r0, r0+4, r0+8, r0+12 of
// one column) in registers and walks the disc once for all four.
//
// Arithmetic, per offset, in the disc order of ref/ops.py:909-919, each
// operation rounded once (built with -fmad=false; the intrinsics state it):
//   w = w0 * lut[|v - c|];  num = num + v * w;  den = den + w
// then out = sat_u8(rint(num / den)) with an IEEE division (the TPU's
// divide is about 2 ulp, which is why K10 is +-1 there).

#include <cstdint>
#include <cuda_runtime.h>

#include "reflect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kRowStep = kThreads / kTileW;        // 4 rows apart
constexpr int kRowsPerThread = kTileH / kRowStep;  // 4 outputs per thread
constexpr int kMaxR = 25;                          // kernels/bilateral.py MAX_RADIUS
constexpr int kMaxOffsets = (2 * kMaxR + 1) * (2 * kMaxR + 1);
constexpr int64_t kMaxGridY = 65535;  // (plane, row tile) pairs beyond it stride over gridDim.y

__global__ void __launch_bounds__(kThreads)
bilateral_gray_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B, int H,
                      int W, const float* __restrict__ offsets, int n,
                      const float* __restrict__ lut_g, int R) {
  __shared__ float lut[256];
  __shared__ int delta[kMaxOffsets];
  __shared__ float w0s[kMaxOffsets];
  __shared__ uint8_t tile[(kTileH + 2 * kMaxR) * (kTileW + 2 * kMaxR)];

  const int tid = threadIdx.x;
  const int in_w = kTileW + 2 * R, in_h = kTileH + 2 * R;
  const int x0 = blockIdx.x * kTileW;
  const int c = tid % kTileW, r0 = tid / kTileW;
  const int xx = x0 + c;
  const int64_t nty = (H + kTileH - 1) / kTileH;

  lut[tid] = lut_g[tid];
  for (int k = tid; k < n; k += kThreads) {
    // clamped to the radius, so no table can read outside the tile
    const int i = min(max(__float2int_rn(offsets[3 * k]), -R), R);
    const int j = min(max(__float2int_rn(offsets[3 * k + 1]), -R), R);
    delta[k] = i * in_w + j;
    w0s[k] = offsets[3 * k + 2];
  }

  // (plane, row tile) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int64_t plane = b * int64_t(H) * W;
    for (int i = tid; i < in_h * in_w; i += kThreads) {
      const int rr = i / in_w, cc = i - rr * in_w;
      const int sy = reflect101(y0 - R + rr, H);
      const int sx = reflect101(x0 - R + cc, W);
      tile[i] = x[plane + int64_t(sy) * W + sx];
    }
    __syncthreads();

    int base[kRowsPerThread], ctr[kRowsPerThread];
    float num[kRowsPerThread], den[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      base[q] = (r0 + q * kRowStep + R) * in_w + c + R;
      ctr[q] = tile[base[q]];
      num[q] = 0.0f;
      den[q] = 0.0f;
    }
    for (int k = 0; k < n; ++k) {
      const int dk = delta[k];
      const float w0 = w0s[k];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int v = tile[base[q] + dk];
        const float w = __fmul_rn(w0, lut[abs(v - ctr[q])]);
        num[q] = __fadd_rn(num[q], __fmul_rn(__int2float_rn(v), w));
        den[q] = __fadd_rn(den[q], w);
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int y = y0 + r0 + q * kRowStep;
      if (y < H && xx < W) {
        const float o = rintf(__fdiv_rn(num[q], den[q]));
        out[plane + int64_t(y) * W + xx] = uint8_t(__float2int_rn(fminf(fmaxf(o, 0.0f), 255.0f)));
      }
    }
    __syncthreads();  // the next item overwrites the tile
  }
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous.  offsets: [n, 3] f32 (i, j, w0) in disc
// order with |i|, |j| <= radius and 1 <= n <= (2 * radius + 1)^2; lut: [256]
// f32 colour weights; radius 1..25.  All on the device.
int ie_bilateral(const uint8_t* x, uint8_t* out, int64_t B, int64_t H, int64_t W,
                 const float* offsets, int32_t n, const float* lut, int32_t radius,
                 cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH || W > 0x7fffffffLL - kTileW ||
      radius < 1 || radius > kMaxR || n < 1 || n > (2 * radius + 1) * (2 * radius + 1))
    return int(cudaErrorInvalidValue);
  const int64_t items = B * ((H + kTileH - 1) / kTileH);
  const dim3 grid(unsigned((W + kTileW - 1) / kTileW),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  bilateral_gray_kernel<<<grid, kThreads, 0, stream>>>(x, out, B, int(H), int(W), offsets, n, lut,
                                                       radius);
  return int(cudaGetLastError());
}

}  // extern "C"
