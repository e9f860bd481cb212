// sep_conv_u8: cv2's u8 fixed-point separable Gaussian with REFLECT_101
// borders, an optional per-plane 256-entry LUT applied to the pixels as they
// are loaded, and an optional unsharp epilogue addWeighted(src, 1+a, blur, -a).
//
// Replaces the JAX package's kernels/conv2.py::sep_conv5_wide (the wide
// layout: packed pixel pairs, banded bf16 MXU pass, vreg-gather LUT) and
// the JAX package's kernels/conv.py::_sep_conv_planes (any shape, host
// pad) with one kernel for every shape and every odd ksize <= 31 per axis.
//
// What bounds it on this card: device memory at 2 B/px is the floor; this
// first version is bounded by shared-memory traffic and integer multiply-adds
// (kv + kh per pixel, int32).  Design: one block per 32x128 output tile of one
// plane.  The block loads its input tile with the halo into shared memory,
// computing REFLECT_101 indices itself (no host pad, repeated reflection when
// the halo is deeper than the plane), applies the LUT from shared memory on
// the way in, runs the vertical pass into an int32 shared buffer, then the
// horizontal pass and the epilogue in registers.
//
// Arithmetic, pinned to ref/ops.py: Q8 taps, int32 accumulation
// (255 * 65536 + 2^15 < 2^31), blur = (acc + 2^15) >> 16.  The epilogue is
// cv2's two single-rounded f32 FMAs for every amount:
//   t = fmul_rn(blur, beta); r = fmaf_rn(src, alpha, t); out = clamp(rint(r))
// with alpha = f32(1 + amount), beta = f32(-amount) computed by the caller.
// It is right for negative amounts too.

#include <cstdint>
#include <cuda_runtime.h>

#include "reflect.cuh"

namespace {

constexpr int kMaxTaps = 31;
constexpr int kMaxR = kMaxTaps / 2;
constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kInH = kTileH + 2 * kMaxR;
constexpr int kInW = kTileW + 2 * kMaxR + 2;  // +2 keeps rows 4-byte aligned
constexpr int64_t kMaxGridY = 65535;  // (plane, row tile) pairs beyond it stride over gridDim.y

struct ConvParams {
  int32_t tv[kMaxTaps];
  int32_t th[kMaxTaps];
  int32_t kv, kh;
  int32_t unsharp;  // 0: write blur; 1: addWeighted epilogue
  float alpha, beta;
};

__global__ void __launch_bounds__(kThreads)
sep_conv_u8_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B, int H,
                   int W, const uint8_t* __restrict__ luts, ConvParams prm) {
  __shared__ uint8_t lut[256];
  __shared__ int32_t tv[kMaxTaps], th[kMaxTaps];
  __shared__ uint8_t tile[kInH][kInW];
  __shared__ int32_t vacc[kTileH][kInW];

  const int tid = threadIdx.x;
  const int kv = prm.kv, kh = prm.kh;
  const int rv = kv >> 1, rh = kh >> 1;
  const int x0 = blockIdx.x * kTileW;
  const int in_h = kTileH + 2 * rv, in_w = kTileW + 2 * rh;
  const int64_t nty = (H + kTileH - 1) / kTileH;

  if (tid < kMaxTaps) {
    tv[tid] = prm.tv[tid];
    th[tid] = prm.th[tid];
  }

  // (plane, row tile) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int64_t plane = b * int64_t(H) * W;
    if (luts != nullptr) lut[tid] = luts[b * 256 + tid];
    __syncthreads();

    // Input tile with halo; rows and columns past the plane's edge are
    // reflected like the halo, read and never written.
    for (int i = tid; i < in_h * in_w; i += kThreads) {
      const int r = i / in_w, c = i - r * in_w;
      const int sy = reflect101(y0 - rv + r, H);
      const int sx = reflect101(x0 - rh + c, W);
      const uint8_t v = x[plane + int64_t(sy) * W + sx];
      tile[r][c] = luts != nullptr ? lut[v] : v;
    }
    __syncthreads();

    for (int i = tid; i < kTileH * in_w; i += kThreads) {
      const int r = i / in_w, c = i - r * in_w;
      int32_t acc = 0;
      for (int j = 0; j < kv; ++j) acc += tv[j] * int32_t(tile[r + j][c]);
      vacc[r][c] = acc;
    }
    __syncthreads();

    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW, c = i % kTileW;
      const int y = y0 + r, xx = x0 + c;
      if (y >= H || xx >= W) continue;
      int32_t acc = 0;
      for (int j = 0; j < kh; ++j) acc += th[j] * vacc[r][c + j];
      const int32_t blur = min((acc + 32768) >> 16, 255);
      int32_t res = blur;
      if (prm.unsharp) {
        const float t = __fmul_rn(__int2float_rn(blur), prm.beta);
        const float s = __fmaf_rn(__int2float_rn(tile[r + rv][c + rh]), prm.alpha, t);
        res = __float2int_rn(fminf(fmaxf(rintf(s), 0.0f), 255.0f));
      }
      out[plane + int64_t(y) * W + xx] = uint8_t(res);
    }
    __syncthreads();  // the next item overwrites lut and tile
  }
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous.  taps_v/taps_h: host arrays of kv/kh Q8
// taps (odd, <= 31), each >= 0 with a sum <= 256.  luts: [B, 256] u8 device
// table or null.  unsharp: 0 writes the blur, 1 the addWeighted epilogue.
int ie_sep_conv_u8(const uint8_t* x, uint8_t* out, int64_t B, int64_t H, int64_t W,
                   const int32_t* taps_v, int32_t kv, const int32_t* taps_h, int32_t kh,
                   const uint8_t* luts, int32_t unsharp, float alpha, float beta,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH ||
      W > 0x7fffffffLL - kTileW || kv < 1 || kv > kMaxTaps || kh < 1 || kh > kMaxTaps ||
      kv % 2 == 0 || kh % 2 == 0)
    return int(cudaErrorInvalidValue);
  ConvParams prm = {};
  for (int j = 0; j < kv; ++j) prm.tv[j] = taps_v[j];
  for (int j = 0; j < kh; ++j) prm.th[j] = taps_h[j];
  prm.kv = kv;
  prm.kh = kh;
  prm.unsharp = unsharp;
  prm.alpha = alpha;
  prm.beta = beta;
  const int64_t items = B * ((H + kTileH - 1) / kTileH);
  const dim3 grid(unsigned((W + kTileW - 1) / kTileW),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  sep_conv_u8_kernel<<<grid, kThreads, 0, stream>>>(x, out, B, int(H), int(W), luts, prm);
  return int(cudaGetLastError());
}

}  // extern "C"
