// median_unsharp_kernel<KM>: median KM x KM (KM = 3 or 5, replicate border)
// -> cv2's Q8 separable Gaussian over the median values (REFLECT_101 border)
// -> the unsharp epilogue addWeighted(med, 1+a, blur, -a), on u8 planes, in
// one pass over device memory.
//
// Replaces the JAX package's kernels/fused.py::median_unsharp_pallas
// (_fused_kernel: a host edge pad for the median, row and column fix-ups for
// the reflected Gaussian border, and an XLA chain for images smaller than
// the halos).  Here one route serves every shape, down to 1x1.
//
// What bounds it on this card: device memory at 2 B/px is the floor; the
// median's integer min/max issue bounds it, as it bounds median.cu, and the
// Gaussian stage comes next.  Design: one block per 32x128 output tile of
// one plane.
//  1. The input tile with a halo of pm + pg (median radius + Gaussian radius)
//     is staged in shared memory with clamped indices: the median's replicate
//     border, no host pad.
//  2. The median is computed into a shared u8 tile one Gaussian halo wider,
//     at REFLECT_101-mapped coordinates: entry (i, j) is the median at
//     (reflect101(y0 - pg + i, H), reflect101(x0 - pg + j, W)), from that
//     pixel's own replicate-clamped window.  Only the rows and columns that
//     the tile's in-plane outputs read are computed; each of their reflected
//     coordinates lies within pg of the tile (the tile is taller and wider
//     than any pg <= 15), so its window lies inside the staged input.
//     Entries whose mapped coordinate is their plain one (all of them but
//     those within pg of the plane's edges) run median.cu's tiled schedule
//     (median_networks.cuh), 2 x 4 entries per thread in two 16-bit lanes;
//     the others run the single-output schedule at their mapped coordinate.
//  3. sep_conv_u8's vertical int32 pass, horizontal pass and two-FMA
//     epilogue (conv.cu) run on the median tile.
//
// Arithmetic, pinned to ref/ops.py: Q8 taps, int32 accumulation, blur =
// (acc + 2^15) >> 16; t = fmul_rn(blur, beta); r = fmaf_rn(med, alpha, t);
// out = clamp(rint(r)), alpha = f32(1 + amount), beta = f32(-amount) from the
// caller.  For an integral amount this equals the JAX kernel's integer form
// med + a * (med - blur).

#include <cstdint>
#include <cuda_runtime.h>

#include "median_networks.cuh"
#include "reflect.cuh"

namespace {

constexpr int kMaxTaps = 31;
constexpr int kMaxR = kMaxTaps / 2;  // Gaussian radius
constexpr int kMaxPm = 2;            // median radius
constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kMedH = kTileH + 2 * kMaxR;
constexpr int kMedW = kTileW + 2 * kMaxR + 2;  // +2 keeps rows 4-byte aligned
constexpr int kInH = kMedH + 2 * kMaxPm;
constexpr int kInW = kMedW + 2 * kMaxPm;
constexpr int64_t kMaxGridY = 65535;  // (plane, row tile) pairs beyond it stride over gridDim.y

struct FusedParams {
  int32_t taps[kMaxTaps];
  int32_t kg;
  float alpha, beta;
};

template <int KM>
__global__ void __launch_bounds__(kThreads)
median_unsharp_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B,
                      int H, int W, FusedParams prm) {
  constexpr int pm = KM / 2;
  __shared__ int32_t taps[kMaxTaps];
  __shared__ __align__(16) uint8_t tin[kInH][kInW];
  __shared__ uint8_t med[kMedH][kMedW];
  __shared__ int32_t vacc[kTileH][kMedW];

  const int tid = threadIdx.x;
  const int kg = prm.kg, pg = kg >> 1, pad = pm + pg;
  const int x0 = blockIdx.x * kTileW;
  const int vw = min(kTileW, W - x0);  // in-plane output columns of this tile
  const int mw = vw + 2 * pg;          // median columns they read
  const int64_t nty = (H + kTileH - 1) / kTileH;

  if (tid < kMaxTaps) taps[tid] = prm.taps[tid];

  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int vh = min(kTileH, H - y0);  // in-plane output rows
    const int mh = vh + 2 * pg;
    const int64_t plane = b * int64_t(H) * W;

    // 1. input rows y0 - pad .. y0 + vh - 1 + pad, clamped into the plane
    for (int i = tid; i < (mh + 2 * pm) * (mw + 2 * pm); i += kThreads) {
      const int r = i / (mw + 2 * pm), c = i - r * (mw + 2 * pm);
      const int sy = min(max(y0 - pad + r, 0), H - 1);
      const int sx = min(max(x0 - pad + c, 0), W - 1);
      tin[r][c] = x[plane + int64_t(sy) * W + sx];
    }
    __syncthreads();

    // 2. the median at each reflected coordinate; tin[r][c] holds row
    // y0 - pad + r, so the window of row R starts at tin row R - y0 + pg.
    // 2a: entries at their plain coordinate, whose window starts at tin
    // (r, c): the tiled schedule, footprint (i, j) = tin (r0 + i, c0 + j)
    const int gw = (mw + 3) / 4;
    for (int i = tid; i < ((mh + 1) / 2) * gw; i += kThreads) {
      const int r0 = 2 * (i / gw), c0 = 4 * (i - (i / gw) * gw);
      uint32_t t[KM + 1][KM + 1];
#pragma unroll
      for (int r = 0; r < KM + 1; ++r) {
        uint32_t q[6];
        lane_pairs(&tin[r0 + r][c0], q);
#pragma unroll
        for (int j = 0; j < KM + 1; ++j) t[r][j] = q[j];
      }
      uint32_t o[2][2];
      median_tile<KM, LanesU16>(t, o);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int Y = y0 - pg + r0 + r;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int X = x0 - pg + c0 + e;
          if (r0 + r < mh && c0 + e < mw && Y >= 0 && Y < H && X >= 0 && X < W)
            med[r0 + r][c0 + e] = uint8_t(lane_output(o[r], e));
        }
      }
    }
    // 2b: entries within pg of the plane's edges, at their mapped coordinate
    if (y0 - pg < 0 || y0 + vh + pg > H || x0 - pg < 0 || x0 + vw + pg > W) {
      for (int i = tid; i < mh * mw; i += kThreads) {
        const int r = i / mw, c = i - r * mw;
        const int Y = y0 - pg + r, X = x0 - pg + c;
        const int R = reflect101(Y, H), C = reflect101(X, W);
        if (R == Y && C == X) continue;
        const uint8_t* w0 = &tin[R - y0 + pg][C - x0 + pg];
        int w[KM][KM];
#pragma unroll
        for (int dy = 0; dy < KM; ++dy) {
#pragma unroll
          for (int dx = 0; dx < KM; ++dx) w[dy][dx] = w0[dy * kInW + dx];
        }
        med[r][c] = uint8_t(median_single<KM, ScalarInt>(w));
      }
    }
    __syncthreads();

    // 3. vertical pass, horizontal pass and epilogue
    for (int i = tid; i < vh * mw; i += kThreads) {
      const int r = i / mw, c = i - r * mw;
      int32_t acc = 0;
      for (int j = 0; j < kg; ++j) acc += taps[j] * int32_t(med[r + j][c]);
      vacc[r][c] = acc;
    }
    __syncthreads();

    for (int i = tid; i < vh * vw; i += kThreads) {
      const int r = i / vw, c = i - r * vw;
      int32_t acc = 0;
      for (int j = 0; j < kg; ++j) acc += taps[j] * vacc[r][c + j];
      const int32_t blur = min((acc + 32768) >> 16, 255);
      const float t = __fmul_rn(__int2float_rn(blur), prm.beta);
      const float s = __fmaf_rn(__int2float_rn(med[r + pg][c + pg]), prm.alpha, t);
      out[plane + int64_t(y0 + r) * W + x0 + c] =
          uint8_t(__float2int_rn(fminf(fmaxf(rintf(s), 0.0f), 255.0f)));
    }
    __syncthreads();  // the next item overwrites tin, med and vacc
  }
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous.  median_ksize 3 or 5.  taps: a host array
// of kg Q8 taps (odd, <= 31), each >= 0 with a sum <= 256, used on both
// axes.  alpha = f32(1 + amount), beta = f32(-amount).
int ie_median_unsharp(const uint8_t* x, uint8_t* out, int64_t B, int64_t H, int64_t W,
                      int32_t median_ksize, const int32_t* taps, int32_t kg, float alpha,
                      float beta, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH || W > 0x7fffffffLL - kTileW ||
      (median_ksize != 3 && median_ksize != 5) || kg < 1 || kg > kMaxTaps || kg % 2 == 0)
    return int(cudaErrorInvalidValue);
  FusedParams prm = {};
  for (int j = 0; j < kg; ++j) prm.taps[j] = taps[j];
  prm.kg = kg;
  prm.alpha = alpha;
  prm.beta = beta;
  const int64_t items = B * ((H + kTileH - 1) / kTileH);
  const dim3 grid(unsigned((W + kTileW - 1) / kTileW),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  if (median_ksize == 3) {
    median_unsharp_kernel<3><<<grid, kThreads, 0, stream>>>(x, out, B, int(H), int(W), prm);
  } else {
    median_unsharp_kernel<5><<<grid, kThreads, 0, stream>>>(x, out, B, int(H), int(W), prm);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
