// warp_gather_u8: bilinear or nearest sampling of u8 planes at an f32
// coordinate field shared by all planes, the sampler of warpAffine,
// warpPerspective, warpPolar and remap on u8 (cv2 5.0's float path).
//
// Replaces the JAX package's kernels/warp.py::_run (gather_bilinear_pallas,
// gather_nearest_pallas; pallas_call at :241).  That kernel DMAs a source
// window per output block, packs each 2x2 tap quad into one i32 and selects
// taps through a chain of take_along_axis candidates, with a window budget
// (WindowTooLarge) that sends large scales back to XLA, and handles the
// constant border outside the kernel (an overlay plus an XLA fix-up of the
// partial band).  On Hopper a gather is a plain load, so one simple kernel
// takes every shape, scale and map, and each tap reads the border value
// itself.  It computes the function of the JAX XLA path (ops/warp.py
// _gather + _bilinear_fma_device), which the TPU kernel equals bitwise:
//   X = clip(sx, -2e9, 2e9), Y likewise (keeps the int casts in range)
//   linear:  ix0 = floor(X), tx = X - floor(X) (exact), likewise y;
//            p_ij = tap(iy0 + i, ix0 + j);
//            top = fma(tx, p01 - p00, p00), bot = fma(tx, p11 - p10, p10),
//            r = fma(ty, bot - top, top), each a single-rounded f32 FMA;
//            out = clip(rint(r), 0, 255)   (half to even)
//   nearest: out = tap(rint(Y), rint(X))
//   tap(y, x) = x[clamp(y), clamp(x)] (replicate), or the border value
//               where (y, x) lies outside the plane (constant).
// Built with -fmad=false and no fast math; each rounding is written out.
//
// What bounds it on this card: bytes.  Per output pixel it reads 8 B of
// map once for all planes and writes 1 B per plane; the taps come through
// L1/L2 (a 4K u8 plane is 8.3 MB, the L2 50 MB), so device memory sees each
// source byte about once.  Design: one thread per output pixel, threads on
// consecutive pixels (coalesced map loads and stores), each thread looping
// over up to kPlanesPerItem planes so the map is read once for them;
// (plane group, pixel) pairs stride over a capped grid, so neither planes
// nor rows are capped, with 64-bit flat offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanesPerItem = 8;
constexpr int64_t kMaxGridX = 1 << 20;  // pixel blocks beyond it stride
constexpr int64_t kMaxGridY = 65535;    // plane groups beyond it stride
constexpr float kCoordLimit = 2e9f;     // exact in f32

__device__ __forceinline__ float clip_coord(float v) {
  return fminf(fmaxf(v, -kCoordLimit), kCoordLimit);
}

__device__ __forceinline__ int tap(const uint8_t* __restrict__ plane, int y, int x, int H, int W,
                                   int replicate, int bval) {
  if (!replicate && (y < 0 || y >= H || x < 0 || x >= W)) return bval;
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return plane[int64_t(y) * W + x];
}

__global__ void __launch_bounds__(kThreads)
warp_gather_u8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sx,
                      const float* __restrict__ sy, uint8_t* __restrict__ out, int64_t B, int H,
                      int W, int64_t npix, int nearest, int replicate, int bval) {
  const int64_t ngroups = (B + kPlanesPerItem - 1) / kPlanesPerItem;
  const int64_t plane_px = int64_t(H) * W;
  for (int64_t g = blockIdx.y; g < ngroups; g += gridDim.y) {
    const int64_t b0 = g * kPlanesPerItem;
    const int nb = B - b0 < kPlanesPerItem ? int(B - b0) : kPlanesPerItem;
    for (int64_t p = int64_t(blockIdx.x) * kThreads + threadIdx.x; p < npix;
         p += int64_t(gridDim.x) * kThreads) {
      const float X = clip_coord(sx[p]);
      const float Y = clip_coord(sy[p]);
      if (nearest) {
        const int ix = __float2int_rn(X), iy = __float2int_rn(Y);
        for (int i = 0; i < nb; ++i) {
          const int64_t b = b0 + i;
          out[b * npix + p] = uint8_t(tap(x + b * plane_px, iy, ix, H, W, replicate, bval));
        }
        continue;
      }
      const float fx = floorf(X), fy = floorf(Y);
      const int ix0 = int(fx), iy0 = int(fy);  // |X| <= 2e9: in range, and +1 too
      const float tx = __fsub_rn(X, fx), ty = __fsub_rn(Y, fy);
      for (int i = 0; i < nb; ++i) {
        const int64_t b = b0 + i;
        const uint8_t* plane = x + b * plane_px;
        const float p00 = float(tap(plane, iy0, ix0, H, W, replicate, bval));
        const float p01 = float(tap(plane, iy0, ix0 + 1, H, W, replicate, bval));
        const float p10 = float(tap(plane, iy0 + 1, ix0, H, W, replicate, bval));
        const float p11 = float(tap(plane, iy0 + 1, ix0 + 1, H, W, replicate, bval));
        const float top = __fmaf_rn(tx, __fsub_rn(p01, p00), p00);
        const float bot = __fmaf_rn(tx, __fsub_rn(p11, p10), p10);
        const float r = rintf(__fmaf_rn(ty, __fsub_rn(bot, top), top));
        out[b * npix + p] = uint8_t(fminf(fmaxf(r, 0.0f), 255.0f));
      }
    }
  }
}

}  // namespace

extern "C" {

// x: [B, H, W] u8 contiguous; sx, sy: [oh, ow] f32 contiguous, shared by all
// planes; out: [B, oh, ow] u8 contiguous; nearest 0/1; replicate 0/1 (0 =
// constant border with value bval, 0..255).
int ie_warp_gather_u8(const uint8_t* x, const float* sx, const float* sy, uint8_t* out, int64_t B,
                      int64_t H, int64_t W, int64_t oh, int64_t ow, int32_t nearest,
                      int32_t replicate, int32_t bval, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL || W > 0x7fffffffLL || oh < 1 || ow < 1 ||
      (nearest != 0 && nearest != 1) || (replicate != 0 && replicate != 1) || bval < 0 ||
      bval > 255)
    return int(cudaErrorInvalidValue);
  const int64_t npix = oh * ow;
  const int64_t blocks = (npix + kThreads - 1) / kThreads;
  const int64_t groups = (B + kPlanesPerItem - 1) / kPlanesPerItem;
  const dim3 grid(unsigned(blocks < kMaxGridX ? blocks : kMaxGridX),
                  unsigned(groups < kMaxGridY ? groups : kMaxGridY));
  warp_gather_u8_kernel<<<grid, kThreads, 0, stream>>>(x, sx, sy, out, B, int(H), int(W), npix,
                                                       nearest, replicate, bval);
  return int(cudaGetLastError());
}

}  // extern "C"
