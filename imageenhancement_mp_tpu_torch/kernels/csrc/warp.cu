// warp_gather_u8: bilinear or nearest sampling of u8 planes at a coordinate
// field shared by all planes, the sampler of warpAffine, warpPerspective,
// warpPolar and remap on u8 (cv2 5.0's float path).
//
// Replaces the JAX package's kernels/warp.py::_run (gather_bilinear_pallas,
// gather_nearest_pallas; pallas_call at :241).  That kernel DMAs a source
// window per output block (window_plan), packs each 2x2 tap quad into one
// i32 and selects taps through a chain of take_along_axis candidates, with a
// window budget (WindowTooLarge) that sends large scales back to XLA, and
// handles the constant border outside the kernel (an overlay plus an XLA
// fix-up of the partial band).  Here one kernel family takes every shape,
// scale and map, and each tap reads the border value itself.
//
// Coordinate sources (a template parameter):
//  * maps: f32 sx, sy [oh, ow] (remap, warpPolar);
//  * affine: the two linear forms a*x + b*y + c of the f32 inverse matrix,
//    cv2 5.0's hybrid law (ref/ops.py::warp_affine_coords_f32, which
//    kernels/warp.py::affine_field reproduces with torch ops):
//      body (x < ow - ow % 16):  crow = f32(f32(b*y) + c),
//                                s = f32(f64(a*x) + crow)
//      tail (last ow % 16):      s = f32(f32(f64(a*x) + f32(b*y)) + c)
//    where f64(a*x) is the f64 product (exact below x = 2^29) and each
//    operation rounds once;
//  * perspective: three such forms nx, ny, den, then sx = nx / den (one IEEE
//    f32 division; den == 0 gives 0), sy likewise.
// Each pixel's coordinates are computed once for all planes of its group, so
// the matrix routes read no field from device memory.  On the matrix routes
// output row `row` takes y = row0 + row: a row-sharded warp (each shard
// rendering rows [row0, row0 + oh) of the frame's output) gets the rows of
// the unsharded call.
//
// The sampling law is the JAX XLA path's (ops/warp.py _gather +
// _bilinear_fma_device), which the TPU kernel equals bitwise:
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
// A byte becomes a float as the word 0x4B000000 | v minus 2^23; a result r
// becomes a byte as the low bits of r + 2^23 (round half to even); r needs
// no clip, as it lies between two taps (each lerp moves from one value
// toward another by a fraction below 1, and rounding keeps it between
// them); a coordinate below 2^22 gets its floor or rint through 1.5 * 2^23.
// All exact, with no I2F or F2I: the H100's conversion unit (16 per clock
// and SM) is left to the f64 -> f32 roundings of the field.
//
// What bounds it on this card: per-pixel instruction issue.  The bytes bound
// (source once, output once, and on the maps route 8 B of map per output
// pixel) is 0.0099 ms at 2x2160x3840 (0.0297 with maps), but with the tap
// loads and the coordinate arithmetic taken out the kernel still took
// 0.0531 of its 0.0783 ms there, and the identity costs about what a 15
// degree rotation costs: the blend, addresses and stores of a pixel are
// some 50 instructions (tools/torch_warp_profile.py --ab; PERF.md).
// Design: on the matrix routes a thread takes 4 outputs of one row, 16
// columns apart, and a warp 16 x 2 lanes, so the 32 taps of one load
// instruction fall on a compact patch of output (and on few source rows
// under any rotation); a thread loads every tap of its 4 pixels before the
// first blend, 16 loads in flight, from unclamped addresses where all 4
// pixels' taps lie inside the plane (one compare per pixel), else each tap
// clamped and, under the constant border, replaced by the border value.  On
// the maps route a thread takes one pixel and a warp 32 adjacent pixels of
// a row, the parent's layout: the matrix route's layout took 0.3175 ms on
// random maps against 0.2684 (--ab).  Staging the tiles' source windows in
// shared memory (per block or per warp, the TPU kernel's DMA'd window) lost
// every A/B the port's probes made.  (plane group, tile) pairs stride over a
// capped grid, so neither planes nor rows are capped, with 64-bit plane
// offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanesPerItem = 8;
constexpr int64_t kMaxGridX = 1 << 20;  // tiles beyond it stride
constexpr int64_t kMaxGridY = 65535;    // plane groups beyond it stride
constexpr float kCoordLimit = 2e9f;     // exact in f32
constexpr uint32_t kMagic = 0x4B000000u;  // the bits of f32 2^23
constexpr float kTwo23 = 8388608.0f;
constexpr float kRound = 12582912.0f;     // 1.5 * 2^23, bits 0x4B400000
constexpr float kSmall = 4194304.0f;      // 2^22: below it, kRound gives the integer

enum Source { kMaps = 0, kAffine = 1, kPerspective = 2 };

// lanes: kLX across a row by 32 / kLX rows; a thread takes kPx outputs of
// one row, kLX columns apart; the 8 warps of a block are stacked
template <int kSource>
struct Layout {
  static constexpr int kLX = kSource == kMaps ? 32 : 16;
  static constexpr int kPx = kSource == kMaps ? 1 : 4;
  static constexpr int kMinBlocks = kSource == kMaps ? 6 : 3;  // 40 / 80 registers
  static constexpr int kTileW = kLX * kPx;
  static constexpr int kTileH = kWarps * (32 / kLX);
};

struct Matrix {  // the f32 inverse matrix, row-major: 2x3 (affine) or 3x3
  float m[9];
};

struct Geometry {
  int64_t B, npix, plane_px;
  int H, W, oh, ow;
  int row0;  // the frame row of output row 0 (matrix routes)
  int64_t tiles_x, ntiles;
  int replicate, bval;
};

__device__ __forceinline__ float clip_coord(float v) {
  return fminf(fmaxf(v, -kCoordLimit), kCoordLimit);
}

// one linear form a*x + b*y + c of cv2 5.0's hybrid field (see the header),
// with its row's terms by = f32(b*y) and crow = f32(by + c) made once per row
struct FormRow {
  double a, by, crow;  // exact: f32 values
  float c;
};
__device__ __forceinline__ FormRow form_row(float a, float b, float c, float yf) {
  const float by = __fmul_rn(b, yf);
  return {double(a), double(by), double(__fadd_rn(by, c)), c};
}
// xd: the column as a double (exact)
__device__ __forceinline__ float form_at(const FormRow& f, double xd, bool body) {
  const double ax = __dmul_rn(f.a, xd);
  if (body) return __double2float_rn(__dadd_rn(ax, f.crow));
  return __fadd_rn(__double2float_rn(__dadd_rn(ax, f.by)), f.c);
}

// floor(X) as an int and a float; below 2^22 by one round-down add of
// 1.5 * 2^23 (exact: the sum lies in [2^23, 2^24), where the ulp is 1)
__device__ __forceinline__ int floor_int(float X, float& fl) {
  if (fabsf(X) < kSmall) {
    const float t = __fadd_rd(X, kRound);
    fl = __fsub_rn(t, kRound);
    return __float_as_int(t) - 0x4B400000;
  }
  fl = floorf(X);
  return int(fl);  // |X| <= 2e9: in range, and +1 too
}
// rint(X), half to even, as an int; likewise
__device__ __forceinline__ int rint_int(float X) {
  if (fabsf(X) < kSmall) return __float_as_int(__fadd_rn(X, kRound)) - 0x4B400000;
  return __float2int_rn(X);
}

// the blend of four taps (bytes); the low byte of the result is the output
__device__ __forceinline__ uint32_t lerp_byte(uint32_t v00, uint32_t v01, uint32_t v10,
                                              uint32_t v11, float tx, float ty) {
  const float m00 = __uint_as_float(kMagic | v00), m01 = __uint_as_float(kMagic | v01);
  const float m10 = __uint_as_float(kMagic | v10), m11 = __uint_as_float(kMagic | v11);
  // p01 - p00 = m01 - m00 exactly; p00 = m00 - 2^23 exactly
  const float top = __fmaf_rn(tx, __fsub_rn(m01, m00), __fsub_rn(m00, kTwo23));
  const float bot = __fmaf_rn(tx, __fsub_rn(m11, m10), __fsub_rn(m10, kTwo23));
  const float r = __fmaf_rn(ty, __fsub_rn(bot, top), top);  // in [0, 255]
  return __float_as_uint(__fadd_rn(r, kTwo23));              // rint, half to even
}

// one plane's outputs of the thread's pixels (row `row`, columns col0 + kLX k;
// all_in: every tap of every pixel inside the plane) into the plane's output
// `o`.  All the taps are loaded before the first blend: where all_in, from
// their unclamped addresses; else each clamped into the plane and, under the
// constant border, replaced by the border value where it lies outside.
template <int kLX, int kPx, bool kNearest>
__device__ __forceinline__ void plane_outputs(const Geometry& g, const uint8_t* __restrict__ plane,
                                              uint8_t* __restrict__ o, int row, int col0,
                                              const int (&ix)[kPx], const int (&iy)[kPx],
                                              const float (&fxs)[kPx], const float (&fys)[kPx],
                                              bool all_in) {
  constexpr int kTaps = kNearest ? 1 : 4;
  uint32_t t[kPx][kTaps];
  if (all_in) {
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const uint8_t* p = plane + int64_t(iy[k]) * g.W + ix[k];
      t[k][0] = __ldg(p);
      if (!kNearest) {
        t[k][1] = __ldg(p + 1);
        t[k][2] = __ldg(p + g.W);
        t[k][3] = __ldg(p + g.W + 1);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
#pragma unroll
      for (int q = 0; q < kTaps; ++q) {
        const int y = iy[k] + (q >> 1), xx = ix[k] + (q & 1);
        const uint32_t v = __ldg(plane + int64_t(min(max(y, 0), g.H - 1)) * g.W +
                                 min(max(xx, 0), g.W - 1));
        const bool out_of_plane = unsigned(y) >= unsigned(g.H) || unsigned(xx) >= unsigned(g.W);
        t[k][q] = !g.replicate && out_of_plane ? uint32_t(g.bval) : v;
      }
  }
  if (row >= g.oh) return;
  uint8_t* dst = o + int64_t(row) * g.ow + col0;
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    if (col0 + kLX * k >= g.ow) break;
    dst[kLX * k] = uint8_t(kNearest ? t[k][0]
                                    : lerp_byte(t[k][0], t[k][1], t[k][2], t[k][3], fxs[k],
                                                fys[k]));
  }
}

template <int kSource, bool kNearest>
__global__ void __launch_bounds__(kThreads, Layout<kSource>::kMinBlocks)
warp_gather_u8_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sx,
                      const float* __restrict__ sy, uint8_t* __restrict__ out, Geometry g,
                      Matrix mat) {
  using L = Layout<kSource>;
  constexpr int kLX = L::kLX, kPx = L::kPx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb_cols = g.ow - g.ow % 16;  // the hybrid field's body columns
  const int64_t ngroups = (g.B + kPlanesPerItem - 1) / kPlanesPerItem;

  for (int64_t grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const int64_t b0 = grp * kPlanesPerItem;
    const int nb = g.B - b0 < kPlanesPerItem ? int(g.B - b0) : kPlanesPerItem;
    for (int64_t tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x) {
      const int64_t tyi = tile / g.tiles_x;
      const int col0 = int(tile - tyi * g.tiles_x) * L::kTileW + lane % kLX;
      const int warp_row = int(tyi) * L::kTileH + warp * (32 / kLX);
      const int row = warp_row + lane / kLX;
      if (warp_row >= g.oh) continue;  // all the warp's rows lie below the output

      // each pixel's tap indices and fractions, once for all planes (a pixel
      // past the output's edge keeps tap (0, 0) and writes nothing)
      int ix[kPx], iy[kPx];
      float fxs[kPx], fys[kPx];
      {
        const float yf = float(g.row0 + row);
        const float* m = mat.m;
        FormRow fx_row, fy_row, fd_row;
        if (kSource != kMaps) {
          fx_row = form_row(m[0], m[1], m[2], yf);
          fy_row = form_row(m[3], m[4], m[5], yf);
          if (kSource == kPerspective) fd_row = form_row(m[6], m[7], m[8], yf);
        }
        const double xd0 = double(col0);
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          const int col = col0 + kLX * k;
          ix[k] = iy[k] = 0;
          fxs[k] = fys[k] = 0.0f;
          if (row >= g.oh || col >= g.ow) continue;
          float X, Y;
          if (kSource == kMaps) {
            const int64_t p = int64_t(row) * g.ow + col;
            X = sx[p];
            Y = sy[p];
          } else {
            const bool body = col < nb_cols;
            const double xd = __dadd_rn(xd0, double(kLX * k));
            X = form_at(fx_row, xd, body);
            Y = form_at(fy_row, xd, body);
            if (kSource == kPerspective) {
              const float den = form_at(fd_row, xd, body);
              X = den != 0.0f ? __fdiv_rn(X, den) : 0.0f;
              Y = den != 0.0f ? __fdiv_rn(Y, den) : 0.0f;
            }
          }
          X = clip_coord(X);
          Y = clip_coord(Y);
          if (kNearest) {
            ix[k] = rint_int(X);
            iy[k] = rint_int(Y);
          } else {
            float flx, fly;
            ix[k] = floor_int(X, flx);
            iy[k] = floor_int(Y, fly);
            fxs[k] = __fsub_rn(X, flx);
            fys[k] = __fsub_rn(Y, fly);
          }
        }
      }
      // the interior test: one compare per pixel
      bool all_in = true;
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        all_in = all_in && (kNearest ? unsigned(ix[k]) < unsigned(g.W) &&
                                           unsigned(iy[k]) < unsigned(g.H)
                                     : unsigned(ix[k]) < unsigned(g.W - 1) &&
                                           unsigned(iy[k]) < unsigned(g.H - 1));
      for (int i = 0; i < nb; ++i) {
        const int64_t b = b0 + i;
        plane_outputs<kLX, kPx, kNearest>(g, x + b * g.plane_px, out + b * g.npix, row, col0, ix,
                                          iy, fxs, fys, all_in);
      }
    }
  }
}

template <int kSource>
void launch_source(cudaStream_t stream, bool nearest, const uint8_t* x, const float* sx,
                   const float* sy, uint8_t* out, Geometry g, const Matrix& m) {
  using L = Layout<kSource>;
  g.tiles_x = (g.ow + L::kTileW - 1) / L::kTileW;
  g.ntiles = g.tiles_x * ((g.oh + L::kTileH - 1) / L::kTileH);
  const int64_t groups = (g.B + kPlanesPerItem - 1) / kPlanesPerItem;
  const dim3 grid(unsigned(g.ntiles < kMaxGridX ? g.ntiles : kMaxGridX),
                  unsigned(groups < kMaxGridY ? groups : kMaxGridY));
  if (nearest)
    warp_gather_u8_kernel<kSource, true><<<grid, kThreads, 0, stream>>>(x, sx, sy, out, g, m);
  else
    warp_gather_u8_kernel<kSource, false><<<grid, kThreads, 0, stream>>>(x, sx, sy, out, g, m);
}

}  // namespace

extern "C" {

// x: [B, H, W] u8 contiguous; out: [B, oh, ow] u8 contiguous; row0: the frame
// row of output row 0 on the matrix routes (0 for a whole output; sources 1
// and 2 only, 0 <= row0, row0 + oh <= 2^31 - 65); nearest 0/1;
// replicate 0/1 (0 = constant border with value bval, 0..255).  source 0:
// sx, sy are [oh, ow] f32 contiguous maps shared by all planes and m0..m8
// are unused; 1: the affine inverse matrix m0..m5 (f32, row-major); 2: the
// perspective inverse matrix m0..m8; sx and sy are then unused.
int ie_warp_gather_u8(const uint8_t* x, const float* sx, const float* sy, uint8_t* out, int64_t B,
                      int64_t H, int64_t W, int64_t oh, int64_t ow, int64_t row0, int32_t nearest,
                      int32_t replicate, int32_t bval, int32_t source, float m0, float m1,
                      float m2, float m3, float m4, float m5, float m6, float m7, float m8,
                      cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL || W > 0x7fffffffLL || oh < 1 || ow < 1 ||
      oh > 0x7fffffffLL - 64 || ow > 0x7fffffffLL - 64 || (nearest != 0 && nearest != 1) ||
      (replicate != 0 && replicate != 1) || bval < 0 || bval > 255 || source < kMaps ||
      source > kPerspective || (source == kMaps && (sx == nullptr || sy == nullptr)) ||
      row0 < 0 || row0 > 0x7fffffffLL - 64 - oh || (source == kMaps && row0 != 0))
    return int(cudaErrorInvalidValue);
  const Geometry g{B,      oh * ow, H * W, int(H), int(W), int(oh), int(ow), int(row0),
                   0,      0,       replicate, bval};
  const Matrix m{{m0, m1, m2, m3, m4, m5, m6, m7, m8}};
  if (source == kMaps)
    launch_source<kMaps>(stream, nearest, x, sx, sy, out, g, m);
  else if (source == kAffine)
    launch_source<kAffine>(stream, nearest, x, sx, sy, out, g, m);
  else
    launch_source<kPerspective>(stream, nearest, x, sx, sy, out, g, m);
  return int(cudaGetLastError());
}

}  // extern "C"
