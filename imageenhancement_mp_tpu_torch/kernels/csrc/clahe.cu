// CLAHE (cv2.createCLAHE(clip, grid).apply) on u8 and u16 planes, in three
// kernels: per-tile histograms (stage A, u8), the clipped tile LUTs (stage B)
// and the bilinear blend of the four neighbour LUTs (stage C).
//
// The tile geometry is cv2's: th x tw tiles on a gh x gw grid over the image
// padded at the bottom and the right with REFLECT_101 when a dimension does
// not divide (ops/clahe.py computes th, tw).  Stage A reads the pad through
// reflected indices, so no padded copy exists.
//
// Each exported function launches on the caller's stream, allocates nothing,
// and returns the cudaError_t of cudaGetLastError() right after its launch.
// Built with -fmad=false and without --use_fast_math: every rounding below
// is the one written.

#include <cstdint>
#include <cuda_runtime.h>

#include "reflect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxGridY = 65535;  // (plane, row band) pairs beyond it stride over gridDim.y

// ---------------------------------------------------------------------------
// hist256_tiles: stage A for u8.  Replaces the JAX package's kernels/
// hist.py::hist256_pallas at its CLAHE call site (ops/clahe.py:207-212),
// where the TPU first copies the image into a [B*gh*gw, th*tw] tile stack.
// Here each block reads its tile in place.  Bound by device memory at 1 B/px
// (plus the pad rows and columns); the per-pixel shared-memory atomics are
// the same scheme as hist.cu's hist256: each warp counts into its own 256
// bins, and the block merges them with one global atomic per nonzero bin.
// Tiles lie on gridDim.x (up to 2^31 - 1 of them); gridDim.y splits a large
// tile into bands of rows.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
hist256_tiles_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out, int H, int W,
                     int gh, int gw, int th, int tw, int band_rows) {
  __shared__ int32_t bins[kWarps][256];
  const int tid = threadIdx.x;
  for (int i = tid; i < kWarps * 256; i += kThreads) (&bins[0][0])[i] = 0;
  __syncthreads();

  const int64_t tile = blockIdx.x;  // b * gh * gw + ty * gw + tx
  const int ntiles = gh * gw;
  const int64_t b = tile / ntiles;
  const int t = int(tile - b * ntiles);
  const int ty = t / gw, tx = t - (t / gw) * gw;
  const uint8_t* p = x + b * int64_t(H) * W;
  const int r0 = blockIdx.y * band_rows;
  const int rows = min(band_rows, th - r0);
  int32_t* mine = bins[tid >> 5];

  for (int i = tid; i < rows * tw; i += kThreads) {
    const int r = i / tw, c = i - r * tw;
    const int sy = reflect101(ty * th + r0 + r, H);
    const int sx = reflect101(tx * tw + c, W);
    atomicAdd(&mine[p[int64_t(sy) * W + sx]], 1);
  }
  __syncthreads();

  int32_t sum = 0;
  for (int w = 0; w < kWarps; ++w) sum += bins[w][tid];
  if (sum) atomicAdd(&out[tile * 256 + tid], sum);
}

// ---------------------------------------------------------------------------
// clahe_lut: stage B.  The JAX package has no TPU kernel here: it is XLA
// (the JAX package's ops/clahe.py::clahe_tile_luts, :74-97), about ten
// small ops over [T, S].  One block per tile does all of it:
//   clip at clip_abs, sum the excess, raise every bin by excess / S, add 1 at
//   bins i with i % step == 0 && i / step < excess % S (step = max(S / resid,
//   1)), take the inclusive scan, lut = clamp(rint(f32(cdf) * scale), 0, S-1)
// with clip_abs and scale = f32(S-1) / f32(area) computed by the caller;
// clip_abs 0 skips the clip.  Bound by launch latency for S = 256 and by the
// three reads of the [T, 65536] i32 histograms (from L2) for S = 65536.
// Each thread owns kPer consecutive bins; the block reduces and scans with
// warp shuffles.  All sums are at most the tile's area, below 2^31.
// ---------------------------------------------------------------------------

template <int kW>
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t total = 0;
  for (int w = 0; w < kW; ++w) total += warp_sums[w];
  __syncthreads();  // warp_sums is reused
  return total;
}

template <int kW>
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t c = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += up;
  }
  if (lane == 31) warp_sums[warp] = c;
  __syncthreads();
  int32_t excl = c - v;
  for (int w = 0; w < warp; ++w) excl += warp_sums[w];
  __syncthreads();
  return excl;
}

template <int S>
constexpr int kLutThreads = S < 1024 ? S : 1024;

template <int S, typename L>
__global__ void __launch_bounds__(kLutThreads<S>)
clahe_lut_kernel(const int32_t* __restrict__ hist, L* __restrict__ lut, int32_t clip_abs,
                 float scale) {
  constexpr int kT = kLutThreads<S>;
  constexpr int kPer = S / kT;
  constexpr int kW = kT / 32;
  __shared__ int32_t warp_sums[kW];
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int32_t* h = hist + tile * S + int64_t(t) * kPer;
  const int i0 = t * kPer;

  int32_t raise = 0, resid = 0, step = 1;
  if (clip_abs > 0) {
    int32_t ex = 0;
    for (int j = 0; j < kPer; ++j) ex += max(h[j] - clip_abs, 0);
    const int32_t excess = block_sum<kW>(ex, warp_sums);
    raise = excess / S;
    resid = excess % S;
    step = max(S / max(resid, 1), 1);
  }
  // the final bin value: clipped, raised and bumped
  auto bin = [&](int j) -> int32_t {
    int32_t v = h[j];
    if (clip_abs > 0) {
      const int i = i0 + j;
      v = min(v, clip_abs) + raise + ((i % step == 0 && i / step < resid) ? 1 : 0);
    }
    return v;
  };

  int32_t mine = 0;
  for (int j = 0; j < kPer; ++j) mine += bin(j);
  int32_t cdf = block_exclusive_scan<kW>(mine, warp_sums);
  L* o = lut + tile * S + i0;
  for (int j = 0; j < kPer; ++j) {
    cdf += bin(j);
    const float r = rintf(__fmul_rn(__int2float_rn(cdf), scale));
    o[j] = L(__float2int_rn(fminf(fmaxf(r, 0.0f), float(S - 1))));
  }
}

// ---------------------------------------------------------------------------
// clahe_blend: stage C.  Replaces both TPU blends,
// the JAX package's kernels/clahe_u16.py::clahe_blend_quad_pallas
// (quadrant blocking and a 256-step packed gather chain, because the TPU has
// no general gather) and kernels/clahe_blend.py::clahe_blend_pallas (nine
// stacked neighbour LUTs for the tile splits the quadrant guard rejects).
// Here every pixel loads its four neighbour entries straight from the
// [B*T, S] table (L1/L2: 16 KiB of u8 tables or 8 MiB of u16 tables per
// plane), with its row's y0, y1, fy and its column's x0, x1, fx from the
// host's _interp_coords tables, so every geometry takes this one kernel.
// Bound by device memory at 2 B/px (u8) plus four dependent table loads.
// The blend is blend_tile_luts' association (ops/clahe.py:145-148), each
// operation rounded once, then one half-even round:
//   top = (1-fx)*l00 + fx*l01;  bot = (1-fx)*l10 + fx*l11
//   out = clamp(rint((1-fy)*top + fy*bot), 0, S-1)
// One block covers 256 columns by kBlendRows rows of one plane.
// ---------------------------------------------------------------------------

constexpr int kBlendRows = 8;

template <typename P, int S>
__global__ void __launch_bounds__(kThreads)
clahe_blend_kernel(const P* __restrict__ x, const P* __restrict__ luts, P* __restrict__ out,
                   int64_t B, int H, int W, int gh, int gw,
                   const int32_t* __restrict__ yidx, const float* __restrict__ fyv,
                   const int32_t* __restrict__ xidx, const float* __restrict__ fxv) {
  const int xx = blockIdx.x * kThreads + threadIdx.x;
  if (xx >= W) return;
  const int x0 = xidx[xx], x1 = xidx[W + xx];
  const float fx = fxv[xx];
  const float gx = __fsub_rn(1.0f, fx);
  const int64_t ntiles = int64_t(gh) * gw;
  const int64_t nbands = (H + kBlendRows - 1) / kBlendRows;

  // (plane, row band) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nbands; item += gridDim.y) {
    const int64_t b = item / nbands;
    const int ya = int(item - b * nbands) * kBlendRows;
    const int yb = min(ya + kBlendRows, H);
    const P* lb = luts + b * ntiles * S;
    const int64_t plane = b * int64_t(H) * W;
    for (int y = ya; y < yb; ++y) {
      const int y0 = yidx[y], y1 = yidx[H + y];
      const float fy = fyv[y];
      const int64_t px = plane + int64_t(y) * W + xx;
      const int v = int(x[px]);
      const float l00 = float(lb[(int64_t(y0) * gw + x0) * S + v]);
      const float l01 = float(lb[(int64_t(y0) * gw + x1) * S + v]);
      const float l10 = float(lb[(int64_t(y1) * gw + x0) * S + v]);
      const float l11 = float(lb[(int64_t(y1) * gw + x1) * S + v]);
      const float top = __fadd_rn(__fmul_rn(gx, l00), __fmul_rn(fx, l01));
      const float bot = __fadd_rn(__fmul_rn(gx, l10), __fmul_rn(fx, l11));
      const float o = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, fy), top), __fmul_rn(fy, bot));
      out[px] = P(__float2int_rn(fminf(fmaxf(rintf(o), 0.0f), float(S - 1))));
    }
  }
}

}  // namespace

extern "C" {

// x: [B, H, W] u8 contiguous; out: [B*gh*gw, 256] int32, zeroed by the
// caller.  Tile (ty, tx) covers padded rows ty*th .. ty*th+th-1 and columns
// tx*tw .. tx*tw+tw-1, with gh*th >= H and gw*tw >= W.
int ie_hist256_tiles(const uint8_t* x, int32_t* out, int64_t B, int64_t H, int64_t W,
                     int32_t gh, int32_t gw, int64_t th, int64_t tw, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || th < 1 || tw < 1 ||
      int64_t(gh) * th < H || int64_t(gw) * tw < W || int64_t(gh) * th > 0x7fffffffLL ||
      int64_t(gw) * tw > 0x7fffffffLL || th * tw > 0x7fffffffLL ||
      B * gh * gw > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  // about 16K pixels per block: a 4K tile of 270x480 gets 8 bands
  int64_t bands = (th * tw + 16383) / 16384;
  if (bands > th) bands = th;
  if (bands > 1024) bands = 1024;
  const int64_t band_rows = (th + bands - 1) / bands;
  bands = (th + band_rows - 1) / band_rows;
  const dim3 grid(unsigned(B * gh * gw), unsigned(bands));
  hist256_tiles_kernel<<<grid, kThreads, 0, stream>>>(x, out, int(H), int(W), gh, gw, int(th),
                                                      int(tw), int(band_rows));
  return int(cudaGetLastError());
}

// hist: [BT, S] int32 (S = 256 or 65536), each row summing to the tile area;
// lut: [BT, S] u8 (S = 256) or u16 (S = 65536).  clip_abs 0 skips the clip.
int ie_clahe_lut(const int32_t* hist, void* lut, int64_t BT, int32_t S, int32_t clip_abs,
                 float scale, cudaStream_t stream) {
  if (BT < 1 || BT > 0x7fffffffLL || clip_abs < 0) return int(cudaErrorInvalidValue);
  if (S == 256) {
    clahe_lut_kernel<256, uint8_t><<<unsigned(BT), kLutThreads<256>, 0, stream>>>(
        hist, static_cast<uint8_t*>(lut), clip_abs, scale);
  } else if (S == 65536) {
    clahe_lut_kernel<65536, uint16_t><<<unsigned(BT), kLutThreads<65536>, 0, stream>>>(
        hist, static_cast<uint16_t*>(lut), clip_abs, scale);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// x, out: [B, H, W] contiguous, u8 (elem_bytes 1, S = 256) or u16
// (elem_bytes 2, S = 65536); luts: [B*gh*gw, S] of the same type.
// yidx: [2, H] int32 (y0 then y1), fy: [H] f32; xidx: [2, W], fx: [W].
int ie_clahe_blend(const void* x, const void* luts, void* out, int64_t B, int64_t H, int64_t W,
                   int32_t elem_bytes, int32_t gh, int32_t gw, const int32_t* yidx,
                   const float* fy, const int32_t* xidx, const float* fx,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || W > 0x7fffffffLL - kThreads ||
      H > 0x7fffffffLL - kBlendRows)
    return int(cudaErrorInvalidValue);
  const int64_t items = B * ((H + kBlendRows - 1) / kBlendRows);
  const dim3 grid(unsigned((W + kThreads - 1) / kThreads),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  if (elem_bytes == 1) {
    clahe_blend_kernel<uint8_t, 256><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
        static_cast<uint8_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx);
  } else if (elem_bytes == 2) {
    clahe_blend_kernel<uint16_t, 65536><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(luts),
        static_cast<uint16_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
