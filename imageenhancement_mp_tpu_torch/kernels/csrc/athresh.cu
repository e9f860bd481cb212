// athresh: cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C) on u8 planes,
// any odd block size, exact against ref/ops.py::adaptive_threshold.
//
// Replaces the JAX package's kernels/dfconv.py::
// adaptive_threshold_gaussian_pallas (_athresh_jit: the local mean in
// double-float f32 with Dekker/Knuth error terms, because the TPU has no
// f64; W % 128 == 0, H % 8 == 0, block size <= 17 only, the rest on an XLA
// double-float route).
//
// The law (ref/ops.py:1145-1157), the oracle's f64 order:
//   rows[y][x] = ((0 + p[y-r][x]*k[0]) + p[y-r+1][x]*k[1]) + ...   (dy ascending)
//   acc[y][x]  = ((0 + rows[y][x-r]*k[0]) + rows[y][x-r+1]*k[1]) + ...
//   mean = rint(acc)  (half to even);  hit = src > mean - idelta
//   out = hit ? maxval : 0  (binary),  hit ? 0 : maxval  (binary_inv)
// with p and rows read at clamped indices (BORDER_REPLICATE), every product
// and sum rounded once.  The taps are cv2's float sigma=0 kernel from host
// NumPy (utils/taps.py::gaussian_kernel), so they are the oracle's bit for
// bit.
//
// Why a screen is exact.  The output depends on acc only through one
// comparison: with m = src + idelta - 1, hit <=> rint(acc) <= m <=> acc <
// m + 1/2, or acc == m + 1/2 with m even.  The kernel computes acc32, the same
// separable sum in f32 with f32(k[d]) and fused multiply-adds.  Where
// |acc32 - (m + 1/2)| > eps the f32 decision is the oracle's; elsewhere the
// thread recomputes acc for that pixel in the oracle's exact order
// (__dmul_rn, __dadd_rn) and decides from it.  eps comes from the host
// (kernels/athresh.py::screen_margin): with A the exact value of the sum,
//   |acc32 - A| <= gamma_{2k+2}(2^-24) * 255 * (sum |k|)^2
//   |acc64 - A| <= gamma_{2k+2}(2^-53) * 255 * (sum |k|)^2
// (gamma_n(u) = n u / (1 - n u): 2k + 2 roundings reach each term, the two
// tap roundings included), and eps is twice their sum, so |acc32 - acc64| <
// eps / 2 and a pixel the screen decides lies on the same side of m + 1/2
// as acc64.  For taps that are multiples of 2^-8 summing to at most 1 (cv2's
// sigma=0 tables at k 3/5/7/9) every f32 product and partial sum is a
// multiple of 2^-16 below 2^8, so acc32 is exact and eps = 0: only exact
// ties recompute.
//
// What bounds it on this card: issue, not memory (2 B/px).  Design, for
// k <= 51: persistent blocks walk 64 x 64 output tiles; a warp's 32 lanes
// are rows (two each, 32 apart) and its 8 outputs per lane adjacent columns, so 128-bit
// shared loads over rows of pitch 4 * odd words are free of bank conflicts.
// The tile and its halo are staged once as f32 through the word 0x4B000000 |
// v (the f32 2^23 + v, minus 2^23: no I2F); the vertical pass writes f32
// column sums, four columns a thread, the horizontal pass reads a register
// window of column sums and runs the screen.  Block sizes 3..11 are
// compile-time instances with the taps in registers; K = 0 is the runtime
// instance, its f32 taps in shared memory padded with zeros to whole 4-wide
// blocks (x + 0 * t is x).  For k > 51 the halo does not fit: two passes
// over the planes, the vertical one into an f64 scratch [B, H, W] from the
// caller, the horizontal one from it, in the oracle's order, unscreened.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;                // outputs per thread, adjacent in a row
constexpr int kTileW = kWarps * kT;  // 64
constexpr int kTileH = 64;           // two rows per lane, 32 apart
constexpr int kMaxTiledR = 25;       // block size 51
constexpr int kMaxTiledK = 2 * kMaxTiledR + 1;
constexpr int kMaxCompileK = 11;
constexpr int kPadTaps = 2 * ((kMaxTiledR + 3) & ~3) + 4;
constexpr uint32_t kMagic = 0x4B000000u;  // the bits of f32 2^23
constexpr float kTwo23 = 8388608.0f;
constexpr int kMaxSmem = 232448;
constexpr int64_t kMaxBlocks = 1 << 20;  // the two-pass kernels stride over pixels beyond it

__host__ __device__ constexpr int align4(int v) { return (v + 3) & ~3; }
// a row pitch of 4 * odd words: 8 rows of one 128-bit load phase, 8 bank quads
__host__ __device__ constexpr int pitch_for(int w) { return (align4(w) / 4) % 2 ? align4(w) : align4(w) + 4; }
__host__ __device__ constexpr int tile_in_w(int R, bool runtime) {
  return kTileW + 2 * align4(R) + (runtime ? 4 : 0);
}

__device__ __forceinline__ uint8_t decide(int src, double acc, int idelta, int mv, int inv) {
  const int mean = __double2int_rn(acc);
  const bool hit = src > mean - idelta;
  return uint8_t(hit != bool(inv) ? mv : 0);
}

// acc64 of one pixel in the oracle's order, from the staged tile: tile rows
// r .. r+k-1, tile columns c .. c+k-1
__device__ __noinline__ uint8_t exact_decide(const float* tile, int pitch, int r, int c, int src,
                                             const double* taps, int k, int idelta, int mv,
                                             int inv) {
  double acc = 0.0;
  for (int dx = 0; dx < k; ++dx) {
    double rows = 0.0;
    for (int dy = 0; dy < k; ++dy)
      rows = __dadd_rn(rows, __dmul_rn(double(tile[(r + dy) * pitch + c + dx]), taps[dy]));
    acc = __dadd_rn(acc, __dmul_rn(rows, taps[dx]));
  }
  return decide(src, acc, idelta, mv, inv);
}

// K > 0: compile-time block size K (k unused); K == 0: runtime block size k <= 51
template <int K>
__global__ void __launch_bounds__(kThreads)
athresh_screen_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B, int H,
                      int W, const double* __restrict__ taps_g, int k, int mv, int idelta, int inv,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRuntime = K == 0;
  const int kk = kRuntime ? k : K;
  const int R = kk / 2, ra = align4(R);
  const int in_w = tile_in_w(R, kRuntime), in_h = kTileH + 2 * R;
  const int pitch = pitch_for(in_w);
  float* tile = smem;                                  // [in_h][pitch]: the planes' values
  float* cols = tile + in_h * pitch;                   // [32][pitch]: f32 column sums
  double* taps = reinterpret_cast<double*>(cols + kTileH * pitch);
  float* tpad = reinterpret_cast<float*>(taps + kMaxTiledK);  // f32 taps from column ra - R

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t ntx = (W + kTileW - 1) / kTileW, nty = (H + kTileH - 1) / kTileH;
  const int64_t items = B * nty * ntx;
  for (int d = tid; d < kk; d += kThreads) taps[d] = taps_g[d];
  for (int q = tid; q < kPadTaps; q += kThreads) {
    const int d = q - (ra - R);
    tpad[q] = (d >= 0 && d < kk) ? __double2float_rn(taps_g[d]) : 0.0f;
  }
  float t32[K > 0 ? K : 1];
  if constexpr (!kRuntime) {
#pragma unroll
    for (int d = 0; d < K; ++d) t32[d] = __double2float_rn(taps_g[d]);
  }
  const float bias = float(idelta) - 0.5f;  // src + bias = m + 1/2, exact

  const int groups = in_w / 4;
  // the compile-time instances stage in one round trip, the runtime one in
  // chunks of 6 row steps (2 at block size 51)
  constexpr int kRows = kRuntime ? 6 : (kTileH + 2 * (K / 2) + kWarps - 1) / kWarps;
  constexpr int kCols = (tile_in_w(kRuntime ? kMaxTiledR : K / 2, kRuntime) + 31) / 32;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const TileItem cur = tile_item(item, ntx, nty, H, W, kTileH, kTileW);
    const int64_t plane = cur.plane;
    const int x0 = cur.x0, y0 = cur.y0;
    __syncthreads();  // the taps are written; the previous item is done with the tile
    stage_tile<kRows, kCols>(tile, pitch, x + plane, H, W, y0 - R, x0 - ra, in_h, in_w,
                             [](int i, int n) { return min(max(i, 0), n - 1); },
                             [](uint32_t v) { return __fsub_rn(__uint_as_float(kMagic | v), kTwo23); });
    __syncthreads();

    // vertical: f32 column sums, d ascending
    if constexpr (!kRuntime) {
      // a strip of kS rows and four columns per item, lanes on consecutive
      // columns: each tile row is loaded once for the strip's kS sums
      constexpr int kS = 4;
      for (int it = tid; it < (kTileH / kS) * groups; it += kThreads) {
        const int g = it % groups, r0 = (it / groups) * kS;
        const float* colp = tile + r0 * pitch + 4 * g;
        float4 acc[kS];
#pragma unroll
        for (int q = 0; q < kS; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int u = 0; u < kS + K - 1; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(colp + u * pitch);
#pragma unroll
          for (int q = 0; q < kS; ++q) {
            const int d = u - q;
            if (d >= 0 && d < K) {
              acc[q].x = __fmaf_rn(v.x, t32[d], acc[q].x);
              acc[q].y = __fmaf_rn(v.y, t32[d], acc[q].y);
              acc[q].z = __fmaf_rn(v.z, t32[d], acc[q].z);
              acc[q].w = __fmaf_rn(v.w, t32[d], acc[q].w);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kS; ++q)
          *reinterpret_cast<float4*>(cols + (r0 + q) * pitch + 4 * g) = acc[q];
      }
    } else {
      // one row and four columns per item
      for (int it = tid; it < kTileH * groups; it += kThreads) {
        const int r = it % kTileH, g = it / kTileH;  // lanes on rows
        const float* colp = tile + r * pitch + 4 * g;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int d = 0; d < kk; ++d) {
          const float4 v = *reinterpret_cast<const float4*>(colp + d * pitch);
          const float td = tpad[d + ra - R];
          acc.x = __fmaf_rn(v.x, td, acc.x);
          acc.y = __fmaf_rn(v.y, td, acc.y);
          acc.z = __fmaf_rn(v.z, td, acc.z);
          acc.w = __fmaf_rn(v.w, td, acc.w);
        }
        *reinterpret_cast<float4*>(cols + r * pitch + 4 * g) = acc;
      }
    }
    __syncthreads();

    // horizontal, from a register window of column sums starting at column 8 w;
    // each lane's rows lane and lane + 32
    for (int row = lane; row < kTileH; row += 32) {
      const float* crow = cols + row * pitch + kT * warp;
      float acc[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
      if constexpr (!kRuntime) {
        constexpr int RR = K / 2, RA = align4(RR), N = kT + 2 * RA;
        float win[N];
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(crow)[q];
          win[4 * q] = v.x;
          win[4 * q + 1] = v.y;
          win[4 * q + 2] = v.z;
          win[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int d = 0; d < K; ++d)
#pragma unroll
          for (int t = 0; t < kT; ++t) acc[t] = __fmaf_rn(win[t + d + RA - RR], t32[d], acc[t]);
      } else {
        const int nb = (ra + R + 4) >> 2;  // 4-wide tap blocks covering columns 0 .. ra + R
        for (int q = 0; q < nb; ++q) {
          float win[12];
#pragma unroll
          for (int h = 0; h < 3; ++h) {
            const float4 v = reinterpret_cast<const float4*>(crow + 4 * q)[h];
            win[4 * h] = v.x;
            win[4 * h + 1] = v.y;
            win[4 * h + 2] = v.z;
            win[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float tp = tpad[4 * q + s];
#pragma unroll
            for (int t = 0; t < kT; ++t) acc[t] = __fmaf_rn(win[t + s], tp, acc[t]);
          }
        }
      }

      const int y = y0 + row, xs = x0 + kT * warp;
      if (y < H && xs < W) {
        const float4* srow = reinterpret_cast<const float4*>(tile + (row + R) * pitch + ra + kT * warp);
        const float4 s0 = srow[0], s1 = srow[1];
        const float srcs[kT] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        uint8_t o[kT];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const float src = srcs[t];
          const float d = __fsub_rn(acc[t], __fadd_rn(src, bias));
          if (d < -eps || d > eps) {
            o[t] = uint8_t((d < 0.0f) != bool(inv) ? mv : 0);
          } else {
            o[t] = xs + t < W ? exact_decide(tile, pitch, row, ra + kT * warp + t - R, int(src),
                                             taps, kk, idelta, mv, inv)
                              : 0;
          }
        }
        uint8_t* dst = out + plane + int64_t(y) * W + xs;
        if (xs + kT <= W && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
          uint2 v;
          v.x = o[0] | (o[1] << 8) | (o[2] << 16) | (uint32_t(o[3]) << 24);
          v.y = o[4] | (o[5] << 8) | (o[6] << 16) | (uint32_t(o[7]) << 24);
          *reinterpret_cast<uint2*>(dst) = v;
        } else {
          for (int t = 0; t < kT && xs + t < W; ++t) dst[t] = o[t];
        }
      }
    }
  }
}

size_t screen_smem_bytes(int k, bool runtime) {
  const int R = k / 2;
  const size_t floats = size_t(kTileH + 2 * R + kTileH) * pitch_for(tile_in_w(R, runtime));
  return floats * 4 + kMaxTiledK * 8 + kPadTaps * 4;
}

template <int K>
int launch_screen(const uint8_t* x, uint8_t* out, int64_t B, int H, int W, const double* taps,
                  int k, int mv, int idelta, int inv, float eps, cudaStream_t stream) {
  const auto kernel = athresh_screen_kernel<K>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return int(attr);
  const size_t smem = screen_smem_bytes(k, K == 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (occ != cudaSuccess) return int(occ);
  const int64_t items = B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  const int64_t full = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = unsigned(items < full ? items : full);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, B, H, W, taps, k, mv, idelta, inv, eps);
  return int(cudaGetLastError());
}

// two-pass route, k > 51: pixel p = (b * H + y) * W + xx of B * H * W
__global__ void __launch_bounds__(kThreads)
athresh_rows_kernel(const uint8_t* __restrict__ x, double* __restrict__ rows, int64_t total, int H,
                    int W, const double* __restrict__ taps, int k) {
  const int R = k / 2;
  for (int64_t p = int64_t(blockIdx.x) * kThreads + threadIdx.x; p < total;
       p += int64_t(gridDim.x) * kThreads) {
    const int64_t line = p / W;  // b * H + y
    const int xx = int(p - line * W);
    const int64_t b = line / H;
    const int y = int(line - b * H);
    const uint8_t* col = x + b * int64_t(H) * W + xx;
    double acc = 0.0;
    for (int d = 0; d < k; ++d) {
      const int sy = min(max(y - R + d, 0), H - 1);
      acc = __dadd_rn(acc, __dmul_rn(double(col[int64_t(sy) * W]), taps[d]));
    }
    rows[p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
athresh_cols_kernel(const uint8_t* __restrict__ x, const double* __restrict__ rows,
                    uint8_t* __restrict__ out, int64_t total, int W,
                    const double* __restrict__ taps, int k, int mv, int idelta, int inv) {
  const int R = k / 2;
  for (int64_t p = int64_t(blockIdx.x) * kThreads + threadIdx.x; p < total;
       p += int64_t(gridDim.x) * kThreads) {
    const int64_t line = p / W;
    const int xx = int(p - line * W);
    const double* row = rows + line * W;
    double acc = 0.0;
    for (int d = 0; d < k; ++d) {
      const int sx = min(max(xx - R + d, 0), W - 1);
      acc = __dadd_rn(acc, __dmul_rn(row[sx], taps[d]));
    }
    out[p] = decide(x[p], acc, idelta, mv, inv);
  }
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous; taps: [k] f64 on the device, k odd >= 3;
// scratch: [B, H, W] f64 for k > 51, else unused (may be null); mv 0..255;
// inv 0 = binary, 1 = binary_inv; eps >= 0 (may be +inf): the screen's margin
// (k <= 51); runtime 1 takes the runtime instance at a block size that has a
// compile-time one (for A/Bs).
int ie_athresh(const uint8_t* x, uint8_t* out, double* scratch, int64_t B, int64_t H, int64_t W,
               const double* taps, int32_t k, int32_t mv, int32_t idelta, int32_t inv, float eps,
               int32_t runtime, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH || W > 0x7fffffffLL - kTileW ||
      k < 3 || k % 2 == 0 || mv < 0 || mv > 255 || (inv != 0 && inv != 1) ||
      (k > kMaxTiledK && scratch == nullptr) || !(eps >= 0.0f) || (runtime != 0 && runtime != 1))
    return int(cudaErrorInvalidValue);
  if (k <= kMaxTiledK) {
    const int h = int(H), w = int(W);
    if (!runtime && k <= kMaxCompileK) switch (k) {
        case 3: return launch_screen<3>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
        case 5: return launch_screen<5>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
        case 7: return launch_screen<7>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
        case 9: return launch_screen<9>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
        case 11: return launch_screen<11>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
        default: break;
      }
    return launch_screen<0>(x, out, B, h, w, taps, k, mv, idelta, inv, eps, stream);
  }
  const int64_t total = B * H * W;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  athresh_rows_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(x, scratch, total, int(H), int(W),
                                                                 taps, k);
  const int err = int(cudaGetLastError());
  if (err != 0) return err;
  athresh_cols_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(x, scratch, out, total, int(W),
                                                                 taps, k, mv, idelta, inv);
  return int(cudaGetLastError());
}

}  // extern "C"
