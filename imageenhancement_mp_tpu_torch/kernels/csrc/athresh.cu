// athresh: cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C) on u8 planes,
// any odd block size, exact against ref/ops.py::adaptive_threshold.
//
// Replaces the JAX package's kernels/dfconv.py::
// adaptive_threshold_gaussian_pallas (_athresh_jit: the local mean in
// double-float f32 with Dekker/Knuth error terms, because the TPU has no
// f64; W % 128 == 0, H % 8 == 0, block size <= 17 only, the rest on an XLA
// double-float route).  This card has f64, so the mean is computed in f64
// in the oracle's own order (ref/ops.py:1145-1153), and is the oracle's
// value bit for bit:
//   rows[y][x] = ((0 + p[y-r][x]*k[0]) + p[y-r+1][x]*k[1]) + ...   (dy ascending)
//   acc[y][x]  = ((0 + rows[y][x-r]*k[0]) + rows[y][x-r+1]*k[1]) + ...
//   mean = rint(acc)  (half to even);  hit = src > mean - idelta
//   out = hit ? maxval : 0  (binary),  hit ? 0 : maxval  (binary_inv)
// with p and rows read at clamped indices (BORDER_REPLICATE), every product
// and sum rounded once (__dmul_rn, __dadd_rn; built with -fmad=false).
// The taps are cv2's float sigma=0 kernel from host NumPy
// (utils/taps.py::gaussian_kernel), so they are the oracle's bit for bit.
//
// What bounds it on this card: f64 throughput, not memory.  A block size k
// costs 2k f64 multiplies and 2k f64 adds per pixel (44 at k = 11) against
// 2 B/px of traffic, and the H100's f64 rate is 1/2 of its f32 rate.
// Design, for k <= 51: one block per 16x64 output tile of one plane; the
// tile and its k/2-deep halo are staged in shared memory as bytes through
// clamped indices, the vertical pass writes the tile's 16 rows of column
// sums (halo columns included) as f64 to shared memory, and the horizontal
// pass, the rounding and the compare run in registers.  For k > 51 the halo
// does not fit: two passes over the planes, the vertical one into an f64
// scratch [B, H, W] from the caller, the horizontal one from it, with
// threads on consecutive columns; the same order of operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kMaxTiledR = 25;  // block size 51
constexpr int kMaxTiledK = 2 * kMaxTiledR + 1;
constexpr int64_t kMaxGridY = 65535;  // (plane, row tile) pairs beyond it stride over gridDim.y
constexpr int64_t kMaxBlocks = 1 << 20;  // the two-pass kernels stride over pixels beyond it

__device__ __forceinline__ uint8_t decide(int src, double acc, int idelta, int mv, int inv) {
  const int mean = __double2int_rn(acc);
  const bool hit = src > mean - idelta;
  return uint8_t(hit != bool(inv) ? mv : 0);
}

__global__ void __launch_bounds__(kThreads)
athresh_tiled_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B, int H,
                     int W, const double* __restrict__ taps_g, int k, int mv, int idelta,
                     int inv) {
  __shared__ double taps[kMaxTiledK];
  __shared__ uint8_t tile[(kTileH + 2 * kMaxTiledR) * (kTileW + 2 * kMaxTiledR)];
  __shared__ double rows[kTileH * (kTileW + 2 * kMaxTiledR)];

  const int tid = threadIdx.x;
  const int R = k / 2;
  const int in_w = kTileW + 2 * R, in_h = kTileH + 2 * R;
  const int x0 = blockIdx.x * kTileW;
  const int64_t nty = (H + kTileH - 1) / kTileH;
  if (tid < k) taps[tid] = taps_g[tid];

  // (plane, row tile) pairs stride over gridDim.y, so any number of planes
  // and rows fits the grid
  for (int64_t item = blockIdx.y; item < B * nty; item += gridDim.y) {
    const int64_t b = item / nty;
    const int y0 = int(item - b * nty) * kTileH;
    const int64_t plane = b * int64_t(H) * W;
    for (int i = tid; i < in_h * in_w; i += kThreads) {
      const int rr = i / in_w, cc = i - rr * in_w;
      const int sy = min(max(y0 - R + rr, 0), H - 1);
      const int sx = min(max(x0 - R + cc, 0), W - 1);
      tile[i] = x[plane + int64_t(sy) * W + sx];
    }
    __syncthreads();

    for (int i = tid; i < kTileH * in_w; i += kThreads) {
      const int rr = i / in_w, cc = i - rr * in_w;
      double acc = 0.0;
      for (int d = 0; d < k; ++d)
        acc = __dadd_rn(acc, __dmul_rn(double(tile[(rr + d) * in_w + cc]), taps[d]));
      rows[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int rr = i / kTileW, cc = i - rr * kTileW;
      const int y = y0 + rr, xx = x0 + cc;
      if (y >= H || xx >= W) continue;
      double acc = 0.0;
      for (int d = 0; d < k; ++d)
        acc = __dadd_rn(acc, __dmul_rn(rows[rr * in_w + cc + d], taps[d]));
      out[plane + int64_t(y) * W + xx] =
          decide(tile[(rr + R) * in_w + cc + R], acc, idelta, mv, inv);
    }
    __syncthreads();  // the next item overwrites tile and rows
  }
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
// inv 0 = binary, 1 = binary_inv.
int ie_athresh(const uint8_t* x, uint8_t* out, double* scratch, int64_t B, int64_t H, int64_t W,
               const double* taps, int32_t k, int32_t mv, int32_t idelta, int32_t inv,
               cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH || W > 0x7fffffffLL - kTileW ||
      k < 3 || k % 2 == 0 || mv < 0 || mv > 255 || (inv != 0 && inv != 1) ||
      (k > kMaxTiledK && scratch == nullptr))
    return int(cudaErrorInvalidValue);
  if (k <= kMaxTiledK) {
    const int64_t items = B * ((H + kTileH - 1) / kTileH);
    const dim3 grid(unsigned((W + kTileW - 1) / kTileW),
                    unsigned(items < kMaxGridY ? items : kMaxGridY));
    athresh_tiled_kernel<<<grid, kThreads, 0, stream>>>(x, out, B, int(H), int(W), taps, k, mv,
                                                        idelta, inv);
    return int(cudaGetLastError());
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
