// Staging a u8 tile with its halo into shared memory, shared by
// bilateral.cu and athresh.cu.  A warp stages rows warp, warp + 8, ...; a
// lane columns lane, lane + 32, ...  The loads of kRows x kCols elements are
// all issued before the first store, so a block waits for one round trip to
// device memory per chunk of kRows row steps, not one per element.  (Copying
// the next tile ahead, into registers or by cp.async, and loading four bytes
// a lane did not win on the H100: these kernels are not waiting on memory.)
#pragma once

#include <cstdint>

namespace {

// item = (plane b, row tile ty, column tile tx) in row-major order: the
// plane's offset and the tile's first row and column
struct TileItem {
  int64_t plane;
  int y0, x0;
};
__device__ __forceinline__ TileItem tile_item(int64_t item, int64_t ntx, int64_t nty, int H, int W,
                                              int tile_h, int tile_w) {
  if (item <= 0xffffffffLL) {  // 32-bit divisions where they do (any batch below 2^32 tiles)
    const uint32_t i = uint32_t(item), nx = uint32_t(ntx), ny = uint32_t(nty);
    const uint32_t band = i / nx, b = band / ny;
    return {int64_t(b) * H * W, int(band - b * ny) * tile_h, int(i - band * nx) * tile_w};
  }
  const int64_t band = item / ntx, b = band / nty;
  return {b * int64_t(H) * W, int(band - b * nty) * tile_h, int(item - band * ntx) * tile_w};
}

// rows y_top .. y_top + in_h - 1 and columns x_left .. x_left + in_w - 1 of
// a [H, W] u8 plane, read at border(y, H) and border(x, W), stored as
// convert(v) at tile[r * pitch + c], in chunks of kRows row steps; kCols
// column steps must cover in_w
template <int kRows, int kCols, class T, class Border, class Convert>
__device__ __forceinline__ void stage_tile(T* tile, int pitch, const uint8_t* __restrict__ plane,
                                           int H, int W, int y_top, int x_left, int in_h,
                                           int in_w, Border border, Convert convert) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int col[kCols];
#pragma unroll
  for (int b = 0; b < kCols; ++b) col[b] = border(x_left + min(lane + 32 * b, in_w - 1), W);
  for (int r0 = warp; r0 < in_h; r0 += kRows * warps) {
    uint32_t v[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const uint8_t* src = plane + int64_t(border(y_top + min(r0 + a * warps, in_h - 1), H)) * W;
#pragma unroll
      for (int b = 0; b < kCols; ++b) v[a][b] = src[col[b]];
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int r = r0 + a * warps, c = lane + 32 * b;
        if (r < in_h && c < in_w) tile[r * pitch + c] = convert(v[a][b]);
      }
  }
}

}  // namespace
