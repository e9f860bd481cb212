// The median networks shared by median.cu (the median alone) and fused.cu
// (median -> Gaussian -> unsharp), as the JAX package's
// kernels/networks.py builds them:
//  * 9 taps: Paeth's 19-comparator median network.
//  * 25 taps: forgetful selection.  Start with the first 14 taps; each round
//    moves the window's minimum and maximum out and takes in the next tap;
//    after 11 rounds the median is the middle of the last three.
// Taps are held as int, the register width: u8, u16 and i16 values all fit,
// and a signed int compare orders each type as the type itself does.  The
// networks are fully unrolled with compile-time indices, so the taps stay in
// registers.
#pragma once

namespace {

__device__ __forceinline__ void cex(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__device__ __forceinline__ int median9(int (&w)[9]) {
  cex(w[1], w[2]); cex(w[4], w[5]); cex(w[7], w[8]); cex(w[0], w[1]);
  cex(w[3], w[4]); cex(w[6], w[7]); cex(w[1], w[2]); cex(w[4], w[5]);
  cex(w[7], w[8]); cex(w[0], w[3]); cex(w[5], w[8]); cex(w[4], w[7]);
  cex(w[3], w[6]); cex(w[1], w[4]); cex(w[2], w[5]); cex(w[4], w[7]);
  cex(w[4], w[2]); cex(w[6], w[4]); cex(w[4], w[2]);
  return w[4];
}

__device__ __forceinline__ int median25(int (&a)[25]) {
  // round r: the window is a[2r .. 13+r]; its minimum goes to a[2r] and its
  // maximum to a[2r+1], both dropped; a[14+r] joins for the next round
#pragma unroll
  for (int r = 0; r < 11; ++r) {
#pragma unroll
    for (int i = 2 * r + 1; i <= 13 + r; ++i) cex(a[2 * r], a[i]);
#pragma unroll
    for (int i = 2 * r + 2; i <= 13 + r; ++i) cex(a[i], a[2 * r + 1]);
  }
  cex(a[22], a[23]);
  cex(a[23], a[24]);
  cex(a[22], a[23]);
  return a[23];
}

// The median of a K x K window (K = 3 or 5) whose top-left tap is at w0,
// rows `pitch` elements apart.
template <int K, typename T>
__device__ __forceinline__ int median_window(const T* w0, int pitch) {
  int w[K * K];
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) w[dy * K + dx] = int(w0[dy * pitch + dx]);
  }
  if constexpr (K == 3) {
    return median9(w);
  } else {
    return median25(w);
  }
}

}  // namespace
