// The REFLECT_101 border index shared by conv.cu (the Gaussian halo) and
// clahe.cu (the pad of non-divisible CLAHE geometries).  The Python plain
// versions use kernels/conv.py::reflect101, the same rule.
#pragma once

namespace {

// numpy.pad(mode="reflect") index: period 2(n-1), so a halo or pad deeper
// than the plane reflects again; a 1-pixel axis repeats its only pixel.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int m = 2 * (n - 1);
  i %= m;
  if (i < 0) i += m;
  return i >= n ? m - i : i;
}

}  // namespace
