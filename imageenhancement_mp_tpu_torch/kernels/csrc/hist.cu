// Histogram-family kernels for u8 planes: the per-plane 256-bin histogram,
// cv2's equalizeHist LUT built from it, and the per-plane 256-entry LUT apply.
//
// Each exported function launches on the caller's stream, allocates nothing,
// and returns the cudaError_t of cudaGetLastError() right after its launch.
// Built with -fmad=false and without --use_fast_math: every rounding below
// is the one written (int->f32 conversion to nearest, IEEE division and
// product, rintf half-to-even).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Bytes one block covers in the streaming kernels: 256 threads x 16 vectors
// of 16 B.  Planes larger than this get several blocks each.
constexpr int64_t kBytesPerBlock = int64_t(kThreads) * 16 * 16;
constexpr int64_t kMaxGridY = 65535;  // planes beyond it stride over gridDim.y

// A plane's bytes as an unaligned head, a body of 16-byte vectors and a tail.
struct Split {
  int64_t head;        // bytes before the first 16-byte boundary
  int64_t nvec;        // uint4 vectors in the body
  int64_t tail_start;  // first byte after the body
};

__device__ __forceinline__ Split split_plane(const uint8_t* p, int64_t n) {
  int64_t head = int64_t((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  if (head > n) head = n;
  const int64_t nvec = (n - head) >> 4;
  return {head, nvec, head + (nvec << 4)};
}

int blocks_per_plane(int64_t n) {
  int64_t b = (n + kBytesPerBlock - 1) / kBytesPerBlock;
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return int(b);
}

// ---------------------------------------------------------------------------
// hist256: replaces the JAX package's kernels/hist.py::hist256_pallas
// (the nibble one-hot MXU dot, whose f32 accumulation forced 2^17-pixel
// stripes).  Here the bound is device memory: 1 B/px read once.  Each warp
// counts into its own 256 shared-memory bins, which cuts contention on equal
// values to one warp; each thread reads 16 B per load.  Blocks merge into the
// zeroed [B,256] output with atomicAdd.  The counts are integers, so the
// result does not depend on the order of the atomics.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void count4(int32_t* bins, uint32_t w) {
  atomicAdd(&bins[w & 255u], 1);
  atomicAdd(&bins[(w >> 8) & 255u], 1);
  atomicAdd(&bins[(w >> 16) & 255u], 1);
  atomicAdd(&bins[w >> 24], 1);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out, int64_t B, int64_t n) {
  __shared__ int32_t bins[kWarps][256];
  const int tid = threadIdx.x;
  const int64_t g = int64_t(blockIdx.x) * kThreads + tid;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  int32_t* mine = bins[tid >> 5];

  // planes stride over gridDim.y, so any number of planes fits the grid
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    for (int i = tid; i < kWarps * 256; i += kThreads) (&bins[0][0])[i] = 0;
    __syncthreads();

    const uint8_t* p = x + b * n;
    const Split s = split_plane(p, n);
    const uint4* pv = reinterpret_cast<const uint4*>(p + s.head);
    for (int64_t i = g; i < s.nvec; i += stride) {
      const uint4 v = pv[i];
      count4(mine, v.x);
      count4(mine, v.y);
      count4(mine, v.z);
      count4(mine, v.w);
    }
    for (int64_t i = g; i < s.head; i += stride) atomicAdd(&mine[p[i]], 1);
    for (int64_t i = s.tail_start + g; i < n; i += stride) atomicAdd(&mine[p[i]], 1);
    __syncthreads();

    int32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += bins[w][tid];
    if (sum) atomicAdd(&out[b * 256 + tid], sum);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// equalize_lut256: replaces the LUT phase of
// the JAX package's kernels/hist.py::equalize_hist_pallas (triangular
// dots on the MXU) and the XLA equalize_lut of ops/histogram.py:92-111.  One
// block of 256 threads per plane; the work is 256 values, so launch latency
// bounds it.  A warp-shuffle inclusive scan gives the cdf; the first nonzero
// bin i0 is the number of bins whose cdf is still 0.  Then
//   lut = clamp(rint(f32(cdf - h0) * f32(255 / f32(max(total - h0, 1)))), 0, 255)
// with the identity when h0 == total (a constant plane), exactly the law of
// ops/histogram.py::equalize_lut.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
equalize_lut256_kernel(const int32_t* __restrict__ hist, uint8_t* __restrict__ lut,
                       int32_t total) {
  __shared__ int32_t warp_sums[8];
  __shared__ int32_t s_h0;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t b = blockIdx.x;

  const int32_t h = hist[b * 256 + t];
  int32_t c = h;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += up;
  }
  if (lane == 31) warp_sums[warp] = c;
  if (t == 0) s_h0 = 0;  // stays 0 for an all-zero histogram
  __syncthreads();
  int32_t cdf = c;
  for (int w = 0; w < warp; ++w) cdf += warp_sums[w];

  const int i0 = __syncthreads_count(cdf == 0);
  if (t == i0) s_h0 = h;
  __syncthreads();
  const int32_t h0 = s_h0;

  int32_t v = t;
  if (h0 != total) {
    const int32_t denom = max(total - h0, 1);
    const float scale = __fdiv_rn(255.0f, __int2float_rn(denom));
    const float r = rintf(__fmul_rn(__int2float_rn(cdf - h0), scale));
    v = __float2int_rn(fminf(fmaxf(r, 0.0f), 255.0f));
  }
  lut[b * 256 + t] = uint8_t(v);
}

// ---------------------------------------------------------------------------
// apply_lut256: replaces the JAX package's kernels/hist.py::
// apply_lut256_pallas for u8 tables (two 128-lane vreg gathers + select on the
// TPU).  Bound by device memory at 2 B/px.  The block stages its plane's table
// in shared memory and maps 16 B per thread per load; when input and output
// are not equally aligned it maps byte by byte.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t map4(const uint8_t* tab, uint32_t w) {
  return uint32_t(tab[w & 255u]) | (uint32_t(tab[(w >> 8) & 255u]) << 8) |
         (uint32_t(tab[(w >> 16) & 255u]) << 16) | (uint32_t(tab[w >> 24]) << 24);
}

__global__ void __launch_bounds__(kThreads)
apply_lut256_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ luts,
                    int64_t lut_stride, uint8_t* __restrict__ out, int64_t B, int64_t n) {
  __shared__ uint8_t tab[256];
  const int tid = threadIdx.x;
  const int64_t g = int64_t(blockIdx.x) * kThreads + tid;
  const int64_t stride = int64_t(gridDim.x) * kThreads;

  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous plane's reads of tab are done
    tab[tid] = luts[b * lut_stride + tid];
    __syncthreads();

    const uint8_t* p = x + b * n;
    uint8_t* q = out + b * n;
    Split s = split_plane(p, n);
    if ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) & 15) {
      s = {n, 0, n};  // mismatched alignment: the whole plane is "head"
    }
    const uint4* pv = reinterpret_cast<const uint4*>(p + s.head);
    uint4* qv = reinterpret_cast<uint4*>(q + s.head);
    for (int64_t i = g; i < s.nvec; i += stride) {
      const uint4 v = pv[i];
      qv[i] = make_uint4(map4(tab, v.x), map4(tab, v.y), map4(tab, v.z), map4(tab, v.w));
    }
    for (int64_t i = g; i < s.head; i += stride) q[i] = tab[p[i]];
    for (int64_t i = s.tail_start + g; i < n; i += stride) q[i] = tab[p[i]];
  }
}

}  // namespace

extern "C" {

const char* ie_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

// x: [B, n] u8 contiguous; out: [B, 256] int32, zeroed by the caller.
int ie_hist256(const uint8_t* x, int32_t* out, int64_t B, int64_t n, cudaStream_t stream) {
  if (B < 1 || n < 1) return int(cudaErrorInvalidValue);
  const dim3 grid(blocks_per_plane(n), unsigned(B < kMaxGridY ? B : kMaxGridY));
  hist256_kernel<<<grid, kThreads, 0, stream>>>(x, out, B, n);
  return int(cudaGetLastError());
}

// hist: [B, 256] int32 with each row summing to total; lut: [B, 256] u8.
int ie_equalize_lut256(const int32_t* hist, uint8_t* lut, int64_t B, int64_t total,
                       cudaStream_t stream) {
  if (B < 1 || B > 0x7fffffffLL || total < 0 || total > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  equalize_lut256_kernel<<<unsigned(B), 256, 0, stream>>>(hist, lut, int32_t(total));
  return int(cudaGetLastError());
}

// x, out: [B, n] u8 contiguous; luts: row b at luts + b * lut_stride
// (lut_stride 0 shares one table, 256 gives one per plane).
int ie_apply_lut256(const uint8_t* x, const uint8_t* luts, int64_t lut_stride, uint8_t* out,
                    int64_t B, int64_t n, cudaStream_t stream) {
  if (B < 1 || n < 1) return int(cudaErrorInvalidValue);
  const dim3 grid(blocks_per_plane(n), unsigned(B < kMaxGridY ? B : kMaxGridY));
  apply_lut256_kernel<<<grid, kThreads, 0, stream>>>(x, luts, lut_stride, out, B, n);
  return int(cudaGetLastError());
}

}  // extern "C"
