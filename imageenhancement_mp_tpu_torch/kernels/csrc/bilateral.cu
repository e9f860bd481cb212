// bilateral_gray_kernel: cv2.bilateralFilter on u8 gray planes, REFLECT_101
// border, any disc radius 1..25, exact against ref/ops.py::bilateral_filter.
//
// Replaces the JAX package's kernels/bilateral.py::bilateral_gray_pallas
// (_bilateral_jit: row stripes with host-built halo side arrays, lane rolls
// plus recomputed 128-lane edge strips, the f32 LUT through a two-vreg
// dynamic-gather chain; W % 128 == 0, H % 8 == 0, radius <= 8 only, the rest
// on a per-offset XLA loop).  Here one kernel family takes every shape and
// radius.
//
// The law, per disc offset in the scan order of ops/bilateral.py::
// bilateral_offsets (i outer, j inner), each operation rounded once (built
// with -fmad=false; the intrinsics state it):
//   w = w0 * lut[|v - c|];  num = num + v * w;  den = den + w
// then out = sat_u8(rint(num / den)) with an IEEE division (the TPU's divide
// is about 2 ulp, which is why K10 is +-1 there).  The sums are sequential
// in disc order, so the order of the walk is fixed; a visit whose weight is
// +0 leaves num and den as they are (x + 0 = x for x >= +0).
//
// What bounds it on this card: issue, not memory.  At d = 9 a pixel visits 49
// offsets against 2 B/px of device traffic, and each visit needs its four
// rounded f32 operations, a colour-table gather whose index depends on the
// data, and the integer work that forms the gather's address.  Design:
//  * A thread owns kT = 8 horizontally adjacent outputs of one row; the 32
//    lanes of a warp are 32 rows, the 8 warps of a block 8 column groups, so
//    a block covers a 32 x 64 tile.  Blocks are persistent: each walks
//    (plane, row tile, column tile) items strided by the grid, which is as
//    large as the card holds at once.
//  * The tile and its halo are staged in shared memory once per item as
//    32-bit words 0x4B000000 | v, the f32 value 2^23 + v: v - c is one
//    integer subtraction of two words, and float(v) = word - 2^23 is exact
//    (no I2F per visit).  Halo columns are rounded up to whole 16-byte
//    chunks, the row pitch is 4 times an odd number of words, so the 8 lanes
//    of a 128-bit load phase (8 rows) hit 8 distinct bank quads.
//  * For each disc row i the thread loads its window, columns x - J_i ..
//    x + 7 + J_i of row y + i (J_i = isqrt(R^2 - i^2)), into registers with
//    128-bit loads, converts each word once, and walks j = -J_i .. J_i for
//    all 8 outputs from registers.
//  * The colour table has 32 lane copies, entry e of lane l at e * 32 + l,
//    so a warp's 32 gathers hit 32 distinct banks whatever the data.  It
//    holds 511 entries indexed by v - c + 255 (the table mirrored, 64 KB),
//    so the byte address is one add of a per-window-element v * 128 and a
//    per-output (255 - c) * 128 + 4 l: no abs, no shift per visit.  (256
//    entries indexed by |v - c| took 0.3137 ms against 0.2387 at d 9 on
//    2x2160x3840 on an H100, PERF.md.)
//  * Radii 1..5 (d 3..11) are compile-time instances: their rows (i, J_i)
//    and loops are immediates and w0 is a kernel parameter, so FMUL reads it
//    from the constant bank.  R = 0 is the runtime instance for every radius:
//    its disc lives in shared memory as rows of 4-wide j blocks padded with
//    weight 0, each block one 12-word window.

#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

#include "reflect.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;                  // outputs per thread, adjacent in a row
constexpr int kTileW = kWarps * kT;    // 64
constexpr int kTileH = 32;             // one row per lane
constexpr int kMaxR = 25;              // kernels/bilateral.py MAX_RADIUS
constexpr int kMaxCompileR = 5;        // d 3..11: compile-time instances
constexpr int kMaxCompileOffsets = (2 * kMaxCompileR + 1) * (2 * kMaxCompileR + 1);
constexpr int kPadW = 2 * ((kMaxR + 3) & ~3) + 4;  // a padded disc row of the runtime instance
constexpr uint32_t kMagic = 0x4B000000u;           // the bits of f32 2^23
constexpr float kTwo23 = 8388608.0f;
constexpr int kMaxSmem = 232448;                   // the H100's opt-in limit per block

struct Disc {  // w0 of the compile-time instances, in disc order
  float w0[kMaxCompileOffsets];
};

__host__ __device__ constexpr int align4(int v) { return (v + 3) & ~3; }
// a row pitch of 4 * odd words: 8 rows of one 128-bit load phase, 8 bank quads
__host__ __device__ constexpr int pitch_for(int w) { return (align4(w) / 4) % 2 ? align4(w) : align4(w) + 4; }
__host__ __device__ constexpr int isqrt_c(int n) {
  int r = 0;
  while ((r + 1) * (r + 1) <= n) ++r;
  return r;
}
// disc index of (i, -J_i): the offsets of rows -R .. i-1
__host__ __device__ constexpr int row_start(int R, int i) {
  int k = 0;
  for (int q = -R; q < i; ++q) k += 2 * isqrt_c(R * R - q * q) + 1;
  return k;
}
constexpr int kLutFloats = 511 * 32;
__host__ __device__ constexpr int tile_in_w(int R, bool runtime) {
  return kTileW + 2 * align4(R) + (runtime ? 4 : 0);
}

__device__ __forceinline__ float word_value(uint32_t w) { return __fsub_rn(__uint_as_float(w), kTwo23); }

// the colour weight of one visit: the table's bytes at vkey + ckey =
// (v - c + 255) * 128 + 4 l, the magic words' 2^23 * 128 cancelling mod 2^32
__device__ __forceinline__ float lut_at(const char* lut, uint32_t vkey, uint32_t ckey) {
  return *reinterpret_cast<const float*>(lut + (vkey + ckey));
}
// per window element: v * 128 (mod 2^32)
__device__ __forceinline__ uint32_t vkey_of(uint32_t w) { return w << 7; }
// per output: (255 - c) * 128 + 4 l (mod 2^32)
__device__ __forceinline__ uint32_t ckey_of(uint32_t c, uint32_t lane4) { return ((255u - c) << 7) + lane4; }

// one disc row I of a compile-time radius R for the thread's kT outputs
template <int R, int I>
__device__ __forceinline__ void disc_row(const uint32_t* row, const char* lut, const uint32_t (&ckey)[kT],
                                         const Disc& disc, float (&num)[kT],
                                         float (&den)[kT]) {
  constexpr int J = isqrt_c(R * R - I * I);
  constexpr int A = align4(J);
  constexpr int N = kT + 2 * A;  // window words, from column -A
  constexpr int K0 = row_start(R, I);
  uint32_t key[N];
  float vf[N];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const uint4 c = reinterpret_cast<const uint4*>(row - A)[q];
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      key[4 * q + e] = vkey_of(w[e]);
      vf[4 * q + e] = word_value(w[e]);
    }
  }
#pragma unroll
  for (int j = -J; j <= J; ++j) {
    const float w0 = disc.w0[K0 + j + J];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int e = A + t + j;
      const float w = __fmul_rn(w0, lut_at(lut, key[e], ckey[t]));
      num[t] = __fadd_rn(num[t], __fmul_rn(vf[e], w));
      den[t] = __fadd_rn(den[t], w);
    }
    // keeps the unrolled disc from hoisting later gathers and windows above
    // this step, which ran out of registers (spills at 128 per thread)
    asm volatile("" ::: "memory");
  }
}

template <int R, int I>
__device__ __forceinline__ void disc_rows(const uint32_t* centre, int pitch, const char* lut,
                                          const uint32_t (&ckey)[kT],
                                          const Disc& disc, float (&num)[kT], float (&den)[kT]) {
  if constexpr (I <= R) {
    disc_row<R, I>(centre + I * pitch, lut, ckey, disc, num, den);
    disc_rows<R, I + 1>(centre, pitch, lut, ckey, disc, num, den);
  }
}

// R > 0: compile-time radius R (r unused); R == 0: runtime radius r, the disc
// from offsets ([n, 3] f32 (i, j, w0) in disc order, validated on the host)
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
bilateral_gray_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int64_t B, int H,
                      int W, const float* __restrict__ lut_g, const __grid_constant__ Disc disc,
                      const float* __restrict__ offsets, int r) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRuntime = R == 0;
  const int rad = kRuntime ? r : R;
  const int ra = align4(rad);
  const int in_w = tile_in_w(rad, kRuntime), in_h = kTileH + 2 * rad;
  const int pitch = pitch_for(in_w);
  float* lut = smem;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + kLutFloats);
  float* wpad = reinterpret_cast<float*>(tile + in_h * pitch);  // runtime: [2r+1][kPadW]
  int* rowj = reinterpret_cast<int*>(wpad + (2 * rad + 1) * kPadW);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t lane4 = uint32_t(lane) * 4;
  for (int k = tid; k < kLutFloats; k += kThreads) {
    const int e = k >> 5;
    lut[k] = lut_g[abs(e - 255)];
  }
  if constexpr (kRuntime) {
    for (int ii = tid; ii <= 2 * rad; ii += kThreads) {
      const int i = ii - rad, n2 = rad * rad - i * i;
      int J = int(sqrtf(float(n2)));
      while ((J + 1) * (J + 1) <= n2) ++J;
      while (J * J > n2) --J;
      rowj[ii] = J;
    }
    __syncthreads();
    // weights padded with 0 to whole 4-wide blocks from j = -align4(J)
    for (int k = tid; k < (2 * rad + 1) * kPadW; k += kThreads) {
      const int ii = k / kPadW, q = k - ii * kPadW;
      const int J = rowj[ii], j = q - align4(J);
      int start = 0;
      for (int p = 0; p < ii; ++p) start += 2 * rowj[p] + 1;
      wpad[k] = (j >= -J && j <= J) ? offsets[3 * (start + j + J) + 2] : 0.0f;
    }
  }

  const char* lut_b = reinterpret_cast<const char*>(lut);
  const int64_t ntx = (W + kTileW - 1) / kTileW, nty = (H + kTileH - 1) / kTileH;
  const int64_t items = B * nty * ntx;
  // the compile-time instances stage in one round trip, the runtime one in
  // chunks of 6 row steps (2 at radius 25)
  constexpr int kRows = kRuntime ? 6 : (kTileH + 2 * R + kWarps - 1) / kWarps;
  constexpr int kCols = (tile_in_w(kRuntime ? kMaxR : R, kRuntime) + 31) / 32;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const TileItem cur = tile_item(item, ntx, nty, H, W, kTileH, kTileW);
    const int64_t plane = cur.plane;
    const int x0 = cur.x0, y0 = cur.y0;
    __syncthreads();  // the tables are written; the previous item is done with the tile
    stage_tile<kRows, kCols>(tile, pitch, x + plane, H, W, y0 - rad, x0 - ra, in_h, in_w,
                             [](int i, int n) { return reflect101(i, n); },
                             [](uint32_t v) { return kMagic | v; });
    __syncthreads();

    const int col = ra + kT * warp;  // the tile column of the thread's first output
    const uint32_t* centre = tile + (lane + rad) * pitch + col;
    uint32_t ckey[kT];
    float num[kT], den[kT];
    {
      const uint4 c0 = reinterpret_cast<const uint4*>(centre)[0];
      const uint4 c1 = reinterpret_cast<const uint4*>(centre)[1];
      const uint32_t c[kT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        ckey[t] = ckey_of(c[t], lane4);
        num[t] = 0.0f;
        den[t] = 0.0f;
      }
    }
    if constexpr (!kRuntime) {
      disc_rows<R, -R>(centre, pitch, lut_b, ckey, disc, num, den);
    } else {
      for (int ii = 0; ii <= 2 * rad; ++ii) {
        const int J = rowj[ii], a = align4(J);
        const int nb = (J + a + 4) >> 2;  // 4-wide blocks covering -a .. J
        const uint32_t* row = centre + (ii - rad) * pitch - a;
        const float* wrow = wpad + ii * kPadW;
        for (int q = 0; q < nb; ++q) {
          uint32_t key[12];
          float vf[12];
#pragma unroll
          for (int h = 0; h < 3; ++h) {
            const uint4 c = reinterpret_cast<const uint4*>(row + 4 * q)[h];
            const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              key[4 * h + e] = vkey_of(w[e]);
              vf[4 * h + e] = word_value(w[e]);
            }
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float w0 = wrow[4 * q + s];
#pragma unroll
            for (int t = 0; t < kT; ++t) {
              const float w = __fmul_rn(w0, lut_at(lut_b, key[t + s], ckey[t]));
              num[t] = __fadd_rn(num[t], __fmul_rn(vf[t + s], w));
              den[t] = __fadd_rn(den[t], w);
            }
          }
        }
      }
    }

    const int y = y0 + lane, xs = x0 + kT * warp;
    if (y < H && xs < W) {
      uint8_t o[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float v = rintf(__fdiv_rn(num[t], den[t]));
        o[t] = uint8_t(__float2int_rn(fminf(fmaxf(v, 0.0f), 255.0f)));
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

size_t smem_bytes(int R, bool runtime) {
  const size_t tile = size_t(kTileH + 2 * R) * pitch_for(tile_in_w(R, runtime)) * 4;
  const size_t disc = runtime ? size_t(2 * R + 1) * (kPadW + 1) * 4 : 0;
  return size_t(kLutFloats) * 4 + tile + disc;
}

template <int R>
int launch_instance(const uint8_t* x, uint8_t* out, int64_t B, int H, int W, const float* lut,
                    const Disc& disc, const float* offsets, int r, cudaStream_t stream) {
  const auto kernel = bilateral_gray_kernel<R>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return int(attr);
  const size_t smem = smem_bytes(r, R == 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (occ != cudaSuccess) return int(occ);
  const int64_t items = B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  const int64_t full = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = unsigned(items < full ? items : full);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, B, H, W, lut, disc, offsets, r);
  return int(cudaGetLastError());
}

int dispatch(const uint8_t* x, uint8_t* out, int64_t B, int H, int W, const float* lut,
             const Disc& disc, const float* offsets, int r, bool runtime, cudaStream_t stream) {
  if (!runtime) switch (r) {
      case 1: return launch_instance<1>(x, out, B, H, W, lut, disc, offsets, r, stream);
      case 2: return launch_instance<2>(x, out, B, H, W, lut, disc, offsets, r, stream);
      case 3: return launch_instance<3>(x, out, B, H, W, lut, disc, offsets, r, stream);
      case 4: return launch_instance<4>(x, out, B, H, W, lut, disc, offsets, r, stream);
      case 5: return launch_instance<5>(x, out, B, H, W, lut, disc, offsets, r, stream);
      default: break;
    }
  return launch_instance<0>(x, out, B, H, W, lut, disc, offsets, r, stream);
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous on the device.  offsets: [n, 3] f32 (i, j,
// w0) on the device, the whole radius-`radius` disc in disc order (n its
// size; kernels/bilateral.py checks the rows); w0_host: the same n weights on
// the host, for the compile-time instances' parameters; lut: [256] f32 colour
// weights on the device; radius 1..25.  runtime: 1 takes the runtime
// instance at every radius (for A/Bs), 0 the compile-time one where there is
// one (radius <= 5).
int ie_bilateral(const uint8_t* x, uint8_t* out, int64_t B, int64_t H, int64_t W,
                 const float* offsets, int32_t n, const float* lut, int32_t radius,
                 const float* w0_host, int32_t runtime, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kTileH || W > 0x7fffffffLL - kTileW ||
      radius < 1 || radius > kMaxR || n != row_start(radius, radius + 1) ||
      (runtime != 0 && runtime != 1) || w0_host == nullptr)
    return int(cudaErrorInvalidValue);
  Disc disc{};
  if (radius <= kMaxCompileR)
    for (int k = 0; k < n; ++k) disc.w0[k] = w0_host[k];
  return dispatch(x, out, B, int(H), int(W), lut, disc, offsets, radius, runtime, stream);
}

}  // extern "C"
