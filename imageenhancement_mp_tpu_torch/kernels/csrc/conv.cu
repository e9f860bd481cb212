// sep_conv_u8: cv2's u8 fixed-point separable Gaussian with REFLECT_101
// borders, an optional per-plane 256-entry LUT applied to the pixels as they
// are loaded, and an optional unsharp epilogue addWeighted(src, 1+a, blur, -a).
//
// Replaces the JAX package's kernels/conv2.py::_sep_conv5_wide_jit (the
// pallas_call at conv2.py:326, function at :292: packed pixel pairs, banded
// bf16 MXU pass, vreg-gather LUT) and kernels/conv.py::_sep_conv_planes (the
// pallas_call at conv.py:194, function at :134: any shape, host pad) with
// one kernel family for every shape and every odd ksize per axis: the
// instances below take ksize <= 31 by value; the wide instance at the end
// takes any odd ksize, its taps from a device buffer.
//
// What bounds it on this card: device memory, 2 B/px (one byte read, one
// written), 0.0099 ms at 8x1080x1920.  Design, per warp: 32 lanes of 8
// adjacent columns each; the outer lane on each side (two in the runtime
// instance) only supplies the horizontal halo, so a warp writes 240 (224)
// columns.  A warp walks down 8 output rows; a block is 8 such warps stacked
// (64 rows) and strides over (plane, row block) pairs on gridDim.y.
//  - Staging without division: a lane's columns are fixed, so their
//    REFLECT_101 indices are computed once; rows reflect once per row.  An
//    interior lane of an 8-byte-aligned plane loads a row's 8 bytes as one
//    uint2; edge lanes, and planes whose rows are not 8-byte aligned
//    (W % 8 != 0, a storage offset), load byte by byte.  A warp's k + 7
//    input rows are all loaded before any is used, so the loads are in
//    flight together.  The LUT is a 256-byte shared table applied as the
//    bytes are unpacked.
//  - Vertical pass on two 16-bit lanes per 32-bit word (lo + hi * 2^16):
//    every vertical sum is <= 255 * 256, so one IMAD does two pixels for any
//    accepted tap set.  The compile-time instances (k 3, 5, 7 on both axes)
//    keep a rolling window of k packed rows in registers, so each input row
//    is loaded once per lane; the runtime instance (every other k) loads
//    each input row once too and adds it into the 8 output rows it reaches.
//  - Horizontal pass from registers: the neighbouring columns come from the
//    neighbouring lanes by __shfl (the runtime instance reads them from a
//    per-warp shared row, 16 bytes per lane and load, and runs every offset
//    up to 15 with those beyond its radius skipped).  Where
//    the taps reduced by their common power of two have scales qv * qh <=
//    256 (sigma 0 at k 3 and 5: [1,2,1], q 4; [1,4,6,4,1], q 16), both passes
//    use the reduced taps and the horizontal pass stays packed: every sum is
//    <= 255 * qv * qh <= 65535, so no carry crosses a lane, and the rounding
//    is (acc + q/2) >> log2 q, which equals cv2's (acc8 + 2^15) >> 16 since
//    acc8 = acc * 65536 / q.  Other taps run the horizontal pass in int32 on
//    cv2's Q8 taps, one pixel per IMAD, rounded as (acc + 2^15) >> 16.
//  - Stores: the pairs go back to bytes with one PRMT per 4 pixels and one
//    8-byte store per lane where aligned; ragged row ends store bytes.
//
// Why CUDA cores and not wgmma: the vertical pass could be a banded u8
// product on the tensor cores, as the TPU's general-sigma route used the MXU,
// but that does (th + 2r)/k times more MACs and still needs the horizontal
// pass and the epilogue on the CUDA cores.  This design aims at about 20-30
// instructions per pixel, about 0.01-0.015 ms of issue at 16.6 Mpx, the same
// as the 0.0099 ms bytes floor.  Measured on an H100 (700 W) at 8x1080x1920,
// k 5, sigma 0, LUT, amount 1, it takes about 0.030 ms, 3x that floor; how
// many instructions a pixel really issues is not measured (no ncu there).
// The static SASS of that instance holds about 3600 instructions for 8 rows
// of 8 columns per lane with both load paths unrolled: at 0.030 ms the SMs
// could issue at most about 61 per pixel.
//
// The epilogue is cv2's two single-rounded f32 FMAs for every amount:
//   t = fmul_rn(blur, beta); r = fmaf_rn(src, alpha, t); out = clamp(rint(r))
// with alpha = f32(1 + amount), beta = f32(-amount) computed by the caller,
// right for negative amounts too.  For an integral amount a in [0, 127]
// (mode 1) every product is an integer below 2^24, so those FMAs are exact
// and out = clamp((1 + a) * src - a * blur, 0, 255); it runs on the packed
// lanes as (1 + a) * S + 256a - a * B, each lane in [a, 255 + 511a] <= 65535,
// clamped to [256a, 256a + 255] with two 16x2 min/max, whose low byte is out.
// The epilogue (0 blur, 1 lanes, 2 the two FMAs) is a template parameter:
// each instance compiles one.

#include <cstdint>
#include <cuda_runtime.h>

#include "reflect.cuh"

namespace {

constexpr int kMaxTaps = 31;
constexpr int kMaxR = kMaxTaps / 2;
constexpr int kCols = 8;             // columns per lane
constexpr int kWords = kCols / 2;    // packed 16-bit pairs per lane
constexpr int kRows = 8;             // output rows per warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// 3 blocks of 8 warps per SM: ptxas keeps an instance in 80 registers.  On
// an H100, at the main path's k 5 with LUT and amount 1, this was the
// fastest of 2, 3 and 4 blocks and 4 to 16 rows per warp (6 rows at 4
// blocks tied), these constants swept on the card.
constexpr int kMinBlocks = 3;
constexpr int kBlockRows = kRows * kWarps;
constexpr int64_t kMaxGridY = 65535;  // (plane, row block) pairs beyond it stride over gridDim.y
constexpr unsigned kFull = 0xffffffffu;

struct ConvArgs {
  const uint8_t* x;
  uint8_t* out;
  const uint8_t* luts;  // [B, 256] or null
  int64_t B;
  int32_t H, W;
  // the route's taps (reduced on the packed route); th centred in the runtime instance
  int32_t tv[kMaxTaps], th[kMaxTaps];
  const int32_t* wtaps;  // the wide instance's taps on the device: kv vertical, then kh horizontal
  int32_t kv, kh;
  int32_t shift, half;  // blur = (acc + half) >> shift
  uint32_t mul_s, mul_b, bias2, lo2, hi2;  // epilogue 1: 1 + a, a, 256a per lane, clamp bounds
  float alpha, beta;    // epilogue 2
  int32_t vec_in, vec_out;  // base pointer and row pitch 8-byte aligned
};

// One input row's 8 columns of this lane, as loaded: one uint2 where the
// lane lies inside an aligned row, else 8 bytes at their REFLECT_101 columns.
__device__ __forceinline__ uint2 fetch_row(const uint8_t* __restrict__ row, int xc, bool fast,
                                           const int (&cidx)[kCols]) {
  if (fast) return *reinterpret_cast<const uint2*>(row + xc);
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < kCols; ++i) w[i >> 2] |= uint32_t(row[cidx[i]]) << (8 * (i & 3));
  return make_uint2(w[0], w[1]);
}

// The 8 bytes as 4 packed pairs (lo + hi * 2^16), the LUT applied.
__device__ __forceinline__ void unpack_row(uint32_t (&p)[kWords], uint2 raw, bool use_lut,
                                           const uint8_t* lut) {
  if (!use_lut) {
    p[0] = __byte_perm(raw.x, 0, 0x4140);
    p[1] = __byte_perm(raw.x, 0, 0x4342);
    p[2] = __byte_perm(raw.y, 0, 0x4140);
    p[3] = __byte_perm(raw.y, 0, 0x4342);
    return;
  }
  uint32_t v[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) v[i] = lut[((i < 4 ? raw.x : raw.y) >> (8 * (i & 3))) & 0xffu];
#pragma unroll
  for (int m = 0; m < kWords; ++m) p[m] = v[2 * m] | (v[2 * m + 1] << 16);
}

template <int EPI>
__device__ __forceinline__ uint32_t epilogue(uint32_t bl, uint32_t s, const ConvArgs& a) {
  if constexpr (EPI == 0) {
    return bl;
  } else if constexpr (EPI == 1) {
    const uint32_t w = s * a.mul_s + a.bias2 - bl * a.mul_b;
    return __vminu2(__vmaxu2(w, a.lo2), a.hi2);
  } else {
    uint32_t res[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bv = int((bl >> (16 * h)) & 0xffffu), sv = int((s >> (16 * h)) & 0xffffu);
      const float t = __fmul_rn(__int2float_rn(bv), a.beta);
      const float r = __fmaf_rn(__int2float_rn(sv), a.alpha, t);
      res[h] = uint32_t(__float2int_rn(fminf(fmaxf(rintf(r), 0.0f), 255.0f)));
    }
    return res[0] | (res[1] << 16);
  }
}

// The epilogue, bytes 0 and 2 of each lane pair back to 8 bytes, the store.
template <int EPI>
__device__ __forceinline__ void finish_row(uint8_t* __restrict__ orow, int xc, int W, bool fast_out,
                                           const uint32_t (&bl)[kWords],
                                           const uint32_t (&s)[kWords], const ConvArgs& a) {
  uint32_t r[kWords];
#pragma unroll
  for (int m = 0; m < kWords; ++m) r[m] = epilogue<EPI>(bl[m], s[m], a);
  const uint32_t lo = __byte_perm(r[0], r[1], 0x6420), hi = __byte_perm(r[2], r[3], 0x6420);
  if (fast_out) {
    *reinterpret_cast<uint2*>(orow + xc) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (xc + i < W) orow[xc + i] = uint8_t((i < 4 ? lo : hi) >> (8 * (i & 3)));
  }
}

// Horizontal pass of the compile-time instances: e[] holds this lane's
// vertical pairs with HW pairs of each neighbouring lane on either side.
template <int KH, bool PACKED>
__device__ __forceinline__ void hpass_lanes(uint32_t (&bl)[kWords], const uint32_t (&v)[kWords],
                                            const ConvArgs& a) {
  constexpr int RH = KH / 2, HW = (RH + 1) / 2, NE = kWords + 2 * HW;
  uint32_t e[NE];
#pragma unroll
  for (int m = 0; m < HW; ++m) e[m] = __shfl_up_sync(kFull, v[kWords - HW + m], 1);
#pragma unroll
  for (int m = 0; m < kWords; ++m) e[HW + m] = v[m];
#pragma unroll
  for (int m = 0; m < HW; ++m) e[HW + kWords + m] = __shfl_down_sync(kFull, v[m], 1);
  // column c of e (c = 0 is this lane's column -2HW) starts at pair t = c
  if constexpr (PACKED) {
    uint32_t o[NE - 1];  // the odd pairs (columns 2m+1, 2m+2)
#pragma unroll
    for (int m = 0; m < NE - 1; ++m) o[m] = __byte_perm(e[m], e[m + 1], 0x5432);
    const uint32_t half2 = uint32_t(a.half) * 0x00010001u;
#pragma unroll
    for (int p = 0; p < kWords; ++p) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const int t = 2 * p + j - RH + 2 * HW;
        acc += uint32_t(a.th[j]) * ((t & 1) ? o[t >> 1] : e[t >> 1]);
      }
      bl[p] = ((acc + half2) >> a.shift) & 0x00ff00ffu;
    }
  } else {
    int32_t col[2 * NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
      col[2 * m] = int32_t(e[m] & 0xffffu);
      col[2 * m + 1] = int32_t(e[m] >> 16);
    }
    int32_t b[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      int32_t acc = 0;
#pragma unroll
      for (int j = 0; j < KH; ++j) acc += a.th[j] * col[i + j - RH + 2 * HW];
      b[i] = min((acc + a.half) >> a.shift, 255);
    }
#pragma unroll
    for (int p = 0; p < kWords; ++p) bl[p] = uint32_t(b[2 * p]) | (uint32_t(b[2 * p + 1]) << 16);
  }
}

// Horizontal pass of the runtime instance.  The warp's vertical pairs go
// through shared memory (hb: one 16-byte word per lane), and each output lane
// loads those of lanes lane-2 .. lane+2, so it holds columns -16 .. 23 of its
// own in registers.  The taps' offsets are then compile-time: the loop runs
// over every offset a 31-tap row can have and skips, uniformly across the
// warp, those beyond this row's radius.  a.th holds the taps centred:
// a.th[kMaxR + d] is offset d's.
template <bool PACKED>
__device__ __forceinline__ void hpass_shared(uint32_t (&bl)[kWords], const uint4* hb, int lane,
                                             const ConvArgs& a) {
  constexpr int NE = 5 * kWords, C0 = 2 * kCols;  // C0: this lane's first column in e
  uint32_t e[NE];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const uint4 w = hb[lane - 2 + q];
    e[4 * q] = w.x;
    e[4 * q + 1] = w.y;
    e[4 * q + 2] = w.z;
    e[4 * q + 3] = w.w;
  }
  const int rh = a.kh >> 1;
  if constexpr (PACKED) {
    uint32_t o[NE - 1];  // the odd pairs (columns 2m+1, 2m+2)
#pragma unroll
    for (int m = 0; m < NE - 1; ++m) o[m] = __byte_perm(e[m], e[m + 1], 0x5432);
    uint32_t acc[kWords] = {};
#pragma unroll
    for (int d = -kMaxR; d <= kMaxR; ++d) {
      if (d < -rh || d > rh) continue;
      const uint32_t t = uint32_t(a.th[kMaxR + d]);
#pragma unroll
      for (int p = 0; p < kWords; ++p) {
        const int c = C0 + 2 * p + d;
        acc[p] += t * ((c & 1) ? o[c >> 1] : e[c >> 1]);
      }
    }
    const uint32_t half2 = uint32_t(a.half) * 0x00010001u;
#pragma unroll
    for (int p = 0; p < kWords; ++p) bl[p] = ((acc[p] + half2) >> a.shift) & 0x00ff00ffu;
  } else {
    int32_t acc[kCols] = {};
#pragma unroll
    for (int d = -kMaxR; d <= kMaxR; ++d) {
      if (d < -rh || d > rh) continue;
      const int32_t t = a.th[kMaxR + d];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = C0 + i + d;
        acc[i] += t * int32_t((e[c >> 1] >> (16 * (c & 1))) & 0xffffu);
      }
    }
    int32_t b[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) b[i] = min((acc[i] + a.half) >> a.shift, 255);
#pragma unroll
    for (int p = 0; p < kWords; ++p) bl[p] = uint32_t(b[2 * p]) | (uint32_t(b[2 * p + 1]) << 16);
  }
}

// K: 3, 5 or 7 for the compile-time instance with kv = kh = K; 0 for the
// runtime instance (any odd kv, kh <= 31).  EPI: the epilogue's mode.
template <int K, bool PACKED, int EPI>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sep_conv_u8_kernel(const ConvArgs a) {
  constexpr int HL = K > 0 ? 1 : 2;  // halo lanes on each side: rh <= 8 * HL
  constexpr int OW = (32 - 2 * HL) * kCols;
  __shared__ uint8_t lut[256];
  __shared__ uint4 hbuf[K > 0 ? 1 : kWarps][32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, W = a.W;
  const int rv = (K > 0 ? K : a.kv) >> 1;
  const int xc = int(blockIdx.x) * OW + (lane - HL) * kCols;  // this lane's first column
  const bool out_lane = lane >= HL && lane < 32 - HL;
  const bool fast_in = a.vec_in && xc >= 0 && xc + kCols <= W;
  const bool fast_out = a.vec_out && xc + kCols <= W;
  const bool use_lut = a.luts != nullptr;
  int cidx[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) cidx[i] = reflect101(xc + i, W);

  const int64_t nrb = (H + kBlockRows - 1) / kBlockRows;
  for (int64_t item = blockIdx.y; item < a.B * nrb; item += gridDim.y) {
    const int64_t b = item / nrb;
    const int y0 = int(item - b * nrb) * kBlockRows + warp * kRows;
    __syncthreads();  // the previous item's readers of lut are done
    if (use_lut)
      for (int i = tid; i < 256; i += kThreads) lut[i] = a.luts[b * 256 + i];
    __syncthreads();
    if (y0 >= H) continue;
    const uint8_t* plane = a.x + b * int64_t(H) * W;
    uint8_t* oplane = a.out + b * int64_t(H) * W;

    if constexpr (K > 0) {
      // every row of the warp's window is loaded before any is used, so all
      // the loads are in flight together; rows past the plane reflect.  Two
      // loops, so the vector/byte choice is made once and not per row.
      constexpr int kIn = kRows + K - 1;
      uint2 raw[kIn];
      if (fast_in) {
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          raw[i] = fetch_row(plane + int64_t(reflect101(y0 - rv + i, H)) * W, xc, true, cidx);
      } else {
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          raw[i] = fetch_row(plane + int64_t(reflect101(y0 - rv + i, H)) * W, xc, false, cidx);
      }
      uint32_t ring[K][kWords];
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        const int r = i - (K - 1);
        unpack_row(ring[i % K], raw[i], use_lut, lut);
        if (r < 0) continue;
        uint32_t v[kWords], bl[kWords];
#pragma unroll
        for (int m = 0; m < kWords; ++m) {
          uint32_t acc = 0;
#pragma unroll
          for (int j = 0; j < K; ++j) acc += uint32_t(a.tv[j]) * ring[(r + j) % K][m];
          v[m] = acc;
        }
        hpass_lanes<K, PACKED>(bl, v, a);
        if (out_lane && y0 + r < H)
          finish_row<EPI>(oplane + int64_t(y0 + r) * W, xc, W, fast_out, bl, ring[(r + rv) % K], a);
      }
    } else {
      // each of the warp's kv + 7 input rows is loaded once and added into
      // the output rows it reaches (input row i is tap i - r of output row r)
      uint32_t v[kRows][kWords] = {};
      const int kin = kRows + a.kv - 1;
      for (int i0 = 0; i0 < kin; i0 += 4) {  // 4 rows' loads in flight together
        uint2 raw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i0 + q < kin)
            raw[q] = fetch_row(plane + int64_t(reflect101(y0 - rv + i0 + q, H)) * W, xc, fast_in, cidx);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q >= kin) break;
          const int i = i0 + q;
          uint32_t p[kWords];
          unpack_row(p, raw[q], use_lut, lut);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (unsigned(i - r) >= unsigned(a.kv)) continue;
            const uint32_t t = uint32_t(a.tv[i - r]);
#pragma unroll
            for (int m = 0; m < kWords; ++m) v[r][m] += t * p[m];
          }
        }
      }
      uint4* hb = hbuf[warp];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (y0 + r >= H) break;
        hb[lane] = make_uint4(v[r][0], v[r][1], v[r][2], v[r][3]);
        __syncwarp();
        if (out_lane) {
          uint32_t bl[kWords], s[kWords];
          hpass_shared<PACKED>(bl, hb, lane, a);
          unpack_row(s, fetch_row(plane + int64_t(y0 + r) * W, xc, fast_in, cidx), use_lut, lut);
          finish_row<EPI>(oplane + int64_t(y0 + r) * W, xc, W, fast_out, bl, s, a);
        }
        __syncwarp();  // the next row overwrites hb
      }
    }
  }
}

// The wide instance: any odd kv, kh (taken where either exceeds 31), the
// int32 route on cv2's Q8 taps, read from a device buffer (a.wtaps) since
// they no longer fit the argument struct.  A block of 256 threads writes 16
// rows of 256 columns, one column a thread; the union of its columns'
// horizontal windows, 256 + 2 rh columns, which may be many times the tile
// when the radius exceeds it, goes through shared memory in chunks of 256:
// each thread forms the vertical sums of one chunk column for the block's 16
// rows (each of the 16 + kv - 1 input rows loaded once and added into the
// rows it reaches), then every thread adds the chunk's columns that fall in
// its window.  What bounds it: issue, about two instructions per tap and
// pass per pixel (a uniform tap load or a shared-memory read beside each
// IMAD), against 2 B/px of device memory; the compile-time instances'
// register windows need a tap count known when compiling.  Both the row and
// the column indices reflect as numpy.pad(mode="reflect") does, in 64 bits,
// so a halo deeper than the plane, or than 2^31 pixels, reflects again.
constexpr int kWideCols = 256;  // output columns per block, one a thread
constexpr int kWideRows = 16;   // output rows per block

__device__ __forceinline__ int reflect101_wide(int64_t i, int n) {
  if (i >= 0 && i < n) return int(i);
  if (n == 1) return 0;
  const int64_t m = 2 * int64_t(n - 1);
  i %= m;
  if (i < 0) i += m;
  return int(i >= n ? m - i : i);
}

template <int EPI>
__global__ void __launch_bounds__(kWideCols)
sep_conv_u8_wide_kernel(const ConvArgs a) {
  __shared__ uint8_t lut[256];
  __shared__ int32_t vs[kWideRows][kWideCols];
  const int t = threadIdx.x, t_first = t & ~31, t_last = t_first + 31;
  const int H = a.H, W = a.W, kv = a.kv;
  const int rv = kv >> 1, rh = a.kh >> 1, span = kWideCols + 2 * rh;  // kv, kh <= 2^30
  const int64_t x0 = int64_t(blockIdx.x) * kWideCols;
  const int32_t* __restrict__ tv = a.wtaps;
  const int32_t* __restrict__ th = a.wtaps + kv;
  const bool use_lut = a.luts != nullptr;
  const int64_t nrb = (H + kWideRows - 1) / kWideRows;
  for (int64_t item = blockIdx.y; item < a.B * nrb; item += gridDim.y) {
    const int64_t b = item / nrb;
    const int y0 = int(item - b * nrb) * kWideRows;
    __syncthreads();  // the previous item's readers of lut and vs are done
    if (use_lut)
      for (int i = t; i < 256; i += kWideCols) lut[i] = a.luts[b * 256 + i];
    __syncthreads();
    const uint8_t* plane = a.x + b * int64_t(H) * W;
    int32_t acc[kWideRows] = {};
    for (int c0 = 0; c0 < span; c0 += kWideCols) {
      // vertical sums of union column c0 + t (plane column x0 - rh + c0 + t)
      int32_t v[kWideRows] = {};
      if (c0 + t < span) {
        const uint8_t* col = plane + reflect101_wide(x0 - rh + c0 + t, W);
        const int kin = kWideRows + kv - 1;
        for (int i = 0; i < kin; ++i) {
          uint32_t px = col[int64_t(reflect101_wide(int64_t(y0) - rv + i, H)) * W];
          if (use_lut) px = lut[px];
#pragma unroll
          for (int r = 0; r < kWideRows; ++r) {
            const int j = i - r;  // input row i is tap i - r of output row r
            if (unsigned(j) < unsigned(kv)) v[r] += __ldg(tv + j) * int32_t(px);
          }
        }
      }
      __syncthreads();  // the previous chunk's readers of vs are done
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) vs[r][t] = v[r];
      __syncthreads();
      // output column t takes union columns t + j, j in [0, 2 rh]; this chunk
      // holds c0 .. c0 + 255.  The warp walks the taps any of its lanes needs.
      const int jlo = max(c0 - t_last, 0), jhi = min(c0 + kWideCols - 1 - t_first, 2 * rh);
      for (int j = jlo; j <= jhi; ++j) {
        const int32_t tap = __ldg(th + j);
        const int s = t + j - c0;
        if (unsigned(s) >= unsigned(kWideCols)) continue;
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) acc[r] += tap * vs[r][s];
      }
    }
    if (x0 + t >= W) continue;
    uint8_t* oplane = a.out + b * int64_t(H) * W;
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      if (y0 + r >= H) break;
      const int64_t o = int64_t(y0 + r) * W + x0 + t;
      uint32_t s = plane[o];
      if (use_lut) s = lut[s];
      const uint32_t bl = uint32_t(min((acc[r] + a.half) >> a.shift, 255));
      oplane[o] = uint8_t(epilogue<EPI>(bl, s, a));  // the low lane: this pixel's byte
    }
  }
}

template <int EPI>
void launch_wide(const ConvArgs& a, cudaStream_t stream) {
  const int64_t items = a.B * ((a.H + kWideRows - 1) / kWideRows);
  const dim3 grid(unsigned((a.W + kWideCols - 1) / kWideCols),
                  unsigned(items < kMaxGridY ? items : kMaxGridY));
  sep_conv_u8_wide_kernel<EPI><<<grid, kWideCols, 0, stream>>>(a);
}

template <int K, bool PACKED, int EPI>
void launch_instance(const ConvArgs& a, cudaStream_t stream) {
  constexpr int OW = (32 - 2 * (K > 0 ? 1 : 2)) * kCols;
  const int64_t items = a.B * ((a.H + kBlockRows - 1) / kBlockRows);
  const dim3 grid(unsigned((a.W + OW - 1) / OW), unsigned(items < kMaxGridY ? items : kMaxGridY));
  sep_conv_u8_kernel<K, PACKED, EPI><<<grid, kThreads, 0, stream>>>(a);
}

// One instance per epilogue, so each compiles only its own: on an H100 this
// was faster at every k timed than one instance choosing its epilogue at run
// time (tools/torch_conv_profile.py; PERF.md, K2/K3).
template <int K, bool PACKED>
void launch_route(const ConvArgs& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case 0: launch_instance<K, PACKED, 0>(a, stream); break;
    case 1: launch_instance<K, PACKED, 1>(a, stream); break;
    default: launch_instance<K, PACKED, 2>(a, stream); break;
  }
}

int64_t tap_sum(const int32_t* t, int k) {
  int64_t s = 0;
  for (int j = 0; j < k; ++j) s += t[j];
  return s;
}

}  // namespace

extern "C" {

// x, out: [B, H, W] u8 contiguous.  taps_v/taps_h: host arrays of kv/kh taps
// (odd, >= 0): the route's, chosen by kernels/conv.py::conv_route.
// dev_taps: the same kv + kh taps in device memory for the wide instance
// (null for the others).  instance: 3, 5 or 7 (then kv = kh = instance), 0
// (the runtime instance, kv and kh <= 31) or -1 (the wide instance, int32
// route, any kv and kh).  packed: 1 runs the horizontal pass on lanes (needs
// 255 * sum(tv) * sum(th) <= 65535), 0 in int32 (needs 255 * sum(tv) <=
// 65535).  blur = (acc + half) >> shift, half = 2^(shift-1) (0 at shift 0).
// luts: [B, 256] u8 device table or null.  mode: 0 blur; 1 integral amount in
// [0, 127]; 2 the two f32 FMAs with alpha, beta.
int ie_sep_conv_u8(const uint8_t* x, uint8_t* out, int64_t B, int64_t H, int64_t W,
                   const int32_t* taps_v, int32_t kv, const int32_t* taps_h, int32_t kh,
                   const int32_t* dev_taps, const uint8_t* luts, int32_t instance,
                   int32_t packed, int32_t shift, int32_t mode, int32_t amount_i, float alpha,
                   float beta, cudaStream_t stream) {
  const bool wide = instance == -1;
  if (B < 1 || H < 1 || W < 1 || H > 0x7fffffffLL - kBlockRows || W > 0x7fffffffLL - 512 ||
      kv < 1 || kh < 1 || kv % 2 == 0 || kh % 2 == 0 ||
      (!wide && (kv > kMaxTaps || kh > kMaxTaps)) || kv > (1 << 30) || kh > (1 << 30) ||
      (wide && (packed || dev_taps == nullptr)) ||
      !(wide || instance == 0 || ((instance == 3 || instance == 5 || instance == 7) &&
                                  kv == instance && kh == instance)) ||
      shift < 0 || shift > 16 || mode < 0 || mode > 2 ||
      (mode == 1 && (amount_i < 0 || amount_i > 127)))
    return int(cudaErrorInvalidValue);
  for (int j = 0; j < kv; ++j)
    if (taps_v[j] < 0) return int(cudaErrorInvalidValue);
  for (int j = 0; j < kh; ++j)
    if (taps_h[j] < 0) return int(cudaErrorInvalidValue);
  const int64_t sv = tap_sum(taps_v, kv), sh = tap_sum(taps_h, kh);
  const int64_t half = shift > 0 ? int64_t(1) << (shift - 1) : 0;
  if (255 * sv > 65535 || (packed && 255 * sv * sh + half > 65535) || (!packed && sh > 256))
    return int(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.x = x;
  a.out = out;
  a.luts = luts;
  a.B = B;
  a.H = int32_t(H);
  a.W = int32_t(W);
  a.wtaps = dev_taps;
  if (!wide) {
    for (int j = 0; j < kv; ++j) a.tv[j] = taps_v[j];
    const int th0 = instance == 0 ? kMaxR - kh / 2 : 0;  // the runtime instance's centred taps
    for (int j = 0; j < kh; ++j) a.th[th0 + j] = taps_h[j];
  }
  a.kv = kv;
  a.kh = kh;
  a.shift = shift;
  a.half = int32_t(half);
  const uint32_t am = uint32_t(mode == 1 ? amount_i : 0);
  a.mul_s = 1 + am;
  a.mul_b = am;
  a.bias2 = 256u * am * 0x00010001u;
  a.lo2 = a.bias2;
  a.hi2 = (256u * am + 255u) * 0x00010001u;
  a.alpha = alpha;
  a.beta = beta;
  a.vec_in = (reinterpret_cast<uintptr_t>(x) % 8 == 0) && (W % 8 == 0);
  a.vec_out = (reinterpret_cast<uintptr_t>(out) % 8 == 0) && (W % 8 == 0);
  if (wide) {
    switch (mode) {
      case 0: launch_wide<0>(a, stream); break;
      case 1: launch_wide<1>(a, stream); break;
      default: launch_wide<2>(a, stream); break;
    }
    return int(cudaGetLastError());
  }
  switch (instance * 2 + (packed ? 1 : 0)) {
    case 0: launch_route<0, false>(a, mode, stream); break;
    case 1: launch_route<0, true>(a, mode, stream); break;
    case 6: launch_route<3, false>(a, mode, stream); break;
    case 7: launch_route<3, true>(a, mode, stream); break;
    case 10: launch_route<5, false>(a, mode, stream); break;
    case 11: launch_route<5, true>(a, mode, stream); break;
    case 14: launch_route<7, false>(a, mode, stream); break;
    default: launch_route<7, true>(a, mode, stream); break;
  }
  return int(cudaGetLastError());
}

}  // extern "C"
