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

#include <atomic>
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
  // the wide instance's taps on the device: kv vertical (int32), then kh
  // horizontal (f32) zero-padded to a multiple of 8 plus 8
  const int32_t* wtaps;
  int32_t kv, kh;
  int32_t tw, kseg, vstride;    // wide: tile columns, taps per segment, shared row pitch
  int32_t vec16;                // wide: base pointer 16-byte aligned and W % 16 == 0
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

// The wide instance: every tap pair with more than 31 taps on an axis after
// the host trimmed the zero taps off both ends (kernels/conv.py::conv_route),
// odd counts up to 2^30.  Its taps come from a device buffer (a.wtaps: the kv
// vertical taps as int32, then the kh horizontal ones as f32, zero-padded to
// a multiple of 8 plus 8).  A block writes 32 rows of a.tw columns (a
// multiple of 64) and strides over (plane, row block) pairs on gridDim.y.
//  - Vertical pass: the tile's union of columns (a.tw + kh - 1 of them from
//    a 16-byte boundary) in rounds of 512.  A round streams the tile's
//    32 + kv - 1 input rows through shared memory in chunks of 32 rows,
//    double-buffered with cp.async (16 bytes a copy; bytes where a row's
//    edge or a misaligned plane needs reflection).  Thread t owns union
//    columns 2t and 2t + 1 of all 32 output rows, as two packed 16-bit lanes
//    in a word (every sum is <= 255 * sum(tv) <= 65280: no lane carries):
//    its last 32 input rows sit in a register window, and each new row costs
//    one 2-byte shared load and, for a nonzero tap, 32 IMADs.  A chunk's 32
//    taps and their nonzero mask are staged with it, so a zero tap's
//    products are skipped on a register bit, and the next row and tap are
//    read a step ahead.  Every thread walks the same rows, so a chunk is
//    loaded once for all of them and its copies are in flight together.  The
//    sums go to a shared f32 tile of 32 rows (0x4B00LLLL is 2^23 + LLLL).
//  - Horizontal pass: lane l of a warp is the tile's row l, so its reads of
//    a shared column hit 32 banks (the tile's row pitch is odd); a lane owns
//    8 adjacent output columns and slides a window of 8 vertical sums along
//    the taps: 8 FFMAs and one shared load a tap (the next 8 sums loaded a
//    group of 8 taps ahead), the taps read 4 at a time.
//    Every sum is an integer below 255 * 256 * 256 < 2^24, so f32 FMAs are
//    exact in any order; blur = (acc + 2^15) >> 16 is an add, a scale by
//    2^-16 and a round-toward-zero add of 2^23.  A zero tap's FMAs are
//    skipped.  Taps wider than the shared tile run in segments, the
//    accumulators kept across them (a.tw is then 64: one group a warp).
//  - Borders: the row and column indices reflect as
//    numpy.pad(mode="reflect") does, in 64 bits, so a halo deeper than the
//    plane, or than 2^31 pixels, reflects again; inside the plane that is two
//    compares.  The LUT is applied as the vertical pass reads its bytes.  The
//    epilogue and the stores are the instances' (finish_row).
// Mirrored taps are not paired: a pair's two rows sit at both ends of the
// window, so pairing needs two windows and both ends of the tile at once.
// What bounds it: the work is about 0.5 IMAD a nonzero vertical tap times
// the union's overhead (512 * rounds / tw) and 1.15 instructions a
// horizontal tap per output pixel, against 2 B/px of device memory.  On an
// H100 (700 W) at 8x1080x1920, device-paced: 0.146 ms at 37 taps (sigma 6;
// the instance before this design 0.562), 0.326 at 121, 1.81 at 541
// (13.37), against a 0.0099 ms bytes bound: 15x, 33x and 183x it (its
// products, u8 times Q8 taps, take less than that at the int8 tensor-core
// rate, which this design leaves unused; at the f32 rate of the IMADs and
// FFMAs it runs on, one a nonzero tap, 0.033, 0.088 and 0.245 ms).  At 37
// taps the copies cost about 0.05 ms (a chunk's latency a tile: the first
// chunk is all window fill) and the horizontal pass 0.03.  Measured
// and dropped: paired 8-row jobs loading their rows from global memory
// (0.218 ms at 37 taps, 3.58 at 541, waiting on those loads), 16-row jobs
// in 512-thread blocks (0.176 and 1.44), and blocks kept resident to stage
// a tile's first chunk during the last tile's horizontal pass (spills at
// 128 registers).  PERF.md, K2's wide row, has every time.
constexpr int kWideRows = 32;     // output rows per block: one a lane in the horizontal pass
constexpr int kWideThreads = 256;
constexpr int kWideRound = 2 * kWideThreads;  // union columns per vertical round
constexpr int kWideMaxRounds = 2;             // a shared tile of at most 1024 columns

__device__ __forceinline__ int reflect101_wide(int64_t i, int n) {
  if (i >= 0 && i < n) return int(i);
  if (n == 1) return 0;
  if (i < 0 && i > -int64_t(n)) return int(-i);                   // one reflection
  if (i >= n && i < 2 * int64_t(n) - 1) return int(2 * int64_t(n - 1) - i);
  const int64_t m = 2 * int64_t(n - 1);
  i %= m;
  if (i < 0) i += m;
  return int(i >= n ? m - i : i);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One chunk of a vertical round into shared memory: input rows yb .. yb + 31
// of the plane (reflected) at plane columns cb .. cb + ncols - 1 (ncols a
// multiple of 16, at most 512) into buf, 512 bytes a row, a warp a row and a
// lane 16 bytes of it; and taps j0 .. j0 + 31 (0 outside 0 .. kv - 1) into
// taps[0..31], their nonzero mask into taps[32].
__device__ __forceinline__ void wide_stage(uint8_t* buf, int32_t* taps,
                                           const uint8_t* __restrict__ plane, int H, int W,
                                           int64_t yb, int64_t cb, int ncols, bool vec16,
                                           const int32_t* __restrict__ tv, int kv, int j0, int warp,
                                           int lane) {
  const int c = lane << 4;
  const int64_t pc = cb + c;
  const bool fast = vec16 && pc >= 0 && pc + 16 <= W;
  for (int r = warp; r < kWideRows; r += kWideThreads / 32) {
    if (c >= ncols) break;
    const uint8_t* row = plane + int64_t(reflect101_wide(yb + r, H)) * W;
    uint8_t* dst = buf + r * kWideRound + c;
    if (fast) {
      cp_async16(dst, row + pc);
    } else {  // the indices first, so the 16 loads are in flight together
      int ci[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) ci[i] = reflect101_wide(pc + i, W);
      uint32_t px[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) px[i] = row[ci[i]];
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i >> 2] |= px[i] << (8 * (i & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (warp == kWideThreads / 32 - 1) {
    const int j = j0 + lane;
    const int32_t tap = j >= 0 && j < kv ? __ldg(tv + j) : 0;
    taps[lane] = tap;
    const unsigned mask = __ballot_sync(kFull, tap != 0);
    if (lane == 0) taps[32] = int32_t(mask);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One vertical round: the sums of the tile's 32 output rows at union
// columns c0 .. c0 + ncols - 1 (plane columns ubase + c0 + ...), stored as
// f32 in rows 0..31 of vs.  Input row i of the tile is plane row y0 - rv + i;
// row i enters window slot i & 31 and, as tap j = i - 31's newest row, adds
// tv[j] * x[j + r] to output row r.  The next row and tap are read a step
// ahead; a zero tap's step skips its products on the chunk's mask.
__device__ __forceinline__ void wide_vround(const ConvArgs& a, float* __restrict__ vs, int S,
                                            uint8_t* stage, int32_t* staps,
                                            const uint8_t* __restrict__ plane, int y0,
                                            int64_t ubase, int c0, int ncols, bool use_lut,
                                            const uint8_t* lut, int t) {
  const int H = a.H, W = a.W, kv = a.kv, rv = kv >> 1;
  const int warp = t >> 5, lane = t & 31;
  const bool mine = 2 * t < ncols;  // this thread's two columns are needed
  const int nchunks = (kv + kWideRows - 1 + kWideRows - 1) / kWideRows;  // rows 0 .. kv + 30
  constexpr int kBuf = kWideRows * kWideRound, kTaps = kWideRows + 1;
  uint32_t win[kWideRows], acc[kWideRows];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) acc[r] = 0;
  wide_stage(stage, staps, plane, H, W, int64_t(y0) - rv, ubase + c0, ncols, a.vec16, a.wtaps, kv,
             -(kWideRows - 1), warp, lane);
  for (int c = 0; c < nchunks; ++c) {
    const uint8_t* buf = stage + (c & 1) * kBuf;
    const int32_t* tq = staps + (c & 1) * kTaps;
    if (c + 1 < nchunks) {  // the other buffers' readers finished at the end of chunk c - 1
      wide_stage(stage + ((c + 1) & 1) * kBuf, staps + ((c + 1) & 1) * kTaps, plane, H, W,
                 int64_t(y0) - rv + kWideRows * (c + 1), ubase + c0, ncols, a.vec16, a.wtaps, kv,
                 kWideRows * (c + 1) - (kWideRows - 1), warp, lane);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // every thread's copies of chunk c have landed
    if (mine) {
      const unsigned mask = unsigned(tq[kWideRows]);
      const uint16_t* col = reinterpret_cast<const uint16_t*>(buf) + t;
      uint32_t px = col[0], tap = uint32_t(tq[0]);
#pragma unroll
      for (int s = 0; s < kWideRows; ++s) {
        const uint32_t px_next = s + 1 < kWideRows ? col[(s + 1) * (kWideRound / 2)] : 0u;
        const uint32_t tap_next = s + 1 < kWideRows ? uint32_t(tq[s + 1]) : 0u;
        win[s] = use_lut ? uint32_t(lut[px & 0xffu]) | (uint32_t(lut[px >> 8]) << 16)
                         : __byte_perm(px, 0, 0x4140);
        if (mask & (1u << s)) {
#pragma unroll
          for (int r = 0; r < kWideRows; ++r) acc[r] += tap * win[(s + 1 + r) & (kWideRows - 1)];
        }
        px = px_next;
        tap = tap_next;
      }
    }
    __syncthreads();  // the readers of buffers c & 1 are done before chunk c + 2 lands in them
  }
  if (!mine) return;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    float* dst = vs + r * S + c0 + 2 * t;
    dst[0] = __fsub_rn(__uint_as_float(__byte_perm(acc[r], 0x4B00u, 0x5410)), 8388608.0f);
    dst[1] = __fsub_rn(__uint_as_float(__byte_perm(acc[r], 0x4B00u, 0x5432)), 8388608.0f);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kWideThreads, 2)
sep_conv_u8_wide_kernel(const ConvArgs a) {
  extern __shared__ float4 wide_smem[];
  const int S = a.vstride;  // odd: a column of the tile's 32 rows spans 32 banks
  float* vs = reinterpret_cast<float*>(wide_smem);
  float* ths = vs + kWideRows * S;  // 16-byte aligned: 32 * S floats
  uint8_t* stage = reinterpret_cast<uint8_t*>(ths + a.kseg + 8);  // 2 chunks of 32 x 512 bytes
  int32_t* staps = reinterpret_cast<int32_t*>(stage + 2 * kWideRows * kWideRound);  // 2 x 33
  uint8_t* lut = reinterpret_cast<uint8_t*>(staps + 2 * (kWideRows + 1));
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int H = a.H, W = a.W, kh = a.kh, rh = kh >> 1;
  const int khp = (kh + 7) & ~7;
  const int nseg = (khp + a.kseg - 1) / a.kseg;
  const int64_t x0 = int64_t(blockIdx.x) * a.tw;
  const int64_t cols = W - x0 < a.tw ? W - x0 : a.tw;
  const int ngroups = int((cols + 7) >> 3);  // 8-column groups of output
  const float* __restrict__ thf = reinterpret_cast<const float*>(a.wtaps + a.kv);
  const bool use_lut = a.luts != nullptr;
  const int64_t nrb = (H + kWideRows - 1) / kWideRows;
  float acc[kCols];
  for (int64_t item = blockIdx.y; item < a.B * nrb; item += gridDim.y) {
    const int64_t b = item / nrb;
    const int y0 = int(item - b * nrb) * kWideRows;
    const uint8_t* plane = a.x + b * int64_t(H) * W;
    __syncthreads();  // the previous item's readers of lut, ths and vs are done
    if (use_lut)
      for (int i = t; i < 256; i += kWideThreads) lut[i] = a.luts[b * 256 + i];
    for (int seg = 0; seg < nseg; ++seg) {
      const int j0 = seg * a.kseg, lenp = min(a.kseg, khp - j0);  // this segment's taps
      if (seg > 0) __syncthreads();  // the previous segment's readers of ths and vs are done
      for (int i = t; i < lenp + 8; i += kWideThreads) ths[i] = thf[j0 + i];
      __syncthreads();  // lut and ths are staged
      // union index u is plane column ubase + u; output column x0 + c at
      // segment tap jj reads u = o + c + jj
      const int64_t org = x0 + j0 - rh, ubase = org & ~int64_t(15);
      const int o = int(org - ubase);
      const int uneed = (o + 8 * ngroups + lenp + 15) & ~15;  // the windows read below uneed
      for (int c0 = 0; c0 < uneed; c0 += kWideRound)
        wide_vround(a, vs, S, stage, staps, plane, y0, ubase, c0, min(kWideRound, uneed - c0),
                    use_lut, lut, t);
      __syncthreads();
      for (int g = warp; g < ngroups; g += kWideThreads / 32) {
        if (seg == 0) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
        }
        const float* vrow = vs + lane * S + o + kCols * g;
        float w[kCols];  // u = jj .. jj + 7 (relative to vrow); nw: the next 8
#pragma unroll
        for (int k = 0; k < kCols; ++k) w[k] = vrow[k];
        for (int jj = 0; jj < lenp; jj += kCols) {
          float nw[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) nw[k] = vrow[jj + kCols + k];
          const float4 t0 = *reinterpret_cast<const float4*>(ths + jj);
          const float4 t1 = *reinterpret_cast<const float4*>(ths + jj + 4);
          const float tt[kCols] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
          for (int s = 0; s < kCols; ++s) {
            if (tt[s] != 0.0f) {
#pragma unroll
              for (int k = 0; k < kCols; ++k)
                acc[k] = __fmaf_rn(tt[s], s + k < kCols ? w[s + k] : nw[s + k - kCols], acc[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < kCols; ++k) w[k] = nw[k];
        }
        const int y = y0 + lane;
        if (seg < nseg - 1 || y >= H) continue;
        const int xc = int(x0) + kCols * g;
        uint32_t bl[kWords], s[kWords], bv[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k)  // floor((acc + 2^15) / 2^16) in the low mantissa bits
          bv[k] = __float_as_uint(__fadd_rz(__fmul_rn(__fadd_rn(acc[k], 32768.0f), 1.0f / 65536.0f),
                                            8388608.0f)) - 0x4B000000u;
#pragma unroll
        for (int m = 0; m < kWords; ++m) bl[m] = bv[2 * m] | (bv[2 * m + 1] << 16);
        int cidx[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) cidx[i] = reflect101(xc + i, W);
        const int64_t off = int64_t(y) * W;
        unpack_row(s, fetch_row(plane + off, xc, a.vec_in && xc + kCols <= W, cidx), use_lut, lut);
        finish_row<EPI>(a.out + b * int64_t(H) * W + off, xc, W, a.vec_out && xc + kCols <= W, bl,
                        s, a);
      }
    }
  }
}

// The wide instance's tile, chosen on the host from kh: rounds of 512
// union columns (a round keeps the 256 threads' vertical jobs busy), the
// fewest whose tile is at least 3 kh wide, so the union's overhead
// (512 * rounds / tw) stays small, up to 2; wider taps run in segments on
// a 64-column tile.
constexpr int kWideMaxSeg = ((kWideRound * kWideMaxRounds - 15 - 64) / 8) * 8;

void wide_tile(ConvArgs& a) {
  const int khp = (a.kh + 7) & ~7;
  const int cap = ((a.W + 63) / 64) * 64;
  int tw = 0, rounds = 1;
  for (; rounds <= kWideMaxRounds; ++rounds) {
    tw = ((kWideRound * rounds - 15 - khp) / 64) * 64;
    if (tw >= 3 * khp || tw >= cap || rounds == kWideMaxRounds) break;
  }
  if (tw >= 64) {
    a.tw = tw < cap ? tw : cap;
    a.kseg = khp;
  } else {
    a.tw = 64;
    a.kseg = kWideMaxSeg;
  }
  const int umax = 15 + a.tw + a.kseg;  // the union columns a segment's windows read
  a.vstride = ((umax + kWideRound - 1) / kWideRound) * kWideRound + 1;
}

constexpr size_t wide_smem_bytes(int vstride, int kseg) {
  return sizeof(float) * (size_t(kWideRows) * vstride + kseg + 8) +
         2 * kWideRows * kWideRound + sizeof(int32_t) * 2 * (kWideRows + 1) + 256;
}

// The largest tile wide_tile makes: a vstride of at most 1025 (the union of
// two rounds, plus one) and a segment of at most kWideMaxSeg taps; about
// 168 KB, under the 227 KB a block may opt in to.
constexpr size_t kWideMaxSmem = wide_smem_bytes(kWideRound * kWideMaxRounds + 1, kWideMaxSeg);

// Raises the instance's dynamic shared-memory limit to kWideMaxSmem once per
// device (a bit each in `opted`; devices past 63 each launch), so a launch
// spends no host time on it.
template <int EPI>
int launch_wide(ConvArgs& a, cudaStream_t stream) {
  static std::atomic<uint64_t> opted{0};
  wide_tile(a);
  const size_t smem = wide_smem_bytes(a.vstride, a.kseg);
  if (smem > kWideMaxSmem) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(sep_conv_u8_wide_kernel<EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(kWideMaxSmem));
    if (e != cudaSuccess) return int(e);
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  const int64_t items = a.B * ((a.H + kWideRows - 1) / kWideRows);
  const dim3 grid(unsigned((a.W + a.tw - 1) / a.tw), unsigned(items < kMaxGridY ? items : kMaxGridY));
  sep_conv_u8_wide_kernel<EPI><<<grid, kWideThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
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
// dev_taps: the same taps in device memory for the wide instance, kv int32
// then kh f32 zero-padded to a multiple of 8 plus 8
// (kernels/conv.py::_device_taps; null for the others).  instance: 3, 5 or
// 7 (then kv = kh = instance), 0 (the runtime instance, kv and kh <= 31) or
// -1 (the wide instance: any kv and kh, packed 0, shift 16).  packed: 1 runs the horizontal pass on lanes (needs
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
    a.vec16 = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (W % 16 == 0);
    switch (mode) {
      case 0: return launch_wide<0>(a, stream);
      case 1: return launch_wide<1>(a, stream);
      default: return launch_wide<2>(a, stream);
    }
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
