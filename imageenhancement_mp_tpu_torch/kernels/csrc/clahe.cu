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

#include "hist_count.cuh"
#include "reflect.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;  // (plane, row band) pairs beyond it stride over gridDim.y

// ---------------------------------------------------------------------------
// hist256_tiles: stage A for u8.  Replaces the JAX package's kernels/
// hist.py::hist256_pallas at its CLAHE call site (ops/clahe.py:207-212),
// where the TPU first copies the image into a [B*gh*gw, th*tw] tile stack.
// Here each block reads its tile in place.  Bound by device memory at 1 B/px
// (plus the pad rows and columns).  Tiles lie on gridDim.x (up to 2^31 - 1
// of them); a tile's rows are cut into bands of band_rows rows (kernels/
// clahe.py::tile_band_plan), which stride over gridDim.y.
//
// A warp takes rows q = warp, warp + 8, ... of the band.  Each row's source
// row is resolved once (reflect101 on the row index), and its interior
// columns [tx*tw, min((tx+1)*tw, W)) split into an unaligned head, a body of
// 16-byte vectors and a tail, as rows start at b*H*W + sy*W + tx*tw.  The
// lanes walk the body vectors of the warp's rows as one stream (lane l
// starts at vector l of the first row and steps 32 vectors, carrying over
// into the next row), so no pixel index is divided and short rows keep
// every lane busy; the vectors go to hist_count.cuh, kTileLoads loads at
// a time.  Then a loop per row counts the head and tail bytes and the pad
// columns >= W (right tiles only; reflect101 per pixel there) through shared
// atomics; a tile whose rows are all whole aligned vectors skips it.  The block adds its bins into the zeroed output with one
// atomicAdd per nonzero bin.
// ---------------------------------------------------------------------------

// Padded row R of a tile: its first interior byte s (column c0 of source
// row reflect101(R, H)), the head bytes before s's first 16-byte boundary,
// and the nv whole vectors after them; the len - head - 16 nv bytes left
// are its tail.
struct RowBody {
  const uint8_t* s;
  int head, nv;
  __device__ __forceinline__ const uint4* vec() const {
    return reinterpret_cast<const uint4*>(s + head);
  }
};

__device__ __forceinline__ RowBody row_body(const uint8_t* plane, int R, int H, int W, int c0,
                                            int len) {
  const uint8_t* s = plane + int64_t(reflect101(R, H)) * W + c0;
  const int head = min(int((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15), len);
  return {s, head, (len - head) >> 4};
}

// Vectors a lane loads at a time (the A/B timed 1 within 2 % of 3).
constexpr int kTileLoads = 3;

__global__ void __launch_bounds__(kCountThreads, 3)
hist256_tiles_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out, int H, int W,
                     int gh, int gw, int th, int tw, int band_rows, int bands) {
  constexpr int kRowWarps = kCountThreads / 32;
  extern __shared__ __align__(16) uint32_t count_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  HistCounter c;
  c.begin(count_smem);
  __syncthreads();

  const int64_t tile = blockIdx.x;  // b * gh * gw + ty * gw + tx
  const int ntiles = gh * gw;
  const int64_t b = tile / ntiles;
  const int t = int(tile - b * ntiles);
  const int ty = t / gw, tx = t - (t / gw) * gw;
  const uint8_t* plane = x + b * int64_t(H) * W;
  const int c0 = tx * tw;
  const int len = max(min(c0 + tw, W) - c0, 0);  // interior columns
  const int cp = max(c0, W);                      // first pad column
  const int npad = c0 + tw - cp;
  // rows with head, tail or pad bytes: unless every row starts on a 16-byte
  // boundary and its interior is whole vectors, with no pad
  const bool ragged = (reinterpret_cast<uintptr_t>(plane + c0) & 15) != 0 ||
                      ((W | len) & 15) != 0 || npad > 0;

  for (int band = blockIdx.y; band < bands; band += gridDim.y) {
    const int R0 = ty * th + band * band_rows;  // the band's first padded row
    const int nrows = min(band_rows, th - band * band_rows);

    // this lane's place in the stream: row q, vector j of its body
    int q = warp, j = lane;
    RowBody row = {nullptr, 0, 0};
    if (q < nrows) row = row_body(plane, R0 + q, H, W, c0, len);
    while (q < nrows && j >= row.nv) {
      j -= row.nv;
      q += kRowWarps;
      if (q < nrows) row = row_body(plane, R0 + q, H, W, c0, len);
    }
    count_vectors<kTileLoads>(c, [&](VecGroup<kTileLoads>& grp) {
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        grp.ok[u] = q < nrows;
        grp.v[u] = grp.ok[u] ? __ldg(row.vec() + j) : make_uint4(0, 0, 0, 0);
        j += 32;
        while (q < nrows && j >= row.nv) {
          j -= row.nv;
          q += kRowWarps;
          if (q < nrows) row = row_body(plane, R0 + q, H, W, c0, len);
        }
      }
    });

    // head and tail bytes (lanes 0-15 and 16-31), then the pad columns
    for (int r = warp; ragged && r < nrows; r += kRowWarps) {
      const RowBody rb = row_body(plane, R0 + r, H, W, c0, len);
      const int tail0 = rb.head + (rb.nv << 4);
      if (lane < 16) {
        if (lane < rb.head) c.add_byte(rb.s[lane]);
      } else if (tail0 + lane - 16 < len) {
        c.add_byte(rb.s[tail0 + lane - 16]);
      }
      const uint8_t* src = rb.s - c0;  // the source row
      for (int k = lane; k < npad; k += 32) c.add_byte(src[reflect101(cp + k, W)]);
    }
  }
  __syncthreads();

  const uint32_t sum = c.bin_total();
  if (sum) atomicAdd(&out[tile * 256 + tid], int32_t(sum));
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
// stacked neighbour LUTs for the tile splits the quadrant guard rejects),
// with one kernel per pixel type for every geometry.  Each pixel takes its
// row's y0, y1, fy and its column's x0, x1, fx from the host's
// _interp_coords tables.  The blend is blend_tile_luts' association
// (ops/clahe.py:145-148), each operation rounded once, then one half-even
// round:
//   top = (1-fx)*l00 + fx*l01;  bot = (1-fx)*l10 + fx*l11
//   out = clamp(rint((1-fy)*top + fy*bot), 0, S-1)
// Bound by device memory at 2 B/px.
//
// u8 (clahe_blend_u8_kernel).  Inside one interpolation cell (the region
// between neighbouring tile centres, where yidx[:, y] and xidx[:, x] are
// constant) the four neighbour LUTs are fixed.  A block covers one plane, a
// band of rows and a chunk of columns; for the row cell it is in, it stages
// one table of 256 words per column cell its chunk touches, word v packing
// the four entries l00 | l01 << 8 | l10 << 16 | l11 << 24, so one LDS.32
// returns a pixel's four taps (in place of four dependent global gathers;
// the words are built from 4-byte loads of the four LUT rows and
// __byte_perm).  The host (kernels/clahe.py::blend_chunk) picks the chunk
// width so that no chunk touches more than kMaxCells column cells; when a
// band's rows cross into the next row cell, the block stages the tables
// anew.  A thread takes kBlendPx = 8 adjacent pixels of a row (one 8-byte
// load and store where rows are 8-byte aligned, else masked bytes), reads
// its columns' fx once, and loads kRowsAhead rows before it blends the
// first.  Bytes become floats as 0x4B000000 | v minus 2^23 and results bytes
// as the low bits of r + 2^23 (exact; no I2F or F2I).  What bounds it:
// about 30 instructions per pixel (one table read, four entry conversions,
// the nine-operation blend, the rounding) against 2 B/px of device memory;
// 8 pixels a thread at up to 128 registers beat 16 pixels, 64 or 80
// registers, 256-thread blocks, bands of 8 or 32 rows and 2 or 8 rows ahead
// on the H100 (PERF.md).  The random table reads of a warp meet
// about 3.5 bank conflicts on average; replicating the table is untried.
// u16 (clahe_blend_kernel, S = 65536, 128 KiB per LUT): every pixel loads
// its four entries straight from the [B*T, S] table (L1/L2).  One block
// covers 256 columns by kBlendRows rows of one plane.
// ---------------------------------------------------------------------------

constexpr int kBlendRows = 8;

constexpr int kBlendThreads = 128;
constexpr int kBlendPx = 8;      // adjacent pixels of a row per thread: one uint2
constexpr int kBlendWords = kBlendPx / 4;
constexpr int kMaxChunk = kBlendThreads * kBlendPx;  // columns per block
constexpr int kMaxCells = 16;    // quad tables per block: 16 KiB
constexpr int kRowsAhead = 4;
constexpr int kBlendMinBlocks = 4;  // resident blocks per SM: at most 128 registers
constexpr uint32_t kMagic = 0x4B000000u;  // the bits of f32 2^23
constexpr float kTwo23 = 8388608.0f;

// the column cell of a column whose neighbour tiles are (i0, i1): 0 left
// of the first tile centre, gw right of the last, else i1 (for gw = 1 every
// column is cell 0: both cells read the one tile twice)
__device__ __forceinline__ int column_cell(int i0, int i1, int gw) {
  return i1 > i0 ? i1 : (i0 == 0 ? 0 : gw);
}

// the four entries of a quad word as exact floats
__device__ __forceinline__ float quad_entry(uint32_t w, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, kMagic, sel)), kTwo23);
}

// stage the quad tables of cells cell0 .. cell0 + ncells - 1 for tile rows
// (y0, y1) of one plane's LUTs: four entries of each of the four LUTs per
// step, interleaved into four quad words
__device__ __forceinline__ void stage_quads(uint4* quad, const uint8_t* __restrict__ lb, int gw,
                                            int y0, int y1, int cell0, int ncells) {
  for (int i = threadIdx.x; i < ncells * 64; i += kBlendThreads) {
    const int c = cell0 + (i >> 6), v0 = (i & 63) * 4;
    const int x0 = min(max(c - 1, 0), gw - 1), x1 = min(c, gw - 1);
    const uint32_t a = __ldg(reinterpret_cast<const unsigned int*>(lb + (y0 * gw + x0) * 256 + v0));
    const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(lb + (y0 * gw + x1) * 256 + v0));
    const uint32_t c2 = __ldg(reinterpret_cast<const unsigned int*>(lb + (y1 * gw + x0) * 256 + v0));
    const uint32_t d = __ldg(reinterpret_cast<const unsigned int*>(lb + (y1 * gw + x1) * 256 + v0));
    const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
    const uint32_t cd_lo = __byte_perm(c2, d, 0x5140), cd_hi = __byte_perm(c2, d, 0x7362);
    quad[i] = make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410), __byte_perm(ab_lo, cd_lo, 0x7632),
                         __byte_perm(ab_hi, cd_hi, 0x5410), __byte_perm(ab_hi, cd_hi, 0x7632));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBlendThreads, kBlendMinBlocks)
clahe_blend_u8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ luts,
                      uint8_t* __restrict__ out, int64_t B, int H, int W, int gh, int gw,
                      const int32_t* __restrict__ yidx, const float* __restrict__ fyv,
                      const int32_t* __restrict__ xidx, const float* __restrict__ fxv, int chunk,
                      int band) {
  __shared__ uint4 quad4[kMaxCells * 64];
  const uint32_t* quad = reinterpret_cast<const uint32_t*>(quad4);
  const int c0 = blockIdx.x * chunk;
  const int cend = min(c0 + chunk, W);
  const int xs = c0 + threadIdx.x * kBlendPx;  // the thread's first column
  const int cell0 = column_cell(xidx[c0], xidx[W + c0], gw);
  const int ncells = column_cell(xidx[cend - 1], xidx[W + cend - 1], gw) - cell0 + 1;

  // the thread's columns: fx, and the local cell (4 bits each) packed
  float fx[kBlendPx];
  uint64_t cells = 0;
#pragma unroll
  for (int k = 0; k < kBlendPx; ++k) {
    const int col = min(xs + k, cend - 1);
    fx[k] = fxv[col];
    cells |= uint64_t(column_cell(xidx[col], xidx[W + col], gw) - cell0) << (4 * k);
  }
  const bool active = xs < cend;
  const int64_t ntiles = int64_t(gh) * gw;
  const int64_t nbands = (H + band - 1) / band;

  for (int64_t item = blockIdx.y; item < B * nbands; item += gridDim.y) {
    const int64_t b = item / nbands;
    const int ya = int(item - b * nbands) * band;
    const int yb = min(ya + band, H);
    const uint8_t* lb = luts + b * ntiles * 256;
    const int64_t plane = b * int64_t(H) * W;
    int cur0 = -1, cur1 = -1;  // the staged row cell's tile rows
    for (int y = ya; y < yb; y += kRowsAhead) {
      uint32_t d[kRowsAhead][kBlendWords];
#pragma unroll
      for (int r = 0; r < kRowsAhead; ++r) {
#pragma unroll
        for (int q = 0; q < kBlendWords; ++q) d[r][q] = 0;
        if (!active || y + r >= yb) continue;
        const uint8_t* src = x + plane + int64_t(y + r) * W + xs;
        if (kVec) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
          d[r][0] = v.x;
          d[r][1] = v.y;
        } else {
#pragma unroll
          for (int k = 0; k < kBlendPx; ++k)
            if (xs + k < cend) d[r][k >> 2] |= uint32_t(src[k]) << (8 * (k & 3));
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsAhead; ++r) {
        const int yy = y + r;
        if (yy >= yb) break;
        const int y0 = yidx[yy], y1 = yidx[H + yy];
        if (y0 != cur0 || y1 != cur1) {  // the same for the whole block
          __syncthreads();               // the previous tables are read
          stage_quads(quad4, lb, gw, y0, y1, cell0, ncells);
          __syncthreads();
          cur0 = y0;
          cur1 = y1;
        }
        if (!active) continue;
        const float fy = fyv[yy];
        const float gy = __fsub_rn(1.0f, fy);
        uint32_t o[kBlendWords];
#pragma unroll
        for (int q = 0; q < kBlendWords; ++q) o[q] = 0;
#pragma unroll
        for (int k = 0; k < kBlendPx; ++k) {
          const uint32_t v = (d[r][k >> 2] >> (8 * (k & 3))) & 0xffu;
          const uint32_t w = quad[(uint32_t((cells >> (4 * k)) & 15u) << 8) | v];
          const float gx = __fsub_rn(1.0f, fx[k]);
          const float top = __fadd_rn(__fmul_rn(gx, quad_entry(w, 0x7540)),
                                      __fmul_rn(fx[k], quad_entry(w, 0x7541)));
          const float bot = __fadd_rn(__fmul_rn(gx, quad_entry(w, 0x7542)),
                                      __fmul_rn(fx[k], quad_entry(w, 0x7543)));
          const float r2 = fminf(fmaxf(__fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot)), 0.0f),
                                 255.0f);
          o[k >> 2] |= (__float_as_uint(__fadd_rn(r2, kTwo23)) & 0xffu) << (8 * (k & 3));
        }
        uint8_t* dst = out + plane + int64_t(yy) * W + xs;
        if (kVec) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
        } else {
#pragma unroll
          for (int k = 0; k < kBlendPx; ++k)
            if (xs + k < cend) dst[k] = uint8_t(o[k >> 2] >> (8 * (k & 3)));
        }
      }
    }
  }
}

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
// tx*tw .. tx*tw+tw-1, with gh*th >= H and gw*tw >= W.  Its rows come in
// `bands` bands of band_rows rows (the last one shorter), which stride over
// grid_y <= min(bands, 65535) (kernels/clahe.py::tile_band_plan).
int ie_hist256_tiles(const uint8_t* x, int32_t* out, int64_t B, int64_t H, int64_t W,
                     int32_t gh, int32_t gw, int64_t th, int64_t tw, int64_t band_rows,
                     int64_t bands, int64_t grid_y, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || th < 1 || tw < 1 ||
      int64_t(gh) * th < H || int64_t(gw) * tw < W || int64_t(gh) * th > 0x7fffffffLL ||
      int64_t(gw) * tw > 0x7fffffffLL || th * tw > 0x7fffffffLL ||
      B * gh * gw > 0x7fffffffLL || band_rows < 1 || bands < 1 ||
      (bands - 1) * band_rows >= th || bands * band_rows < th || grid_y < 1 || grid_y > bands ||
      grid_y > kMaxGridY)
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(B * gh * gw), unsigned(grid_y));
  hist256_tiles_kernel<<<grid, kCountThreads, HistCounter::kSmemBytes, stream>>>(
      x, out, int(H), int(W), gh, gw, int(th), int(tw), int(band_rows), int(bands));
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
// (elem_bytes 2, S = 65536); luts: [B*gh*gw, S] of the same type (u8: 4-byte
// aligned).  yidx: [2, H] int32 (y0 then y1), fy: [H] f32; xidx: [2, W], fx:
// [W].  u8 only: chunk (a multiple of 16, at most 2048) columns and band rows
// per block, from kernels/clahe.py::blend_chunk and blend_band (every chunk
// within kMaxCells column cells).
int ie_clahe_blend(const void* x, const void* luts, void* out, int64_t B, int64_t H, int64_t W,
                   int32_t elem_bytes, int32_t gh, int32_t gw, const int32_t* yidx,
                   const float* fy, const int32_t* xidx, const float* fx, int32_t chunk,
                   int32_t band, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || W > 0x7fffffffLL - kMaxChunk ||
      H > 0x7fffffffLL - kBlendRows)
    return int(cudaErrorInvalidValue);
  if (elem_bytes == 1) {
    if (chunk < kBlendPx || chunk > kMaxChunk || chunk % kBlendPx || band < 1 ||
        int64_t(gh) * gw * 256 > 0x7fffffffLL || (reinterpret_cast<uintptr_t>(luts) & 3))
      return int(cudaErrorInvalidValue);
    const int64_t items = B * ((H + band - 1) / band);
    const dim3 grid(unsigned((W + chunk - 1) / chunk),
                    unsigned(items < kMaxGridY ? items : kMaxGridY));
    const bool vec = W % kBlendPx == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                            reinterpret_cast<uintptr_t>(out)) % kBlendPx) == 0;
    if (vec)
      clahe_blend_u8_kernel<true><<<grid, kBlendThreads, 0, stream>>>(
          static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
          static_cast<uint8_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx, chunk, band);
    else
      clahe_blend_u8_kernel<false><<<grid, kBlendThreads, 0, stream>>>(
          static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
          static_cast<uint8_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx, chunk, band);
  } else if (elem_bytes == 2) {
    const int64_t items = B * ((H + kBlendRows - 1) / kBlendRows);
    const dim3 grid(unsigned((W + kThreads - 1) / kThreads),
                    unsigned(items < kMaxGridY ? items : kMaxGridY));
    clahe_blend_kernel<uint16_t, 65536><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(luts),
        static_cast<uint16_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
