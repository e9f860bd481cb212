// CLAHE (cv2.createCLAHE(clip, grid).apply) on u8 and u16 planes, in three
// stages: per-tile histograms (stage A: hist256_tiles for u8,
// hist65536_tiles for u16), the clipped tile LUTs (stage B) and the bilinear
// blend of the four neighbour LUTs (stage C: one kernel for u8, one for u16).
// Stage B runs in stage A's epilogue (tile_luts256 for u8, tile_luts65536
// for u16), so the CLAHE path makes two launches for either type.
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
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hist_count.cuh"
#include "reflect.cuh"

namespace cg = cooperative_groups;

namespace {

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
// atomics; a tile whose rows are all whole aligned vectors skips it.  The
// tile's band blocks then hand their bins to the last of them
// (hist_count.cuh::last_of_group), which writes the tile's histogram row
// whole (`hist`, when given) or runs stage B's S = 256 law on it and writes
// the tile's u8 LUT row (`lut`, when given; clip_abs and scale as for
// clahe_lut): stages A and B in one launch, with no tile histogram in
// device memory beyond the band blocks' scratch rows, and no zeroed output.
// ---------------------------------------------------------------------------

// Padded row R of a tile piece: its first interior element s (column c0 of
// source row reflect101(R, H)), the head elements before s's first 16-byte
// boundary, and the nv whole 16-byte vectors after them; the elements left
// are its tail.
template <typename T>
struct RowBody {
  static constexpr int kShift = sizeof(T) == 1 ? 4 : 3;  // log2 of the elements a vector holds
  const T* s;
  int head, nv;
  __device__ __forceinline__ const uint4* vec() const {
    return reinterpret_cast<const uint4*>(s + head);
  }
};

template <typename T>
__device__ __forceinline__ RowBody<T> row_body(const T* plane, int R, int H, int W, int c0,
                                               int len) {
  const T* s = plane + int64_t(reflect101(R, H)) * W + c0;
  const int head =
      min(int(((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) >> (sizeof(T) - 1)), len);
  return {s, head, (len - head) >> RowBody<T>::kShift};
}

// Count padded rows R0 .. R0 + nrows - 1 of a tile piece, interior columns
// [c0, c0 + len) and pad columns [cp, cp + npad), into c: the body vectors of
// the rows as one lane stream (warp w takes rows w, w + kRowWarps, ...;
// lane l starts at vector l of its first row and steps 32 vectors, carrying
// over into the next row), kLoads loads at a time, then, where `ragged`,
// the head and tail elements (lanes 0-15 and 16-31) and the pad columns
// one at a time.
template <typename T, int kLoads, int kRowWarps, typename Counter>
__device__ __forceinline__ void count_tile_rows(Counter& c, const T* plane, int H, int W, int R0,
                                                int nrows, int c0, int len, int cp, int npad,
                                                bool ragged) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's place in the stream: row q, vector j of its body
  int q = warp, j = lane;
  RowBody<T> row = {nullptr, 0, 0};
  if (q < nrows) row = row_body(plane, R0 + q, H, W, c0, len);
  while (q < nrows && j >= row.nv) {
    j -= row.nv;
    q += kRowWarps;
    if (q < nrows) row = row_body(plane, R0 + q, H, W, c0, len);
  }
  count_vectors<kLoads>(c, [&](VecGroup<kLoads>& grp) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
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

  // head and tail elements (lanes 0-15 and 16-31), then the pad columns
  for (int r = warp; ragged && r < nrows; r += kRowWarps) {
    const RowBody<T> rb = row_body(plane, R0 + r, H, W, c0, len);
    const int tail0 = rb.head + (rb.nv << RowBody<T>::kShift);
    if (lane < 16) {
      if (lane < rb.head) c.add_one(rb.s[lane]);
    } else if (tail0 + lane - 16 < len) {
      c.add_one(rb.s[tail0 + lane - 16]);
    }
    const T* src = rb.s - c0;  // the source row
    for (int k = lane; k < npad; k += 32) c.add_one(src[reflect101(cp + k, W)]);
  }
}

// A tile piece's columns: tile column tx, columns [c0, c0 + pw) of the
// padded plane; len interior ones, npad pad ones from cp.
struct Piece {
  int c0, len, cp, npad;
  bool ragged;  // rows with head, tail or pad elements
};

template <typename T>
__device__ __forceinline__ Piece tile_piece(const T* plane, int W, int c0, int pw) {
  Piece p;
  p.c0 = c0;
  p.len = max(min(c0 + pw, W) - c0, 0);
  p.cp = max(c0, W);
  p.npad = c0 + pw - p.cp;
  // unless every row starts on a 16-byte boundary and its interior is whole
  // vectors, with no pad
  p.ragged = (reinterpret_cast<uintptr_t>(plane + c0) & 15) != 0 ||
             ((W | p.len) & ((1 << RowBody<T>::kShift) - 1)) != 0 || p.npad > 0;
  return p;
}

// Vectors a lane loads at a time (the A/B timed 1 within 2 % of 3).
constexpr int kTileLoads = 3;

__global__ void __launch_bounds__(kCountThreads, 3)
hist256_tiles_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ hist,
                     uint8_t* __restrict__ lut, int32_t clip_abs, float scale,
                     uint32_t* __restrict__ partial, int32_t* __restrict__ tickets, int H, int W,
                     int gh, int gw, int th, int tw, int band_rows, int bands) {
  extern __shared__ __align__(16) uint32_t count_smem[];
  HistCounter c;
  c.begin(count_smem);
  __syncthreads();

  const int64_t tile = blockIdx.x;  // b * gh * gw + ty * gw + tx
  const int ntiles = gh * gw;
  const int64_t b = tile / ntiles;
  const int t = int(tile - b * ntiles);
  const int ty = t / gw, tx = t - (t / gw) * gw;
  const uint8_t* plane = x + b * int64_t(H) * W;
  const Piece pc = tile_piece(plane, W, tx * tw, tw);

  for (int band = blockIdx.y; band < bands; band += gridDim.y) {
    const int R0 = ty * th + band * band_rows;  // the band's first padded row
    const int nrows = min(band_rows, th - band * band_rows);
    count_tile_rows<uint8_t, kTileLoads, kCountThreads / 32>(c, plane, H, W, R0, nrows, pc.c0,
                                                            pc.len, pc.cp, pc.npad, pc.ragged);
  }
  __syncthreads();

  uint32_t sum = c.bin_total();
  if (!last_of_group(sum, partial + tile * gridDim.y * 256, blockIdx.y, gridDim.y,
                     tickets + tile))
    return;
  if (hist) hist[tile * 256 + threadIdx.x] = int32_t(sum);
  if (lut) lut[tile * 256 + threadIdx.x] = clahe_lut256_entry(int32_t(sum), clip_abs, scale);
}

// ---------------------------------------------------------------------------
// clahe_lut: stage B.  The JAX package has no TPU kernel here: it is XLA
// (the JAX package's ops/clahe.py::clahe_tile_luts, :74-97), about ten
// small ops over [T, S]:
//   clip at clip_abs, sum the excess, raise every bin by excess / S, add 1 at
//   bins i with i % step == 0 && i / step < excess % S (step = max(S / resid,
//   1)), take the inclusive scan, lut = clamp(rint(f32(cdf) * scale), 0, S-1)
// with clip_abs and scale = f32(S-1) / f32(area) computed by the caller;
// clip_abs 0 skips the clip.  All sums are at most the tile's area, below
// 2^31.  Two routes, one per table size:
//  * S = 256 (u8): one block of 256 threads per tile, one bin a thread; the
//    block reduces and scans with warp shuffles.  Bound by launch latency.
//    The CLAHE path runs this law in hist256_tiles' epilogue instead
//    (tile_luts256); this kernel serves callers that hold histograms.
//  * S = 65536 (u16): clahe_lut16_kernel below, one cluster of blocks per
//    tile.  Bound by device memory: 6 B per bin.  The CLAHE path runs its
//    law in hist65536_tiles' epilogue instead (tile_luts65536).
// ---------------------------------------------------------------------------

// S = 256: one block of 256 threads a tile, one bin a thread, through
// hist_count.cuh::clahe_lut256_entry (the law the tiles kernel's epilogue
// runs too).
__global__ void __launch_bounds__(256)
clahe_lut256_kernel(const int32_t* __restrict__ hist, uint8_t* __restrict__ lut, int32_t clip_abs,
                    float scale) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  lut[i] = clahe_lut256_entry(hist[i], clip_abs, scale);
}

// ---------------------------------------------------------------------------
// clahe_lut16_kernel: stage B at S = 65536.  The same function in closed
// form: with Pc(i) the inclusive prefix of min(h, clip_abs) (of h without a
// clip), raise = excess / S and resid = excess % S, the bumps at bins <= i
// number min(i / step + 1, resid) (resid * step <= S, so every bump lies
// below S; none when resid = 0), and
//   cdf(i) = Pc(i) + raise * (i + 1) + min(i / step + 1, resid).
// So one read of a bin gives both its share of the excess and its clipped
// value, and i / step is one division per thread and round, then a counter
// (lut16_octet, which the u16 tiles kernel's epilogue runs too).
//
// One cluster of kLut16Blocks blocks per tile (tiles stride over the
// clusters of the grid): block `rank` owns bins [rank * 8192, rank * 8192 +
// 8192), warp w of it 512 of them, and in round r lane l the 8 bins from
// w * 512 + r * 256 + l * 8: two 16-byte loads, one 16-byte store of 8 u16,
// so a warp's loads cover 1 KiB and its store 512 contiguous bytes.  Each
// block reduces its clipped sum and its excess into shared memory; after a
// cluster barrier, warp 0 reads the cluster's pairs through distributed
// shared memory: the tile's excess and the clipped sum of the lower ranks
// (tile_context).  Each lane then scans its bins in registers.  The
// histograms are read once and the LUTs written once, 6 B per bin, and a
// 4K frame pair on an 8x8 grid gives 1024 blocks, where one block a tile
// gave 128 for 132 SMs.
// ---------------------------------------------------------------------------

constexpr int kLut16Blocks = 8;  // a cluster: the most a launch may ask for without opting in
// Chosen by A/B (tools/torch_hist_profile.py --ablut, PERF.md §6) over
// clusters of 2 or 4 blocks of 1024 threads, blocks of 256 or 1024 threads,
// and 2 or 4 resident blocks a SM.
constexpr int kLut16Threads = 512;
constexpr int kLut16MinBlocks = 3;  // resident blocks a SM: at most 42 registers
constexpr int kLut16Bins = 8;  // bins a lane takes in a round

// The layout of a tile's 65536 bins over a cluster of kBlocks blocks of
// kThreads threads: block `rank` owns 65536 / kBlocks of them, warp w
// kWarpBins, and lane l in round r the 8 from first_bin(rank) + r * 256.
template <int kBlocks, int kThreads>
struct Lut16Layout {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRounds = 65536 / (kBlocks * kThreads * kLut16Bins);
  static constexpr int kWarpBins = kRounds * 32 * kLut16Bins;
  static_assert(kRounds >= 1 && kRounds * kBlocks * kThreads * kLut16Bins == 65536,
                "the cluster covers a tile's 65536 bins exactly");
  static __device__ __forceinline__ int first_bin(int rank) {
    return rank * (65536 / kBlocks) + (threadIdx.x >> 5) * kWarpBins + (threadIdx.x & 31) * kLut16Bins;
  }
};

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

__device__ __forceinline__ int32_t warp_total(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The halves of the cluster barrier that cooperative_groups' sync() joins:
// arrive (release) once this block's reads of its peers are done, wait
// (acquire) before its shared memory is written again or the block exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The tile's context for the lanes of a block of a kBlocks cluster, from
// each warp's clipped sum (wclip) and excess (ex), both uniform across the
// warp: the tile's excess (x) and the clipped sum of the bins before this
// lane's first bin (y: the lower ranks' and the lower warps' of this
// block).  Each block publishes its pair in shared memory; after a cluster
// barrier warp 0 reads the cluster's pairs through distributed shared
// memory.  The caller calls cluster_arrive() once it reads no peer any more
// (these words, or others), and cluster_wait() before these words are
// written again or the block exits.
template <int kBlocks, int kWarps>
__device__ __forceinline__ int2 tile_context(int32_t wclip, int32_t ex, int rank,
                                             cg::cluster_group& cluster) {
  __shared__ int32_t warp_clip[kWarps], warp_ex[kWarps];
  __shared__ int32_t block_pair[2];  // this block's clipped sum and excess, for the cluster
  __shared__ int32_t tile_ctx[2];    // the tile's excess, the lower ranks' clipped sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_clip[warp] = wclip, warp_ex[warp] = ex;
  __syncthreads();
  if (warp == 0) {
    const int32_t a = warp_total(lane < kWarps ? warp_clip[lane] : 0);
    const int32_t e = warp_total(lane < kWarps ? warp_ex[lane] : 0);
    if (lane == 0) block_pair[0] = a, block_pair[1] = e;
  }
  cluster.sync();  // every block's pair is in its shared memory
  if (warp == 0) {
    int32_t a = 0, e = 0;
    if (lane < kBlocks) {
      const int32_t* peer = cluster.map_shared_rank(block_pair, lane);
      e = peer[1];
      a = lane < rank ? peer[0] : 0;
    }
    a = warp_total(a);
    e = warp_total(e);
    if (lane == 0) tile_ctx[0] = e, tile_ctx[1] = a;
  }
  __syncthreads();
  int32_t before = tile_ctx[1];
  for (int w = 0; w < warp; ++w) before += warp_clip[w];
  return make_int2(tile_ctx[0], before);
}

// Stage B's law on the 8 bins i0 .. i0 + 7 of a tile, c their clipped
// counts and `cum` the clipped sum of the bins before i0 (raised by the 8 on
// return): cdf(i) = cum(i) + raise * (i + 1) + min(i / step + 1, resid),
// with i / step from one division and a counter, then
//   lut = clamp(rint(f32(cdf) * scale), 0, 65535),
// packed as 8 u16 for one 16-byte store.  Written once for both kernels
// that build u16 LUTs.
__device__ __forceinline__ uint4 lut16_octet(const int32_t (&c)[kLut16Bins], int32_t& cum, int i0,
                                             int32_t raise, int32_t resid, int step, float scale) {
  int q = i0 / step, rem = i0 - q * step;  // i / step and i % step, carried below
  uint32_t w[kLut16Bins / 2] = {};
#pragma unroll
  for (int j = 0; j < kLut16Bins; ++j) {
    cum += c[j];
    const int32_t cdf = cum + raise * (i0 + j + 1) + min(q + 1, resid);
    const float f = rintf(__fmul_rn(__int2float_rn(cdf), scale));
    w[j >> 1] |= uint32_t(__float2int_rn(fminf(fmaxf(f, 0.0f), 65535.0f))) << (16 * (j & 1));
    if (++rem == step) rem = 0, ++q;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __cluster_dims__(kLut16Blocks, 1, 1)
__launch_bounds__(kLut16Threads, kLut16MinBlocks)
clahe_lut16_kernel(const int32_t* __restrict__ hist, uint16_t* __restrict__ lut, int64_t T,
                   int32_t clip_abs, float scale) {
  using L = Lut16Layout<kLut16Blocks, kLut16Threads>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int i_lane = L::first_bin(rank);  // this lane's first bin in round 0; round r adds r * 256

  for (int64_t tile = blockIdx.x / kLut16Blocks; tile < T; tile += gridDim.x / kLut16Blocks) {
    const int32_t* h = hist + tile * 65536 + i_lane;
    int32_t c[L::kRounds][kLut16Bins];
#pragma unroll
    for (int r = 0; r < L::kRounds; ++r) {
      const int4* p = reinterpret_cast<const int4*>(h + r * 32 * kLut16Bins);
      const int4 a = __ldg(p), b = __ldg(p + 1);
      c[r][0] = a.x, c[r][1] = a.y, c[r][2] = a.z, c[r][3] = a.w;
      c[r][4] = b.x, c[r][5] = b.y, c[r][6] = b.z, c[r][7] = b.w;
    }
    // clip in place; each round's clipped sum scanned over the warp's lanes
    int32_t ex = 0, mine[L::kRounds], incl[L::kRounds];
#pragma unroll
    for (int r = 0; r < L::kRounds; ++r) {
      mine[r] = 0;
#pragma unroll
      for (int j = 0; j < kLut16Bins; ++j) {
        if (clip_abs > 0) {
          ex += max(c[r][j] - clip_abs, 0);
          c[r][j] = min(c[r][j], clip_abs);
        }
        mine[r] += c[r][j];
      }
      incl[r] = warp_inclusive_scan(mine[r]);
    }
    int32_t wclip = 0;
#pragma unroll
    for (int r = 0; r < L::kRounds; ++r) wclip += __shfl_sync(0xffffffffu, incl[r], 31);
    const int2 ctx = tile_context<kLut16Blocks, L::kWarps>(wclip, warp_total(ex), rank, cluster);
    cluster_arrive();  // this block is done with its peers' and its own shared memory

    const int32_t raise = ctx.x >> 16, resid = ctx.x & 65535;
    const int step = max(65536 / max(resid, 1), 1);
    int32_t before = ctx.y;  // clipped bins before this lane's in round 0
    uint16_t* o = lut + tile * 65536 + i_lane;
#pragma unroll
    for (int r = 0; r < L::kRounds; ++r) {
      int32_t cum = before + incl[r] - mine[r];
      *reinterpret_cast<uint4*>(o + r * 32 * kLut16Bins) =
          lut16_octet(c[r], cum, i_lane + r * 32 * kLut16Bins, raise, resid, step, scale);
      before += __shfl_sync(0xffffffffu, incl[r], 31);
    }
    cluster_wait();  // the cluster's reads of this block's pair are done
  }
}

// ---------------------------------------------------------------------------
// hist65536_tiles and tile_luts65536: stage A for u16, and stages A and B
// in one launch (one kernel, hist65536_tiles_kernel<kLut>).  The JAX package
// computes stage A in XLA (ops/clahe.py:55-61: a byte-split MXU product on
// the TPU, a scatter elsewhere; no Pallas kernel) and stage B too
// (ops/clahe.py:74-97).  The torch route (kernels/clahe.py::
// tile_hists_plain: int64 widening, two index copies and a bincount into
// B*gh*gw*65536 bins) moves about 1.5 GB for 33 MB of pixels.  Bound by
// device memory: 2 B/px read, and the [B*gh*gw, 65536] int32 histograms
// (hist65536_tiles) or u16 LUTs (tile_luts65536) written once.
//
// 65536 int32 counters (256 KiB) do not fit a block's shared memory; 65536
// 16-bit ones (128 KiB) do, and hold up to 65535 pixels.  So the
// kHist16Ranks blocks of a tile (tiles on gridDim.x, ranks on gridDim.y)
// form one thread-block cluster, the tile's padded rows are cut into
// kHist16Ranks shares, and each block walks only its own share with
// hist256_tiles' row walk (count_tile_rows: rows read in place as 16-byte
// vectors of 8 pixels, the pad through reflected indices), so each pixel
// is read by exactly one block of the cluster.  A block counts its pixels
// into its own 16-bit counters of the whole value range (value v in half
// v & 1 of word v >> 1; one shared atomic a pixel, one a vector of 8 equal
// pixels), in rounds of at most 65535 pixels (kernels/clahe.py::
// tile16_rounds; one round for tiles up to 2 x 65535 pixels, a 4K tile on
// an 8x8 grid among them).  Then block `rank` owns values [rank *
// kRankBins, ...): after a cluster barrier it sums their counters over the
// cluster's blocks (its own, and its peers' through distributed shared
// memory: 16-byte loads of 8 counters), so no atomic leaves its block.  Each
// lane takes the 8 bins of Lut16Layout: lut16_octet's, 16 bytes of counters
// from each block a round.
//  * hist (kLut false): each block stores its range of the tile's int32
//    bins whole;
//  * lut (kLut true): stage B on those sums (the closed form of
//    clahe_lut16_kernel, the same layout and the same law, lut16_octet),
//    summed twice (once for the clipped sums and the excess, once for the
//    entries) rather than held in registers; the blocks' (clipped, excess)
//    pairs meet through distributed shared memory (tile_context), and each
//    block writes its range of the tile's u16 LUT once.  No histogram goes
//    to device memory unless the tile takes more than one round.
// Between rounds each block adds its range's sums into `acc` (the output
// histograms, or the LUT route's scratch), and re-zeroes its counters once
// the cluster is past a second barrier (its peers' reads of them are done).
// A block exits only after a last cluster barrier, once its peers have read
// its counters and its pair.  Chosen by A/B (tools/torch_hist_profile.py --ab16,
// PERF.md §6) over splitting the int32 counters by value among the ranks
// and adding each pixel into its owner's counters, half of them a peer's
// through distributed shared memory (2.9x slower on random planes), a
// cluster of 4, 512 threads, 1 or 4 loads a group, constant-increment
// adds, a vector of two values in two adds, and two blocks that each walk
// the whole tile and count one half of the value range in int32 counters
// (the tile read twice; stage B a second launch).
// ---------------------------------------------------------------------------

constexpr int kHist16Ranks = 2;         // blocks a tile: one cluster
constexpr int kHist16Threads = 1024;
constexpr int kHist16MinBlocks = 1;     // resident blocks a SM
constexpr int kHist16Loads = 2;         // vectors a lane loads at a time
constexpr int kRankBins = 65536 / kHist16Ranks;
constexpr int kRoundPixels = 65535;     // the most a 16-bit counter holds
static_assert(kRankBins * kHist16Ranks == 65536, "the ranks split the value range evenly");

struct Count16 {
  static constexpr int kSmemBytes = 65536 * 2;
  uint32_t* w;  // value v: half v & 1 of word v >> 1

  __device__ __forceinline__ void zero() {
    uint4* z = reinterpret_cast<uint4*>(w);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += kHist16Threads) z[i] = make_uint4(0, 0, 0, 0);
  }
  // One atomic whose increment depends on the half: lanes of a warp that
  // add to one word take a step each.  (Constant increments, +1 in a low
  // half and 1 << 16 in a high one, let the hardware sum a warp's +1 lanes
  // into one word in one step, but cost two atomics a pixel under
  // divergence: 8 % slower on random planes, PERF.md §6.)
  __device__ __forceinline__ void add(uint32_t v, uint32_t n) {
    atomicAdd(&w[v >> 1], n << ((v & 1u) << 4));
  }
  __device__ __forceinline__ void add_one(uint32_t v) { add(v, 1u); }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    const uint32_t b = v.x & 0xffffu;
    if (v.x == b * 0x10001u && v.y == v.x && v.z == v.x && v.w == v.x) {
      add(b, 8u);
      return;
    }
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      add(q[i] & 0xffffu, 1u);
      add(q[i] >> 16, 1u);
    }
  }
};

// A block's rounds: its share of the tile's rows (share rows, the last
// rank's shorter or empty) in row bands by column pieces of at most
// kRoundPixels pixels; every rank takes the same count of rounds.
struct Rounds16 {
  int share, piece_w, band_rows, pieces, bands;
  __device__ __forceinline__ Rounds16(int th, int tw) {
    share = th / kHist16Ranks + (th % kHist16Ranks != 0);
    piece_w = min(tw, kRoundPixels);
    band_rows = kRoundPixels / piece_w;
    pieces = tw / piece_w + (tw % piece_w != 0);
    bands = share / band_rows + (share % band_rows != 0);
  }
};

// The 8 bins i0 .. i0 + 7 (i0 a multiple of 8) summed over the cluster's
// blocks: 16 bytes of 16-bit counters from each (this block's own
// directly, its peers' through distributed shared memory), plus acc's
// int32 sums of the earlier rounds where acc is given.
__device__ __forceinline__ void cluster_bins(int32_t (&c)[kLut16Bins], const uint32_t* w, int i0,
                                             int rank, const int32_t* acc,
                                             cg::cluster_group& cluster) {
#pragma unroll
  for (int j = 0; j < kLut16Bins; ++j) c[j] = 0;
  const uint4* mine = reinterpret_cast<const uint4*>(w + (i0 >> 1));
#pragma unroll
  for (int q = 0; q < kHist16Ranks; ++q) {
    const uint4 v = q == rank ? *mine : *cluster.map_shared_rank(mine, q);
    const uint32_t d[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] += int32_t(d[k] & 0xffffu);
      c[2 * k + 1] += int32_t(d[k] >> 16);
    }
  }
  if (acc) {
    const int4 a = reinterpret_cast<const int4*>(acc + i0)[0], b = reinterpret_cast<const int4*>(acc + i0)[1];
    c[0] += a.x, c[1] += a.y, c[2] += a.z, c[3] += a.w;
    c[4] += b.x, c[5] += b.y, c[6] += b.z, c[7] += b.w;
  }
}

template <bool kLut>
__global__ void __cluster_dims__(1, kHist16Ranks, 1)
__launch_bounds__(kHist16Threads, kHist16MinBlocks)
hist65536_tiles_kernel(const uint16_t* __restrict__ x, int32_t* __restrict__ hist,
                       uint16_t* __restrict__ lut, int32_t* __restrict__ scratch, int32_t clip_abs,
                       float scale, int H, int W, int gh, int gw, int th, int tw) {
  extern __shared__ __align__(16) uint32_t count_smem[];
  using L = Lut16Layout<kHist16Ranks, kHist16Threads>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());  // blockIdx.y
  Count16 c;
  c.w = count_smem;

  const int64_t tile = blockIdx.x;  // b * gh * gw + ty * gw + tx
  const int ntiles = gh * gw;
  const int64_t b = tile / ntiles;
  const int t = int(tile - b * ntiles);
  const int ty = t / gw, tx = t - (t / gw) * gw;
  const uint16_t* plane = x + b * int64_t(H) * W;
  const Rounds16 rd(th, tw);
  const int64_t s0 = int64_t(rank) * rd.share;
  const int r0 = s0 < th ? int(s0) : th;        // this block's share of the tile's rows
  const int nrows = min(rd.share, th - r0);
  const int i_lane = L::first_bin(rank);  // this lane's first bin in round 0; round r adds r * 256
  int32_t* acc = (kLut ? scratch : hist) + tile * 65536;  // the earlier rounds' sums

  const int nrounds = rd.pieces * rd.bands;
  for (int round = 0; round < nrounds; ++round) {
    c.zero();
    __syncthreads();
    const int piece = round / rd.bands, band = round - piece * rd.bands;
    const int pc0 = piece * rd.piece_w;
    const Piece pc = tile_piece(plane, W, tx * tw + pc0, min(rd.piece_w, tw - pc0));
    const int q0 = band * rd.band_rows;
    count_tile_rows<uint16_t, kHist16Loads, kHist16Threads / 32>(
        c, plane, H, W, ty * th + r0 + q0, min(rd.band_rows, nrows - q0), pc.c0, pc.len, pc.cp,
        pc.npad, pc.ragged);
    cluster.sync();  // every block's counters of this round are complete
    if (round == nrounds - 1) break;
    // an earlier round: this block's range into acc, then the counters anew
    for (int r = 0; r < L::kRounds; ++r) {
      const int i0 = i_lane + r * 32 * kLut16Bins;
      int32_t s[kLut16Bins];
      cluster_bins(s, count_smem, i0, rank, round ? acc : nullptr, cluster);
      int4* o = reinterpret_cast<int4*>(acc + i0);
      o[0] = make_int4(s[0], s[1], s[2], s[3]);
      o[1] = make_int4(s[4], s[5], s[6], s[7]);
    }
    cluster.sync();  // the cluster's reads of this block's counters are done
  }
  const int32_t* prev = nrounds > 1 ? acc : nullptr;

  if (!kLut) {
    for (int r = 0; r < L::kRounds; ++r) {
      const int i0 = i_lane + r * 32 * kLut16Bins;
      int32_t s[kLut16Bins];
      cluster_bins(s, count_smem, i0, rank, prev, cluster);
      int4* o = reinterpret_cast<int4*>(hist + tile * 65536 + i0);
      o[0] = make_int4(s[0], s[1], s[2], s[3]);
      o[1] = make_int4(s[4], s[5], s[6], s[7]);
    }
    cluster_arrive();  // this block reads no peer any more
    cluster_wait();    // the cluster's reads of this block's counters are done
    return;
  }
  // first sum: each round's clipped sum scanned over the warp's lanes, the excess
  int32_t ex = 0, mine[L::kRounds], incl[L::kRounds];
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) {
    int32_t cr[kLut16Bins];
    cluster_bins(cr, count_smem, i_lane + r * 32 * kLut16Bins, rank, prev, cluster);
    mine[r] = 0;
#pragma unroll
    for (int j = 0; j < kLut16Bins; ++j) {
      if (clip_abs > 0) ex += max(cr[j] - clip_abs, 0);
      mine[r] += clip_abs > 0 ? min(cr[j], clip_abs) : cr[j];
    }
    incl[r] = warp_inclusive_scan(mine[r]);
  }
  int32_t wclip = 0;
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) wclip += __shfl_sync(0xffffffffu, incl[r], 31);
  const int2 ctx = tile_context<kHist16Ranks, L::kWarps>(wclip, warp_total(ex), rank, cluster);

  // second sum: the entries
  const int32_t raise = ctx.x >> 16, resid = ctx.x & 65535;
  const int step = max(65536 / max(resid, 1), 1);
  int32_t before = ctx.y;  // clipped bins before this lane's in round 0
  uint16_t* o = lut + tile * 65536 + i_lane;
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) {
    int32_t cr[kLut16Bins];
    cluster_bins(cr, count_smem, i_lane + r * 32 * kLut16Bins, rank, prev, cluster);
    if (clip_abs > 0) {
#pragma unroll
      for (int j = 0; j < kLut16Bins; ++j) cr[j] = min(cr[j], clip_abs);
    }
    int32_t cum = before + incl[r] - mine[r];
    *reinterpret_cast<uint4*>(o + r * 32 * kLut16Bins) =
        lut16_octet(cr, cum, i_lane + r * 32 * kLut16Bins, raise, resid, step, scale);
    before += __shfl_sync(0xffffffffu, incl[r], 31);
  }
  cluster_arrive();  // this block reads no peer any more
  cluster_wait();    // the cluster's reads of this block's counters and pair are done
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
// u16 (clahe_blend_u16_kernel, S = 65536: 128 KiB per LUT, 512 KiB for a
// cell's four).  Per-pixel gathers from the [B*T, S] tables meet four
// scattered 32-byte L2 sectors per pixel (about 2 GB of L2 traffic for a
// 4K pair), so here the LUTs come to the pixels in value chunks through
// shared memory.  A block covers a region of one plane inside one
// interpolation cell: rows of one row cell (kernels/clahe.py::
// blend16_rows) by the columns of one column piece (blend16_pieces: a
// column cell, cut at kB16MaxPieceVecs vectors), as many rows as fill its
// kB16Threads * kB16Vecs vectors of 8 pixels.  A thread loads kB16Vecs
// vectors into shared memory (its words at a stride of kB16Threads, so a
// warp's reads of them meet no bank conflict); pixels of an edge vector
// outside the piece belong to the neighbouring cell's block and are not
// stored.  The block finds its least and greatest value and the
// kB16Chunk-value chunks its pixels use; for each used chunk it stages
// only the values between its least and greatest, as 8-byte quads
// (l00 | l01 << 16, l10 | l11 << 16: coalesced 16-byte loads of the four
// LUT rows, __byte_perm), then the chunk's pixels read their quads there
// and blend.  A warp whose lanes each have all their pixels in the chunk
// or none (flat, 12-bit, most smooth regions) walks each lane's words in
// order; else each lane walks its own pixels of the chunk, found through
// bit planes of the value bits above the chunk (bit k of plane i: bit
// kB16Shift + i of pixel k), lowest first.  u16 -> f32 as 0x4B000000 | v
// minus 2^23 and the result as the low bits of r + 2^23, as for u8.
// Chosen by A/B (tools/torch_hist_profile.py --ab16, PERF.md §6): 16 or
// 64 pixels a thread, chunks of 4096 or 16384 values and the walk without
// the one-chunk path lost on every kind of plane they changed; 1024-thread
// blocks and four-array staging won on random planes and lost on flat and
// 12-bit ones, which real u16 frames resemble more.  Random data stays
// bound by the per-lane walk over 8 chunks and the L2 reads of the staged
// quads; two-valued planes ({0, 65535}) stage two whole chunks and walk both.
// ---------------------------------------------------------------------------

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

constexpr int kB16Threads = 512;
constexpr int kB16Vecs = 4;           // 8-pixel vectors a thread holds: 32 pixels
constexpr int kB16Items = kB16Threads * kB16Vecs;  // vectors a block covers at most
constexpr int kB16Shift = 13;         // chunks of 8192 values: 64 KiB of quads
constexpr int kB16Chunk = 1 << kB16Shift;
constexpr int kB16Planes = 16 - kB16Shift;
constexpr int kB16MaxPieceVecs = 256;  // columns of a piece: 8 KiB of fx
constexpr int kB16MinBlocks = 2;
// quads, the piece's fx, the block's pixels (word w of thread t at w * kB16Threads + t)
constexpr int kB16SmemBytes = kB16Chunk * 8 + kB16MaxPieceVecs * 8 * 4 + kB16Items * 16;
// bit 8 j + k of a thread's masks: pixel k of its vector j
using B16Mask = std::conditional_t<kB16Vecs * 8 <= 32, uint32_t, uint64_t>;

__device__ __forceinline__ float u16_entry(uint32_t w, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, kMagic, sel)), kTwo23);
}

__device__ __forceinline__ int lowest_bit(uint32_t m) { return __ffs(int(m)) - 1; }
__device__ __forceinline__ int lowest_bit(uint64_t m) { return __ffsll((long long)(m)) - 1; }

// the pixels of `m` in value chunk ch, from the bit planes
__device__ __forceinline__ B16Mask chunk_pixels(const B16Mask (&bits)[kB16Planes], B16Mask m,
                                                int ch) {
#pragma unroll
  for (int i = 0; i < kB16Planes; ++i) m &= ((ch >> i) & 1) ? bits[i] : ~bits[i];
  return m;
}

// entry j of a thread's per-vector registers, j < kB16Vecs, without local memory
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kB16Vecs], int j) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < kB16Vecs; ++i) r = j == i ? a[i] : r;
  return r;
}

// Stage values v0 + 8 g .. v0 + 8 g + 7 of the four LUT rows (r00, r01:
// the top row's left and right tiles; r10, r11 the bottom row's): one
// 16-byte load from each row, four 16-byte stores of interleaved quads
// (l00 | l01 << 16, l10 | l11 << 16), quad v - v0 at 8-byte word v - v0.
__device__ __forceinline__ void stage_quads16(uint4* smem, const uint16_t* __restrict__ r00,
                                              const uint16_t* __restrict__ r01,
                                              const uint16_t* __restrict__ r10,
                                              const uint16_t* __restrict__ r11, int g) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(r00) + g);
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(r01) + g);
  const uint4 c = __ldg(reinterpret_cast<const uint4*>(r10) + g);
  const uint4 d = __ldg(reinterpret_cast<const uint4*>(r11) + g);
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  const uint32_t cw[4] = {c.x, c.y, c.z, c.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
    smem[4 * g + w] = make_uint4(__byte_perm(aw[w], bw[w], 0x5410), __byte_perm(cw[w], dw[w], 0x5410),
                                 __byte_perm(aw[w], bw[w], 0x7632), __byte_perm(cw[w], dw[w], 0x7632));
}

// the staged quad of value v (in the chunk)
__device__ __forceinline__ uint2 quad_at(const uint4* smem, uint32_t v) {
  return reinterpret_cast<const uint2*>(smem)[v & (kB16Chunk - 1)];
}

// blend pixel k (0 or 1) of word w through quad q: the four entries, then
// blend_tile_luts' association, each step rounded once; the result in the
// low 16 bits
__device__ __forceinline__ uint32_t blend16(uint2 q, float fx, float fy) {
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(gx, u16_entry(q.x, 0x7610)),
                              __fmul_rn(fx, u16_entry(q.x, 0x7632)));
  const float bot = __fadd_rn(__fmul_rn(gx, u16_entry(q.y, 0x7610)),
                              __fmul_rn(fx, u16_entry(q.y, 0x7632)));
  const float r = fminf(fmaxf(__fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot)), 0.0f), 65535.0f);
  return __float_as_uint(__fadd_rn(r, kTwo23));
}

// pieces: [npieces, 3] int32 (first column, end column, rows per block);
// rcells: [nrcells, 2] int32 (first row, end row).  blockIdx.x is piece *
// maxbands + band; (plane, row cell) pairs stride over gridDim.y.
template <bool kVec>
__global__ void __launch_bounds__(kB16Threads, kB16MinBlocks)
clahe_blend_u16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ luts,
                       uint16_t* __restrict__ out, int64_t B, int H, int W, int gh, int gw,
                       const int32_t* __restrict__ yidx, const float* __restrict__ fyv,
                       const int32_t* __restrict__ xidx, const float* __restrict__ fxv,
                       const int32_t* __restrict__ pieces, int maxbands,
                       const int32_t* __restrict__ rcells, int nrcells) {
  extern __shared__ __align__(16) uint4 b16_smem[];
  float* sfx = reinterpret_cast<float*>(b16_smem + kB16Chunk / 2);
  uint32_t* px = reinterpret_cast<uint32_t*>(sfx + kB16MaxPieceVecs * 8);
  __shared__ uint32_t vrange[3];  // the block's least and greatest value, its chunks
  const int tid = threadIdx.x;
  const int p = blockIdx.x / maxbands, band = blockIdx.x - p * maxbands;
  const int xa = pieces[3 * p], xb = pieces[3 * p + 1], rpb = pieces[3 * p + 2];
  const int xv = xa & ~7;                      // the first vector's first column
  const int nv = ((xb + 7) >> 3) - (xa >> 3);  // vectors per row
  for (int i = tid; i < nv * 8; i += kB16Threads) sfx[i] = fxv[min(xv + i, W - 1)];
  const int tx0 = xidx[xa], tx1 = xidx[W + xa];
  const int64_t ntiles = int64_t(gh) * gw;

  for (int64_t item = blockIdx.y; item < B * nrcells; item += gridDim.y) {
    const int64_t b = item / nrcells;
    const int rc = int(item - b * nrcells);
    const int64_t ya64 = rcells[2 * rc] + int64_t(band) * rpb;
    const int yend = rcells[2 * rc + 1];
    if (ya64 >= yend) continue;  // the same for the whole block
    const int ya = int(ya64);
    const int n = (min(ya + rpb, yend) - ya) * nv;  // the region's vectors
    const int ty0 = yidx[ya], ty1 = yidx[H + ya];
    const int64_t plane = b * int64_t(H) * W;

    // the thread's vectors (8 pixels each, two to a word) into px, where
    // word w of vector j is px[(4 j + w) * kB16Threads + tid]; a pixel
    // outside the piece's columns takes the value of one inside, so that
    // every pixel of a vector lies in a chunk its block stages (it is
    // blended, and not stored).  The row's fy and the first column relative
    // to xv stay in registers.
    float fy[kB16Vecs];
    int col[kB16Vecs];
    B16Mask valid = 0;                 // the block's pixels (columns [xa, xb))
    uint32_t vmin2 = 0xffffffffu, vmax2 = 0;  // per 16-bit half
#pragma unroll
    for (int j = 0; j < kB16Vecs; ++j) {
      const int it = tid + j * kB16Threads;
      fy[j] = 0.0f;
      col[j] = 0;
      if (it >= n) continue;
      const int r = it / nv;
      col[j] = (it - r * nv) << 3;
      fy[j] = fyv[ya + r];
      const uint16_t* src = x + plane + int64_t(ya + r) * W + xv + col[j];
      uint32_t d[4] = {0, 0, 0, 0};
      if (kVec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      uint32_t vm = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = xv + col[j] + k;
        if (!kVec && c < W) d[k >> 1] |= uint32_t(src[k]) << (16 * (k & 1));
        if (c >= xa && c < xb) vm |= 1u << k;
      }
      valid |= B16Mask(vm) << (8 * j);
      if (vm != 0xffu) {  // an edge vector: the first pixel inside fills the rest
        const int k0 = __ffs(int(vm)) - 1;
        const uint32_t v0 = (d[k0 >> 1] >> (16 * (k0 & 1))) & 0xffffu;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (!((vm >> k) & 1u))
            d[k >> 1] = (d[k >> 1] & (0xffffu << (16 * (1 - (k & 1))))) | (v0 << (16 * (k & 1)));
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        px[(4 * j + w) * kB16Threads + tid] = d[w];
        vmin2 = __vminu2(vmin2, d[w]);
        vmax2 = __vmaxu2(vmax2, d[w]);
      }
    }
    const uint32_t tmin = min(vmin2 & 0xffffu, vmin2 >> 16);
    const uint32_t tmax = max(vmax2 & 0xffffu, vmax2 >> 16);
    const int cmin = valid ? int(tmin >> kB16Shift) : 1 << kB16Planes;  // the thread's chunks
    const int cmax = valid ? int(tmax >> kB16Shift) : -1;
    // the pixels of each chunk, where the thread's pixels span several:
    // bit plane i holds value bit kB16Shift + i of each pixel
    B16Mask bits[kB16Planes] = {};
    uint32_t mine = cmin == cmax ? 1u << cmin : 0u;  // the chunks the thread's pixels use
    if (cmin != cmax && cmax >= 0) {
#pragma unroll
      for (int s = 0; s < kB16Vecs * 8; s += 2) {
        const uint32_t w = px[(s >> 1) * kB16Threads + tid];
#pragma unroll
        for (int i = 0; i < kB16Planes; ++i)
          bits[i] |= (B16Mask((w >> (kB16Shift + i)) & 1u) << s) |
                     (B16Mask((w >> (16 + kB16Shift + i)) & 1u) << (s + 1));
      }
#pragma unroll
      for (int c = 0; c < (1 << kB16Planes); ++c)
        if (chunk_pixels(bits, valid, c)) mine |= 1u << c;
    }
    // the block's value range
    const uint32_t wmin = __reduce_min_sync(0xffffffffu, valid ? tmin : 0xffffu);
    const uint32_t wmax = __reduce_max_sync(0xffffffffu, valid ? tmax : 0u);
    mine = __reduce_or_sync(0xffffffffu, mine);
    __syncthreads();  // sfx is staged; the previous item's quads and vrange are read
    if (tid == 0) {
      vrange[0] = 0xffffu;
      vrange[1] = 0;
      vrange[2] = 0;
    }
    __syncthreads();
    if ((tid & 31) == 0) {
      atomicMin(&vrange[0], wmin);
      atomicMax(&vrange[1], wmax);
      atomicOr(&vrange[2], mine);
    }
    __syncthreads();
    const int bmin = int(vrange[0]), bmax = int(vrange[1]);
    uint32_t chunks = vrange[2];

    const uint16_t* lb = luts + ((b * ntiles) << 16);
    const int64_t t00 = int64_t(ty0 * gw + tx0) << 16, t01 = int64_t(ty0 * gw + tx1) << 16;
    const int64_t t10 = int64_t(ty1 * gw + tx0) << 16, t11 = int64_t(ty1 * gw + tx1) << 16;
    while (chunks) {
      const int ch = __ffs(int(chunks)) - 1;
      chunks &= chunks - 1;
      const int v0 = ch << kB16Shift;
      if (ch != (bmin >> kB16Shift)) __syncthreads();  // the previous chunk's quads are read
      // the chunk's values the block can use, 8 a step
      const int g0 = (max(bmin, v0) - v0) >> 3, g1 = (min(bmax, v0 + kB16Chunk - 1) - v0) >> 3;
      for (int g = g0 + tid; g <= g1; g += kB16Threads)
        stage_quads16(b16_smem, lb + t00 + v0, lb + t01 + v0, lb + t10 + v0, lb + t11 + v0, g);
      __syncthreads();
      const bool all_here = cmin == ch && cmax == ch;
      if (__all_sync(0xffffffffu, all_here || ch < cmin || ch > cmax)) {
        // every lane has all its pixels in this chunk or none: each takes its
        // words in order, both pixels of a word
        if (!all_here) continue;
#pragma unroll
        for (int j = 0; j < kB16Vecs; ++j) {
          if (!((valid >> (8 * j)) & 0xffu)) continue;
          const float* f = sfx + col[j];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            uint32_t* word = px + (4 * j + w) * kB16Threads + tid;
            const uint32_t v = *word;
            const uint32_t lo = blend16(quad_at(b16_smem, v), f[2 * w], fy[j]);
            const uint32_t hi = blend16(quad_at(b16_smem, v >> 16), f[2 * w + 1], fy[j]);
            *word = __byte_perm(lo, hi, 0x5410);
          }
        }
        continue;
      }
      // else each lane walks its own pixels of the chunk, lowest first: a
      // warp takes as many steps as its busiest lane has pixels there
      B16Mask m = (ch < cmin || ch > cmax) ? B16Mask(0) : valid;
      if (cmin != cmax) m = chunk_pixels(bits, m, ch);
      while (__any_sync(0xffffffffu, m != 0)) {
        if (!m) continue;
        const int s = lowest_bit(m);
        m &= m - 1;
        const int j = s >> 3, k = s & 7;
        uint16_t* slot = reinterpret_cast<uint16_t*>(px + (4 * j + (k >> 1)) * kB16Threads + tid) +
                         (k & 1);
        *slot = uint16_t(blend16(quad_at(b16_smem, *slot), sfx[pick(col, j) + k], pick(fy, j)));
      }
    }

    // the results replaced the thread's own pixels in px
#pragma unroll
    for (int j = 0; j < kB16Vecs; ++j) {
      const uint32_t vm = uint32_t(valid >> (8 * j)) & 0xffu;
      if (!vm) continue;
      const int r = (tid + j * kB16Threads) / nv;
      uint32_t d[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) d[w] = px[(4 * j + w) * kB16Threads + tid];
      uint16_t* dst = out + plane + int64_t(ya + r) * W + xv + col[j];
      if (kVec && vm == 0xffu) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(d[0], d[1], d[2], d[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if ((vm >> k) & 1u) dst[k] = uint16_t(d[k >> 1] >> (16 * (k & 1)));
      }
    }
  }
}

// x: [B, H, W] u8 contiguous; hist: [B*gh*gw, 256] int32 and lut:
// [B*gh*gw, 256] u8, each written whole where not null.  Tile (ty, tx)
// covers padded rows ty*th .. ty*th+th-1 and columns tx*tw .. tx*tw+tw-1,
// with gh*th >= H and gw*tw >= W.  Its rows come in `bands` bands of
// band_rows rows (the last one shorter), which stride over grid_y <=
// min(bands, 65535) (kernels/clahe.py::tile_band_plan).  With grid_y > 1,
// partial: [B*gh*gw, grid_y, 256] u32 scratch and tickets: B*gh*gw int32
// counters at 0 (left at 0), both unused (may be null) at grid_y == 1.
int launch_hist256_tiles(const uint8_t* x, int32_t* hist, uint8_t* lut, int32_t clip_abs,
                         float scale, uint32_t* partial, int32_t* tickets, int64_t B, int64_t H,
                         int64_t W, int32_t gh, int32_t gw, int64_t th, int64_t tw,
                         int64_t band_rows, int64_t bands, int64_t grid_y, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || th < 1 || tw < 1 ||
      int64_t(gh) * th < H || int64_t(gw) * tw < W || int64_t(gh) * th > 0x7fffffffLL ||
      int64_t(gw) * tw > 0x7fffffffLL || th * tw > 0x7fffffffLL ||
      B * gh * gw > 0x7fffffffLL || band_rows < 1 || bands < 1 ||
      (bands - 1) * band_rows >= th || bands * band_rows < th || grid_y < 1 || grid_y > bands ||
      grid_y > kMaxGridY || clip_abs < 0 ||
      (grid_y > 1 && (partial == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(B * gh * gw), unsigned(grid_y));
  hist256_tiles_kernel<<<grid, kCountThreads, HistCounter::kSmemBytes, stream>>>(
      x, hist, lut, clip_abs, scale, partial, tickets, int(H), int(W), gh, gw, int(th), int(tw),
      int(band_rows), int(bands));
  return int(cudaGetLastError());
}

// x: [B, H, W] u16 contiguous; hist: [B*gh*gw, 65536] int32 or lut:
// [B*gh*gw, 65536] u16 (the other null; 16-byte aligned), written whole.
// scratch: [B*gh*gw, 65536] int32 (16-byte aligned, no fill) where a LUT
// launch takes more than one round (kernels/clahe.py::tile16_rounds), else
// unused (may be null).  Tiles as for launch_hist256_tiles; th * tw below
// 2^31 (the int32 cdf).
int launch_hist65536_tiles(const uint16_t* x, int32_t* hist, uint16_t* lut, int32_t* scratch,
                           int32_t clip_abs, float scale, int64_t B, int64_t H, int64_t W,
                           int32_t gh, int32_t gw, int64_t th, int64_t tw, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || th < 1 || tw < 1 ||
      int64_t(gh) * th < H || int64_t(gw) * tw < W || int64_t(gh) * th > 0x7fffffffLL ||
      int64_t(gw) * tw > 0x7fffffffLL || th * tw > 0x7fffffffLL ||
      B * gh * gw > 0x7fffffffLL || clip_abs < 0 || (hist == nullptr) == (lut == nullptr) ||
      ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(lut) |
        reinterpret_cast<uintptr_t>(scratch)) & 15))
    return int(cudaErrorInvalidValue);
  const int64_t share = (th + kHist16Ranks - 1) / kHist16Ranks;
  const int64_t piece_w = tw < kRoundPixels ? tw : kRoundPixels;
  const int64_t rows = kRoundPixels / piece_w;
  const int64_t rounds = ((tw + piece_w - 1) / piece_w) * ((share + rows - 1) / rows);
  if (lut && rounds > 1 && scratch == nullptr) return int(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(hist65536_tiles_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Count16::kSmemBytes),
      cudaFuncSetAttribute(hist65536_tiles_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Count16::kSmemBytes)};
  if (attr[0] != cudaSuccess) return int(attr[0]);
  if (attr[1] != cudaSuccess) return int(attr[1]);
  const dim3 grid(unsigned(B * gh * gw), kHist16Ranks);  // a cluster of kHist16Ranks a tile
  if (lut)
    hist65536_tiles_kernel<true><<<grid, kHist16Threads, Count16::kSmemBytes, stream>>>(
        x, nullptr, lut, scratch, clip_abs, scale, int(H), int(W), gh, gw, int(th), int(tw));
  else
    hist65536_tiles_kernel<false><<<grid, kHist16Threads, Count16::kSmemBytes, stream>>>(
        x, hist, nullptr, nullptr, 0, 0.0f, int(H), int(W), gh, gw, int(th), int(tw));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Stage A for u8: x's tile histograms into hist ([B*gh*gw, 256] int32,
// written whole); tiles, bands, partial and tickets as for
// launch_hist256_tiles.
int ie_hist256_tiles(const uint8_t* x, int32_t* hist, int64_t B, int64_t H, int64_t W,
                     int32_t gh, int32_t gw, int64_t th, int64_t tw, int64_t band_rows,
                     int64_t bands, int64_t grid_y, uint32_t* partial, int32_t* tickets,
                     cudaStream_t stream) {
  if (hist == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist256_tiles(x, hist, nullptr, 0, 0.0f, partial, tickets, B, H, W, gh, gw, th,
                              tw, band_rows, bands, grid_y, stream);
}

// Stages A and B for u8 in one launch: x's tile LUTs into lut ([B*gh*gw,
// 256] u8), clip_abs and scale of the tile area as for ie_clahe_lut; no
// histogram kept.  The rest as for ie_hist256_tiles.
int ie_tile_luts256(const uint8_t* x, uint8_t* lut, int32_t clip_abs, float scale, int64_t B,
                    int64_t H, int64_t W, int32_t gh, int32_t gw, int64_t th, int64_t tw,
                    int64_t band_rows, int64_t bands, int64_t grid_y, uint32_t* partial,
                    int32_t* tickets, cudaStream_t stream) {
  if (lut == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist256_tiles(x, nullptr, lut, clip_abs, scale, partial, tickets, B, H, W, gh, gw,
                              th, tw, band_rows, bands, grid_y, stream);
}

// x: [B, H, W] u16 contiguous; out: [B*gh*gw, 65536] int32, written
// whole; tiles as for ie_hist256_tiles.
int ie_hist65536_tiles(const uint16_t* x, int32_t* out, int64_t B, int64_t H, int64_t W,
                       int32_t gh, int32_t gw, int64_t th, int64_t tw, cudaStream_t stream) {
  if (out == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist65536_tiles(x, out, nullptr, nullptr, 0, 0.0f, B, H, W, gh, gw, th, tw,
                                stream);
}

// Stages A and B for u16 in one launch: x's tile LUTs into lut ([B*gh*gw,
// 65536] u16, written whole), clip_abs and scale of the tile area as for
// ie_clahe_lut; no histogram kept unless the tiles take more than one
// round (then in scratch, as for launch_hist65536_tiles).  Tiles as for
// ie_hist256_tiles.
int ie_tile_luts65536(const uint16_t* x, uint16_t* lut, int32_t* scratch, int32_t clip_abs,
                      float scale, int64_t B, int64_t H, int64_t W, int32_t gh, int32_t gw,
                      int64_t th, int64_t tw, cudaStream_t stream) {
  if (lut == nullptr) return int(cudaErrorInvalidValue);
  return launch_hist65536_tiles(x, nullptr, lut, scratch, clip_abs, scale, B, H, W, gh, gw, th,
                                tw, stream);
}

// hist: [BT, S] int32 (S = 256 or 65536), each row summing to the tile area;
// lut: [BT, S] u8 (S = 256) or u16 (S = 65536; both 16-byte aligned).
// clip_abs 0 skips the clip.
int ie_clahe_lut(const int32_t* hist, void* lut, int64_t BT, int32_t S, int32_t clip_abs,
                 float scale, cudaStream_t stream) {
  if (BT < 1 || BT > 0x7fffffffLL || clip_abs < 0) return int(cudaErrorInvalidValue);
  if (S == 256) {
    clahe_lut256_kernel<<<unsigned(BT), 256, 0, stream>>>(hist, static_cast<uint8_t*>(lut),
                                                          clip_abs, scale);
  } else if (S == 65536) {
    if ((reinterpret_cast<uintptr_t>(hist) | reinterpret_cast<uintptr_t>(lut)) & 15)
      return int(cudaErrorInvalidValue);
    // one cluster a tile; tiles beyond the grid's 2^31 - 1 blocks stride
    const int64_t clusters = BT < 0x7fffffffLL / kLut16Blocks ? BT : 0x7fffffffLL / kLut16Blocks;
    clahe_lut16_kernel<<<unsigned(clusters * kLut16Blocks), kLut16Threads, 0, stream>>>(
        hist, static_cast<uint16_t*>(lut), BT, clip_abs, scale);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// x, out: [B, H, W] contiguous, u8 (elem_bytes 1, S = 256) or u16
// (elem_bytes 2, S = 65536); luts: [B*gh*gw, S] of the same type (u8:
// 4-byte aligned; u16: 16-byte aligned).  yidx: [2, H] int32 (y0 then y1),
// fy: [H] f32; xidx: [2, W], fx: [W].  u8 only: chunk (a multiple of 16, at
// most 2048) columns and band rows per block, from kernels/clahe.py::
// blend_chunk and blend_band (every chunk within kMaxCells column cells).
// u16 only: pieces [npieces, 3] and rcells [nrcells, 2] int32 from
// kernels/clahe.py::blend16_pieces and blend16_rows, maxbands the most row
// bands of any piece in any row cell.
int ie_clahe_blend(const void* x, const void* luts, void* out, int64_t B, int64_t H, int64_t W,
                   int32_t elem_bytes, int32_t gh, int32_t gw, const int32_t* yidx,
                   const float* fy, const int32_t* xidx, const float* fx,
                   const int32_t* pieces, int32_t npieces, int32_t maxbands,
                   const int32_t* rcells, int32_t nrcells, int32_t chunk, int32_t band,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || gh < 1 || gw < 1 || W > 0x7fffffffLL - kMaxChunk ||
      H > 0x7fffffffLL - kB16Items)
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
    if (pieces == nullptr || rcells == nullptr || npieces < 1 || maxbands < 1 || nrcells < 1 ||
        int64_t(npieces) * maxbands > 0x7fffffffLL || (reinterpret_cast<uintptr_t>(luts) & 15))
      return int(cudaErrorInvalidValue);
    static const cudaError_t attr[2] = {
        cudaFuncSetAttribute(clahe_blend_u16_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kB16SmemBytes),
        cudaFuncSetAttribute(clahe_blend_u16_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kB16SmemBytes)};
    if (attr[0] != cudaSuccess) return int(attr[0]);
    if (attr[1] != cudaSuccess) return int(attr[1]);
    const int64_t items = B * nrcells;
    const dim3 grid(unsigned(int64_t(npieces) * maxbands),
                    unsigned(items < kMaxGridY ? items : kMaxGridY));
    // 8-pixel vectors: rows of whole vectors, 16-byte aligned planes
    const bool vec = W % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (vec)
      clahe_blend_u16_kernel<true><<<grid, kB16Threads, kB16SmemBytes, stream>>>(
          static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(luts),
          static_cast<uint16_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx, pieces,
          maxbands, rcells, nrcells);
    else
      clahe_blend_u16_kernel<false><<<grid, kB16Threads, kB16SmemBytes, stream>>>(
          static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(luts),
          static_cast<uint16_t*>(out), B, int(H), int(W), gh, gw, yidx, fy, xidx, fx, pieces,
          maxbands, rcells, nrcells);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
