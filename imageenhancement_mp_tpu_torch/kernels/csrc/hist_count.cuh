// Exact 256-bin counting of u8 pixels by one block of kCountThreads threads,
// shared by hist.cu (hist256) and clahe.cu (hist256_tiles), and what both
// do after a block's last add: the handoff of a group's bins to the block
// that finishes the group last, and the two 256-entry LUT laws that block
// may run on the group's totals (below HistCounter).  Both kernels
// feed it 16-pixel vectors through count_vectors, in groups of N loads, the
// next group loaded before the last is counted, and the odd bytes of a row
// or plane (head, tail, pad) one at a time through add_one.
//
// HistCounter keeps 32 copies of the 256 bins, one per lane index, with
// lane l's copy of bin v at word 32 v + l: each lane of a warp adds into its
// own bank whatever the data, so a warp's shared atomic costs the same on
// random, smooth and constant planes (per-warp bins cost more on random
// data, where lanes of different values meet in one bank).  The eight warps
// of a block share each copy through the atomics.  A vector of 16 equal
// bytes, as a flat region gives, is counted with one atomic.
// Chosen by A/B on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/torch_hist_profile.py --ab, PERF.md §6) over per-warp bins,
// per-thread 8-bit counters flushed every 15 vectors (no atomics and no bank
// conflicts, but a load-add-store chain), those counters with atomic adds,
// and __match_any_sync before the atomic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCountThreads = 256;

struct HistCounter {
  static constexpr int kSmemBytes = 256 * 32 * 4;
  uint32_t* bins;
  uint32_t* mine;  // this lane's copy: bin v at mine[32 v]

  // Zero the counters; the caller synchronises before the first add.
  __device__ __forceinline__ void begin(uint32_t* smem) {
    bins = smem;
    mine = smem + (threadIdx.x & 31);
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += kCountThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void add_one(uint32_t v) { atomicAdd(&mine[v << 5], 1u); }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    const uint32_t b = v.x & 255u;
    if (v.x == b * 0x01010101u && v.y == v.x && v.z == v.x && v.w == v.x) {
      atomicAdd(&mine[b << 5], 16u);
      return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) add_one((w[i / 4] >> (8 * (i % 4))) & 255u);
  }
  // The count of bin threadIdx.x; after a barrier that follows the last add.
  // Its 32 copies are read along a diagonal, so a warp's reads hit 32 banks.
  __device__ __forceinline__ uint32_t bin_total() const {
    const int t = threadIdx.x;
    uint32_t s = 0;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) s += bins[t * 32 + ((l + t) & 31)];
    return s;
  }
};

// N vectors of one thread, each with whether it is one.
template <int N>
struct VecGroup {
  uint4 v[N];
  bool ok[N];
};

// The loop both kernels run (and clahe.cu's hist65536_tiles, with its own
// counter): `load(group)` fills the next group of this thread's vectors (ok false past its last, and in every group after it);
// each group is loaded before the previous one is counted.
template <int N, typename Counter, typename Load>
__device__ __forceinline__ void count_vectors(Counter& c, Load load) {
  VecGroup<N> cur;
  load(cur);
  while (cur.ok[0]) {
    VecGroup<N> next;
    load(next);
#pragma unroll
    for (int u = 0; u < N; ++u) c.add_vec(cur.v[u], cur.ok[u]);
    cur = next;
  }
}

// ---------------------------------------------------------------------------
// Scans over the 256 threads of a block, one value a thread.  Each ends
// with a barrier, so its shared words can be used again at once.
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

// ---------------------------------------------------------------------------
// The two 256-entry LUT laws, each run by a block of 256 threads with bin
// threadIdx.x's count h in each thread; each returns entry threadIdx.x.
// The standalone kernels (hist.cu::equalize_lut256_kernel, clahe.cu::
// clahe_lut256_kernel) and the count kernels' epilogues call these, so each
// rounding is written once.
// ---------------------------------------------------------------------------

// cv2's equalizeHist LUT (the JAX package's ops/histogram.py::equalize_lut,
// :92-111) of a histogram of `total` pixels: a shuffle scan gives the cdf;
// the first nonzero bin i0 is the number of bins whose cdf is still 0; then
//   lut = clamp(rint(f32(cdf - h0) * f32(255 / f32(max(total - h0, 1)))), 0, 255)
// with h0 = h[i0], and the identity when h0 == total (a constant plane; also
// an empty one).
__device__ __forceinline__ uint8_t equalize_lut_entry(int32_t h, int32_t total) {
  __shared__ int32_t warp_sums[8];
  __shared__ int32_t s_h0;
  const int t = threadIdx.x;
  __syncthreads();  // an earlier call's reads of s_h0 are done
  const int32_t cdf = block_exclusive_scan<8>(h, warp_sums) + h;
  if (t == 0) s_h0 = 0;  // stays 0 for an all-zero histogram
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
  return uint8_t(v);
}

// CLAHE's stage B at S = 256 (the JAX package's ops/clahe.py::
// clahe_tile_luts, :74-97): clip at clip_abs, sum the excess, raise every
// bin by excess / 256, add 1 at bins i with i % step == 0 && i / step <
// excess % 256 (step = max(256 / resid, 1)), scan,
//   lut = clamp(rint(f32(cdf) * scale), 0, 255)
// with clip_abs and scale = f32(255) / f32(area) from the host
// (kernels/clahe.py::clip_and_scale); clip_abs 0 skips the clip.
__device__ __forceinline__ uint8_t clahe_lut256_entry(int32_t h, int32_t clip_abs, float scale) {
  __shared__ int32_t warp_sums[8];
  const int i = threadIdx.x;
  int32_t v = h;
  if (clip_abs > 0) {
    const int32_t excess = block_sum<8>(max(h - clip_abs, 0), warp_sums);
    const int32_t raise = excess / 256, resid = excess % 256;
    const int32_t step = max(256 / max(resid, 1), 1);
    v = min(h, clip_abs) + raise + ((i % step == 0 && i / step < resid) ? 1 : 0);
  }
  const int32_t cdf = block_exclusive_scan<8>(v, warp_sums) + v;
  const float r = rintf(__fmul_rn(__int2float_rn(cdf), scale));
  return uint8_t(__float2int_rn(fminf(fmaxf(r, 0.0f), 255.0f)));
}

// ---------------------------------------------------------------------------
// The handoff of a group's bins (hist256: the blocks of one plane;
// hist256_tiles: the band blocks of one tile) to the block that finishes
// the group last, with no zeroed output and no second launch.
//
// Each member stores its 256 partial bins whole into its row of the
// group's scratch (from the caching allocator: no fill), then takes a
// ticket from the group's counter.  Release: every thread fences its own
// store before the barrier after which thread 0 takes the ticket (the
// threadFenceReduction pattern), so the rows are visible device-wide before
// the ticket is.  The member that draws the group's last ticket resets the
// counter to 0 (no other member of this launch touches it again, and the
// next launch on the stream starts after this one ends), fences (acquire),
// and its threads sum the group's rows through L2 with __ldcg, never the
// incoherent L1: thread t loads 16-byte vectors of bins 4 (t % 64) .. +3
// from rows t / 64, t / 64 + 4, ..., kTailLoads at a time, and four such
// partial sums of each bin meet in shared memory.  The tail is the last
// block's alone, so its loads are issued together: one L2 round trip per
// 4 kTailLoads rows.  A group of one member needs neither scratch nor
// ticket.
// The counters live in a per-(device, stream) buffer that starts at 0
// (kernels/__init__.py::stream_tickets), so two streams never share one.
// ---------------------------------------------------------------------------

constexpr int kTailLoads = 8;  // 16-byte loads a thread has in flight in the tail

// `bin` is this thread's partial count of bin threadIdx.x; `rows` the
// group's members x 256 scratch words (16-byte aligned).  True (in every
// thread) in the block that arrives last, with `bin` then the group's
// total.
__device__ __forceinline__ bool last_of_group(uint32_t& bin, uint32_t* __restrict__ rows,
                                              int member, int members, int32_t* ticket) {
  __shared__ int s_last;
  __shared__ uint4 tail[4][64];
  if (members == 1) return true;
  const int t = threadIdx.x;
  rows[int64_t(member) * 256 + t] = bin;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const bool last = atomicAdd(ticket, 1) == members - 1;
    if (last) {
      atomicExch(ticket, 0);
      __threadfence();
    }
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return false;
  // tail: begin
  const uint4* rv = reinterpret_cast<const uint4*>(rows);
  const int q = t & 63, r0 = t >> 6;
  uint4 a = make_uint4(0, 0, 0, 0);
  for (int k0 = r0; k0 < members; k0 += 4 * kTailLoads) {
    uint4 v[kTailLoads];
#pragma unroll
    for (int u = 0; u < kTailLoads; ++u) {
      const int k = k0 + 4 * u;
      v[u] = k < members ? __ldcg(rv + int64_t(k) * 64 + q) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kTailLoads; ++u) a.x += v[u].x, a.y += v[u].y, a.z += v[u].z, a.w += v[u].w;
  }
  tail[r0][q] = a;  // words r0 * 256 + 4 q .. + 3: bins 4 q .. + 3
  __syncthreads();
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tail);
  bin = w[t] + w[256 + t] + w[512 + t] + w[768 + t];
  // tail: end
  return true;
}

}  // namespace
