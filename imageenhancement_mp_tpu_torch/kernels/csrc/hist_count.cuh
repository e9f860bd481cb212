// Exact 256-bin counting of u8 pixels by one block of kCountThreads threads,
// shared by hist.cu (hist256) and clahe.cu (hist256_tiles).  Both kernels
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

}  // namespace
