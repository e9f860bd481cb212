// take_table: a per-element table lookup, out[b, p] = table[b][clamp(idx[b, p], 0, L - 1)],
// with one table shared by all planes or one table per plane; int32 or int64
// entries, int32 indices.  The lookups of the colour conversions (the u8
// Lab and Luv tables) and of the non-local-means weight LUT.
//
// Replaces two Pallas kernels of the JAX package's kernels/hist.py:
// take_table_pallas (_take_kernel, pallas_call at :415) and the
// dynamic-gather probe _probe_dg (pallas_call at :87), which is the
// per-plane case with B = 8 and L = 128.  The TPU kernel cuts the table
// into 128-lane vregs and selects among up to 32 take_along_axis results
// per lookup, so it serves tables of at most 4096 entries and XLA takes the
// rest.  On Hopper a lookup is one load, so one kernel serves every table
// length.
//
// What bounds it on this card: bytes.  Per lookup it reads a 4 B index and
// writes a 4 or 8 B entry; the table is read once per block.  Design: each
// block works on one plane at a time (planes stride over a gridDim.y capped
// at 65535) and on spans of kChunk indices of it (spans stride over
// gridDim.x), each thread keeping kUnroll coalesced index loads in flight.
// A table of at most kSmemTableBytes is copied into dynamic shared memory
// once per block and plane (once per block when shared); a longer one is read
// through L1/L2 with read-only loads.  kSmemTableBytes = 64 KB: 16384 int32
// or 8192 int64 entries, which holds every table of the colour and
// non-local-means paths except Lab's 36864-entry inverse cube table and
// Luv's 35937-entry grid columns, and leaves room for three blocks on an SM.
// Above 48 KB the kernel opts in with cudaFuncSetAttribute.  Indices are
// clamped into [0, L), so no read leaves the table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kChunk = int64_t(kThreads) * kUnroll;
constexpr int64_t kSmemTableBytes = 64 * 1024;
constexpr int64_t kTargetBlocks = 1024;  // spans of one plane stride beyond it
constexpr int64_t kMaxGridY = 65535;     // planes beyond it stride

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads)
take_table_kernel(const int32_t* __restrict__ idx, const T* __restrict__ table,
                  T* __restrict__ out, int64_t B, int64_t n, int L, int per_plane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stab = reinterpret_cast<T*>(smem_raw);
  bool loaded = false;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* tab = table + (per_plane ? b * L : 0);
    if (kSmem && (per_plane || !loaded)) {
      __syncthreads();  // every thread is done with the previous plane's table
      for (int j = threadIdx.x; j < L; j += kThreads) stab[j] = tab[j];
      __syncthreads();
      loaded = true;
    }
    const int32_t* ib = idx + b * n;
    T* ob = out + b * n;
    for (int64_t base = int64_t(blockIdx.x) * kChunk; base < n;
         base += int64_t(gridDim.x) * kChunk) {
      int32_t v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t p = base + k * kThreads + threadIdx.x;
        v[k] = p < n ? __ldg(ib + p) : 0;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t p = base + k * kThreads + threadIdx.x;
        if (p < n) {
          const int i = min(max(v[k], 0), L - 1);
          ob[p] = kSmem ? stab[i] : __ldg(tab + i);
        }
      }
    }
  }
}

template <typename T>
int launch(const int32_t* idx, const T* table, T* out, int64_t B, int64_t n, int64_t L,
           int per_plane, cudaStream_t stream) {
  const int64_t spans = (n + kChunk - 1) / kChunk;
  const int64_t gy = B < kMaxGridY ? B : kMaxGridY;
  const int64_t per = kTargetBlocks / gy > 1 ? kTargetBlocks / gy : 1;
  const dim3 grid(unsigned(spans < per ? spans : per), unsigned(gy));
  const int64_t bytes = L * int64_t(sizeof(T));
  if (bytes <= kSmemTableBytes) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          take_table_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(kSmemTableBytes));
      if (e != cudaSuccess) return int(e);
    }
    take_table_kernel<T, true><<<grid, kThreads, size_t(bytes), stream>>>(
        idx, table, out, B, n, int(L), per_plane);
  } else {
    take_table_kernel<T, false><<<grid, kThreads, 0, stream>>>(idx, table, out, B, n, int(L),
                                                                per_plane);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx: [B, n] int32 contiguous; table: [L] (per_plane 0) or [B, L]
// (per_plane 1) contiguous, entries of elem_bytes 4 (int32) or 8 (int64);
// out: [B, n] of the table's type, contiguous.
int ie_take_table(const int32_t* idx, const void* table, void* out, int64_t B, int64_t n,
                  int64_t L, int32_t per_plane, int32_t elem_bytes, cudaStream_t stream) {
  if (B < 1 || n < 1 || L < 1 || L > 0x7fffffffLL || (per_plane != 0 && per_plane != 1))
    return int(cudaErrorInvalidValue);
  if (elem_bytes == 4)
    return launch(idx, static_cast<const int32_t*>(table), static_cast<int32_t*>(out), B, n, L,
                  per_plane, stream);
  if (elem_bytes == 8)
    return launch(idx, static_cast<const long long*>(table), static_cast<long long*>(out), B, n,
                  L, per_plane, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
