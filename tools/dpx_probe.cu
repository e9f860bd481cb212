// Throughput of the integer min/max forms the median schedules could use, on
// one sm_90a card: int32 min/max, the 16x2 SIMD forms (__vminu2, __vmins2 and
// their PTX min/max.u16x2 / .s16x2), the 8x4 form (__vminu4) and the
// three-way DPX forms (__vimin3_u16x2, __vimin3_s16x2, __vimin3_s32).  Each
// kernel runs odd-even transposition passes over 8 registers per thread on
// 8 blocks of 256 threads per SM and reports calls per second.
//
//   bash tools/dpx_probe.sh
//
// tools/dpx_probe.sh also prints the SASS opcode histogram of each kernel,
// which shows whether a call is one instruction (VIMNMX, VIMNMX3) or an
// emulation sequence.  The three-way kernels XOR a constant into their third
// operand, so each of their calls costs one LOP3 besides the VIMNMX3.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

struct OpS32 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return (uint32_t)min((int)a, (int)b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return (uint32_t)max((int)a, (int)b); }
};
struct OpU2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxu2(a, b); }
};
struct OpS2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
};
struct OpU4 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vminu4(a, b); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxu4(a, b); }
};
struct OpPtxU2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) {
    uint32_t r; asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) {
    uint32_t r; asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
};
struct OpPtxS2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) {
    uint32_t r; asm("min.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) {
    uint32_t r; asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); return r; }
};

struct OpMin3U2 {  // three-way forms: one call = min of three
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vimin3_u16x2(a, b, a ^ 0x10001u); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vimax3_u16x2(a, b, b ^ 0x10001u); }
};
struct OpMin3S2 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vimin3_s16x2(a, b, a ^ 0x10001u); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vimax3_s16x2(a, b, b ^ 0x10001u); }
};
struct OpMin3S32 {
  static __device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return (uint32_t)__vimin3_s32((int)a, (int)b, (int)(a ^ 1u)); }
  static __device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return (uint32_t)__vimax3_s32((int)a, (int)b, (int)(b ^ 1u)); }
};

// odd-even transposition passes over 8 registers, 4 and 3 compare-exchanges in turn
template <class Op>
__global__ void probe(uint32_t* out, int iters) {
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = (threadIdx.x * 2654435761u) ^ (i * 0x9e3779b9u) ^ blockIdx.x;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
#pragma unroll
      for (int i = (p & 1); i + 1 < 8; i += 2) {
        const uint32_t lo = Op::mn(r[i], r[i + 1]);
        r[i + 1] = Op::mx(r[i], r[i + 1]);
        r[i] = lo;
      }
    }
    r[0] ^= it;  // keep iterations distinct
  }
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc ^= r[i] * (i + 1);
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <class Op>
void run(const char* name, uint32_t* d, int blocks, int threads, int iters) {
  probe<Op><<<blocks, threads>>>(d, 4);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(a);
    probe<Op><<<blocks, threads>>>(d, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    if (ms < best) best = ms;
  }
  // per iteration: 16 passes; even passes 4 cex, odd passes 3 cex; 2 calls per cex
  const double calls = double(blocks) * threads * iters * (8 * 4 + 8 * 3) * 2.0;
  printf("%-10s %8.3f ms  %8.3f T calls/s  err=%s\n", name, best, calls / (best * 1e-3) / 1e12,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("SMs %d  clock attr %d kHz\n", sms, clk);
  const int threads = 256, blocks = sms * 8, iters = 2000;
  uint32_t* d; cudaMalloc(&d, sizeof(uint32_t) * blocks * threads);
  run<OpS32>("s32", d, blocks, threads, iters);
  run<OpU2>("vminu2", d, blocks, threads, iters);
  run<OpS2>("vmins2", d, blocks, threads, iters);
  run<OpU4>("vminu4", d, blocks, threads, iters);
  run<OpPtxU2>("ptx.u16x2", d, blocks, threads, iters);
  run<OpPtxS2>("ptx.s16x2", d, blocks, threads, iters);
  run<OpMin3U2>("min3u16x2", d, blocks, threads, iters);
  run<OpMin3S2>("min3s16x2", d, blocks, threads, iters);
  run<OpMin3S32>("min3s32", d, blocks, threads, iters);
  run<OpS32>("s32", d, blocks, threads, iters);
  cudaFree(d);
  return 0;
}
