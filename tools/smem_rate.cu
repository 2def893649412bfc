// Shared-memory delivery rate: how many cycles an SM spends per warp-wide
// shared load, by the width a lane reads (4, 8 or 16 bytes) and by how
// many distinct addresses the warp's lanes read.
//
// One block per SM (its dynamic shared memory is more than half an SM's),
// `warps` warps a block. Each warp issues `iters` x 16 loads; lane l reads
//   pattern 0 (distinct):  l * W             32 addresses, no bank conflict
//   pattern 1 (rows4):     (l / 8) * 272     4 addresses, 8 lanes each (the
//                                            K2 spike tile: rows 68 floats
//                                            apart)
//   pattern 2 (cols8):     (l % 8) * W       8 addresses, 4 lanes each (the
//                                            K2 weight tile)
//   pattern 3 (uniform):   0                 one address a warp
//   patterns 4-9:          (l % 4) * W, (l / 4) * W, (l / 8) * W,
//                          (l / 2) * W, (l % 2) * W, (l % 4) * 272,
//                          ((l >> 1) & 7) * W,
//                          ((l & 1) | ((l >> 4) << 1)) * 272
// plus j * 1024 bytes for the j-th load of an iteration. Thread 0 reads the
// SM clock before and after (between barriers) into cycles[blockIdx.x].
// The loads are volatile, so the assembler keeps every one of them.
#include <cuda_runtime.h>

namespace {

template <int W> struct Load;
template <> struct Load<4> {
  unsigned r[1];
  __device__ __forceinline__ void at(unsigned a) {
    asm volatile("ld.volatile.shared.b32 %0, [%1];" : "=r"(r[0]) : "r"(a));
  }
};
template <> struct Load<8> {
  unsigned r[2];
  __device__ __forceinline__ void at(unsigned a) {
    asm volatile("ld.volatile.shared.v2.b32 {%0, %1}, [%2];"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
  }
};
template <> struct Load<16> {
  unsigned r[4];
  __device__ __forceinline__ void at(unsigned a) {
    asm volatile("ld.volatile.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
};

template <int W>
__global__ void __launch_bounds__(512) smem_rate(unsigned* sink, long long* cycles, int iters,
                          int pattern) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = threadIdx.x; i < 32768; i += blockDim.x) smem[i] = i * 7;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  int off = pattern == 0 ? lane * W
          : pattern == 1 ? (lane / 8) * 272
          : pattern == 2 ? (lane % 8) * W
          : pattern == 3 ? 0
          : pattern == 4 ? (lane % 4) * W
          : pattern == 5 ? (lane / 4) * W
          : pattern == 6 ? (lane / 8) * W
          : pattern == 7 ? (lane / 2) * W
          : pattern == 8 ? (lane % 2) * W
          : pattern == 9 ? (lane % 4) * 272
          : pattern == 10 ? ((lane >> 1) & 7) * W
          : ((lane & 1) | ((lane >> 4) << 1)) * 272;
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem) + off;
  Load<W> v[16];
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j].at(base + j * 1024);
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < W / 4; ++e) acc ^= v[j].r[e];
  if (acc == 0x12345678u) sink[threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

// Spin for `cycles` SM clock cycles: its event time gives the clock.
__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

}  // namespace

extern "C" int spin_run(long long cycles, int blocks, void* stream) {
  spin<<<blocks, 32, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}

// Launch on `blocks` blocks of `warps` warps; returns the CUDA error code.
extern "C" int smem_rate_run(int width, int pattern, int blocks, int warps,
                             int iters, void* sink, void* cycles,
                             void* stream) {
  constexpr int SMEM = 160 * 1024;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define RUN(W)                                                          \
  e = cudaFuncSetAttribute(smem_rate<W>,                                \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                           SMEM);                                       \
  if (e != cudaSuccess) return (int)e;                                  \
  smem_rate<W><<<blocks, warps * 32, SMEM, s>>>(                        \
      (unsigned*)sink, (long long*)cycles, iters, pattern);
  if (width == 4) { RUN(4) }
  else if (width == 8) { RUN(8) }
  else if (width == 16) { RUN(16) }
  else return (int)cudaErrorInvalidValue;
#undef RUN
  return (int)cudaGetLastError();
}
