// K3: packed-ternary matmul, out = (x @ unpack2bit(w_packed)) * scale.
//
// Replaces ternary_matmul_pallas (repro/kernels/ternary_matmul.py), which
// streams 2-bit packed weight tiles from HBM into VMEM, unpacks them there
// and feeds the MXU with an f32 accumulator in scratch across a sequential
// K grid axis. On Hopper the blocks of a grid run in no order, so no sum
// is carried between blocks: each thread owns one output column n for a
// block of ROWS rows of x and walks the whole K range itself, in ascending
// k, with one f32 accumulator per row in registers.
//
// Layout (as in the TPU kernel):
//   x        (M, K)    f32 or bf16, row-major
//   w_packed (K/4, N)  uint8; byte (j, n) holds k = 4j..4j+3 in bits
//                      [2i, 2i+2) as value + 1
//   scale    (N,)      f32, applied once after the sum
//   out      (M, N)    x's dtype
//
// Each K chunk of x (ROWS x KC, converted to f32, stored k-major so one
// 16-byte shared load gives the ROWS values of one k) and of w_packed
// (KC/4 x BN bytes) is staged in shared memory by all threads with
// independent, coalesced loads, so the k loop itself touches no global
// memory. Ragged M, N and K edges are masked.
//
// Arithmetic: acc = acc + x[m,k] * (field - 1), each multiply and add
// rounded on its own (__fmul_rn/__fadd_rn, and the library is built with
// -fmad=false), then one __fmul_rn by scale[n]. The product is exact (the
// factor is -1, 0 or +1), so this is "add +x, add -x, or add nothing" in
// ascending k, which the plain version repeats operation for operation.
//
// Bound: at the frame wing's fc1 (M = 8 slots, K = 2048, N = 512) the
// work is 16.8 MFLOP over 0.35 MB, so the card's bound is well under a
// microsecond; this first kernel is bound by latency and launch instead:
// only (N/32) x (M/4) = 32 one-warp blocks, each running 2048 dependent
// adds per accumulator. The fixed ascending order rules out splitting K.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;     // output columns per block (one warp)
constexpr int ROWS = 4;    // rows of x per block, one accumulator each
constexpr int KC = 512;    // k values per shared-memory chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(BN)
ternary_matmul_kernel(const T* __restrict__ x,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int m, int k, int n) {
  __shared__ __align__(16) float xs[KC * ROWS];   // [k][row]
  __shared__ uint8_t ws[(KC / 4) * BN];           // [byte row][column]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int col = n0 + tid;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    const int kc = min(KC, k - k0);          // a multiple of 4
    const int jc = kc / 4;
    for (int e = tid; e < ROWS * kc; e += BN) {
      const int r = e / kc, kk = e - r * kc;
      const int row = m0 + r;
      xs[kk * ROWS + r] =
          row < m ? to_f32(x[(long long)row * k + k0 + kk]) : 0.0f;
    }
    for (int e = tid; e < jc * BN; e += BN) {
      const int jj = e / BN, c = e - jj * BN;
      ws[e] = n0 + c < n ? w[(long long)(k0 / 4 + jj) * n + n0 + c]
                         : (uint8_t)0x55;
    }
    __syncthreads();
    for (int jj = 0; jj < jc; ++jj) {
      const unsigned byte = ws[jj * BN + tid];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float q = (float)((byte >> (2 * i)) & 0x3u) - 1.0f;
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[(4 * jj + i) * ROWS]);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(xv.x, q));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(xv.y, q));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(xv.z, q));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(xv.w, q));
      }
    }
    __syncthreads();
  }

  if (col < n) {
    const float s = scale[col];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = m0 + r;
      if (row < m)
        out[(long long)row * n + col] = from_f32<T>(__fmul_rn(acc[r], s));
    }
  }
}

static_assert(ROWS == 4, "the k loop reads one float4 of rows per k");

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* out,
           int m, int k, int n, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + BN - 1) / BN, (m + ROWS - 1) / ROWS);
    ternary_matmul_kernel<T><<<grid, BN, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)w, (const float*)scale, (T*)out, m, k,
        n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ternary_matmul_f32(const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, void* stream) {
  return launch<float>(x, w, scale, out, m, k, n, stream);
}

extern "C" int ternary_matmul_bf16(const void* x, const void* w,
                                   const void* scale, void* out, int m,
                                   int k, int n, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, out, m, k, n, stream);
}
