// K2: fused synapse + LIF scan for the fully connected layers.
//
// Replaces fc_lif_scan_pallas (repro/kernels/fc_lif_scan.py):
//
//   I[t] = S_in[t] @ W            S_in (T, B, K), W (K, N)
//   V[t] = alpha * V[t-1] * (V[t-1] < v_th) + I[t]
//   S[t] = V[t] >= v_th
//
// The currents never reach device memory: a block computes them for a
// (T chunk x batch group x 32 outputs) tile into shared memory, then one
// warp runs the LIF update over the chunk with the membrane in registers.
//
// Numerics are part of the function. Each current is an fp32 sum over k in
// ascending order, each product and add rounded on its own (no TF32, no
// FMA: __fmul_rn/__fadd_rn and -fmad=false). fc1's input is an average pool
// of spikes, so products round; the fixed order is what makes the kernel
// equal its plain version bit for bit and a stream's rows independent of
// the batch it rides in.
//
// Bound on the H100: at fc1 (B=8, T=16, K=2048, N=512) the 268 MFLOP of
// the sums on the fp32 CUDA cores. The sequential k order forbids splitting
// K, so parallelism comes from the (t, b, n) outputs: threads in a warp own
// 32 neighbouring n (W loads coalesce, S_in loads broadcast), the warps of a
// block own the T steps of a chunk, and each thread sums BG batch rows so a
// W value is loaded once for BG products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 32;  // outputs per block (one warp wide)
constexpr int TT = 16;  // time steps per chunk (warps per block)
constexpr int BG = 4;   // batch rows per thread

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
__global__ void __launch_bounds__(NT * TT)
fc_lif_scan_kernel(const T* __restrict__ spk, const float* __restrict__ w,
                   const float* __restrict__ v0, T* __restrict__ out,
                   T* __restrict__ vfin, int steps, int b, int k, int n,
                   float alpha, float v_th) {
  __shared__ float cur_s[TT][BG][NT];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * NT + tx;
  const int b0 = blockIdx.y * BG;
  const bool col_ok = col < n;

  float v[BG];
#pragma unroll
  for (int j = 0; j < BG; ++j) {
    const int row = b0 + j;
    v[j] = (v0 != nullptr && col_ok && row < b)
               ? v0[(long long)row * n + col] : 0.0f;
  }

  for (int t0 = 0; t0 < steps; t0 += TT) {
    const int t = t0 + ty;
    float acc[BG];
#pragma unroll
    for (int j = 0; j < BG; ++j) acc[j] = 0.0f;
    if (t < steps && col_ok) {
      const T* s_t = spk + ((long long)t * b + b0) * k;
      for (int kk = 0; kk < k; ++kk) {
        const float wv = w[(long long)kk * n + col];
#pragma unroll
        for (int j = 0; j < BG; ++j) {
          if (b0 + j < b) {
            const float s = to_f32(s_t[(long long)j * k + kk]);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(s, wv));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BG; ++j) cur_s[ty][j][tx] = acc[j];
    __syncthreads();
    if (ty == 0 && col_ok) {
      for (int tt = 0; tt < TT && t0 + tt < steps; ++tt) {
#pragma unroll
        for (int j = 0; j < BG; ++j) {
          const int row = b0 + j;
          if (row < b) {
            const float live = v[j] < v_th ? 1.0f : 0.0f;
            v[j] = __fadd_rn(__fmul_rn(__fmul_rn(alpha, v[j]), live),
                             cur_s[tt][j][tx]);
            out[((long long)(t0 + tt) * b + row) * n + col] =
                from_f32<T>(v[j] >= v_th ? 1.0f : 0.0f);
          }
        }
      }
    }
    __syncthreads();
  }

  if (ty == 0 && col_ok) {
#pragma unroll
    for (int j = 0; j < BG; ++j) {
      const int row = b0 + j;
      if (row < b) vfin[(long long)row * n + col] = from_f32<T>(v[j]);
    }
  }
}

template <typename T>
int launch(const void* spk, const void* w, const void* v0, void* out,
           void* vfin, int steps, int b, int k, int n, float alpha,
           float v_th, void* stream) {
  if (b > 0 && n > 0) {
    const dim3 block(NT, TT);
    const dim3 grid((n + NT - 1) / NT, (b + BG - 1) / BG);
    fc_lif_scan_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)spk, (const float*)w, (const float*)v0, (T*)out, (T*)vfin,
        steps, b, k, n, alpha, v_th);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fc_lif_scan_f32(const void* spk, const void* w, const void* v0,
                               void* out, void* vfin, int steps, int b, int k,
                               int n, float alpha, float v_th, void* stream) {
  return launch<float>(spk, w, v0, out, vfin, steps, b, k, n, alpha, v_th,
                       stream);
}

extern "C" int fc_lif_scan_bf16(const void* spk, const void* w,
                                const void* v0, void* out, void* vfin,
                                int steps, int b, int k, int n, float alpha,
                                float v_th, void* stream) {
  return launch<__nv_bfloat16>(spk, w, v0, out, vfin, steps, b, k, n, alpha,
                               v_th, stream);
}
