// K1: reset-to-zero LIF scan over (T, N) currents, one thread per neuron.
//
// Replaces lif_scan_pallas (repro/kernels/lif_scan.py). The Pallas kernel
// tiles neurons into 128-lane rows and walks T in sequential grid chunks so
// the membrane stays in VMEM; on Hopper the membrane simply lives in a
// register of the thread that owns the neuron for all T steps, so no T-chunk
// grid and no padding tail are needed.
//
// Bound: device memory. Each step reads one current and writes one spike per
// neuron (about 2*T*N*esize bytes), with two flops per element. Threads of a
// warp own neighbouring neurons, so every load and store is coalesced.
//
//   V[t] = alpha * V[t-1] * (V[t-1] < v_th) + I[t]
//   S[t] = V[t] >= v_th
//
// Every multiply and add is rounded on its own (__fmul_rn/__fadd_rn, and the
// library is built with -fmad=false): a fused multiply-add would change
// membrane bits against the plain version and the JAX reference.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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
__global__ void lif_scan_kernel(const T* __restrict__ cur,
                                const float* __restrict__ v0,
                                T* __restrict__ spk, T* __restrict__ vfin,
                                long long n, int steps, float alpha,
                                float v_th) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = v0 != nullptr ? v0[i] : 0.0f;
  for (int t = 0; t < steps; ++t) {
    const long long off = (long long)t * n + i;
    const float live = v < v_th ? 1.0f : 0.0f;
    v = __fadd_rn(__fmul_rn(__fmul_rn(alpha, v), live), to_f32(cur[off]));
    spk[off] = from_f32<T>(v >= v_th ? 1.0f : 0.0f);
  }
  vfin[i] = from_f32<T>(v);
}

template <typename T>
int launch(const void* cur, const void* v0, void* spk, void* vfin,
           long long n, int steps, float alpha, float v_th, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    lif_scan_kernel<T><<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const T*)cur, (const float*)v0, (T*)spk, (T*)vfin, n, steps, alpha,
        v_th);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lif_scan_f32(const void* cur, const void* v0, void* spk,
                            void* vfin, long long n, int steps, float alpha,
                            float v_th, void* stream) {
  return launch<float>(cur, v0, spk, vfin, n, steps, alpha, v_th, stream);
}

extern "C" int lif_scan_bf16(const void* cur, const void* v0, void* spk,
                             void* vfin, long long n, int steps, float alpha,
                             float v_th, void* stream) {
  return launch<__nv_bfloat16>(cur, v0, spk, vfin, n, steps, alpha, v_th,
                               stream);
}
