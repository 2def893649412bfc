// K1: reset-to-zero LIF scan over (T, N) currents, one thread per neuron.
//
// Replaces lif_scan_pallas (repro/kernels/lif_scan.py). The Pallas kernel
// tiles neurons into 128-lane rows and walks T in sequential grid chunks so
// the membrane stays in VMEM; on Hopper the membrane lives in a register of
// the thread that owns the neuron for all T steps, so no T-chunk grid and no
// padding tail are needed.
//
//   V[t] = alpha * V[t-1] * (V[t-1] < v_th) + I[t]
//   S[t] = V[t] >= v_th
//
// Bound: device memory. Each step reads one current and writes one spike per
// neuron (about 2*T*N*esize bytes), with three operations per element.
// Threads of a warp own neighbouring neurons, so every load and store
// coalesces. The currents do not depend on the recurrence, so a thread
// issues all loads of a time chunk of TC steps (ld.global.nc) before it runs
// the chunk's recurrence: one memory round trip a chunk, whatever the
// compiler makes of the loop. The last T % TC steps go in chunks of TAIL,
// then one at a time.
// Stores keep the default L2 policy: the 2x2 pool reads the spikes next.
//
// tools/k1_probe.py chose the geometry on the H100: chunks of 4, 8 and 16
// steps and blocks of 128 and 256 threads take the event wing's step within
// about a microsecond of each other. The kept 16 steps (all of a window) and
// 256 threads tie with the parent's runtime loop from a cold L2 and are
// ~0.25 us a step faster from a warm one. Under the probe's timing a call is
// an empty call's fixed cost plus its bytes.
//
// Every multiply and add is rounded on its own (__fmul_rn/__fadd_rn, and the
// library is built with -fmad=false): a fused multiply-add would change
// membrane bits against the plain version and the JAX reference. The order is
// (alpha*v)*live, then + cur.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

// The kernel's geometry (tools/k1_probe.py builds copies with these lines
// replaced; kernels/lif_scan.py checks them through lif_scan_geometry).
constexpr int TC = 16;        // steps a chunk: its loads precede its updates
constexpr int TAIL = 4;       // steps a chunk of the last T % TC
constexpr int THREADS = 256;  // threads a block

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

// One step of one neuron: the update, then its spike at s.
template <typename T>
__device__ __forceinline__ void step(float& v, T in, T* s, float alpha,
                                     float v_th) {
  const float live = v < v_th ? 1.0f : 0.0f;
  v = __fadd_rn(__fmul_rn(__fmul_rn(alpha, v), live), to_f32(in));
  *s = from_f32<T>(v >= v_th ? 1.0f : 0.0f);
}

// K steps of one neuron from c and s, rows n apart: all K loads go out
// before the first update. Moves c and s past the K steps.
template <int K, typename T>
__device__ __forceinline__ void chunk(float& v, const T*& c, T*& s,
                                      long long n, float alpha, float v_th) {
  T in[K];
#pragma unroll
  for (int j = 0; j < K; ++j) in[j] = __ldg(c + j * n);
#pragma unroll
  for (int j = 0; j < K; ++j) step(v, in[j], s + j * n, alpha, v_th);
  c += K * n;
  s += K * n;
}

template <typename T, bool HAS_V0>
__global__ void __launch_bounds__(THREADS)
    lif_scan_kernel(const T* __restrict__ cur, const float* __restrict__ v0,
                    T* __restrict__ spk, T* __restrict__ vfin, long long n,
                    int steps, float alpha, float v_th) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float v = HAS_V0 ? __ldg(v0 + i) : 0.0f;
  const T* c = cur + i;
  T* s = spk + i;
  // Chunks of TC steps, then of TAIL, then single steps. The loops are not
  // unrolled: a larger kernel is slower to start from a cold L2, and
  // guarding a whole chunk's loads step by step costs more instructions
  // than the round trips it saves (tools/k1_probe.py's A/B rounds).
  int t = 0;
#pragma unroll 1
  for (; t + TC <= steps; t += TC) chunk<TC>(v, c, s, n, alpha, v_th);
#pragma unroll 1
  for (; t + TAIL <= steps; t += TAIL) chunk<TAIL>(v, c, s, n, alpha, v_th);
#pragma unroll 1
  for (; t < steps; ++t) chunk<1>(v, c, s, n, alpha, v_th);
  vfin[i] = from_f32<T>(v);
}

template <typename T>
int launch(const void* cur, const void* v0, void* spk, void* vfin,
           long long n, int steps, float alpha, float v_th, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    if (v0 != nullptr)
      lif_scan_kernel<T, true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (const T*)cur, (const float*)v0, (T*)spk, (T*)vfin, n, steps, alpha,
          v_th);
    else
      lif_scan_kernel<T, false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (const T*)cur, nullptr, (T*)spk, (T*)vfin, n, steps, alpha, v_th);
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

// (TC, TAIL, THREADS), for the wrapper's check.
extern "C" int lif_scan_geometry(int* out) {
  out[0] = TC;
  out[1] = TAIL;
  out[2] = THREADS;
  return 0;
}
