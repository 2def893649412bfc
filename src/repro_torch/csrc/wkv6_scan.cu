// K4: the RWKV-6 WKV recurrence, one (batch, head) per block.
//
//   o_t = r_t (S + diag(u) k_t v_t^T)
//   S  <- diag(exp(logw_t)) S + k_t v_t^T
//
// Replaces wkv6_scan_pallas (repro/kernels/wkv6_scan.py), which keeps a
// block of (hd x hd) f32 states in VMEM scratch across a sequential T grid
// axis while r/k/v/logw stream through, after transposing the inputs to
// (T, B*H, hd) and padding B*H to its block. On Hopper the blocks of a grid
// run in no order, so nothing is carried between them: each block owns one
// (b, h) for the whole sequence and walks T itself. Thread j holds column j
// of the state, S[0..hd-1][j], in registers for all T; the state never
// touches device memory between the optional state0 read and the final
// write. The inputs are read in place, (B, T, H, hd) row-major: a (b, t, h)
// row is hd contiguous values, so the hd threads of a block load one row
// with one coalesced access and no transpose or padding is needed.
//
// Per step, thread j stages r_t[j], k_t[j] and w_t[j] = expf(logw_t[j]) in
// shared memory (two buffers, so one barrier per step suffices), reads its
// own v_t[j], then walks i = 0..hd-1 in ascending order:
//   kv  = k_i * v_j
//   acc = acc + r_i * (S_ij + u_i * kv)
//   S_ij = w_i * S_ij + kv
// each multiply and add rounded on its own (__fmul_rn/__fadd_rn; the library
// is built with -fmad=false) and expf the accurate one, never __expf. The
// plain version (kernels/wkv6_scan.py wkv6_scan_plain) repeats exactly these
// operations, so the two agree bit for bit on the card, and a (b, h) never
// depends on the others.
//
// Types: r, k, v, u f32 or bf16 (all the same); logw f32 or r's type;
// o in r's type; the state always f32. hd in {16, 32, 64}.
//
// Bound: 7 hd^2 flops per (b, h, t) against (4 + logw) hd values read and hd
// written, so at hd = 64 the work is operation-bound on the card (prefill
// B=4, T=2048, H=64: 15.0 GFLOP over ~0.41 GB, 0.225 ms at 67 TFLOP/s f32).
// This first design carries a 64-long dependent add chain per step in each
// thread, so it runs at the latency of that chain, well above the bound;
// splitting i across warps or a chunked tensor-core form is later work.
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

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const TW* __restrict__ logw,
                 const T* __restrict__ u, const float* __restrict__ state0,
                 T* __restrict__ o, float* __restrict__ state_out,
                 int n_t, int n_h) {
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;           // b * H + h
  const int b = bh / n_h, h = bh - b * n_h;
  const long long row_stride = (long long)n_h * HD;        // one t
  const long long base = (long long)b * n_t * row_stride + (long long)h * HD;
  const long long sbase = (long long)bh * HD * HD;

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s[i] = state0 != nullptr ? state0[sbase + (long long)i * HD + j] : 0.0f;
  us[j] = to_f32(u[h * HD + j]);

  // Registers for the next step's inputs, loaded one step ahead.
  float r_n = 0.0f, k_n = 0.0f, v_n = 0.0f, lw_n = 0.0f;
  if (n_t > 0) {
    r_n = to_f32(r[base + j]);
    k_n = to_f32(k[base + j]);
    v_n = to_f32(v[base + j]);
    lw_n = to_f32(logw[base + j]);
  }
  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    rs[buf][j] = r_n;
    ks[buf][j] = k_n;
    ws[buf][j] = expf(lw_n);
    const float vj = v_n;
    if (t + 1 < n_t) {
      const long long off = base + (long long)(t + 1) * row_stride + j;
      r_n = to_f32(r[off]);
      k_n = to_f32(k[off]);
      v_n = to_f32(v[off]);
      lw_n = to_f32(logw[off]);
    }
    // Buffer `buf` was last read in step t - 2; every thread has passed
    // step t - 1's barrier since, so one barrier per step is enough.
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = __fmul_rn(ks[buf][i], vj);
      acc = __fadd_rn(acc, __fmul_rn(rs[buf][i],
                                     __fadd_rn(s[i], __fmul_rn(us[i], kv))));
      s[i] = __fadd_rn(__fmul_rn(ws[buf][i], s[i]), kv);
    }
    o[base + (long long)t * row_stride + j] = from_f32<T>(acc);
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) state_out[sbase + (long long)i * HD + j] = s[i];
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* state0, void* o, void* state_out,
           int n_b, int n_t, int n_h, int hd, void* stream) {
  const int blocks = n_b * n_h;
  if (blocks == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define WKV6_ARGS                                                            \
  (const T*)r, (const T*)k, (const T*)v, (const TW*)logw, (const T*)u,      \
      (const float*)state0, (T*)o, (float*)state_out, n_t, n_h
  switch (hd) {
    case 16: wkv6_scan_kernel<T, TW, 16><<<blocks, 16, 0, st>>>(WKV6_ARGS);
      break;
    case 32: wkv6_scan_kernel<T, TW, 32><<<blocks, 32, 0, st>>>(WKV6_ARGS);
      break;
    case 64: wkv6_scan_kernel<T, TW, 64><<<blocks, 64, 0, st>>>(WKV6_ARGS);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef WKV6_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, u, o f32; logw f32.
extern "C" int wkv6_scan_f32(const void* r, const void* k, const void* v,
                             const void* logw, const void* u,
                             const void* state0, void* o, void* state_out,
                             int n_b, int n_t, int n_h, int hd,
                             void* stream) {
  return launch<float, float>(r, k, v, logw, u, state0, o, state_out, n_b,
                              n_t, n_h, hd, stream);
}

// r, k, v, u, o bf16; logw bf16.
extern "C" int wkv6_scan_bf16(const void* r, const void* k, const void* v,
                              const void* logw, const void* u,
                              const void* state0, void* o, void* state_out,
                              int n_b, int n_t, int n_h, int hd,
                              void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, logw, u, state0, o, state_out, n_b, n_t, n_h, hd, stream);
}

// r, k, v, u, o bf16; logw f32 (what the bf16 model's time mix hands over).
extern "C" int wkv6_scan_bf16_lwf32(const void* r, const void* k,
                                    const void* v, const void* logw,
                                    const void* u, const void* state0,
                                    void* o, void* state_out, int n_b,
                                    int n_t, int n_h, int hd, void* stream) {
  return launch<__nv_bfloat16, float>(r, k, v, logw, u, state0, o, state_out,
                                      n_b, n_t, n_h, hd, stream);
}
