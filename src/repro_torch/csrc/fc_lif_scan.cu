// K2: fused synapse + LIF scan for the fully connected layers, and the
// same current sum on its own (fc_currents).
//
// Replaces fc_lif_scan_pallas (src/repro/kernels/fc_lif_scan.py:131):
//
//   I[t] = S_in[t] @ W            S_in (T, B, K), W (K, N)
//   V[t] = alpha * V[t-1] * (V[t-1] < v_th) + I[t]
//   S[t] = V[t] >= v_th
//
// fc_currents_f32 computes I alone for (M, K) inputs. The frame wing's fc2
// uses it: the JAX package leaves that product to XLA (s3 @ w), but the
// port's frame rows must keep their bits across batch sizes, which takes
// this fixed order.
//
// Numerics are part of the function. Each current is an fp32 sum over k in
// ascending order, each product and add rounded on its own (no TF32, no
// FMA: __fmul_rn/__fadd_rn and -fmad=false), starting from +0. fc1's input
// is an average pool of spikes, so products round; the fixed order is what
// makes the kernel equal its plain version bit for bit and a stream's rows
// independent of the batch it rides in. It rules out splitting K and the
// tensor cores, so all parallelism comes from the (t, b, n) outputs.
//
// What bounds it on the H100 (measured by tools/k2_probe.py). The
// operations: at fc1 (B=8, T=16, K=2048, N=512) 268 M separate fp32
// multiplies and adds, 8.0 us at 33.5 T instructions/s. 65,536 outputs on
// 132 SMs fill the 528 warp schedulers only at <= 4 outputs a thread, so
// the tile is 2 x 2 (Wide: a block of 128 threads computes 32 rows x 16
// columns) and each scheduler holds one warp. That warp issues ~11
// instructions a k step (8 fp32, 1.5 shared loads, its share of the
// staging) in ~18 cycles: with no other warp to switch to, its waits on
// shared loads and barriers show. Fewer outputs a thread (more warps, more
// loads an output), other chunk lengths and depths, loads issued a group
// ahead and spikes held in 16 bits all measured slower or no faster.
// Shared memory serves a warp's 4- or 8-byte load in one cycle and a
// 16-byte load in two when the lanes that share an address sit in aligned
// groups, twice that when they interleave (lane % 4, lane % 8); the lane
// map in fc_kernel keeps both of a warp's loads in the first form. Below
// kWideMinOutputs a thread owns one output (Narrow: 16 x 8), where the
// 4-cycle dependent add chain of each sum is the floor (K=2048: ~4 us).
//
// The design: K is walked in chunks of KC that cp.async stages into
// shared memory NSTAGE deep, so the copies of the next chunks overlap the
// sums of this one and the inner loop reads only shared memory and
// registers. A thread's copies are found once per T chunk, so staging a
// chunk costs a few instructions a vector. Rows of a block are (t, b)
// pairs that cover whole T chunks of its batch rows, so after the K loop
// the block writes the chunk's currents to shared memory and runs the LIF
// update over them, one thread per neuron, the membranes in registers
// across chunks: the currents never reach device memory.
//
// Ragged T, B, K and N are padded with zeros in shared memory (cp.async's
// zero fill). A padded k adds 0 * 0 = +0, which leaves every partial sum
// unchanged (a sum that starts at +0 is never -0), so padding is exact.
#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NSTAGE = 4;
// Wide tiles (4 outputs a thread) once they still give >= 2 warps per SM
// on 132 SMs: 128 threads x 4 outputs x 66 blocks.
constexpr long long kWideMinOutputs = 32768;

template <int RT_, int CT_, int TC_, int KC_, int BATCH_>
struct Tile {
  static constexpr int RT = RT_;             // rows per thread
  static constexpr int CT = CT_;             // columns per thread
  static constexpr int TC = TC_;             // threads along the columns
  static constexpr int TR = NTHREADS / TC_;  // threads along the rows
  static constexpr int ROWS = TR * RT_, COLS = TC_ * CT_, KC = KC_;
  static constexpr int BATCH = BATCH_;       // groups of products formed ahead
};
using Wide = Tile<2, 2, 8, 64, 2>;     // 32 x 16 outputs a block
using Narrow = Tile<1, 1, 8, 128, 8>;  // 16 x 8 outputs a block

// Shared-memory row stride of a spike tile, in elements: KC plus 16 bytes,
// which keeps rows 16-byte aligned for cp.async and spreads the rows a warp
// reads over the banks.
template <class C, typename T>
__host__ __device__ constexpr int spike_ld() {
  return C::KC + 16 / (int)sizeof(T);
}

// A stage: the spike tile (ROWS rows of spike_ld), then the weight tile
// (KC rows of COLS floats).
template <class C, typename T>
__host__ __device__ constexpr int spike_bytes() {
  return C::ROWS * spike_ld<C, T>() * (int)sizeof(T);
}
template <class C, typename T>
__host__ __device__ constexpr int stage_bytes() {
  return spike_bytes<C, T>() + C::KC * C::COLS * 4;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four consecutive k values of one spike row in shared memory, as f32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <int CT>
__device__ __forceinline__ void loadw(const float* p, float (&v)[CT]) {
  if constexpr (CT == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) v[c] = p[c];
  }
}

// The block's rows: r -> (tt, bb) = (r / bb_n, r % bb_n), the global row
// (t0 + tt) * B + b0 + bb of the (T, B, K) spikes, or -1 past an edge.
struct Rows {
  int t0, tt_n, bb_n, b0, b;
  __device__ __forceinline__ long long at(int r) const {
    const int tt = r / bb_n, bb = r - tt * bb_n;
    if (tt >= tt_n || b0 + bb >= b) return -1;
    return (long long)(t0 + tt) * b + b0 + bb;
  }
};

// The spike tile's copies, ROWS x KC elements a chunk: 16-byte cp.async
// when the rows and the base are 16-byte aligned (``vec``; a thread's
// vectors share one k offset and their rows are found once per T chunk),
// else plain loads and stores, one element at a time.
template <class C, typename T>
struct SpikeStager {
  static constexpr int LD = spike_ld<C, T>();
  static constexpr int EPV = 16 / sizeof(T), VPR = C::KC / EPV;
  static constexpr int PER = C::ROWS * VPR / NTHREADS;   // vectors a thread
  static constexpr int RSTEP = NTHREADS / VPR;           // rows between them
  const T* spk;
  const T* src[PER];   // row start + the thread's k offset; null past an edge
  Rows rows;
  int k, q, r0;
  bool vec;

  __device__ __forceinline__ SpikeStager(const T* spk_, const Rows& rows_,
                                         int k_, bool vec_)
      : spk(spk_), rows(rows_), k(k_), vec(vec_) {
    q = (threadIdx.x % VPR) * EPV;
    r0 = threadIdx.x / VPR;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const long long g = rows.at(r0 + i * RSTEP);
      src[i] = g >= 0 ? spk + g * k + q : nullptr;
    }
  }

  __device__ __forceinline__ void stage(T* dst, int k0) const {
    if (vec) {
      const bool k_ok = k0 + q < k;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const bool ok = k_ok && src[i] != nullptr;
        cp_async16(dst + (r0 + i * RSTEP) * LD + q, ok ? src[i] + k0 : spk,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < C::ROWS * C::KC; e += NTHREADS) {
        const int r = e / C::KC, kq = e - r * C::KC, kk = k0 + kq;
        const long long g = rows.at(r);
        dst[r * LD + kq] = (g >= 0 && kk < k) ? spk[g * k + kk]
                                              : from_f32<T>(0.0f);
      }
    }
  }
};

// The weight tile's cp.async copies, KC x COLS floats a chunk in W's own
// row layout, as vectors of VW (4 when n % 4 == 0 and W is 16-byte
// aligned, else 1): a thread's vectors share one column and are KSTEP
// rows apart.
template <class C, int VW>
__device__ __forceinline__ void stage_weights(float* dst, const float* w,
                                              int k0, int k, int n0, int n) {
  constexpr int VPR = C::COLS / VW, PER = C::KC * VPR / NTHREADS;
  constexpr int KSTEP = NTHREADS / VPR;
  const int cq = (threadIdx.x % VPR) * VW, kr0 = threadIdx.x / VPR;
  const bool col_ok = n0 + cq < n;
  const float* src = w + (long long)(k0 + kr0) * n + n0 + cq;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool ok = col_ok && k0 + kr0 + i * KSTEP < k;
    float* d = dst + (kr0 + i * KSTEP) * C::COLS + cq;
    const float* p = ok ? src + (long long)i * KSTEP * n : w;
    if constexpr (VW == 4) cp_async16(d, p, ok ? 16 : 0);
    else cp_async4(d, p, ok ? 4 : 0);
  }
}

// One staged chunk into the thread's RT x CT sums, k ascending. The
// thread's rows are tr + i * TR, its columns tc * CT + c. A group is four
// k: one 16-byte (bf16: 8-byte) load per row and one CT-wide load per k.
// The products of a batch of groups are formed before the batch's adds.
template <class C, typename T>
__device__ __forceinline__ void sum_chunk(const T* s, const float* w, int tr,
                                          int tc,
                                          float (&acc)[C::RT][C::CT]) {
  constexpr int LD = spike_ld<C, T>();
  constexpr int G = C::KC / 4, BATCH = C::BATCH;
#pragma unroll
  for (int g0 = 0; g0 < G; g0 += BATCH) {
    float p[BATCH][4][C::RT][C::CT];
#pragma unroll
    for (int g = 0; g < BATCH; ++g) {
      float sv[C::RT][4];
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
        load4(s + (tr + i * C::TR) * LD + 4 * (g0 + g), sv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wv[C::CT];
        loadw<C::CT>(w + (4 * (g0 + g) + j) * C::COLS + tc * C::CT, wv);
#pragma unroll
        for (int i = 0; i < C::RT; ++i)
#pragma unroll
          for (int c = 0; c < C::CT; ++c)
            p[g][j][i][c] = __fmul_rn(sv[i][j], wv[c]);
      }
    }
#pragma unroll
    for (int g = 0; g < BATCH; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < C::RT; ++i)
#pragma unroll
          for (int c = 0; c < C::CT; ++c)
            acc[i][c] = __fadd_rn(acc[i][c], p[g][j][i][c]);
  }
}

// The block's currents for the rows of ``rows``, into ``acc``: K walked in
// chunks, NSTAGE - 1 chunks in flight ahead of the one being summed. The
// copies of chunk c + NSTAGE - 1 go into the stage that chunk c - 1 left,
// after the barrier that ends its sums.
template <class C, typename T>
__device__ __forceinline__ void block_currents(
    unsigned char* smem, const T* spk, const float* w, const Rows& rows,
    int k, int n0, int n, bool s16, bool w16, int tr, int tc,
    float (&acc)[C::RT][C::CT]) {
  const int chunks = (k + C::KC - 1) / C::KC;
  const SpikeStager<C, T> spikes(spk, rows, k, s16);
  auto stage = [&](int c) {
    unsigned char* s = smem + (c % NSTAGE) * stage_bytes<C, T>();
    float* wt = reinterpret_cast<float*>(s + spike_bytes<C, T>());
    spikes.stage(reinterpret_cast<T*>(s), c * C::KC);
    if (w16) stage_weights<C, 4>(wt, w, c * C::KC, k, n0, n);
    else stage_weights<C, 1>(wt, w, c * C::KC, k, n0, n);
  };
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int c = 0; c < C::CT; ++c) acc[i][c] = 0.0f;
  for (int c = 0; c < NSTAGE - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<NSTAGE - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot c - 1 is free
    if (c + NSTAGE - 1 < chunks) stage(c + NSTAGE - 1);
    cp_async_commit();
    const unsigned char* s = smem + (c % NSTAGE) * stage_bytes<C, T>();
    sum_chunk<C, T>(reinterpret_cast<const T*>(s),
                    reinterpret_cast<const float*>(s + spike_bytes<C, T>()),
                    tr, tc, acc);
  }
  __syncthreads();                 // the slots may be staged again
}

template <class C, typename T, bool LIF>
constexpr int smem_bytes() {
  return NSTAGE * stage_bytes<C, T>() +
         (LIF ? C::ROWS * (C::COLS + 1) * 4 : 0);
}

// LIF = true: the fused K2 kernel over (T, B, K) spikes. LIF = false:
// currents of (M, K) inputs (steps = 1, b = M) written to ``cur_out``.
template <class C, typename T, bool LIF>
__global__ void __launch_bounds__(NTHREADS)
fc_kernel(const T* __restrict__ spk, const float* __restrict__ w,
          const float* __restrict__ v0, T* __restrict__ out,
          T* __restrict__ vfin, float* __restrict__ cur_out, int steps,
          int b, int k, int n, int tt_n, int bb_n, float alpha, float v_th,
          bool s16, bool w16) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CUR_LD = C::COLS + 1;
  float* cur_s = reinterpret_cast<float*>(smem + NSTAGE * stage_bytes<C, T>());
  // The lane map: a thread's column group tc is lane bits 1-3, its row
  // group tr the warp and lane bits 0 and 4. Lanes that load the same
  // weights, and lanes that load the same spike row, then sit in the
  // aligned groups that shared memory serves at full rate.
  static_assert(C::TC == 8 && C::TR == 16, "the lane map takes 8 x 16");
  const int tid = threadIdx.x, tc = (tid >> 1) & 7,
            tr = (tid / 32) * 4 + (tid & 1) + ((tid >> 4) & 1) * 2;
  const int n0 = blockIdx.x * C::COLS, b0 = blockIdx.y * bb_n;

  // LIF neurons of the block: i = tid + j * NTHREADS -> (bb, c) =
  // (i / COLS, i % COLS); bb_n * COLS <= ROWS * COLS = NTHREADS * NV.
  constexpr int NV = C::RT * C::CT;
  const int neurons = bb_n * C::COLS;
  float v[NV];
  if constexpr (LIF) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * NTHREADS;
      const int row = b0 + i / C::COLS, col = n0 + i % C::COLS;
      v[j] = (v0 != nullptr && i < neurons && row < b && col < n)
                 ? v0[(long long)row * n + col] : 0.0f;
    }
  }

  for (int t0 = 0; t0 < steps; t0 += tt_n) {
    const Rows rows{t0, min(tt_n, steps - t0), bb_n, b0, b};
    float acc[C::RT][C::CT];
    block_currents<C, T>(smem, spk, w, rows, k, n0, n, s16, w16, tr, tc,
                         acc);
    if constexpr (!LIF) {
#pragma unroll
      for (int i = 0; i < C::RT; ++i) {
        const long long g = rows.at(tr + i * C::TR);
#pragma unroll
        for (int c = 0; c < C::CT; ++c) {
          const int col = n0 + tc * C::CT + c;
          if (g >= 0 && col < n) cur_out[g * n + col] = acc[i][c];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int c = 0; c < C::CT; ++c)
          cur_s[(tr + i * C::TR) * CUR_LD + tc * C::CT + c] = acc[i][c];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int i = tid + j * NTHREADS;
        const int bb = i / C::COLS, c = i % C::COLS;
        const int row = b0 + bb, col = n0 + c;
        if (i < neurons && row < b && col < n) {
          for (int tt = 0; tt < rows.tt_n; ++tt) {
            const float live = v[j] < v_th ? 1.0f : 0.0f;
            v[j] = __fadd_rn(__fmul_rn(__fmul_rn(alpha, v[j]), live),
                             cur_s[(tt * bb_n + bb) * CUR_LD + c]);
            out[((long long)(t0 + tt) * b + row) * n + col] =
                from_f32<T>(v[j] >= v_th ? 1.0f : 0.0f);
          }
        }
      }
      __syncthreads();             // cur_s may be written again
    }
  }

  if constexpr (LIF) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * NTHREADS;
      const int row = b0 + i / C::COLS, col = n0 + i % C::COLS;
      if (i < neurons && row < b && col < n)
        vfin[(long long)row * n + col] = from_f32<T>(v[j]);
    }
  }
}

// 16-byte copies need a 16-byte aligned base and rows of a multiple of 16
// bytes.
bool aligned16(const void* p, long long row_bytes) {
  return (unsigned long long)p % 16 == 0 && row_bytes % 16 == 0;
}

template <class C, typename T, bool LIF>
int run(const void* spk, const void* w, const void* v0, void* out,
        void* vfin, void* cur, int steps, int b, int k, int n, float alpha,
        float v_th, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<C, T, LIF>();
  // Set on every launch: the attribute belongs to the current device.
  const cudaError_t attr = cudaFuncSetAttribute(
      fc_kernel<C, T, LIF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // A block covers tt_n time steps of bb_n batch rows: the whole of T
  // when it fits in the tile's rows, with as many batch rows as fit.
  const int tt_n = steps < 1 ? 1 : (steps < C::ROWS ? steps : C::ROWS);
  const int bb_n = std::max(1, std::min(b, C::ROWS / tt_n));
  const dim3 grid((n + C::COLS - 1) / C::COLS, (b + bb_n - 1) / bb_n);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  fc_kernel<C, T, LIF><<<grid, NTHREADS, SMEM, stream>>>(
      (const T*)spk, (const float*)w, (const float*)v0, (T*)out, (T*)vfin,
      (float*)cur, steps, b, k, n, tt_n, bb_n, alpha, v_th,
      aligned16(spk, (long long)k * sizeof(T)), aligned16(w, 4LL * n));
  return (int)cudaGetLastError();
}

template <typename T, bool LIF>
int launch(const void* spk, const void* w, const void* v0, void* out,
           void* vfin, void* cur, int steps, int b, int k, int n,
           float alpha, float v_th, void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if ((long long)steps * b * n >= kWideMinOutputs)
    return run<Wide, T, LIF>(spk, w, v0, out, vfin, cur, steps, b, k, n,
                             alpha, v_th, s);
  return run<Narrow, T, LIF>(spk, w, v0, out, vfin, cur, steps, b, k, n,
                             alpha, v_th, s);
}

}  // namespace

extern "C" int fc_lif_scan_f32(const void* spk, const void* w, const void* v0,
                               void* out, void* vfin, int steps, int b, int k,
                               int n, float alpha, float v_th, void* stream) {
  return launch<float, true>(spk, w, v0, out, vfin, nullptr, steps, b, k, n,
                             alpha, v_th, stream);
}

extern "C" int fc_lif_scan_bf16(const void* spk, const void* w,
                                const void* v0, void* out, void* vfin,
                                int steps, int b, int k, int n, float alpha,
                                float v_th, void* stream) {
  return launch<__nv_bfloat16, true>(spk, w, v0, out, vfin, nullptr, steps,
                                     b, k, n, alpha, v_th, stream);
}

// Currents alone: x (M, K) f32, w (K, N) f32 -> cur (M, N) f32, the same
// sums as the fused kernel (one time step of M batch rows).
extern "C" int fc_currents_f32(const void* x, const void* w, void* cur, int m,
                               int k, int n, void* stream) {
  return launch<float, false>(x, w, nullptr, nullptr, nullptr, cur, 1, m, k,
                              n, 0.0f, 0.0f, stream);
}
