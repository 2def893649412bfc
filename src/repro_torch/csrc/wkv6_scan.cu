// K4: the RWKV-6 WKV recurrence,
//
//   o_t = r_t (S + diag(u) k_t v_t^T)
//   S  <- diag(exp(logw_t)) S + k_t v_t^T
//
// Replaces wkv6_scan_pallas (src/repro/kernels/wkv6_scan.py:69), which
// keeps a block of (hd x hd) f32 states in VMEM scratch across a
// sequential T grid axis while r/k/v/logw stream through, after
// transposing the inputs to (T, B*H, hd) and padding B*H to its block. On
// Hopper the blocks of a grid run in no order, so nothing is carried
// between them: a block owns one (b, h) (or, with COL_SPLIT = 2, half of
// its columns: the columns of S never meet) and walks T itself. The state
// never touches device memory between the optional state0 read and the
// final write. The inputs are read in place, (B, T, H, hd) row-major.
//
// The function fixes the order of every sum (kernels/wkv6_scan.py says
// the same, and wkv6_scan_plain there repeats it operation for operation,
// so the two agree bit for bit on the card). Per (b, h, t), with S the
// state before the step, each multiply and add rounded on its own
// (__fmul_rn/__fadd_rn; the library is built with -fmad=false) and expf
// the accurate one, never __expf:
//
//   p_g,j = sum over i in [g*IS, (g+1)*IS), ascending, from +0: r_i S_ij
//   beta  = sum over i = 0..hd-1, ascending, from +0: (r_i u_i) k_i
//   o_j   = (((+0 + p_0,j) + p_1,j) ... + p_last,j) + beta v_j
//   S_ij <- expf(logw_i) S_ij + k_i v_j
//
// beta is the bonus term as a rank-one dot: r diag(u) k v^T = ((r*u).k) v.
// The order depends on (b, h, t) alone: not on T, the batch, the time
// chunks below or the launch geometry.
//
// What bounds it on the H100. Per (b, h, t) the recurrence needs
// 5 hd^2 + 6 hd f32 operations (r.S 2 hd^2, the update 3 hd^2, beta and
// its v-scaled add 5 hd, exp hd) against (4 + logw) hd values read and hd
// written: prefill (B=4, T=2048, H=64, hd=64) is 10.9 G operations over
// ~0.35 GB, 0.327 ms at 33.5e12 f32 instructions a second (each multiply
// and each add one: no FMA) against 0.10 ms of bytes, so it is bound by
// instruction issue. The only serial dependence is S_ij's own multiply
// and add a step; o_t depends on S but nothing depends on o_t. The
// design (tools/k4_probe.py times it against variants of IS, TC, CPT,
// COL_SPLIT and HELPERS):
//
//  * Threads: (hd / IS) x (hd / COL_SPLIT / CPT) state threads and
//    HELPERS helper warps a block. State thread (g, j) holds rows
//    g*IS .. g*IS+IS-1 of CPT columns j, j + 32, .. in CPT x IS registers.
//    A warp's lanes share g, so the r, w and k values a step needs are
//    broadcast 16-byte shared loads, each used CPT times. At hd = 64: 4
//    state warps and 2 helper warps a block, 2 blocks an SM at prefill
//    (B*H = 256 blocks on 132 SMs).
//  * Time chunks of TC steps, one block barrier a chunk. In iteration c
//    the state warps run the steps of chunk c while the helper warps copy
//    chunk c+2 into shared memory (16-byte cp.async, or element loads
//    where a tensor is not 16-byte aligned), take beta of each step of
//    chunk c (a lane a step: its hd-long add chain), combine chunk c-1
//    and widen chunk c+1 to f32 (w = expf(logw) once an element). Each
//    phase writes buffers no other phase of the iteration touches (raw
//    x2, widened r/w/k x2, v x3, beta x2, partials x2). The first chunk
//    is read straight from device memory, the last is combined by all
//    threads; rows past T are neither copied nor used.
//  * Steps: no barrier inside a chunk. State thread (g, j) adds its IS
//    terms of r.S, writes p_g,j to a shared [TC][hd/IS][hd] buffer and
//    updates its state values; the next step's r is loaded before the
//    partial is stored.
//  * Combine: the partials in ascending g, then beta v_j; o is written
//    coalesced in r's dtype.
//  * A call of at most TC_SHORT steps (decode) takes an instance with
//    TC_SHORT-step chunks: its blocks start faster with a quarter of the
//    shared memory. The order, and so every bit, is the same.
//
// One launch a call; no workspace, no atomics, nothing kept between
// calls. Types: r, k, v, u f32 or bf16 (all the same); logw f32 or r's
// type; o in r's type; the state always f32. hd in {16, 32, 64}.
//
// The stripe entry (wkv6_stripe_*, at the end of this file) is the same
// recurrence on rows [lo, lo + DK) of each (b, h) state, for a decode step
// whose state has dk split over the data ranks (context parallelism: a
// global batch the batch axes do not divide). The rank holds only its DK
// rows; r, k, v and u are whole (beta and v_j need every row), logw is
// read on the stripe's rows alone. Per (b, h, t) it writes the
// partials p_g,j of the stripe's segments (SEG = min(IS, DK) rows each,
// in the order above), beta whole, and the new state rows, each op rounded
// as above; the caller gathers the partials of every stripe and adds them
// in ascending row order, then beta v_j (kernels/wkv6_scan.py,
// wkv6_stripe_combine). Where DK is a multiple of IS that is the order
// above, so o equals the whole-state kernel's bit for bit. A block owns
// one (b, h): thread (g, j) holds the SEG rows of segment g of column j in
// registers, the step's r, k and v rows and the stripe's DK values of
// w = expf(logw) are staged in shared memory, and thread 0 takes beta's
// hd-long chain. Decode calls
// are one step of B x H_r blocks, bound by the launch: it is kept plain.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// i-segment width of r.S. kernels/wkv6_scan.py names the same constant IS
// (and checks it against wkv6_scan_geometry when it loads this library):
// the two must agree, or the kernel and its plain version part bits.
constexpr int IS = 16;
constexpr int TC = 16;           // steps a staged time chunk
constexpr int TC_SHORT = 4;      // ... in a call of at most that many steps
constexpr int CPT = 2;           // columns a thread where hd >= 16 * it
constexpr int COL_SPLIT = 1;     // blocks a (b, h) where hd >= 32 * it
constexpr int HELPERS = 2;       // helper warps a block (copies, beta,
                                 // combine, widening)
static_assert(TC % 4 == 0 && TC <= 32 && TC_SHORT % 4 == 0 && TC_SHORT <= TC,
              "chunks of whole float4 rows; beta takes a lane a step");

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

// Four consecutive values widened to f32 (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 bits = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(bits.x << 16),
                     __uint_as_float(bits.x & 0xffff0000u),
                     __uint_as_float(bits.y << 16),
                     __uint_as_float(bits.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float fma_free(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// The block's geometry and its shared-memory layout, in bytes, for time
// chunks of CH steps.
template <typename T, typename TW, int HD, int CH> struct Cfg {
  static constexpr int SEG = IS < HD ? IS : HD;
  static constexpr int G = HD / SEG;                      // segments
  static constexpr int SPLIT = HD >= 32 * COL_SPLIT ? COL_SPLIT : 1;
  static constexpr int JB = HD / SPLIT;                   // columns a block
  static constexpr int CT =                               // columns a thread
      JB % CPT == 0 && JB / CPT >= 16 ? CPT : 1;
  static constexpr int CW = JB / CT;                      // threads a segment
  static constexpr int NT = G * CW;                       // state threads
  static constexpr int BW = (NT + 31) / 32 * 32;          // first helper
  static constexpr int THREADS = BW + 32 * HELPERS;
  static constexpr int MINB = 2;   // shared memory holds 2 blocks an SM
  static constexpr int LDW = HD + 4;   // widened r/w/k row stride (floats):
                                       // beta's lanes read rows apart
  static constexpr int RAW_T = CH * HD * (int)sizeof(T);  // a raw r/k/v chunk
  static constexpr int RAW = 3 * RAW_T + CH * HD * (int)sizeof(TW);
  static constexpr int OFF_RWK = 2 * RAW;                 // f32 [2][3][CH][LDW]
  static constexpr int OFF_V = OFF_RWK + 2 * 3 * CH * LDW * 4;  // [3][CH][HD]
  static constexpr int OFF_BETA = OFF_V + 3 * CH * HD * 4;      // [2][CH]
  static constexpr int OFF_PART = OFF_BETA + 2 * CH * 4;  // [2][CH][G][JB]
  static constexpr int OFF_U = OFF_PART + 2 * CH * G * JB * 4;  // [HD]
  static constexpr int BYTES = OFF_U + HD * 4;
  static_assert(RAW_T % 16 == 0 && OFF_PART % 16 == 0, "16-byte rows");
};

// Rows t0 .. t0+n-1 of one (b, h) of x into dst ([TC][HD] of X): 16-byte
// cp.async pieces, or element loads when a tensor is not 16-byte aligned.
template <typename X, int HD>
__device__ __forceinline__ void stage_rows(X* dst, const X* x,
                                           long long base,
                                           long long row_stride, int t0,
                                           int n, bool aligned, int tid,
                                           int nt) {
  const X* src = x + base + (long long)t0 * row_stride;
  if (aligned) {
    constexpr int PR = HD * (int)sizeof(X) / 16;          // pieces a row
    constexpr int VALS = 16 / (int)sizeof(X);
    for (int e = tid; e < n * PR; e += nt) {
      const int t = e / PR, pc = e - t * PR;
      cp_async16(dst + t * HD + pc * VALS,
                 src + (long long)t * row_stride + pc * VALS, 16);
    }
  } else {
    for (int e = tid; e < n * HD; e += nt) {
      const int t = e / HD;
      dst[e] = src[(long long)t * row_stride + (e - t * HD)];
    }
  }
}

// Four consecutive values of x at p, widened to f32: one vector load when
// x is 16-byte aligned (p is then 8-byte aligned at least), else four.
template <typename X>
__device__ __forceinline__ float4 fetch4(const X* p, bool aligned) {
  if (aligned) return load4(p);
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

// The final state, CT columns of IS rows a thread, coalesced rows.
template <int CT, int SEG, int HD, int CW>
__device__ __forceinline__ void store_state(float* out,
                                            const float (&s)[CT][SEG],
                                            long long sbase, int g, int j) {
#pragma unroll
  for (int m = 0; m < CT; ++m)
#pragma unroll
    for (int ii = 0; ii < SEG; ++ii)
      out[sbase + (long long)(g * SEG + ii) * HD + j + m * CW] = s[m][ii];
}

template <typename T, typename TW, int HD, int CH>
__global__ void __launch_bounds__(Cfg<T, TW, HD, CH>::THREADS,
                                  Cfg<T, TW, HD, CH>::MINB)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const TW* __restrict__ logw,
                 const T* __restrict__ u, const float* __restrict__ state0,
                 T* __restrict__ o, float* __restrict__ state_out, int n_t,
                 int n_h, bool aligned) {
  using C = Cfg<T, TW, HD, CH>;
  constexpr int TC = CH;           // this instance's chunk
  constexpr int SEG = C::SEG, G = C::G, JB = C::JB, NT = C::NT;
  constexpr int CT = C::CT, CW = C::CW, NB = C::THREADS;
  constexpr int LDW = C::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const rwk = reinterpret_cast<float*>(smem + C::OFF_RWK);
  float* const vb = reinterpret_cast<float*>(smem + C::OFF_V);
  float* const betas = reinterpret_cast<float*>(smem + C::OFF_BETA);
  float* const part = reinterpret_cast<float*>(smem + C::OFF_PART);
  float* const us = reinterpret_cast<float*>(smem + C::OFF_U);

  const int tid = threadIdx.x;
  const int g = tid / CW, jj = tid - g * CW;   // columns j0 + jj + m*CW
  const int bh = blockIdx.x / C::SPLIT;
  const int j0 = (blockIdx.x - bh * C::SPLIT) * JB;
  const int j = j0 + jj;
  const int b = bh / n_h, h = bh - b * n_h;
  const long long row_stride = (long long)n_h * HD;        // one t
  const long long base = (long long)b * n_t * row_stride + (long long)h * HD;
  const long long sbase = (long long)bh * HD * HD;
  const int n_c = (n_t + TC - 1) / TC;

  const bool holds = tid < NT;      // a state thread
  const int hl = tid - C::BW;       // helper lane (< 0 in a state thread)
  float s[CT][SEG];
#pragma unroll
  for (int m = 0; m < CT; ++m)
#pragma unroll
    for (int ii = 0; ii < SEG; ++ii)
      s[m][ii] = holds && state0 != nullptr
          ? state0[sbase + (long long)(g * SEG + ii) * HD + j + m * CW]
          : 0.0f;
  for (int i = tid; i < HD; i += NB) us[i] = to_f32(u[h * HD + i]);

  auto raw = [&](int c) { return smem + (c & 1) * C::RAW; };
  auto rows = [&](int c) { return min(TC, n_t - c * TC); };
  // Copy chunk c's rows (those below T) into raw(c), asynchronously.
  auto stage = [&](int c, int me, int nth) {
    unsigned char* d = raw(c);
    const int t0 = c * TC, n = rows(c);
    stage_rows<T, HD>(reinterpret_cast<T*>(d), r, base, row_stride, t0, n,
                      aligned, me, nth);
    stage_rows<T, HD>(reinterpret_cast<T*>(d + C::RAW_T), k, base,
                      row_stride, t0, n, aligned, me, nth);
    stage_rows<T, HD>(reinterpret_cast<T*>(d + 2 * C::RAW_T), v, base,
                      row_stride, t0, n, aligned, me, nth);
    stage_rows<TW, HD>(reinterpret_cast<TW*>(d + 3 * C::RAW_T), logw, base,
                       row_stride, t0, n, aligned, me, nth);
    cp_async_commit();
  };
  // Widen chunk c's rows to f32: r, w = expf(logw), k into rwk[c & 1], v
  // into vb[c % 3]; from raw(c), or (direct) from device memory.
  auto widen = [&](int c, bool direct, int me, int nth) {
    const unsigned char* d = raw(c);
    float* R = rwk + (c & 1) * 3 * TC * LDW;
    float* V = vb + (c % 3) * TC * HD;
    const int items = rows(c) * (HD / 4);
#pragma unroll 4
    for (int e = me; e < items; e += nth) {
      const int t = e / (HD / 4), i = (e - t * (HD / 4)) * 4;
      float4 rv, lw, kv, vv;
      if (direct) {
        const long long at = base + (long long)(c * TC + t) * row_stride + i;
        rv = fetch4(r + at, aligned);
        lw = fetch4(logw + at, aligned);
        kv = fetch4(k + at, aligned);
        vv = fetch4(v + at, aligned);
      } else {
        const int at = t * HD + i;
        rv = load4(reinterpret_cast<const T*>(d) + at);
        kv = load4(reinterpret_cast<const T*>(d + C::RAW_T) + at);
        vv = load4(reinterpret_cast<const T*>(d + 2 * C::RAW_T) + at);
        lw = load4(reinterpret_cast<const TW*>(d + 3 * C::RAW_T) + at);
      }
      lw = make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w));
      *reinterpret_cast<float4*>(R + t * LDW + i) = rv;
      *reinterpret_cast<float4*>(R + (TC + t) * LDW + i) = lw;
      *reinterpret_cast<float4*>(R + (2 * TC + t) * LDW + i) = kv;
      *reinterpret_cast<float4*>(V + t * HD + i) = vv;
    }
  };
  // beta of each step of chunk c, a lane a step, in the first helper warp.
  auto beta = [&](int c, int n) {
    const int t = tid - C::BW;
    if (t < n) {
      const float* R = rwk + ((c & 1) * 3 * TC + t) * LDW;
      const float* K = R + 2 * TC * LDW;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = load4(R + i), k4 = load4(K + i), u4 = load4(us + i);
        acc = fma_free(acc, __fmul_rn(r4.x, u4.x), k4.x);
        acc = fma_free(acc, __fmul_rn(r4.y, u4.y), k4.y);
        acc = fma_free(acc, __fmul_rn(r4.z, u4.z), k4.z);
        acc = fma_free(acc, __fmul_rn(r4.w, u4.w), k4.w);
      }
      betas[(c & 1) * TC + t] = acc;
    }
  };
  // o of chunk c: the partials in ascending g, then beta v_j.
  auto combine = [&](int c, int me, int nth) {
    const float* P = part + (c & 1) * TC * G * JB;
    const float* V = vb + (c % 3) * TC * HD + j0;
    const float* B = betas + (c & 1) * TC;
    const int items = rows(c) * JB;
#pragma unroll 4
    for (int e = me; e < items; e += nth) {
      const int t = e / JB, jc = e - t * JB;
      float acc = 0.0f;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        acc = __fadd_rn(acc, P[(t * G + gi) * JB + jc]);
      acc = fma_free(acc, B[t], V[t * HD + jc]);
      o[base + (long long)(c * TC + t) * row_stride + j0 + jc] =
          from_f32<T>(acc);
    }
  };

  // Chunk 0 is widened straight from device memory while chunk 1 copies.
  if (n_c > 1) stage(1, tid, NB);
  if (n_c > 0) widen(0, true, tid, NB);
  cp_async_wait_all();
  __syncthreads();
  if (n_c == 0 && holds)
    store_state<CT, SEG, HD, CW>(state_out, s, sbase, g, j);
  for (int c = 0; c <= n_c; ++c) {
    if (c == n_c) {
      if (c >= 1) combine(c - 1, tid, NB);     // the last chunk: all threads
    } else if (hl >= 0) {
      constexpr int HN = 32 * HELPERS;
      if (c + 2 < n_c) stage(c + 2, hl, HN);
      if (hl < 32) beta(c, rows(c));
      if (c >= 1) combine(c - 1, hl, HN);
      if (c + 1 < n_c) widen(c + 1, false, hl, HN);
    } else if (holds) {
      // The steps of chunk c for thread (g, j), written out here rather
      // than in a lambda so that s[] stays in registers. The r values of
      // step t+1 are loaded before step t's partial is stored (the
      // compiler may not move a shared load above a shared store), those
      // of w, k and v at the top of their step, ahead of the r.S chain.
      const int n = rows(c);
      const float* R = rwk + (c & 1) * 3 * TC * LDW + g * SEG;
      const float* W = R + TC * LDW;
      const float* K = R + 2 * TC * LDW;
      const float* V = vb + (c % 3) * TC * HD + j;
      float* P = part + (c & 1) * TC * G * JB + g * JB + jj;
      float4 rn[SEG / 4];
#pragma unroll
      for (int q = 0; q < SEG / 4; ++q) rn[q] = load4(R + 4 * q);
#pragma unroll 2
      for (int t = 0; t < n; ++t) {
        float4 rt[SEG / 4], wt[SEG / 4], kt[SEG / 4];
        float vj[CT], p[CT];
#pragma unroll
        for (int q = 0; q < SEG / 4; ++q) {
          wt[q] = load4(W + t * LDW + 4 * q);
          kt[q] = load4(K + t * LDW + 4 * q);
          rt[q] = rn[q];
          // Row t+1 <= TC lies inside the buffers (row TC is W's first).
          rn[q] = load4(R + (t + 1) * LDW + 4 * q);
        }
#pragma unroll
        for (int m = 0; m < CT; ++m) {
          vj[m] = V[t * HD + m * CW];
          p[m] = 0.0f;
        }
#pragma unroll
        for (int q = 0; q < SEG / 4; ++q)
#pragma unroll
          for (int m = 0; m < CT; ++m) {
            p[m] = fma_free(p[m], rt[q].x, s[m][4 * q]);
            p[m] = fma_free(p[m], rt[q].y, s[m][4 * q + 1]);
            p[m] = fma_free(p[m], rt[q].z, s[m][4 * q + 2]);
            p[m] = fma_free(p[m], rt[q].w, s[m][4 * q + 3]);
          }
#pragma unroll
        for (int m = 0; m < CT; ++m) P[t * G * JB + m * CW] = p[m];
#pragma unroll
        for (int q = 0; q < SEG / 4; ++q)
#pragma unroll
          for (int m = 0; m < CT; ++m) {
            float* x = s[m] + 4 * q;
            x[0] = __fadd_rn(__fmul_rn(wt[q].x, x[0]),
                             __fmul_rn(kt[q].x, vj[m]));
            x[1] = __fadd_rn(__fmul_rn(wt[q].y, x[1]),
                             __fmul_rn(kt[q].y, vj[m]));
            x[2] = __fadd_rn(__fmul_rn(wt[q].z, x[2]),
                             __fmul_rn(kt[q].z, vj[m]));
            x[3] = __fadd_rn(__fmul_rn(wt[q].w, x[3]),
                             __fmul_rn(kt[q].w, vj[m]));
          }
      }
      if (c == n_c - 1)
        store_state<CT, SEG, HD, CW>(state_out, s, sbase, g, j);
    }
    if (c < n_c) {
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

// Lets wkv6_scan_kernel<T, TW, HD, CH> take its dynamic shared memory
// (over the 48 KB default) and prefer shared memory over L1, once per
// device.
template <typename T, typename TW, int HD, int CH>
int allow_smem() {
  static std::atomic<unsigned long long> done{0};   // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute(wkv6_scan_kernel<T, TW, HD, CH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<T, TW, HD, CH>::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_scan_kernel<T, TW, HD, CH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit);
  return 0;
}

bool aligned16(const void* p) { return (unsigned long long)p % 16 == 0; }

template <typename T, typename TW, int HD, int CH>
int run(const void* r, const void* k, const void* v, const void* logw,
        const void* u, const void* state0, void* o, void* state_out,
        int n_b, int n_t, int n_h, cudaStream_t st) {
  using C = Cfg<T, TW, HD, CH>;
  const long long blocks = (long long)n_b * n_h * C::SPLIT;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int e = allow_smem<T, TW, HD, CH>();
  if (e) return e;
  const bool aligned = aligned16(r) && aligned16(k) && aligned16(v)
      && aligned16(logw);
  wkv6_scan_kernel<T, TW, HD, CH><<<(unsigned)blocks, C::THREADS, C::BYTES,
                                st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)logw, (const T*)u,
      (const float*)state0, (T*)o, (float*)state_out, n_t, n_h, aligned);
  return (int)cudaGetLastError();
}

// A call of at most TC_SHORT steps takes the instance with TC_SHORT-step
// chunks: a quarter of the shared memory, which a block pays for in its
// start-up at decode; the order, and so every bit, is the same.
template <typename T, typename TW, int HD>
int run_any(const void* r, const void* k, const void* v, const void* logw,
            const void* u, const void* state0, void* o, void* state_out,
            int n_b, int n_t, int n_h, cudaStream_t st) {
  return n_t <= TC_SHORT
      ? run<T, TW, HD, TC_SHORT>(r, k, v, logw, u, state0, o, state_out, n_b,
                                 n_t, n_h, st)
      : run<T, TW, HD, TC>(r, k, v, logw, u, state0, o, state_out, n_b, n_t,
                           n_h, st);
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* state0, void* o, void* state_out,
           int n_b, int n_t, int n_h, int hd, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return run_any<T, TW, 16>(r, k, v, logw, u, state0, o, state_out,
                                   n_b, n_t, n_h, st);
    case 32: return run_any<T, TW, 32>(r, k, v, logw, u, state0, o, state_out,
                                   n_b, n_t, n_h, st);
    case 64: return run_any<T, TW, 64>(r, k, v, logw, u, state0, o, state_out,
                                   n_b, n_t, n_h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TW, int HD>
int geometry(int* out) {
  using C = Cfg<T, TW, HD, TC>;
  out[0] = IS;
  out[1] = TC;
  out[2] = C::THREADS;
  out[3] = C::BYTES;
  int e = allow_smem<T, TW, HD, TC>();
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], wkv6_scan_kernel<T, TW, HD, TC>, C::THREADS, C::BYTES);
}

}  // namespace

// The kernel's geometry at head dim hd for bf16 r/k/v/u with f32 logw (the
// bf16 model's call): IS, TC, threads a block, dynamic shared bytes a
// block, resident blocks an SM, in that order. Returns a CUDA error code.
extern "C" int wkv6_scan_geometry(int hd, int* out) {
  switch (hd) {
    case 16: return geometry<__nv_bfloat16, float, 16>(out);
    case 32: return geometry<__nv_bfloat16, float, 32>(out);
    case 64: return geometry<__nv_bfloat16, float, 64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

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

// ----------------------------------------------------------------------
// The stripe entry.
// ----------------------------------------------------------------------

namespace {

template <int HD, int DK> struct StripeCfg {
  static_assert(DK <= HD, "a stripe of at most hd rows");
  static constexpr int SEG = IS < DK ? IS : DK;           // rows a segment
  static constexpr int G = DK / SEG;                      // segments
  static constexpr int NT = G * HD;                       // state threads
  static constexpr int THREADS = (NT + 31) / 32 * 32;
  static_assert(DK % SEG == 0, "whole segments");
};

template <typename T, typename TW, int HD, int DK>
__global__ void __launch_bounds__(StripeCfg<HD, DK>::THREADS)
wkv6_stripe_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const TW* __restrict__ logw,
                   const T* __restrict__ u, const float* __restrict__ state0,
                   float* __restrict__ part, float* __restrict__ beta_out,
                   float* __restrict__ state_out, int n_t, int n_h, int lo) {
  using C = StripeCfg<HD, DK>;
  constexpr int SEG = C::SEG, G = C::G, NT = C::NT, NB = C::THREADS;
  __shared__ float rs[HD], ks[HD], ws[DK], vs[HD], us[HD];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / n_h, h = bh - b * n_h;
  const int g = tid / HD, j = tid - g * HD;
  const bool holds = tid < NT;
  const long long row_stride = (long long)n_h * HD;        // one t
  const long long base = (long long)b * n_t * row_stride + (long long)h * HD;
  const long long sbase = (long long)bh * DK * HD;
  float s[SEG];
#pragma unroll
  for (int ii = 0; ii < SEG; ++ii)
    s[ii] = holds && state0 != nullptr
        ? state0[sbase + (long long)(g * SEG + ii) * HD + j]
        : 0.0f;
  for (int i = tid; i < HD; i += NB) us[i] = to_f32(u[h * HD + i]);
#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    const long long at = base + (long long)t * row_stride;
    for (int i = tid; i < HD; i += NB) {
      rs[i] = to_f32(r[at + i]);
      ks[i] = to_f32(k[at + i]);
      vs[i] = to_f32(v[at + i]);
    }
    for (int i = tid; i < DK; i += NB)    // the stripe's rows of w alone
      ws[i] = expf(to_f32(logw[at + lo + i]));
    __syncthreads();
    const long long bht = ((long long)b * n_t + t) * n_h + h;
    if (tid == 0) {                    // beta: i = 0..hd-1, ascending
      float acc = 0.0f;
#pragma unroll 1
      for (int i = 0; i < HD; ++i)
        acc = fma_free(acc, __fmul_rn(rs[i], us[i]), ks[i]);
      beta_out[bht] = acc;
    }
    if (holds) {
      const float* R = rs + lo + g * SEG;
      const float* W = ws + g * SEG;
      const float* K = ks + lo + g * SEG;
      float p = 0.0f;
#pragma unroll
      for (int ii = 0; ii < SEG; ++ii) p = fma_free(p, R[ii], s[ii]);
      part[(bht * G + g) * HD + j] = p;
      const float vj = vs[j];
#pragma unroll
      for (int ii = 0; ii < SEG; ++ii)
        s[ii] = __fadd_rn(__fmul_rn(W[ii], s[ii]), __fmul_rn(K[ii], vj));
    }
    __syncthreads();
  }
  if (holds) {
#pragma unroll
    for (int ii = 0; ii < SEG; ++ii)
      state_out[sbase + (long long)(g * SEG + ii) * HD + j] = s[ii];
  }
}

template <typename T, typename TW, int HD, int DK>
int run_stripe(const void* r, const void* k, const void* v, const void* logw,
               const void* u, const void* state0, void* part, void* beta,
               void* state_out, int n_b, int n_t, int n_h, int lo,
               cudaStream_t st) {
  const long long blocks = (long long)n_b * n_h;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  wkv6_stripe_kernel<T, TW, HD, DK>
      <<<(unsigned)blocks, StripeCfg<HD, DK>::THREADS, 0, st>>>(
          (const T*)r, (const T*)k, (const T*)v, (const TW*)logw,
          (const T*)u, (const float*)state0, (float*)part, (float*)beta,
          (float*)state_out, n_t, n_h, lo);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, int HD>
int stripe_rows(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* state0, void* part, void* beta,
                void* state_out, int n_b, int n_t, int n_h, int dk, int lo,
                cudaStream_t st) {
  switch (dk) {
#define WKV6_STRIPE_CASE(D)                                                  \
    case D:                                                                  \
      if (D <= HD)                                                           \
        return run_stripe<T, TW, HD, (D <= HD ? D : HD)>(                   \
            r, k, v, logw, u, state0, part, beta, state_out, n_b, n_t, n_h, \
            lo, st);                                                         \
      return (int)cudaErrorInvalidValue;
    WKV6_STRIPE_CASE(4)
    WKV6_STRIPE_CASE(8)
    WKV6_STRIPE_CASE(16)
    WKV6_STRIPE_CASE(32)
    WKV6_STRIPE_CASE(64)
#undef WKV6_STRIPE_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TW>
int launch_stripe(const void* r, const void* k, const void* v,
                  const void* logw, const void* u, const void* state0,
                  void* part, void* beta, void* state_out, int n_b, int n_t,
                  int n_h, int hd, int dk, int lo, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dk <= 0 || lo < 0 || lo % dk || lo + dk > hd)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return stripe_rows<T, TW, 16>(r, k, v, logw, u, state0, part,
                                           beta, state_out, n_b, n_t, n_h,
                                           dk, lo, st);
    case 32: return stripe_rows<T, TW, 32>(r, k, v, logw, u, state0, part,
                                           beta, state_out, n_b, n_t, n_h,
                                           dk, lo, st);
    case 64: return stripe_rows<T, TW, 64>(r, k, v, logw, u, state0, part,
                                           beta, state_out, n_b, n_t, n_h,
                                           dk, lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The stripe entry: r, k, v, u, logw (B, T, H, hd) / (H, hd) whole (of
// logw only the rows [lo, lo + dk) are read); state0 and state_out (B, H,
// dk, hd) f32 rows [lo, lo + dk); part (B, T, H, dk / min(IS, dk), hd) f32;
// beta (B, T, H) f32. dk in {4, 8, 16, 32, 64}, at most hd, lo a multiple
// of dk. Returns a CUDA error code.
extern "C" int wkv6_stripe_f32(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* state0, void* part, void* beta,
                               void* state_out, int n_b, int n_t, int n_h,
                               int hd, int dk, int lo, void* stream) {
  return launch_stripe<float, float>(r, k, v, logw, u, state0, part, beta,
                                     state_out, n_b, n_t, n_h, hd, dk, lo,
                                     stream);
}

extern "C" int wkv6_stripe_bf16(const void* r, const void* k, const void* v,
                                const void* logw, const void* u,
                                const void* state0, void* part, void* beta,
                                void* state_out, int n_b, int n_t, int n_h,
                                int hd, int dk, int lo, void* stream) {
  return launch_stripe<__nv_bfloat16, __nv_bfloat16>(
      r, k, v, logw, u, state0, part, beta, state_out, n_b, n_t, n_h, hd, dk,
      lo, stream);
}

extern "C" int wkv6_stripe_bf16_lwf32(const void* r, const void* k,
                                      const void* v, const void* logw,
                                      const void* u, const void* state0,
                                      void* part, void* beta,
                                      void* state_out, int n_b, int n_t,
                                      int n_h, int hd, int dk, int lo,
                                      void* stream) {
  return launch_stripe<__nv_bfloat16, float>(
      r, k, v, logw, u, state0, part, beta, state_out, n_b, n_t, n_h, hd, dk,
      lo, stream);
}
