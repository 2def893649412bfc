// K3: packed-ternary matmul, out = (x @ unpack2bit(w_packed)) * scale.
//
// Replaces ternary_matmul_pallas (src/repro/kernels/ternary_matmul.py:92),
// which streams 2-bit packed weight tiles from HBM into VMEM, unpacks them
// there and feeds the MXU, adding one K tile's product at a time into an
// f32 accumulator in ascending tile order.
//
// Layout (as in the TPU kernel):
//   x        (M, K)    f32 or bf16, row-major
//   w_packed (K/4, N)  uint8; byte (j, n) holds k = 4j..4j+3 in bits
//                      [2i, 2i+2) as value + 1 (field 3 decodes to +2)
//   scale    (N,)      f32, applied once after the sum
//   out      (M, N)    x's dtype
//
// The sum's order is part of the function, and it mirrors the TPU
// kernel's K tiling: K is cut into segments of KS = 512 k (the last may
// be short); a segment's partial is an f32 sum in ascending k from +0;
// the partials are added into an accumulator (from +0) in ascending
// segment order; the accumulator is multiplied by the scale once. Each
// multiply and add is rounded on its own (__fmul_rn/__fadd_rn, and the
// library is built with -fmad=false). The product x * q is exact for
// q in {-1, 0, +1, +2}, and a +-0 term leaves a sum that starts at +0
// unchanged, so zero padding is exact. ternary_matmul_plain in
// kernels/ternary_matmul.py repeats this arithmetic operation for
// operation, and a row never depends on the rows around it.
//
// What bounds it on the H100. Bytes: the LM decode products (M = 4,
// K x N = 4096 x 4096 ... 14,336 x 4096) read 4-15 MB of packed weights,
// 1.3-4.4 us at 3.35 TB/s. Operations: a term costs an f32 multiply and
// add, a weight byte ~11 instructions to unpack (shared by the R rows a
// thread holds), and every term needs its x in a register, loaded from
// shared memory: ~3 instructions a term at R = 4. So the kernel is bound
// by instruction issue at decode, where 131,072 sums of 512 terms (K = N
// = 4096) give two warps a scheduler and part of each warp's latency
// stays unhidden (tools/k3_probe.py times the variants), and by latency
// where there are fewer (the frame fc1: 16,384 sums). Its design:
//
//  * A warp owns a tile of R rows (R = 1, 2, 4 or 8, chosen by the
//    wrapper) by 32 columns, a lane one column of it, so one unpacked
//    weight feeds R independent sums that hide the add latency.
//  * Each warp stages its own chunks of KC = 64 k (x rows and packed
//    weight rows, by 16-byte cp.async, or element loads when a tensor is
//    not 16-byte aligned) NSTAGE deep and reads only them, so the main
//    loop has no block-wide barrier. The chunk's weight bytes, and x
//    XAHEAD / R groups of 4 k ahead, are loaded into registers before the
//    adds that need them. A chunk never crosses a segment end (KS is a
//    multiple of KC); ragged M, N and K are zero filled. A bf16 x chunk
//    is widened to f32 in shared memory once, before the lanes read it.
//  * Split path (up to 64 rows: decode, prompts, the frame fc1): the
//    warps of a block share one tile and take `group` consecutive
//    segments each; each segment's partial goes to shared memory, and
//    after one barrier the first warp adds the tile's partials in
//    ascending segment order and applies the scale. One launch, and
//    nothing leaves the block.
//  * Serial path (more rows: prefill): a block holds SERIAL_WARPS tiles,
//    and each warp walks all segments of its tile, folding each partial
//    into a register accumulator.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// k per segment. kernels/ternary_matmul.py names the same constant KS:
// the two must agree, or the kernel and its plain version part bits.
constexpr int KS = 512;
constexpr int KC = 64;           // k per shared-memory chunk
constexpr int CPS = KS / KC;     // chunks per segment
constexpr int NSTAGE = 4;
constexpr int XAHEAD = 16;       // x float4 loads a lane keeps in flight
constexpr int COLS = 32;         // columns of a warp's tile, one a lane
constexpr int MAX_WARPS = 16;    // warps of a split-path block
constexpr int SERIAL_WARPS = 4;  // tiles (warps) of a serial-path block
// kernels/ternary_matmul.py plans the launch with its own copies of KS,
// COLS, MAX_WARPS and SERIAL_WARPS, and checks them against
// ternary_matmul_geometry below when it loads this library.
static_assert(KS % KC == 0, "a chunk must never cross a segment end");
static_assert(KC / 4 * 2 == 32, "one weight vector a lane a chunk");

// Row strides in shared memory, in elements: KC plus 16 bytes, which keeps
// rows 16-byte aligned for cp.async and float4 loads.
template <typename T> __host__ __device__ constexpr int ld_x() {
  return KC + 16 / (int)sizeof(T);
}
constexpr int LDF = KC + 4;      // the f32 copy of a bf16 chunk

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Field i of a weight byte as the float value - 1 in {-1, 0, +1, +2}:
// 2**23 + field, minus 2**23 + 1, both exact. The bits come from one
// lop3, (b >> 2i) & 3 | 0x4B000000 with the constant in a register
// (left to the compiler, the mask and the or take two).
__device__ __forceinline__ float field(unsigned b, int i) {
  unsigned bits;
  asm("lop3.b32 %0, %1, 3, %2, 0xEA;"
      : "=r"(bits) : "r"(b >> (2 * i)), "r"(0x4B000000u));
  return __fadd_rn(__uint_as_float(bits), -8388609.0f);
}

// A warp's staging area for one chunk: the x tile (R rows of ld_x) then
// the weight tile (KC/4 byte rows of COLS).
template <typename T, int R>
__host__ __device__ constexpr int stage_bytes() {
  return (R * ld_x<T>() * (int)sizeof(T) + (KC / 4) * COLS + 15) / 16 * 16;
}
template <typename T, int R>
__host__ __device__ constexpr int warp_bytes() {
  return NSTAGE * stage_bytes<T, R>() + (sizeof(T) == 2 ? R * LDF * 4 : 0);
}

struct Shape {
  int m, k, n;
  int segs, group;   // segments of K; segments a warp (>= segs: serial)
  bool xvec, wvec;   // 16-byte copies allowed
};

// Stage chunk c (k from c * KC) of the warp's tile, rows m0.. and columns
// n0.., by the warp's 32 lanes.
template <typename T, int R>
__device__ __forceinline__ void stage(unsigned char* dst, const T* x,
                                      const uint8_t* w, const Shape& s,
                                      int m0, int n0, int c, int lane) {
  constexpr int EPV = 16 / sizeof(T);     // elements a 16-byte vector
  constexpr int VPR = KC / EPV;           // vectors a row
  const int k0 = c * KC;
  T* xs = reinterpret_cast<T*>(dst);
#pragma unroll
  for (int v = lane; v < R * VPR; v += 32) {
    const int r = v / VPR, kk = (v % VPR) * EPV;
    const int row = m0 + r, kg = k0 + kk;
    T* d = xs + r * ld_x<T>() + kk;
    const T* src = x + (long long)row * s.k + kg;
    if (s.xvec) {
      const int left = s.k - kg;
      const int bytes = row < s.m && left > 0
          ? (left < EPV ? left : EPV) * (int)sizeof(T) : 0;
      cp_async16(d, bytes ? (const void*)src : (const void*)x, bytes);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        d[e] = row < s.m && kg + e < s.k ? src[e] : from_f32<T>(0.0f);
    }
  }
  // KC/4 byte rows of COLS = 32 bytes: a lane copies half a row.
  const int jj = lane / 2, cc = (lane % 2) * 16;
  const int j = k0 / 4 + jj, col = n0 + cc;
  uint8_t* d = dst + R * ld_x<T>() * sizeof(T) + jj * COLS + cc;
  const uint8_t* src = w + (long long)j * s.n + col;
  const bool j_ok = j < s.k / 4;
  if (s.wvec) {
    const int left = s.n - col;
    const int bytes = j_ok && left > 0 ? (left < 16 ? left : 16) : 0;
    cp_async16(d, bytes ? (const void*)src : (const void*)w, bytes);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      d[e] = j_ok && col + e < s.n ? src[e] : (uint8_t)0;
  }
}

// One staged chunk into part: the lane's column of KC/4 weight byte rows
// (wc, row stride COLS) against its R rows of x (xr, row stride ldx). The
// chunk's weight bytes are read first, and x P groups of 4 k ahead of
// the adds that use it.
template <int R>
__device__ __forceinline__ void sum_chunk(const uint8_t* wc, const float* xr,
                                          int ldx, float (&part)[R]) {
  constexpr int J = KC / 4;
  constexpr int P = XAHEAD / R > 1 ? XAHEAD / R : 1;
  unsigned b[J];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) b[jj] = wc[jj * COLS];
  float4 xq[P][R];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
      xq[p][r] = *reinterpret_cast<const float4*>(xr + r * ldx + 4 * p);
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    float4 xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xv[r] = xq[jj % P][r];
      if (jj + P < J)
        xq[jj % P][r] = *reinterpret_cast<const float4*>(
            xr + r * ldx + 4 * (jj + P));
    }
    const float q0 = field(b[jj], 0), q1 = field(b[jj], 1),
                q2 = field(b[jj], 2), q3 = field(b[jj], 3);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      part[r] = __fadd_rn(part[r], __fmul_rn(xv[r].x, q0));
      part[r] = __fadd_rn(part[r], __fmul_rn(xv[r].y, q1));
      part[r] = __fadd_rn(part[r], __fmul_rn(xv[r].z, q2));
      part[r] = __fadd_rn(part[r], __fmul_rn(xv[r].w, q3));
    }
  }
}

// Split path: block b owns tile b, and its warp g sums segments
// [g * group, (g + 1) * group). Serial path: warp w of block b owns tile
// b * SERIAL_WARPS + w and walks every segment.
template <typename T, int R>
__global__ void __launch_bounds__(32 * MAX_WARPS)
ternary_matmul_kernel(const T* __restrict__ x,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ out,
                      Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool split = s.group < s.segs;
  const int tile = split ? blockIdx.x : blockIdx.x * SERIAL_WARPS + warp;
  const int col_tiles = (s.n + COLS - 1) / COLS;
  const int m0 = (tile / col_tiles) * R;
  const int n0 = (tile % col_tiles) * COLS;
  const int nchunks = (s.k + KC - 1) / KC;
  const int c_begin = split ? warp * s.group * CPS : 0;
  const int c_end = split ? min(c_begin + s.group * CPS, nchunks) : nchunks;
  const int nc = c_end - c_begin;
  unsigned char* mine = smem + warp * warp_bytes<T, R>();
  float* xf = reinterpret_cast<float*>(mine + NSTAGE * stage_bytes<T, R>());
  // The split path's partials, (segment, r, lane), after the warps'
  // staging areas.
  float* parts = reinterpret_cast<float*>(
      smem + (blockDim.x / 32) * warp_bytes<T, R>());
  const bool live = m0 < s.m;   // a serial block's last warps may idle

  float acc[R], part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = part[r] = 0.0f;

  if (live) {
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) {
      if (i < nc)
        stage<T, R>(mine + i * stage_bytes<T, R>(), x, w, s, m0, n0,
                    c_begin + i, lane);
      cp_async_commit();
    }
    for (int i = 0; i < nc; ++i) {
      cp_async_wait<NSTAGE - 2>();
      __syncwarp();   // chunk i is in; every lane is done with i - 1
      const int nxt = i + NSTAGE - 1;
      if (nxt < nc)
        stage<T, R>(mine + (nxt % NSTAGE) * stage_bytes<T, R>(), x, w, s,
                    m0, n0, c_begin + nxt, lane);
      cp_async_commit();
      const unsigned char* st = mine + (i % NSTAGE) * stage_bytes<T, R>();
      const float* xr;
      int ldx;
      if constexpr (sizeof(T) == 2) {
        // Widen the bf16 chunk to f32 once, for every lane to read.
        const T* xs = reinterpret_cast<const T*>(st);
#pragma unroll
        for (int e = lane; e < R * (KC / 2); e += 32) {
          const int r = e / (KC / 2), kk = 2 * (e % (KC / 2));
          const unsigned u =
              *reinterpret_cast<const unsigned*>(xs + r * ld_x<T>() + kk);
          *reinterpret_cast<float2*>(xf + r * LDF + kk) =
              make_float2(__uint_as_float(u << 16),
                          __uint_as_float(u & 0xffff0000u));
        }
        __syncwarp();
        xr = xf;
        ldx = LDF;
      } else {
        xr = reinterpret_cast<const float*>(st);
        ldx = ld_x<T>();
      }
      sum_chunk<R>(st + R * ld_x<T>() * sizeof(T) + lane, xr, ldx, part);
      const int c = c_begin + i;
      if ((c + 1) % CPS == 0 || c + 1 == nchunks) {   // a segment ends
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (split)
            parts[((c / CPS) * R + r) * 32 + lane] = part[r];
          else
            acc[r] = __fadd_rn(acc[r], part[r]);
          part[r] = 0.0f;
        }
      }
    }
    cp_async_wait<0>();
  }

  if (split) {
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int seg = 0; seg < s.segs; ++seg)
        acc[r] = __fadd_rn(acc[r], parts[(seg * R + r) * 32 + lane]);
  }
  const int col = n0 + lane;
  if (!live || col >= s.n) return;
  const float sc = scale[col];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m0 + r < s.m)
      out[(long long)(m0 + r) * s.n + col] =
          from_f32<T>(__fmul_rn(acc[r], sc));
}

bool aligned16(const void* p, long long row_bytes) {
  return (unsigned long long)p % 16 == 0 && row_bytes % 16 == 0;
}

// Lets ternary_matmul_kernel<T, R> take as much dynamic shared memory as
// the current device allows a block. The attribute is a limit, not what a
// launch takes, so it is set once per device and instance rather than on
// every launch with that launch's size. A launch past the limit fails.
template <typename T, int R>
int allow_smem() {
  static std::atomic<unsigned long long> done{0};   // a bit a device
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ternary_matmul_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit);
  return 0;
}

template <typename T, int R>
int run(const void* x, const void* w, const void* scale, void* out,
        const Shape& s, cudaStream_t stream) {
  const long long tiles = (long long)((s.m + R - 1) / R)
      * ((s.n + COLS - 1) / COLS);
  const bool split = s.group < s.segs;
  const int warps = split ? (s.segs + s.group - 1) / s.group : SERIAL_WARPS;
  const long long blocks =
      split ? tiles : (tiles + SERIAL_WARPS - 1) / SERIAL_WARPS;
  const int smem =
      warps * warp_bytes<T, R>() + (split ? s.segs * R * 32 * 4 : 0);
  if (warps > MAX_WARPS || blocks > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int limit = allow_smem<T, R>();
  if (limit) return limit;
  ternary_matmul_kernel<T, R>
      <<<(unsigned)blocks, 32 * warps, smem, stream>>>(
          (const T*)x, (const uint8_t*)w, (const float*)scale, (T*)out, s);
  return (int)cudaGetLastError();
}

// r rows a thread (a warp's tile is r x 32); group segments a warp, the
// split path when group is below the number of segments.
template <typename T>
int launch(const void* x, const void* w, const void* scale, void* out,
           int m, int k, int n, int r, int group, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (group < 1) return (int)cudaErrorInvalidValue;
  const Shape s{m, k, n, k > 0 ? (k + KS - 1) / KS : 1, group,
                aligned16(x, (long long)k * sizeof(T)), aligned16(w, n)};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: return run<T, 1>(x, w, scale, out, s, st);
    case 2: return run<T, 2>(x, w, scale, out, s, st);
    case 4: return run<T, 4>(x, w, scale, out, s, st);
    case 8: return run<T, 8>(x, w, scale, out, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The constants the wrapper plans launches with: KS, COLS, MAX_WARPS,
// SERIAL_WARPS, in that order.
extern "C" void ternary_matmul_geometry(int* out) {
  out[0] = KS;
  out[1] = COLS;
  out[2] = MAX_WARPS;
  out[3] = SERIAL_WARPS;
}

extern "C" int ternary_matmul_f32(const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, int r, int group, void* stream) {
  return launch<float>(x, w, scale, out, m, k, n, r, group, stream);
}

extern "C" int ternary_matmul_bf16(const void* x, const void* w,
                                   const void* scale, void* out, int m,
                                   int k, int n, int r, int group,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, out, m, k, n, r, group, stream);
}
