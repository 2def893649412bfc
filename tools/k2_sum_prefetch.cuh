// One staged chunk into the thread's RT x CT sums, k ascending, with the
// shared-memory loads of group g + 1 issued before the arithmetic of group
// g (two register buffers, indexed by constants once unrolled), so one
// warp a scheduler waits less on them.
template <class C, typename T>
__device__ __forceinline__ void sum_chunk(const T* s, const float* w, int tr,
                                          int tc,
                                          float (&acc)[C::RT][C::CT]) {
  constexpr int LD = spike_ld<C, T>();
  constexpr int G = C::KC / 4;
  float sv[2][C::RT][4];
  float wv[2][4][C::CT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i) load4(s + (tr + i * C::TR) * LD, sv[0][i]);
#pragma unroll
  for (int j = 0; j < 4; ++j) loadw<C::CT>(w + j * C::COLS + tc * C::CT,
                                           wv[0][j]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g + 1 < G) {
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
        load4(s + (tr + i * C::TR) * LD + 4 * (g + 1), sv[(g + 1) & 1][i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        loadw<C::CT>(w + (4 * (g + 1) + j) * C::COLS + tc * C::CT,
                     wv[(g + 1) & 1][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
#pragma unroll
        for (int c = 0; c < C::CT; ++c)
          acc[i][c] = __fadd_rn(acc[i][c],
                                __fmul_rn(sv[g & 1][i][j], wv[g & 1][j][c]));
  }
}

