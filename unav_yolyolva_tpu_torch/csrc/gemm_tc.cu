// The tensor-core fp32 product of gemm_tc.cuh alone (ops/gemm_tc.py), for
// testing and timing it by itself: `count` products in one launch, as
// launch_gemm batches them.
#include "gemm.cuh"

// Per product i: ptrs[5i..5i+4] = A, B, C, bias (or null), rowmask (or
// null); ints[8i..8i+7] = lda, ldb, ldc, M, N, K, taps (1 or 3: the k=3
// conv loader, Kc = K / 3), seq; scales[i].
extern "C" int unav_gemm_tc(int count, void* const* ptrs, const long* ints,
                            const float* scales, void* stream) {
  if (count < 1 || count > GEMM_MAX_BATCH) return (int)cudaErrorInvalidValue;
  GemmBatch batch;
  for (int i = 0; i < count; ++i) {
    void* const* p = ptrs + 5 * i;
    const long* n = ints + 8 * i;
    GemmArgs& a = batch.g[i];
    a = gemm_args((const float*)p[0], n[0], (const float*)p[1], n[1], (float*)p[2], n[2],
                  (const float*)p[3], (const unsigned char*)p[4], scales[i], (int)n[3],
                  (int)n[4], (int)n[5]);
    if (n[6] == 3) {
      a.taps = 3; a.Kc = (int)(n[5] / 3); a.seq = (int)n[7];
    } else if (n[6] != 1) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return launch_gemm_tc(batch, count, (cudaStream_t)stream);
}
