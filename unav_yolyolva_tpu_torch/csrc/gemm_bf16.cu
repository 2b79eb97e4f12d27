// The bf16 policy's product of bf16.cuh alone (ops/gemm_tc.py:bf16_products),
// for testing and timing it by itself: `count` products in one launch.
#include "bf16.cuh"

constexpr int BG_PTRS = 6, BG_INTS = 10;

// Per product i: ptrs[6i..6i+5] = A, B, C, bias, rowmask, seqmul (the last
// three may be null); ints[10i..10i+9] = lda, ldb, ldc, M, N, K, taps (1,
// or 3: the k=3 conv loader on A, Kc = K / 3), seq (rows per sequence of
// the conv and of seqmul), act (BF16_ACT_*), raw; scales[i] (a bf16 value).
extern "C" int unav_gemm_bf16(int count, void* const* ptrs, const long* ints,
                              const float* scales, void* stream) {
  if (count < 1 || count > BG_MAX_BATCH) return (int)cudaErrorInvalidValue;
  Bf16Batch batch;
  for (int i = 0; i < count; ++i) {
    void* const* p = ptrs + BG_PTRS * i;
    const long* n = ints + BG_INTS * i;
    Bf16Gemm& a = batch.g[i];
    a = bf16_gemm((const bf16*)p[0], n[0], (const bf16*)p[1], n[1], p[2], n[2],
                  (const bf16*)p[3], (const unsigned char*)p[4], (int)n[3], (int)n[4], (int)n[5]);
    a.seqmul = (const float*)p[5];
    a.taps = (int)n[6];
    a.seq = a.mseq = (int)n[7];
    a.act = (int)n[8];
    a.raw = (int)n[9];
    a.scale = scales[i];
    if (a.taps == 3) a.Kc = a.K / 3;
    if (a.act != BF16_ACT_NONE && a.act != BF16_ACT_GELU) return (int)cudaErrorInvalidValue;
  }
  return launch_gemm_bf16(batch, count, (cudaStream_t)stream);
}
