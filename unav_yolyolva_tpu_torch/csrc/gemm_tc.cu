// The tensor-core fp32 product of gemm_tc.cuh alone (ops/gemm_tc.py), for
// testing and timing it by itself: `count` products of any of the three
// layouts in one call, batched as launch_gemm batches them, or one product
// with the GemmEpi epilogue (launch_gemm_tc_epi).
#include "gemm.cuh"

constexpr int TC_PTRS = 9, TC_INTS = 17;

// Per product i: ptrs[9i..9i+8] = A, B, C, bias, rowmask, kmask, aux,
// seqmul, pre (all but the first three may be null); ints[17i..17i+16] =
// lda, ldb, ldc, M, N, K, taps (1, or 3: the k=3 conv loader on A, Kc =
// K / 3), seq (rows per sequence of the conv and of seqmul), tapdir (+1 or
// -1), btaps (1, or 3: the conv loader on B's n index, Kc = N / 3),
// transA, transB, beta, epi (1: the epilogue kernel, count 1), act
// (GEMM_ACT_*), ldaux, ldpre; scales[i]. part: split-K scratch of
// part_floats floats (gemm_splitk_floats of the largest weight grad), or
// null without one.
extern "C" int unav_gemm_tc(int count, void* const* ptrs, const long* ints,
                            const float* scales, float* part, long part_floats, void* stream) {
  if (count < 1 || count > GEMM_MAX_BATCH) return (int)cudaErrorInvalidValue;
  GemmBatch batch;
  GemmEpi epi{};
  bool with_epi = false;
  for (int i = 0; i < count; ++i) {
    void* const* p = ptrs + TC_PTRS * i;
    const long* n = ints + TC_INTS * i;
    GemmArgs& a = batch.g[i];
    a = gemm_args((const float*)p[0], n[0], (const float*)p[1], n[1], (float*)p[2], n[2],
                  (const float*)p[3], (const unsigned char*)p[4], scales[i], (int)n[3],
                  (int)n[4], (int)n[5]);
    a.kmask = (const unsigned char*)p[5];
    a.taps = (int)n[6]; a.seq = (int)n[7]; a.tapdir = (int)n[8]; a.btaps = (int)n[9];
    a.transA = (int)n[10]; a.transB = (int)n[11]; a.beta = (int)n[12];
    if ((a.taps != 1 && a.taps != 3) || (a.btaps != 1 && a.btaps != 3) ||
        (a.tapdir != 1 && a.tapdir != -1) || (a.taps == 3 && a.btaps == 3))
      return (int)cudaErrorInvalidValue;
    if (a.taps == 3) a.Kc = a.K / 3;
    if (a.btaps == 3) a.Kc = a.N / 3;
    if (n[13]) {
      if (count != 1) return (int)cudaErrorInvalidValue;
      with_epi = true;
      epi = GemmEpi{(int)n[14], (const float*)p[6], n[15], (const float*)p[7], a.seq,
                    (float*)p[8], n[16]};
    }
  }
  if (with_epi) return launch_gemm_tc_epi(batch.g[0], epi, (cudaStream_t)stream);
  return launch_gemm(batch, count, (cudaStream_t)stream, part, part_floats);
}

// K per split of a weight grad of shape (M, N, K) (gemm_split_chunk)
extern "C" int unav_gemm_split_chunk(int M, int N, int K) { return gemm_split_chunk(M, N, K); }
