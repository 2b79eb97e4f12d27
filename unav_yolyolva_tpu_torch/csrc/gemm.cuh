// The port's product helpers over the tensor-core kernels of gemm_tc.cuh:
// launch_gemm batches products of any of the three layouts (A.B^T, A.B,
// A^T.B; operand description GemmArgs there), and gemm_nn / gemm_wgrad
// describe the backward's input and weight grads. Every product of the
// port runs on gemm_tc.cuh: these without an epilogue, the TransformerBlock
// MLP's with its GemmEpi epilogue through launch_gemm_tc_epi.
#pragma once

#include "gemm_tc.cuh"

// Launch `count` independent products (count <= GEMM_MAX_BATCH) on the
// tensor cores (gemm_tc.cuh): one grid for each operand layout present, in
// the order A.B^T, A.B, A^T.B. A^T.B products (weight grads) split K by
// their own shape into `part` (gemm_splitk_floats of the largest).
static int launch_gemm(const GemmBatch& batch, int count, cudaStream_t stream,
                       float* part = nullptr, long part_floats = 0) {
  for (int layout = 0; layout < 3; ++layout) {
    GemmBatch sub;
    int n = 0;
    for (int i = 0; i < count; ++i) {
      const GemmArgs& p = batch.g[i];
      if ((p.transA ? 2 : p.transB ? 1 : 0) == layout) sub.g[n++] = p;
    }
    if (!n) continue;
    const int rc = launch_gemm_tc(sub, n, stream, part, part_floats);
    if (rc) return rc;
  }
  return 0;
}

// C (ldc) = A (lda) . B with B stored (K, N) row-major (ldb): an input grad.
static GemmArgs gemm_nn(const float* A, long lda, const float* B, long ldb, float* C,
                        long ldc, const unsigned char* rowmask, int M, int N, int K) {
  GemmArgs a = gemm_args(A, lda, B, ldb, C, ldc, nullptr, rowmask, 1.f, M, N, K);
  a.transB = 1;
  return a;
}

// C (M, N) = A^T . B with A stored (K, M) and B stored (K, N), the K rows
// optionally masked: a weight grad summed over K = R*T rows.
static GemmArgs gemm_wgrad(const float* A, long lda, const float* B, long ldb, float* C,
                           const unsigned char* kmask, int M, int N, int K) {
  GemmArgs a = gemm_args(A, lda, B, ldb, C, N, nullptr, nullptr, 1.f, M, N, K);
  a.transA = 1; a.transB = 1; a.kmask = kmask;
  return a;
}
