// launch_gemm, which runs every product of the port without an epilogue on
// the tensor cores (gemm_tc.cuh: A.B^T, A.B and A^T.B; operand description
// GemmArgs there), and the FFMA product of the TransformerBlock's MLP, whose
// GemmEpi epilogue gemm_tc.cuh does not take:
//
//   C[m, n] = act(sum_k A(m, k) * B(n, k) + bias[n]) * scale * rowmask[m]
//             * seqmul[m / seq, n] (+ C[m, n] when beta)
//   act none, exact erf GELU, or the product with GELU'(aux[m, n]).
//
// Bound of the epilogue products: FFMA, the fp32 non-tensor peak of the
// card (ROADMAP Queue 2b: the next redesign). Shared-memory tiles of BM x 8
// and BN x 8, 256 threads, each holding a TM x TN block of the output in
// registers; one launch a product.
#pragma once

#include "gemm_tc.cuh"

// The MLP products' epilogue, a kernel parameter of its own: kept out of
// GemmArgs, whose size every other product's kernel pays for in registers.
constexpr int GEMM_ACT_NONE = 0, GEMM_ACT_GELU = 1, GEMM_ACT_GELU_GRAD = 2;
struct GemmEpi {
  int act;                      // GEMM_ACT_*
  const float* aux; long ldaux; // GELU' input (GEMM_ACT_GELU_GRAD)
  const float* seqmul; int seq; // (M / seq, N) column multiplier, or nullptr
};

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float u) {
  return 0.5f * (1.f + erff(u * 0.70710678118654752f)) +
         u * 0.39894228040143268f * expf(-0.5f * u * u);
}

// The GemmEpi epilogue of one output element.
__device__ __forceinline__ void gemm_store_epi(const GemmArgs& p, const GemmEpi& e, int m,
                                               int n, float v) {
  if (p.bias) v += p.bias[n];
  if (e.act == GEMM_ACT_GELU) v = gelu_erf(v);
  else if (e.act == GEMM_ACT_GELU_GRAD) v *= gelu_erf_grad(e.aux[(long)m * e.ldaux + n]);
  v = v * p.scale * (p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f);
  if (e.seqmul) v *= e.seqmul[(long)(m / e.seq) * p.N + n];
  float* c = p.C + (long)m * p.ldc + n;
  *c = p.beta ? *c + v : v;
}

template <bool TB>
__device__ __forceinline__ float gemm_load_a(const GemmArgs& p, int m, int k) {
  if (m >= p.M || k >= p.K) return 0.f;
  if (p.taps == 1) return p.A[(long)m * p.lda + k];
  const int tap = k / p.Kc, c = k - tap * p.Kc;
  const int dt = TB ? p.tapdir * (tap - 1) : tap - 1;
  const int t = m % p.seq + dt;
  if (t < 0 || t >= p.seq) return 0.f;
  return p.A[(long)(m + dt) * p.lda + c];
}

template <bool TB>
__device__ __forceinline__ float gemm_load_b(const GemmArgs& p, int n, int k) {
  if (n >= p.N || k >= p.K) return 0.f;
  return TB ? p.B[(long)k * p.ldb + n] : p.B[(long)n * p.ldb + k];
}

// Rows/columns of a thread's TM x TN block come in groups of 4 spaced 64
// apart, so that a quarter warp's float4 shared-memory reads are contiguous.
// TB: B stored (K, N) (an input grad) rather than (N, K). The product comes
// as a batch of one (grid z = 1), the parameter layout of the tensor-core
// kernels.
template <int TM, int TN, bool TB>
__global__ void __launch_bounds__(256) gemm_epi_kernel(const GemmBatch batch, const GemmEpi epi) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = 8;
  const GemmArgs p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // neighbouring threads read neighbouring addresses: along k for a
    // row-major operand, along n for a transposed one
#pragma unroll
    for (int i = 0; i < BM * BK / 256; ++i) {
      const int e = tid + i * 256, r = e / BK, kk = e % BK;
      As[kk][r] = gemm_load_a<TB>(p, m0 + r, k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 256; ++i) {
      const int e = tid + i * 256;
      const int r = TB ? e % BN : e / BK, kk = TB ? e / BN : e % BK;
      Bs[kk][r] = gemm_load_b<TB>(p, n0 + r, k0 + kk);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][g * 64 + ty * 4]);
        a[g * 4 + 0] = v.x; a[g * 4 + 1] = v.y; a[g * 4 + 2] = v.z; a[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][g * 64 + tx * 4]);
        b[g * 4 + 0] = v.x; b[g * 4 + 1] = v.y; b[g * 4 + 2] = v.z; b[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (n < p.N) gemm_store_epi(p, epi, m, n, acc[i][j]);
    }
  }
}

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

// One A.B^T or A.B product with the GemmEpi epilogue (an A^T.B is refused),
// on FFMA: 8x8 outputs a thread for large products, 4x4 for small ones so
// that they still fill the SMs. Only the libraries that call it compile
// these kernels, whose unrolled GELU epilogues are slow to build.
static int launch_gemm_epi(const GemmArgs& a, const GemmEpi& epi, cudaStream_t stream) {
  if (a.transA || a.kmask || a.btaps != 1) return (int)cudaErrorInvalidValue;
  GemmBatch one;
  one.g[0] = a;
  const bool big = (long)ceil_div(a.M, 128) * ceil_div(a.N, 128) >= 2 * 132;
  const int bm = big ? 128 : 64;
  const dim3 grid(ceil_div(a.N, bm), ceil_div(a.M, bm));
  if (big && a.transB) gemm_epi_kernel<8, 8, true><<<grid, 256, 0, stream>>>(one, epi);
  else if (big) gemm_epi_kernel<8, 8, false><<<grid, 256, 0, stream>>>(one, epi);
  else if (a.transB) gemm_epi_kernel<4, 4, true><<<grid, 256, 0, stream>>>(one, epi);
  else gemm_epi_kernel<4, 4, false><<<grid, 256, 0, stream>>>(one, epi);
  UNAV_RETURN_IF_ERROR();
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
