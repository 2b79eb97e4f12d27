// Plain tiled fp32 GEMM shared by the MHCA and CSP kernels.
//
//   C[m, n] = epilogue( sum_k A[m, k] * B[n, k] )      (B in torch Linear layout)
//   epilogue: (acc + bias[n]) * scale * rowmask[m]
//
// A and C are addressed with a row stride, so a product can read from and
// write straight into a column slice of a wider buffer (the CSP concat).
// With taps == 3 the A loader is a k=3 "same" convolution over time written
// as one product of depth 3*Kc: k = tap * Kc + c reads A at row m + tap - 1,
// and zero outside the sequence (rows are (sequence, t) with t = m % seq).
//
// Bound: FFMA only, so the fp32 non-tensor peak of the card. Shared-memory
// tiles of BM x 8 and BN x 8, 256 threads, each holding a TM x TN block of
// the output in registers (8x8 for large products, 4x4 for small ones so
// that the small pyramid levels still fill the SMs). No double buffering,
// no tensor cores: making it fast (wgmma, TMA, bf16) is later work.
#pragma once

#include "common.cuh"

struct GemmArgs {
  const float* A; long lda;
  const float* B; long ldb;
  float* C; long ldc;
  const float* bias;            // (N) or nullptr
  const unsigned char* rowmask; // (M) or nullptr
  float scale;
  int M, N, K;
  int taps;                     // 1, or 3 for the k=3 conv loader
  int Kc;                       // channels per tap (taps == 3)
  int seq;                      // sequence length (taps == 3)
};

constexpr int GEMM_MAX_BATCH = 3;
struct GemmBatch { GemmArgs g[GEMM_MAX_BATCH]; };

__device__ __forceinline__ float gemm_load_a(const GemmArgs& p, int m, int k) {
  if (m >= p.M || k >= p.K) return 0.f;
  if (p.taps == 1) return p.A[(long)m * p.lda + k];
  const int tap = k / p.Kc, c = k - tap * p.Kc;
  const int t = m % p.seq + tap - 1;
  if (t < 0 || t >= p.seq) return 0.f;
  return p.A[(long)(m + tap - 1) * p.lda + c];
}

// Rows/columns of a thread's TM x TN block come in groups of 4 spaced 64
// apart, so that a quarter warp's float4 shared-memory reads are contiguous.
template <int TM, int TN>
__global__ void __launch_bounds__(256) gemm_tn_kernel(const GemmBatch batch) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = 8;
  const GemmArgs p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;

  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / 256; ++i) {
      const int e = tid + i * 256, r = e / BK, kk = e % BK;
      As[kk][r] = gemm_load_a(p, m0 + r, k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 256; ++i) {
      const int e = tid + i * 256, r = e / BK, kk = e % BK;
      const int n = n0 + r, k = k0 + kk;
      Bs[kk][r] = (n < p.N && k < p.K) ? p.B[(long)n * p.ldb + k] : 0.f;
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
    const float mk = p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f;
    float* crow = p.C + (long)m * p.ldc;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (p.bias) v += p.bias[n];
      crow[n] = v * p.scale * mk;
    }
  }
}

// Launch `count` independent products (count <= GEMM_MAX_BATCH) as one grid.
static int launch_gemm(const GemmBatch& batch, int count, cudaStream_t stream) {
  long maxM = 0, maxN = 0;
  for (int i = 0; i < count; ++i) {
    if (batch.g[i].M > maxM) maxM = batch.g[i].M;
    if (batch.g[i].N > maxN) maxN = batch.g[i].N;
  }
  const long big_tiles = (long)ceil_div(maxM, 128) * ceil_div(maxN, 128) * count;
  if (big_tiles >= 2 * 132) {
    dim3 grid(ceil_div(maxN, 128), ceil_div(maxM, 128), count);
    gemm_tn_kernel<8, 8><<<grid, 256, 0, stream>>>(batch);
  } else {
    dim3 grid(ceil_div(maxN, 64), ceil_div(maxM, 64), count);
    gemm_tn_kernel<4, 4><<<grid, 256, 0, stream>>>(batch);
  }
  UNAV_RETURN_IF_ERROR();
  return 0;
}

static GemmArgs gemm_args(const float* A, long lda, const float* B, long ldb,
                          float* C, long ldc, const float* bias,
                          const unsigned char* rowmask, float scale,
                          int M, int N, int K) {
  GemmArgs a;
  a.A = A; a.lda = lda; a.B = B; a.ldb = ldb; a.C = C; a.ldc = ldc;
  a.bias = bias; a.rowmask = rowmask; a.scale = scale;
  a.M = M; a.N = N; a.K = K; a.taps = 1; a.Kc = K; a.seq = 1;
  return a;
}
