// The port's products other than the plain forward layout: a tiled fp32
// FFMA GEMM for A.B (input grads), A^T.B (weight grads, split-K) and the
// products with a GemmEpi epilogue (the TransformerBlock's MLP), and
// launch_gemm, which sends every A.B^T product without an epilogue to the
// tensor-core kernel of gemm_tc.cuh (operand description: GemmArgs there).
//
//   C[m, n] = epilogue( sum_k A(m, k) * B(n, k) )
//   epilogue: (acc + bias[n]) * scale * rowmask[m]  (+ C[m, n] when beta)
//   with a GemmEpi (the TransformerBlock's MLP products, one per launch):
//   act(acc + bias[n]) * scale * rowmask[m] * seqmul[m / seq, n] (+ C),
//   act none, exact erf GELU, or the product with GELU'(aux[m, n]).
//
// The weight grads reduce over all R*T rows inside one launch: each output
// element is summed by one thread in a fixed order, so two runs give the
// same bits.
//
// Bound: FFMA only, so the fp32 non-tensor peak of the card. Shared-memory
// tiles of BM x 8 and BN x 8, 256 threads, each holding a TM x TN block of
// the output in registers (8x8 for large products, 4x4 for small ones so
// that the small pyramid levels still fill the SMs). No double buffering,
// no tensor cores: these layouts are the next redesign (ROADMAP Queue 2b).
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

// FWD (A.B^T, here only with a GemmEpi) compiles without the backward's
// options: no kmask, tapdir +1, no beta.
template <bool TA, bool FWD>
__device__ __forceinline__ float gemm_load_a(const GemmArgs& p, int m, int k) {
  if (m >= p.M || k >= p.K) return 0.f;
  if (!FWD && p.kmask && !p.kmask[k]) return 0.f;
  if (TA) return p.A[(long)k * p.lda + m];
  if (p.taps == 1) return p.A[(long)m * p.lda + k];
  const int tap = k / p.Kc, c = k - tap * p.Kc;
  const int dt = FWD ? tap - 1 : p.tapdir * (tap - 1);
  const int t = m % p.seq + dt;
  if (t < 0 || t >= p.seq) return 0.f;
  return p.A[(long)(m + dt) * p.lda + c];
}

template <bool TB>
__device__ __forceinline__ float gemm_load_b(const GemmArgs& p, int n, int k) {
  if (n >= p.N || k >= p.K) return 0.f;
  if (!TB) return p.B[(long)n * p.ldb + k];
  if (p.btaps == 1) return p.B[(long)k * p.ldb + n];
  const int tap = n / p.Kc, c = n - tap * p.Kc;
  const int t = k % p.seq + tap - 1;
  if (t < 0 || t >= p.seq) return 0.f;
  return p.B[(long)(k + tap - 1) * p.ldb + c];
}

// Rows/columns of a thread's TM x TN block come in groups of 4 spaced 64
// apart, so that a quarter warp's float4 shared-memory reads are contiguous.
// TA / TB: the operand layouts (transA / transB) of every product of the
// batch, compiled in so that the forward's loaders carry no layout branch.
// With splits > 1 (weight grads only, TA) blockIdx.z = product * splits +
// slice: the block sums its slice of K and stores the raw partial into
// part (one slot of `slot` floats per block z) for gemm_splitk_reduce_kernel.
// EPI: the GemmEpi epilogue (the TransformerBlock's MLP products); every
// other product compiles the short one (bias, scale, row mask, beta off the
// forward layout).
template <int TM, int TN, bool TA, bool TB, bool EPI>
__global__ void __launch_bounds__(256) gemm_tn_kernel(const GemmBatch batch, int splits,
                                                      int kchunk, float* part, long slot,
                                                      const GemmEpi epi) {
  constexpr int BM = 16 * TM, BN = 16 * TN, BK = 8;
  constexpr bool FWD = !TA && !TB;
  const int z = TA ? blockIdx.z / splits : blockIdx.z;
  const GemmArgs p = batch.g[z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;
  const int kbeg = TA ? (blockIdx.z % splits) * kchunk : 0;
  const int kend = TA ? min(p.K, kbeg + kchunk) : p.K;

  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // neighbouring threads read neighbouring addresses: along k for a
    // row-major operand, along m (n) for a transposed one
#pragma unroll
    for (int i = 0; i < BM * BK / 256; ++i) {
      const int e = tid + i * 256;
      const int r = TA ? e % BM : e / BK, kk = TA ? e / BM : e % BK;
      As[kk][r] = !TA || k0 + kk < kend ? gemm_load_a<TA, FWD>(p, m0 + r, k0 + kk) : 0.f;
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

  if (TA && splits > 1) {
    float* out = part + blockIdx.z * slot;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
        if (m < p.M && n < p.N) out[(long)m * p.N + n] = acc[i][j];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= p.M) continue;
    if (EPI) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
        if (n < p.N) gemm_store_epi(p, epi, m, n, acc[i][j]);
      }
      continue;
    }
    const float mk = p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f;
    float* crow = p.C + (long)m * p.ldc;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (p.bias) v += p.bias[n];
      v = v * p.scale * mk;
      crow[n] = p.beta ? crow[n] + v : v;   // the forward layout takes a GemmEpi here
    }
  }
}

// C = epilogue(sum of the splits' partials, in slice order); grid (ceil(M*N
// / 256), count).
__global__ void __launch_bounds__(256) gemm_splitk_reduce_kernel(const GemmBatch batch,
                                                                 int splits,
                                                                 const float* part,
                                                                 long slot) {
  const GemmArgs& p = batch.g[blockIdx.y];
  const long e = (long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long)p.M * p.N) return;
  const int m = (int)(e / p.N), n = (int)(e - (long)m * p.N);
  const float* src = part + (long)blockIdx.y * splits * slot + e;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += src[s * slot];
  if (p.bias) v += p.bias[n];
  v = v * p.scale * (p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f);
  float* c = p.C + (long)m * p.ldc + n;
  *c = p.beta ? *c + v : v;
}

constexpr int GEMM_MAX_SPLITS = 8;

// floats of split-K scratch for weight-grad products of at most mn outputs
static long gemm_splitk_floats(long mn) { return (long)GEMM_MAX_BATCH * GEMM_MAX_SPLITS * mn; }

// EPI launches take `epi` (launch_gemm_epi); only the libraries that call
// launch_gemm_epi compile those kernels, whose unrolled GELU epilogues are
// slow to build.
template <bool TA, bool TB, bool EPI = false>
static int launch_gemm_layout(const GemmBatch& batch, int count, cudaStream_t stream,
                              float* part, long part_floats, const GemmEpi& epi = GemmEpi{}) {
  long maxM = 0, maxN = 0, maxK = 0;
  for (int i = 0; i < count; ++i) {
    maxM = std::max(maxM, (long)batch.g[i].M);
    maxN = std::max(maxN, (long)batch.g[i].N);
    maxK = std::max(maxK, (long)batch.g[i].K);
  }
  const long big_tiles = (long)ceil_div(maxM, 128) * ceil_div(maxN, 128) * count;
  if (!TA && big_tiles >= 2 * 132) {
    dim3 grid(ceil_div(maxN, 128), ceil_div(maxM, 128), count);
    gemm_tn_kernel<8, 8, TA, TB, EPI><<<grid, 256, 0, stream>>>(batch, 1, 0, nullptr, 0, epi);
    UNAV_RETURN_IF_ERROR();
    return 0;
  }
  // weight grads: few output tiles over a long K (all R*T rows), so split K
  // until the grid holds ~2 blocks per SM, each slice at least 256 deep
  const long tiles = (long)ceil_div(maxM, 64) * ceil_div(maxN, 64) * count;
  int splits = 1;
  if (TA && part)
    splits = (int)std::min<long>({(long)GEMM_MAX_SPLITS, ceil_div(2 * 132, tiles),
                                  std::max(1L, maxK / 256),
                                  part_floats / std::max(1L, (long)count * maxM * maxN)});
  splits = std::max(splits, 1);
  const int kchunk = ceil_div(ceil_div(maxK, splits), 8) * 8;
  splits = ceil_div(maxK, kchunk);
  dim3 grid(ceil_div(maxN, 64), ceil_div(maxM, 64), count * splits);
  gemm_tn_kernel<4, 4, TA, TB, EPI><<<grid, 256, 0, stream>>>(batch, splits, kchunk, part,
                                                                maxM * maxN, epi);
  UNAV_RETURN_IF_ERROR();
  if (splits > 1) {
    gemm_splitk_reduce_kernel<<<dim3(ceil_div(maxM * maxN, 256), count), 256, 0, stream>>>(
        batch, splits, part, maxM * maxN);
    UNAV_RETURN_IF_ERROR();
  }
  return 0;
}

// Launch `count` independent products (count <= GEMM_MAX_BATCH): one grid
// for each operand layout present, in the order A.B^T (on the tensor cores,
// gemm_tc.cuh), A.B, A^T.B. With `part` (gemm_splitk_floats of the largest
// weight grad) the A^T.B products split K, deterministically.
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
    const int rc =
        layout == 0   ? launch_gemm_tc(sub, n, stream)
        : layout == 1 ? launch_gemm_layout<false, true>(sub, n, stream, nullptr, 0)
                      : launch_gemm_layout<true, true>(sub, n, stream, part, part_floats);
    if (rc) return rc;
  }
  return 0;
}

// One A.B^T or A.B product with the GemmEpi epilogue (an A^T.B is refused).
static int launch_gemm_epi(const GemmArgs& a, const GemmEpi& epi, cudaStream_t stream) {
  GemmBatch one;
  one.g[0] = a;
  if (a.transA) return (int)cudaErrorInvalidValue;
  return a.transB ? launch_gemm_layout<false, true, true>(one, 1, stream, nullptr, 0, epi)
                  : launch_gemm_layout<false, false, true>(one, 1, stream, nullptr, 0, epi);
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
