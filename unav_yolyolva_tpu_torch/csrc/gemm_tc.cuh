// The forward-layout fp32 product on the tensor cores (3xTF32), and the
// operand description that every product of the port shares.
//
//   C[m, n] = (sum_k A(m, k) * B(n, k) + bias[n]) * scale * rowmask[m]
//
// It replaces, for the port, the fp32 `jnp.dot`s of the Pallas kernels'
// bodies: `_csp_compute` (main, guide_fc, k=3 projection and final convs,
// unav_yolyolva_tpu/ops/pallas_csp.py) and `_mhca_compute` (q/k/v and proj
// dense layers, ops/pallas_fusion.py). launch_gemm (gemm.cuh) sends every
// A.B^T product without a GemmEpi here; the attention of mhca.cuh runs its
// two products on the same fragments (mma_3xtf32).
//
// Bound: operations. On the H100 the fp32 FFMA peak is 67 TFLOP/s, the
// dense TF32 tensor-core peak 495. One TF32 pass keeps 10 mantissa bits and
// would break the port's fp32 protocol, so each operand is split as
// hi = tf32(x), lo = tf32(x - hi) and the product sums lo.hi + hi.lo + hi.hi
// in fp32 (the lo.lo term, ~2^-22 relative, is dropped): three mma per
// product term, an fp32-accurate product at up to 495 / 3 = 165 TFLOP/s.
// The design:
//   - mma.sync m16n8k8 (tf32 in, fp32 accumulate): fragments live in
//     registers, so the hi/lo split is a register operation (two integer
//     operations per term) and costs no shared memory; splitting each
//     stage once into shared memory instead measured slower (more
//     registers, a second barrier per stage; PERF.md);
//   - a 3- or 4-stage cp.async.cg ring of A and B tiles (32 deep in k) in
//     dynamic shared memory, rows padded to 36 floats so that the fragment
//     reads hit 32 distinct banks; ragged M / N / K edges and the k=3 conv's
//     rows outside their sequence are zero-filled by the copy (src-size 0);
//   - the block tile (128x64, 64x64 or 32x32; warps of 32x32 or 16x16, 128
//     registers at most, so two blocks share an SM) is chosen from M and N
//     so that a launch has at least 2 x 132 blocks where it can;
//   - the tensor cores round the sum of an mma toward zero, so each 32-deep
//     slice of k is summed from zero and then added to the fp32 total: the
//     long sum is rounded to nearest, as an FFMA loop's is.
// Deterministic and independent of batching: no split-K, no atomics; every
// output element is summed by one thread over the same 32-deep slices in
// the same order whatever the tile shape or the other products of the
// launch, so the forward and the backward's recompute (which batches
// guide_fc with the projection conv) give the same bits.
#pragma once

#include <stdint.h>

#include "common.cuh"

// One product. Operand layouts (row strides lda / ldb):
//   A(m, k) = A[m * lda + k], or A[k * lda + m] with transA;
//   B(n, k) = B[n * ldb + k] (torch Linear layout), or B[k * ldb + n] with
//   transB. A and C are addressed with a row stride, so a product can read
//   from and write straight into a column slice of a wider buffer (the CSP
//   concat). The forward uses A.B^T (this header); the backward's input
//   grads use A.B (transB) and its weight grads A^T.B (transA + transB), on
//   the FFMA kernel of gemm.cuh.
// kmask[k] zeroes A(m, k) (a row mask of the rows being reduced over).
// With taps == 3 the A loader is a k=3 "same" convolution over time written
// as one product of depth 3*Kc: k = tap * Kc + c reads A at row
// m + tapdir * (tap - 1), zero outside the sequence (rows are (sequence, t)
// with t = m % seq); tapdir = -1 is the transposed conv of the backward.
// With btaps == 3 (transB only) the B loader does the same on the n index:
// n = tap * Kc + c reads B at row k + tap - 1 (the conv's weight grad).
struct GemmArgs {
  const float* A; long lda;
  const float* B; long ldb;
  float* C; long ldc;
  const float* bias;            // (N) or nullptr
  const unsigned char* rowmask; // (M) or nullptr
  const unsigned char* kmask;   // (K) or nullptr
  float scale;
  int M, N, K;
  int taps;                     // 1, or 3 for the k=3 conv loader on A
  int tapdir;                   // +1 (forward conv) or -1 (its transpose)
  int btaps;                    // 1, or 3 for the k=3 loader on B's n index
  int Kc;                       // channels per tap
  int seq;                      // sequence length (taps or btaps == 3)
  int transA, transB, beta;
};

constexpr int GEMM_MAX_BATCH = 4;
struct GemmBatch { GemmArgs g[GEMM_MAX_BATCH]; };

static GemmArgs gemm_args(const float* A, long lda, const float* B, long ldb,
                          float* C, long ldc, const float* bias,
                          const unsigned char* rowmask, float scale,
                          int M, int N, int K) {
  GemmArgs a;
  a.A = A; a.lda = lda; a.B = B; a.ldb = ldb; a.C = C; a.ldc = ldc;
  a.bias = bias; a.rowmask = rowmask; a.kmask = nullptr; a.scale = scale;
  a.M = M; a.N = N; a.K = K; a.taps = 1; a.tapdir = 1; a.btaps = 1; a.Kc = K;
  a.seq = 1; a.transA = 0; a.transB = 0; a.beta = 0;
  return a;
}

// ---- asynchronous copies and 3xTF32 fragments (also used by mhca.cuh) ----

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32 for every finite x, in two integer operations (sm_90 has
// no native conversion: ptxas expands cvt.rna into several, and the split
// sits in the products' inner loops)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~22 bits, each a TF32 value rounded to nearest (ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4): A (16x8, row-major)
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8x8, k by n) b0
// (t, g), b1 (t+4, g); C (16x8) c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
// c3 (g+8, 2t+1).
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// A fragment from a row-major tile: p points at (row g, col t), ld its stride
__device__ __forceinline__ FragA load_frag_a(const float* p, int ld) {
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// B fragment from an n-major tile ((n, k) rows): p points at (k = t, n = g)
__device__ __forceinline__ FragB load_frag_b(const float* p) {
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}

// A B fragment from a tile pre-split into (hi, lo) float pairs (the
// attention's key and value tiles): p points at the pair of (k = t, n = g),
// kstride steps k, in floats
__device__ __forceinline__ FragB load_frag_b_split(const float* p, int kstride) {
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + kstride);
  FragB f;
  f.hi[0] = __float_as_uint(v0.x); f.lo[0] = __float_as_uint(v0.y);
  f.hi[1] = __float_as_uint(v1.x); f.lo[1] = __float_as_uint(v1.y);
  return f;
}

// x split into its (hi, lo) pair at dst
__device__ __forceinline__ void store_split(float* dst, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  *reinterpret_cast<float2*>(dst) = make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: the two small terms first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---- the product ------------------------------------------------------------

constexpr int TC_BK = 32;           // k per ring stage (one summed slice)
constexpr int TC_LDS = TC_BK + 4;   // shared row stride: conflict-free fragments

// grid (ceil(N / BN), ceil(M / BM), count), WM x WN warps, each owning a
// (BM / WM) x (BN / WN) block of the output.
template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32) gemm_tc_kernel(const GemmBatch batch) {
  constexpr int NT = WM * WN * 32, TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && (BM * 8) % NT == 0 && (BN * 8) % NT == 0,
                "tile shape");
  const GemmArgs p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;
  extern __shared__ __align__(16) float tc_smem[];
  float* As = tc_smem;                          // STAGES x BM x TC_LDS
  float* Bs = tc_smem + STAGES * BM * TC_LDS;   // STAGES x BN x TC_LDS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t4 = lane & 3;
  const int KT = (p.K + TC_BK - 1) / TC_BK;

  // one stage: 16-byte chunks, 8 per 32-deep row; neighbouring threads take
  // neighbouring chunks of a row
  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
    float* as = As + stage * BM * TC_LDS;
    float* bs = Bs + stage * BN * TC_LDS;
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) {
      const int e = tid + i * NT, r = e >> 3, c = (e & 7) * 4;
      const int m = m0 + r, k = k0 + c;
      bool ok = m < p.M && k < p.K;
      const float* src = p.A;
      if (p.taps == 1) {
        if (ok) src = p.A + (long)m * p.lda + k;
      } else {
        const int tap = k / p.Kc, cc = k - tap * p.Kc, t = m % p.seq + tap - 1;
        ok = ok && t >= 0 && t < p.seq;
        if (ok) src = p.A + (long)(m + tap - 1) * p.lda + cc;
      }
      cp_async16(as + r * TC_LDS + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / NT; ++i) {
      const int e = tid + i * NT, r = e >> 3, c = (e & 7) * 4;
      const int n = n0 + r, k = k0 + c;
      const bool ok = n < p.N && k < p.K;
      cp_async16(bs + r * TC_LDS + c, ok ? p.B + (long)n * p.ldb + k : p.B, ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed for every thread; stage kt-1 is free
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * BM * TC_LDS + (wm * TM + g) * TC_LDS + t4;
    const float* bs = Bs + (kt % STAGES) * BN * TC_LDS + (wn * TN + g) * TC_LDS + t4;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      FragB b[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) b[j] = load_frag_b(bs + j * 8 * TC_LDS + kk);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const FragA a = load_frag_a(as + i * 16 * TC_LDS + kk, TC_LDS);
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_3xtf32(part[i][j], a, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * TM + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float mk = p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f;
      float* crow = p.C + (long)m * p.ldc;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * t4;
        if (n >= p.N) continue;   // N is even: n + 1 < N too
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.bias) {
          v0 += p.bias[n];
          v1 += p.bias[n + 1];
        }
        *reinterpret_cast<float2*>(crow + n) =
            make_float2(v0 * p.scale * mk, v1 * p.scale * mk);
      }
    }
}

template <int BM, int BN, int WM, int WN, int STAGES>
static int launch_gemm_tc_tile(const GemmBatch& batch, int count, int maxM, int maxN,
                               cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * TC_LDS * (int)sizeof(float);
  auto kernel = gemm_tc_kernel<BM, BN, WM, WN, STAGES>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(ceil_div(maxN, BN), ceil_div(maxM, BM), count);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(batch);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// blocks of a BM x BN tiling that hold output
static long tc_blocks(const GemmBatch& batch, int count, int bm, int bn) {
  long n = 0;
  for (int i = 0; i < count; ++i)
    n += (long)ceil_div(batch.g[i].M, bm) * ceil_div(batch.g[i].N, bn);
  return n;
}

// Launch `count` A.B^T products (no transA / transB / kmask / beta) in one
// grid. Every operand the ring copies must be 16-byte aligned with row
// strides, K (and Kc) multiples of 4 floats, and N even; otherwise returns
// cudaErrorMisalignedAddress and launches nothing.
static int launch_gemm_tc(const GemmBatch& batch, int count, cudaStream_t stream) {
  int maxM = 0, maxN = 0;
  for (int i = 0; i < count; ++i) {
    const GemmArgs& p = batch.g[i];
    if (p.transA || p.transB || p.kmask || p.beta) return (int)cudaErrorInvalidValue;
    if (!aligned16(p.A) || !aligned16(p.B) || p.lda % 4 || p.ldb % 4 || p.K % 4 ||
        p.Kc % 4 || p.N % 2 || p.ldc % 2 || ((uintptr_t)p.C & 7))
      return (int)cudaErrorMisalignedAddress;
    maxM = std::max(maxM, p.M);
    maxN = std::max(maxN, p.N);
  }
  if (tc_blocks(batch, count, 128, 64) >= 2 * 132)
    return launch_gemm_tc_tile<128, 64, 4, 2, 3>(batch, count, maxM, maxN, stream);
  if (tc_blocks(batch, count, 64, 64) >= 2 * 132)
    return launch_gemm_tc_tile<64, 64, 2, 2, 4>(batch, count, maxM, maxN, stream);
  return launch_gemm_tc_tile<32, 32, 2, 2, 4>(batch, count, maxM, maxN, stream);
}
