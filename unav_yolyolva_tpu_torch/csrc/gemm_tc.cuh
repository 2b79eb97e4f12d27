// The port's fp32 product on the tensor cores (3xTF32), in the three operand
// layouts of GemmArgs, and the operand description that every product of the
// port shares.
//
//   C[m, n] = (sum_k A(m, k) * B(n, k) + bias[n]) * scale * rowmask[m]
//             (+ C[m, n] with beta)
//
// and, through launch_gemm_tc_epi (A.B^T or A.B, a compile-time choice of
// the kernel), the same with the GemmEpi epilogue: exact erf GELU or the
// product with GELU'(aux), a per-sequence column multiplier, beta on either
// layout, and GELU's input written beside its output.
//
// It replaces, for the port, the fp32 `jnp.dot`s of the Pallas kernels'
// bodies and of their backward: `_csp_compute` and `_csp_bwd_kernel` (main,
// guide_fc, k=3 projection and final convs and their grads,
// unav_yolyolva_tpu/ops/pallas_csp.py), `_mhca_compute` and
// `_mhca_bwd_kernel` (q/k/v and proj dense layers and their grads,
// ops/pallas_fusion.py), `_tblock_compute` and `_tblock_bwd_kernel` (fc1 +
// GELU, fc2 + residual tail, and their grads, ops/pallas_tblock.py). Every
// product of the port runs here: launch_gemm (gemm.cuh) sends those without
// an epilogue; the attention of mhca.cuh and its backward (mhca_bwd.cuh)
// run their products on the same fragments (mma_3xtf32).
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
//     dynamic shared memory. An operand stored with k along its rows (A of
//     the forward and input-grad layouts, B of the forward layout) sits
//     n-major, rows padded to 36 floats; one stored with k down its rows
//     (A of the weight grads, B of the input and weight grads) sits
//     k-major, rows padded to BM + 8 or BN + 8 floats: either way the
//     fragment reads hit 32 distinct banks. Ragged edges, masked k rows and
//     the k=3 conv's rows outside their sequence are zero-filled by the
//     copy (src-size 0);
//   - the block tile (128x64, 64x64 or 32x32; warps of 32x32 or 16x16, 128
//     registers at most, so two blocks share an SM) is chosen from the
//     launch's blocks so that it has at least 2 x 132 where it can;
//   - the tensor cores round the sum of an mma toward zero, so each 32-deep
//     slice of k is summed from zero and then added to the fp32 total: the
//     long sum is rounded to nearest, as an FFMA loop's is.
// Deterministic and independent of batching, no atomics: every output
// element is summed by one thread over the same 32-deep slices in the same
// order whatever the tile shape or the other products of the launch, so
// the forward and the backward's recompute (which batches guide_fc with the
// projection conv, or writes fc1's GELU input beside its output) give the
// same bits. A weight grad (A^T.B, K = all R*T
// rows) splits K into gemm_split_chunk(M, N, K) slices, multiples of 32
// fixed by its own shape; each split's raw sum goes to scratch and
// gemm_splitk_reduce_kernel adds them in split order.
#pragma once

#include <stdint.h>

#include "common.cuh"

// One product. Operand layouts (row strides lda / ldb):
//   A(m, k) = A[m * lda + k], or A[k * lda + m] with transA;
//   B(n, k) = B[n * ldb + k] (torch Linear layout), or B[k * ldb + n] with
//   transB. A and C are addressed with a row stride, so a product can read
//   from and write straight into a column slice of a wider buffer (the CSP
//   concat). The forward uses A.B^T, the backward's input grads A.B
//   (transB) and its weight grads A^T.B (transA + transB).
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

// The TransformerBlock MLP's epilogue (launch_gemm_tc_epi), a kernel
// parameter of its own: kept out of GemmArgs, whose size every other
// product's kernel would pay for in registers.
constexpr int GEMM_ACT_NONE = 0, GEMM_ACT_GELU = 1, GEMM_ACT_GELU_GRAD = 2;
struct GemmEpi {
  int act;                      // GEMM_ACT_*
  const float* aux; long ldaux; // GELU' input (GEMM_ACT_GELU_GRAD)
  const float* seqmul; int seq; // (M / seq, N) column multiplier, or nullptr
  float* pre; long ldpre;       // GEMM_ACT_GELU: the input of GELU, or nullptr
};

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float u) {
  return 0.5f * (1.f + erff(u * 0.70710678118654752f)) +
         u * 0.39894228040143268f * expf(-0.5f * u * u);
}

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
constexpr int TC_LDS = TC_BK + 4;   // n-major row stride: conflict-free fragments
constexpr int TC_KPAD = 8;          // k-major rows: BM (BN) + 8 floats, also conflict-free
constexpr int GEMM_MAX_SPLITS = 8;

// A fragment from a k-major tile (element (m, k) at p[k * ld + m]): p points
// at (k = t, m = g)
__device__ __forceinline__ FragA load_frag_a_kmajor(const float* p, int ld) {
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8], f.hi[1], f.lo[1]);
  split_tf32(p[4 * ld], f.hi[2], f.lo[2]);
  split_tf32(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// B fragment from a k-major tile (element (n, k) at p[k * ld + n]): p points
// at (k = t, n = g)
__device__ __forceinline__ FragB load_frag_b_kmajor(const float* p, int ld) {
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4 * ld], f.hi[1], f.lo[1]);
  return f;
}

// How a launch of weight grads splits K: product i owns blocks z in
// [first[i], first[i + 1]), each summing kchunk[i] of K (a multiple of
// TC_BK); with more than one split its raw sums go to part + off[i] (split
// s at s * M * N), else straight to C.
struct GemmSplits {
  int first[GEMM_MAX_BATCH + 1];
  int kchunk[GEMM_MAX_BATCH];
  long off[GEMM_MAX_BATCH];
};

// K per split of a weight grad (M, N, K), a multiple of TC_BK fixed by the
// product's own shape: split until its 64x64 tiles make ~2 blocks per SM,
// each split at least 8 slices deep (ops/gemm_tc.py:split_chunk mirrors it)
static int gemm_split_chunk(int M, int N, int K) {
  const long tiles = (long)ceil_div(M, 64) * ceil_div(N, 64);
  const int slices = ceil_div(K, TC_BK);
  const long s = std::max(1L, std::min<long>({(long)GEMM_MAX_SPLITS, ceil_div(2 * 132, tiles),
                                              (long)(slices / 8)}));
  return ceil_div(slices, s) * TC_BK;
}

// grid (ceil(N / BN), ceil(M / BM), count, or the splits' blocks with TA),
// WM x WN warps, each owning a (BM / WM) x (BN / WN) block of the output.
// TA / TB: the layouts of every product of the launch (A.B^T, A.B, A^T.B).
// EPI: apply epi (one A.B^T or A.B product); without it epi is not read.
template <int BM, int BN, int WM, int WN, int STAGES, bool TA, bool TB, bool EPI>
__global__ void __launch_bounds__(WM * WN * 32) gemm_tc_kernel(const GemmBatch batch,
                                                              const GemmSplits sp,
                                                              float* part,
                                                              const GemmEpi epi) {
  constexpr int NT = WM * WN * 32, TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  constexpr int LDA = TA ? BM + TC_KPAD : TC_LDS, LDB = TB ? BN + TC_KPAD : TC_LDS;
  constexpr int ASZ = TA ? TC_BK * LDA : BM * TC_LDS, BSZ = TB ? TC_BK * LDB : BN * TC_LDS;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && (BM * 8) % NT == 0 && (BN * 8) % NT == 0,
                "tile shape");
  int pi = blockIdx.z, split = 0;
  if (TA) {
    pi = 0;
    while ((int)blockIdx.z >= sp.first[pi + 1]) ++pi;
    split = blockIdx.z - sp.first[pi];
  }
  const GemmArgs p = batch.g[pi];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;
  const int kbeg = TA ? split * sp.kchunk[pi] : 0;
  const int kend = TA ? min(p.K, kbeg + sp.kchunk[pi]) : p.K;
  extern __shared__ __align__(16) float tc_smem[];
  float* As = tc_smem;                  // STAGES x ASZ
  float* Bs = tc_smem + STAGES * ASZ;   // STAGES x BSZ
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t4 = lane & 3;
  const int KT = (kend - kbeg + TC_BK - 1) / TC_BK;

  // one stage: 16-byte chunks, neighbouring threads on neighbouring chunks
  // of a row (8 chunks a 32-deep n-major row, BM / 4 or BN / 4 a k-major one)
  auto load = [&](int stage, int kt) {
    const int k0 = kbeg + kt * TC_BK;
    float* as = As + stage * ASZ;
    float* bs = Bs + stage * BSZ;
#pragma unroll
    for (int i = 0; i < BM * 8 / NT; ++i) {
      const int e = tid + i * NT;
      if (TA) {
        const int r = e / (BM / 4), c = (e % (BM / 4)) * 4, m = m0 + c, k = k0 + r;
        const bool ok = m < p.M && k < kend && (!p.kmask || p.kmask[k]);
        cp_async16(as + r * LDA + c, ok ? p.A + (long)k * p.lda + m : p.A, ok);
        continue;
      }
      const int r = e >> 3, c = (e & 7) * 4;
      const int m = m0 + r, k = k0 + c;
      bool ok = m < p.M && k < p.K;
      const float* src = p.A;
      if (p.taps == 1) {
        if (ok) src = p.A + (long)m * p.lda + k;
      } else {
        const int tap = k / p.Kc, cc = k - tap * p.Kc;
        const int dt = TB ? p.tapdir * (tap - 1) : tap - 1, t = m % p.seq + dt;
        ok = ok && t >= 0 && t < p.seq;
        if (ok) src = p.A + (long)(m + dt) * p.lda + cc;
      }
      cp_async16(as + r * TC_LDS + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 8 / NT; ++i) {
      const int e = tid + i * NT;
      if (TB) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4, n = n0 + c, k = k0 + r;
        bool ok = n < p.N && k < kend;
        const float* src = p.B;
        if (p.btaps == 1) {
          if (ok) src = p.B + (long)k * p.ldb + n;
        } else {
          const int tap = n / p.Kc, cc = n - tap * p.Kc, t = k % p.seq + tap - 1;
          ok = ok && t >= 0 && t < p.seq;
          if (ok) src = p.B + (long)(k + tap - 1) * p.ldb + cc;
        }
        cp_async16(bs + r * LDB + c, src, ok);
        continue;
      }
      const int r = e >> 3, c = (e & 7) * 4;
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
    const float* as = As + (kt % STAGES) * ASZ +
                      (TA ? t4 * LDA + wm * TM + g : (wm * TM + g) * TC_LDS + t4);
    const float* bs = Bs + (kt % STAGES) * BSZ +
                      (TB ? t4 * LDB + wn * TN + g : (wn * TN + g) * TC_LDS + t4);
    float part_[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part_[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      FragB b[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j)
        b[j] = TB ? load_frag_b_kmajor(bs + kk * LDB + j * 8, LDB)
                  : load_frag_b(bs + j * 8 * TC_LDS + kk);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const FragA a = TA ? load_frag_a_kmajor(as + kk * LDA + i * 16, LDA)
                           : load_frag_a(as + i * 16 * TC_LDS + kk, TC_LDS);
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_3xtf32(part_[i][j], a, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part_[i][j][r];
  }
  cp_async_wait<0>();

  // a split's raw sum, for gemm_splitk_reduce_kernel
  float* out = TA && sp.first[pi + 1] - sp.first[pi] > 1
                   ? part + sp.off[pi] + (long)split * p.M * p.N : nullptr;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * TM + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float mk = p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f;
      float* crow = out ? out + (long)m * p.N : p.C + (long)m * p.ldc;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * t4;
        if (n >= p.N) continue;   // N is even: n + 1 < N too
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (!out) {
          if (p.bias) {
            v0 += p.bias[n];
            v1 += p.bias[n + 1];
          }
          if (EPI && epi.act == GEMM_ACT_GELU) {
            if (epi.pre)
              *reinterpret_cast<float2*>(epi.pre + (long)m * epi.ldpre + n) = make_float2(v0, v1);
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          } else if (EPI && epi.act == GEMM_ACT_GELU_GRAD) {
            const float2 u = *reinterpret_cast<const float2*>(epi.aux + (long)m * epi.ldaux + n);
            v0 *= gelu_erf_grad(u.x);
            v1 *= gelu_erf_grad(u.y);
          }
          v0 = v0 * p.scale * mk;
          v1 = v1 * p.scale * mk;
          if (EPI && epi.seqmul) {
            const float2 s = *reinterpret_cast<const float2*>(epi.seqmul +
                                                              (long)(m / epi.seq) * p.N + n);
            v0 *= s.x;
            v1 *= s.y;
          }
          if ((TA || TB || EPI) && p.beta) {   // only the epilogue's forward accumulates
            const float2 c = *reinterpret_cast<const float2*>(crow + n);
            v0 += c.x;
            v1 += c.y;
          }
        }
        *reinterpret_cast<float2*>(crow + n) = make_float2(v0, v1);
      }
    }
}

// C = epilogue(the sum of a weight grad's split partials, in split order);
// grid (ceil(M * N / 256), count): products with one split return at once.
__global__ void __launch_bounds__(256) gemm_splitk_reduce_kernel(const GemmBatch batch,
                                                                 const GemmSplits sp,
                                                                 const float* __restrict__ part) {
  const GemmArgs& p = batch.g[blockIdx.y];
  const int splits = sp.first[blockIdx.y + 1] - sp.first[blockIdx.y];
  const long e = (long)blockIdx.x * 256 + threadIdx.x, mn = (long)p.M * p.N;
  if (splits == 1 || e >= mn) return;
  const int m = (int)(e / p.N), n = (int)(e - (long)m * p.N);
  const float* src = part + sp.off[blockIdx.y] + e;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += src[s * mn];
  if (p.bias) v += p.bias[n];
  v = v * p.scale * (p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f);
  float* c = p.C + (long)m * p.ldc + n;
  *c = p.beta ? *c + v : v;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` the first time a
// launch needs more than it has (once per process and kernel: `limit` is
// the caller's static for that kernel).
static void raise_smem_limit(const void* kernel, int bytes, int& limit) {
  if (bytes > limit && bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    limit = bytes;
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool TA, bool TB, bool EPI>
static int launch_gemm_tc_tile(const GemmBatch& batch, const GemmSplits& sp, int count,
                               int maxM, int maxN, float* part, const GemmEpi& epi,
                               cudaStream_t stream) {
  constexpr int ASZ = TA ? TC_BK * (BM + TC_KPAD) : BM * TC_LDS;
  constexpr int BSZ = TB ? TC_BK * (BN + TC_KPAD) : BN * TC_LDS;
  const int smem = STAGES * (ASZ + BSZ) * (int)sizeof(float);
  auto kernel = gemm_tc_kernel<BM, BN, WM, WN, STAGES, TA, TB, EPI>;
  static int limit = 0;
  raise_smem_limit((const void*)kernel, smem, limit);
  const dim3 grid(ceil_div(maxN, BN), ceil_div(maxM, BM), TA ? sp.first[count] : count);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(batch, sp, part, epi);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// blocks of a BM x BN tiling that hold output (with every split of K)
static long tc_blocks(const GemmBatch& batch, const GemmSplits& sp, int count, bool ta,
                      int bm, int bn) {
  long n = 0;
  for (int i = 0; i < count; ++i)
    n += (long)ceil_div(batch.g[i].M, bm) * ceil_div(batch.g[i].N, bn) *
         (ta ? sp.first[i + 1] - sp.first[i] : 1);
  return n;
}

template <bool TA, bool TB, bool EPI>
static int launch_gemm_tc_layout(const GemmBatch& batch, const GemmSplits& sp, int count,
                                 int maxM, int maxN, float* part, const GemmEpi& epi,
                                 cudaStream_t stream) {
  if (tc_blocks(batch, sp, count, TA, 128, 64) >= 2 * 132)
    return launch_gemm_tc_tile<128, 64, 4, 2, 3, TA, TB, EPI>(batch, sp, count, maxM, maxN,
                                                              part, epi, stream);
  if (tc_blocks(batch, sp, count, TA, 64, 64) >= 2 * 132)
    return launch_gemm_tc_tile<64, 64, 2, 2, 4, TA, TB, EPI>(batch, sp, count, maxM, maxN,
                                                             part, epi, stream);
  return launch_gemm_tc_tile<32, 32, 2, 2, 4, TA, TB, EPI>(batch, sp, count, maxM, maxN, part,
                                                           epi, stream);
}

// 0, or why launch_gemm_tc refuses product p of a launch of layout (ta, tb):
// one layout a launch; kmask and btaps only on weight grads, taps only on a
// row-major A, tapdir -1 not on the forward layout, beta not on it but for
// an epilogue product (epi); the ring's 16-byte copies.
static int gemm_tc_refuses(const GemmArgs& p, bool ta, bool tb, bool epi) {
  if ((bool)p.transA != ta || (bool)p.transB != tb || (ta && !tb) ||
      (!ta && (p.kmask || p.btaps != 1)) || (ta && p.taps != 1) ||
      (!tb && ((p.beta && !epi) || p.tapdir != 1)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(p.A) || !aligned16(p.B) || p.lda % 4 || p.ldb % 4 ||
      ((p.taps == 3 || p.btaps == 3) && p.Kc % 4) ||
      (ta ? p.M % 4 : p.K % 4) || (tb ? p.N % 4 : p.K % 4) || p.N % 2 || p.ldc % 2 ||
      ((uintptr_t)p.C & 7))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// Launch `count` products of one layout in one grid (and, for weight grads
// that split K, one reduce launch). Every operand the ring copies must be
// 16-byte aligned with row strides and the dimension it is copied along
// (K of a row-major A or B, M of a transposed A, N of a transposed B, Kc)
// multiples of 4 floats, and N even; otherwise returns
// cudaErrorMisalignedAddress and launches nothing. A weight grad's splits
// need gemm_splitk_floats of scratch in part (else cudaErrorInvalidValue).
static int launch_gemm_tc(const GemmBatch& batch, int count, cudaStream_t stream,
                          float* part = nullptr, long part_floats = 0) {
  const bool ta = batch.g[0].transA, tb = batch.g[0].transB;
  int maxM = 0, maxN = 0;
  GemmSplits sp;
  sp.first[0] = 0;
  long off = 0;
  for (int i = 0; i < count; ++i) {
    const GemmArgs& p = batch.g[i];
    if (const int rc = gemm_tc_refuses(p, ta, tb, false)) return rc;
    maxM = std::max(maxM, p.M);
    maxN = std::max(maxN, p.N);
    sp.kchunk[i] = ta ? gemm_split_chunk(p.M, p.N, p.K) : p.K;
    const int splits = ta ? std::max(1, ceil_div(p.K, sp.kchunk[i])) : 1;
    sp.first[i + 1] = sp.first[i] + splits;
    sp.off[i] = off;
    if (splits > 1) off += (long)splits * p.M * p.N;
  }
  if (off > (part ? part_floats : 0)) return (int)cudaErrorInvalidValue;
  const GemmEpi none{};
  const int rc =
      ta   ? launch_gemm_tc_layout<true, true, false>(batch, sp, count, maxM, maxN, part, none,
                                                      stream)
      : tb ? launch_gemm_tc_layout<false, true, false>(batch, sp, count, maxM, maxN, part, none,
                                                       stream)
           : launch_gemm_tc_layout<false, false, false>(batch, sp, count, maxM, maxN, part,
                                                        none, stream);
  if (rc || !off) return rc;
  gemm_splitk_reduce_kernel<<<dim3(ceil_div((long)maxM * maxN, 256), count), 256, 0, stream>>>(
      batch, sp, part);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// floats of split-K scratch for a launch of weight grads of at most mn
// outputs each
static long gemm_splitk_floats(long mn) { return (long)GEMM_MAX_BATCH * GEMM_MAX_SPLITS * mn; }

// One A.B^T or A.B product with the GemmEpi epilogue, applied to each pair
// of outputs before they are stored:
//   C[m, n] = act(sum_k A(m, k) B(n, k) + bias[n]) * scale * rowmask[m]
//             * seqmul[m / seq, n] (+ C[m, n] with beta, either layout)
// act: none; exact erf GELU, writing its input to pre as well when pre is
// given; or the product with GELU'(aux[m, n]). The bits of C (and of pre)
// are those of the same product without the epilogue, then the epilogue.
// aux, pre and seqmul are read and written as float pairs: 8-byte aligned,
// even row strides. An A^T.B, kmask or btaps is refused. A template, so
// that only the libraries that call it compile its kernels.
template <bool EPI = true>
static int launch_gemm_tc_epi(const GemmArgs& a, const GemmEpi& epi, cudaStream_t stream) {
  if (a.transA || epi.act < GEMM_ACT_NONE || epi.act > GEMM_ACT_GELU_GRAD ||
      (epi.act == GEMM_ACT_GELU_GRAD && !epi.aux) || (epi.seqmul && epi.seq < 1))
    return (int)cudaErrorInvalidValue;
  if (const int rc = gemm_tc_refuses(a, false, a.transB, EPI)) return rc;
  if ((epi.aux && (((uintptr_t)epi.aux & 7) || epi.ldaux % 2)) ||
      (epi.pre && (((uintptr_t)epi.pre & 7) || epi.ldpre % 2)) ||
      ((uintptr_t)epi.seqmul & 7))
    return (int)cudaErrorMisalignedAddress;
  GemmBatch one;
  one.g[0] = a;
  GemmSplits sp;
  sp.first[0] = 0;
  sp.first[1] = 1;
  sp.kchunk[0] = a.K;
  sp.off[0] = 0;
  return a.transB
             ? launch_gemm_tc_layout<false, true, EPI>(one, sp, 1, a.M, a.N, nullptr, epi, stream)
             : launch_gemm_tc_layout<false, false, EPI>(one, sp, 1, a.M, a.N, nullptr, epi,
                                                        stream);
}
