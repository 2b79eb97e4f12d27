// The bf16 compute policy's forward kernels for Hopper: the bf16
// instantiations of the Pallas kernels `_mhca_kernel` (ops/pallas_fusion.py),
// `_csp_kernel` (ops/pallas_csp.py) and `_tblock_kernel` (ops/pallas_tblock.py)
// of the JAX package, whose bodies take their compute dtype from their inputs
// (tpu.compute_dtype: bfloat16). Their arithmetic, which this file follows op
// by op:
//   - weights are fp32 masters, cast to bf16 at the call (`w.astype(dtype)`):
//     here once per call, by cast_bf16_kernel into the call's scratch;
//   - products take bf16 operands with fp32 sums (preferred_element_type),
//     are rounded to bf16, and then the bias is added in bf16 (rounded
//     again); q is scaled by bf16(1/sqrt(d)) after its bias;
//   - the depthwise k=3 conv runs in bf16, each product and sum rounded;
//     LayerNorm statistics and affine are fp32, stored bf16;
//   - attention logits and softmax are fp32; P is cast to bf16 after the
//     division by its sum, and P.V is summed in fp32, stored bf16;
//   - the CSP gate's scores are fp32 sums, its max and sigmoid fp32, the gate
//     cast to bf16 before it multiplies the bf16 projection;
//   - the TransformerBlock's residual stream and branch multipliers are fp32;
//     its LayerNorms store bf16, fc1's GELU takes and gives bf16.
// Bound: operations (the products, the attention's two products and the
// gate's scores run mma.sync.m16n8k16 bf16 with fp32 sums on the tensor
// cores). The design, for this card:
//   - the product (gemm_bf16_kernel): 128 x 128 tiles on 8 warps of 64 x 32
//     (two blocks a SM) where the products fill the card, a four-stage
//     cp.async ring read with ldmatrix, each 32-deep slice of k summed from
//     zero in four registers a 16 x 8 tile and added to the fp32 total (so a
//     warp holds one slice's fragments, not a second set of sums), the k=3
//     conv taps read by the loader, up to four products a launch;
//   - the attention (attn_bf16_kernel): no logits row in shared memory; a
//     warp's 16 query rows stay as fragments in registers and the logits are
//     recomputed on three passes over a cp.async ring of key and value tiles
//     (max; the sums, in the order the backward takes them; P and P.V), 128
//     queries a block up to d = 64 (each key tile read once for 8 warps);
//   - the CSP gate's scores (gate_bf16_scores): a (64 frames x Ng) tile on
//     the tensor cores, the projected guide streamed in 64-token tiles, the
//     max and tie count in registers; the backward rescores through the same
//     function.
// The dwconv + LayerNorm and the TBlock's glue stay on the FP32 pipes.
// `wgmma` and TMA are later work.
#pragma once

#include <cuda_bf16.h>

#include "csp.cuh"
#include "tblock.cuh"

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rb(float x) { return __float2bfloat16_rn(x); }
// x rounded to bf16 (to nearest even) and read back as fp32
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async16b(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), as stored or transposed
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// d += a.b, m16n8k16, bf16 operands, fp32 sums. Fragments (g = lane / 4,
// t = lane % 4): A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3
// (g+8, 2t+8..); B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); C c0/c1 (g,
// 2t..2t+1), c2/c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b + 0: the first 16-deep step of a slice summed from zero (the zero
// accumulator a register of zeros, not four moves)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// ---- fp32 weights -> bf16 scratch, once per call -----------------------------

constexpr int CAST_MAX = 24;
// a segment's layout: as stored, or a (d0, d1, d2) source written with its
// last two dims swapped, or with its last dim first
constexpr int CAST_AS_IS = 0, CAST_SWAP12 = 1, CAST_LAST_FIRST = 2;
struct CastList {
  const float* src[CAST_MAX];
  bf16* dst[CAST_MAX];
  long n[CAST_MAX];
  int perm[CAST_MAX], d1[CAST_MAX], d2[CAST_MAX];
  int count;
};

// grid (x, count): segment blockIdx.y, grid-strided
__global__ void __launch_bounds__(256) cast_bf16_kernel(const CastList l) {
  const int s = blockIdx.y, pm = l.perm[s];
  const long d1 = l.d1[s], d2 = l.d2[s];
  const float* src = l.src[s];
  bf16* dst = l.dst[s];
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < l.n[s]; i += (long)gridDim.x * 256) {
    long j = i;
    if (pm == CAST_SWAP12) {          // dst (d0, d2, d1)
      const long a = i / (d2 * d1), r = i - a * d2 * d1, b = r / d1, c = r - b * d1;
      j = (a * d1 + c) * d2 + b;
    } else if (pm == CAST_LAST_FIRST) {   // dst (d2, d0, d1)
      const long d0 = l.n[s] / (d1 * d2), a = i / (d0 * d1), r = i - a * d0 * d1;
      const long b = r / d1, c = r - b * d1;
      j = (b * d1 + c) * d2 + a;
    }
    dst[i] = rb(src[j]);
  }
}

// Queues the cast of n floats at src into the bump allocation `next`
// (segments start on 16 bytes) and returns where they will be; perm
// (with the source's last two dims d1, d2) rearranges a 3-d source.
static bf16* cast_push(CastList& l, bf16*& next, const float* src, long n,
                       int perm = CAST_AS_IS, int d1 = 1, int d2 = 1) {
  bf16* d = next;
  l.src[l.count] = src;
  l.dst[l.count] = d;
  l.n[l.count] = n;
  l.perm[l.count] = perm;
  l.d1[l.count] = d1;
  l.d2[l.count] = d2;
  ++l.count;
  next += (n + 7) / 8 * 8;
  return d;
}

static long cast_elems(long n) { return (n + 7) / 8 * 8; }

static int launch_cast(const CastList& l, cudaStream_t stream) {
  if (l.count < 1 || l.count > CAST_MAX) return (int)cudaErrorInvalidValue;
  long mx = 1;
  for (int i = 0; i < l.count; ++i) mx = std::max(mx, l.n[i]);
  cast_bf16_kernel<<<dim3(std::min(ceil_div(mx, 256), 1024), l.count), 256, 0, stream>>>(l);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- the product ----------------------------------------------------------------

// One product, C (ldc) = epilogue(A . B^T):
//   A(m, k) = A[m * lda + k] (bf16), or with taps == 3 the k=3 "same" conv
//   of A (M, Kc), k = tap * Kc + c reading row m + tap - 1 inside its
//   sequence of seq rows (zero outside); B (N, K) bf16, row stride ldb.
// Epilogue of each fp32 sum, every step rounded to bf16 (the JAX order):
//   y = bf16(sum); y = bf16(y + bias[n]); act GELU: y = bf16(gelu(y));
//   scale != 1: y = bf16(y * scale) (scale a bf16 value); y *= rowmask[m];
// stored bf16, or (seqmul) C fp32 += y * seqmul[m / mseq, n] (the TBlock's
// residual tail), or (raw) the fp32 sum alone.
struct Bf16Gemm {
  const bf16* A; long lda;
  const bf16* B; long ldb;
  void* C; long ldc;
  const bf16* bias;               // (N) or nullptr
  const unsigned char* rowmask;   // (M) or nullptr
  const float* seqmul;            // (M / mseq, N) or nullptr
  float scale;
  int M, N, K;
  int taps, Kc, seq, mseq;
  int act;                        // BF16_ACT_*
  int raw;
};

constexpr int BF16_ACT_NONE = 0, BF16_ACT_GELU = 1;
constexpr int BG_MAX_BATCH = 4;
struct Bf16Batch { Bf16Gemm g[BG_MAX_BATCH]; };

static Bf16Gemm bf16_gemm(const bf16* A, long lda, const bf16* B, long ldb, void* C, long ldc,
                          const bf16* bias, const unsigned char* rowmask, int M, int N, int K) {
  Bf16Gemm a;
  a.A = A; a.lda = lda; a.B = B; a.ldb = ldb; a.C = C; a.ldc = ldc;
  a.bias = bias; a.rowmask = rowmask; a.seqmul = nullptr; a.scale = 1.f;
  a.M = M; a.N = N; a.K = K; a.taps = 1; a.Kc = K; a.seq = 1; a.mseq = 1;
  a.act = BF16_ACT_NONE; a.raw = 0;
  return a;
}

constexpr int BG_BK = 32;            // k per ring stage (one summed slice)
constexpr int BG_LDS = BG_BK + 8;    // bf16 a smem row: 80 bytes, conflict-free ldmatrix

// grid (ceil(N / BN), ceil(M / BM), count), WM x WN warps of (BM / WM) x
// (BN / WN) outputs each. Rows of A and B sit n-major in a STAGES-deep
// cp.async ring (32 k per row, 16-byte chunks, neighbouring threads on
// neighbouring chunks) and are read with ldmatrix. A warp loads B's
// fragments of a whole 32-deep slice, then, row tile by row tile, A's, and
// sums each of its 16 x 8 tiles' slice from zero in four registers (two
// mma) and adds it to the total: the first design's order, so every
// product keeps its bits.
template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB) gemm_bf16_kernel(const Bf16Batch batch) {
  constexpr int NT = WM * WN * 32, TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  constexpr int ASZ = BM * BG_LDS, BSZ = BN * BG_LDS;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && (BM * 4) % NT == 0 && (BN * 4) % NT == 0,
                "tile shape");
  const Bf16Gemm p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;
  extern __shared__ __align__(16) unsigned char bg_smem[];
  bf16* As = reinterpret_cast<bf16*>(bg_smem);   // STAGES x ASZ
  bf16* Bs = As + STAGES * ASZ;                   // STAGES x BSZ
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, i8 = lane >> 3, r8 = lane & 7;
  const int KT = (p.K + BG_BK - 1) / BG_BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BG_BK;
    bf16* as = As + stage * ASZ;
    bf16* bs = Bs + stage * BSZ;
#pragma unroll
    for (int i = 0; i < BM * 4 / NT; ++i) {
      const int e = tid + i * NT, r = e >> 2, c = (e & 3) * 8, m = m0 + r, k = k0 + c;
      bool ok = m < p.M && k < p.K;
      const bf16* src = p.A;
      if (p.taps == 1) {
        if (ok) src = p.A + (long)m * p.lda + k;
      } else {
        const int tap = k / p.Kc, cc = k - tap * p.Kc, t = m % p.seq + tap - 1;
        ok = ok && t >= 0 && t < p.seq;
        if (ok) src = p.A + (long)(m + tap - 1) * p.lda + cc;
      }
      cp_async16b(as + r * BG_LDS + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * 4 / NT; ++i) {
      const int e = tid + i * NT, r = e >> 2, c = (e & 3) * 8, n = n0 + r, k = k0 + c;
      const bool ok = n < p.N && k < p.K;
      cp_async16b(bs + r * BG_LDS + c, ok ? p.B + (long)n * p.ldb + k : p.B, ok);
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
    const bf16* as =
        As + (kt % STAGES) * ASZ + (wm * TM + (lane & 15)) * BG_LDS + (lane >> 4) * 8;
    const bf16* bs = Bs + (kt % STAGES) * BSZ + (wn * TN + r8 + (i8 >> 1) * 8) * BG_LDS +
                     (i8 & 1) * 8;
    uint32_t b[2][NI][2];   // B of the slice's two 16-deep steps
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int jp = 0; jp < NI / 2; ++jp) {
        uint32_t r[4];
        ldsm4(r, bs + jp * 16 * BG_LDS + ks * 16);
        b[ks][2 * jp][0] = r[0];
        b[ks][2 * jp][1] = r[1];
        b[ks][2 * jp + 1][0] = r[2];
        b[ks][2 * jp + 1][1] = r[3];
      }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint32_t a[2][4];     // A of row tile i, both steps
      ldsm4(a[0], as + i * 16 * BG_LDS);
      ldsm4(a[1], as + i * 16 * BG_LDS + 16);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float part[4];
        mma_bf16_zero(part, a[0], b[0][j]);
        mma_bf16(part, a[1], b[1][j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[r];
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * TM + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float mk = p.rowmask ? (p.rowmask[m] ? 1.f : 0.f) : 1.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * t4;
        if (n >= p.N) continue;   // N is even: n + 1 < N too
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        if (p.raw) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + (long)m * p.ldc + n) =
              make_float2(v[0], v[1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = rbf(v[e]);
          if (p.bias) y = rbf(y + bf(p.bias[n + e]));
          if (p.act == BF16_ACT_GELU) y = rbf(gelu_erf(y));
          if (p.scale != 1.f) y = rbf(y * p.scale);
          v[e] = y * mk;
        }
        if (p.seqmul) {
          float* c = static_cast<float*>(p.C) + (long)m * p.ldc + n;
          const float* s = p.seqmul + (long)(m / p.mseq) * p.N + n;
          const float2 o = *reinterpret_cast<const float2*>(c);
          *reinterpret_cast<float2*>(c) = make_float2(__fadd_rn(o.x, __fmul_rn(v[0], s[0])),
                                                      __fadd_rn(o.y, __fmul_rn(v[1], s[1])));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + (long)m * p.ldc + n) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
}

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
static int launch_gemm_bf16_tile(const Bf16Batch& batch, int count, int maxM, int maxN,
                                 cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * BG_LDS * (int)sizeof(bf16);
  auto kernel = gemm_bf16_kernel<BM, BN, WM, WN, STAGES, MINB>;
  static int limit = 0;
  raise_smem_limit((const void*)kernel, smem, limit);
  const dim3 grid(ceil_div(maxN, BN), ceil_div(maxM, BM), count);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(batch);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// 0, or why launch_gemm_bf16 refuses a product: the ring's 16-byte copies
// (A and B 16-byte aligned, row strides, K and Kc multiples of 8 bf16), the
// epilogue's pairs (N and ldc even, C 4- or 8-byte aligned).
static int gemm_bf16_refuses(const Bf16Gemm& p) {
  if ((p.taps != 1 && p.taps != 3) || (p.taps == 3 && (p.K != 3 * p.Kc || p.seq < 1)) ||
      (p.seqmul && p.mseq < 1) || (p.raw && (p.seqmul || p.act)) || p.M < 0 || p.N < 0 ||
      p.K < 0)
    return (int)cudaErrorInvalidValue;
  const int cbytes = (p.seqmul || p.raw) ? 8 : 4;
  if (!aligned16(p.A) || !aligned16(p.B) || p.lda % 8 || p.ldb % 8 || p.K % 8 || p.Kc % 8 ||
      p.N % 2 || p.ldc % 2 || ((uintptr_t)p.C % cbytes))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// Launch `count` (<= BG_MAX_BATCH) products in one grid: 128 x 128 tiles on
// 8 warps of 64 x 32 (two blocks a SM, 128 registers a thread) where the
// products make a wave of them, else 64 x 64 on 4 where they make two waves
// of those, else 32 x 32 on 4; a four-stage ring each. The tile does not
// change a sum's order.
static int launch_gemm_bf16(const Bf16Batch& batch, int count, cudaStream_t stream) {
  if (count < 1 || count > BG_MAX_BATCH) return (int)cudaErrorInvalidValue;
  int maxM = 0, maxN = 0;
  long b128 = 0, b64 = 0;
  for (int i = 0; i < count; ++i) {
    const Bf16Gemm& p = batch.g[i];
    if (const int rc = gemm_bf16_refuses(p)) return rc;
    maxM = std::max(maxM, p.M);
    maxN = std::max(maxN, p.N);
    b128 += (long)ceil_div(p.M, 128) * ceil_div(p.N, 128);
    b64 += (long)ceil_div(p.M, 64) * ceil_div(p.N, 64);
  }
  if (!maxM || !maxN) return 0;
  if (b128 >= 132)
    return launch_gemm_bf16_tile<128, 128, 2, 4, 4, 2>(batch, count, maxM, maxN, stream);
  if (b64 >= 2 * 132)
    return launch_gemm_bf16_tile<64, 64, 2, 2, 4, 4>(batch, count, maxM, maxN, stream);
  return launch_gemm_bf16_tile<32, 32, 2, 2, 4, 4>(batch, count, maxM, maxN, stream);
}

static int launch_gemm_bf16_one(const Bf16Gemm& g, cudaStream_t stream) {
  Bf16Batch b;
  b.g[0] = g;
  return launch_gemm_bf16(b, 1, stream);
}

// ---- the MHCA's depthwise conv + LayerNorm ------------------------------------

// For q (from x2), k and v (from x1): the depthwise k=3 conv in bf16 (taps
// bf16(dw); ((l w0 + c w1) + r w2), each product and sum rounded), the
// output mask, the channel LayerNorm with fp32 statistics and affine, stored
// bf16. One warp per frame.
template <int CPL>
__global__ void __launch_bounds__(256) dwconv_ln_bf16_kernel(
    const bf16* __restrict__ x1, long ld1, const bf16* __restrict__ x2, long ld2,
    const unsigned char* __restrict__ mask, long P, int T, int C,
    const float* __restrict__ dw, const float* __restrict__ lnw,
    const float* __restrict__ lnb, float eps, bf16* __restrict__ out) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const int t = (int)(row % T);
  const float mval = mask[row] ? 1.f : 0.f;
  for (int which = 0; which < 3; ++which) {
    const bf16* x = which == 0 ? x2 : x1;
    const long ld = which == 0 ? ld2 : ld1;
    const bf16* xr = x + row * ld;
    const float* w = dw + (long)which * C * 3;
    float y[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      y[i] = 0.f;
      if (c < C) {
        const float left = t > 0 ? bf(xr[c - ld]) : 0.f;
        const float right = t < T - 1 ? bf(xr[c + ld]) : 0.f;
        float s = rbf(rbf(left * rbf(w[c * 3 + 0])) + rbf(bf(xr[c]) * rbf(w[c * 3 + 1])));
        s = rbf(s + rbf(right * rbf(w[c * 3 + 2])));
        y[i] = s * mval;
      }
    }
    const float inv = warp_ln_center(y, lane, C, eps);
    bf16* o = out + (long)which * P * C + row * C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) o[c] = rb(y[i] * inv * lnw[which * C + c] + lnb[which * C + c]);
    }
  }
}

// ---- the attention -------------------------------------------------------------

constexpr int AB_KT = 64;       // keys of a key or value tile
constexpr int AB_STAGES = 3;    // slots of the key / value ring
constexpr int AB_EW = AB_KT + 8;  // a staged row of a tile's e values (floats)
// warps a block at head width dp and sequence length T, each with 16 query
// rows: one for T <= 16; else 8 (128 queries, each key tile read once for
// twice the rows) up to d=64 where T > 64, and 4 otherwise (d=128 needs
// twice the registers a thread)
static int ab_warps(int dp, int T) { return T <= 16 ? 1 : dp <= 64 && T > 64 ? 8 : 4; }
// blocks a SM the registers must allow (128 registers a thread at 8 warps,
// and at 4 up to d=64)
__host__ __device__ constexpr int ab_min_blocks(int dp, int nw) {
  return nw == 8 ? 2 : nw == 4 ? (dp <= 64 ? 4 : 2) : 8;
}

// A warp's 16 x 8 tile of A.B^T on the tensor cores: A's 16 rows in
// registers (fragments af, DP wide), B's 8 rows j*8 .. j*8+7 of a shared
// tile bt (rows of DP + 8 bf16, dims past the operands' width zero), each
// 32-deep slice of the sum from zero and the slices added in order. s: rows
// g (0, 1) and g + 8 (2, 3), columns 2 t4, 2 t4 + 1. The attention's logits
// (as the backward, bf16_bwd.cuh, recomputes them) and the gate's scores.
template <int DP>
__device__ __forceinline__ void scores_16x8(float (&s)[4], const uint32_t (&af)[DP / 16][4],
                                            const bf16* bt, int j, int lane) {
  constexpr int RS = DP + 8;
  s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < DP; c0 += 32) {
    float part[4];
    uint32_t b[4] = {0u, 0u, 0u, 0u};
    if (DP >= 32) {   // (lo, hi) of the 16-deep steps at c0 and c0 + 16
      ldsm4(b, bt + (j * 8 + (lane & 7)) * RS + c0 + (lane >> 3) * 8);
    } else {
      const bf16* p = bt + (j * 8 + (lane >> 2)) * RS + 2 * (lane & 3);
      b[0] = ld32(p);
      b[1] = ld32(p + 8);
    }
    const uint32_t b01[2] = {b[0], b[1]}, b23[2] = {b[2], b[3]};
    mma_bf16_zero(part, af[c0 / 16], b01);
    if (c0 + 16 < DP) mma_bf16(part, af[c0 + 16 < DP ? c0 / 16 + 1 : c0 / 16], b23);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += part[e];
  }
}

// A warp's A fragments of 16 shared rows (row stride RS), DP wide
template <int DP>
__device__ __forceinline__ void load_afrags(uint32_t (&af)[DP / 16][4], const bf16* rows, int rs,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16)
    ldsm4(af[kk / 16], rows + (lane & 15) * rs + kk + (lane >> 4) * 8);
}

// grid (ceil(T / QT), H, R), QT = 16 NW queries a block of NW warps
// (ab_warps); DP the head width d rounded up to 16 (dims past d
// zero-filled). Warp w owns query rows 16w .. 16w+15 of the
// block's tile and keeps their Q fragments in registers; no logits row is
// stored. Key tiles, then key and value tiles, stream through a three-slot
// cp.async ring of 64-key tiles, read with ldmatrix (.trans for V); the
// logits are recomputed from the fragments on each of three passes:
//   (a) the row max (masked keys -FLT_MAX), then across the quad;
//   (b) e = exp(s - max) (0 for a masked or padded key), each tile's e
//       staged in the warp's 16 x 64 fp32 buffer, lane l adding keys l and
//       l + 32 of the tile to its partial sum of each row: over the tiles
//       keys l + 32 jj in jj order, then warp_sum, as the backward sums;
//   (c) P = bf16(e / sum) packed from the C fragments into P.V's A
//       fragments, P.V summed in fp32 over each 32 keys from zero.
// So P, its sum and P.V are the one-row-a-warp design's to the bit. Eight
// keys that are all masked or padded skip their logits (their e and P are
// exact zeros: max and sums do not move). A row (sequence) without a valid
// key writes exactly 0. Shared memory: the ring (3 x 64 x DP+8 bf16), the
// warps' e buffers (16 x 72 fp32 each, a warp's query rows staged there
// first) and the key flags: 63.3 KiB at d=64 and 8 warps, 69.3 KiB at d=128
// and 4 (T=224; two blocks a SM).
template <int DP, int NW>
__global__ void __launch_bounds__(32 * NW, ab_min_blocks(DP, NW)) attn_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned char* __restrict__ mask, int T, int C, int H, bf16* __restrict__ out) {
  constexpr int RS = DP + 8, TILE = AB_KT * RS, CH = DP / 8, EB = 16 * AB_EW;
  constexpr int NT = 32 * NW, QT = 16 * NW;
  static_assert(16 * RS * 2 <= EB * 4, "a warp's query rows fit its e buffer");
  extern __shared__ __align__(16) unsigned char ab_smem[];
  bf16* ring = reinterpret_cast<bf16*>(ab_smem);                        // AB_STAGES x TILE
  float* ebuf = reinterpret_cast<float*>(ring + AB_STAGES * TILE);      // NW x EB
  const int d = C / H, nkt = (T + AB_KT - 1) / AB_KT, T64 = nkt * AB_KT, nu = 4 * nkt;
  unsigned char* km = reinterpret_cast<unsigned char*>(ebuf + NW * EB);  // T64 key flags
  unsigned char* k8 = km + T64;   // T64 / 8 flags: an n8 tile of keys has a valid key
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  float* eb = ebuf + warp * EB;
  const bool live = q0 + warp * 16 < T;   // the warp has a query row

  int any = 0;
  for (int i = tid; i < T64; i += NT) {
    const unsigned char f = i < T && mrow[i];
    km[i] = f;
    any |= f;
  }
  for (int j = tid; j < T64 / 8; j += NT) {
    unsigned char f = 0;
    for (int i = 8 * j; i < 8 * j + 8; ++i) f |= i < T && mrow[i];
    k8[j] = f;
  }
  if (!__syncthreads_or(any)) {
    // no valid key in this row: the reference's output is exactly 0
    for (int e = tid; e < QT * d; e += NT) {
      const int i = e / d, dd = e - i * d;
      if (q0 + i < T) out[base + (long)(q0 + i) * C + dd] = rb(0.f);
    }
    return;
  }

  // ring item u: key tile u (pass a), key tile u - nkt (pass b), then key
  // and value tiles in turn (pass c)
  auto load_item = [&](int u) {
    const int w = u - 2 * nkt;
    const bool isv = w >= 0 && (w & 1);
    const int key0 = (u < nkt ? u : w < 0 ? u - nkt : w >> 1) * AB_KT;
    const bf16* src = isv ? v : k;
    bf16* dst = ring + (u % AB_STAGES) * TILE;
    for (int e = tid; e < AB_KT * CH; e += NT) {
      const int row = e / CH, c = (e - row * CH) * 8, key = key0 + row;
      const bool ok = key < T && c < d;
      cp_async16b(dst + row * RS + c, ok ? src + base + (long)key * C + c : src, ok);
    }
  };
  // warp w's query rows go to the start of its e buffer (read before pass b)
  for (int e = tid; e < QT * CH; e += NT) {
    const int row = e / CH, c = (e - row * CH) * 8;
    const bool ok = q0 + row < T && c < d;
    bf16* dst = reinterpret_cast<bf16*>(ebuf + (row >> 4) * EB) + (row & 15) * RS + c;
    cp_async16b(dst, ok ? q + base + (long)(q0 + row) * C + c : q, ok);
  }
#pragma unroll
  for (int s = 0; s < AB_STAGES - 1; ++s) {
    if (s < nu) load_item(s);
    cp_async_commit();
  }

  uint32_t qf[DP / 16][4];
  float rmax[2] = {-FLT_MAX, -FLT_MAX};   // rows g and g + 8
  float psum[16];                          // this lane's partial sum of each row
#pragma unroll
  for (int i = 0; i < 16; ++i) psum[i] = 0.f;
  float sum[2] = {1.f, 1.f};
  uint32_t pf[AB_KT / 16][4];               // bf16(P) of a key tile: P.V's A fragments
  float o[DP / 8][4];
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jn][e] = 0.f;

  for (int u = 0; u < nu; ++u) {
    cp_async_wait<AB_STAGES - 2>();
    __syncthreads();   // item u (and the queries) landed; slot u - 1 is free
    if (u + AB_STAGES - 1 < nu) load_item(u + AB_STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const bf16* tile = ring + (u % AB_STAGES) * TILE;
    if (u == 0) load_afrags<DP>(qf, reinterpret_cast<const bf16*>(eb), RS, lane);
    if (u < nkt) {                        // (a) the row max
#pragma unroll
      for (int j = 0; j < AB_KT / 8; ++j) {
        if (!k8[u * (AB_KT / 8) + j]) continue;   // eight masked keys: -FLT_MAX
        float s[4];
        scores_16x8<DP>(s, qf, tile, j, lane);
        const int key = u * AB_KT + j * 8 + 2 * t4;
        const bool f0 = km[key], f1 = km[key + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          rmax[hh] = fmaxf(rmax[hh],
                           fmaxf(f0 ? s[2 * hh] : -FLT_MAX, f1 ? s[2 * hh + 1] : -FLT_MAX));
      }
      if (u == nkt - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 1));
          rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 2));
        }
      }
    } else if (u < 2 * nkt) {             // (b) the sums, in the backward's order
      const int key0 = (u - nkt) * AB_KT;
#pragma unroll
      for (int j = 0; j < AB_KT / 8; ++j) {
        const int kl = j * 8 + 2 * t4;
        if (!k8[key0 / 8 + j]) {             // eight masked keys: e = 0
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(eb + (g + 8 * hh) * AB_EW + kl) = make_float2(0.f, 0.f);
          continue;
        }
        float s[4];
        scores_16x8<DP>(s, qf, tile, j, lane);
        const bool f0 = km[key0 + kl], f1 = km[key0 + kl + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(eb + (g + 8 * hh) * AB_EW + kl) =
              make_float2(f0 ? expf(s[2 * hh] - rmax[hh]) : 0.f,
                          f1 ? expf(s[2 * hh + 1] - rmax[hh]) : 0.f);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        psum[i] += eb[i * AB_EW + lane];
        psum[i] += eb[i * AB_EW + lane + 32];
      }
      __syncwarp();   // the buffer is read before the next tile's e
      if (u == 2 * nkt - 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float tot = warp_sum(psum[i]);
          if (i == g) sum[0] = tot;
          if (i == g + 8) sum[1] = tot;
        }
      }
    } else if (!((u - 2 * nkt) & 1)) {    // (c) P of key tile (u - 2 nkt) / 2
      const int key0 = ((u - 2 * nkt) >> 1) * AB_KT;
#pragma unroll
      for (int j = 0; j < AB_KT / 8; ++j) {
        if (!k8[key0 / 8 + j]) {             // eight masked keys: P = 0
          pf[j >> 1][(j & 1) * 2] = pf[j >> 1][(j & 1) * 2 + 1] = 0u;
          continue;
        }
        float s[4];
        scores_16x8<DP>(s, qf, tile, j, lane);
        const int key = key0 + j * 8 + 2 * t4;
        const bool f0 = km[key], f1 = km[key + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(
              f0 ? expf(s[2 * hh] - rmax[hh]) / sum[hh] : 0.f,
              f1 ? expf(s[2 * hh + 1] - rmax[hh]) / sum[hh] : 0.f);
          pf[j >> 1][(j & 1) * 2 + hh] = *reinterpret_cast<const uint32_t*>(&p2);
        }
      }
    } else {                              // (c) P.V over the value tile
      const int i8 = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int c0 = 0; c0 < AB_KT; c0 += 32) {
#pragma unroll
        for (int jn = 0; jn < DP / 8; jn += 2) {
          uint32_t b0[4], b1[4];   // (jn lo, jn hi, jn+1 lo, jn+1 hi) at keys c0, c0 + 16
          ldsm4t(b0, tile + (c0 + r8 + (i8 & 1) * 8) * RS + jn * 8 + (i8 >> 1) * 8);
          ldsm4t(b1, tile + (c0 + 16 + r8 + (i8 & 1) * 8) * RS + jn * 8 + (i8 >> 1) * 8);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float part[4];
            const uint32_t lo[2] = {b0[2 * x], b0[2 * x + 1]}, hi[2] = {b1[2 * x], b1[2 * x + 1]};
            mma_bf16_zero(part, pf[c0 / 16], lo);
            mma_bf16(part, pf[c0 / 16 + 1], hi);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[jn + x][e] += part[e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + warp * 16 + g + 8 * hh;
    if (qrow >= T) continue;
    bf16* orow = out + base + (long)qrow * C;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn) {
      const int dd = jn * 8 + 2 * t4;   // d is a multiple of 8
      if (dd < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + dd) =
            __floats2bfloat162_rn(o[jn][2 * hh], o[jn][2 * hh + 1]);
    }
  }
}

static size_t attn_bf16_smem(int dp, int nw, int T) {
  return sizeof(bf16) * (size_t)AB_STAGES * AB_KT * (dp + 8) +
         sizeof(float) * (size_t)nw * 16 * AB_EW + (size_t)ceil_div(T, AB_KT) * AB_KT * 9 / 8;
}

// blocks, where given: no launch; *blocks gets the instantiation's resident
// blocks a SM at this shape
template <int DP, int NW>
static int launch_attn_bf16_nw(const bf16* q, const bf16* k, const bf16* v,
                               const unsigned char* mask, int R, int T, int C, int H, bf16* out,
                               cudaStream_t stream, int* blocks) {
  const size_t smem = attn_bf16_smem(DP, NW, T);
  auto kernel = attn_bf16_kernel<DP, NW>;
  static int limit = 0;
  raise_smem_limit((const void*)kernel, (int)smem, limit);
  if (blocks)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, 32 * NW, smem);
  kernel<<<dim3(ceil_div(T, 16 * NW), H, R), 32 * NW, smem, stream>>>(q, k, v, mask, T, C, H,
                                                                      out);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

template <int DP>
static int launch_attn_bf16_dp(const bf16* q, const bf16* k, const bf16* v,
                               const unsigned char* mask, int R, int T, int C, int H, bf16* out,
                               cudaStream_t stream, int* blocks) {
  switch (ab_warps(DP, T)) {
    case 1: return launch_attn_bf16_nw<DP, 1>(q, k, v, mask, R, T, C, H, out, stream, blocks);
    case 4: return launch_attn_bf16_nw<DP, 4>(q, k, v, mask, R, T, C, H, out, stream, blocks);
    default:
      return launch_attn_bf16_nw<DP, DP <= 64 ? 8 : 4>(q, k, v, mask, R, T, C, H, out, stream,
                                                       blocks);
  }
}

// q (scaled), k, v, out: (R*T, C) bf16; T <= 512, head width d a multiple of
// 8 up to 128
static int launch_attn_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const unsigned char* mask, int R, int T, int C, int H, bf16* out,
                            cudaStream_t stream, int* blocks = nullptr) {
  const int d = C / H;
  if (d % 8 || C % 8) return (int)cudaErrorMisalignedAddress;
  if (T > 8 * AB_KT) return (int)cudaErrorInvalidValue;
  if (d <= 16) return launch_attn_bf16_dp<16>(q, k, v, mask, R, T, C, H, out, stream, blocks);
  if (d <= 32) return launch_attn_bf16_dp<32>(q, k, v, mask, R, T, C, H, out, stream, blocks);
  if (d <= 64) return launch_attn_bf16_dp<64>(q, k, v, mask, R, T, C, H, out, stream, blocks);
  if (d <= 128) return launch_attn_bf16_dp<128>(q, k, v, mask, R, T, C, H, out, stream, blocks);
  return (int)cudaErrorInvalidValue;
}

// ---- the MHCA forward ------------------------------------------------------------

// bf16 elements of scratch mhca_bf16_forward_impl needs (normalized q/k/v,
// then the projections)
static long mhca_bf16_scratch_elems(int R, int T, int C) { return 6L * R * T * C; }

// One MaskedMHCA forward in bf16. x1 (k/v source), x2 (q source) (R*T, C)
// bf16 with row strides ld1 / ld2; out bf16 with row stride ldo. Weights:
// dw (3, C, 3), lnw / lnb (3, C) fp32; wb (4, C, C), bb (4, C) bf16 (cast).
// The attention's output goes to att (P x C) if given, else over the start of
// the scratch; a backward that keeps the scratch and att reads its
// recompute from them.
static int mhca_bf16_forward_impl(const bf16* x1, long ld1, const bf16* x2, long ld2,
                                  const unsigned char* mask, int R, int T, int C, int H,
                                  const float* dw, const float* lnw, const float* lnb,
                                  const bf16* wb, const bf16* bb, float eps, bf16* out,
                                  long ldo, bf16* scratch, cudaStream_t stream,
                                  bf16* att = nullptr) {
  const long P = (long)R * T, PC = P * C;
  const int d = C / H;
  bf16* nrm = scratch;            // normalized q/k/v, later the attention output
  bf16* qkv = scratch + 3 * PC;   // projected q/k/v
  int rc = with_cpl(C, [&](auto cpl) {
    dwconv_ln_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, stream>>>(
        x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, lnb, eps, nrm);
  });
  if (rc) return rc;

  Bf16Batch b;
  for (int i = 0; i < 3; ++i)
    b.g[i] = bf16_gemm(nrm + i * PC, C, wb + (long)i * C * C, C, qkv + i * PC, C,
                       bb + (long)i * C, i == 2 ? mask : nullptr, (int)P, C, C);
  b.g[0].scale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)d))));
  if ((rc = launch_gemm_bf16(b, 3, stream))) return rc;

  bf16* o = att ? att : nrm;
  rc = launch_attn_bf16(qkv, qkv + PC, qkv + 2 * PC, mask, R, T, C, H, o, stream);
  if (rc) return rc;

  rc = launch_gemm_bf16_one(bf16_gemm(o, C, wb + 3L * C * C, C, out, ldo, bb + 3L * C, mask,
                                      (int)P, C, C),
                            stream);
  return rc;
}

// ---- the CSP gate -------------------------------------------------------------------

constexpr int GB_T = 64;       // frames a gate block (4 warps of 16)
constexpr int GB_N = 64;       // guide tokens a ring tile
constexpr int GB_STAGES = 3;   // slots of the token ring

// shared bytes of a gate block: its frames' rows and the token ring, HP + 8
// bf16 a row
static size_t gate_bf16_smem(int hp) {
  return sizeof(bf16) * (size_t)(GB_T + GB_STAGES * GB_N) * (hp + 8);
}

// The max-sigmoid gate's scores of the 64 frames t0 .. t0+63 (t0 = 64
// blockIdx.x) of sequence r = blockIdx.z under head h = blockIdx.y, on the
// bf16 tensor cores: s(t, n) = sum over the head's hc channels of p(t, c)
// gp(n, c), p slice 4 of the concat (row stride ldp), gp the projected
// guide (R, Ng, emb); the fp32 sums in 32-deep slices from zero, added in
// order (scores_16x8; HP = hc rounded up to 16, zero-filled; a head width
// that is not a multiple of 8 is loaded value by value). The products
// of bf16 values are exact in fp32, as in the JAX body's einsum with
// preferred_element_type f32. Warp w's frames stay as A fragments in
// registers; 64-token tiles of gp stream through a cp.async ring. Every
// score of a frame t < T goes to visit(t, n, s); the frames t0 + 16w + g
// and + 8 get their max over the Ng tokens and how many tokens reach it (mx,
// cnt [0] and [1], on every lane of the frame's quad). The forward
// (gate_bf16_kernel) and the backward's rescoring
// (csp_bwd_bf16.cu:gate_scores_bf16_kernel) both score through it, so the
// backward's scores, max and ties are the forward's to the bit. 128 threads,
// gate_bf16_smem(HP) bytes of shared memory at smem.
template <int HP, class Visit>
__device__ __forceinline__ void gate_bf16_scores(bf16* smem, const bf16* __restrict__ p, long ldp,
                                                 const bf16* __restrict__ gp, int T, int Ng,
                                                 int emb, int H, Visit visit, float (&mx)[2],
                                                 int (&cnt)[2]) {
  constexpr int RS = HP + 8, TILE = GB_N * RS, CH = HP / 8;
  const int hc = emb / H, r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GB_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nt = (Ng + GB_N - 1) / GB_N;
  const bool live = t0 + warp * 16 < T;
  bf16* Ps = smem;                 // GB_T x RS
  bf16* ring = smem + GB_T * RS;   // GB_STAGES x TILE
  const bf16* gh = gp + (long)r * Ng * emb + h * hc;
  // 8 channels of a row (zeros past hc and past the rows): one cp.async where
  // the head's rows start on 16 bytes, else value by value
  auto chunk = [&](bf16* dst, const bf16* src, bool ok, int c) {
    if (hc % 8 == 0) {
      cp_async16b(dst, ok ? src : p, ok);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = ok && c + q < hc ? src[q] : rb(0.f);
    }
  };
  auto load_tile = [&](int i) {
    bf16* dst = ring + (i % GB_STAGES) * TILE;
    for (int e = tid; e < GB_N * CH; e += 128) {
      const int row = e / CH, c = (e - row * CH) * 8, n = i * GB_N + row;
      chunk(dst + row * RS + c, gh + (long)n * emb + c, n < Ng && c < hc, c);
    }
  };
  for (int e = tid; e < GB_T * CH; e += 128) {
    const int row = e / CH, c = (e - row * CH) * 8, t = t0 + row;
    chunk(Ps + row * RS + c, p + ((long)r * T + t) * ldp + h * hc + c, t < T && c < hc, c);
  }
#pragma unroll
  for (int s = 0; s < GB_STAGES - 1; ++s) {
    if (s < nt) load_tile(s);
    cp_async_commit();
  }
  mx[0] = mx[1] = -INFINITY;
  cnt[0] = cnt[1] = 0;
  uint32_t pf[HP / 16][4];
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<GB_STAGES - 2>();
    __syncthreads();   // tile i (and the frames) landed; slot i - 1 is free
    if (i + GB_STAGES - 1 < nt) load_tile(i + GB_STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    if (i == 0) load_afrags<HP>(pf, Ps + warp * 16 * RS, RS, lane);
    const bf16* tile = ring + (i % GB_STAGES) * TILE;
#pragma unroll
    for (int j = 0; j < GB_N / 8; ++j) {
      float s[4];
      scores_16x8<HP>(s, pf, tile, j, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = i * GB_N + j * 8 + 2 * t4 + (e & 1), hh = e >> 1;
        const int t = t0 + warp * 16 + g + 8 * hh;
        if (n >= Ng) continue;
        if (t < T) visit(t, n, s[e]);
        if (s[e] > mx[hh]) {
          mx[hh] = s[e];
          cnt[hh] = 1;
        } else if (s[e] == mx[hh]) {
          ++cnt[hh];
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {   // the frame's quad
      const float om = __shfl_xor_sync(0xffffffffu, mx[hh], off);
      const int oc = __shfl_xor_sync(0xffffffffu, cnt[hh], off);
      if (om > mx[hh]) {
        mx[hh] = om;
        cnt[hh] = oc;
      } else if (om == mx[hh]) {
        cnt[hh] += oc;
      }
    }
}

// frame t of this thread's quad (hh: row g or g + 8 of its warp) in a gate
// block
__device__ __forceinline__ int gate_frame(int hh) {
  return blockIdx.x * GB_T + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * hh;
}

// dst[j] = bf16(src[j] * gate) over a head's och channels, the four lanes
// of a quad in turn: in pairs where och is even (the callers' rows then
// start on 4 bytes), else value by value
__device__ __forceinline__ void gate_bf16_rows(const bf16* src, bf16* dst, int och, float gate) {
  const int q = threadIdx.x & 3;
  if (och % 2) {
    for (int j = q; j < och; j += 4) dst[j] = rb(bf(src[j]) * gate);
    return;
  }
  for (int j = 2 * q; j < och; j += 8) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(src + j);
    *reinterpret_cast<__nv_bfloat162*>(dst + j) =
        __floats2bfloat162_rn(bf(x.x) * gate, bf(x.y) * gate);
  }
}

// The forward's gate: scores (gate_bf16_scores), max, then gate = bf16(
// sigmoid(max / sqrt(hc) + battn[h])) in fp32, multiplied into the bf16
// projection (slice 5, row stride ldd, och channels a head) in place,
// rounded. grid (ceil(T / 64), H, R), 128 threads.
template <int HP>
__global__ void __launch_bounds__(128) gate_bf16_kernel(
    const bf16* __restrict__ p, long ldp, const bf16* __restrict__ gp,
    const float* __restrict__ battn, int T, int Ng, int emb, int H, float sqrt_hc, bf16* dst,
    long ldd, int och) {
  extern __shared__ __align__(16) unsigned char gb_smem[];
  float mx[2];
  int cnt[2];
  gate_bf16_scores<HP>(reinterpret_cast<bf16*>(gb_smem), p, ldp, gp, T, Ng, emb, H,
                       [](int, int, float) {}, mx, cnt);
  const int r = blockIdx.z, h = blockIdx.y;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = gate_frame(hh);
    if (t >= T) continue;
    const float gate = rbf(1.f / (1.f + expf(-(mx[hh] / sqrt_hc + battn[h]))));
    bf16* row = dst + ((long)r * T + t) * ldd + h * och;
    gate_bf16_rows(row, row, och, gate);
  }
}

// Calls f(std::integral_constant<int, HP>{}) with the gate's head width hc
// (up to 128) rounded up to 16.
template <class F>
static int with_gate_hp(int hc, F f) {
  if (hc < 1 || hc > 128) return (int)cudaErrorInvalidValue;
  if (hc <= 16)
    f(std::integral_constant<int, 16>{});
  else if (hc <= 32)
    f(std::integral_constant<int, 32>{});
  else if (hc <= 64)
    f(std::integral_constant<int, 64>{});
  else
    f(std::integral_constant<int, 128>{});
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- the TransformerBlock's glue ----------------------------------------------

// ln11 and ln12 of the fp32 rows of x, one set of fp32 statistics, stored bf16
template <int CPL>
__global__ void __launch_bounds__(256) ln_pair_bf16_kernel(
    const float* __restrict__ x, long P, int C, const float* __restrict__ lnw3,
    const float* __restrict__ lnb3, float eps, bf16* __restrict__ h1, bf16* __restrict__ h2) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const float* xr = x + row * C;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) y[i] = lane + 32 * i < C ? xr[lane + 32 * i] : 0.f;
  const float inv = warp_ln_center(y, lane, C, eps);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      const float yh = y[i] * inv;
      h1[row * C + c] = rb(yh * lnw3[c] + lnb3[c]);
      h2[row * C + c] = rb(yh * lnw3[C + c] + lnb3[C + c]);
    }
  }
}

// res = x * m + float(a) * mult_a[sequence] in fp32 (the residual stream),
// then h = LN(res) * lnw + lnb stored bf16; one warp per frame
template <int CPL>
__global__ void __launch_bounds__(256) residual_ln2_bf16_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ mult_a, const bf16* __restrict__ a, long P, int T, int C,
    const float* __restrict__ lnw, const float* __restrict__ lnb, float eps,
    float* __restrict__ res, bf16* __restrict__ h) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const float mval = mask[row] ? 1.f : 0.f;
  const float* ma = mult_a + (row / T) * C;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    y[i] = 0.f;
    if (c < C) {
      y[i] = __fadd_rn(__fmul_rn(x[row * C + c], mval), __fmul_rn(bf(a[row * C + c]), ma[c]));
      res[row * C + c] = y[i];
    }
  }
  const float inv = warp_ln_center(y, lane, C, eps);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) h[row * C + c] = rb(y[i] * inv * lnw[c] + lnb[c]);
  }
}
