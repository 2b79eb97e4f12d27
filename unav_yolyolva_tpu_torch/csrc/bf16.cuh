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
// Bound: operations. The product (gemm_bf16_kernel) runs
// mma.sync.m16n8k16 bf16 with fp32 accumulation on the tensor cores: one mma
// per 16-deep step, no hi/lo split, half the bytes of fp32 operands. It keeps
// the 3xTF32 product's cp.async ring and its slice-from-zero sums (each
// 32-deep slice of k summed from zero, then added to the fp32 total). The
// attention (attn_bf16_kernel) runs both of its products on the same mma;
// the dwconv + LayerNorm, the gate's scores and the TBlock's glue stay on the
// FP32 pipes, as in the fp32 kernels. `wgmma` and TMA are later work.
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
constexpr int BG_LDS = BG_BK + 8;    // bf16 a smem row: 80 bytes, conflict-free fragments

// grid (ceil(N / BN), ceil(M / BM), count), WM x WN warps of (BM / WM) x
// (BN / WN) outputs each. Rows of A and B sit n-major in the ring (32 k per
// row, 16-byte chunks, neighbouring threads on neighbouring chunks).
template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32) gemm_bf16_kernel(const Bf16Batch batch) {
  constexpr int NT = WM * WN * 32, TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  constexpr int ASZ = BM * BG_LDS, BSZ = BN * BG_LDS;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && (BM * 4) % NT == 0 && (BN * 4) % NT == 0,
                "tile shape");
  const Bf16Gemm p = batch.g[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= p.M || n0 >= p.N) return;
  extern __shared__ __align__(16) unsigned char bg_smem[];
  bf16* As = reinterpret_cast<bf16*>(bg_smem);   // STAGES x ASZ
  bf16* Bs = As + STAGES * ASZ;                   // STAGES x BSZ
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t4 = lane & 3;
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
    const bf16* as = As + (kt % STAGES) * ASZ + (wm * TM + g) * BG_LDS + 2 * t4;
    const bf16* bs = Bs + (kt % STAGES) * BSZ + (wn * TN + g) * BG_LDS + 2 * t4;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BG_BK; kk += 16) {
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const bf16* q = bs + j * 8 * BG_LDS + kk;
        b[j][0] = ld32(q);
        b[j][1] = ld32(q + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const bf16* q = as + i * 16 * BG_LDS + kk;
        const uint32_t a[4] = {ld32(q), ld32(q + 8 * BG_LDS), ld32(q + 8), ld32(q + 8 * BG_LDS + 8)};
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], a, b[j]);
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

template <int BM, int BN, int WM, int WN, int STAGES>
static int launch_gemm_bf16_tile(const Bf16Batch& batch, int count, int maxM, int maxN,
                                 cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * BG_LDS * (int)sizeof(bf16);
  auto kernel = gemm_bf16_kernel<BM, BN, WM, WN, STAGES>;
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

// Launch `count` (<= BG_MAX_BATCH) products in one grid, with the block tile
// chosen, as the fp32 product's, from the blocks it makes (2 x 132 or more
// where it can).
static int launch_gemm_bf16(const Bf16Batch& batch, int count, cudaStream_t stream) {
  if (count < 1 || count > BG_MAX_BATCH) return (int)cudaErrorInvalidValue;
  int maxM = 0, maxN = 0;
  long b128 = 0, b64 = 0;
  for (int i = 0; i < count; ++i) {
    const Bf16Gemm& p = batch.g[i];
    if (const int rc = gemm_bf16_refuses(p)) return rc;
    maxM = std::max(maxM, p.M);
    maxN = std::max(maxN, p.N);
    b128 += (long)ceil_div(p.M, 128) * ceil_div(p.N, 64);
    b64 += (long)ceil_div(p.M, 64) * ceil_div(p.N, 64);
  }
  if (!maxM || !maxN) return 0;
  if (b128 >= 2 * 132) return launch_gemm_bf16_tile<128, 64, 4, 2, 3>(batch, count, maxM, maxN, stream);
  if (b64 >= 2 * 132) return launch_gemm_bf16_tile<64, 64, 2, 2, 4>(batch, count, maxM, maxN, stream);
  return launch_gemm_bf16_tile<32, 32, 2, 2, 4>(batch, count, maxM, maxN, stream);
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

constexpr int AB_QT = 64;   // queries a block (4 warps of 16 rows)
constexpr int AB_KT = 64;   // keys of a key or value tile

// grid (ceil(T / 64), H, R), 128 threads; DP the head width d rounded up to
// 16 (dims past d zero-filled). Warp w owns query rows 16w .. 16w+15 of the
// block's tile; its logits against all T keys (fp32, masked keys -FLT_MAX)
// stay in shared memory, its softmax runs on its own rows and writes P =
// bf16(exp(s - max) / sum) over the start of each logits row, and P.V sums
// in fp32 over the value tiles, each 32 keys from zero. Keys, then values,
// stream through a two-slot cp.async ring of 64-key tiles. A row (sequence)
// without a valid key writes exactly 0. Shared memory: the query tile (64 x
// DP+8 bf16), the ring (2 x 64 x DP+8 bf16), the logits (64 x T64+4 fp32,
// T64 = T rounded up to 64) and the 64 row maxima.
template <int DP>
__global__ void __launch_bounds__(128) attn_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const unsigned char* __restrict__ mask, int T, int C, int H, bf16* __restrict__ out) {
  constexpr int RS = DP + 8, TILE = AB_KT * RS, CH = DP / 8;
  extern __shared__ __align__(16) unsigned char ab_smem[];
  const int d = C / H, T64 = (T + AB_KT - 1) / AB_KT * AB_KT, SP = T64 + 4, nkt = T64 / AB_KT;
  bf16* Qs = reinterpret_cast<bf16*>(ab_smem);             // AB_QT x RS
  bf16* ring = Qs + AB_QT * RS;                            // 2 x TILE
  float* S = reinterpret_cast<float*>(ring + 2 * TILE);    // AB_QT x SP
  float* rowmax = S + AB_QT * SP;                          // AB_QT
  const bf16* Pb = reinterpret_cast<const bf16*>(S);       // P row r at Pb + r * 2 * SP
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AB_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;

  int any = 0;
  for (int i = tid; i < T; i += 128) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    // no valid key in this row: the reference's output is exactly 0
    for (int e = tid; e < AB_QT * d; e += 128) {
      const int i = e / d, dd = e - i * d;
      if (q0 + i < T) out[base + (long)(q0 + i) * C + dd] = rb(0.f);
    }
    return;
  }

  // ring tile i: the keys of key tile i (i < nkt), else the values of tile i - nkt
  auto load_tile = [&](int i) {
    const bool isv = i >= nkt;
    const int key0 = (isv ? i - nkt : i) * AB_KT;
    const bf16* src = isv ? v : k;
    bf16* dst = ring + (i & 1) * TILE;
    for (int e = tid; e < AB_KT * CH; e += 128) {
      const int row = e / CH, c = (e - row * CH) * 8, key = key0 + row;
      const bool ok = key < T && c < d;
      cp_async16b(dst + row * RS + c, ok ? src + base + (long)key * C + c : src, ok);
    }
  };
  for (int e = tid; e < AB_QT * CH; e += 128) {
    const int row = e / CH, c = (e - row * CH) * 8;
    const bool ok = q0 + row < T && c < d;
    cp_async16b(Qs + row * RS + c, ok ? q + base + (long)(q0 + row) * C + c : q, ok);
  }
  load_tile(0);
  cp_async_commit();

  const int wr = warp * 16;
  float rmax[2] = {-FLT_MAX, -FLT_MAX};   // rows g and g+8, over this lane's keys
  uint32_t qf[DP / 16][4];
  for (int i = 0; i < nkt; ++i) {
    if (i + 1 < 2 * nkt) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile i (and the queries) landed
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        const bf16* p = Qs + (wr + g) * RS + kk + 2 * t4;
        qf[kk / 16][0] = ld32(p);
        qf[kk / 16][1] = ld32(p + 8 * RS);
        qf[kk / 16][2] = ld32(p + 8);
        qf[kk / 16][3] = ld32(p + 8 * RS + 8);
      }
    }
    const bf16* ks = ring + (i & 1) * TILE;
#pragma unroll
    for (int j = 0; j < AB_KT / 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c0 = 0; c0 < DP; c0 += 32) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = c0; kk < c0 + 32 && kk < DP; kk += 16) {
          const bf16* p = ks + (j * 8 + g) * RS + kk + 2 * t4;
          const uint32_t b[2] = {ld32(p), ld32(p + 8)};
          mma_bf16(part, qf[kk / 16], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += part[e];
      }
      const int key = i * AB_KT + j * 8 + 2 * t4;
      const bool ok0 = key < T && mrow[key], ok1 = key + 1 < T && mrow[key + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v0 = ok0 ? s[2 * hh] : -FLT_MAX, v1 = ok1 ? s[2 * hh + 1] : -FLT_MAX;
        *reinterpret_cast<float2*>(S + (wr + g + 8 * hh) * SP + key) = make_float2(v0, v1);
        rmax[hh] = fmaxf(rmax[hh], fmaxf(v0, v1));
      }
    }
    __syncthreads();   // every warp is done with tile i: its slot may be refilled
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 1));
    rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 2));
    if (t4 == 0) rowmax[wr + g + 8 * hh] = rmax[hh];
  }
  __syncwarp();

  // the warp's 16 rows: P = bf16(exp(s - max) / sum), written over the start
  // of the row once the whole row is in registers (T64 <= 512: 16 a lane)
  for (int rr = 0; rr < 16; ++rr) {
    const int row = wr + rr;
    const float* srow = S + row * SP;
    const float mx = rowmax[row];
    float e[16];
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      e[jj] = j < T64 ? expf(srow[j] - mx) : 0.f;
      sum += e[jj];
    }
    sum = warp_sum(sum);
    __syncwarp();
    bf16* prow = reinterpret_cast<bf16*>(S + row * SP);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      if (j < T64) prow[j] = rb(e[jj] / sum);
    }
    __syncwarp();
  }

  float o[DP / 8][4];
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jn][e] = 0.f;
  for (int i = nkt; i < 2 * nkt; ++i) {
    if (i + 1 < 2 * nkt) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // value tile i - nkt landed
    const bf16* vs = ring + (i & 1) * TILE;
    const int key0 = (i - nkt) * AB_KT;
#pragma unroll
    for (int c0 = 0; c0 < AB_KT; c0 += 32) {
      float part[DP / 8][4];
#pragma unroll
      for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jn][e] = 0.f;
#pragma unroll
      for (int kk = c0; kk < c0 + 32; kk += 16) {
        const bf16* p = Pb + (long)(wr + g) * 2 * SP + key0 + kk + 2 * t4;
        const uint32_t a[4] = {ld32(p), ld32(p + 16 * SP), ld32(p + 8), ld32(p + 16 * SP + 8)};
        const bf16* vrow = vs + (kk + (lane & 15)) * RS;
#pragma unroll
        for (int jn = 0; jn < DP / 8; ++jn) {
          uint32_t b[2];
          const unsigned addr = (unsigned)__cvta_generic_to_shared(vrow + jn * 8);
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                       : "=r"(b[0]), "=r"(b[1])
                       : "r"(addr));
          mma_bf16(part[jn], a, b);
        }
      }
#pragma unroll
      for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jn][e] += part[jn][e];
    }
    __syncthreads();   // every warp is done with this slot
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + wr + g + 8 * hh;
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

template <int DP>
static int launch_attn_bf16_dp(const bf16* q, const bf16* k, const bf16* v,
                               const unsigned char* mask, int R, int T, int C, int H, bf16* out,
                               cudaStream_t stream) {
  const int T64 = ceil_div(T, AB_KT) * AB_KT;
  const size_t smem = sizeof(bf16) * (size_t)3 * AB_QT * (DP + 8) +
                      sizeof(float) * ((size_t)AB_QT * (T64 + 4) + AB_QT);
  static int limit = 0;
  raise_smem_limit((const void*)attn_bf16_kernel<DP>, (int)smem, limit);
  const dim3 grid(ceil_div(T, AB_QT), H, R);
  attn_bf16_kernel<DP><<<grid, 128, smem, stream>>>(q, k, v, mask, T, C, H, out);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// q (scaled), k, v, out: (R*T, C) bf16; T <= 512, head width d a multiple of
// 8 up to 128
static int launch_attn_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const unsigned char* mask, int R, int T, int C, int H, bf16* out,
                            cudaStream_t stream) {
  const int d = C / H;
  if (d % 8 || C % 8) return (int)cudaErrorMisalignedAddress;
  if (T > 8 * AB_KT) return (int)cudaErrorInvalidValue;
  if (d <= 16) return launch_attn_bf16_dp<16>(q, k, v, mask, R, T, C, H, out, stream);
  if (d <= 32) return launch_attn_bf16_dp<32>(q, k, v, mask, R, T, C, H, out, stream);
  if (d <= 64) return launch_attn_bf16_dp<64>(q, k, v, mask, R, T, C, H, out, stream);
  if (d <= 128) return launch_attn_bf16_dp<128>(q, k, v, mask, R, T, C, H, out, stream);
  return (int)cudaErrorInvalidValue;
}

// ---- the MHCA forward ------------------------------------------------------------

// bf16 elements of scratch mhca_bf16_forward_impl needs (normalized q/k/v,
// then the projections)
static long mhca_bf16_scratch_elems(int R, int T, int C) { return 6L * R * T * C; }

// One MaskedMHCA forward in bf16. x1 (k/v source), x2 (q source) (R*T, C)
// bf16 with row strides ld1 / ld2; out bf16 with row stride ldo. Weights:
// dw (3, C, 3), lnw / lnb (3, C) fp32; wb (4, C, C), bb (4, C) bf16 (cast).
// marks, if given, gets an event after each of the four launches. The
// attention's output goes to att (P x C) if given, else over the start of
// the scratch; a backward that keeps the scratch and att reads its
// recompute from them.
static int mhca_bf16_forward_impl(const bf16* x1, long ld1, const bf16* x2, long ld2,
                                  const unsigned char* mask, int R, int T, int C, int H,
                                  const float* dw, const float* lnw, const float* lnb,
                                  const bf16* wb, const bf16* bb, float eps, bf16* out,
                                  long ldo, bf16* scratch, cudaStream_t stream,
                                  StageMarks* marks = nullptr, bf16* att = nullptr) {
  const long P = (long)R * T, PC = P * C;
  const int d = C / H;
  bf16* nrm = scratch;            // normalized q/k/v, later the attention output
  bf16* qkv = scratch + 3 * PC;   // projected q/k/v
  int rc = with_cpl(C, [&](auto cpl) {
    dwconv_ln_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, stream>>>(
        x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, lnb, eps, nrm);
  });
  if (rc) return rc;
  mark_stage(marks, stream);

  Bf16Batch b;
  for (int i = 0; i < 3; ++i)
    b.g[i] = bf16_gemm(nrm + i * PC, C, wb + (long)i * C * C, C, qkv + i * PC, C,
                       bb + (long)i * C, i == 2 ? mask : nullptr, (int)P, C, C);
  b.g[0].scale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)d))));
  if ((rc = launch_gemm_bf16(b, 3, stream))) return rc;
  mark_stage(marks, stream);

  bf16* o = att ? att : nrm;
  rc = launch_attn_bf16(qkv, qkv + PC, qkv + 2 * PC, mask, R, T, C, H, o, stream);
  if (rc) return rc;
  mark_stage(marks, stream);

  rc = launch_gemm_bf16_one(bf16_gemm(o, C, wb + 3L * C * C, C, out, ldo, bb + 3L * C, mask,
                                      (int)P, C, C),
                            stream);
  mark_stage(marks, stream);
  return rc;
}

// ---- the CSP gate -------------------------------------------------------------------

// gate_kernel<false> (csp.cuh) on bf16 operands: scores summed in fp32 FFMA
// over bf16 values, max and sigmoid fp32, the gate rounded to bf16 and
// multiplied into the bf16 projection (slice 5) in place, rounded.
__global__ void __launch_bounds__(256) gate_bf16_kernel(
    const bf16* __restrict__ p, long ldp, const bf16* __restrict__ gp,
    const float* __restrict__ battn, int T, int Ng, int emb, int H, float sqrt_hc,
    bf16* __restrict__ dst, long ldd, int och) {
  extern __shared__ float gsm[];
  const int hc = emb / H, hp = hc + 1;
  float* Ps = gsm;                 // GATE_T x hp
  float* Gs = gsm + GATE_T * hp;   // GATE_N x hp
  const int r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GATE_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < GATE_T * hc; e += 256) {
    const int i = e / hc, c = e - i * hc, t = t0 + i;
    Ps[i * hp + c] = t < T ? bf(p[((long)r * T + t) * ldp + h * hc + c]) : 0.f;
  }
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n0 = 0; n0 < Ng; n0 += GATE_N) {
    __syncthreads();
    for (int e = tid; e < GATE_N * hc; e += 256) {
      const int i = e / hc, c = e - i * hc, n = n0 + i;
      Gs[i * hp + c] = n < Ng ? bf(gp[((long)r * Ng + n) * emb + h * hc + c]) : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int c = 0; c < hc; ++c) {
      float pv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(warp * 4 + i) * hp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = Gs[(lane + 32 * j) * hp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], gv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + lane + 32 * j < Ng)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i] = fmaxf(mx[i], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m = warp_max(mx[i]);
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    const float gate = rbf(1.f / (1.f + expf(-(m / sqrt_hc + battn[h]))));
    bf16* row = dst + ((long)r * T + t) * ldd + h * och;
    for (int j = lane; j < och; j += 32) row[j] = rb(bf(row[j]) * gate);
  }
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
