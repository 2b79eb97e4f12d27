// The bf16 backward's strided product for Hopper (bf16_bwd.cuh's design):
// xgemm_kernel, one kernel for the A.B^T, A.B and A^T.B layouts of the
// bf16 compute policy's backward kernels, in one fixed sum order (32-deep
// slices from zero, JAX's row blocks), and its launcher.
#pragma once

#include <cstring>

#include "bf16.cuh"

// ---- the product in every layout ----------------------------------------------

// One strided product, batched over z = (z1, z2) = (z / zdiv, z % zdiv):
//   C[z](m, n) = sum_k A[z](m, k) B[z](k, n),
// each operand element at base + z1 * s_z1 + z2 * s_z2 + row * s_row +
// col * s_col (element strides), so one kernel reads A.B^T, A.B and A^T.B.
// A is bf16 or fp32 (split into three bf16 terms), B bf16. amask zeroes the
// rows of A as it is stored (m of A (M, K), k of A stored (K, M)): a masked
// upstream grad read in place. With b_seq, B stored (K, N) reads at row k
// the row k + b_shift of its sequence of b_seq rows, zero outside (a conv
// tap). K is summed in blocks of kblock (default K): each block from zero
// in 32-deep slices, then added to the total in order, rounded to bf16
// first with round_blocks (the JAX kernels' per-block bf16 weight grads).
// Epilogue: fp32 out (rounded to bf16 values with round_f32), or bf16 out:
// y = bf16(sum); scale != 1: y = bf16(y * scale); rowmask[z1 * rm_z1 + m]
// zeroes a row.
struct XGemm {
  const void* A; long a_z1, a_z2, a_m, a_k; int a_f32;
  const unsigned char* amask; long am_z1;
  const bf16* B; long b_z1, b_z2, b_k, b_n;
  int b_seq, b_shift;
  void* C; long c_z1, c_z2, c_m, c_n; int c_f32, round_f32;
  const unsigned char* rowmask; long rm_z1;
  float scale;
  int M, N, K, Z, zdiv, kblock, round_blocks;
  // set by launch_xgemms: the product's first z of the launch, its tiles,
  // its K in nsplit chunks of chunk (split: their sums), 16-byte copies,
  // C written in pairs
  int z0, mtiles, ntiles, nsplit, chunk, avec, bvec, cvec;
  float* split;
};

static XGemm xgemm(int M, int N, int K) {
  XGemm g;
  memset(&g, 0, sizeof(g));
  g.M = M; g.N = N; g.K = K; g.Z = 1; g.zdiv = 1; g.kblock = K; g.scale = 1.f;
  return g;
}
// operands by layout: row-major A (M, K) with row stride lda, A stored (K, M)
// (A^T.B), B stored (N, K) (A.B^T), B stored (K, N) (A.B)
static void xg_a(XGemm& g, const void* A, long lda, int f32 = 0) {
  g.A = A; g.a_m = lda; g.a_k = 1; g.a_f32 = f32;
}
static void xg_at(XGemm& g, const void* A, long lda, int f32 = 0) {
  g.A = A; g.a_m = 1; g.a_k = lda; g.a_f32 = f32;
}
static void xg_bt(XGemm& g, const bf16* B, long ldb) { g.B = B; g.b_k = 1; g.b_n = ldb; }
static void xg_b(XGemm& g, const bf16* B, long ldb) { g.B = B; g.b_k = ldb; g.b_n = 1; }
static void xg_c(XGemm& g, void* C, long ldc, int f32) {
  g.C = C; g.c_m = ldc; g.c_n = 1; g.c_f32 = f32;
}
static void xg_batch(XGemm& g, int Z, int zdiv, long a1, long a2, long b1, long b2, long c1,
                     long c2) {
  g.Z = Z; g.zdiv = zdiv; g.a_z1 = a1; g.a_z2 = a2; g.b_z1 = b1; g.b_z2 = b2;
  g.c_z1 = c1; g.c_z2 = c2;
}
// a weight grad of a vjp: K in JAX row blocks of `rows`, each rounded
static void xg_blocks(XGemm& g, int rows) { g.kblock = rows; g.round_blocks = 1; }

constexpr int XG_BK = 32;              // k of a ring stage (one summed slice)
constexpr int XG_LDK = XG_BK + 8;      // a k-contiguous shared row: 80 bytes
constexpr int XG_MAX = 4;              // products a launch
struct XGemms { XGemm g[XG_MAX]; int count; };

// shared-memory shapes of a BM x BN tile and its ring (bf16 values; an fp32
// A stage, AF, counted in bf16 values too)
template <int BM, int BN, bool AK, bool BK>
struct XgTile {
  static constexpr int STAGES = 4;
  static constexpr int LDA = AK ? XG_LDK : BM + 8, LDB = BK ? XG_LDK : BN + 8;
  static constexpr int ASZ = AK ? BM * XG_LDK : XG_BK * (BM + 8);
  static constexpr int BSZ = BK ? BN * XG_LDK : XG_BK * (BN + 8);
  static constexpr int LDF = AK ? XG_BK + 4 : BM + 4;    // an fp32 stage's row, floats
  static constexpr int AF = 2 * (AK ? BM : XG_BK) * LDF;
  static int smem(bool f32) {
    return 2 * (STAGES * ((f32 ? AF : ASZ) + BSZ) + (f32 ? 3 * BM * XG_LDK : 0));
  }
};

// 16 bytes global -> shared of which the first `bytes` are src's (the rest
// zero; src is not read when bytes is 0)
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

template <class T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return rb(0.f); }

// A 16-byte chunk of a row of which the first n values are src's (the rest
// zero): one cp.async where the operand's rows start on 16 bytes (vec),
// else value by value.
template <class T>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int n, bool vec,
                                           const T* any) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    cp_async_bytes(dst, n > 0 ? (const void*)src : (const void*)any, n * (int)sizeof(T));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = e < n ? src[e] : zero_of<T>();
  }
}

// grid (max N tiles, max M tiles x chunks, the products' z summed), WM x WN
// warps of (BM / WM) x (BN / WN) outputs. AK: A is k-contiguous (kept
// [m][k]), else m-contiguous (kept [k][m], read with ldmatrix.trans); BK
// likewise for B. MB: a block of the grid sums more than one row block. An
// fp32 A (64 x 64 tiles only) lands as fp32 and is split into its three
// bf16 terms (Pl, [m][k]) once per stage.
template <int BM, int BN, int WM, int WN, bool AK, bool BK, bool MB>
__global__ void __launch_bounds__(WM * WN * 32) xgemm_kernel(
    const __grid_constant__ XGemms gs) {
  using L = XgTile<BM, BN, AK, BK>;
  constexpr int NT = WM * WN * 32, TM = BM / WM, TN = BN / WN, MI = TM / 16, NI = TN / 8;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
  int pi = 0;
#pragma unroll
  for (int i = 1; i < XG_MAX; ++i)
    if (i < gs.count && (int)blockIdx.z >= gs.g[i].z0) pi = i;
  const XGemm& p = gs.g[pi];
  if ((int)blockIdx.x >= p.ntiles || (int)blockIdx.y >= p.mtiles * p.nsplit) return;
  const int z = blockIdx.z - p.z0, z1 = z / p.zdiv, z2 = z - z1 * p.zdiv;
  const int sp = blockIdx.y / p.mtiles, m0 = (blockIdx.y - sp * p.mtiles) * BM;
  const int n0 = blockIdx.x * BN;
  // this block's K: [kbeg, kend) in row blocks of kb, each in 32-deep slices
  const int kbeg = sp * p.chunk, kend = min(p.K, kbeg + p.chunk);
  const int kb = p.nsplit > 1 ? p.chunk : p.kblock, tpb = (kb + XG_BK - 1) / XG_BK;
  const int span = max(kend - kbeg, 0), nblk = (span + kb - 1) / kb;
  const int ntl = nblk ? (nblk - 1) * tpb + (span - (nblk - 1) * kb + XG_BK - 1) / XG_BK : 0;
  const bool f32 = BM == 64 && p.a_f32;
  const int astage = f32 ? L::AF : L::ASZ;
  extern __shared__ __align__(16) unsigned char xg_smem[];
  bf16* As = reinterpret_cast<bf16*>(xg_smem);
  bf16* Bs = As + L::STAGES * astage;
  bf16* Pl = Bs + L::STAGES * L::BSZ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp / WN, wn = warp % WN;
  const int i8 = lane >> 3, r8 = lane & 7;
  const long aoff = z1 * p.a_z1 + z2 * p.a_z2, boff = z1 * p.b_z1 + z2 * p.b_z2;
  const unsigned char* am = p.amask ? p.amask + z1 * p.am_z1 : nullptr;
  const bool avec = p.avec, bvec = p.bvec;

  auto load = [&](int stage, int t) {
    const int b = t / tpb;
    const int k0 = kbeg + b * kb + (t - b * tpb) * XG_BK, bend = min(kend, kbeg + (b + 1) * kb);
    if (f32) {
      float* as = reinterpret_cast<float*>(As + stage * astage);
      const float* A = static_cast<const float*>(p.A) + aoff;
      if (AK) {
#pragma unroll
        for (int e = tid; e < BM * 8; e += NT) {
          const int r = e >> 3, c = (e & 7) * 4, m = m0 + r, k = k0 + c;
          const int n = m < p.M && (!am || am[m]) ? max(0, min(4, bend - k)) : 0;
          load_chunk(as + r * L::LDF + c, A + (long)m * p.a_m + k, n, avec, A);
        }
      } else {
#pragma unroll
        for (int e = tid; e < XG_BK * (BM / 4); e += NT) {
          const int r = e / (BM / 4), c = (e - r * (BM / 4)) * 4, k = k0 + r, m = m0 + c;
          const int n = k < bend && (!am || am[k]) ? max(0, min(4, p.M - m)) : 0;
          load_chunk(as + r * L::LDF + c, A + (long)k * p.a_k + m, n, avec, A);
        }
      }
    } else {
      bf16* as = As + stage * astage;
      const bf16* A = static_cast<const bf16*>(p.A) + aoff;
      if (AK) {
#pragma unroll
        for (int e = tid; e < BM * 4; e += NT) {
          const int r = e >> 2, c = (e & 3) * 8, m = m0 + r, k = k0 + c;
          const int n = m < p.M && (!am || am[m]) ? max(0, min(8, bend - k)) : 0;
          load_chunk(as + r * L::LDA + c, A + (long)m * p.a_m + k, n, avec, A);
        }
      } else {
#pragma unroll
        for (int e = tid; e < XG_BK * (BM / 8); e += NT) {
          const int r = e / (BM / 8), c = (e - r * (BM / 8)) * 8, k = k0 + r, m = m0 + c;
          const int n = k < bend && (!am || am[k]) ? max(0, min(8, p.M - m)) : 0;
          load_chunk(as + r * L::LDA + c, A + (long)k * p.a_k + m, n, avec, A);
        }
      }
    }
    bf16* bs = Bs + stage * L::BSZ;
    const bf16* B = p.B + boff;
    if (BK) {
#pragma unroll
      for (int e = tid; e < BN * 4; e += NT) {
        const int r = e >> 2, c = (e & 3) * 8, n = n0 + r, k = k0 + c;
        const int cnt = n < p.N ? max(0, min(8, bend - k)) : 0;
        load_chunk(bs + r * L::LDB + c, B + (long)n * p.b_n + k, cnt, bvec, B);
      }
    } else {
#pragma unroll
      for (int e = tid; e < XG_BK * (BN / 8); e += NT) {
        const int r = e / (BN / 8), c = (e - r * (BN / 8)) * 8, k = k0 + r, n = n0 + c;
        bool ok = k < bend;
        long row = k;
        if (p.b_seq) {
          const int t = k % p.b_seq + p.b_shift;
          ok = ok && t >= 0 && t < p.b_seq;
          row += p.b_shift;
        }
        const int cnt = ok ? max(0, min(8, p.N - n)) : 0;
        load_chunk(bs + r * L::LDB + c, B + row * p.b_k + n, cnt, bvec, B);
      }
    }
  };

  float acc[MI][NI][4], blk[MB ? MI : 1][MB ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
#pragma unroll
  for (int i = 0; i < (MB ? MI : 1); ++i)
#pragma unroll
    for (int j = 0; j < (MB ? NI : 1); ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) blk[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < ntl) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntl; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();   // stage t landed for every thread; stage t-1 is free
    if (t + L::STAGES - 1 < ntl) load((t + L::STAGES - 1) % L::STAGES, t + L::STAGES - 1);
    cp_async_commit();
    const bf16* as = As + (t % L::STAGES) * astage;
    const bf16* bs = Bs + (t % L::STAGES) * L::BSZ;
    if (f32) {   // the fp32 stage into its three bf16 terms, smallest last
      const float* fs = reinterpret_cast<const float*>(as);
      for (int e = tid; e < BM * XG_BK; e += NT) {
        const int m = e >> 5, k = e & 31;
        const float v = AK ? fs[m * L::LDF + k] : fs[k * L::LDF + m];
        const bf16 hi = rb(v);
        const float r1 = v - bf(hi);
        const bf16 mi = rb(r1);
        Pl[m * XG_LDK + k] = hi;
        Pl[(BM + m) * XG_LDK + k] = mi;
        Pl[(2 * BM + m) * XG_LDK + k] = rb(r1 - bf(mi));
      }
      __syncthreads();
    }
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < XG_BK; kk += 16) {
      uint32_t b[NI][2];
#pragma unroll
      for (int jp = 0; jp < NI / 2; ++jp) {
        uint32_t r[4];
        if (BK)
          ldsm4(r, bs + (wn * TN + jp * 16 + r8 + (i8 >> 1) * 8) * L::LDB + kk + (i8 & 1) * 8);
        else
          ldsm4t(r, bs + (kk + r8 + (i8 & 1) * 8) * L::LDB + wn * TN + jp * 16 + (i8 >> 1) * 8);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
      for (int pl = f32 ? 2 : 0; pl >= 0; --pl) {   // smallest term first
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t a[4];
          const int row = wm * TM + i * 16;
          if (f32)
            ldsm4(a, Pl + (pl * BM + row + (lane & 15)) * XG_LDK + kk + (lane >> 4) * 8);
          else if (AK)
            ldsm4(a, as + (row + (lane & 15)) * L::LDA + kk + (lane >> 4) * 8);
          else
            ldsm4t(a, as + (kk + r8 + (i8 >> 1) * 8) * L::LDA + row + (i8 & 1) * 8);
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], a, b[j]);
        }
      }
    }
    // the slice into its row block; a finished block into the total
    if (MB) {
      const int b = t / tpb;
      const bool last = t - b * tpb == tpb - 1 || t == ntl - 1;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            blk[i % (MB ? MI : 1)][j % (MB ? NI : 1)][r] += part[i][j][r];
            if (last) {
              const float v = blk[i % (MB ? MI : 1)][j % (MB ? NI : 1)][r];
              acc[i][j][r] += p.round_blocks ? rbf(v) : v;
              blk[i % (MB ? MI : 1)][j % (MB ? NI : 1)][r] = 0.f;
            }
          }
    } else {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    }
  }
  cp_async_wait<0>();
  if (!MB && p.round_blocks && ntl) {   // this block's one row block
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = rbf(acc[i][j][r]);
  }

  const int g = lane >> 2, t4 = lane & 3;
  float* sc = p.nsplit > 1 ? p.split + ((long)z * p.nsplit + sp) * p.M * p.N : nullptr;
  const long coff = z1 * p.c_z1 + z2 * p.c_z2;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * TM + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float mk = p.rowmask ? (p.rowmask[z1 * p.rm_z1 + m] ? 1.f : 0.f) : 1.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn * TN + j * 8 + 2 * t4;
        if (n >= p.N) continue;
        const bool two = n + 1 < p.N, pair = two && p.cvec;
        float y[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        if (sc) {
          sc[(long)m * p.N + n] = y[0];
          if (two) sc[(long)m * p.N + n + 1] = y[1];
          continue;
        }
        const long off = coff + (long)m * p.c_m + (long)n * p.c_n;
        if (p.c_f32) {
          float* c = static_cast<float*>(p.C) + off;
          if (p.round_f32) y[0] = rbf(y[0]), y[1] = rbf(y[1]);
          if (pair) {
            *reinterpret_cast<float2*>(c) = make_float2(y[0], y[1]);
          } else {
            c[0] = y[0];
            if (two) c[p.c_n] = y[1];
          }
        } else {
          bf16* c = static_cast<bf16*>(p.C) + off;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = rbf(y[e]);
            if (p.scale != 1.f) y[e] = rbf(y[e] * p.scale);
            y[e] *= mk;
          }
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(y[0], y[1]);
          } else {
            c[0] = rb(y[0]);
            if (two) c[p.c_n] = rb(y[1]);
          }
        }
      }
    }
}

// C = sum over a split product's chunks, in order, written with C's
// strides: grid (ceil(max Z M N / 256), products)
__global__ void __launch_bounds__(256) xgemm_reduce_kernel(
    const __grid_constant__ XGemms gs) {
  const XGemm& p = gs.g[blockIdx.y];
  if (p.nsplit < 2) return;
  const long MN = (long)p.M * p.N, i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= p.Z * MN) return;
  const int z = (int)(i / MN);
  const long r = i - z * MN;
  const int m = (int)(r / p.N), n = (int)(r - (long)m * p.N);
  const float* part = p.split + (long)z * p.nsplit * MN + r;
  float s = 0.f;
  for (int c = 0; c < p.nsplit; ++c) s += part[c * MN];
  const int z1 = z / p.zdiv, z2 = z - z1 * p.zdiv;
  static_cast<float*>(p.C)[z1 * p.c_z1 + z2 * p.c_z2 + m * p.c_m + n * p.c_n] = s;
}

// How a product's K is split: a single fp32 weight grad with fewer 64 x 64
// tiles than two a SM runs its K in chunks on blocks of their own into
// scratch, then adds the chunks in order (xgemm_reduce_kernel). The chunks
// are the row blocks when they are rounded (the same bits as one pass),
// else even slices of K. Returns the chunks (1: no split) and sets chunk.
static int xgemm_plan(const XGemm& p, int max_chunks, int& chunk) {
  chunk = p.K;
  const long tiles = (long)ceil_div(p.N, 64) * ceil_div(p.M, 64);
  if (max_chunks < 2 || p.Z != 1 || !p.c_f32 || p.round_f32 || p.rowmask ||
      tiles >= 2 * 132 || p.K <= 0)
    return 1;
  int c = p.kblock;
  if (!p.round_blocks) {
    const int want = (int)std::min<long>(ceil_div(2 * 132, tiles), ceil_div(p.K, 256));
    c = ceil_div(ceil_div(p.K, std::max(want, 1)), XG_BK) * XG_BK;
  }
  const int n = ceil_div(p.K, c);
  if (n < 2 || n > max_chunks || n > 65535) return 1;
  chunk = c;
  return n;
}

// a product's floats of split scratch (0 where it does not split)
static long xgemm_split_floats(const XGemm& p, int max_chunks) {
  int chunk;
  const int n = xgemm_plan(p, max_chunks, chunk);
  return n > 1 ? (long)n * p.M * p.N : 0;
}

// The most chunks a product's K may be split into when the batch has R rows
// (a product planned into more runs unsplit). The cap decides which
// products split, and so the order of their sums: it stays the first
// design's R + 17.
static inline int xgemm_max_chunks(int R) { return R + 17; }

// The scratch a launch may split its products' K into, and the most chunks
// a product takes.
struct XSplit {
  float* base;
  long floats;
  int max_chunks;
};

// whether an operand's rows and the slices' starts sit on 16 bytes
static bool xg_vec(const void* base, long row, long z1, long z2, bool kcontig, int kblock,
                   int K, int values16) {
  return aligned16(base) && row % values16 == 0 && z1 % values16 == 0 &&
         z2 % values16 == 0 && (!kcontig || kblock % values16 == 0 || kblock >= K);
}

template <int BM, int BN, int WM, int WN, bool AK, bool BK, bool MB>
static int launch_xgemm_tile(const XGemms& b, int gx, int gy, int gz, bool f32,
                             cudaStream_t stream) {
  const int smem = XgTile<BM, BN, AK, BK>::smem(f32);
  auto kernel = xgemm_kernel<BM, BN, WM, WN, AK, BK, MB>;
  static int limit = 0;
  raise_smem_limit((const void*)kernel, smem, limit);
  kernel<<<dim3(gx, gy, gz), WM * WN * 32, smem, stream>>>(b);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// Launches up to XG_MAX products of one layout (A and B each k-contiguous or
// not) as one grid, then, if any splits its K, the pass that adds its
// chunks. Tiles of 128 x 128 on 8 warps where the products make a wave of
// them, else 128 x 64 on 8 (a few long sums: more warps at each tile); 64 x
// 64 on 4 where an A is fp32 (the stage keeps the fp32 tile and its three
// bf16 terms). The layouts are the port's: A.B^T (A and B k-contiguous),
// A.B, A^T.B; a block that sums several row blocks takes A^T.B (a weight
// grad without its split) on 128 x 64 or 64 x 64. The tile does not change
// a sum's order.
static int launch_xgemms(const XGemm* list, int count, cudaStream_t stream,
                         XSplit sp = {nullptr, 0, 0}) {
  if (count < 1 || count > XG_MAX) return (int)cudaErrorInvalidValue;
  XGemms b;
  b.count = 0;
  bool ak = false, bk = false, mb = false, f32 = false, split = false;
  long used = 0, maxmn = 0, wave = 0;
  int zsum = 0;
  for (int i = 0; i < count; ++i) {
    XGemm q = list[i];
    if (q.M <= 0 || q.N <= 0 || q.Z <= 0) continue;
    if (q.K < 0 || q.kblock <= 0 || q.zdiv <= 0 || (q.b_seq && q.b_k == 1))
      return (int)cudaErrorInvalidValue;
    const bool qak = q.a_k == 1, qbk = q.b_k == 1;
    if (b.count && (qak != ak || qbk != bk)) return (int)cudaErrorInvalidValue;
    ak = qak;
    bk = qbk;
    q.nsplit = xgemm_plan(q, sp.max_chunks, q.chunk);
    q.split = nullptr;
    if (q.nsplit > 1) {
      q.split = sp.base + used;
      used += (long)q.nsplit * q.Z * q.M * q.N;
      split = true;
      maxmn = std::max(maxmn, (long)q.Z * q.M * q.N);
    }
    if (used > sp.floats) return (int)cudaErrorInvalidValue;
    const long arow = qak ? q.a_m : q.a_k, brow = qbk ? q.b_n : q.b_k;
    q.avec = xg_vec(q.A, arow, q.a_z1, q.a_z2, qak, q.kblock, q.K, q.a_f32 ? 4 : 8);
    q.bvec = xg_vec(q.B, brow, q.b_z1, q.b_z2, qbk, q.kblock, q.K, 8);
    q.cvec = q.c_n == 1 && q.c_m % 2 == 0 && q.c_z1 % 2 == 0 && q.c_z2 % 2 == 0 &&
             (uintptr_t)q.C % (q.c_f32 ? 8 : 4) == 0;
    mb = mb || (q.nsplit == 1 && q.K > q.kblock);
    f32 = f32 || q.a_f32;
    q.z0 = zsum;
    zsum += q.Z;
    wave += (long)ceil_div(q.M, 128) * ceil_div(q.N, 128) * q.nsplit * q.Z;
    b.g[b.count++] = q;
  }
  if (!b.count) return 0;
  if (zsum > 65535 || (mb && (ak || bk)) || (!ak && bk) || (f32 && bk))
    return (int)cudaErrorInvalidValue;
  const bool big = !f32 && !mb && wave >= 132;
  const int bm = f32 ? 64 : 128, bn = big ? 128 : 64;
  int gx = 1, gy = 1;
  for (int i = 0; i < b.count; ++i) {
    XGemm& q = b.g[i];
    q.mtiles = ceil_div(q.M, bm);
    q.ntiles = ceil_div(q.N, bn);
    gx = std::max(gx, q.ntiles);
    gy = std::max(gy, q.mtiles * q.nsplit);
  }
  for (int i = b.count; i < XG_MAX; ++i) b.g[i] = b.g[0];
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const int z = zsum;
  int rc;
  if (f32 && mb)
    rc = launch_xgemm_tile<64, 64, 2, 2, false, false, true>(b, gx, gy, z, true, stream);
  else if (f32 && ak)
    rc = launch_xgemm_tile<64, 64, 2, 2, true, false, false>(b, gx, gy, z, true, stream);
  else if (f32)
    rc = launch_xgemm_tile<64, 64, 2, 2, false, false, false>(b, gx, gy, z, true, stream);
  else if (mb)
    rc = launch_xgemm_tile<128, 64, 4, 2, false, false, true>(b, gx, gy, z, false, stream);
  else if (big && ak && bk)
    rc = launch_xgemm_tile<128, 128, 4, 2, true, true, false>(b, gx, gy, z, false, stream);
  else if (big && ak)
    rc = launch_xgemm_tile<128, 128, 4, 2, true, false, false>(b, gx, gy, z, false, stream);
  else if (big)
    rc = launch_xgemm_tile<128, 128, 4, 2, false, false, false>(b, gx, gy, z, false, stream);
  else if (ak && bk)
    rc = launch_xgemm_tile<128, 64, 4, 2, true, true, false>(b, gx, gy, z, false, stream);
  else if (ak)
    rc = launch_xgemm_tile<128, 64, 4, 2, true, false, false>(b, gx, gy, z, false, stream);
  else
    rc = launch_xgemm_tile<128, 64, 4, 2, false, false, false>(b, gx, gy, z, false, stream);
  if (rc || !split) return rc;
  xgemm_reduce_kernel<<<dim3(ceil_div(maxmn, 256), b.count), 256, 0, stream>>>(b);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

static int launch_xgemm(const XGemm& p, cudaStream_t stream, XSplit sp = {nullptr, 0, 0}) {
  return launch_xgemms(&p, 1, stream, sp);
}
