// The whole-block TransformerBlock's MLP products for Hopper (bf16 compute
// policy): fc1 and fc2 of tblock_bf16.cu's forward and of tblock_bwd_bf16.cu's
// recompute, the backward's input grads dag = dy2 W2 and dh = du W1, and its
// weight grads dy2^T a and du^T h, with their epilogues. It replaces
// gemm_bf16_kernel (bf16.cuh) and xgemm (bf16_xgemm.cuh) for those products
// only; it keeps their sum order: each 32-deep slice of k summed from zero
// (scale-d 0 on its first k16 step, then one accumulating k16 step) and
// added to the fp32 total in k order; a weight grad's k in JAX row blocks,
// each block's slices added from zero, rounded to bf16 and added to the
// total in order.
// Bound: operations (the MLP's products are ~2/3 of the block's FLOPs at the
// stem). The design, for this card:
//   - a persistent block a SM of three warpgroups: one producer thread keeps
//     TMA loads (cp.async.bulk.tensor, tensor maps encoded on the host) in
//     flight into a ring of 64-deep stages in shared memory, 128-byte
//     swizzled so that the wgmma descriptors read them as they land, full
//     and empty mbarriers a stage; two consumer warpgroups (setmaxnreg 232,
//     the producer 40) share each stage: a block's tile is 128 x BN, each
//     consumer 64 rows of it against the same B (BN 128, or 64 where the
//     128-wide tiles do not give every SM one, and for the weight grads);
//     one consumer's slice adds overlap the other's wgmma, and the producer
//     loads the next tile's stages while the consumers run the epilogue.
//     Consumers that take the tiles in turns (ping-pong, one's epilogue
//     under the other's wgmma) measured within 1.5% of this either way on
//     the TBlock's shapes, and need a turn barrier besides;
//   - a consumer holds its total and two slice buffers in registers (and a
//     row block's sum); slice s + 1's wgmma runs while slice s is added, in
//     passes of two stages that retire every group they issue (a group in
//     flight across a branch makes ptxas serialize every wgmma of the
//     kernel, C7514);
//   - A is K-major (M, K) or MN-major (K, M) (A^T.B: the weight grads); B is
//     K-major (N, K) (A.B^T: fc1, fc2) or MN-major (K, N); the descriptors'
//     transpose bits read the TMA tiles as they land. An MN-major operand's
//     rows are mapped as (row blocks, rows of a block) in three dimensions,
//     so that a stage never reads past its row block (TMA fills zeros);
//   - epilogues from registers, a chunk's loads before its stores: the fp32
//     sums (WG_RAW); bf16(sum) [+ bias] [* row mask] (WG_STORE); + bias and
//     erf GELU (WG_GELU); u = bf16(sum + bias) and a = bf16(GELU(u)) both
//     stored (WG_UA: the backward's recompute); + bias, row mask and out +=
//     y * seqmul in fp32 (WG_RES: fc2's residual tail); du = bf16(GELU'(u) *
//     bf16(sum)) (WG_DU), each step rounded as bf16.cuh's product rounds it.
//     At the stem's shapes the epilogues, not the wgmma, take most of fc1's
//     and fc2's time (PERF.md).
#pragma once

#include <cuda.h>

#include <cstring>

#include "bf16.cuh"
#include "wgmma.cuh"

constexpr int WG_RAW = 0, WG_STORE = 1, WG_GELU = 2, WG_UA = 3, WG_RES = 4, WG_DU = 5;
constexpr int WG_BM = 64, WG_BK = 64;        // a consumer's rows, a stage's k
constexpr int WG_ROWS = 2 * WG_BM;           // a block's tile rows (two consumers)
constexpr int WG_THREADS = 384;              // producer + two consumer warpgroups

// One product C = epi(A . B^T) (B (N, K)) or epi(A . B) (B (K, N)), A (M,
// K), or A^T . B with A stored (K, M) (the launcher's TA and TB say which);
// bf16 operands, rows of 16 bytes. kb: K in row blocks of kb rows (A^T.B
// only), each block's sum rounded to bf16 before it joins the total.
struct WgProduct {
  const bf16* A; long lda;
  const bf16* B; long ldb;
  void* C; long ldc;                // bf16, or fp32 (WG_RAW, WG_RES)
  bf16* C2;                         // WG_UA: a (ldc)
  const bf16* aux;                  // WG_DU: u (ldc)
  const bf16* bias;                 // (N) or nullptr
  const unsigned char* rowmask;     // (M) or nullptr
  const float* seqmul; int mseq;    // WG_RES: (M / mseq, N)
  int M, N, K;
  int kb;                           // 0: K in one block, not rounded
};

static WgProduct wg_product(const bf16* A, long lda, const bf16* B, long ldb, void* C, long ldc,
                            int M, int N, int K) {
  WgProduct g;
  memset(&g, 0, sizeof(g));
  g.A = A; g.lda = lda; g.B = B; g.ldb = ldb; g.C = C; g.ldc = ldc;
  g.M = M; g.N = N; g.K = K; g.mseq = 1;
  return g;
}

// what the kernel reads of a WgProduct, with its tiles and K's blocks
struct WgArgs {
  WgProduct p;
  int mtiles, ntiles;
  int nblk, ksb;                    // K's row blocks, a block's 64-deep stages
};

// d (+)= A.B on a 64 x 128 tile, one k16 step: A and B from shared memory by
// descriptor, A MN-major with TA, B with TB; ACC 0 writes d (scale-d 0: the sum of a
// slice starts from zero), 1 adds to it (d is "+f" in both: an output-only
// operand lets the compiler copy it while the wgmma is in flight)
template <int TA, int TB, int ACC>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(ACC));
}

// d (+)= A.B on a 64 x 64 tile, one k16 step: A and B from shared memory by
// descriptor, A MN-major with TA, B with TB; ACC 0 writes d (scale-d 0: the sum of a
// slice starts from zero), 1 adds to it (d is "+f" in both: an output-only
// operand lets the compiler copy it while the wgmma is in flight)
template <int TA, int TB, int ACC>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(ACC));
}

template <int BN, int TA, int TB, int ACC>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_n128<TA, TB, ACC>(d, da, db);
  else
    wgmma_n64<TA, TB, ACC>(d, da, db);
}

// ---- the kernel ---------------------------------------------------------------------

template <int BN>
struct WgRing {
  static constexpr int A_BYTES = WG_ROWS * WG_BK * 2;    // 128 rows x 128 bytes
  static constexpr int B_BYTES = BN * WG_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = std::min(8, 196608 / STAGE);
  // the ring on 1024 bytes (the swizzle's period), then its barriers: full
  // and empty a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// One consumer's epilogue of its 64 x BN tile at (m0, n0): thread (warp w,
// lane l) holds rows 16w + l/4 (+8) and, per 8 columns j, columns 8j +
// 2(l%4) (+1) (wgmma's fragment of D). A chunk of WG_EPI_J column groups
// at a time: every load of the chunk first (bias, out, seqmul, u; the
// pointers restrict, so that the loads need not wait for the stores), then
// its arithmetic and stores.
constexpr int WG_EPI_J = 4;
template <int BN, int EPI>
__device__ __forceinline__ void wg_epilogue(const WgProduct& p, const float (&acc)[BN / 2],
                                            int m0, int n0) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  const bf16* __restrict__ bias = p.bias;
  const float* __restrict__ seqmul = p.seqmul;
  const bf16* __restrict__ aux = p.aux;
  float* __restrict__ cf = static_cast<float*>(p.C);
  bf16* __restrict__ cb = static_cast<bf16*>(p.C);
  bf16* __restrict__ c2 = p.C2;
  int m[2];
  bool mok[2];
  long row[2], srow[2];
  float mk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = m0 + 16 * w + (l >> 2) + 8 * h;
    mok[h] = m[h] < p.M;
    row[h] = (long)m[h] * p.ldc;
    srow[h] = EPI == WG_RES && mok[h] ? (long)(m[h] / p.mseq) * p.N : 0;
    mk[h] = p.rowmask && mok[h] ? (p.rowmask[m[h]] ? 1.f : 0.f) : 1.f;
  }
  const int nb = n0 + 2 * (l & 3);
#pragma unroll
  for (int jc = 0; jc < BN / 8; jc += WG_EPI_J) {
    float2 bv[WG_EPI_J], ov[2][WG_EPI_J], sv[2][WG_EPI_J];
    __nv_bfloat162 uv[2][WG_EPI_J];
#pragma unroll
    for (int j = 0; j < WG_EPI_J; ++j) {
      const int n = nb + 8 * (jc + j);
      const bool nok = n < p.N;   // N is even: n + 1 < N too
      bv[j] = bias && nok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n))
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = nok && mok[h];
        if constexpr (EPI == WG_RES) {
          ov[h][j] = ok ? *reinterpret_cast<const float2*>(cf + row[h] + n) : make_float2(0.f, 0.f);
          sv[h][j] = ok ? *reinterpret_cast<const float2*>(seqmul + srow[h] + n)
                        : make_float2(0.f, 0.f);
        }
        if constexpr (EPI == WG_DU)
          uv[h][j] = ok ? *reinterpret_cast<const __nv_bfloat162*>(aux + row[h] + n)
                        : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < WG_EPI_J; ++j) {
      const int n = nb + 8 * (jc + j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (n >= p.N || !mok[h]) continue;
        float v[2] = {acc[4 * (jc + j) + 2 * h], acc[4 * (jc + j) + 2 * h + 1]};
        if constexpr (EPI == WG_RAW) {
          *reinterpret_cast<float2*>(cf + row[h] + n) = make_float2(v[0], v[1]);
        } else if constexpr (EPI == WG_DU) {
          *reinterpret_cast<__nv_bfloat162*>(cb + row[h] + n) =
              __floats2bfloat162_rn(gelu_erf_grad(__low2float(uv[h][j])) * rbf(v[0]),
                                    gelu_erf_grad(__high2float(uv[h][j])) * rbf(v[1]));
        } else {
          v[0] = rbf(v[0]);
          v[1] = rbf(v[1]);
          if (bias) v[0] = rbf(v[0] + bv[j].x), v[1] = rbf(v[1] + bv[j].y);
          if constexpr (EPI == WG_UA) {
            *reinterpret_cast<__nv_bfloat162*>(cb + row[h] + n) = __floats2bfloat162_rn(v[0], v[1]);
            *reinterpret_cast<__nv_bfloat162*>(c2 + row[h] + n) =
                __floats2bfloat162_rn(gelu_erf(v[0]), gelu_erf(v[1]));
          } else {
            if constexpr (EPI == WG_GELU) v[0] = rbf(gelu_erf(v[0])), v[1] = rbf(gelu_erf(v[1]));
            v[0] *= mk[h];
            v[1] *= mk[h];
            if constexpr (EPI == WG_RES) {
              *reinterpret_cast<float2*>(cf + row[h] + n) =
                  make_float2(__fadd_rn(ov[h][j].x, __fmul_rn(v[0], sv[h][j].x)),
                              __fadd_rn(ov[h][j].y, __fmul_rn(v[1], sv[h][j].y)));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(cb + row[h] + n) =
                  __floats2bfloat162_rn(v[0], v[1]);
            }
          }
        }
      }
    }
  }
}

// One 32-deep slice into d, from zero: k16 steps kk0 and kk0 + 1 of the
// stage at shared address `stage` (A at a_off in it, B after A), one group.
// A K-major tile steps 32 bytes along its rows, an MN-major one 16 k rows of
// 128 bytes.
template <int BN, int TA, int TB>
__device__ __forceinline__ void issue_slice(float (&d)[BN / 2], uint32_t stage, uint32_t a_off,
                                            int kk0) {
  const uint32_t a = stage + a_off, b = stage + WgRing<BN>::A_BYTES;
  auto da = [&](int kk) {
    return TA ? wg_desc(a + 2048 * kk, 8192, 1024) : wg_desc(a + 32 * kk, 0, 1024);
  };
  auto db = [&](int kk) {
    return TB ? wg_desc(b + 2048 * kk, 8192, 1024) : wg_desc(b + 32 * kk, 0, 1024);
  };
  fence_regs(d);
  wgmma_fence();
  wgmma_step<BN, TA, TB, 0>(d, da(kk0), db(kk0));
  wgmma_step<BN, TA, TB, 1>(d, da(kk0 + 1), db(kk0 + 1));
  wgmma_commit();
}

// grid: persistent blocks (at most one a SM), each walking the output tiles
// blockIdx.x, + gridDim.x, ... (n fastest), its i-th tile on ring stages
// i * nblk * ksb ... (the producer loads them in that order). A K-major A is
// read as (M, K) boxes, an MN-major one as (row blocks, rows, M), B likewise.
template <int BN, int TA, int TB, int EPI>
__global__ void __launch_bounds__(WG_THREADS, 1) wgmma_bf16_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ WgArgs args) {
  using R = WgRing<BN>;
  constexpr int NR = BN / 2;
  constexpr bool RB = TA;           // A^T.B: a weight grad, its row blocks rounded
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const WgProduct& p = args.p;
  const long tiles = (long)args.mtiles * args.ntiles;
  const int ksb = args.ksb, nblk = args.nblk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);      // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, broadcast from lane 0: the compiler then knows it is the
  // same in every lane (and the consumers' loops uniform)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      long it = 0;
      for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (int)(tile / args.ntiles) * WG_ROWS, n0 = (int)(tile % args.ntiles) * BN;
        for (int bk = 0; bk < nblk; ++bk)
          for (int ks = 0; ks < ksb; ++ks, ++it) {
            const int st = (int)(it % R::STAGES), ph = (int)((it / R::STAGES) & 1);
            mbar_wait(empty + st, ph ^ 1);
            mbar_expect_tx(full + st, R::STAGE);
            unsigned char* a = ring + st * R::STAGE;
            if (TA) {
              tma_load_3d(a, &ta, m0, ks * WG_BK, bk, full + st);
              tma_load_3d(a + 8192, &ta, m0 + 64, ks * WG_BK, bk, full + st);
            } else {
              tma_load_2d(a, &ta, ks * WG_BK, m0, full + st);
            }
            if (!TB) {
              tma_load_2d(a + R::A_BYTES, &tb, ks * WG_BK, n0, full + st);
            } else {
#pragma unroll
              for (int h = 0; h < BN / 64; ++h)
                tma_load_3d(a + R::A_BYTES + h * 8192, &tb, n0 + 64 * h, ks * WG_BK, bk,
                            full + st);
            }
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, lane = threadIdx.x & 31;
    // this consumer's 64 rows of a stage's A: 8 KB in (both K-major and
    // MN-major tiles)
    const uint32_t ring_u32 = smem_u32(ring), a_off = 8192 * c;
    long it0 = 0;
    for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      // the slice buffers, zeroed (the wgmma name them as inputs) each tile,
      // so that they are dead through the epilogue
      float s0[NR], s1[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) s0[i] = s1[i] = 0.f;
      const int m0 = (int)(tile / args.ntiles) * WG_ROWS + WG_BM * c;
      const int n0 = (int)(tile % args.ntiles) * BN;
      // the total, and a row block's sum (RB: each slice joins it, the
      // rounded block the total) or the total itself
      float acc[NR], bsum[NR];
      float(&blk)[NR] = RB ? bsum : acc;
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      for (int bk = 0; bk < nblk; ++bk, it0 += ksb) {
        if constexpr (RB) {
#pragma unroll
          for (int i = 0; i < NR; ++i) bsum[i] = 0.f;
        }
        // The block's slices, two a stage (a stage past K, or past its row
        // block, holds TMA's zeros: its slice sums to +0, and the total,
        // never -0, keeps its bits), s0 the first of a stage and s1 the
        // second: slice s + 1's wgmma runs while slice s is added. A pass
        // takes two stages and retires every group it issued before it
        // ends (ptxas serializes all of a function's wgmma when a group
        // stays in flight across a branch), its full barriers waited first;
        // an odd last stage takes a pass of its own. The registers are
        // fenced only before the arrive and after the wait that retires
        // them.
        for (int ks = 0; ks + 1 < ksb; ks += 2) {
          const long it = it0 + ks;
          const int sa = (int)(it % R::STAGES), sb = (int)((it + 1) % R::STAGES);
          mbar_wait(full + sa, (int)((it / R::STAGES) & 1));
          mbar_wait(full + sb, (int)(((it + 1) / R::STAGES) & 1));
          issue_slice<BN, TA, TB>(s0, ring_u32 + sa * R::STAGE, a_off, 0);
          issue_slice<BN, TA, TB>(s1, ring_u32 + sa * R::STAGE, a_off, 2);
          wgmma_wait<1>();
          fence_regs(s0);
          add_regs(blk, s0);
          issue_slice<BN, TA, TB>(s0, ring_u32 + sb * R::STAGE, a_off, 0);
          wgmma_wait<1>();
          fence_regs(s1);
          add_regs(blk, s1);
          mbar_arrive_if(empty + sa, lane == 0);
          issue_slice<BN, TA, TB>(s1, ring_u32 + sb * R::STAGE, a_off, 2);
          wgmma_wait<1>();
          fence_regs(s0);
          add_regs(blk, s0);
          wgmma_wait<0>();
          fence_regs(s1);
          add_regs(blk, s1);
          mbar_arrive_if(empty + sb, lane == 0);
        }
        if (ksb % 2) {
          const long it = it0 + ksb - 1;
          const int sl = (int)(it % R::STAGES);
          mbar_wait(full + sl, (int)((it / R::STAGES) & 1));
          issue_slice<BN, TA, TB>(s0, ring_u32 + sl * R::STAGE, a_off, 0);
          issue_slice<BN, TA, TB>(s1, ring_u32 + sl * R::STAGE, a_off, 2);
          wgmma_wait<1>();
          fence_regs(s0);
          add_regs(blk, s0);
          wgmma_wait<0>();
          fence_regs(s1);
          add_regs(blk, s1);
          mbar_arrive_if(empty + sl, lane == 0);
        }
        if constexpr (RB) {
#pragma unroll
          for (int i = 0; i < NR; ++i) acc[i] += rbf(bsum[i]);
        }
      }
      wg_epilogue<BN, EPI>(p, acc, m0, n0);
    }
  }
}

// ---- the host side --------------------------------------------------------------------

// a bf16 tensor map of a row-major (rows, cols) operand with row stride ld
// values, boxes of box_rows x 64 columns, 128-byte swizzle, zeros outside:
// 2-d, or with kb (a divisor of rows) 3-d as (rows / kb, kb, cols), so that
// a box stops at the end of its block of kb rows
static int wg_map(CUtensorMap* map, const bf16* base, long rows, long cols, long ld,
                  int box_rows, long kb = 0) {
  const WgEncodeTiled enc = wg_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const int rank = kb ? 3 : 2;
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)(kb ? kb : rows),
                             (cuuint64_t)(kb ? rows / kb : 1)};
  const cuuint64_t stride[2] = {(cuuint64_t)ld * 2, (cuuint64_t)(kb ? kb : rows) * ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, (void*)base, dim, stride,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// 0, or why launch_wgmma_bf16 refuses a product: TMA's 16-byte rows and
// bases (K too where A is K-major), the epilogue's pairs (N, ldc even, C
// aligned), whole row blocks of an A^T.B product
static int wgmma_bf16_refuses(const WgProduct& p, int ta, int epi) {
  if (p.M < 0 || p.N < 0 || p.K <= 0 || (epi == WG_RES && (!p.seqmul || p.mseq < 1)) ||
      (epi == WG_UA && !p.C2) || (epi == WG_DU && !p.aux) || (ta && epi != WG_RAW) ||
      p.kb < 0 || (p.kb && (!ta || p.K % p.kb)))
    return (int)cudaErrorInvalidValue;
  const int cbytes = (epi == WG_RAW || epi == WG_RES) ? 8 : 4;
  if (!aligned16(p.A) || !aligned16(p.B) || p.lda % 8 || p.ldb % 8 || (!ta && p.K % 8) ||
      p.N % 2 || p.ldc % 2 || ((uintptr_t)p.C % cbytes) || ((uintptr_t)p.C2 % 4) ||
      ((uintptr_t)p.aux % 4))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <int BN, int TA, int TB, int EPI>
static int launch_wgmma_bf16_tile(const WgProduct& p, cudaStream_t stream) {
  using R = WgRing<BN>;
  WgArgs a;
  a.p = p;
  a.mtiles = ceil_div(p.M, WG_ROWS);
  a.ntiles = ceil_div(p.N, BN);
  const int kb = p.kb ? p.kb : p.K;
  a.nblk = p.K / kb;
  a.ksb = ceil_div(kb, WG_BK);
  CUtensorMap ta, tb;
  int rc = TA ? wg_map(&ta, p.A, p.K, p.M, p.lda, WG_BK, kb)
              : wg_map(&ta, p.A, p.M, p.K, p.lda, WG_ROWS);
  if (!rc) rc = TB ? wg_map(&tb, p.B, p.K, p.N, p.ldb, WG_BK, kb)
                   : wg_map(&tb, p.B, p.N, p.K, p.ldb, BN);
  if (rc) return rc;
  const int grid = (int)std::min<long>(wg_sms(), (long)a.mtiles * a.ntiles);
  auto kernel = wgmma_bf16_kernel<BN, TA, TB, EPI>;
  static int limit = 0;
  raise_smem_limit((const void*)kernel, R::SMEM, limit);
  kernel<<<grid, WG_THREADS, R::SMEM, stream>>>(ta, tb, a);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// Launch one product: A K-major (TA 0) or MN-major (TA 1: A^T.B, the fp32
// sums of row blocks of p.kb rows each rounded), B K-major (TB 0) or
// MN-major (TB 1), epilogue EPI. 128 x 128 tiles a block where they give
// every SM one (not for A^T.B), else 128 x 64. The tile does not change a
// sum's order.
template <int TA, int TB, int EPI>
static int launch_wgmma_bf16(const WgProduct& p, cudaStream_t stream) {
  if (const int rc = wgmma_bf16_refuses(p, TA, EPI)) return rc;
  if (!p.M || !p.N) return 0;
  if constexpr (!TA) {
    if (p.N > 64 && (long)ceil_div(p.M, WG_ROWS) * ceil_div(p.N, 128) >= wg_sms())
      return launch_wgmma_bf16_tile<128, TA, TB, EPI>(p, stream);
  }
  return launch_wgmma_bf16_tile<64, TA, TB, EPI>(p, stream);
}
