// The event-dependency block's two k=3 "same" convolutions (models/dependency.py:
// feature_expand 1024 -> 12,800 with its ReLU, feature_squeeze 12,800 -> 1024),
// at stride 1, without bias, with MaskedConv1D's row mask, in fp32 (3xTF32)
// on Hopper's wgmma fed by TMA:
//
//   y[m, n] = epi(sum_{tap, c} x[m + tap - 1, c] * W[n, c, tap]) * mask[m]
//
// rows m = (b, t) of the (B, T, C) tensors as they lie, a row outside its own
// sequence read as zero; epi the ReLU (expand) or nothing (squeeze).
// It replaces no Pallas kernel: the JAX package's block runs XLA's conv
// (unav_yolyolva_tpu/models/dependency.py). It was added because cuDNN's fp32
// convolution (TF32 off) ran these two at ~39 TFLOP/s on the FFMA pipes, the
// largest block of device time of a served batch with the block (PERF.md).
// Bound: operations, 2 * M * N * 3 * Kc a conv (4.44 TFLOP a batch of 64 for
// the pair), at 495 / 3 = 165 TFLOP/s in 3xTF32. The design, for this card:
//   - 3xTF32 as in gemm_tc.cuh: each operand split as hi = tf32(x), lo =
//     tf32(x - hi) (round to nearest, ties away), lo.hi + hi.lo + hi.hi
//     summed in fp32; each 32-deep slice of k (32 channels of one tap) is
//     summed from zero by the tensor cores and then added to the fp32 total,
//     in the order (channel block, tap): the tensor cores truncate each
//     sum, and summing the whole of k on them measured 15x fp32's error;
//   - wgmma m64n128k8 (tf32): B, the weight, is split once a call into hi
//     and lo halves laid out (N, 3, Kc) (conv3_split_kernel) and both are
//     TMA'd into the ring, 128-byte swizzled, read by descriptor; A, the
//     activation, is TMA'd once a stage for all three taps, (rows + 2) x 32
//     channels, and each consumer thread builds its fragments from shared
//     memory at the tap's row shift, zeroes the rows outside their sequence
//     by predicate, splits them in registers and feeds wgmma from registers
//     (tf32 wgmma takes both operands K-major, the weight as it is split);
//   - a persistent block a SM of three warpgroups as in bf16_wgmma.cuh (its
//     helpers shared through wgmma.cuh): one producer thread keeps TMA
//     loads in flight on two rings (A stages of the block's 128 rows, B
//     stages of one tap's 128-row weight tile), full and empty mbarriers a
//     stage; two consumer warpgroups each own 64 rows of the block's 128 x
//     128 tile against the same B, their total and one slice buffer in
//     registers (168 registers, no spill); each slice's four k8 steps run as
//     groups retired within the slice's straight-line pass, the A registers
//     of step s + 2 built while step s + 1's group runs; the other consumer
//     fills the tensor cores while one adds its slice. Two consumers of 128
//     rows x 64 columns each (256 x 64 tiles, the weight's bytes shared by
//     twice the rows) measured 8-11 % slower (PERF.md);
//   - the tiles of every level of one call (up to six, the weight shared)
//     in one launch, level-major, within a level in groups of 16 m-tiles
//     (m fastest): a wave reads ~16 row blocks and ~8 weight tiles, not
//     every row of a level per weight tile;
//   - the epilogue from registers: ReLU (expand), the row mask, float2
//     stores straight into the (B, T, N) output: no transpose, no separate
//     ReLU or mask pass.
// Deterministic, no atomics: every output is summed by one thread over the
// same slices in the same order whatever the levels of a launch.
#include <cstring>

#include "gemm_tc.cuh"
#include "wgmma.cuh"

constexpr int DC_MAX_LEVELS = 6;
constexpr int DC_BK = 32;          // channels a stage: one summed slice a tap
constexpr int DC_THREADS = 384;    // producer + two consumer warpgroups
constexpr int DC_GM = 16;          // m-tiles of a group in the order of tiles

struct DcLevel {
  float* y;                        // (M, N)
  const unsigned char* mask;       // (M)
  int M, T, mtiles, tile0;
};

struct DcArgs {
  CUtensorMap a[DC_MAX_LEVELS];    // each level's x (M, Kc)
  CUtensorMap bhi, blo;            // the weight's halves (N, 3, Kc)
  DcLevel lv[DC_MAX_LEVELS];
  int nlev, N, Kc, ntiles, tiles, kcb, relu;
};

// The rings of a 128 x 128 tile: A stages of both consumers' 64 rows and the
// row either side (each consumer's box on 1024 bytes, the swizzle's period),
// B stages of one tap's hi and lo tiles; then the barriers.
struct DcRing {
  static constexpr int ROWS = 64;                              // a consumer's rows
  static constexpr int BN = 128;
  static constexpr int A_BOX = ROWS + 2;
  static constexpr int A_CONS = (A_BOX * 128 + 1023) / 1024 * 1024;
  static constexpr int A_STAGE = 2 * A_CONS;
  static constexpr int B_TILE = BN * 128;
  static constexpr int B_STAGE = 2 * B_TILE;
  static constexpr int A_STAGES = 3;
  static constexpr int B_STAGES = (230400 - A_STAGES * A_STAGE) / B_STAGE;
  static constexpr int SMEM =
      1024 + A_STAGES * A_STAGE + B_STAGES * B_STAGE + 2 * (A_STAGES + B_STAGES) * 8;
};

// d (+)= A.B on a 64 x 128 tile, one k8 step: A from registers (a), B K-major
// from shared memory by descriptor; acc 0 writes d (the slice starts from
// zero), 1 adds to it
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// A thread's fragment of one k8 step (j) of a 128-byte-swizzled A box: rows
// r0 (at shared address row0) and r0 + 8, channels 8j + t and 8j + t + 4
// (wgmma's A fragment, as mma.m16n8k8's: a0 (g, t), a1 (g+8, t), a2 (g,
// t+4), a3 (g+8, t+4)); x = r0 & 7 (the swizzle's row); a row whose read
// falls outside its sequence (ok0, ok1 false) reads zero; split into hi, lo.
__device__ __forceinline__ void dc_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t row0, int j,
                                        int x, int t, bool ok0, bool ok1) {
  const uint32_t c0 = row0 + (((2 * j) ^ x) << 4) + 4 * t;
  const uint32_t c1 = row0 + (((2 * j + 1) ^ x) << 4) + 4 * t;
  float v[4] = {lds_f32(c0), lds_f32(c0 + 1024), lds_f32(c1), lds_f32(c1 + 1024)};
  v[0] = ok0 ? v[0] : 0.f;
  v[2] = ok0 ? v[2] : 0.f;
  v[1] = ok1 ? v[1] : 0.f;
  v[3] = ok1 ? v[3] : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// One consumer's 32-deep slice of one tap into sl, from zero: four k8 steps,
// each lo.hi + hi.lo + hi.hi, a group a step; step s + 2's A registers reuse
// step s's once its group retired (wait 1), and the pass retires every
// group it issued before it ends (a group in flight across a branch makes
// ptxas serialize every wgmma of the kernel). arow: this thread's row 16w +
// g + tap in the consumer's A box; bst: the B stage (hi tile, then lo);
// ok0, ok1: rows g and g + 8 read inside their sequence.
__device__ __forceinline__ void dc_slice(float (&sl)[64], uint32_t arow, uint32_t bst, int x,
                                         int t, bool ok0, bool ok1) {
  uint32_t hi[2][4], lo[2][4];
  auto issue = [&](int set, int j) {
    const uint64_t dh = wg_desc(bst + 32 * j, 0, 1024);
    const uint64_t dl = wg_desc(bst + DcRing::B_TILE + 32 * j, 0, 1024);
    wgmma_fence();
    wgmma_tf32(sl, lo[set], dh, j > 0);
    wgmma_tf32(sl, hi[set], dl, 1);
    wgmma_tf32(sl, hi[set], dh, 1);
    wgmma_commit();
  };
  fence_regs(sl);
  dc_frag(hi[0], lo[0], arow, 0, x, t, ok0, ok1);
  issue(0, 0);
  dc_frag(hi[1], lo[1], arow, 1, x, t, ok0, ok1);
  issue(1, 1);
  wgmma_wait<1>();
  dc_frag(hi[0], lo[0], arow, 2, x, t, ok0, ok1);
  issue(0, 2);
  wgmma_wait<1>();
  dc_frag(hi[1], lo[1], arow, 3, x, t, ok0, ok1);
  issue(1, 3);
  wgmma_wait<0>();
  fence_regs(sl);
}

struct DcTile {
  int lv, m0, n0;
};

// tile -> (level, first row, first column): levels in order, within a level
// groups of DC_GM m-tiles, m fastest within a group
__device__ __forceinline__ DcTile dc_tile(const DcArgs& a, int tile) {
  int lv = 0;
  while (lv + 1 < a.nlev && tile >= a.lv[lv + 1].tile0) ++lv;
  const DcLevel& L = a.lv[lv];
  const int local = tile - L.tile0, span = DC_GM * a.ntiles;
  const int grp = local / span, r = local - grp * span;
  const int gm = min(DC_GM, L.mtiles - grp * DC_GM);
  DcTile d;
  d.lv = lv;
  d.m0 = (grp * DC_GM + r % gm) * 2 * DcRing::ROWS;
  d.n0 = (r / gm) * DcRing::BN;
  return d;
}

// grid: persistent blocks (at most one a SM), each walking the tiles
// blockIdx.x, + gridDim.x, ...; both rings are filled and drained in that
// order: per tile, per 32-channel block an A stage and, per tap, a B stage.
__global__ void __launch_bounds__(DC_THREADS, 1) conv3_tc_kernel(const __grid_constant__ DcArgs args) {
  using R = DcRing;
  extern __shared__ unsigned char dc_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dc_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring_b = ring + R::A_STAGES * R::A_STAGE;
  uint64_t* afull = reinterpret_cast<uint64_t*>(ring_b + R::B_STAGES * R::B_STAGE);
  uint64_t* aempty = afull + R::A_STAGES;
  uint64_t* bfull = aempty + R::A_STAGES;
  uint64_t* bempty = bfull + R::B_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::A_STAGES; ++s) {
      mbar_init(afull + s, 1);
      mbar_init(aempty + s, 8);     // a warp of each consumer
    }
    for (int s = 0; s < R::B_STAGES; ++s) {
      mbar_init(bfull + s, 1);
      mbar_init(bempty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      long ia = 0, ib = 0;
      for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
        const DcTile d = dc_tile(args, tile);
        const CUtensorMap* am = &args.a[d.lv];
        for (int cb = 0; cb < args.kcb; ++cb, ++ia) {
          const int sa = (int)(ia % R::A_STAGES);
          mbar_wait(aempty + sa, (int)((ia / R::A_STAGES) & 1) ^ 1);
          mbar_expect_tx(afull + sa, 2 * R::A_BOX * 128);
          unsigned char* a = ring + sa * R::A_STAGE;
          tma_load_2d(a, am, cb * DC_BK, d.m0 - 1, afull + sa);
          tma_load_2d(a + R::A_CONS, am, cb * DC_BK, d.m0 + R::ROWS - 1, afull + sa);
          for (int tap = 0; tap < 3; ++tap, ++ib) {
            const int sb = (int)(ib % R::B_STAGES);
            mbar_wait(bempty + sb, (int)((ib / R::B_STAGES) & 1) ^ 1);
            mbar_expect_tx(bfull + sb, R::B_STAGE);
            unsigned char* b = ring_b + sb * R::B_STAGE;
            tma_load_3d(b, &args.bhi, cb * DC_BK, tap, d.n0, bfull + sb);
            tma_load_3d(b + R::B_TILE, &args.blo, cb * DC_BK, tap, d.n0, bfull + sb);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t ring_u32 = smem_u32(ring), ring_b_u32 = smem_u32(ring_b);
    long ia = 0, ib = 0;
    for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
      const DcTile d = dc_tile(args, tile);
      const DcLevel& L = args.lv[d.lv];
      const int mb = d.m0 + R::ROWS * c + 16 * w + g;   // this thread's first row
      // rows mb and mb + 8 have a frame before them (okl) or after them (okr)
      // in their sequence
      const int t0 = mb % L.T, t1 = (mb + 8) % L.T;
      const bool okl0 = t0 > 0, okl1 = t1 > 0, okr0 = t0 < L.T - 1, okr1 = t1 < L.T - 1;
      float acc[64], sl[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = sl[i] = 0.f;
      for (int cb = 0; cb < args.kcb; ++cb, ++ia) {
        const int sa = (int)(ia % R::A_STAGES);
        mbar_wait(afull + sa, (int)((ia / R::A_STAGES) & 1));
        // this thread's row 16w + g of the consumer's box at tap 0 (the box
        // starts one row before the consumer's first)
        const uint32_t arow = ring_u32 + sa * R::A_STAGE + c * R::A_CONS + (16 * w + g) * 128;
#pragma unroll
        for (int tap = 0; tap < 3; ++tap, ++ib) {
          const int sb = (int)(ib % R::B_STAGES);
          mbar_wait(bfull + sb, (int)((ib / R::B_STAGES) & 1));
          dc_slice(sl, arow + tap * 128, ring_b_u32 + sb * R::B_STAGE, (g + tap) & 7, t4,
                   tap == 0 ? okl0 : tap == 1 || okr0, tap == 0 ? okl1 : tap == 1 || okr1);
          add_regs(acc, sl);
          mbar_arrive_if(bempty + sb, lane == 0);
        }
        mbar_arrive_if(aempty + sa, lane == 0);
      }
      // the epilogue: thread (w, lane) holds rows 16w + g (+8) and, per 8
      // columns j, columns 8j + 2 t4 (+1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = mb + 8 * i;
        if (m >= L.M) continue;
        const float mk = L.mask[m] ? 1.f : 0.f;
        float* row = L.y + (long)m * args.N;
#pragma unroll
        for (int j = 0; j < R::BN / 8; ++j) {
          const int n = d.n0 + 8 * j + 2 * t4;
          if (n >= args.N) continue;         // N is even: n + 1 < N too
          float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if (args.relu) {
            v0 = v0 < 0.f ? 0.f : v0;
            v1 = v1 < 0.f ? 0.f : v1;
          }
          *reinterpret_cast<float2*>(row + n) = make_float2(v0 * mk, v1 * mk);
        }
      }
    }
  }
}

// w (N, Kc, 3), the conv's weight as PyTorch keeps it -> hi, lo (N, 3, Kc),
// k = tap * Kc + c: one thread an output element
__global__ void __launch_bounds__(256) conv3_split_kernel(const float* __restrict__ w,
                                                          float* __restrict__ hi,
                                                          float* __restrict__ lo, int N, int Kc) {
  const long e = (long)blockIdx.x * 256 + threadIdx.x;
  if (e >= 3L * N * Kc) return;
  const int cc = (int)(e % Kc);
  const long r = e / Kc;
  const int tap = (int)(r % 3);
  const long n = r / 3;
  uint32_t h, l;
  split_tf32(w[(n * Kc + cc) * 3 + tap], h, l);
  hi[e] = __uint_as_float(h);
  lo[e] = __uint_as_float(l);
}

// ---- the host side --------------------------------------------------------------------

// an fp32 tensor map of `rank` dims (inner first), 128-byte swizzle, zeros
// outside
static int dc_map(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dim,
                  const cuuint64_t* stride, const cuuint32_t* box) {
  const WgEncodeTiled enc = wg_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, (void*)base, dim, stride,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One launch of the conv over nlev levels that share the weight: per level
// l, ptrs[3l..3l+2] = x (M, Kc), y (M, N), mask (M) (bool), ints[2l..2l+1] =
// M, T (rows per sequence, M a multiple of it); the weight's halves whi, wlo
// (N, 3, Kc) from unav_conv3_split; relu: the expand's epilogue. Refuses
// (no launch) what TMA and the epilogue do not take: 16-byte aligned x and
// halves, Kc a multiple of 4, N even, y 8-byte aligned.
extern "C" int unav_conv3_tc(int nlev, void* const* ptrs, const long* ints, const float* whi,
                             const float* wlo, int N, int Kc, int relu, void* stream) {
  using R = DcRing;
  if (nlev < 1 || nlev > DC_MAX_LEVELS || N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(whi) || !aligned16(wlo) || Kc % 4 || N % 2) return (int)cudaErrorMisalignedAddress;
  DcArgs a;
  memset(&a, 0, sizeof(a));
  a.nlev = nlev;
  a.N = N;
  a.Kc = Kc;
  a.relu = relu;
  a.ntiles = ceil_div(N, R::BN);
  a.kcb = ceil_div(Kc, DC_BK);
  int tiles = 0;
  for (int l = 0; l < nlev; ++l) {
    const float* x = (const float*)ptrs[3 * l];
    DcLevel& L = a.lv[l];
    L.y = (float*)ptrs[3 * l + 1];
    L.mask = (const unsigned char*)ptrs[3 * l + 2];
    L.M = (int)ints[2 * l];
    L.T = (int)ints[2 * l + 1];
    if (L.M < 0 || L.T < 1 || L.M % L.T) return (int)cudaErrorInvalidValue;
    if (!aligned16(x) || ((uintptr_t)L.y & 7)) return (int)cudaErrorMisalignedAddress;
    L.mtiles = ceil_div(L.M, 2 * R::ROWS);
    L.tile0 = tiles;
    tiles += L.mtiles * a.ntiles;
    const cuuint64_t dim[2] = {(cuuint64_t)Kc, (cuuint64_t)std::max(L.M, 1)};
    const cuuint64_t stride[1] = {(cuuint64_t)Kc * 4};
    const cuuint32_t box[2] = {DC_BK, R::A_BOX};
    if (const int rc = dc_map(&a.a[l], x, 2, dim, stride, box)) return rc;
  }
  a.tiles = tiles;
  if (!tiles) return 0;
  const cuuint64_t dim[3] = {(cuuint64_t)Kc, 3, (cuuint64_t)N};
  const cuuint64_t stride[2] = {(cuuint64_t)Kc * 4, (cuuint64_t)Kc * 12};
  const cuuint32_t box[3] = {DC_BK, 1, R::BN};
  if (const int rc = dc_map(&a.bhi, whi, 3, dim, stride, box)) return rc;
  if (const int rc = dc_map(&a.blo, wlo, 3, dim, stride, box)) return rc;
  static int limit = 0;
  raise_smem_limit((const void*)conv3_tc_kernel, R::SMEM, limit);
  conv3_tc_kernel<<<std::min(wg_sms(), tiles), DC_THREADS, R::SMEM, (cudaStream_t)stream>>>(a);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// The weight's halves for unav_conv3_tc: w (N, Kc, 3) -> hi, lo (N, 3, Kc).
extern "C" int unav_conv3_split(const float* w, float* hi, float* lo, int N, int Kc,
                                void* stream) {
  if (N < 1 || Kc < 1) return (int)cudaErrorInvalidValue;
  const long n = 3L * N * Kc;
  conv3_split_kernel<<<ceil_div(n, 256), 256, 0, (cudaStream_t)stream>>>(w, hi, lo, N, Kc);
  UNAV_RETURN_IF_ERROR();
  return 0;
}
