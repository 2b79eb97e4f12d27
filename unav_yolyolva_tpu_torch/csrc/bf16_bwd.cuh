// The bf16 compute policy's backward kernels for Hopper: the bf16
// instantiations of the Pallas backward kernels `_mhca_bwd_kernel`
// (ops/pallas_fusion.py), `_csp_bwd_kernel` (ops/pallas_csp.py) and
// `_tblock_bwd_kernel` (ops/pallas_tblock.py) of the JAX package. Their
// arithmetic, which this file follows op by op:
//   - the standalone MHCA's backward is written by hand: the forward is
//     recomputed in bf16, the attention's ds is rounded to bf16 before dq and
//     dk, every weight grad is an fp32 sum over all rows (form MHCA_HAND);
//   - the CSP layer's and the TransformerBlock's are `jax.vjp` of the bf16
//     forward body, once per block of Rj rows of the batch (the TPU kernel's
//     grid): a product's input grad is its fp32 sum rounded to bf16; a weight
//     cast to bf16 gets its fp32 sum over the block's rows rounded to bf16,
//     and the blocks are added in fp32 in order (xgemm's kblock); a bias or
//     depthwise tap broadcast in bf16 gets the bf16 sum of its cotangent in
//     XLA:CPU's reduction order (xla_sums_kernel); the attention's datt is
//     rounded to bf16 and its fp32 ds multiplies k and q unrounded; a value
//     used several times gets its cotangents added in bf16 in the order of
//     JAX's backward pass (form MHCA_VJP).
// Bound: operations. Every product runs on the bf16 tensor cores (mma.sync
// m16n8k16, fp32 sums) through one strided product, xgemm_kernel, that
// takes the A.B^T, A.B and A^T.B layouts and batches (sequence, head) pairs;
// an fp32 operand (the attention's ds, the gate's sparse grads) is split into
// three bf16 terms whose products are exact in the fp32 sums. The attention
// backward materializes each head's (T, T) logits, probabilities and grads
// in device memory, and the reductions, LayerNorms and elementwise glue run
// on the FP32 pipes. This is the first, simple design: its tiles are loaded
// without a copy pipeline; `wgmma`, TMA and a fused attention backward are
// later work.
#pragma once

#include <cstring>

#include "bf16.cuh"

// ---- scratch ------------------------------------------------------------------

// Carves a scratch buffer into 256-byte aligned pieces; with base nullptr it
// only counts the bytes (the *_scratch entry points size a call this way).
struct Bump {
  char* base;
  long used;
  template <class T>
  T* take(long n) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += ((long)sizeof(T) * n + 255) / 256 * 256;
    return p;
  }
};

// ---- the product in every layout ----------------------------------------------

// One strided product per launch, batched over z = (z1, z2) = (z / zdiv,
// z % zdiv):
//   C[z](m, n) = sum_k A[z](m, k) B[z](k, n),
// each operand element at base + z1 * s_z1 + z2 * s_z2 + row * s_row +
// col * s_col (element strides), so one kernel reads A.B^T, A.B and A^T.B.
// A is bf16 or fp32 (split into three bf16 terms), B bf16. K is summed in
// blocks of kblock (default K): each block from zero in 32-deep slices, then
// added to the total in order, rounded to bf16 first with round_blocks (the
// JAX kernels' per-block bf16 weight grads). Epilogue: fp32 out (rounded to
// bf16 values with round_f32), or bf16 out: y = bf16(sum); scale != 1: y =
// bf16(y * scale); rowmask[z1 * rm_z1 + m] zeroes a row.
struct XGemm {
  const void* A; long a_z1, a_z2, a_m, a_k; int a_f32;
  const bf16* B; long b_z1, b_z2, b_k, b_n;
  void* C; long c_z1, c_z2, c_m, c_n; int c_f32, round_f32;
  const unsigned char* rowmask; long rm_z1;
  float scale;
  int M, N, K, Z, zdiv, kblock, round_blocks;
  int klimit;                  // > 0: batch z1's K is min(K, klimit - z1 * K) (split chunks)
  float* split; long split_cap;  // scratch floats for a weight grad's split K, or nullptr
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

constexpr int XG_BM = 64, XG_BN = 64, XG_BK = 32, XG_LDS = XG_BK + 8;

// grid (ceil(N / 64), ceil(M / 64), Z), 128 threads: 2 x 2 warps of 32 x 32
__global__ void __launch_bounds__(128) xgemm_kernel(const XGemm p) {
  __shared__ __align__(16) bf16 As[3][XG_BM * XG_LDS];
  __shared__ __align__(16) bf16 Bs[XG_BN * XG_LDS];
  const int z = blockIdx.z, z1 = z / p.zdiv, z2 = z - z1 * p.zdiv;
  const int m0 = blockIdx.y * XG_BM, n0 = blockIdx.x * XG_BN;
  const int K = p.klimit ? min(p.K, p.klimit - z1 * p.K) : p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const long aoff = z1 * p.a_z1 + z2 * p.a_z2, boff = z1 * p.b_z1 + z2 * p.b_z2;
  const float* Af = static_cast<const float*>(p.A) + aoff;
  const bf16* Ab = static_cast<const bf16*>(p.A) + aoff;
  const bf16* B = p.B + boff;
  const bool akf = p.a_k == 1, bkf = p.b_k == 1;
  const int planes = p.a_f32 ? 3 : 1;

  float acc[2][4][4], blk[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = blk[i][j][r] = 0.f;

  for (int kb0 = 0; kb0 < K; kb0 += p.kblock) {
    const int kend = min(K, kb0 + p.kblock);
    for (int k0 = kb0; k0 < kend; k0 += XG_BK) {
      __syncthreads();   // the last slice's readers are done
      for (int e = tid; e < XG_BM * XG_BK; e += 128) {
        const int m = akf ? e >> 5 : e & 63, k = akf ? e & 31 : e >> 6;
        const int gm = m0 + m, gk = k0 + k;
        const bool ok = gm < p.M && gk < kend;
        const long off = (long)gm * p.a_m + (long)gk * p.a_k;
        if (p.a_f32) {
          const float v = ok ? Af[off] : 0.f;
          const bf16 hi = rb(v);
          const float r1 = v - bf(hi);
          const bf16 mi = rb(r1);
          As[0][m * XG_LDS + k] = hi;
          As[1][m * XG_LDS + k] = mi;
          As[2][m * XG_LDS + k] = rb(r1 - bf(mi));
        } else {
          As[0][m * XG_LDS + k] = ok ? Ab[off] : rb(0.f);
        }
      }
      for (int e = tid; e < XG_BN * XG_BK; e += 128) {
        const int n = bkf ? e >> 5 : e & 63, k = bkf ? e & 31 : e >> 6;
        const int gn = n0 + n, gk = k0 + k;
        Bs[n * XG_LDS + k] =
            gn < p.N && gk < kend ? B[(long)gk * p.b_k + (long)gn * p.b_n] : rb(0.f);
      }
      __syncthreads();
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < XG_BK; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16* q = Bs + (wn * 32 + j * 8 + g) * XG_LDS + kk + 2 * t4;
          b[j][0] = ld32(q);
          b[j][1] = ld32(q + 8);
        }
        for (int pl = planes - 1; pl >= 0; --pl) {   // smallest term first
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bf16* q = As[pl] + (wm * 32 + i * 16 + g) * XG_LDS + kk + 2 * t4;
            const uint32_t a[4] = {ld32(q), ld32(q + 8 * XG_LDS), ld32(q + 8),
                                   ld32(q + 8 * XG_LDS + 8)};
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b[j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) blk[i][j][r] += part[i][j][r];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[i][j][r] += p.round_blocks ? rbf(blk[i][j][r]) : blk[i][j][r];
          blk[i][j][r] = 0.f;
        }
  }

  const long coff = z1 * p.c_z1 + z2 * p.c_z2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
      const float mk = p.rowmask ? (p.rowmask[z1 * p.rm_z1 + m] ? 1.f : 0.f) : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t4 + e;
          if (n >= p.N) continue;
          const long off = coff + (long)m * p.c_m + (long)n * p.c_n;
          const float v = acc[i][j][2 * h + e];
          if (p.c_f32) {
            static_cast<float*>(p.C)[off] = p.round_f32 ? rbf(v) : v;
          } else {
            float y = rbf(v);
            if (p.scale != 1.f) y = rbf(y * p.scale);
            static_cast<bf16*>(p.C)[off] = rb(y * mk);
          }
        }
    }
}

// C = sum over the nsplit partial planes, in order (a split weight grad's
// chunks), written with C's strides
__global__ void xgemm_reduce_kernel(const float* __restrict__ part, int nsplit, int M, int N,
                                    float* __restrict__ C, long c_m, long c_n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)M * N) return;
  const long m = i / N, n = i - m * N, plane = (long)M * N;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += part[z * plane + i];
  C[m * c_m + n * c_n] = s;
}

// Launches one product. A single fp32 product with fewer tiles than two a
// SM (a weight grad: few M x N tiles over a long K) and which has
// `split` scratch runs its K in chunks on separate blocks into the scratch,
// then adds the chunks in order (xgemm_reduce_kernel): the chunks are the
// row blocks when they are rounded (the same bits as one pass), else even
// slices of K.
static int launch_xgemm(const XGemm& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.Z <= 0) return 0;
  if (p.K < 0 || p.kblock <= 0 || p.zdiv <= 0 || p.Z > 65535) return (int)cudaErrorInvalidValue;
  const long tiles = (long)ceil_div(p.N, XG_BN) * ceil_div(p.M, XG_BM);
  if (p.split && p.Z == 1 && p.c_f32 && !p.round_f32 && !p.rowmask && tiles < 2 * 132) {
    int chunk = p.kblock;
    if (!p.round_blocks) {
      const int want = (int)std::min<long>(ceil_div(2 * 132, tiles), ceil_div(p.K, 256));
      chunk = ceil_div(ceil_div(p.K, std::max(want, 1)), XG_BK) * XG_BK;
    }
    const int nsplit = ceil_div(p.K, chunk);
    if (nsplit > 1 && (long)nsplit * p.M * p.N <= p.split_cap && nsplit <= 65535) {
      XGemm q = p;
      q.K = chunk;
      q.klimit = p.K;
      q.kblock = chunk;
      q.Z = nsplit;
      q.zdiv = 1;
      q.a_z1 = (long)chunk * p.a_k;
      q.b_z1 = (long)chunk * p.b_k;
      q.C = p.split;
      q.c_m = p.N;
      q.c_n = 1;
      q.c_z1 = (long)p.M * p.N;
      q.split = nullptr;
      xgemm_kernel<<<dim3(ceil_div(p.N, XG_BN), ceil_div(p.M, XG_BM), nsplit), 128, 0,
                     stream>>>(q);
      UNAV_RETURN_IF_ERROR();
      xgemm_reduce_kernel<<<ceil_div((long)p.M * p.N, 256), 256, 0, stream>>>(
          p.split, nsplit, p.M, p.N, static_cast<float*>(p.C), p.c_m, p.c_n);
      UNAV_RETURN_IF_ERROR();
      return 0;
    }
  }
  const dim3 grid(ceil_div(p.N, XG_BN), ceil_div(p.M, XG_BM), p.Z);
  xgemm_kernel<<<grid, 128, 0, stream>>>(p);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- bf16 sums in XLA:CPU's order -------------------------------------------------

// XLA:CPU reduces a bf16 sum with each partial sum rounded, after its
// tree-reduction rewrite: every reduced dimension longer than 32 is padded
// with zeros to a multiple of 32 (half before it, the rest after), summed in
// windows of 32 (a dimension of at most 32 is one window), each window
// sequentially in row-major order over the reduced dims; the window sums are
// reduced again the same way, down to one value (ops/bf16_grad.py:xla_sum).
__device__ __forceinline__ void xla_window(int n, int& size, int& lo) {
  if (n <= 32) {
    size = n;
    lo = 0;
  } else {
    size = 32;
    lo = ((n + 31) / 32 * 32 - n) / 2;
  }
}

template <int L>
struct XlaLevel {
  // the sum of window (w0, w1) of level L over the level-(L-1) values (n0,
  // n1: each level's dims)
  template <class F>
  __device__ static float sum(const int* n0, const int* n1, int w0, int w1, F& leaf) {
    int s0, lo0, s1, lo1;
    xla_window(n0[L - 1], s0, lo0);
    xla_window(n1[L - 1], s1, lo1);
    float s = 0.f;
    for (int k0 = w0 * s0 - lo0; k0 < w0 * s0 - lo0 + s0; ++k0) {
      if (k0 < 0 || k0 >= n0[L - 1]) continue;
      for (int k1 = w1 * s1 - lo1; k1 < w1 * s1 - lo1 + s1; ++k1) {
        if (k1 < 0 || k1 >= n1[L - 1]) continue;
        s = rbf(s + XlaLevel<L - 1>::sum(n0, n1, k0, k1, leaf));
      }
    }
    return s;
  }
};
template <>
struct XlaLevel<0> {
  template <class F>
  __device__ static float sum(const int*, const int*, int i0, int i1, F& leaf) {
    return leaf(i0, i1);
  }
};

// The XLA-order bf16 sum of leaf(i0, i1) over a (D0, D1) array (a 1-d sum
// is (1, D)); D0, D1 <= 32^4.
template <class F>
__device__ float xla_sum2(int D0, int D1, F& leaf) {
  int n0[5], n1[5];
  n0[0] = D0;
  n1[0] = D1;
  int L = 0;
  while (n0[L] > 1 || n1[L] > 1 || L == 0) {
    n0[L + 1] = n0[L] <= 32 ? 1 : (n0[L] + 31) / 32;
    n1[L + 1] = n1[L] <= 32 ? 1 : (n1[L] + 31) / 32;
    ++L;
    if (L == 4) break;
  }
  switch (L) {
    case 1: return XlaLevel<1>::sum(n0, n1, 0, 0, leaf);
    case 2: return XlaLevel<2>::sum(n0, n1, 0, 0, leaf);
    case 3: return XlaLevel<3>::sum(n0, n1, 0, 0, leaf);
    default: return XlaLevel<4>::sum(n0, n1, 0, 0, leaf);
  }
}

// out[c * ostride] (+)= sum over the JAX blocks in order, in fp32, of the
// block's bf16 sum in XLA's order of v(row, c) = a[(row + shift) within its
// sequence][c] (0 outside it), times b[row][c] rounded to bf16 when b is
// given. A block is Rj sequences of T rows, laid out as the JAX program
// holds them: padded to tpad rows (zeros). twod: the sum runs over (Rj,
// tpad), the depthwise taps' broadcast; else over Rj * tpad rows, the
// bias of a product's 2-d (rows, N) result.
struct XJob {
  const bf16* a; long lda; int shift;
  const bf16* b; long ldb;
  float* out; long ostride;
  int C, T, tpad, twod, accumulate;
  long woff;                   // launch_xla_sums: where its window sums go in the work
};
constexpr int XJ_MAX = 16;
struct XJobs { XJob j[XJ_MAX]; };

static XJob xjob(const bf16* a, long lda, float* out, int C, int T, int tpad) {
  XJob j;
  j.a = a; j.lda = lda; j.shift = 0; j.b = nullptr; j.ldb = 0; j.out = out; j.ostride = 1;
  j.C = C; j.T = T; j.tpad = tpad; j.twod = 0; j.accumulate = 0; j.woff = 0;
  return j;
}

// the JAX block's reduced dims of a job: (Rj, tpad), or (1, Rj * tpad) rows
__host__ __device__ inline void xla_dims(const XJob& jb, int Rj, int& D0, int& D1) {
  D0 = jb.twod ? Rj : 1;
  D1 = jb.twod ? jb.tpad : Rj * jb.tpad;
}
__host__ __device__ inline int xla_count(int n) { return n <= 32 ? 1 : (n + 31) / 32; }

// v(i0, i1) of job jb's block starting at row0, column c (XJob's comment)
struct XlaLeaf {
  const XJob& jb;
  long row0;
  int c;
  __device__ float operator()(int i0, int i1) const {
    int r, t;
    if (jb.twod) {
      r = i0;
      t = i1;
    } else {
      r = i1 / jb.tpad;
      t = i1 - r * jb.tpad;
    }
    if (t >= jb.T) return 0.f;
    const int ts = t + jb.shift;
    if (ts < 0 || ts >= jb.T) return 0.f;
    const long row = row0 + (long)r * jb.T + t;
    float v = bf(jb.a[(row + jb.shift) * jb.lda + c]);
    if (jb.b) v = rbf(v * bf(jb.b[row * jb.ldb + c]));
    return v;
  }
};

// The first level of every job's tree in parallel, one window of one block
// and one column a thread: grid (ceil(Cmax / 64), nblocks * wmax, jobs), the
// window's bf16 sum, in XLA's order, into win[job][block][window][c].
__global__ void __launch_bounds__(64) xla_windows_kernel(const XJobs jobs, int Rj, int wmax,
                                                         float* __restrict__ win) {
  const XJob& jb = jobs.j[blockIdx.z];
  const int c = blockIdx.x * 64 + threadIdx.x;
  const int blk = blockIdx.y / wmax, w = blockIdx.y - blk * wmax;
  int D0, D1;
  xla_dims(jb, Rj, D0, D1);
  const int c1 = xla_count(D1), nwin = xla_count(D0) * c1;
  if (c >= jb.C || w >= nwin) return;
  const XlaLeaf leaf{jb, (long)blk * Rj * jb.T, c};
  const int w0 = w / c1, w1 = w - w0 * c1;
  int s0, lo0, s1, lo1;
  xla_window(D0, s0, lo0);
  xla_window(D1, s1, lo1);
  float s = 0.f;
  for (int k0 = w0 * s0 - lo0; k0 < w0 * s0 - lo0 + s0; ++k0) {
    if (k0 < 0 || k0 >= D0) continue;
    for (int k1 = w1 * s1 - lo1; k1 < w1 * s1 - lo1 + s1; ++k1) {
      if (k1 < 0 || k1 >= D1) continue;
      s = rbf(s + leaf(k0, k1));
    }
  }
  win[jb.woff + ((long)blk * nwin + w) * jb.C + c] = s;
}

// The rest of each tree from the window sums (XLA reduces them by the same
// rule), and the blocks added in fp32 in order: one column of one job a
// thread, grid (ceil(Cmax / 64), jobs).
__global__ void __launch_bounds__(64) xla_sums_kernel(const XJobs jobs, int nblocks, int Rj,
                                                      const float* __restrict__ win) {
  const XJob& jb = jobs.j[blockIdx.y];
  const int c = blockIdx.x * 64 + threadIdx.x;
  if (c >= jb.C) return;
  int D0, D1;
  xla_dims(jb, Rj, D0, D1);
  const int c0 = xla_count(D0), c1 = xla_count(D1);
  float tot = jb.accumulate ? jb.out[(long)c * jb.ostride] : 0.f;
  for (int blk = 0; blk < nblocks; ++blk) {
    const float* wb = win + jb.woff + (long)blk * c0 * c1 * jb.C + c;
    auto leaf = [&](int i0, int i1) -> float { return wb[(long)(i0 * c1 + i1) * jb.C]; };
    tot += xla_sum2(c0, c1, leaf);
  }
  jb.out[(long)c * jb.ostride] = tot;
}

// floats of work launch_xla_sums needs for jobs over R rows of sequences
// padded to at most tpad, C columns at most, njobs jobs (a bound)
static long xla_sums_work_floats(int R, int tpad, int C, int njobs) {
  return (long)njobs * C * (2L * R * (tpad / 32 + 2) + 2);
}

// The jobs' sums: xla_windows_kernel, then xla_sums_kernel; work holds the
// window sums (xla_sums_work_floats).
static int launch_xla_sums(const XJobs& jobs, int count, int nblocks, int Rj, float* work,
                           long work_floats, cudaStream_t stream) {
  if (count < 1 || count > XJ_MAX) return (int)cudaErrorInvalidValue;
  XJobs jj = jobs;
  int cmax = 1, wmax = 1;
  long total = 0;
  for (int i = 0; i < count; ++i) {
    XJob& jb = jj.j[i];
    if (jb.tpad < jb.T || Rj > 1024 || jb.tpad > 1024 * 32) return (int)cudaErrorInvalidValue;
    int D0, D1;
    xla_dims(jb, Rj, D0, D1);
    const int nwin = xla_count(D0) * xla_count(D1);
    cmax = std::max(cmax, jb.C);
    wmax = std::max(wmax, nwin);
    jb.woff = total;
    total += (long)nblocks * nwin * jb.C;
  }
  if (total > work_floats || (long)nblocks * wmax > 65535) return (int)cudaErrorInvalidValue;
  xla_windows_kernel<<<dim3(ceil_div(cmax, 64), nblocks * wmax, count), 64, 0, stream>>>(
      jj, Rj, wmax, work);
  UNAV_RETURN_IF_ERROR();
  xla_sums_kernel<<<dim3(ceil_div(cmax, 64), count), 64, 0, stream>>>(jj, nblocks, Rj, work);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- fp32 column sums of bf16 or fp32 operands -------------------------------------

// colsum.cuh's deterministic two-pass sums, for operands of either dtype:
//   out[c * ostride] (+)= sum_m A(m + shift, c) * B(m, c)
// (A read within the row's sequence of seq rows, zero outside; B optional).
struct FJob {
  const void* a; long lda; int a_bf;
  const void* b; long ldb; int b_bf;
  float* out; long ostride;
  int shift, M, C, seq, accumulate;
};
constexpr int FJ_MAX = 24;
constexpr int FS_CHUNK = 256;   // rows per partial
struct FJobs { FJob j[FJ_MAX]; };

static FJob fjob(const void* a, long lda, int a_bf, int M, int C, float* out) {
  FJob j;
  j.a = a; j.lda = lda; j.a_bf = a_bf; j.b = nullptr; j.ldb = 0; j.b_bf = 0;
  j.out = out; j.ostride = 1; j.shift = 0; j.M = M; j.C = C; j.seq = 1; j.accumulate = 0;
  return j;
}

__device__ __forceinline__ float ld_any(const void* p, long i, int is_bf) {
  return is_bf ? bf(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// grid (ceil(Cmax / 32), chunks, jobs), block (32, 8)
__global__ void __launch_bounds__(256) fsum_partial_kernel(const FJobs jobs,
                                                           float* __restrict__ partial,
                                                           int chunks, int cmax) {
  const FJob& jb = jobs.j[blockIdx.z];
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int m0 = blockIdx.y * FS_CHUNK;
  float s = 0.f;
  if (c < jb.C) {
    const int m1 = min(m0 + FS_CHUNK, jb.M);
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      const int t = m % jb.seq + jb.shift;
      if (t < 0 || t >= jb.seq) continue;
      float v = ld_any(jb.a, (long)(m + jb.shift) * jb.lda + c, jb.a_bf);
      if (jb.b) v *= ld_any(jb.b, (long)m * jb.ldb + c, jb.b_bf);
      s += v;
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < jb.C) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    partial[((long)blockIdx.z * chunks + blockIdx.y) * cmax + c] = tot;
  }
}

// grid (ceil(Cmax / 256), jobs), 256 threads
__global__ void __launch_bounds__(256) fsum_final_kernel(const FJobs jobs,
                                                         const float* __restrict__ partial,
                                                         int chunks, int cmax) {
  const FJob& jb = jobs.j[blockIdx.y];
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= jb.C) return;
  const int used = (jb.M + FS_CHUNK - 1) / FS_CHUNK;
  float tot = 0.f;
  for (int i = 0; i < used; ++i) tot += partial[((long)blockIdx.y * chunks + i) * cmax + c];
  float* o = jb.out + (long)c * jb.ostride;
  *o = jb.accumulate ? *o + tot : tot;
}

static long fsum_scratch_floats(long M, long C) {
  return (long)FJ_MAX * ceil_div(M, FS_CHUNK) * C;
}

static int launch_fsums(const FJobs& jobs, int count, float* partial, cudaStream_t stream) {
  if (count < 1 || count > FJ_MAX) return (int)cudaErrorInvalidValue;
  int mmax = 1, cmax = 1;
  for (int i = 0; i < count; ++i) {
    mmax = std::max(mmax, jobs.j[i].M);
    cmax = std::max(cmax, jobs.j[i].C);
  }
  const int chunks = ceil_div(mmax, FS_CHUNK);
  fsum_partial_kernel<<<dim3(ceil_div(cmax, 32), chunks, count), dim3(32, 8), 0, stream>>>(
      jobs, partial, chunks, cmax);
  UNAV_RETURN_IF_ERROR();
  fsum_final_kernel<<<dim3(ceil_div(cmax, 256), count), 256, 0, stream>>>(jobs, partial,
                                                                          chunks, cmax);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- elementwise glue ------------------------------------------------------------------

// y[m][c] = x[m][c] * mask[m] (bf16, exact), for the first C columns
__global__ void mask_rows_bf16_kernel(const bf16* __restrict__ x, long ldx, long P, int C,
                                      const unsigned char* __restrict__ mask,
                                      bf16* __restrict__ y, long ldy) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * C) return;
  const long m = i / C;
  const int c = (int)(i - m * C);
  y[m * ldy + c] = mask[m] ? x[m * ldx + c] : rb(0.f);
}

static int launch_mask_rows(const bf16* x, long ldx, long P, int C, const unsigned char* mask,
                            bf16* y, long ldy, cudaStream_t stream) {
  mask_rows_bf16_kernel<<<ceil_div(P * C, 256), 256, 0, stream>>>(x, ldx, P, C, mask, y, ldy);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ---- the attention, materialized ---------------------------------------------------------

// One warp per (sequence, head, query) row of the (R*H*T, T) fp32 logits S:
// masked keys at finfo.min, a row without a valid key all 0, softmax, times
// any_kv: P (fp32) and bf16(P).
__global__ void __launch_bounds__(256) softmax_rows_kernel(
    const float* __restrict__ S, const unsigned char* __restrict__ mask, int T, int H,
    long rows, float* __restrict__ Pf, bf16* __restrict__ Pc) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int r = (int)(row / ((long)H * T));
  const unsigned char* mk = mask + (long)r * T;
  const float* s = S + row * T;
  int any = 0;
  float mx = -FLT_MAX;
  for (int j = lane; j < T; j += 32) {
    any |= mk[j];
    mx = fmaxf(mx, mk[j] ? s[j] : -FLT_MAX);
  }
  any = __any_sync(0xffffffffu, any);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < T; j += 32) sum += mk[j] ? expf(s[j] - mx) : 0.f;
  sum = warp_sum(sum);
  for (int j = lane; j < T; j += 32) {
    const float pv = any && mk[j] ? expf(s[j] - mx) / sum : 0.f;
    Pf[row * T + j] = pv;
    Pc[row * T + j] = rb(pv);
  }
}

// One warp per row: dS = P (dP - sum(P dP)) from fp32 P and dP (each row's
// any_kv is in P); fp32 out, or (dSc) rounded to bf16.
__global__ void __launch_bounds__(256) softmax_bwd_rows_kernel(
    const float* __restrict__ Pf, const float* __restrict__ dP, int T, long rows,
    float* __restrict__ dS, bf16* __restrict__ dSc) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pr = Pf + row * T;
  const float* gr = dP + row * T;
  float d = 0.f;
  for (int j = lane; j < T; j += 32) d += pr[j] * gr[j];
  d = warp_sum(d);
  for (int j = lane; j < T; j += 32) {
    const float v = pr[j] * (gr[j] - d);
    if (dSc)
      dSc[row * T + j] = rb(v);
    else
      dS[row * T + j] = v;
  }
}

// ---- the MHCA's conv + LayerNorm backward ------------------------------------------------

// For q (from x2), k and v (from x1), one warp per frame: recomputes the
// bf16 depthwise conv and the fp32 LayerNorm statistics as
// dwconv_ln_bf16_kernel does, and from the LN output's grad dyl (bf16)
// writes yhat (fp32, for the affine grads) and the conv output's grad
// bf16(inv (dyh - mean(dyh) - yhat mean(dyh yhat))) * mask, dyh = dyl * lnw
// (the JAX package's LayerNorm backward, `_mhca_bwd_kernel.ln_bwd`).
template <int CPL>
__global__ void __launch_bounds__(256) mhca_ln_bwd_bf16_kernel(
    const bf16* __restrict__ x1, long ld1, const bf16* __restrict__ x2, long ld2,
    const unsigned char* __restrict__ mask, long P, int T, int C,
    const float* __restrict__ dw, const float* __restrict__ lnw, float eps,
    const bf16* __restrict__ dyl, float* __restrict__ yhat, bf16* __restrict__ dzm) {
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
    const long off = (long)which * P * C + row * C;
    float dyh[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      dyh[i] = 0.f;
      if (c < C) {
        y[i] *= inv;
        dyh[i] = bf(dyl[off + c]) * lnw[which * C + c];
        s1 += dyh[i];
        s2 += dyh[i] * y[i];
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        yhat[off + c] = y[i];
        dzm[off + c] = rb(rbf(inv * (dyh[i] - s1 - y[i] * s2)) * mval);
      }
    }
  }
}

// The depthwise convs' input grads from dzm (3 x P x C, q/k/v), each
// product dzm * bf16(tap) and each sum rounded to bf16. For path i the
// terms at frame t are c = dzm_i[t] w1, r = dzm_i[t-1] w2 (the right tap)
// and l = dzm_i[t+1] w0 (the left tap).
//   hand (MHCA_HAND, `_mhca_bwd_kernel.dwconv_bwd`): path = (l + c) + r;
//     dx2 = path q, dx1 = path k + path v;
//   vjp (MHCA_VJP, JAX's backward pass): one chain of bf16 adds, prev (the
//     caller's first cotangent of x1, if any), then c, r, l of v, of k and,
//     when x1 is x2 (one), of q; else dx2 = c + r + l of q.
__global__ void __launch_bounds__(256) mhca_dx_bf16_kernel(
    const bf16* __restrict__ dzm, long P, int T, int C, const float* __restrict__ dw,
    int vjp, int one, const bf16* prev, long ldprev, bf16* dx1, long lddx1, bf16* dx2,
    long lddx2) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * C) return;
  const long m = idx / C;
  const int c = (int)(idx - m * C), t = (int)(m % T);
  float cc[3], rr[3], ll[3];
  bool hr[3], hl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bf16* z = dzm + (long)i * P * C;
    const float* w = dw + (long)i * C * 3 + c * 3;
    cc[i] = rbf(bf(z[m * C + c]) * rbf(w[1]));
    hr[i] = t > 0;
    rr[i] = hr[i] ? rbf(bf(z[(m - 1) * C + c]) * rbf(w[2])) : 0.f;
    hl[i] = t + 1 < T;
    ll[i] = hl[i] ? rbf(bf(z[(m + 1) * C + c]) * rbf(w[0])) : 0.f;
  }
  if (!vjp) {
    float path[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = hl[i] ? rbf(ll[i] + cc[i]) : cc[i];
      path[i] = hr[i] ? rbf(s + rr[i]) : s;
    }
    const float kv = rbf(path[1] + path[2]);
    if (one) {
      dx1[m * lddx1 + c] = rb(rbf(path[0] + kv));
    } else {
      dx1[m * lddx1 + c] = rb(kv);
      dx2[m * lddx2 + c] = rb(path[0]);
    }
    return;
  }
  bool have = prev != nullptr;
  float s = have ? bf(prev[m * ldprev + c]) : 0.f;
  auto add = [&](float v, bool ok) {
    if (!ok) return;
    s = have ? rbf(s + v) : v;
    have = true;
  };
  for (int i = 2; i >= (one ? 0 : 1); --i) {
    add(cc[i], true);
    add(rr[i], hr[i]);
    add(ll[i], hl[i]);
  }
  dx1[m * lddx1 + c] = rb(s);
  if (!one) {
    float q = cc[0];
    if (hr[0]) q = rbf(q + rr[0]);
    if (hl[0]) q = rbf(q + ll[0]);
    dx2[m * lddx2 + c] = rb(q);
  }
}

// ---- the MHCA backward ---------------------------------------------------------------------

constexpr int MHCA_HAND = 0, MHCA_VJP = 1;

// One MHCA backward's device buffers (mhca_bwd_bf16_buffers carves them).
struct MhcaBwdBufs {
  bf16 *y3, *qkv, *Pc, *o, *gp, *go, *dSc, *dqkv, *dyl, *dzm;
  float *S, *Pf, *dP, *yhat, *partial, *xwork, *split;
  long xwork_floats, split_cap;
};

static MhcaBwdBufs mhca_bwd_bf16_buffers(Bump& s, int R, int T, int C, int H) {
  const long P = (long)R * T, PC = P * C, HTT = (long)R * H * T * T;
  MhcaBwdBufs b;
  b.y3 = s.take<bf16>(3 * PC);
  b.qkv = s.take<bf16>(3 * PC);
  b.S = s.take<float>(HTT);
  b.Pf = s.take<float>(HTT);
  b.Pc = s.take<bf16>(HTT);
  b.o = s.take<bf16>(PC);
  b.gp = s.take<bf16>(PC);
  b.go = s.take<bf16>(PC);
  b.dP = s.take<float>(HTT);
  b.dSc = s.take<bf16>(HTT);
  b.dqkv = s.take<bf16>(3 * PC);
  b.dyl = s.take<bf16>(3 * PC);
  b.yhat = s.take<float>(3 * PC);
  b.dzm = s.take<bf16>(3 * PC);
  b.partial = s.take<float>(fsum_scratch_floats(P, C));
  b.xwork_floats = xla_sums_work_floats(R, T + 8, C, 13);
  b.xwork = s.take<float>(b.xwork_floats);
  b.split_cap = (long)(R + 17) * C * C;   // a weight grad's chunks (launch_xgemm)
  b.split = s.take<float>(b.split_cap);
  return b;
}

// Weight grads of one MHCA (fp32, the port's layouts): gdw (3, C, 3), glnw /
// glnb (3, C), gw (4, C, C) [out, in], gb (4, C).
struct MhcaGrads {
  float *gdw, *glnw, *glnb, *gw, *gb;
};

// The backward of one MaskedMHCA in bf16, in `form` MHCA_HAND or MHCA_VJP
// (file comment). x1 (k/v source), x2 (q source) (R*T, C) bf16 with row
// strides (vjp form, x1 == x2 and ld1 == ld2: one input); g the output's grad (row
// stride ldg); fp32 dw / lnw / lnb, bf16 wb (4, C, C) and bb (4, C) (cast
// once by the caller). Writes dx1 (and dx2 unless one input; vjp form: after
// prev, the caller's first cotangent of x1, which may alias dx1) and the
// weight grads. VJP form: weight grads per block of Rj sequences (JAX's
// grid), bf16 sums in XLA's order over blocks of tpad rows.
static int mhca_bf16_backward(int form, const bf16* x1, long ld1, const bf16* x2, long ld2,
                              const unsigned char* mask, int R, int T, int C, int H,
                              const float* dw, const float* lnw, const float* lnb,
                              const bf16* wb, const bf16* bb, float eps, const bf16* g,
                              long ldg, const bf16* prev, long ldprev, bf16* dx1, long lddx1,
                              bf16* dx2, long lddx2, const MhcaGrads& gr, int Rj, int tpad,
                              const MhcaBwdBufs& bu, cudaStream_t s) {
  const long P = (long)R * T, PC = P * C, CC = (long)C * C, TT = (long)T * T;
  const int d = C / H, Z = R * H, vjp = form == MHCA_VJP;
  const bool one = vjp && x1 == x2 && ld1 == ld2;
  if (C % 8 || d % 8 || R % Rj) return (int)cudaErrorInvalidValue;
  const float scale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)d))));
  int rc;

  // the forward, recomputed: conv + LN, q/k/v (as mhca_bf16_forward_impl)
  rc = with_cpl(C, [&](auto cpl) {
    dwconv_ln_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, lnb, eps, bu.y3);
  });
  if (rc) return rc;
  Bf16Batch qb;
  for (int i = 0; i < 3; ++i)
    qb.g[i] = bf16_gemm(bu.y3 + i * PC, C, wb + i * CC, C, bu.qkv + i * PC, C, bb + (long)i * C,
                        i == 2 ? mask : nullptr, (int)P, C, C);
  qb.g[0].scale = scale;
  if ((rc = launch_gemm_bf16(qb, 3, s))) return rc;
  const bf16 *q = bu.qkv, *k = bu.qkv + PC, *v = bu.qkv + 2 * PC;

  // attention per (sequence, head): S = q k^T, P = softmax, o = bf16(P) v
  XGemm sg = xgemm(T, T, d);
  xg_a(sg, q, C);
  xg_bt(sg, k, C);
  xg_c(sg, bu.S, T, 1);
  xg_batch(sg, Z, H, (long)T * C, d, (long)T * C, d, H * TT, TT);
  if ((rc = launch_xgemm(sg, s))) return rc;
  softmax_rows_kernel<<<ceil_div((long)Z * T, 8), 256, 0, s>>>(bu.S, mask, T, H, (long)Z * T,
                                                                bu.Pf, bu.Pc);
  UNAV_RETURN_IF_ERROR();
  XGemm og = xgemm(T, d, T);
  xg_a(og, bu.Pc, T);
  xg_b(og, v, C);
  xg_c(og, bu.o, C, 0);
  xg_batch(og, Z, H, H * TT, TT, (long)T * C, d, (long)T * C, d);
  if ((rc = launch_xgemm(og, s))) return rc;

  // proj: gp = g . m, go = bf16(gp Wp)
  if ((rc = launch_mask_rows(g, ldg, P, C, mask, bu.gp, C, s))) return rc;
  XGemm pg = xgemm((int)P, C, C);
  xg_a(pg, bu.gp, C);
  xg_b(pg, wb + 3 * CC, C);
  xg_c(pg, bu.go, C, 0);
  if ((rc = launch_xgemm(pg, s))) return rc;

  // attention backward: dP = go v^T (vjp: rounded to bf16), dS, then dq =
  // bf16(dS k) * scale, dk = bf16(dS^T q), dv = bf16(bf16(P)^T go) * mask
  XGemm dg = xgemm(T, T, d);
  xg_a(dg, bu.go, C);
  xg_bt(dg, v, C);
  xg_c(dg, bu.dP, T, 1);
  dg.round_f32 = vjp;
  xg_batch(dg, Z, H, (long)T * C, d, (long)T * C, d, H * TT, TT);
  if ((rc = launch_xgemm(dg, s))) return rc;
  softmax_bwd_rows_kernel<<<ceil_div((long)Z * T, 8), 256, 0, s>>>(
      bu.Pf, bu.dP, T, (long)Z * T, bu.S, vjp ? nullptr : bu.dSc);
  UNAV_RETURN_IF_ERROR();
  const void* dS = vjp ? (const void*)bu.S : (const void*)bu.dSc;
  XGemm qg = xgemm(T, d, T);
  xg_a(qg, dS, T, vjp);
  xg_b(qg, k, C);
  xg_c(qg, bu.dqkv, C, 0);
  qg.scale = scale;
  xg_batch(qg, Z, H, H * TT, TT, (long)T * C, d, (long)T * C, d);
  if ((rc = launch_xgemm(qg, s))) return rc;
  XGemm kg = xgemm(T, d, T);
  xg_at(kg, dS, T, vjp);
  xg_b(kg, q, C);
  xg_c(kg, bu.dqkv + PC, C, 0);
  xg_batch(kg, Z, H, H * TT, TT, (long)T * C, d, (long)T * C, d);
  if ((rc = launch_xgemm(kg, s))) return rc;
  XGemm vg = xgemm(T, d, T);
  xg_at(vg, bu.Pc, T);
  xg_b(vg, bu.go, C);
  xg_c(vg, bu.dqkv + 2 * PC, C, 0);
  vg.rowmask = mask;
  vg.rm_z1 = T;
  xg_batch(vg, Z, H, H * TT, TT, (long)T * C, d, (long)T * C, d);
  if ((rc = launch_xgemm(vg, s))) return rc;

  // dense layers: the LN outputs' grads dyl_i = bf16(dy_i W_i), the weight
  // grads dy_i^T y_i (proj: gp^T o), per block rounded (vjp) or fp32 (hand)
  for (int i = 0; i < 3; ++i) {
    XGemm xg = xgemm((int)P, C, C);
    xg_a(xg, bu.dqkv + i * PC, C);
    xg_b(xg, wb + i * CC, C);
    xg_c(xg, bu.dyl + i * PC, C, 0);
    if ((rc = launch_xgemm(xg, s))) return rc;
  }
  for (int i = 0; i < 4; ++i) {
    XGemm wg = xgemm(C, C, (int)P);
    xg_at(wg, i < 3 ? bu.dqkv + i * PC : bu.gp, C);
    xg_b(wg, i < 3 ? bu.y3 + i * PC : bu.o, C);
    xg_c(wg, gr.gw + i * CC, C, 1);
    wg.split = bu.split;
    wg.split_cap = bu.split_cap;
    if (vjp) {
      wg.kblock = Rj * T;
      wg.round_blocks = 1;
    }
    if ((rc = launch_xgemm(wg, s))) return rc;
  }

  // LayerNorm backward, the conv's input grads
  rc = with_cpl(C, [&](auto cpl) {
    mhca_ln_bwd_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, eps, bu.dyl, bu.yhat, bu.dzm);
  });
  if (rc) return rc;
  mhca_dx_bf16_kernel<<<ceil_div(PC, 256), 256, 0, s>>>(bu.dzm, P, T, C, dw, vjp, one, prev,
                                                        ldprev, dx1, lddx1, dx2, lddx2);
  UNAV_RETURN_IF_ERROR();

  // the sums: LN affine (fp32 in both forms); biases and taps fp32 (hand) or
  // bf16 in XLA's order per block (vjp)
  FJobs fj;
  int nf = 0;
  for (int i = 0; i < 3; ++i) {
    fj.j[nf] = fjob(bu.dyl + i * PC, C, 1, (int)P, C, gr.glnw + (long)i * C);
    fj.j[nf].b = bu.yhat + i * PC;
    fj.j[nf++].ldb = C;
    fj.j[nf++] = fjob(bu.dyl + i * PC, C, 1, (int)P, C, gr.glnb + (long)i * C);
  }
  if (!vjp) {
    for (int i = 0; i < 4; ++i)
      fj.j[nf++] = fjob(i < 3 ? bu.dqkv + i * PC : bu.gp, C, 1, (int)P, C, gr.gb + (long)i * C);
    for (int i = 0; i < 3; ++i)
      for (int tap = 0; tap < 3; ++tap) {
        FJob& j = fj.j[nf++];
        j = fjob(i == 0 ? x2 : x1, i == 0 ? ld2 : ld1, 1, (int)P, C,
                 gr.gdw + (long)i * C * 3 + tap);
        j.ostride = 3; j.shift = tap - 1; j.seq = T;
        j.b = bu.dzm + i * PC; j.ldb = C; j.b_bf = 1;
      }
  }
  if ((rc = launch_fsums(fj, nf, bu.partial, s))) return rc;
  if (vjp) {
    XJobs xj;
    int nx = 0;
    for (int i = 0; i < 4; ++i)
      xj.j[nx++] = xjob(i < 3 ? bu.dqkv + i * PC : bu.gp, C, gr.gb + (long)i * C, C, T, tpad);
    for (int i = 0; i < 3; ++i)
      for (int tap = 0; tap < 3; ++tap) {
        XJob& j = xj.j[nx++];
        j = xjob(i == 0 ? x2 : x1, i == 0 ? ld2 : ld1, gr.gdw + (long)i * C * 3 + tap, C, T,
                 tpad);
        j.ostride = 3; j.shift = tap - 1; j.twod = 1;
        j.b = bu.dzm + i * PC; j.ldb = C;
      }
    if ((rc = launch_xla_sums(xj, nx, R / Rj, Rj, bu.xwork, bu.xwork_floats, s))) return rc;
  }
  return 0;
}
