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
// m16n8k16, fp32 sums); an fp32 operand (the attention's ds, the gate's
// sparse grads) is split into three bf16 terms whose products are exact in
// the fp32 sums. The design, for this card:
//   - one strided product, xgemm_kernel, for the A.B^T, A.B and A^T.B
//     layouts: 16-byte cp.async copies into a four-stage ring, each operand
//     kept in shared memory as it lies in device memory and read with
//     ldmatrix (.trans where its contiguous dimension is M or N); 128 x 128
//     tiles on 8 warps where the products fill the card, 128 x 64 on 8
//     otherwise, 64 x 64 on 4 for an fp32 A; up to four products a launch;
//     a weight grad's row blocks on blocks of their own, added in order by a
//     second pass (bf16_xgemm.cuh);
//   - a fused attention backward in two launches, attn_bwd_q_bf16_kernel
//     (a 32-query tile keeps its whole fp32 S and datt rows in shared memory:
//     the softmax statistics summed as the forward sums them, D = sum(P datt)
//     over every key, dS, dq) and attn_bwd_kv_bf16_kernel (a 32-key tile
//     recomputes S, P and datt from those statistics: dk, dv), with no (T, T)
//     array in device memory;
//   - the masks, the projection conv's shifted rows and the weights'
//     transposes read by the loaders instead of copied; the CSP layer's
//     three MHCAs reuse its recompute and add their sums to its own launch.
// Every sum has one fixed order (32-deep slices from zero, added in order;
// the JAX row blocks; a softmax row lane by lane, then across the warp):
// two builds that keep it give the same bits. The reductions, LayerNorms and
// elementwise glue run on the FP32 pipes; `wgmma` and TMA are later work.
#pragma once

#include "bf16_xgemm.cuh"

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
// mask, if given, zeroes a's rows (a masked upstream grad) before b.
struct XJob {
  const bf16* a;
  const bf16* b;
  const unsigned char* mask;
  float* out;
  long woff;                   // launch_xla_sums: where its window sums go in the work
  int lda, ldb, ostride, shift, C, T, tpad, twod, accumulate;
};
// a CSP backward's own 4 jobs and its three MHCAs' 13 each, in one launch
// (the jobs' table stays under 4 KB of kernel parameters)
constexpr int XJ_MAX = 48;
struct XJobs { XJob j[XJ_MAX]; };

static XJob xjob(const bf16* a, long lda, float* out, int C, int T, int tpad,
                 const unsigned char* mask = nullptr) {
  XJob j;
  j.a = a; j.b = nullptr; j.mask = mask; j.out = out; j.woff = 0;
  j.lda = (int)lda; j.ldb = 0; j.ostride = 1; j.shift = 0;
  j.C = C; j.T = T; j.tpad = tpad; j.twod = 0; j.accumulate = 0;
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
    if (jb.mask && !jb.mask[row]) return 0.f;
    float v = bf(jb.a[(row + jb.shift) * jb.lda + c]);
    if (jb.b) v = rbf(v * bf(jb.b[row * jb.ldb + c]));
    return v;
  }
};

// The first level of every job's tree in parallel, one window of one block
// and one column a thread: grid (ceil(Cmax / 64), nblocks * wmax, jobs), the
// window's bf16 sum, in XLA's order, into win[job][block][window][c].
__global__ void __launch_bounds__(64) xla_windows_kernel(const __grid_constant__ XJobs jobs,
                                                         int Rj, int wmax,
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
__global__ void __launch_bounds__(64) xla_sums_kernel(const __grid_constant__ XJobs jobs,
                                                      int nblocks, int Rj,
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
// (A read within the row's sequence of seq rows, zero outside, and in the
// rows mask keeps, if given; B optional).
struct FJob {
  const void* a;
  const void* b;
  const unsigned char* mask;
  float* out;
  int lda, ldb, ostride, a_bf, b_bf, shift, M, C, seq, accumulate;
};
constexpr int FJ_MAX = 24;
constexpr int FS_CHUNK = 256;   // rows per partial
struct FJobs { FJob j[FJ_MAX]; };

static FJob fjob(const void* a, long lda, int a_bf, int M, int C, float* out,
                 const unsigned char* mask = nullptr) {
  FJob j;
  j.a = a; j.b = nullptr; j.mask = mask; j.out = out;
  j.lda = (int)lda; j.ldb = 0; j.ostride = 1; j.a_bf = a_bf; j.b_bf = 0;
  j.shift = 0; j.M = M; j.C = C; j.seq = 1; j.accumulate = 0;
  return j;
}

__device__ __forceinline__ float ld_any(const void* p, long i, int is_bf) {
  return is_bf ? bf(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// grid (ceil(Cmax / 32), chunks, jobs), block (32, 8)
__global__ void __launch_bounds__(256) fsum_partial_kernel(const __grid_constant__ FJobs jobs,
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
      if (t < 0 || t >= jb.seq || (jb.mask && !jb.mask[m])) continue;
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
__global__ void __launch_bounds__(256) fsum_final_kernel(const __grid_constant__ FJobs jobs,
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

// ---- the attention backward, fused -----------------------------------------------------

constexpr int AT_T = 32;   // queries, or keys, a tile of the attention backward

// grid (ceil(T / 32), H, R), 256 threads: one 32-query tile of one head.
// DP: the head width d rounded up to 16, 32, 64 or 128 (dims past d zero).
// q (scaled), k, v, go (R*T, C) bf16 with the head's d columns at h * d.
// Pass 1 streams key tiles through a two-slot cp.async ring and keeps the
// tile's whole fp32 rows of S = q k^T and datt = go v^T (rounded to bf16 in
// the vjp form) in shared memory, each summed as the strided product sums
// (32-deep slices of d from zero, the query as A). Then
// a warp takes 4 rows: P = exp(s - max) / sum over the valid keys with the
// max, the sum and D = sum(P datt) each taken by every lane over keys lane,
// lane + 32, ... in order and then across the warp (the forward attention's
// order: P and bf16(P) are the forward's), dS =
// P (datt - D) written over the row as bf16 terms: rounded (hand form) or
// split into three (vjp form: the fp32 dS multiplies k unrounded). Pass 2
// streams the key tiles again: dq = bf16(bf16(dS k) * scale), 32 keys a
// slice. Each row's (max, sum, D) goes to stat for the key-tile kernel. A
// sequence without a valid key writes exact zeros. Shared memory: the query
// and go tiles and the ring (6 x 32 x DP+8 bf16), the rows (32 x 2 T32 + 4
// fp32, T32 = T rounded up to 32).
template <int DP>
__global__ void __launch_bounds__(256) attn_bwd_q_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ go, const unsigned char* __restrict__ mask, int T, int C, int H,
    int vjp, float scale, bf16* __restrict__ dq, float* __restrict__ stat) {
  constexpr int RS = DP + 8, CH = DP / 8, TILE = AT_T * RS, NJ = (DP / 8 + 3) / 4;
  extern __shared__ __align__(16) unsigned char aq_smem[];
  const int d = C / H, T32 = (T + AT_T - 1) / AT_T * AT_T, RW = 2 * T32 + 4, nkt = T32 / AT_T;
  bf16* Qs = reinterpret_cast<bf16*>(aq_smem);
  bf16* Gs = Qs + TILE;
  bf16* ring = Gs + TILE;                                    // 2 slots of (key, value) tiles
  float* rows = reinterpret_cast<float*>(ring + 4 * TILE);   // AT_T x RW
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * AT_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int e = tid; e < AT_T * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      if (q0 + i < T) dq[base + (long)(q0 + i) * C + dd] = rb(0.f);
    }
    return;
  }
  auto load_rows = [&](bf16* dst, const bf16* src, int row0) {
    for (int e = tid; e < AT_T * CH; e += 256) {
      const int row = e / CH, c = (e - row * CH) * 8;
      const bool ok = row0 + row < T && c < d;
      cp_async16b(dst + row * RS + c, ok ? src + base + (long)(row0 + row) * C + c : src, ok);
    }
  };
  load_rows(Qs, q, q0);
  load_rows(Gs, go, q0);
  load_rows(ring, k, 0);
  load_rows(ring + TILE, v, 0);
  cp_async_commit();

  // pass 1: warp (rg, kq) owns rows 16 rg .. and keys 8 kq .. of each tile
  const int rg = warp & 1, kq = warp >> 1;
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  for (int i = 0; i < nkt; ++i) {
    if (i + 1 < nkt) {
      bf16* slot = ring + ((i + 1) & 1) * 2 * TILE;
      load_rows(slot, k, (i + 1) * AT_T);
      load_rows(slot + TILE, v, (i + 1) * AT_T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile i (and the query tiles) landed
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        const bf16* p = Qs + (rg * 16 + g) * RS + kk + 2 * t4;
        const bf16* pg = Gs + (rg * 16 + g) * RS + kk + 2 * t4;
        qf[kk / 16][0] = ld32(p);
        qf[kk / 16][1] = ld32(p + 8 * RS);
        qf[kk / 16][2] = ld32(p + 8);
        qf[kk / 16][3] = ld32(p + 8 * RS + 8);
        gf[kk / 16][0] = ld32(pg);
        gf[kk / 16][1] = ld32(pg + 8 * RS);
        gf[kk / 16][2] = ld32(pg + 8);
        gf[kk / 16][3] = ld32(pg + 8 * RS + 8);
      }
    }
    const bf16* ks = ring + (i & 1) * 2 * TILE;
    const bf16* vs = ks + TILE;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c0 = 0; c0 < DP; c0 += 32) {
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = c0; kk < c0 + 32 && kk < DP; kk += 16) {
        const bf16* pk = ks + (kq * 8 + g) * RS + kk + 2 * t4;
        const bf16* pv = vs + (kq * 8 + g) * RS + kk + 2 * t4;
        const uint32_t bk[2] = {ld32(pk), ld32(pk + 8)}, bv[2] = {ld32(pv), ld32(pv + 8)};
        mma_bf16(ps, qf[kk / 16], bk);
        mma_bf16(pd, gf[kk / 16], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += ps[e];
        dp[e] += pd[e];
      }
    }
    const int key = i * AT_T + kq * 8 + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* sr = rows + (rg * 16 + g + 8 * hh) * RW;
      *reinterpret_cast<float2*>(sr + key) = make_float2(s[2 * hh], s[2 * hh + 1]);
      *reinterpret_cast<float2*>(sr + T32 + key) =
          vjp ? make_float2(rbf(dp[2 * hh]), rbf(dp[2 * hh + 1]))
              : make_float2(dp[2 * hh], dp[2 * hh + 1]);
    }
    __syncthreads();   // every warp is done with tile i: its slot may be refilled
  }
  load_rows(ring, k, 0);   // pass 2's first key tile, under the row statistics
  cp_async_commit();

  // each warp's 4 rows: statistics, P, D, dS over the row (T32 <= 512: 16 a lane)
  for (int i4 = 0; i4 < AT_T / 8; ++i4) {
    const int row = warp * (AT_T / 8) + i4;
    float* sr = rows + row * RW;
    bf16* terms = reinterpret_cast<bf16*>(sr);   // dS's bf16 terms, over the row
    float sv[16], gv[16], pf[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      sv[jj] = j < T ? sr[j] : 0.f;
      gv[jj] = j < T ? sr[T32 + j] : 0.f;
    }
    float mx = -FLT_MAX;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      if (j < T) mx = fmaxf(mx, mrow[j] ? sv[jj] : -FLT_MAX);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      if (j < T) sum += mrow[j] ? expf(sv[jj] - mx) : 0.f;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      pf[jj] = j < T && mrow[j] ? expf(sv[jj] - mx) / sum : 0.f;
    }
    float dsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      if (j < T) dsum += pf[jj] * gv[jj];
    }
    dsum = warp_sum(dsum);
    __syncwarp();   // the row is read: its bf16 terms go over it
    const bool live = q0 + row < T;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = lane + 32 * jj;
      if (j >= T32) continue;
      const float x = live && j < T ? pf[jj] * (gv[jj] - dsum) : 0.f;
      if (vjp) {
        const bf16 hi = rb(x);
        const float r1 = x - bf(hi);
        const bf16 mi = rb(r1);
        terms[j] = hi;
        terms[T32 + j] = mi;
        terms[2 * T32 + j] = rb(r1 - bf(mi));
      } else {
        terms[j] = rb(x);
      }
    }
    if (lane == 0 && live) {
      float* st = stat + (sbase + q0 + row) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = dsum;
    }
  }

  // pass 2: dq = dS k, warp (rg, kq) owns rows 16 rg .. and n8 tiles kq + 4 jj
  float acc[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
  const bf16* arow = reinterpret_cast<const bf16*>(rows + (rg * 16 + (lane & 15)) * RW) +
                     (lane >> 4) * 8;
  for (int i = 0; i < nkt; ++i) {
    if (i + 1 < nkt) load_rows(ring + ((i + 1) & 1) * 2 * TILE, k, (i + 1) * AT_T);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // key tile i landed; every row's terms are written
    const bf16* ks = ring + (i & 1) * 2 * TILE;
    float part[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < AT_T; kk += 16) {
      uint32_t b[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = kq + 4 * jj;
        if (j < DP / 8) ldsm2t(b[jj], ks + (kk + (lane & 15)) * RS + j * 8);
      }
      for (int pl = vjp ? 2 : 0; pl >= 0; --pl) {   // smallest term first
        uint32_t a[4];
        ldsm4(a, arow + pl * T32 + i * AT_T + kk);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (kq + 4 * jj < DP / 8) mma_bf16(part[jj], a, b[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] += part[jj][e];
    __syncthreads();   // every warp is done with this slot
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + rg * 16 + g + 8 * hh;
    if (qrow >= T) continue;
    bf16* out = dq + base + (long)qrow * C;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = (kq + 4 * jj) * 8 + 2 * t4;   // d is a multiple of 8
      if (dd >= d) continue;
      float y0 = rbf(acc[jj][2 * hh]), y1 = rbf(acc[jj][2 * hh + 1]);
      if (scale != 1.f) {
        y0 = rbf(y0 * scale);
        y1 = rbf(y1 * scale);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + dd) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// grid (ceil(T / 32), H, R), 256 threads: one 32-key tile of one head.
// Query and go tiles stream through a two-slot cp.async ring; per query tile
// warp (rg, kq) recomputes S and datt of query rows 16 rg .. and keys 8 kq
// .. as the query-tile kernel does (the same bits), P and dS from that
// kernel's (max, sum, D), and keeps bf16(P) and dS's terms [query][key] in
// shared memory; then warp (rk, jq) adds dv += bf16(P)^T go and dk +=
// dS^T q for keys 16 rk .. and n8 tiles jq + 4 jj, the 32 queries one
// slice. dk = bf16(sum), dv = bf16(sum) * mask.
template <int DP>
__global__ void __launch_bounds__(256) attn_bwd_kv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ go, const unsigned char* __restrict__ mask,
    const float* __restrict__ stat, int T, int C, int H, int vjp, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  constexpr int RS = DP + 8, CH = DP / 8, TILE = AT_T * RS, NJ = (DP / 8 + 3) / 4;
  constexpr int PS = AT_T + 8;   // a [query][key] row: 80 bytes
  extern __shared__ __align__(16) unsigned char akv_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(akv_smem);
  bf16* Vs = Ks + TILE;
  bf16* ring = Vs + TILE;            // 2 slots of (query, go) tiles
  bf16* Pt = ring + 4 * TILE;        // bf16(P), AT_T x PS
  bf16* St = Pt + AT_T * PS;         // dS's terms, 3 x AT_T x PS
  const int d = C / H, r = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * AT_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int i8 = lane >> 3, r8 = lane & 7;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int e = tid; e < AT_T * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      if (k0 + i < T) {
        dk[base + (long)(k0 + i) * C + dd] = rb(0.f);
        dv[base + (long)(k0 + i) * C + dd] = rb(0.f);
      }
    }
    return;
  }
  auto load_rows = [&](bf16* dst, const bf16* src, int row0) {
    for (int e = tid; e < AT_T * CH; e += 256) {
      const int row = e / CH, c = (e - row * CH) * 8;
      const bool ok = row0 + row < T && c < d;
      cp_async16b(dst + row * RS + c, ok ? src + base + (long)(row0 + row) * C + c : src, ok);
    }
  };
  load_rows(Ks, k, k0);
  load_rows(Vs, v, k0);
  load_rows(ring, q, 0);
  load_rows(ring + TILE, go, 0);
  cp_async_commit();

  const int rg = warp & 1, kq = warp >> 1;   // S and datt
  const int rk = warp & 1, jq = warp >> 1;   // dk and dv
  const int nqt = (T + AT_T - 1) / AT_T;
  uint32_t kf[DP / 16][2], vf[DP / 16][2];
  float adk[NJ][4], adv[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[jj][e] = adv[jj][e] = 0.f;
  for (int i = 0; i < nqt; ++i) {
    const int q0 = i * AT_T;
    if (i + 1 < nqt) {
      bf16* slot = ring + ((i + 1) & 1) * 2 * TILE;
      load_rows(slot, q, q0 + AT_T);
      load_rows(slot + TILE, go, q0 + AT_T);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // query tile i (and the key tiles) landed
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        const bf16* pk = Ks + (kq * 8 + g) * RS + kk + 2 * t4;
        const bf16* pv = Vs + (kq * 8 + g) * RS + kk + 2 * t4;
        kf[kk / 16][0] = ld32(pk);
        kf[kk / 16][1] = ld32(pk + 8);
        vf[kk / 16][0] = ld32(pv);
        vf[kk / 16][1] = ld32(pv + 8);
      }
    }
    const bf16* qs = ring + (i & 1) * 2 * TILE;
    const bf16* gs = qs + TILE;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c0 = 0; c0 < DP; c0 += 32) {
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = c0; kk < c0 + 32 && kk < DP; kk += 16) {
        const bf16* pa = qs + (rg * 16 + g) * RS + kk + 2 * t4;
        const bf16* pg = gs + (rg * 16 + g) * RS + kk + 2 * t4;
        const uint32_t aq[4] = {ld32(pa), ld32(pa + 8 * RS), ld32(pa + 8), ld32(pa + 8 * RS + 8)};
        const uint32_t ag[4] = {ld32(pg), ld32(pg + 8 * RS), ld32(pg + 8), ld32(pg + 8 * RS + 8)};
        mma_bf16(ps, aq, kf[kk / 16]);
        mma_bf16(pd, ag, vf[kk / 16]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += ps[e];
        dp[e] += pd[e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rg * 16 + g + 8 * hh, qrow = q0 + row, kl = kq * 8 + 2 * t4;
      float mx = 0.f, sum = 1.f, D = 0.f;
      if (qrow < T) {
        const float* st = stat + (sbase + qrow) * 3;
        mx = st[0];
        sum = st[1];
        D = st[2];
      }
      float pf[2], x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + kl + e;
        const bool live = qrow < T && key < T;
        pf[e] = live && mrow[key] ? expf(s[2 * hh + e] - mx) / sum : 0.f;
        const float dpv = vjp ? rbf(dp[2 * hh + e]) : dp[2 * hh + e];
        x[e] = live ? pf[e] * (dpv - D) : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(Pt + row * PS + kl) = __floats2bfloat162_rn(pf[0], pf[1]);
      if (vjp) {
        bf16 t[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          t[0][e] = rb(x[e]);
          const float r1 = x[e] - bf(t[0][e]);
          t[1][e] = rb(r1);
          t[2][e] = rb(r1 - bf(t[1][e]));
        }
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) {
          __nv_bfloat162 w;
          w.x = t[pl][0];
          w.y = t[pl][1];
          *reinterpret_cast<__nv_bfloat162*>(St + (pl * AT_T + row) * PS + kl) = w;
        }
      } else {
        *reinterpret_cast<__nv_bfloat162*>(St + row * PS + kl) =
            __floats2bfloat162_rn(x[0], x[1]);
      }
    }
    __syncthreads();   // bf16(P) and dS of the tile are in
    float pv[NJ][4], pk[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[jj][e] = pk[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < AT_T; kk += 16) {
      uint32_t bg[NJ][2], bq[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = jq + 4 * jj;
        if (j < DP / 8) {
          ldsm2t(bg[jj], gs + (kk + (lane & 15)) * RS + j * 8);
          ldsm2t(bq[jj], qs + (kk + (lane & 15)) * RS + j * 8);
        }
      }
      const int ao = (kk + r8 + (i8 >> 1) * 8) * PS + rk * 16 + (i8 & 1) * 8;
      uint32_t a[4];
      ldsm4t(a, Pt + ao);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        if (jq + 4 * jj < DP / 8) mma_bf16(pv[jj], a, bg[jj]);
      for (int pl = vjp ? 2 : 0; pl >= 0; --pl) {   // smallest term first
        ldsm4t(a, St + pl * AT_T * PS + ao);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (jq + 4 * jj < DP / 8) mma_bf16(pk[jj], a, bq[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adv[jj][e] += pv[jj][e];
        adk[jj][e] += pk[jj][e];
      }
    __syncthreads();   // the slot, bf16(P) and dS may be refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + rk * 16 + g + 8 * hh;
    if (key >= T) continue;
    const float mk = mrow[key] ? 1.f : 0.f;
    const long row = base + (long)key * C;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = (jq + 4 * jj) * 8 + 2 * t4;
      if (dd >= d) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + dd) =
          __floats2bfloat162_rn(rbf(adk[jj][2 * hh]), rbf(adk[jj][2 * hh + 1]));
      *reinterpret_cast<__nv_bfloat162*>(dv + row + dd) = __floats2bfloat162_rn(
          rbf(adv[jj][2 * hh]) * mk, rbf(adv[jj][2 * hh + 1]) * mk);
    }
  }
}

template <int DP>
static int launch_attn_bwd_bf16_dp(const bf16* q, const bf16* k, const bf16* v, const bf16* go,
                                   const unsigned char* mask, int R, int T, int C, int H,
                                   int vjp, float scale, bf16* dq, bf16* dk, bf16* dv,
                                   float* stat, cudaStream_t stream) {
  constexpr int TILE = AT_T * (DP + 8);
  const int T32 = ceil_div(T, AT_T) * AT_T;
  const size_t qsmem = sizeof(bf16) * 6 * TILE + sizeof(float) * (size_t)AT_T * (2 * T32 + 4);
  const size_t kvsmem = sizeof(bf16) * (6 * TILE + 4 * AT_T * (AT_T + 8));
  static int qlimit = 0, kvlimit = 0;
  raise_smem_limit((const void*)attn_bwd_q_bf16_kernel<DP>, (int)qsmem, qlimit);
  raise_smem_limit((const void*)attn_bwd_kv_bf16_kernel<DP>, (int)kvsmem, kvlimit);
  const dim3 grid(ceil_div(T, AT_T), H, R);
  attn_bwd_q_bf16_kernel<DP><<<grid, 256, qsmem, stream>>>(q, k, v, go, mask, T, C, H, vjp,
                                                           scale, dq, stat);
  UNAV_RETURN_IF_ERROR();
  attn_bwd_kv_bf16_kernel<DP><<<grid, 256, kvsmem, stream>>>(q, k, v, go, mask, stat, T, C, H,
                                                             vjp, dk, dv);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// The attention backward of R sequences of H heads: q (scaled), k, v, go
// and dq, dk, dv (R*T, C) bf16, stat R*H*T*3 floats; T <= 512, the head width
// a multiple of 8 up to 128. Two launches.
static int launch_attn_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* go,
                                const unsigned char* mask, int R, int T, int C, int H, int vjp,
                                float scale, bf16* dq, bf16* dk, bf16* dv, float* stat,
                                cudaStream_t stream) {
  const int d = C / H;
  if (d % 8 || C % 8) return (int)cudaErrorMisalignedAddress;
  if (T > 16 * 32) return (int)cudaErrorInvalidValue;
#define UNAV_ATT_BWD(DP) \
  launch_attn_bwd_bf16_dp<DP>(q, k, v, go, mask, R, T, C, H, vjp, scale, dq, dk, dv, stat, stream)
  if (d <= 16) return UNAV_ATT_BWD(16);
  if (d <= 32) return UNAV_ATT_BWD(32);
  if (d <= 64) return UNAV_ATT_BWD(64);
  if (d <= 128) return UNAV_ATT_BWD(128);
#undef UNAV_ATT_BWD
  return (int)cudaErrorInvalidValue;
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

// One MHCA backward's device buffers (mhca_bwd_bf16_buffers carves them):
// the forward's recompute (y3 the normalized q/k/v inputs and qkv the
// projections, one 6 x P x C piece as mhca_bf16_forward_impl's scratch, o
// the attention's output), go, the grads, the attention's row statistics,
// and (sums) the scratch of the sums.
struct MhcaBwdBufs {
  bf16 *y3, *qkv, *o, *go, *dqkv, *dyl, *dzm;
  float *stat, *yhat, *partial, *xwork;
  long xwork_floats;
};

static MhcaBwdBufs mhca_bwd_bf16_buffers(Bump& s, int R, int T, int C, int H, bool sums = true) {
  const long P = (long)R * T, PC = P * C;
  MhcaBwdBufs b;
  b.y3 = s.take<bf16>(6 * PC);
  b.qkv = b.y3 ? b.y3 + 3 * PC : nullptr;
  b.o = s.take<bf16>(PC);
  b.go = s.take<bf16>(PC);
  b.dqkv = s.take<bf16>(3 * PC);
  b.dyl = s.take<bf16>(3 * PC);
  b.dzm = s.take<bf16>(3 * PC);
  b.stat = s.take<float>((long)R * H * T * 3);
  b.yhat = s.take<float>(3 * PC);
  b.xwork_floats = sums ? xla_sums_work_floats(R, T + 8, C, 13) : 0;
  b.partial = sums ? s.take<float>(fsum_scratch_floats(P, C)) : nullptr;
  b.xwork = sums ? s.take<float>(b.xwork_floats) : nullptr;
  return b;
}

// Weight grads of one MHCA (fp32, the port's layouts): gdw (3, C, 3), glnw /
// glnb (3, C), gw (4, C, C) [out, in], gb (4, C).
struct MhcaGrads {
  float *gdw, *glnw, *glnb, *gw, *gb;
};

// Where an MHCA backward's sums go: launched by it (nullptr) or added to the
// caller's lists (the CSP layer launches its three MHCAs' with its own).
struct SumLists {
  FJobs* f;
  int nf;
  XJobs* x;
  int nx;
};

// The backward of one MaskedMHCA in bf16, in `form` MHCA_HAND or MHCA_VJP
// (file comment). x1 (k/v source), x2 (q source) (R*T, C) bf16 with row
// strides (vjp form, x1 == x2 and ld1 == ld2: one input); g the output's grad
// (row stride ldg); fp32 dw / lnw / lnb, bf16 wb (4, C, C) and bb (4, C)
// (cast once by the caller). Writes dx1 (and dx2 unless one input; vjp
// form: after prev, the caller's first cotangent of x1, which may alias
// dx1) and the weight grads. VJP form: weight grads per block of Rj
// sequences (JAX's grid), bf16 sums in XLA's order over blocks of tpad rows.
// With `recompute` false the caller has run mhca_bf16_forward_impl into
// bu.y3 / bu.qkv / bu.o already. sums: the caller's lists, or nullptr.
static int mhca_bf16_backward(int form, const bf16* x1, long ld1, const bf16* x2, long ld2,
                              const unsigned char* mask, int R, int T, int C, int H,
                              const float* dw, const float* lnw, const float* lnb,
                              const bf16* wb, const bf16* bb, float eps, const bf16* g,
                              long ldg, const bf16* prev, long ldprev, bf16* dx1, long lddx1,
                              bf16* dx2, long lddx2, const MhcaGrads& gr, int Rj, int tpad,
                              const MhcaBwdBufs& bu, bool recompute, SumLists* sums,
                              XSplit split, cudaStream_t s) {
  const long P = (long)R * T, PC = P * C, CC = (long)C * C;
  const int d = C / H, vjp = form == MHCA_VJP;
  const bool one = vjp && x1 == x2 && ld1 == ld2;
  if (C % 8 || d % 8 || R % Rj) return (int)cudaErrorInvalidValue;
  const float scale = __bfloat162float(__float2bfloat16_rn((float)(1.0 / sqrt((double)d))));
  int rc;

  // the forward, recomputed: conv + LN, q/k/v, the attention's output o
  // (as mhca_bf16_forward_impl)
  if (recompute) {
    rc = with_cpl(C, [&](auto cpl) {
      dwconv_ln_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
          x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, lnb, eps, bu.y3);
    });
    if (rc) return rc;
    Bf16Batch qb;
    for (int i = 0; i < 3; ++i)
      qb.g[i] = bf16_gemm(bu.y3 + i * PC, C, wb + i * CC, C, bu.qkv + i * PC, C,
                          bb + (long)i * C, i == 2 ? mask : nullptr, (int)P, C, C);
    qb.g[0].scale = scale;
    if ((rc = launch_gemm_bf16(qb, 3, s))) return rc;
    if ((rc = launch_attn_bf16(bu.qkv, bu.qkv + PC, bu.qkv + 2 * PC, mask, R, T, C, H, bu.o, s)))
      return rc;
  }
  const bf16 *q = bu.qkv, *k = bu.qkv + PC, *v = bu.qkv + 2 * PC;

  // proj: go = bf16((g . m) Wp), the mask read with g
  XGemm pg = xgemm((int)P, C, C);
  xg_a(pg, g, ldg);
  pg.amask = mask;
  xg_b(pg, wb + 3 * CC, C);
  xg_c(pg, bu.go, C, 0);
  if ((rc = launch_xgemm(pg, s))) return rc;

  // attention backward: dq = bf16(dS k) * scale, dk = bf16(dS^T q), dv =
  // bf16(bf16(P)^T go) * mask
  if ((rc = launch_attn_bwd_bf16(q, k, v, bu.go, mask, R, T, C, H, vjp, scale, bu.dqkv,
                                 bu.dqkv + PC, bu.dqkv + 2 * PC, bu.stat, s)))
    return rc;

  // dense layers: the LN outputs' grads dyl_i = bf16(dy_i W_i), one launch;
  // the weight grads dy_i^T y_i and (g . m)^T o, per block rounded (vjp) or
  // fp32 (hand), one launch
  XGemm xg[4];
  for (int i = 0; i < 3; ++i) {
    xg[i] = xgemm((int)P, C, C);
    xg_a(xg[i], bu.dqkv + i * PC, C);
    xg_b(xg[i], wb + i * CC, C);
    xg_c(xg[i], bu.dyl + i * PC, C, 0);
  }
  if ((rc = launch_xgemms(xg, 3, s))) return rc;
  for (int i = 0; i < 4; ++i) {
    xg[i] = xgemm(C, C, (int)P);
    if (i < 3) {
      xg_at(xg[i], bu.dqkv + i * PC, C);
      xg_b(xg[i], bu.y3 + i * PC, C);
    } else {
      xg_at(xg[i], g, ldg);
      xg[i].amask = mask;
      xg_b(xg[i], bu.o, C);
    }
    xg_c(xg[i], gr.gw + i * CC, C, 1);
    if (vjp) xg_blocks(xg[i], Rj * T);
  }
  if ((rc = launch_xgemms(xg, 4, s, split))) return rc;

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
  FJobs fown;
  XJobs xown;
  SumLists own{&fown, 0, &xown, 0};
  SumLists& L = sums ? *sums : own;
  if (L.nf + 6 + (vjp ? 0 : 13) > FJ_MAX || L.nx + (vjp ? 13 : 0) > XJ_MAX)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    FJob& j = L.f->j[L.nf++];
    j = fjob(bu.dyl + i * PC, C, 1, (int)P, C, gr.glnw + (long)i * C);
    j.b = bu.yhat + i * PC;
    j.ldb = C;
    L.f->j[L.nf++] = fjob(bu.dyl + i * PC, C, 1, (int)P, C, gr.glnb + (long)i * C);
  }
  if (!vjp) {
    for (int i = 0; i < 4; ++i)
      L.f->j[L.nf++] = i < 3 ? fjob(bu.dqkv + i * PC, C, 1, (int)P, C, gr.gb + (long)i * C)
                             : fjob(g, ldg, 1, (int)P, C, gr.gb + 3L * C, mask);
    for (int i = 0; i < 3; ++i)
      for (int tap = 0; tap < 3; ++tap) {
        FJob& j = L.f->j[L.nf++];
        j = fjob(i == 0 ? x2 : x1, i == 0 ? ld2 : ld1, 1, (int)P, C,
                 gr.gdw + (long)i * C * 3 + tap);
        j.ostride = 3; j.shift = tap - 1; j.seq = T;
        j.b = bu.dzm + i * PC; j.ldb = C; j.b_bf = 1;
      }
  } else {
    for (int i = 0; i < 4; ++i)
      L.x->j[L.nx++] = i < 3 ? xjob(bu.dqkv + i * PC, C, gr.gb + (long)i * C, C, T, tpad)
                             : xjob(g, ldg, gr.gb + 3L * C, C, T, tpad, mask);
    for (int i = 0; i < 3; ++i)
      for (int tap = 0; tap < 3; ++tap) {
        XJob& j = L.x->j[L.nx++];
        j = xjob(i == 0 ? x2 : x1, i == 0 ? ld2 : ld1, gr.gdw + (long)i * C * 3 + tap, C, T,
                 tpad);
        j.ostride = 3; j.shift = tap - 1; j.twod = 1;
        j.b = bu.dzm + i * PC; j.ldb = C;
      }
  }
  if (!sums) {
    if ((rc = launch_fsums(fown, own.nf, bu.partial, s))) return rc;
    if (own.nx && (rc = launch_xla_sums(xown, own.nx, R / Rj, Rj, bu.xwork, bu.xwork_floats, s)))
      return rc;
  }
  return 0;
}
