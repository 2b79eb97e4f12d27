// MaskedMHCA backward for Hopper: the port of the Pallas kernel
// `_mhca_bwd_kernel` / `_mhca_diff_bwd` (unav_yolyolva_tpu/ops/
// pallas_fusion.py). Like the TPU kernel it saves nothing from the forward
// but its inputs, and runs in two halves:
//   mhca_recompute: the forward's own launches (mhca.cuh: conv + LN, the
//     q/k/v product, the attention, which also writes each query row's
//     log-sum-exp, and the proj product when the caller needs the output),
//     keeping the intermediates the backward reads (MhcaSaved);
//   mhca_backward_saved: the chain in reverse from those intermediates:
//     proj dense backward   g_o = (g . mm) Wp                    (A.B)
//     attention backward, split so that neither pass needs atomics:
//       attn_bwd_dq_kernel, per 32-query tile: D = rowsum(g_o * o) (the
//         softmax term sum(att * datt)), then over key tiles S = q k^T,
//         dP = g_o v^T, dS = P (dP - D) with P = exp(S - lse), dq += dS k;
//       attn_bwd_dkdv_kernel, per 32-key tile over query tiles: the same S
//         and dP, dv += P^T g_o (masked), dk += dS^T q;
//       masked keys have P = 0, so a row without a valid key gets exact 0;
//     q/k/v dense backward: three input-grad products (A.B) and the four
//       weight grads (A^T.B over all R*T rows, one launch);
//     ln_bwd_kernel: LayerNorm backward, one warp per frame, recomputing the
//       conv and the fp32 statistics; dwconv_bwd_kernel: the conv's input
//       grad with the output mask applied;
//     one batched column-sum launch (colsum.cuh) for the dense biases, the
//       LN affine and the depthwise taps.
// The standalone backward and the TransformerBlock's call both halves; the
// CSP backward runs each inner MHCA's recompute once, inside its own.
// Bound: operations. Every product (the recompute's and the backward's
// dense layers, the attention's five) runs in 3xTF32 on the tensor cores
// (gemm_tc.cuh); the softmax, LN and conv stay fp32 FFMA. The attention
// backward splits each query, dO, key and value tile once into TF32 (hi,
// lo) pairs in shared memory, as the forward splits its key and value
// tiles, and computes S with the forward's own fragments, slices and order
// (query rows as A, keys as B), so P = exp(S - lse) is the forward's P;
// dS and P go through shared memory to become the A operand of the next
// products. Every weight grad is a fixed-order reduction: two runs give
// the same bits.
#pragma once

#include "colsum.cuh"
#include "mhca.cuh"

constexpr int ATB_T = 32;   // queries (keys) per tile of the two attention-backward passes

// A fragment from a tile of (hi, lo) pairs: p points at the pair of (row g,
// col t), ld is the row stride in floats
__device__ __forceinline__ FragA load_frag_a_split(const float* p, int ld) {
  const float2 v0 = *reinterpret_cast<const float2*>(p);
  const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  FragA f;
  f.hi[0] = __float_as_uint(v0.x); f.lo[0] = __float_as_uint(v0.y);
  f.hi[1] = __float_as_uint(v1.x); f.lo[1] = __float_as_uint(v1.y);
  f.hi[2] = __float_as_uint(v2.x); f.lo[2] = __float_as_uint(v2.y);
  f.hi[3] = __float_as_uint(v3.x); f.lo[3] = __float_as_uint(v3.y);
  return f;
}

// One 32-row tile of a head's DP dims (zero past d and past T), as each
// thread's 16-byte chunks in registers: loaded ahead, split when stored.
template <int DP>
struct AttnRows {
  static constexpr int CH = DP / 4, N = (ATB_T * CH + 255) / 256;
  float4 v[N];

  __device__ __forceinline__ void load(const float* src, long base, int row0, int T, int C,
                                       int d) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * 256, row = e / CH, c = (e - row * CH) * 4;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < ATB_T * CH && row0 + row < T && c < d)
        v[i] = *reinterpret_cast<const float4*>(src + base + (long)(row0 + row) * C + c);
    }
  }

  // into (hi, lo) pairs, rows of 2 DP + 8 floats
  __device__ __forceinline__ void store_split(float* dst) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * 256, row = e / CH, c = (e - row * CH) * 4;
      if (e >= ATB_T * CH) continue;
      const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(x[j], hi[j], lo[j]);
      float4* o = reinterpret_cast<float4*>(dst + row * (2 * DP + 8) + 2 * c);
      o[0] = make_float4(__uint_as_float(hi[0]), __uint_as_float(lo[0]),
                         __uint_as_float(hi[1]), __uint_as_float(lo[1]));
      o[1] = make_float4(__uint_as_float(hi[2]), __uint_as_float(lo[2]),
                         __uint_as_float(hi[3]), __uint_as_float(lo[3]));
    }
  }
};

// S = Q K^T and dP = dO V^T of one warp's 16 rows (rows 16 rg ..) and 8 keys
// (keys 8 kq ..) of a 32 x 32 tile pair, from (hi, lo) pair tiles. S is
// summed as attn_tc_kernel sums its logits (32-deep slices of the head
// dims, each from zero, in order, the query as A): the same bits.
template <int DP>
__device__ __forceinline__ void attn_bwd_scores(const float* Qp, const float* Gp,
                                                const float* Kp, const float* Vp, int rg,
                                                int kq, float (&s)[4], float (&dp)[4]) {
  constexpr int HL = 2 * DP + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < DP; c0 += 32) {
    float ps[4] = {}, pd[4] = {};
#pragma unroll
    for (int kk = c0; kk < c0 + 32 && kk < DP; kk += 8) {
      const int ao = (rg * 16 + g) * HL + 2 * (kk + t4), bo = (kq * 8 + g) * HL + 2 * (kk + t4);
      mma_3xtf32(ps, load_frag_a_split(Qp + ao, HL), load_frag_b_split(Kp + bo, 8));
      mma_3xtf32(pd, load_frag_a_split(Gp + ao, HL), load_frag_b_split(Vp + bo, 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] += ps[e];
      dp[e] += pd[e];
    }
  }
}

// grid (ceil(T/32), H, R), 256 threads. DP: the head width d rounded up to
// 16, 32, 64 or 128, as in attn_tc_kernel. Warp w computes S and dP for
// query rows 16 (w % 2) .. and keys 8 (w / 2) .. of each key tile, then dq
// for the same rows and the n8 tiles w / 2, + 4, .. of the head dims.
// Shared memory: (hi, lo) pairs of the query, dO, key and value tiles
// (32 x 2DP+8 each), dS (32 x 36), each query row's lse and D.
template <int DP>
__global__ void __launch_bounds__(256, DP <= 64 ? 2 : 1) attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ go,
    const float* __restrict__ lse, const unsigned char* __restrict__ mask, int T, int C,
    int H, float scale, float* __restrict__ dq, float* __restrict__ Dout) {
  constexpr int HL = 2 * DP + 8, LDS = ATB_T + 4, NJ = (DP / 8 + 3) / 4;
  extern __shared__ __align__(16) float ab_smem[];
  float* Qp = ab_smem;
  float* Gp = Qp + ATB_T * HL;
  float* Kp = Gp + ATB_T * HL;
  float* Vp = Kp + ATB_T * HL;
  float* dS = Vp + ATB_T * HL;     // ATB_T x LDS
  float* Lq = dS + ATB_T * LDS;    // ATB_T
  float* Dq = Lq + ATB_T;          // ATB_T
  const int d = C / H, r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATB_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int e = tid; e < ATB_T * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      if (q0 + i < T) dq[base + (long)(q0 + i) * C + dd] = 0.f;
    }
    if (tid < ATB_T && q0 + tid < T) Dout[sbase + q0 + tid] = 0.f;
    return;
  }
  {
    AttnRows<DP> rq, rgo;
    rq.load(q, base, q0, T, C, d);
    rgo.load(go, base, q0, T, C, d);
    rq.store_split(Qp);
    rgo.store_split(Gp);
  }
  // D = <g_o, o> over the head's dims; warp w owns rows 4w .. 4w+3
  for (int i4 = 0; i4 < ATB_T / 8; ++i4) {
    const int i = warp * (ATB_T / 8) + i4;
    float sum = 0.f;
    if (q0 + i < T)
      for (int dd = lane; dd < d; dd += 32) {
        const long off = base + (long)(q0 + i) * C + dd;
        sum += go[off] * o[off];
      }
    sum = warp_sum(sum);
    if (lane == 0) {
      Dq[i] = sum;
      Lq[i] = q0 + i < T ? lse[sbase + q0 + i] : 0.f;
      if (q0 + i < T) Dout[sbase + q0 + i] = sum;
    }
  }
  const int rg = warp & 1, kq = warp >> 1;
  AttnRows<DP> rk, rv;
  rk.load(k, base, 0, T, C, d);
  rv.load(v, base, 0, T, C, d);
  float acc[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
  for (int k0 = 0; k0 < T; k0 += ATB_T) {
    __syncthreads();   // the last tile's readers are done
    rk.store_split(Kp);
    rv.store_split(Vp);
    __syncthreads();
    if (k0 + ATB_T < T) {   // the next tile loads while this one is used
      rk.load(k, base, k0 + ATB_T, T, C, d);
      rv.load(v, base, k0 + ATB_T, T, C, d);
    }
    float s[4], dp[4];
    attn_bwd_scores<DP>(Qp, Gp, Kp, Vp, rg, kq, s, dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rg * 16 + g + 8 * hh, key = k0 + kq * 8 + 2 * t4;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = q0 + row < T && key + e < T && mrow[key + e];
        const float pr = ok ? expf(s[2 * hh + e] - Lq[row]) : 0.f;
        ds[e] = pr * (dp[2 * hh + e] - Dq[row]);
      }
      *reinterpret_cast<float2*>(dS + row * LDS + kq * 8 + 2 * t4) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();
    // dq += dS . k over the tile's 32 keys: one summed slice
    float part[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < ATB_T; kk += 8) {
      const FragA a = load_frag_a(dS + (rg * 16 + g) * LDS + kk + t4, LDS);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = kq + 4 * jj;
        if (j < DP / 8)
          mma_3xtf32(part[jj], a, load_frag_b_split(Kp + (kk + t4) * HL + 2 * (j * 8 + g), 4 * HL));
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] += part[jj][e];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + rg * 16 + g + 8 * hh;
    if (qrow >= T) continue;
    float* out = dq + base + (long)qrow * C;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = (kq + 4 * jj) * 8 + 2 * t4;   // d is a multiple of 4
      if (dd < d)
        *reinterpret_cast<float2*>(out + dd) =
            make_float2(acc[jj][2 * hh] * scale, acc[jj][2 * hh + 1] * scale);
    }
  }
}

// grid (ceil(T/32), H, R), 256 threads, per 32-key tile over all query
// tiles. Warp w computes S and dP for query rows 16 (w % 2) .. and keys
// 8 (w / 2) .. (the forward's orientation), writes P and dS to shared
// memory as [query][key], then dk and dv for keys 16 (w % 2) .. and the n8
// tiles w / 2, + 4, .. of the head dims, reading P and dS transposed as the
// A operand. Shared memory: pairs of the key, value, query and dO tiles,
// P and dS (32 x 40 each), lse and D of the query tile.
template <int DP>
__global__ void __launch_bounds__(256, DP <= 64 ? 2 : 1) attn_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ go, const float* __restrict__ lse,
    const float* __restrict__ D, const unsigned char* __restrict__ mask, int T, int C,
    int H, float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int HL = 2 * DP + 8, LDT = ATB_T + 8, NJ = (DP / 8 + 3) / 4;
  extern __shared__ __align__(16) float ab_smem[];
  float* Kp = ab_smem;
  float* Vp = Kp + ATB_T * HL;
  float* Qp = Vp + ATB_T * HL;
  float* Gp = Qp + ATB_T * HL;
  float* Pt = Gp + ATB_T * HL;     // ATB_T x LDT, [query][key]
  float* St = Pt + ATB_T * LDT;    // dS, the same layout
  float* Lq = St + ATB_T * LDT;    // ATB_T
  float* Dq = Lq + ATB_T;          // ATB_T
  const int d = C / H, r = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ATB_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int e = tid; e < ATB_T * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      if (k0 + i < T) {
        dk[base + (long)(k0 + i) * C + dd] = 0.f;
        dv[base + (long)(k0 + i) * C + dd] = 0.f;
      }
    }
    return;
  }
  {
    AttnRows<DP> rk, rv;
    rk.load(k, base, k0, T, C, d);
    rv.load(v, base, k0, T, C, d);
    rk.store_split(Kp);
    rv.store_split(Vp);
  }
  const int rg = warp & 1, kq = warp >> 1;
  AttnRows<DP> rq, rgo;
  rq.load(q, base, 0, T, C, d);
  rgo.load(go, base, 0, T, C, d);
  float adk[NJ][4], adv[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[jj][e] = adv[jj][e] = 0.f;
  for (int q0 = 0; q0 < T; q0 += ATB_T) {
    __syncthreads();   // the last tile's readers are done
    rq.store_split(Qp);
    rgo.store_split(Gp);
    if (tid < ATB_T) {
      const bool ok = q0 + tid < T;
      Lq[tid] = ok ? lse[sbase + q0 + tid] : 0.f;
      Dq[tid] = ok ? D[sbase + q0 + tid] : 0.f;
    }
    __syncthreads();
    if (q0 + ATB_T < T) {
      rq.load(q, base, q0 + ATB_T, T, C, d);
      rgo.load(go, base, q0 + ATB_T, T, C, d);
    }
    float s[4], dp[4];
    attn_bwd_scores<DP>(Qp, Gp, Kp, Vp, rg, kq, s, dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rg * 16 + g + 8 * hh, key = k0 + kq * 8 + 2 * t4;
      float pr[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = q0 + row < T && key + e < T && mrow[key + e];
        pr[e] = ok ? expf(s[2 * hh + e] - Lq[row]) : 0.f;
        ds[e] = pr[e] * (dp[2 * hh + e] - Dq[row]);
      }
      const int off = row * LDT + kq * 8 + 2 * t4;
      *reinterpret_cast<float2*>(Pt + off) = make_float2(pr[0], pr[1]);
      *reinterpret_cast<float2*>(St + off) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();
    // dv += P^T . dO, dk += dS^T . q over the tile's 32 queries: one slice
    float pv[NJ][4] = {}, pk[NJ][4] = {};
#pragma unroll
    for (int kk = 0; kk < ATB_T; kk += 8) {
      const int ao = (kk + t4) * LDT + rg * 16 + g;
      const FragA ap = load_frag_a_kmajor(Pt + ao, LDT), as = load_frag_a_kmajor(St + ao, LDT);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = kq + 4 * jj;
        if (j < DP / 8) {
          const int bo = (kk + t4) * HL + 2 * (j * 8 + g);
          mma_3xtf32(pv[jj], ap, load_frag_b_split(Gp + bo, 4 * HL));
          mma_3xtf32(pk[jj], as, load_frag_b_split(Qp + bo, 4 * HL));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adv[jj][e] += pv[jj][e];
        adk[jj][e] += pk[jj][e];
      }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + rg * 16 + g + 8 * hh;
    if (key >= T) continue;
    const float mk = mrow[key] ? 1.f : 0.f;
    const long row = base + (long)key * C;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = (kq + 4 * jj) * 8 + 2 * t4;
      if (dd < d) {
        *reinterpret_cast<float2*>(dk + row + dd) = make_float2(adk[jj][2 * hh], adk[jj][2 * hh + 1]);
        *reinterpret_cast<float2*>(dv + row + dd) =
            make_float2(adv[jj][2 * hh] * mk, adv[jj][2 * hh + 1] * mk);
      }
    }
  }
}

template <int DP>
static int launch_attn_bwd_tc(const float* qkv, const float* att, const float* go,
                              const float* lse, const unsigned char* mask, int R, int T, int C,
                              int H, float scale, float* dqkv, float* Dsum,
                              cudaStream_t stream) {
  const long PC = (long)R * T * C;
  const int pairs = 4 * ATB_T * (2 * DP + 8);
  const int smem_dq = (int)sizeof(float) * (pairs + ATB_T * (ATB_T + 4) + 2 * ATB_T);
  const int smem_kv = (int)sizeof(float) * (pairs + 2 * ATB_T * (ATB_T + 8) + 2 * ATB_T);
  static int limit_dq = 0, limit_kv = 0;
  raise_smem_limit((const void*)attn_bwd_dq_kernel<DP>, smem_dq, limit_dq);
  raise_smem_limit((const void*)attn_bwd_dkdv_kernel<DP>, smem_kv, limit_kv);
  const dim3 grid(ceil_div(T, ATB_T), H, R);
  attn_bwd_dq_kernel<DP><<<grid, 256, smem_dq, stream>>>(qkv, qkv + PC, qkv + 2 * PC, att, go,
                                                         lse, mask, T, C, H, scale, dqkv, Dsum);
  UNAV_RETURN_IF_ERROR();
  attn_bwd_dkdv_kernel<DP><<<grid, 256, smem_kv, stream>>>(qkv, qkv + PC, qkv + 2 * PC, go, lse,
                                                           Dsum, mask, T, C, H, dqkv + PC,
                                                           dqkv + 2 * PC);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// LayerNorm backward of q/k/v, one warp per frame: recomputes the conv and
// the fp32 statistics as dwconv_ln_kernel does, writes yhat (for the affine
// grads) and dz * mask (the conv's output grad). dy, yhat, dzm: 3 x P x C.
template <int CPL>
__global__ void __launch_bounds__(256) ln_bwd_kernel(
    const float* __restrict__ x1, long ld1, const float* __restrict__ x2, long ld2,
    const unsigned char* __restrict__ mask, long P, int T, int C,
    const float* __restrict__ dw, const float* __restrict__ lnw, float eps,
    const float* __restrict__ dy, float* __restrict__ yhat, float* __restrict__ dzm) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const int t = (int)(row % T);
  const float mval = mask[row] ? 1.f : 0.f;
  for (int which = 0; which < 3; ++which) {
    const float* x = which == 0 ? x2 : x1;
    const long ld = which == 0 ? ld2 : ld1;
    const float* xr = x + row * ld;
    const float* w = dw + (long)which * C * 3;
    float y[CPL];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      y[i] = 0.f;
      if (c < C) {
        const float left = t > 0 ? xr[c - ld] : 0.f;
        const float right = t < T - 1 ? xr[c + ld] : 0.f;
        y[i] = (left * w[c * 3 + 0] + xr[c] * w[c * 3 + 1] + right * w[c * 3 + 2]) * mval;
        s += y[i];
      }
    }
    const float mean = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        y[i] -= mean;
        v += y[i] * y[i];
      }
    }
    const float inv = rsqrtf(warp_sum(v) / C + eps);
    const long off = (long)which * P * C + row * C;
    float dyh[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      dyh[i] = 0.f;
      if (c < C) {
        y[i] *= inv;                                   // yhat
        dyh[i] = dy[off + c] * lnw[which * C + c];
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
        dzm[off + c] = inv * (dyh[i] - s1 - y[i] * s2) * mval;
      }
    }
  }
}

// Input grads of the three depthwise k=3 convs: dx2 from q, dx1 from k and
// v; with dx1 == dx2 (self-attention) one sum. accumulate adds into dx.
__global__ void __launch_bounds__(256) dwconv_bwd_kernel(
    const float* __restrict__ dzm, long P, int T, int C, const float* __restrict__ dw,
    float* dx1, long lddx1, float* dx2, long lddx2, int accumulate) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * C) return;
  const long m = idx / C;
  const int c = (int)(idx - m * C), t = (int)(m % T);
  float part[3];
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    const float* z = dzm + (long)which * P * C;
    const float* w = dw + (long)which * C * 3 + c * 3;
    float s = t + 1 < T ? z[(m + 1) * C + c] * w[0] : 0.f;
    s += z[m * C + c] * w[1];
    if (t > 0) s += z[(m - 1) * C + c] * w[2];
    part[which] = s;
  }
  const float kv = part[1] + part[2];
  if (dx1 == dx2 && lddx1 == lddx2) {
    float* o = dx1 + m * lddx1 + c;
    *o = accumulate ? *o + (part[0] + kv) : part[0] + kv;
  } else {
    float* o1 = dx1 + m * lddx1 + c;
    float* o2 = dx2 + m * lddx2 + c;
    *o1 = accumulate ? *o1 + kv : kv;
    *o2 = accumulate ? *o2 + part[0] : part[0];
  }
}


// The intermediates of one MHCA forward that its backward reads: the LN
// outputs nrm (3 x P x C), the projections qkv (3 x P x C: q scaled by
// 1/sqrt(d), v masked), the attention output att (P x C) and each query
// row's log-sum-exp lse (R x H x T).
struct MhcaSaved {
  float *nrm, *qkv, *att, *lse;
};

static long mhca_saved_floats(int R, int T, int C, int H) {
  return 7L * R * T * C + ((long)R * H * T + 3) / 4 * 4;
}

static MhcaSaved mhca_saved(float* base, int R, int T, int C) {
  const long PC = (long)R * T * C;
  return MhcaSaved{base, base + 3 * PC, base + 6 * PC, base + 7 * PC};
}

// floats of working scratch mhca_backward_saved needs
static long mhca_backward_work_floats(int R, int T, int C, int H) {
  const long P = (long)R * T, PC = P * C;
  return 13 * PC + ((long)R * H * T + 3) / 4 * 4 + colsum_scratch_floats(P, C) +
         gemm_splitk_floats((long)C * C);
}

// The first half of a backward: launches 1-3 of the forward (as
// mhca_forward_impl, operands the same) into sv, and with out the proj
// product too (the block's output, row stride ldo), the forward's bits.
static int mhca_recompute(const float* x1, long ld1, const float* x2, long ld2,
                          const unsigned char* mask, int R, int T, int C, int H,
                          const float* dw, const float* lnw, const float* lnb, const float* w,
                          const float* b, float eps, const MhcaSaved& sv, float* out, long ldo,
                          cudaStream_t stream) {
  int rc = mhca_attention_impl(x1, ld1, x2, ld2, mask, R, T, C, H, dw, lnw, lnb, w, b, eps,
                               sv.nrm, sv.qkv, sv.att, sv.lse, stream);
  if (rc || !out) return rc;
  GemmBatch proj;
  proj.g[0] = gemm_args(sv.att, C, w + 3L * C * C, C, out, ldo, b + 3L * C, mask, 1.f,
                        (int)(R * (long)T), C, C);
  return launch_gemm(proj, 1, stream);
}

// The second half: from sv (mhca_recompute) and the upstream grad g (row
// stride ldg), writes (or, with accumulate, adds) the input grads into dx1 /
// dx2 (row strides), and writes the fp32 weight grads gdw (3, C, 3),
// glnw/glnb (3, C), gw (4, C, C), gb (4, C). work: mhca_backward_work_floats
// floats.
static int mhca_backward_saved(const float* x1, long ld1, const float* x2, long ld2,
                               const unsigned char* mask, int R, int T, int C, int H,
                               const float* dw, const float* lnw, const float* w, float eps,
                               const MhcaSaved& sv, const float* g, long ldg, float* dx1,
                               long lddx1, float* dx2, long lddx2, int accumulate, float* gdw,
                               float* glnw, float* glnb, float* gw, float* gb, float* work,
                               cudaStream_t stream) {
  const long P = (long)R * T, PC = P * C, CC = (long)C * C, HT = (long)R * H * T;
  const int d = C / H;
  float* go = work;              // PC: the attention output's grad
  float* dqkv = go + PC;         // 3 PC: grads of the q/k/v dense outputs
  float* dy = dqkv + 3 * PC;     // 3 PC: grads of the LN outputs
  float* yhat = dy + 3 * PC;     // 3 PC
  float* dzm = yhat + 3 * PC;    // 3 PC: masked grads of the conv outputs
  float* Dsum = dzm + 3 * PC;    // HT
  float* partial = Dsum + (HT + 3) / 4 * 4;
  float* split = partial + colsum_scratch_floats(P, C);

  GemmBatch gbat;
  gbat.g[0] = gemm_nn(g, ldg, w + 3 * CC, C, go, C, mask, (int)P, C, C);
  int rc = launch_gemm(gbat, 1, stream);
  if (rc) return rc;

  const float qscale = (float)(1.0 / sqrt((double)d));
  if (d % 4 || C % 4) return (int)cudaErrorMisalignedAddress;
  rc = d <= 16   ? launch_attn_bwd_tc<16>(sv.qkv, sv.att, go, sv.lse, mask, R, T, C, H, qscale,
                                         dqkv, Dsum, stream)
       : d <= 32 ? launch_attn_bwd_tc<32>(sv.qkv, sv.att, go, sv.lse, mask, R, T, C, H, qscale,
                                          dqkv, Dsum, stream)
       : d <= 64 ? launch_attn_bwd_tc<64>(sv.qkv, sv.att, go, sv.lse, mask, R, T, C, H, qscale,
                                          dqkv, Dsum, stream)
       : d <= ATT_MAX_D
           ? launch_attn_bwd_tc<128>(sv.qkv, sv.att, go, sv.lse, mask, R, T, C, H, qscale,
                                     dqkv, Dsum, stream)
           : (int)cudaErrorInvalidValue;
  if (rc) return rc;

  for (int i = 0; i < 3; ++i)
    gbat.g[i] = gemm_nn(dqkv + i * PC, C, w + i * CC, C, dy + i * PC, C, nullptr, (int)P, C, C);
  if ((rc = launch_gemm(gbat, 3, stream))) return rc;
  for (int i = 0; i < 3; ++i)
    gbat.g[i] = gemm_wgrad(dqkv + i * PC, C, sv.nrm + i * PC, C, gw + i * CC, nullptr, C, C,
                           (int)P);
  gbat.g[3] = gemm_wgrad(g, ldg, sv.att, C, gw + 3 * CC, mask, C, C, (int)P);
  if ((rc = launch_gemm(gbat, 4, stream, split, gemm_splitk_floats(CC)))) return rc;

  const int blocks = ceil_div(P, 8);
  int cpl = 1;
  while (32 * cpl < C) cpl *= 2;
  switch (cpl) {
#define UNAV_LNB_CASE(n) case n: ln_bwd_kernel<n><<<blocks, 256, 0, stream>>>( \
      x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, eps, dy, yhat, dzm); break;
    UNAV_LNB_CASE(1) UNAV_LNB_CASE(2) UNAV_LNB_CASE(4) UNAV_LNB_CASE(8)
    UNAV_LNB_CASE(16) UNAV_LNB_CASE(32)
#undef UNAV_LNB_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  UNAV_RETURN_IF_ERROR();
  dwconv_bwd_kernel<<<ceil_div(PC, 256), 256, 0, stream>>>(dzm, P, T, C, dw, dx1, lddx1, dx2,
                                                           lddx2, accumulate);
  UNAV_RETURN_IF_ERROR();

  ColBatch cb;
  int n = 0;
  for (int i = 0; i < 3; ++i) cb.j[n++] = col_job(dqkv + i * PC, C, (int)P, C, gb + i * C);
  cb.j[n] = col_job(g, ldg, (int)P, C, gb + 3L * C);
  cb.j[n++].rowmask = mask;
  for (int i = 0; i < 3; ++i) {
    cb.j[n] = col_job(dy + i * PC, C, (int)P, C, glnw + i * C);
    cb.j[n].b = yhat + i * PC;
    cb.j[n++].ldb = C;
    cb.j[n++] = col_job(dy + i * PC, C, (int)P, C, glnb + i * C);
  }
  for (int i = 0; i < 3; ++i)
    for (int tap = 0; tap < 3; ++tap) {
      ColJob& j = cb.j[n++];
      j = col_job(i == 0 ? x2 : x1, i == 0 ? ld2 : ld1, (int)P, C, gdw + (long)i * C * 3 + tap);
      j.ostride = 3; j.shift = tap - 1; j.seq = T;
      j.b = dzm + i * PC; j.ldb = C;
    }
  rc = launch_colsum(cb, n, partial, stream);
  return rc;
}
