// MaskedMHCA backward for Hopper: the port of the Pallas kernel
// `_mhca_bwd_kernel` / `_mhca_diff_bwd` (unav_yolyolva_tpu/ops/
// pallas_fusion.py). mhca_backward_impl saves nothing from the forward: like
// the TPU kernel it recomputes it (launches 1-3, the attention also writing each query row's
// log-sum-exp) and walks the chain in reverse:
//   proj dense backward   g_o = (g . mm) Wp                    (GEMM, A.B)
//   attention backward, split so that neither pass needs atomics:
//     attn_bwd_dq_kernel, per 32-query tile: D = rowsum(g_o * o) (the
//       softmax term sum(att * datt)), then over key tiles
//       ds = P (g_o v^T - D) with P = exp(s - lse), dq = ds k / sqrt(d);
//     attn_bwd_dkdv_kernel, per 32-key tile over query tiles:
//       dv = P^T g_o (masked), dk = ds^T q;
//     masked keys have P = 0, so a row without a valid key gets exact 0;
//   q/k/v dense backward: three input-grad GEMMs (A.B) and the four
//     weight-grad GEMMs (A^T.B over all R*T rows, one launch);
//   ln_bwd_kernel: LayerNorm backward, one warp per frame, recomputing the
//     conv and the fp32 statistics; dwconv_bwd_kernel: the conv's input
//     grad with the output mask applied;
//   one batched column-sum launch (colsum.cuh) for the dense biases, the LN
//     affine and the depthwise taps.
// Every weight grad is a fixed-order reduction: two runs give the same bits.
// The recompute runs the forward's own launches (its products and attention
// in 3xTF32 on the tensor cores, gemm_tc.cuh); the dq and dk/dv passes
// below recompute the logits with FFMA against that log-sum-exp, so their
// P = exp(s - lse) differs from the forward's by the two products'
// rounding, about 1e-6 relative: well inside the backward's tolerances.
// Bound: operations (recompute + twice the forward's products; the
// backward's own products run on FFMA).
#pragma once

#include "colsum.cuh"
#include "mhca.cuh"

constexpr int ATT_Q = 32;   // queries (keys) per tile of the two attention-backward passes

// grid (ceil(T/32), H, R), 256 threads: thread (qi, g8) owns query qi of the
// tile, keys g8 + 8j of each key tile and output dims g8 + 8j.
__global__ void __launch_bounds__(256) attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ go,
    const float* __restrict__ lse, const unsigned char* __restrict__ mask, int T, int C,
    int H, float scale, float* __restrict__ dq, float* __restrict__ Dout) {
  extern __shared__ float sm[];
  const int d = C / H, dp = d + 1;
  float* Qs = sm;                 // ATT_Q x dp
  float* Gs = Qs + ATT_Q * dp;    // ATT_Q x dp
  float* Ks = Gs + ATT_Q * dp;    // 32 x dp
  float* Vs = Ks + 32 * dp;       // 32 x dp
  float* Ds = Vs + 32 * dp;       // ATT_Q x 33
  float* Dq = Ds + ATT_Q * 33;    // ATT_Q
  float* Lq = Dq + ATT_Q;         // ATT_Q
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_Q;
  const int tid = threadIdx.x, qi = tid >> 3, g8 = tid & 7;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int j = g8; j < d; j += 8)
      if (q0 + qi < T) dq[base + (long)(q0 + qi) * C + j] = 0.f;
    if (g8 == 0 && q0 + qi < T) Dout[sbase + q0 + qi] = 0.f;
    return;
  }
  for (int e = tid; e < ATT_Q * d; e += 256) {
    const int i = e / d, dd = e - i * d;
    const bool ok = q0 + i < T;
    const long off = base + (long)(q0 + i) * C + dd;
    Qs[i * dp + dd] = ok ? q[off] : 0.f;
    Gs[i * dp + dd] = ok ? go[off] : 0.f;
  }
  // D = <g_o, o> over the head's dims; warp w owns rows 4w .. 4w+3
  const int warp = tid >> 5, lane = tid & 31;
  for (int i4 = 0; i4 < ATT_Q / 8; ++i4) {
    const int i = warp * (ATT_Q / 8) + i4;
    float s = 0.f;
    if (q0 + i < T)
      for (int dd = lane; dd < d; dd += 32) {
        const long off = base + (long)(q0 + i) * C + dd;
        s += go[off] * o[off];
      }
    s = warp_sum(s);
    if (lane == 0) {
      Dq[i] = s;
      Lq[i] = q0 + i < T ? lse[sbase + q0 + i] : 0.f;
      if (q0 + i < T) Dout[sbase + q0 + i] = s;
    }
  }
  float acc[ATT_MAX_D / 8];
#pragma unroll
  for (int j = 0; j < ATT_MAX_D / 8; ++j) acc[j] = 0.f;
  const bool qok = q0 + qi < T;
  for (int k0 = 0; k0 < T; k0 += 32) {
    __syncthreads();
    for (int e = tid; e < 32 * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      const bool ok = k0 + i < T;
      const long off = base + (long)(k0 + i) * C + dd;
      Ks[i * dp + dd] = ok ? k[off] : 0.f;
      Vs[i * dp + dd] = ok ? v[off] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dd = 0; dd < d; ++dd) {
      const float qv = Qs[qi * dp + dd], gv = Gs[qi * dp + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(qv, Ks[(g8 + 8 * j) * dp + dd], s[j]);
        dpv[j] = fmaf(gv, Vs[(g8 + 8 * j) * dp + dd], dpv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + g8 + 8 * j;
      float pr = 0.f;
      if (qok && key < T && mrow[key]) pr = expf(s[j] - Lq[qi]);
      Ds[qi * 33 + g8 + 8 * j] = pr * (dpv[j] - Dq[qi]);
    }
    __syncthreads();
    const int kn = min(32, T - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float dsv = Ds[qi * 33 + kk];
#pragma unroll
      for (int j = 0; j < ATT_MAX_D / 8; ++j) {
        const int dd = g8 + 8 * j;
        if (dd < d) acc[j] = fmaf(dsv, Ks[kk * dp + dd], acc[j]);
      }
    }
  }
  if (qok) {
    float* row = dq + base + (long)(q0 + qi) * C;
#pragma unroll
    for (int j = 0; j < ATT_MAX_D / 8; ++j) {
      const int dd = g8 + 8 * j;
      if (dd < d) row[dd] = acc[j] * scale;
    }
  }
}

// grid (ceil(T/32), H, R), 256 threads: thread (ki, g8) owns key ki of the
// tile, queries g8 + 8j of each query tile and output dims g8 + 8j.
__global__ void __launch_bounds__(256) attn_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ go, const float* __restrict__ lse,
    const float* __restrict__ D, const unsigned char* __restrict__ mask, int T, int C,
    int H, float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ float sm[];
  const int d = C / H, dp = d + 1;
  float* Ks = sm;                 // 32 x dp
  float* Vs = Ks + 32 * dp;       // 32 x dp
  float* Qs = Vs + 32 * dp;       // ATT_Q x dp
  float* Gs = Qs + ATT_Q * dp;    // ATT_Q x dp
  float* Ps = Gs + ATT_Q * dp;    // 32 x 33, [key][query]
  float* Ss = Ps + 32 * 33;       // 32 x 33
  float* Lq = Ss + 32 * 33;       // ATT_Q
  float* Dq = Lq + ATT_Q;         // ATT_Q
  const int r = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * 32;
  const int tid = threadIdx.x, ki = tid >> 3, g8 = tid & 7;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const long sbase = ((long)r * H + h) * T;
  const int key = k0 + ki;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    for (int j = g8; j < d; j += 8)
      if (key < T) {
        dk[base + (long)key * C + j] = 0.f;
        dv[base + (long)key * C + j] = 0.f;
      }
    return;
  }
  for (int e = tid; e < 32 * d; e += 256) {
    const int i = e / d, dd = e - i * d;
    const bool ok = k0 + i < T;
    const long off = base + (long)(k0 + i) * C + dd;
    Ks[i * dp + dd] = ok ? k[off] : 0.f;
    Vs[i * dp + dd] = ok ? v[off] : 0.f;
  }
  const bool kok = key < T && mrow[key];
  float adk[ATT_MAX_D / 8], adv[ATT_MAX_D / 8];
#pragma unroll
  for (int j = 0; j < ATT_MAX_D / 8; ++j) adk[j] = adv[j] = 0.f;
  for (int q0 = 0; q0 < T; q0 += ATT_Q) {
    __syncthreads();
    for (int e = tid; e < ATT_Q * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      const bool ok = q0 + i < T;
      const long off = base + (long)(q0 + i) * C + dd;
      Qs[i * dp + dd] = ok ? q[off] : 0.f;
      Gs[i * dp + dd] = ok ? go[off] : 0.f;
    }
    if (tid < ATT_Q) {
      const bool ok = q0 + tid < T;
      Lq[tid] = ok ? lse[sbase + q0 + tid] : 0.f;
      Dq[tid] = ok ? D[sbase + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dd = 0; dd < d; ++dd) {
      const float kv = Ks[ki * dp + dd], vv = Vs[ki * dp + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(Qs[(g8 + 8 * j) * dp + dd], kv, s[j]);
        dpv[j] = fmaf(Gs[(g8 + 8 * j) * dp + dd], vv, dpv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = g8 + 8 * j;
      float pr = 0.f;
      if (kok && q0 + qq < T) pr = expf(s[j] - Lq[qq]);
      Ps[ki * 33 + qq] = pr;
      Ss[ki * 33 + qq] = pr * (dpv[j] - Dq[qq]);
    }
    __syncthreads();
    const int qn = min(ATT_Q, T - q0);
    for (int qq = 0; qq < qn; ++qq) {
      const float pv = Ps[ki * 33 + qq], sv = Ss[ki * 33 + qq];
#pragma unroll
      for (int j = 0; j < ATT_MAX_D / 8; ++j) {
        const int dd = g8 + 8 * j;
        if (dd < d) {
          adv[j] = fmaf(pv, Gs[qq * dp + dd], adv[j]);
          adk[j] = fmaf(sv, Qs[qq * dp + dd], adk[j]);
        }
      }
    }
  }
  if (key < T) {
    const float mk = mrow[key] ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < ATT_MAX_D / 8; ++j) {
      const int dd = g8 + 8 * j;
      if (dd < d) {
        dk[base + (long)key * C + dd] = adk[j];
        dv[base + (long)key * C + dd] = adv[j] * mk;
      }
    }
  }
}

static size_t attn_bwd_dq_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(2 * ATT_Q + 64) * (d + 1) + ATT_Q * 33 + 2 * ATT_Q);
}

static size_t attn_bwd_dkdv_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(2 * ATT_Q + 64) * (d + 1) + 2 * 32 * 33 + 2 * ATT_Q);
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

static long mhca_backward_scratch_floats(int R, int T, int C, int H) {
  const long P = (long)R * T, PC = P * C;
  return 20 * PC + 2L * R * H * T + colsum_scratch_floats(P, C) +
         gemm_splitk_floats((long)C * C);
}

// Recompute-backward of one MaskedMHCA forward (same operands as
// mhca_forward_impl) for the upstream grad g (row stride ldg). Writes (or,
// with accumulate, adds) the input grads into dx1 / dx2 (row strides), and
// writes the fp32 weight grads gdw (3, C, 3), glnw/glnb (3, C),
// gw (4, C, C), gb (4, C). scratch: mhca_backward_scratch_floats floats.
static int mhca_backward_impl(const float* x1, long ld1, const float* x2, long ld2,
                              const unsigned char* mask, int R, int T, int C, int H,
                              const float* dw, const float* lnw, const float* lnb,
                              const float* w, const float* b, float eps, const float* g,
                              long ldg, float* dx1, long lddx1, float* dx2, long lddx2,
                              int accumulate, float* gdw, float* glnw, float* glnb,
                              float* gw, float* gb, float* scratch, cudaStream_t stream) {
  const long P = (long)R * T, PC = P * C, CC = (long)C * C, HT = (long)R * H * T;
  const int d = C / H;
  float* nrm = scratch;          // 3 PC: LN outputs
  float* qkv = nrm + 3 * PC;     // 3 PC: q (scaled), k, v (masked)
  float* att = qkv + 3 * PC;     // PC: attention output
  float* go = att + PC;          // PC: its grad
  float* dqkv = go + PC;         // 3 PC: grads of the q/k/v dense outputs
  float* dy = dqkv + 3 * PC;     // 3 PC: grads of the LN outputs
  float* yhat = dy + 3 * PC;     // 3 PC
  float* dzm = yhat + 3 * PC;    // 3 PC: masked grads of the conv outputs
  float* lse = dzm + 3 * PC;     // HT
  float* Dsum = lse + HT;        // HT
  float* partial = Dsum + HT;
  float* split = partial + colsum_scratch_floats(P, C);

  int rc = mhca_attention_impl(x1, ld1, x2, ld2, mask, R, T, C, H, dw, lnw, lnb, w, b,
                               eps, nrm, qkv, att, lse, stream);
  if (rc) return rc;

  GemmBatch gbat;
  gbat.g[0] = gemm_nn(g, ldg, w + 3 * CC, C, go, C, mask, (int)P, C, C);
  if ((rc = launch_gemm(gbat, 1, stream))) return rc;

  const float qscale = (float)(1.0 / sqrt((double)d));
  dim3 grid(ceil_div(T, 32), H, R);
  const size_t smem_dq = attn_bwd_dq_smem_bytes(d), smem_kv = attn_bwd_dkdv_smem_bytes(d);
  cudaFuncSetAttribute(attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_dq);
  cudaFuncSetAttribute(attn_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_kv);
  attn_bwd_dq_kernel<<<grid, 256, smem_dq, stream>>>(qkv, qkv + PC, qkv + 2 * PC, att, go,
                                                     lse, mask, T, C, H, qscale, dqkv, Dsum);
  UNAV_RETURN_IF_ERROR();
  attn_bwd_dkdv_kernel<<<grid, 256, smem_kv, stream>>>(qkv, qkv + PC, qkv + 2 * PC, go, lse,
                                                       Dsum, mask, T, C, H, dqkv + PC,
                                                       dqkv + 2 * PC);
  UNAV_RETURN_IF_ERROR();

  for (int i = 0; i < 3; ++i)
    gbat.g[i] = gemm_nn(dqkv + i * PC, C, w + i * CC, C, dy + i * PC, C, nullptr, (int)P, C, C);
  if ((rc = launch_gemm(gbat, 3, stream))) return rc;
  for (int i = 0; i < 3; ++i)
    gbat.g[i] = gemm_wgrad(dqkv + i * PC, C, nrm + i * PC, C, gw + i * CC, nullptr, C, C,
                           (int)P);
  gbat.g[3] = gemm_wgrad(g, ldg, att, C, gw + 3 * CC, mask, C, C, (int)P);
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
  return launch_colsum(cb, n, partial, stream);
}
