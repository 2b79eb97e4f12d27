// MaskedMHCA forward for Hopper: the port of the Pallas kernel
// `_mhca_kernel` / `_mhca_compute` (unav_yolyolva_tpu/ops/pallas_fusion.py).
//
// The TPU kernel holds a whole batch block, weights and the (R, T, T)
// attention in VMEM. On the H100 a block has at most 227 KB of shared
// memory, less than one head's fp32 224x224 logits plus K and V, so the
// block is split into four launches:
//   1. dwconv_ln_kernel: for q (from x2), k and v (from x1) the depthwise
//      k=3 conv, the output mask and the channel LayerNorm (fp32 stats),
//      one warp per frame;
//   2. one grouped GEMM for the q/k/v dense layers; the epilogue adds the
//      bias, scales q by 1/sqrt(d) and masks v;
//   3. attn_kernel: one block per (row, head, 32-query tile); that tile's
//      logits against all T keys stay in shared memory (32 x T x 4 B),
//      keys and values stream through in tiles of 32; masked keys get
//      -FLT_MAX and a row without a valid key writes exactly 0;
//   4. the proj GEMM with a row-mask epilogue, into a strided output.
// Bound: operations (the q/k/v/proj products are ~80% of the FLOPs at
// C=512, T=224), so the GEMM decides the time.
#pragma once

#include "gemm.cuh"

constexpr int ATT_Q = 32;       // queries per attention block
constexpr int ATT_MAX_D = 128;  // head width the attention kernel holds

template <int CPL>  // channels per lane: C <= 32 * CPL
__global__ void __launch_bounds__(256) dwconv_ln_kernel(
    const float* __restrict__ x1, long ld1, const float* __restrict__ x2, long ld2,
    const unsigned char* __restrict__ mask, long P, int T, int C,
    const float* __restrict__ dw, const float* __restrict__ lnw,
    const float* __restrict__ lnb, float eps, float* __restrict__ out) {
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
    float* o = out + (long)which * P * C + row * C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) o[c] = y[i] * inv * lnw[which * C + c] + lnb[which * C + c];
    }
  }
}

__global__ void __launch_bounds__(256) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    int T, int C, int H, float* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ float sm[];
  const int d = C / H, dp = d + 1, Tp = T + 1;
  float* Qs = sm;                 // ATT_Q x dp
  float* KV = Qs + ATT_Q * dp;    // 32 x dp
  float* S = KV + 32 * dp;        // ATT_Q x Tp
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_Q;
  const int tid = threadIdx.x;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;
  const int qi = tid >> 3, g8 = tid & 7;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    // no valid key in this row: the reference's output is exactly 0
    for (int j = g8; j < d; j += 8)
      if (q0 + qi < T) out[base + (long)(q0 + qi) * C + j] = 0.f;
    if (lse && g8 == 0 && q0 + qi < T) lse[((long)r * H + h) * T + q0 + qi] = 0.f;
    return;
  }

  for (int e = tid; e < ATT_Q * d; e += 256) {
    const int i = e / d, dd = e - i * d;
    Qs[i * dp + dd] = q0 + i < T ? q[base + (long)(q0 + i) * C + dd] : 0.f;
  }
  // logits: thread (qi, g8) owns keys g8, g8 + 8, g8 + 16, g8 + 24 of a tile
  for (int k0 = 0; k0 < T; k0 += 32) {
    __syncthreads();
    for (int e = tid; e < 32 * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      KV[i * dp + dd] = k0 + i < T ? k[base + (long)(k0 + i) * C + dd] : 0.f;
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int dd = 0; dd < d; ++dd) {
      const float qv = Qs[qi * dp + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(qv, KV[(g8 + 8 * j) * dp + dd], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + g8 + 8 * j;
      if (key < T) S[qi * Tp + key] = mrow[key] ? acc[j] : -FLT_MAX;
    }
  }
  __syncthreads();
  // softmax over each query row: warp w owns rows 4w .. 4w+3
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = 0; i < ATT_Q / 8; ++i) {
    float* s = S + (warp * (ATT_Q / 8) + i) * Tp;
    float mx = -FLT_MAX;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) s[j] = s[j] / sum;
    const int qrow = q0 + warp * (ATT_Q / 8) + i;
    if (lse && lane == 0 && qrow < T) lse[((long)r * H + h) * T + qrow] = mx + logf(sum);
  }
  // P.V: thread (qi, g8) owns output dims g8, g8 + 8, ...
  float o[ATT_MAX_D / 8];
#pragma unroll
  for (int j = 0; j < ATT_MAX_D / 8; ++j) o[j] = 0.f;
  for (int k0 = 0; k0 < T; k0 += 32) {
    __syncthreads();
    for (int e = tid; e < 32 * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      KV[i * dp + dd] = k0 + i < T ? v[base + (long)(k0 + i) * C + dd] : 0.f;
    }
    __syncthreads();
    const int kn = min(32, T - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float pv = S[qi * Tp + k0 + kk];
#pragma unroll
      for (int j = 0; j < ATT_MAX_D / 8; ++j) {
        const int dd = g8 + 8 * j;
        if (dd < d) o[j] = fmaf(pv, KV[kk * dp + dd], o[j]);
      }
    }
  }
  if (q0 + qi < T) {
    float* orow = out + base + (long)(q0 + qi) * C;
#pragma unroll
    for (int j = 0; j < ATT_MAX_D / 8; ++j) {
      const int dd = g8 + 8 * j;
      if (dd < d) orow[dd] = o[j];
    }
  }
}

static size_t attn_smem_bytes(int T, int d) {
  return sizeof(float) * ((size_t)(ATT_Q + 32) * (d + 1) + (size_t)ATT_Q * (T + 1));
}

// Launches 1-3 of the forward: nrm (3 x P x C) gets the normalized q/k/v
// inputs, qkv (3 x P x C) the projections (q scaled by 1/sqrt(d), v masked),
// att (P x C) the attention output; lse (R x H x T) is optional.
static int mhca_attention_impl(const float* x1, long ld1, const float* x2, long ld2,
                               const unsigned char* mask, int R, int T, int C, int H,
                               const float* dw, const float* lnw, const float* lnb,
                               const float* w, const float* b, float eps, float* nrm,
                               float* qkv, float* att, float* lse, cudaStream_t stream) {
  const long P = (long)R * T, PC = P * C;
  const int d = C / H;

  const int blocks = ceil_div(P, 8);  // 8 warps, one frame each
  int cpl = 1;
  while (32 * cpl < C) cpl *= 2;
  switch (cpl) {
#define UNAV_LN_CASE(n) case n: dwconv_ln_kernel<n><<<blocks, 256, 0, stream>>>( \
      x1, ld1, x2, ld2, mask, P, T, C, dw, lnw, lnb, eps, nrm); break;
    UNAV_LN_CASE(1) UNAV_LN_CASE(2) UNAV_LN_CASE(4) UNAV_LN_CASE(8)
    UNAV_LN_CASE(16) UNAV_LN_CASE(32)
#undef UNAV_LN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  UNAV_RETURN_IF_ERROR();

  const float qscale = (float)(1.0 / sqrt((double)d));
  GemmBatch qkv_batch;
  for (int i = 0; i < 3; ++i)
    qkv_batch.g[i] = gemm_args(nrm + i * PC, C, w + (long)i * C * C, C, qkv + i * PC, C,
                               b + (long)i * C, i == 2 ? mask : nullptr,
                               i == 0 ? qscale : 1.f, (int)P, C, C);
  int rc = launch_gemm(qkv_batch, 3, stream);
  if (rc) return rc;

  const size_t smem = attn_smem_bytes(T, d);
  cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(ceil_div(T, ATT_Q), H, R);
  attn_kernel<<<grid, 256, smem, stream>>>(qkv, qkv + PC, qkv + 2 * PC, mask, T, C, H, att,
                                           lse);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// One MaskedMHCA forward. x1 (k/v source) and x2 (q source) are (R*T, C)
// with row strides ld1/ld2; out has row stride ldo. Weights: dw (3, C, 3)
// [q/k/v, channel, tap], lnw/lnb (3, C), w (4, C, C) [q/k/v/proj, out, in],
// b (4, C). scratch holds 6 * R * T * C floats.
static int mhca_forward_impl(const float* x1, long ld1, const float* x2, long ld2,
                             const unsigned char* mask, int R, int T, int C, int H,
                             const float* dw, const float* lnw, const float* lnb,
                             const float* w, const float* b, float eps,
                             float* out, long ldo, float* scratch, cudaStream_t stream) {
  const long P = (long)R * T, PC = P * C;
  float* nrm = scratch;            // normalized q/k/v, later the attention output
  float* qkv = scratch + 3 * PC;   // projected q/k/v
  int rc = mhca_attention_impl(x1, ld1, x2, ld2, mask, R, T, C, H, dw, lnw, lnb, w, b,
                               eps, nrm, qkv, nrm, nullptr, stream);
  if (rc) return rc;
  GemmBatch proj;
  proj.g[0] = gemm_args(nrm, C, w + 3L * C * C, C, out, ldo, b + 3L * C, mask, 1.f,
                        (int)P, C, C);
  return launch_gemm(proj, 1, stream);
}
