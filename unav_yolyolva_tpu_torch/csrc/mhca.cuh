// MaskedMHCA forward for Hopper: the port of the Pallas kernel
// `_mhca_kernel` / `_mhca_compute` (unav_yolyolva_tpu/ops/pallas_fusion.py).
//
// The TPU kernel holds a whole batch block, weights and the (R, T, T)
// attention in VMEM. On the H100 a block has at most 227 KB of shared
// memory, so the block is split into four launches:
//   1. dwconv_ln_kernel: for q (from x2), k and v (from x1) the depthwise
//      k=3 conv, the output mask and the channel LayerNorm (fp32 stats),
//      one warp per frame;
//   2. one batched product for the q/k/v dense layers (gemm_tc.cuh); the
//      epilogue adds the bias, scales q by 1/sqrt(d) and masks v;
//   3. attn_tc_kernel: one block per (row, head, 64-query tile); that
//      tile's logits against all T keys stay in shared memory, keys and
//      values stream through a cp.async ring in tiles of 32, each split
//      once into TF32 (hi, lo) pairs; masked keys get -FLT_MAX and a row
//      without a valid key writes exactly 0;
//   4. the proj product with a row-mask epilogue, into a strided output.
// Bound: operations. The q/k/v/proj products are ~80% of the FLOPs at
// C=512, T=224 and the attention's two products most of the rest; all of
// them run in 3xTF32 on the tensor cores (gemm_tc.cuh: fp32-accurate, up to
// 165 TFLOP/s against the 67 of FFMA). The softmax stays fp32 FFMA.
#pragma once

#include "gemm.cuh"

constexpr int ATT_QT = 64;      // queries per attention block (4 warps of 16 rows, twice)
constexpr int ATT_KT = 32;      // keys per key / value tile of the ring
constexpr int ATT_STAGES = 3;   // tiles in flight
constexpr int ATT_MAX_D = 128;  // head width the attention kernels hold

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

// grid (ceil(T / 64), H, R), 256 threads; DP is the head width d rounded up
// to 16, 32, 64 or 128 (the dims past d are zero-filled). The split of an
// operand into TF32 hi and lo costs more issue slots than its three mma, so
// each value is split once: the 64-query tile into registers (each warp's
// A fragments), each key or value tile, when it lands, into (hi, lo) pairs
// in shared memory that every warp reads; only exp(s - max) is split as it is
// read.
// Shared memory: the query tile (64 x DP+4), which the split tile (32 x
// 2DP+8: conflict-free pair reads) reuses once the queries are in
// registers; a ring of ATT_STAGES raw key or value tiles (32 x DP+4); the
// tile's logits against all T keys (64 x T32+4, T32 = T rounded up to 32),
// then their exp(s - max), and three floats a query row (each key half's
// max, 1 / the sum). The row max is taken as the logits are written, the
// exponentials in one pass, and the output is divided by the sum at the
// end: the softmax costs one pass over the logits, not three (it took
// ~30% of the kernel). The ring streams the key tiles, then the value
// tiles, so the first value tiles load while the softmax runs. Warp w owns query rows 16 (w % 4) ..
// +16 and, in the logits, keys 16 (w / 4) .. +16 of each key tile, in P.V
// the head dims (w / 4) DP/2 .. +DP/2.
template <int DP>
__global__ void __launch_bounds__(256, DP <= 64 ? 2 : 1) attn_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    int T, int C, int H, float* __restrict__ out, float* __restrict__ lse) {
  constexpr int RS = DP + 4, HL = 2 * DP + 8, CH = DP / 4, SLOT = ATT_KT * RS;
  constexpr int PNI = DP / 16;   // n8 tiles of a warp's half of the head dims
  extern __shared__ __align__(16) float att_smem[];
  const int d = C / H, T32 = (T + ATT_KT - 1) / ATT_KT * ATT_KT, SP = T32 + 4,
            nkt = T32 / ATT_KT;
  float* Qs = att_smem;                    // ATT_QT x RS, then the split tile
  float* split = att_smem;                 // ATT_KT x HL (hi, lo) pairs
  float* ring = att_smem + ATT_QT * RS;    // ATT_STAGES x SLOT
  float* S = ring + ATT_STAGES * SLOT;     // ATT_QT x SP
  float* rowmax = S + ATT_QT * SP;         // 2 x ATT_QT: each key half's row max
  float* rowinv = rowmax + 2 * ATT_QT;     // ATT_QT: 1 / the row's sum of exp
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned char* mrow = mask + (long)r * T;
  const long base = (long)r * T * C + (long)h * d;

  int any = 0;
  for (int i = tid; i < T; i += 256) any |= mrow[i];
  if (!__syncthreads_or(any)) {
    // no valid key in this row: the reference's output is exactly 0
    for (int e = tid; e < ATT_QT * d; e += 256) {
      const int i = e / d, dd = e - i * d;
      if (q0 + i < T) out[base + (long)(q0 + i) * C + dd] = 0.f;
    }
    if (lse && tid < ATT_QT && q0 + tid < T) lse[((long)r * H + h) * T + q0 + tid] = 0.f;
    return;
  }

  // ring tile i: keys of key tile i (i < nkt), else values of tile i - nkt
  auto load_tile = [&](int i) {
    const bool isv = i >= nkt;
    const int key0 = (isv ? i - nkt : i) * ATT_KT;
    const float* src = isv ? v : k;
    float* dst = ring + (i % ATT_STAGES) * SLOT;
    for (int e = tid; e < ATT_KT * CH; e += 256) {
      const int row = e / CH, c = (e - row * CH) * 4, key = key0 + row;
      const bool ok = key < T && c < d;
      cp_async16(dst + row * RS + c, ok ? src + base + (long)key * C + c : src, ok);
    }
  };
  // one pipeline step: tile i landed, the next one requested, tile i split
  auto advance = [&](int i) {
    if (i + ATT_STAGES - 1 < 2 * nkt) load_tile(i + ATT_STAGES - 1);
    cp_async_commit();
    const float* raw = ring + (i % ATT_STAGES) * SLOT;
    for (int e = tid; e < ATT_KT * DP; e += 256) {
      const int row = e / DP, c = e - row * DP;
      store_split(split + row * HL + 2 * c, raw[row * RS + c]);
    }
  };
  for (int e = tid; e < ATT_QT * CH; e += 256) {
    const int row = e / CH, c = (e - row * CH) * 4;
    const bool ok = q0 + row < T && c < d;
    cp_async16(Qs + row * RS + c, ok ? q + base + (long)(q0 + row) * C + c : q, ok);
  }
#pragma unroll
  for (int s = 0; s < ATT_STAGES - 1; ++s) {
    if (s < 2 * nkt) load_tile(s);
    cp_async_commit();
  }

  const int wr = (warp & 3) * 16, wh = warp >> 2;
  {
    float rmax[2] = {-FLT_MAX, -FLT_MAX};   // rows g and g+8, over this lane's keys
    // logits: the warp's 16 queries against 16 keys of each tile, summed
    // over the head dims in 32-deep slices
    FragA qf[DP / 8];
    for (int i = 0; i < nkt; ++i) {
      cp_async_wait<ATT_STAGES - 2>();
      __syncthreads();   // tile i (and the queries) landed; the split tile is free
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < DP; kk += 8) qf[kk / 8] = load_frag_a(Qs + (wr + g) * RS + kk + t4, RS);
        __syncthreads();   // the split tile reuses the queries' space
      }
      advance(i);
      __syncthreads();
      float s[2][4] = {};
#pragma unroll
      for (int c0 = 0; c0 < DP; c0 += 32) {
        float part[2][4] = {};
#pragma unroll
        for (int kk = c0; kk < c0 + 32 && kk < DP; kk += 8)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_3xtf32(part[j], qf[kk / 8],
                       load_frag_b_split(split + (wh * 16 + j * 8 + g) * HL + 2 * (kk + t4), 8));
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = i * ATT_KT + wh * 16 + j * 8 + 2 * t4;
        const bool ok0 = key < T && mrow[key], ok1 = key + 1 < T && mrow[key + 1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v0 = ok0 ? s[j][2 * hh] : -FLT_MAX, v1 = ok1 ? s[j][2 * hh + 1] : -FLT_MAX;
          *reinterpret_cast<float2*>(S + (wr + g + 8 * hh) * SP + key) = make_float2(v0, v1);
          rmax[hh] = fmaxf(rmax[hh], fmaxf(v0, v1));
        }
      }
    }
    // the row max over the warp's half of the keys: the four lanes of a row
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 1));
      rmax[hh] = fmaxf(rmax[hh], __shfl_xor_sync(0xffffffffu, rmax[hh], 2));
      if (t4 == 0) rowmax[wh * ATT_QT + wr + g + 8 * hh] = rmax[hh];
    }
  }

  float o[PNI][4];
#pragma unroll
  for (int j = 0; j < PNI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int i = nkt; i < 2 * nkt; ++i) {
    cp_async_wait<ATT_STAGES - 2>();
    __syncthreads();   // value tile landed; every logit written; the split tile is free
    advance(i);
    if (i == nkt) {
      // softmax numerators exp(s - max) in one pass over each query row
      // (masked and padding keys hold -FLT_MAX and get exactly 0); the
      // division by the row's sum waits for the output. Warp w owns rows
      // 8w .. 8w+7.
      for (int rr = 0; rr < ATT_QT / 8; ++rr) {
        const int row = warp * (ATT_QT / 8) + rr;
        float* srow = S + row * SP;
        const float mx = fmaxf(rowmax[row], rowmax[ATT_QT + row]);
        float sum = 0.f;
        for (int j = lane; j < T32; j += 32) {
          const float e = expf(srow[j] - mx);
          srow[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) rowinv[row] = 1.f / sum;
        if (lse && lane == 0 && q0 + row < T) lse[((long)r * H + h) * T + q0 + row] = mx + logf(sum);
      }
    }
    __syncthreads();
    // exp(s - max).V over the 32 keys of value tile i - nkt, one summed slice
    const int key0 = (i - nkt) * ATT_KT;
    float part[PNI][4] = {};
#pragma unroll
    for (int kk = 0; kk < ATT_KT; kk += 8) {
      const FragA a = load_frag_a(S + (wr + g) * SP + key0 + kk + t4, SP);
#pragma unroll
      for (int j = 0; j < PNI; ++j)
        mma_3xtf32(part[j], a,
                   load_frag_b_split(split + (kk + t4) * HL + 2 * (wh * (DP / 2) + j * 8 + g),
                                     4 * HL));
    }
#pragma unroll
    for (int j = 0; j < PNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] += part[j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qrow = q0 + wr + g + 8 * hh;
    if (qrow >= T) continue;
    float* orow = out + base + (long)qrow * C;
    const float inv = rowinv[wr + g + 8 * hh];
#pragma unroll
    for (int j = 0; j < PNI; ++j) {
      const int dd = wh * (DP / 2) + j * 8 + 2 * t4;   // d is a multiple of 4
      if (dd < d)
        *reinterpret_cast<float2*>(orow + dd) = make_float2(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
    }
  }
}

template <int DP>
static int launch_attn_tc(const float* q, const float* k, const float* v,
                          const unsigned char* mask, int R, int T, int C, int H, float* out,
                          float* lse, cudaStream_t stream) {
  const int T32 = ceil_div(T, ATT_KT) * ATT_KT;
  const size_t smem = sizeof(float) * ((size_t)(ATT_QT + ATT_STAGES * ATT_KT) * (DP + 4) +
                                       (size_t)ATT_QT * (T32 + 4 + 3));
  static int limit = 0;
  raise_smem_limit((const void*)attn_tc_kernel<DP>, (int)smem, limit);
  const dim3 grid(ceil_div(T, ATT_QT), H, R);
  attn_tc_kernel<DP><<<grid, 256, smem, stream>>>(q, k, v, mask, T, C, H, out, lse);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// the attention of launch 3: q (scaled), k, v, out (R*T, C), lse optional
static int launch_attn(const float* q, const float* k, const float* v,
                       const unsigned char* mask, int R, int T, int C, int H, float* out,
                       float* lse, cudaStream_t stream) {
  const int d = C / H;
  if (d % 4 || C % 4) return (int)cudaErrorMisalignedAddress;
  if (d <= 16) return launch_attn_tc<16>(q, k, v, mask, R, T, C, H, out, lse, stream);
  if (d <= 32) return launch_attn_tc<32>(q, k, v, mask, R, T, C, H, out, lse, stream);
  if (d <= 64) return launch_attn_tc<64>(q, k, v, mask, R, T, C, H, out, lse, stream);
  if (d <= ATT_MAX_D) return launch_attn_tc<128>(q, k, v, mask, R, T, C, H, out, lse, stream);
  return (int)cudaErrorInvalidValue;
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

  rc = launch_attn(qkv, qkv + PC, qkv + 2 * PC, mask, R, T, C, H, att, lse, stream);
  return rc;
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
  rc = launch_gemm(proj, 1, stream);
  return rc;
}
