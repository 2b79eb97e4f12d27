// Whole stride-1 TransformerBlock forward for Hopper: the port of the Pallas
// kernel `_tblock_kernel` / `_tblock_compute`
// (unav_yolyolva_tpu/ops/pallas_tblock.py).
//
// The TPU kernel holds a batch block, the MHCA's attention and the MLP's
// (T, 4C) hidden in VMEM. On the H100 the block runs as eight launches of
// the repo's own kernels, each reading and writing device memory:
//   1. ln_pair_kernel: ln11 and ln12 of x in one pass (one warp per frame,
//      the same fp32 statistics serve both affines);
//   2-5. the MaskedMHCA forward of mhca.cuh (k/v from ln11, q from ln12);
//   6. residual_ln2_kernel: out = x * m + attn * mult_a, then ln2 of out;
//   7. fc1 with a bias + exact erf GELU epilogue;
//   8. fc2 with a bias, row-mask, mult_m and residual epilogue, adding into
//      out.
// Bound: operations; the MLP's two products are ~2/3 of the FLOPs at the
// stem shape. Every product runs in 3xTF32 on the tensor cores
// (gemm_tc.cuh; the MLP's through launch_gemm_tc_epi, whose epilogue is
// applied to the fragments before the store, so the (P, 4C) pre-activation
// is never written); the glue kernels are bytes-bound and read each
// activation once.
#pragma once

#include <type_traits>

#include "mhca.cuh"

// One warp's frame of C values, CPL per lane (zero beyond C): subtracts the
// mean from y in place and returns 1 / sqrt(var + eps), the fp32 statistics
// of the LayerNorms in mhca.cuh.
template <int CPL>
__device__ __forceinline__ float warp_ln_center(float (&y)[CPL], int lane, int C, float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) s += y[i];
  const float mean = warp_sum(s) / C;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (lane + 32 * i < C) {
      y[i] -= mean;
      v += y[i] * y[i];
    }
  }
  return rsqrtf(warp_sum(v) / C + eps);
}

// channels per lane of the one-warp-per-frame kernels (C <= 1024)
static int lanes_cpl(int C) {
  int cpl = 1;
  while (32 * cpl < C) cpl *= 2;
  return cpl;
}

// Calls launch(std::integral_constant<int, CPL>{}) for the CPL of C.
template <class F>
static int with_cpl(int C, F launch) {
  switch (lanes_cpl(C)) {
    case 1: launch(std::integral_constant<int, 1>{}); break;
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    case 8: launch(std::integral_constant<int, 8>{}); break;
    case 16: launch(std::integral_constant<int, 16>{}); break;
    case 32: launch(std::integral_constant<int, 32>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ln11 and ln12 of the (P, C) rows of x: h1 = LN(x) * lnw3[0] + lnb3[0],
// h2 = LN(x) * lnw3[1] + lnb3[1], one set of fp32 statistics for both.
template <int CPL>
__global__ void __launch_bounds__(256) ln_pair_kernel(
    const float* __restrict__ x, long P, int C, const float* __restrict__ lnw3,
    const float* __restrict__ lnb3, float eps, float* __restrict__ h1,
    float* __restrict__ h2) {
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
      h1[row * C + c] = yh * lnw3[c] + lnb3[c];
      h2[row * C + c] = yh * lnw3[C + c] + lnb3[C + c];
    }
  }
}

// res = x * m + a * mult_a[sequence], then h = LN(res) * lnw + lnb, one warp
// per frame. res may alias a (the forward adds in place).
template <int CPL>
__global__ void __launch_bounds__(256) residual_ln2_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ mult_a, const float* a, long P, int T, int C,
    const float* __restrict__ lnw, const float* __restrict__ lnb, float eps, float* res,
    float* __restrict__ h) {
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
      y[i] = x[row * C + c] * mval + a[row * C + c] * ma[c];
      res[row * C + c] = y[i];
    }
  }
  const float inv = warp_ln_center(y, lane, C, eps);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) h[row * C + c] = y[i] * inv * lnw[c] + lnb[c];
  }
}

static int launch_ln_pair(const float* x, long P, int C, const float* lnw3, const float* lnb3,
                          float eps, float* h1, float* h2, cudaStream_t stream) {
  return with_cpl(C, [&](auto cpl) {
    ln_pair_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, stream>>>(
        x, P, C, lnw3, lnb3, eps, h1, h2);
  });
}

static int launch_residual_ln2(const float* x, const unsigned char* mask, const float* mult_a,
                               const float* a, long P, int T, int C, const float* lnw,
                               const float* lnb, float eps, float* res, float* h,
                               cudaStream_t stream) {
  return with_cpl(C, [&](auto cpl) {
    residual_ln2_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, stream>>>(
        x, mask, mult_a, a, P, T, C, lnw, lnb, eps, res, h);
  });
}

// The packed weights of one block (TransformerBlock.packed_weights()).
struct TBlockWeights {
  const float *lnw3, *lnb3;               // (3, C): ln11, ln12, ln2
  const float *dw, *lnw, *lnb, *w, *b;    // the MHCA (mhca.cuh layout)
  const float *w1, *b1, *w2, *b2;         // (Hd, C), (Hd), (C, Hd), (C)
};

// fc1: hid = h W1^T + b1, (P, Hd), before the activation
static GemmArgs tblock_fc1(const TBlockWeights& W, const float* h, float* hid, long P, int C,
                           int Hd) {
  return gemm_args(h, C, W.w1, C, hid, Hd, W.b1, nullptr, 1.f, (int)P, Hd, C);
}

static long tblock_forward_scratch_floats(int R, int T, int C, int Hd) {
  const long P = (long)R * T, PC = P * C;
  return std::max(6 * PC, PC + P * Hd);
}

// The block's forward of x (R*T, C) with the (R*T) mask and (R, C) branch
// multipliers into out (R*T, C). scratch: tblock_forward_scratch_floats.
static int tblock_forward_impl(const float* x, const unsigned char* mask, int R, int T, int C,
                               int Hd, int H, const float* mult_a, const float* mult_m,
                               const TBlockWeights& W, float eps, float* out, float* scratch,
                               cudaStream_t stream) {
  const long P = (long)R * T, PC = P * C;
  // ln11 / ln12 go into the MHCA's q/k/v region: only its first launch
  // reads them, and its second overwrites them (stream order)
  float* h1 = scratch + 3 * PC;
  float* h2 = h1 + PC;
  int rc = launch_ln_pair(x, P, C, W.lnw3, W.lnb3, eps, h1, h2, stream);
  if (rc) return rc;
  rc = mhca_forward_impl(h1, C, h2, C, mask, R, T, C, H, W.dw, W.lnw, W.lnb, W.w, W.b, eps,
                         out, C, scratch, stream);
  if (rc) return rc;
  float* h = scratch;           // ln2 output
  float* hid = scratch + PC;    // (P, Hd) GELU(fc1)
  rc = launch_residual_ln2(x, mask, mult_a, out, P, T, C, W.lnw3 + 2L * C, W.lnb3 + 2L * C,
                           eps, out, h, stream);
  if (rc) return rc;
  rc = launch_gemm_tc_epi(tblock_fc1(W, h, hid, P, C, Hd), GemmEpi{GEMM_ACT_GELU}, stream);
  if (rc) return rc;
  GemmArgs fc2 = gemm_args(hid, Hd, W.w2, Hd, out, C, W.b2, mask, 1.f, (int)P, C, Hd);
  fc2.beta = 1;
  rc = launch_gemm_tc_epi(fc2, GemmEpi{GEMM_ACT_NONE, nullptr, 0, mult_m, T}, stream);
  return rc;
}
