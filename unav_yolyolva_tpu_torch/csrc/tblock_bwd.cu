// Whole stride-1 TransformerBlock backward for Hopper: the port of the Pallas
// kernel `_tblock_bwd_kernel` / `_tblock_diff_bwd`
// (unav_yolyolva_tpu/ops/pallas_tblock.py). Like the TPU kernel it saves
// nothing from the forward: it recomputes the block from x, the multipliers
// and the weights (keeping the intermediates the backward reads), then
// walks the chain in reverse:
//   y = fc2(GELU(u)) with u = fc1(h): gy = g * mult_m * m, and
//     d(mult_m) = sum_t g * y * m (seq_dot_kernel);
//   du = (gy W2) * GELU'(u) (A.B with the GELU' epilogue); dh = du W1;
//     dW2 = gy^T GELU(u), dW1 = du^T h (split-K A^T.B, one launch);
//   ln2 backward: dout = g + LN2'(dh) (ln2_bwd_kernel);
//   d(mult_a) = sum_t dout * attn, and the MHCA's upstream grad dout *
//     mult_a (seq_dot_kernel);
//   the MHCA backward of mhca_bwd.cuh from the intermediates the
//     recompute kept (mhca_recompute: the MHCA forward runs once);
//   ln11 / ln12 backward: dx = dout * m + LN11'(dh1) + LN12'(dh2)
//     (ln_pair_bwd_kernel);
//   one batched column-sum launch for b1, b2 and the three LN affines.
// Every weight and multiplier grad is a fixed-order reduction, no float
// atomics: two runs give the same bits. Bound: operations (recompute +
// twice the products). Every product runs in 3xTF32 on the tensor cores
// (gemm_tc.cuh, and the MHCA's attention backward): the recompute's fc1
// writes u and GELU(u) in one launch, from the fragments of the forward's
// fc1, and du's GELU' is applied in the product's epilogue.
#include "mhca_bwd.cuh"
#include "tblock.cuh"

// Per-sequence column sums, grid (ceil(C / 32), R), block (32, 8):
//   out[r, c] = sum_t A[r, t, c] * B[r, t, c] * m[r, t]   (m = 1 without mask)
// and, with scaled, scaled[r, t, c] = A[r, t, c] * mult[r, c] * m[r, t].
// The 8 row lanes' partials are added in order: the sums are deterministic.
__global__ void __launch_bounds__(256) seq_dot_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const unsigned char* __restrict__ mask, const float* __restrict__ mult, int T, int C,
    float* __restrict__ out, float* __restrict__ scaled) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x, r = blockIdx.y;
  float s = 0.f;
  if (c < C) {
    const float mu = mult[(long)r * C + c];
    for (int t = threadIdx.y; t < T; t += 8) {
      const long row = (long)r * T + t;
      const float mv = mask ? (mask[row] ? 1.f : 0.f) : 1.f;
      const float a = A[row * C + c];
      s += a * B[row * C + c] * mv;
      if (scaled) scaled[row * C + c] = a * mu * mv;
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    out[(long)r * C + c] = tot;
  }
}

// ln2 backward, one warp per frame: recomputes the statistics of res, then
// dout = g + inv * (dh w - mean(dh w) - yhat mean(dh w yhat)); writes yhat.
template <int CPL>
__global__ void __launch_bounds__(256) ln2_bwd_kernel(
    const float* __restrict__ res, const float* __restrict__ dh, const float* __restrict__ lnw,
    const float* __restrict__ g, long P, int C, float eps, float* __restrict__ dout,
    float* __restrict__ yhat) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const long off = row * C;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) y[i] = lane + 32 * i < C ? res[off + lane + 32 * i] : 0.f;
  const float inv = warp_ln_center(y, lane, C, eps);
  float dyh[CPL];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    dyh[i] = 0.f;
    if (c < C) {
      y[i] *= inv;
      dyh[i] = dh[off + c] * lnw[c];
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
      dout[off + c] = g[off + c] + inv * (dyh[i] - s1 - y[i] * s2);
    }
  }
}

// ln11 / ln12 backward, one warp per frame: both normalize the same x, so
// one set of statistics; dx = dout * m + LN'(dh1; lnw3[0]) + LN'(dh2;
// lnw3[1]). Writes yhat (shared by both affine grads).
template <int CPL>
__global__ void __launch_bounds__(256) ln_pair_bwd_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ lnw3, const float* __restrict__ dh1,
    const float* __restrict__ dh2, const float* __restrict__ dout, long P, int C, float eps,
    float* __restrict__ dx, float* __restrict__ yhat) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const long off = row * C;
  const float mval = mask[row] ? 1.f : 0.f;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) y[i] = lane + 32 * i < C ? x[off + lane + 32 * i] : 0.f;
  const float inv = warp_ln_center(y, lane, C, eps);
  float d1[CPL], d2[CPL];
  float s11 = 0.f, s12 = 0.f, s21 = 0.f, s22 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    d1[i] = d2[i] = 0.f;
    if (c < C) {
      y[i] *= inv;
      d1[i] = dh1[off + c] * lnw3[c];
      d2[i] = dh2[off + c] * lnw3[C + c];
      s11 += d1[i];
      s12 += d1[i] * y[i];
      s21 += d2[i];
      s22 += d2[i] * y[i];
    }
  }
  s11 = warp_sum(s11) / C;
  s12 = warp_sum(s12) / C;
  s21 = warp_sum(s21) / C;
  s22 = warp_sum(s22) / C;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      yhat[off + c] = y[i];
      dx[off + c] = dout[off + c] * mval + inv * (d1[i] - s11 - y[i] * s12) +
                    inv * (d2[i] - s21 - y[i] * s22);
    }
  }
}

// The scratch layout of one backward (floats).
struct TBlockBwdScratch {
  float *h1, *h2, *a, *res, *h, *u, *z, *y, *gy, *du, *dh, *dout, *yhat2, *gmh, *dh1, *dh2,
      *yhat1, *saved, *mhca, *partial, *split;
  long split_floats, total;
};

static TBlockBwdScratch tblock_bwd_layout(float* base, int R, int T, int C, int Hd, int H) {
  const long P = (long)R * T, PC = P * C, PH = P * Hd;
  TBlockBwdScratch s;
  long off = 0;  // base may be nullptr: only the total is wanted then
  // every part starts on 16 bytes: the tensor-core products' ring copies
  auto take = [base, &off](long n) {
    float* q = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return q;
  };
  s.h1 = take(PC); s.h2 = take(PC); s.a = take(PC); s.res = take(PC);
  s.h = take(PC); s.u = take(PH); s.z = take(PH); s.y = take(PC); s.gy = take(PC);
  s.du = take(PH); s.dh = take(PC); s.dout = take(PC); s.yhat2 = take(PC); s.gmh = take(PC);
  s.dh1 = take(PC); s.dh2 = take(PC); s.yhat1 = take(PC);
  s.saved = take(mhca_saved_floats(R, T, C, H));
  s.mhca = take(mhca_backward_work_floats(R, T, C, H));
  s.partial = take(colsum_scratch_floats(P, std::max(C, Hd)));
  s.split_floats = 2L * GEMM_MAX_SPLITS * C * Hd;
  s.split = take(s.split_floats);
  s.total = off;
  return s;
}

extern "C" long unav_tblock_backward_scratch(int R, int T, int C, int Hd, int heads) {
  return tblock_bwd_layout(nullptr, R, T, C, Hd, heads).total;
}

// The grads of one block forward for the upstream grad g (R*T, C): dx
// (R*T, C), d(mult_a) / d(mult_m) (R, C), and the eleven weight grads in
// the weights' layouts. scratch: unav_tblock_backward_scratch floats.
extern "C" int unav_tblock_backward(const float* x, const unsigned char* mask, int R, int T, int C,
                                    int Hd, int H, const float* mult_a, const float* mult_m,
                                    const float* lnw3, const float* lnb3, const float* dw,
                                    const float* lnw, const float* lnb, const float* w,
                                    const float* b, const float* w1, const float* b1,
                                    const float* w2, const float* b2, float eps, const float* g,
                                    float* dx, float* dma, float* dmm, float* glnw3,
                                    float* glnb3, float* gdw, float* glnw, float* glnb,
                                    float* gw, float* gb, float* gw1, float* gb1, float* gw2,
                                    float* gb2, float* scratch, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const TBlockWeights W{lnw3, lnb3, dw, lnw, lnb, w, b, w1, b1, w2, b2};
  const long P = (long)R * T;
  const TBlockBwdScratch s = tblock_bwd_layout(scratch, R, T, C, Hd, H);
  const int rows = ceil_div(P, 8);   // blocks of the one-warp-per-frame kernels

  // ---- recompute: ln11 / ln12, MHCA, residual + ln2, fc1 + GELU, fc2 -----
  int rc = launch_ln_pair(x, P, C, lnw3, lnb3, eps, s.h1, s.h2, stream);
  if (rc) return rc;
  const MhcaSaved sv = mhca_saved(s.saved, R, T, C);
  rc = mhca_recompute(s.h1, C, s.h2, C, mask, R, T, C, H, dw, lnw, lnb, w, b, eps, sv, s.a, C,
                      stream);
  if (rc) return rc;
  rc = launch_residual_ln2(x, mask, mult_a, s.a, P, T, C, lnw3 + 2L * C, lnb3 + 2L * C, eps,
                           s.res, s.h, stream);
  if (rc) return rc;
  // z = GELU(u), u kept for GELU'
  rc = launch_gemm_tc_epi(tblock_fc1(W, s.h, s.z, P, C, Hd),
                          GemmEpi{GEMM_ACT_GELU, nullptr, 0, nullptr, 0, s.u, Hd}, stream);
  if (rc) return rc;
  GemmBatch prod;
  prod.g[0] = gemm_args(s.z, Hd, w2, Hd, s.y, C, b2, nullptr, 1.f, (int)P, C, Hd);
  if ((rc = launch_gemm(prod, 1, stream))) return rc;

  // ---- the MLP branch in reverse -----------------------------------------
  const dim3 sgrid(ceil_div(C, 32), R), sblock(32, 8);
  seq_dot_kernel<<<sgrid, sblock, 0, stream>>>(g, s.y, mask, mult_m, T, C, dmm, s.gy);
  UNAV_RETURN_IF_ERROR();
  rc = launch_gemm_tc_epi(gemm_nn(s.gy, C, w2, Hd, s.du, Hd, nullptr, (int)P, Hd, C),
                          GemmEpi{GEMM_ACT_GELU_GRAD, s.u, Hd}, stream);
  if (rc) return rc;
  prod.g[0] = gemm_nn(s.du, Hd, w1, C, s.dh, C, nullptr, (int)P, C, Hd);
  prod.g[1] = gemm_wgrad(s.gy, C, s.z, Hd, gw2, nullptr, C, Hd, (int)P);
  prod.g[2] = gemm_wgrad(s.du, Hd, s.h, C, gw1, nullptr, Hd, C, (int)P);
  if ((rc = launch_gemm(prod, 3, stream, s.split, s.split_floats))) return rc;

  // ---- ln2, the residual and the attention branch ------------------------
  rc = with_cpl(C, [&](auto cpl) {
    ln2_bwd_kernel<decltype(cpl)::value><<<rows, 256, 0, stream>>>(
        s.res, s.dh, lnw3 + 2L * C, g, P, C, eps, s.dout, s.yhat2);
  });
  if (rc) return rc;
  seq_dot_kernel<<<sgrid, sblock, 0, stream>>>(s.dout, s.a, nullptr, mult_a, T, C, dma,
                                               s.gmh);
  UNAV_RETURN_IF_ERROR();
  rc = mhca_backward_saved(s.h1, C, s.h2, C, mask, R, T, C, H, dw, lnw, w, eps, sv, s.gmh, C,
                           s.dh1, C, s.dh2, C, 0, gdw, glnw, glnb, gw, gb, s.mhca, stream);
  if (rc) return rc;

  // ---- ln11 / ln12 and x -------------------------------------------------
  rc = with_cpl(C, [&](auto cpl) {
    ln_pair_bwd_kernel<decltype(cpl)::value><<<rows, 256, 0, stream>>>(
        x, mask, lnw3, s.dh1, s.dh2, s.dout, P, C, eps, dx, s.yhat1);
  });
  if (rc) return rc;

  // ---- biases and LayerNorm affines: one batched column-sum launch -------
  ColBatch cb;
  int n = 0;
  cb.j[n++] = col_job(s.gy, C, (int)P, C, gb2);
  cb.j[n++] = col_job(s.du, Hd, (int)P, Hd, gb1);
  const float* dys[3] = {s.dh1, s.dh2, s.dh};
  const float* yhats[3] = {s.yhat1, s.yhat1, s.yhat2};
  for (int i = 0; i < 3; ++i) {
    cb.j[n] = col_job(dys[i], C, (int)P, C, glnw3 + (long)i * C);
    cb.j[n].b = yhats[i];
    cb.j[n++].ldb = C;
    cb.j[n++] = col_job(dys[i], C, (int)P, C, glnb3 + (long)i * C);
  }
  rc = launch_colsum(cb, n, s.partial, stream);
  return rc;
}
