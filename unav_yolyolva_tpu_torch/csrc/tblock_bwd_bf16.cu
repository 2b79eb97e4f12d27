// Whole stride-1 TransformerBlock backward in bf16 for Hopper: the bf16
// instantiation (cdtype bfloat16) of the Pallas kernel `_tblock_bwd_kernel` /
// `_tblock_diff_bwd` (unav_yolyolva_tpu/ops/pallas_tblock.py), `jax.vjp` of
// the bf16 `_tblock_compute` once per block of Rj sequences. It saves nothing
// but its inputs: the forward is recomputed with tblock_bf16.cu's launches
// (fc1's epilogue keeping u = bf16(h W1 + b1) beside a = bf16(GELU(u))),
// then, in reverse:
//   mult_bwd_kernel: d(mult_m) = sum_t y * g (fp32), y's grad bf16(g *
//     mult_m) * m;
//   fc2, GELU' of the fp32 GELU on u's bf16 value (rounded to bf16, in the
//     epilogue of the product dy2 W2), fc1: input grads rounded to bf16,
//     weight grads per block rounded, biases in XLA's order (bf16_bwd.cuh);
//   ln2_bwd_kernel: ln2's backward in fp32 plus the residual's grad;
//   mult_bwd_kernel: d(mult_a) = sum_t attn * dout, the MHCA output's grad
//     bf16(dout * mult_a);
//   the MHCA (form MHCA_VJP, k/v from ln11, q from ln12), from the
//     recompute's own normalized inputs, q/k/v and attention output;
//   ln_pair_bwd_kernel: ln11's and ln12's backward and x's grad, fp32 (the
//     residual stream), and the LayerNorm affine grads' fp32 sums.
// Bound: operations (bf16_bwd.cuh; the MLP's products ~2/3 of the FLOPs).
// The MLP's six products (fc1, fc2, dy2 W2, du W1 and the weight grads
// dy2^T a, du^T h) run on bf16_wgmma.cuh.
#include "bf16_bwd.cuh"
#include "bf16_wgmma.cuh"

// d(mult)[r][c] = sum_t f(y[r,t,c]) g[r,t,c] in fp32 (y bf16 or fp32), and
// dy[r,t,c] = bf16(g * mult[r][c]) * m[r,t] (no mask: m = 1). A block per
// (sequence, 32 channels), lane = channel: its MB_WARPS warps each sum every
// MB_WARPS-th frame, and the warps' partial sums are added in warp order
// (no atomics: repeats give the same bits).
constexpr int MB_WARPS = 8;
__global__ void __launch_bounds__(MB_WARPS * 32) mult_bwd_kernel(
    const void* __restrict__ y, int y_bf, const float* __restrict__ g,
    const float* __restrict__ mult, const unsigned char* __restrict__ mask, int T, int C,
    float* __restrict__ dmult, bf16* __restrict__ dy) {
  __shared__ float part[MB_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.y, c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < C) {
    const float mu = mult[(long)r * C + c];
#pragma unroll 4
    for (int t = w; t < T; t += MB_WARPS) {
      const long row = (long)r * T + t, off = row * C + c;
      const float gv = g[off];
      s += ld_any(y, off, y_bf) * gv;
      dy[off] = rb(!mask || mask[row] ? rbf(gv * mu) : 0.f);
    }
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < C) {
    float tot = part[0][lane];
#pragma unroll
    for (int i = 1; i < MB_WARPS; ++i) tot += part[i][lane];
    dmult[(long)r * C + c] = tot;
  }
}

static int launch_mult_bwd(const void* y, int y_bf, const float* g, const float* mult,
                           const unsigned char* mask, int R, int T, int C, float* dmult,
                           bf16* dy, cudaStream_t s) {
  mult_bwd_kernel<<<dim3(ceil_div(C, 32), R), MB_WARPS * 32, 0, s>>>(y, y_bf, g, mult, mask, T,
                                                                      C, dmult, dy);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// ln2's backward, one warp per frame: recomputes res = x * m + attn *
// mult_a (fp32, as residual_ln2_bf16_kernel) and ln2's statistics, writes
// yhat2 and dout = g + LN'(dh * lnw2) (fp32)
template <int CPL>
__global__ void __launch_bounds__(256) ln2_bwd_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask,
    const float* __restrict__ mult_a, const bf16* __restrict__ a, long P, int T, int C,
    const float* __restrict__ lnw, float eps, const bf16* __restrict__ dh,
    const float* __restrict__ g, float* __restrict__ yhat, float* __restrict__ dout) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const float mval = mask[row] ? 1.f : 0.f;
  const float* ma = mult_a + (row / T) * C;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    y[i] = c < C ? __fadd_rn(__fmul_rn(x[row * C + c], mval), __fmul_rn(bf(a[row * C + c]), ma[c]))
                 : 0.f;
  }
  const float inv = warp_ln_center(y, lane, C, eps);
  float dyh[CPL];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    dyh[i] = 0.f;
    if (c < C) {
      y[i] *= inv;
      dyh[i] = bf(dh[row * C + c]) * lnw[c];
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
      yhat[row * C + c] = y[i];
      dout[row * C + c] = g[row * C + c] + inv * (dyh[i] - s1 - y[i] * s2);
    }
  }
}

// ln11's and ln12's backward, one warp per frame (one set of statistics of
// x): yhat, and dx = dout * m + LN'(dh1 * lnw11) + LN'(dh2 * lnw12), fp32
template <int CPL>
__global__ void __launch_bounds__(256) ln_pair_bwd_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ mask, long P, int C,
    const float* __restrict__ lnw3, float eps, const bf16* __restrict__ dh1,
    const bf16* __restrict__ dh2, const float* __restrict__ dout, float* __restrict__ yhat,
    float* __restrict__ dx) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= P) return;
  const float mval = mask[row] ? 1.f : 0.f;
  float y[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) y[i] = lane + 32 * i < C ? x[row * C + lane + 32 * i] : 0.f;
  const float inv = warp_ln_center(y, lane, C, eps);
  float d1[CPL], d2[CPL];
  float a1 = 0.f, b1 = 0.f, a2 = 0.f, b2 = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    d1[i] = d2[i] = 0.f;
    if (c < C) {
      y[i] *= inv;
      d1[i] = bf(dh1[row * C + c]) * lnw3[c];
      d2[i] = bf(dh2[row * C + c]) * lnw3[C + c];
      a1 += d1[i];
      b1 += d1[i] * y[i];
      a2 += d2[i];
      b2 += d2[i] * y[i];
    }
  }
  a1 = warp_sum(a1) / C;
  b1 = warp_sum(b1) / C;
  a2 = warp_sum(a2) / C;
  b2 = warp_sum(b2) / C;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      yhat[row * C + c] = y[i];
      dx[row * C + c] = dout[row * C + c] * mval + inv * (d1[i] - a1 - y[i] * b1) +
                        inv * (d2[i] - a2 - y[i] * b2);
    }
  }
}

struct TblockBwdBufs {
  bf16 *wb, *bb, *w1b, *b1b, *w2b, *b2b;
  bf16 *h1, *h2, *attn, *h, *u, *a, *y2, *dy2, *du, *dh, *dattn, *dh1, *dh2;
  float *res, *yhat2, *dout, *yhat, *partial, *xwork, *split;
  long xwork_floats, split_floats;
  MhcaBwdBufs mb;
};

static TblockBwdBufs tblock_bwd_bf16_buffers(Bump& s, int R, int T, int C, int Hd, int H) {
  const long P = (long)R * T, PC = P * C, PH = P * Hd;
  TblockBwdBufs b;
  b.wb = s.take<bf16>(4L * C * C);
  b.bb = s.take<bf16>(4L * C);
  b.w1b = s.take<bf16>((long)Hd * C);
  b.b1b = s.take<bf16>(Hd);
  b.w2b = s.take<bf16>((long)C * Hd);
  b.b2b = s.take<bf16>(C);
  b.h1 = s.take<bf16>(PC);
  b.h2 = s.take<bf16>(PC);
  b.attn = s.take<bf16>(PC);
  b.h = s.take<bf16>(PC);
  b.u = s.take<bf16>(PH);
  b.a = s.take<bf16>(PH);
  b.y2 = s.take<bf16>(PC);
  b.dy2 = s.take<bf16>(PC);
  b.du = s.take<bf16>(PH);
  b.dh = s.take<bf16>(PC);
  b.dattn = s.take<bf16>(PC);
  b.dh1 = s.take<bf16>(PC);
  b.dh2 = s.take<bf16>(PC);
  b.res = s.take<float>(PC);
  b.yhat2 = s.take<float>(PC);
  b.dout = s.take<float>(PC);
  b.yhat = s.take<float>(PC);
  b.partial = s.take<float>(fsum_scratch_floats(P, C));
  b.xwork_floats = xla_sums_work_floats(R, T, std::max(C, Hd), 2);
  b.xwork = s.take<float>(b.xwork_floats);
  // the MHCA's four weight grads' row blocks (at most R)
  b.split_floats = (long)R * 4L * C * C;
  b.split = s.take<float>(b.split_floats);
  b.mb = mhca_bwd_bf16_buffers(s, R, T, C, H);
  return b;
}

// floats of scratch unav_tblock_bf16_backward needs
extern "C" long unav_tblock_bf16_backward_scratch(int R, int T, int C, int Hd, int heads) {
  Bump b{nullptr, 0};
  tblock_bwd_bf16_buffers(b, R, T, C, Hd, heads);
  return (b.used + 3) / 4;
}

// x, g (R*T, C) fp32, mask (R*T), mult_a / mult_m (R, C) fp32, the packed
// fp32 weights (tblock.cuh's order); Rj the JAX kernel's block of sequences
// (a divisor of R). Writes dx (R*T, C), d(mult_a), d(mult_m) (R, C) and the
// weight grads, fp32, in the weights' layouts.
extern "C" int unav_tblock_bf16_backward(
    const float* x, const unsigned char* mask, int R, int T, int C, int Hd, int heads, int Rj,
    const float* mult_a, const float* mult_m, const float* lnw3, const float* lnb3,
    const float* dw, const float* lnw, const float* lnb, const float* w, const float* b,
    const float* w1, const float* b1, const float* w2, const float* b2, float eps,
    const float* g, float* dx, float* dma, float* dmm, float* glnw3, float* glnb3, float* gdw,
    float* glnw, float* glnb, float* gw, float* gb, float* gw1, float* gb1, float* gw2,
    float* gb2, float* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long P = (long)R * T;
  if (R % Rj) return (int)cudaErrorInvalidValue;
  Bump bump{reinterpret_cast<char*>(scratch), 0};
  const TblockBwdBufs u = tblock_bwd_bf16_buffers(bump, R, T, C, Hd, heads);
  const XSplit split{u.split, u.split_floats, xgemm_max_chunks(R)};
  CastList l;
  l.count = 0;
  bf16* next;
  const struct { bf16* dst; const float* src; long n; } casts[] = {
      {u.wb, w, 4L * C * C}, {u.bb, b, 4L * C}, {u.w1b, w1, (long)Hd * C}, {u.b1b, b1, Hd},
      {u.w2b, w2, (long)C * Hd}, {u.b2b, b2, C}};
  for (const auto& c : casts) {
    next = c.dst;
    cast_push(l, next, c.src, c.n);
  }
  int rc = launch_cast(l, s);
  if (rc) return rc;

  // ---- the forward, recomputed
  rc = with_cpl(C, [&](auto cpl) {
    ln_pair_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, P, C, lnw3, lnb3, eps, u.h1, u.h2);
  });
  if (rc) return rc;
  rc = mhca_bf16_forward_impl(u.h1, C, u.h2, C, mask, R, T, C, heads, dw, lnw, lnb, u.wb, u.bb,
                              eps, u.attn, C, u.mb.y3, s, u.mb.o);
  if (rc) return rc;
  rc = with_cpl(C, [&](auto cpl) {
    residual_ln2_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, mask, mult_a, u.attn, P, T, C, lnw3 + 2L * C, lnb3 + 2L * C, eps, u.res, u.h);
  });
  if (rc) return rc;
  WgProduct fc1 = wg_product(u.h, C, u.w1b, C, u.u, Hd, (int)P, Hd, C);
  fc1.bias = u.b1b;
  fc1.C2 = u.a;
  if ((rc = launch_wgmma_bf16<0, 0, WG_UA>(fc1, s))) return rc;
  WgProduct fc2 = wg_product(u.a, Hd, u.w2b, Hd, u.y2, C, (int)P, C, Hd);
  fc2.bias = u.b2b;
  fc2.rowmask = mask;
  if ((rc = launch_wgmma_bf16<0, 0, WG_STORE>(fc2, s))) return rc;

  // ---- mult_m, fc2, GELU, fc1
  if ((rc = launch_mult_bwd(u.y2, 1, g, mult_m, mask, R, T, C, dmm, u.dy2, s))) return rc;
  // the weight grads: fp32 sums of JAX row blocks of Rj * T rows, each rounded
  WgProduct w2g = wg_product(u.dy2, C, u.a, Hd, gw2, Hd, C, Hd, (int)P);
  w2g.kb = Rj * T;
  if ((rc = launch_wgmma_bf16<1, 1, WG_RAW>(w2g, s))) return rc;
  // du = bf16(GELU'(u) * bf16(dy2 W2)), u read by the epilogue
  WgProduct dag = wg_product(u.dy2, C, u.w2b, Hd, u.du, Hd, (int)P, Hd, C);
  dag.aux = u.u;
  if ((rc = launch_wgmma_bf16<0, 1, WG_DU>(dag, s))) return rc;
  WgProduct w1g = wg_product(u.du, Hd, u.h, C, gw1, C, Hd, C, (int)P);
  w1g.kb = Rj * T;
  if ((rc = launch_wgmma_bf16<1, 1, WG_RAW>(w1g, s))) return rc;
  if ((rc = launch_wgmma_bf16<0, 1, WG_STORE>(
           wg_product(u.du, Hd, u.w1b, C, u.dh, C, (int)P, C, Hd), s)))
    return rc;

  // ---- ln2 and the residual, mult_a
  rc = with_cpl(C, [&](auto cpl) {
    ln2_bwd_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, mask, mult_a, u.attn, P, T, C, lnw3 + 2L * C, eps, u.dh, g, u.yhat2, u.dout);
  });
  if (rc) return rc;
  // d(mult_a) and the MHCA output's grad bf16(dout * mult_a) (no row mask:
  // JAX's residual add is not masked)
  if ((rc = launch_mult_bwd(u.attn, 1, u.dout, mult_a, nullptr, R, T, C, dma, u.dattn, s)))
    return rc;

  // ---- the MHCA
  rc = mhca_bf16_backward(MHCA_VJP, u.h1, C, u.h2, C, mask, R, T, C, heads, dw, lnw, lnb, u.wb,
                          u.bb, eps, u.dattn, C, nullptr, 0, u.dh1, C, u.dh2, C,
                          MhcaGrads{gdw, glnw, glnb, gw, gb}, Rj, T, u.mb, false, nullptr,
                          split, s);
  if (rc) return rc;

  // ---- ln11, ln12 and x
  rc = with_cpl(C, [&](auto cpl) {
    ln_pair_bwd_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, mask, P, C, lnw3, eps, u.dh1, u.dh2, u.dout, u.yhat, dx);
  });
  if (rc) return rc;

  // ---- the sums: LayerNorm affine fp32, the MLP's biases in XLA's order
  FJobs fj;
  const bf16* dls[3] = {u.dh1, u.dh2, u.dh};
  for (int i = 0; i < 3; ++i) {
    fj.j[2 * i] = fjob(dls[i], C, 1, (int)P, C, glnw3 + (long)i * C);
    fj.j[2 * i].b = i < 2 ? u.yhat : u.yhat2;
    fj.j[2 * i].ldb = C;
    fj.j[2 * i + 1] = fjob(dls[i], C, 1, (int)P, C, glnb3 + (long)i * C);
  }
  if ((rc = launch_fsums(fj, 6, u.partial, s))) return rc;
  XJobs xj;
  xj.j[0] = xjob(u.dy2, C, gb2, C, T, T);
  xj.j[1] = xjob(u.du, Hd, gb1, Hd, T, T);
  rc = launch_xla_sums(xj, 2, R / Rj, Rj, u.xwork, u.xwork_floats, s);
  return rc;
}
