// MaxSigmoidCSPLayer backward in bf16 for Hopper: the bf16 instantiation of
// the Pallas kernel `_csp_bwd_kernel` / `_csp_diff_bwd`
// (unav_yolyolva_tpu/ops/pallas_csp.py), `jax.vjp` of the bf16 `_csp_compute`
// once per block of Rj sequences (bf16_bwd.cuh's form MHCA_VJP for the three
// inner MHCAs). Like the TPU kernel it saves nothing but its inputs:
//   recompute: main conv, the three MHCAs (bf16.cuh), guide_fc, the
//     projection conv, and gate_scores_bf16_kernel, which scores the gate
//     with the forward's own tiles and fmaf chain on bf16 loads (the
//     forward's scores to the bit, so ties route as the forward saw them) and
//     keeps each (frame, head)'s scores, max, tie count and sigmoid;
//   final conv: dcat = bf16((g . m) Wfinal), Wfinal's grad per block;
//   gate_bwd_bf16_kernel: d(pc) = bf16(dgated * gate) . m, the gate's grad
//     as the bf16 sum over the head's channels in XLA's order, sigmoid',
//     the max's grad split over the tied tokens into a dense fp32 (T, Ng)
//     grad of the scores, which two products turn into d(p) and d(gp);
//   projection conv: three products for d(p) (centre, right and left taps)
//     and three weight grads over shifted rows;
//   p's grads added in JAX's order (concat, gate, centre, right, left), then
//     the MHCAs in reverse, each adding its input's grads after the concat's;
//   guide_fc and the main conv: input grads, weight grads per block, biases
//     in XLA's order.
// Bound: operations (bf16_bwd.cuh).
#include "bf16_bwd.cuh"

// gate_bf16_kernel's tiling (csp_bf16's forward: grid (ceil(T / 32), H, R),
// 256 threads, each warp 4 frames, each lane 4 tokens of a 128-token tile)
// and its fmaf chain over the head's hc channels on bf16 loads, so the scores
// are the forward's to the bit; each score is kept (sc), then each frame's
// max, tie count, sigmoid s and s (1 - s) (stat), and the gated projection
// bf16(pc * bf16(s)) into dst (cat slice 5).
__global__ void __launch_bounds__(256) gate_scores_bf16_kernel(
    const bf16* __restrict__ p, long ldp, const bf16* __restrict__ gp,
    const float* __restrict__ battn, const bf16* __restrict__ pc, int T, int Ng, int emb,
    int H, float sqrt_hc, int och, float* __restrict__ sc, float* __restrict__ stat,
    bf16* __restrict__ dst, long ldd) {
  extern __shared__ float gsm[];
  const int hc = emb / H, hp = hc + 1;
  float* Ps = gsm;                 // GATE_T x hp
  float* Gs = gsm + GATE_T * hp;   // GATE_N x hp
  const int r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GATE_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < GATE_T * hc; e += 256) {
    const int i = e / hc, c = e - i * hc, t = t0 + i;
    Ps[i * hp + c] = t < T ? bf(p[((long)r * T + t) * ldp + h * hc + c]) : 0.f;
  }
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int n0 = 0; n0 < Ng; n0 += GATE_N) {
    __syncthreads();
    for (int e = tid; e < GATE_N * hc; e += 256) {
      const int i = e / hc, c = e - i * hc, n = n0 + i;
      Gs[i * hp + c] = n < Ng ? bf(gp[((long)r * Ng + n) * emb + h * hc + c]) : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int c = 0; c < hc; ++c) {
      float pv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(warp * 4 + i) * hp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = Gs[(lane + 32 * j) * hp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], gv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + warp * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + lane + 32 * j;
        if (n < Ng && t < T) {
          sc[(((long)r * H + h) * T + t) * Ng + n] = acc[i][j];
          mx[i] = fmaxf(mx[i], acc[i][j]);
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m = warp_max(mx[i]);
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    const long row = ((long)r * H + h) * T + t;
    int cnt = 0;
    for (int n = lane; n < Ng; n += 32) cnt += sc[row * Ng + n] == m;
    cnt = (int)warp_sum((float)cnt);
    const float sg = 1.f / (1.f + expf(-(m / sqrt_hc + battn[h])));
    const float gate = rbf(sg);
    if (lane == 0) {
      stat[row * 4 + 0] = m;
      stat[row * 4 + 1] = (float)cnt;
      stat[row * 4 + 2] = sg * (1.f - sg);
      stat[row * 4 + 3] = gate;
    }
    const long prow = (long)r * T + t;
    for (int j = lane; j < och; j += 32)
      dst[prow * ldd + h * och + j] = rb(bf(pc[prow * (long)och * H + h * och + j]) * gate);
  }
}

// One warp per (sequence, head, frame): from the gated part's grad dgated
// (cat slice 5 of dcat), d(pc) = bf16(dgated * gate) * m; the gate's grad
// as the XLA-order bf16 sum over the head's och channels of bf16(pc *
// dgated), times s (1 - s) in fp32 (kept in dbias for battn's grad); the
// max's grad, / sqrt(hc) / ties, to every token that reaches the max: the
// row of dsc (fp32, zero elsewhere).
__global__ void __launch_bounds__(256) gate_bwd_bf16_kernel(
    const bf16* __restrict__ dgated, long ldg, const bf16* __restrict__ pc,
    const unsigned char* __restrict__ mask, const float* __restrict__ sc,
    const float* __restrict__ stat, int R, int T, int Ng, int H, float sqrt_hc, int och,
    bf16* __restrict__ dpc, float* __restrict__ dbias, float* __restrict__ dsc) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;   // (r, h, t)
  const int lane = threadIdx.x & 31;
  if (row >= (long)R * H * T) return;
  const int t = (int)(row % T), h = (int)(row / T % H), r = (int)(row / ((long)T * H));
  const long prow = (long)r * T + t;
  const float gate = stat[row * 4 + 3], mval = mask[prow] ? 1.f : 0.f;
  const bf16* dg = dgated + prow * ldg + h * och;
  const bf16* pch = pc + prow * (long)och * H + h * och;
  for (int j = lane; j < och; j += 32)
    dpc[prow * (long)och * H + h * och + j] = rb(rbf(bf(dg[j]) * gate) * mval);
  float dgate = 0.f;
  if (lane == 0) {
    auto leaf = [&](int, int j) -> float { return rbf(bf(pch[j]) * bf(dg[j])); };
    dgate = xla_sum2(1, och, leaf);
  }
  dgate = __shfl_sync(0xffffffffu, dgate, 0);
  const float ds = dgate * stat[row * 4 + 2];
  if (lane == 0) dbias[prow * H + h] = ds;
  const float coef = ds / sqrt_hc / stat[row * 4 + 1], mx = stat[row * 4 + 0];
  for (int n = lane; n < Ng; n += 32) dsc[row * Ng + n] = sc[row * Ng + n] == mx ? coef : 0.f;
}

// dst[t] = src[t + dir] within each sequence (zero outside), bf16 rows
__global__ void shift_rows_bf16_kernel(const bf16* __restrict__ src, long lds, long P, int T,
                                       int C, int dir, bf16* __restrict__ dst) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * C) return;
  const long m = i / C;
  const int c = (int)(i - m * C), t = (int)(m % T) + dir;
  dst[m * C + c] = t >= 0 && t < T ? src[(m + dir) * lds + c] : rb(0.f);
}

// p's grad in JAX's order, in place over the concat's grad dp (row stride
// ldp): ((((dp + de) + dC) + dR[t-1]) + dL[t+1]), each sum rounded to bf16
__global__ void p_grad_bf16_kernel(bf16* dp, long ldp, const bf16* __restrict__ de,
                                   const bf16* __restrict__ dC, const bf16* __restrict__ dR,
                                   const bf16* __restrict__ dL, long P, int T, int C) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * C) return;
  const long m = i / C;
  const int c = (int)(i - m * C), t = (int)(m % T);
  float s = rbf(bf(dp[m * ldp + c]) + bf(de[m * C + c]));
  s = rbf(s + bf(dC[m * C + c]));
  if (t > 0) s = rbf(s + bf(dR[(m - 1) * C + c]));
  if (t + 1 < T) s = rbf(s + bf(dL[(m + 1) * C + c]));
  dp[m * ldp + c] = rb(s);
}

// the call's buffers; with a counting Bump, its scratch size
struct CspBwdBufs {
  bf16 *wmain, *bmain, *w, *b, *wg, *bg, *wproj, *wproj_t, *bproj, *wfinal, *bfinal;
  bf16 *cat, *gp, *mhca, *pc, *gout, *dcat, *dpc, *de, *dgp, *pl, *pr, *dC, *dR, *dL;
  float *sc, *stat, *dsc, *dbias, *partial, *xwork, *split;
  long xwork_floats, split_cap;
  MhcaBwdBufs mb;
};

static CspBwdBufs csp_bwd_bf16_buffers(Bump& s, int R, int T, int Cin, int mid, int Ng,
                                       int Fg, int Cout, int H, int mh) {
  const long P = (long)R * T, Z = (long)R * H;
  CspBwdBufs b;
  b.wmain = s.take<bf16>(2L * mid * Cin);
  b.bmain = s.take<bf16>(2L * mid);
  b.w = s.take<bf16>(12L * mid * mid);
  b.b = s.take<bf16>(12L * mid);
  b.wg = s.take<bf16>((long)mid * Fg);
  b.bg = s.take<bf16>(mid);
  b.wproj = s.take<bf16>(3L * mid * mid);
  b.wproj_t = s.take<bf16>(3L * mid * mid);
  b.bproj = s.take<bf16>(mid);
  b.wfinal = s.take<bf16>(6L * mid * Cout);
  b.bfinal = s.take<bf16>(Cout);
  b.cat = s.take<bf16>(P * 6 * mid);
  b.gp = s.take<bf16>((long)R * Ng * mid);
  b.mhca = s.take<bf16>(mhca_bf16_scratch_elems(R, T, mid));
  b.pc = s.take<bf16>(P * mid);
  b.gout = s.take<bf16>(P * Cout);
  b.dcat = s.take<bf16>(P * 6 * mid);
  b.dpc = s.take<bf16>(P * mid);
  b.de = s.take<bf16>(P * mid);
  b.dgp = s.take<bf16>((long)R * Ng * mid);
  b.pl = s.take<bf16>(P * mid);
  b.pr = s.take<bf16>(P * mid);
  b.dC = s.take<bf16>(P * mid);
  b.dR = s.take<bf16>(P * mid);
  b.dL = s.take<bf16>(P * mid);
  b.sc = s.take<float>(Z * T * Ng);
  b.stat = s.take<float>(Z * T * 4);
  b.dsc = s.take<float>(Z * T * Ng);
  b.dbias = s.take<float>(P * H);
  b.partial = s.take<float>(fsum_scratch_floats(P, std::max(H, 1)));
  b.xwork_floats = xla_sums_work_floats(R, std::max(T + 8, Ng),
                                        std::max(std::max(Cout, 2 * mid), Fg), 4);
  b.xwork = s.take<float>(b.xwork_floats);
  b.split_cap = (long)R * std::max(std::max(2L * mid * Cin, 6L * mid * Cout),
                                   std::max((long)mid * mid, (long)mid * Fg));
  b.split = s.take<float>(b.split_cap);
  b.mb = mhca_bwd_bf16_buffers(s, R, T, mid, mh);
  return b;
}

// floats of scratch unav_csp_bf16_backward needs
extern "C" long unav_csp_bf16_backward_scratch(int R, int T, int Cin, int mid, int Ng, int Fg,
                                               int Cout, int attn_heads, int mhca_heads) {
  Bump b{nullptr, 0};
  csp_bwd_bf16_buffers(b, R, T, Cin, mid, Ng, Fg, Cout, attn_heads, mhca_heads);
  return (b.used + 3) / 4;
}

// x (R*T, Cin), guide (R*Ng, Fg), g (R*T, Cout) bf16; mask (R*T). The JAX
// kernel's block of Rj sequences (a divisor of R) and its padded length tpad
// (T rounded up to 8). fp32 weights as csp_bf16.cu takes them, wproj (mid, 3,
// mid) [out, tap, in] and wproj_t (3, mid, mid) [tap, out, in]. Writes dx
// (R*T, Cin) and dguide (R*Ng, Fg) bf16, and the fp32 weight grads in the
// weights' layouts, gwproj as (3, mid, mid) [tap, out, in].
extern "C" int unav_csp_bf16_backward(
    const bf16* x, const bf16* guide, const unsigned char* mask, int R, int T, int Cin, int mid,
    int Ng, int Fg, int Cout, int attn_heads, int mhca_heads, int Rj, int tpad,
    const float* wmain, const float* bmain, const float* dw, const float* lnw, const float* lnb,
    const float* w, const float* b, const float* wg, const float* bg, const float* battn,
    const float* wproj, const float* wproj_t, const float* bproj, const float* wfinal,
    const float* bfinal, float eps, const bf16* g, bf16* dx, bf16* dguide, float* gwmain,
    float* gbmain, float* gdw, float* glnw, float* glnb, float* gw, float* gb, float* gwg,
    float* gbg, float* gbattn, float* gwproj, float* gbproj, float* gwfinal, float* gbfinal,
    float* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int H = attn_heads, emb = mid, hc = emb / H, och = mid / H, C6 = 6 * mid;
  const long P = (long)R * T, Z = (long)R * H;
  if (R % Rj || tpad < T || emb % H || mid % H) return (int)cudaErrorInvalidValue;
  Bump bump{reinterpret_cast<char*>(scratch), 0};
  const CspBwdBufs u = csp_bwd_bf16_buffers(bump, R, T, Cin, mid, Ng, Fg, Cout, H, mhca_heads);
  CastList l;
  l.count = 0;
  bf16* next;
  const struct { bf16* dst; const float* src; long n; } casts[] = {
      {u.wmain, wmain, 2L * mid * Cin}, {u.bmain, bmain, 2L * mid},
      {u.w, w, 12L * mid * mid}, {u.b, b, 12L * mid}, {u.wg, wg, (long)mid * Fg},
      {u.bg, bg, mid}, {u.wproj, wproj, 3L * mid * mid}, {u.wproj_t, wproj_t, 3L * mid * mid},
      {u.bproj, bproj, mid}, {u.wfinal, wfinal, 6L * mid * Cout}, {u.bfinal, bfinal, Cout}};
  for (const auto& c : casts) {
    next = c.dst;
    cast_push(l, next, c.src, c.n);
  }
  int rc = launch_cast(l, s);
  if (rc) return rc;

  // ---- the forward, recomputed
  if ((rc = launch_gemm_bf16_one(
           bf16_gemm(x, Cin, u.wmain, Cin, u.cat, C6, u.bmain, mask, (int)P, 2 * mid, Cin), s)))
    return rc;
  for (int bi = 0; bi < 3; ++bi) {
    const bf16* src = u.cat + (1 + bi) * mid;
    rc = mhca_bf16_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                                dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                                lnb + (long)bi * 3 * mid, u.w + (long)bi * 4 * mid * mid,
                                u.b + (long)bi * 4 * mid, eps, u.cat + (2 + bi) * mid, C6, u.mhca,
                                s);
    if (rc) return rc;
  }
  if ((rc = launch_gemm_bf16_one(
           bf16_gemm(guide, Fg, u.wg, Fg, u.gp, emb, u.bg, nullptr, R * Ng, emb, Fg), s)))
    return rc;
  Bf16Gemm pj = bf16_gemm(u.cat + 4 * mid, C6, u.wproj, 3 * mid, u.pc, mid, u.bproj, mask,
                          (int)P, mid, 3 * mid);
  pj.taps = 3; pj.Kc = mid; pj.seq = T;
  if ((rc = launch_gemm_bf16_one(pj, s))) return rc;
  const float sqrt_hc = (float)sqrt((double)hc);
  const size_t gsmem = gate_smem_bytes(hc);
  static int glimit = 0;
  raise_smem_limit((const void*)gate_scores_bf16_kernel, (int)gsmem, glimit);
  gate_scores_bf16_kernel<<<dim3(ceil_div(T, GATE_T), H, R), 256, gsmem, s>>>(
      u.cat + 4 * mid, C6, u.gp, battn, u.pc, T, Ng, emb, H, sqrt_hc, och, u.sc, u.stat,
      u.cat + 5 * mid, C6);
  UNAV_RETURN_IF_ERROR();

  // ---- final conv
  if ((rc = launch_mask_rows(g, Cout, P, Cout, mask, u.gout, Cout, s))) return rc;
  XGemm fw = xgemm(Cout, C6, (int)P);
  xg_at(fw, u.gout, Cout);
  xg_b(fw, u.cat, C6);
  xg_c(fw, gwfinal, C6, 1);
  fw.split = u.split;
  fw.split_cap = u.split_cap;
  fw.kblock = Rj * T;
  fw.round_blocks = 1;
  if ((rc = launch_xgemm(fw, s))) return rc;
  XGemm fx = xgemm((int)P, C6, Cout);
  xg_a(fx, u.gout, Cout);
  xg_b(fx, u.wfinal, C6);
  xg_c(fx, u.dcat, C6, 0);
  if ((rc = launch_xgemm(fx, s))) return rc;

  // ---- the gate
  gate_bwd_bf16_kernel<<<ceil_div(Z * T, 8), 256, 0, s>>>(
      u.dcat + 5 * mid, C6, u.pc, mask, u.sc, u.stat, R, T, Ng, H, sqrt_hc, och, u.dpc, u.dbias,
      u.dsc);
  UNAV_RETURN_IF_ERROR();
  const long TN = (long)T * Ng;
  XGemm eg = xgemm(T, hc, Ng);   // d(p) of the scores: dsc . gp_h
  xg_a(eg, u.dsc, Ng, 1);
  xg_b(eg, u.gp, emb);
  xg_c(eg, u.de, mid, 0);
  xg_batch(eg, (int)Z, H, H * TN, TN, (long)Ng * emb, hc, (long)T * mid, hc);
  if ((rc = launch_xgemm(eg, s))) return rc;
  XGemm gg = xgemm(Ng, hc, T);   // d(gp): dsc^T . p_h
  xg_at(gg, u.dsc, Ng, 1);
  xg_b(gg, u.cat + 4 * mid, C6);
  xg_c(gg, u.dgp, emb, 0);
  xg_batch(gg, (int)Z, H, H * TN, TN, (long)T * C6, hc, (long)Ng * emb, hc);
  if ((rc = launch_xgemm(gg, s))) return rc;

  // ---- the projection conv: taps (left, centre, right) = p[t-1], p[t], p[t+1]
  shift_rows_bf16_kernel<<<ceil_div(P * mid, 256), 256, 0, s>>>(u.cat + 4 * mid, C6, P, T, mid,
                                                                -1, u.pl);
  UNAV_RETURN_IF_ERROR();
  shift_rows_bf16_kernel<<<ceil_div(P * mid, 256), 256, 0, s>>>(u.cat + 4 * mid, C6, P, T, mid,
                                                                1, u.pr);
  UNAV_RETURN_IF_ERROR();
  const long MM = (long)mid * mid;
  for (int tap = 0; tap < 3; ++tap) {
    XGemm pw = xgemm(mid, mid, (int)P);
    xg_at(pw, u.dpc, mid);
    xg_b(pw, tap == 0 ? u.pl : tap == 1 ? u.cat + 4 * mid : u.pr, tap == 1 ? C6 : mid);
    xg_c(pw, gwproj + tap * MM, mid, 1);
    pw.split = u.split;
    pw.split_cap = u.split_cap;
    pw.kblock = Rj * T;
    pw.round_blocks = 1;
    if ((rc = launch_xgemm(pw, s))) return rc;
    XGemm px = xgemm((int)P, mid, mid);
    xg_a(px, u.dpc, mid);
    xg_b(px, u.wproj_t + tap * MM, mid);
    xg_c(px, tap == 0 ? u.dL : tap == 1 ? u.dC : u.dR, mid, 0);
    if ((rc = launch_xgemm(px, s))) return rc;
  }
  p_grad_bf16_kernel<<<ceil_div(P * mid, 256), 256, 0, s>>>(u.dcat + 4 * mid, C6, u.de, u.dC,
                                                            u.dR, u.dL, P, T, mid);
  UNAV_RETURN_IF_ERROR();

  // ---- guide_fc
  XGemm gw_ = xgemm(emb, Fg, R * Ng);
  xg_at(gw_, u.dgp, emb);
  xg_b(gw_, guide, Fg);
  xg_c(gw_, gwg, Fg, 1);
  gw_.split = u.split;
  gw_.split_cap = u.split_cap;
  gw_.kblock = Rj * Ng;
  gw_.round_blocks = 1;
  if ((rc = launch_xgemm(gw_, s))) return rc;
  XGemm gx = xgemm(R * Ng, Fg, emb);
  xg_a(gx, u.dgp, emb);
  xg_b(gx, u.wg, Fg);
  xg_c(gx, dguide, Fg, 0);
  if ((rc = launch_xgemm(gx, s))) return rc;

  // ---- the three MHCAs in reverse: block bi reads slice bi+1, its output's
  // grad is slice bi+2, its input's grads go after the concat's, in place
  for (int bi = 2; bi >= 0; --bi) {
    const bf16* src = u.cat + (1 + bi) * mid;
    bf16* dsrc = u.dcat + (1 + bi) * mid;
    const long o3 = (long)bi * 3 * mid;
    rc = mhca_bf16_backward(
        MHCA_VJP, src, C6, src, C6, mask, R, T, mid, mhca_heads, dw + o3 * 3, lnw + o3,
        lnb + o3, u.w + (long)bi * 4 * MM, u.b + (long)bi * 4 * mid, eps, u.dcat + (2 + bi) * mid,
        C6, dsrc, C6, dsrc, C6, nullptr, 0,
        MhcaGrads{gdw + o3 * 3, glnw + o3, glnb + o3, gw + (long)bi * 4 * MM,
                  gb + (long)bi * 4 * mid},
        Rj, tpad, u.mb, s);
    if (rc) return rc;
  }

  // ---- main conv: its output's grad is slices 0, 1 times the mask
  if ((rc = launch_mask_rows(u.dcat, C6, P, 2 * mid, mask, u.dcat, C6, s))) return rc;
  XGemm mw = xgemm(2 * mid, Cin, (int)P);
  xg_at(mw, u.dcat, C6);
  xg_b(mw, x, Cin);
  xg_c(mw, gwmain, Cin, 1);
  mw.split = u.split;
  mw.split_cap = u.split_cap;
  mw.kblock = Rj * T;
  mw.round_blocks = 1;
  if ((rc = launch_xgemm(mw, s))) return rc;
  XGemm mx = xgemm((int)P, Cin, 2 * mid);
  xg_a(mx, u.dcat, C6);
  xg_b(mx, u.wmain, Cin);
  xg_c(mx, dx, Cin, 0);
  if ((rc = launch_xgemm(mx, s))) return rc;

  // ---- the biases in XLA's order per block; battn's in fp32
  XJobs xj;
  xj.j[0] = xjob(u.gout, Cout, gbfinal, Cout, T, tpad);
  xj.j[1] = xjob(u.dpc, mid, gbproj, mid, T, tpad);
  xj.j[2] = xjob(u.dcat, C6, gbmain, 2 * mid, T, tpad);
  xj.j[3] = xjob(u.dgp, emb, gbg, emb, Ng, Ng);
  if ((rc = launch_xla_sums(xj, 4, R / Rj, Rj, u.xwork, u.xwork_floats, s))) return rc;
  FJobs fj;
  fj.j[0] = fjob(u.dbias, H, 0, (int)P, H, gbattn);
  return launch_fsums(fj, 1, u.partial, s);
}
