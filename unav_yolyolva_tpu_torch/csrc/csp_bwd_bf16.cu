// MaxSigmoidCSPLayer backward in bf16 for Hopper: the bf16 instantiation of
// the Pallas kernel `_csp_bwd_kernel` / `_csp_diff_bwd`
// (unav_yolyolva_tpu/ops/pallas_csp.py), `jax.vjp` of the bf16 `_csp_compute`
// once per block of Rj sequences (bf16_bwd.cuh's form MHCA_VJP for the three
// inner MHCAs). Like the TPU kernel it saves nothing but its inputs:
//   recompute: main conv, the three MHCAs (bf16.cuh; each keeps its normalized
//     inputs, q/k/v and attention output for its backward), guide_fc and the
//     projection conv in one launch, and gate_scores_bf16_kernel, which
//     scores the gate through the forward's own scoring function on the
//     tensor cores (the forward's scores to the bit, so ties route as the
//     forward saw them) and keeps each (frame, head)'s scores, max, tie
//     count and sigmoid;
//   final conv: dcat = bf16((g . m) Wfinal), Wfinal's grad per block (the
//     mask read with g);
//   gate_bwd_bf16_kernel: d(pc) = bf16(dgated * gate) . m, the gate's grad
//     as the bf16 sum over the head's channels in XLA's order, sigmoid',
//     the max's grad split over the tied tokens into a dense fp32 (T, Ng)
//     grad of the scores, which two products turn into d(p) and d(gp);
//   projection conv: three products for d(p) (centre, right and left taps),
//     in the launch of d(p) from the scores, and three weight grads over
//     shifted rows (read shifted by the product's loader), in the launch of
//     d(gp);
//   p's grads added in JAX's order (concat, gate, centre, right, left), then
//     the MHCAs in reverse, each adding its input's grads after the concat's;
//   guide_fc and the main conv: input grads, weight grads per block; every
//     bias and tap, the three MHCAs' too, in one launch of XLA-order sums,
//     the LayerNorms' affine grads and battn's in one of fp32 sums.
// Wproj arrives as the layer keeps it, (mid, mid, 3) [out, in, tap]: the
// weights' cast writes the forward's (mid, 3, mid) and the transposed conv's
// (3, mid, mid) copies, and its grad is written in place in that layout.
// Bound: operations (bf16_bwd.cuh).
#include "bf16_bwd.cuh"

// The gate rescored as the forward scores it (bf16.cuh:gate_bf16_scores,
// the one scoring function of both, so the scores, max and ties are the
// forward's to the bit): each score is kept (sc), then each frame's max,
// tie count, sigmoid s and s (1 - s) (stat), and the gated projection
// bf16(pc * bf16(s)) into dst (cat slice 5). grid (ceil(T / 64), H, R), 128
// threads, gate_bf16_smem(HP) bytes of shared memory.
template <int HP>
__global__ void __launch_bounds__(128) gate_scores_bf16_kernel(
    const bf16* __restrict__ p, long ldp, const bf16* __restrict__ gp,
    const float* __restrict__ battn, const bf16* __restrict__ pc, int T, int Ng, int emb,
    int H, float sqrt_hc, int och, float* __restrict__ sc, float* __restrict__ stat,
    bf16* __restrict__ dst, long ldd) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  const int r = blockIdx.z, h = blockIdx.y;
  float* scr = sc + ((long)r * H + h) * T * Ng;
  float mx[2];
  int cnt[2];
  gate_bf16_scores<HP>(reinterpret_cast<bf16*>(gs_smem), p, ldp, gp, T, Ng, emb, H,
                       [&](int t, int n, float v) { scr[(long)t * Ng + n] = v; }, mx, cnt);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = gate_frame(hh);
    if (t >= T) continue;
    const long row = ((long)r * H + h) * T + t, prow = (long)r * T + t;
    const float sg = 1.f / (1.f + expf(-(mx[hh] / sqrt_hc + battn[h])));
    const float gate = rbf(sg);
    if ((threadIdx.x & 3) == 0) {
      stat[row * 4 + 0] = mx[hh];
      stat[row * 4 + 1] = (float)cnt[hh];
      stat[row * 4 + 2] = sg * (1.f - sg);
      stat[row * 4 + 3] = gate;
    }
    gate_bf16_rows(pc + prow * (long)och * H + h * och, dst + prow * ldd + h * och, och, gate);
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
  bf16 *cat, *gp, *pc, *dcat, *dpc, *de, *dgp, *dC, *dR, *dL;
  float *sc, *stat, *dsc, *dbias, *partial, *xwork, *split;
  long xwork_floats, split_floats;
  MhcaBwdBufs mb[3];
};

static CspBwdBufs csp_bwd_bf16_buffers(Bump& s, int R, int T, int Cin, int mid, int Ng,
                                       int Fg, int Cout, int H, int mh) {
  const long P = (long)R * T, Z = (long)R * H, MM = (long)mid * mid;
  CspBwdBufs b;
  b.wmain = s.take<bf16>(2L * mid * Cin);
  b.bmain = s.take<bf16>(2L * mid);
  b.w = s.take<bf16>(12L * MM);
  b.b = s.take<bf16>(12L * mid);
  b.wg = s.take<bf16>((long)mid * Fg);
  b.bg = s.take<bf16>(mid);
  b.wproj = s.take<bf16>(3L * MM);
  b.wproj_t = s.take<bf16>(3L * MM);
  b.bproj = s.take<bf16>(mid);
  b.wfinal = s.take<bf16>(6L * mid * Cout);
  b.bfinal = s.take<bf16>(Cout);
  b.cat = s.take<bf16>(P * 6 * mid);
  b.gp = s.take<bf16>((long)R * Ng * mid);
  b.pc = s.take<bf16>(P * mid);
  b.dcat = s.take<bf16>(P * 6 * mid);
  b.dpc = s.take<bf16>(P * mid);
  b.de = s.take<bf16>(P * mid);
  b.dgp = s.take<bf16>((long)R * Ng * mid);
  b.dL = s.take<bf16>(3 * P * mid);   // the taps' d(p): left, centre, right
  b.dC = b.dL ? b.dL + P * mid : nullptr;
  b.dR = b.dL ? b.dL + 2 * P * mid : nullptr;
  b.sc = s.take<float>(Z * T * Ng);
  b.stat = s.take<float>(Z * T * 4);
  b.dsc = s.take<float>(Z * T * Ng);
  b.dbias = s.take<float>(P * H);
  b.partial = s.take<float>(fsum_scratch_floats(P, std::max(mid, H)));
  b.xwork_floats = xla_sums_work_floats(R, std::max(T + 8, Ng),
                                        std::max(std::max(Cout, 2 * mid), Fg), 4 + 3 * 13);
  b.xwork = s.take<float>(b.xwork_floats);
  // the weight grads' row blocks (at most R of them) of the largest launch
  b.split_floats = (long)R * std::max(std::max(2L * mid * Cin, 6L * mid * Cout),
                                      std::max(4 * MM, (long)mid * Fg));
  b.split = s.take<float>(b.split_floats);
  for (auto& m : b.mb) m = mhca_bwd_bf16_buffers(s, R, T, mid, mh, false);
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
// (T rounded up to 8). fp32 weights as the layer keeps them: wmain (2mid,
// Cin); per MHCA block (3, stacked) dw (3, mid, 3), lnw / lnb (3, mid), w
// (4, mid, mid), b (4, mid); wg (emb, Fg); battn (H); wproj (mid, mid, 3)
// [out, in, tap]; wfinal (Cout, 6mid). Writes dx (R*T, Cin) and dguide
// (R*Ng, Fg) bf16, and the fp32 weight grads in the weights' layouts.
extern "C" int unav_csp_bf16_backward(
    const bf16* x, const bf16* guide, const unsigned char* mask, int R, int T, int Cin,
    int mid, int Ng, int Fg, int Cout, int attn_heads, int mhca_heads, int Rj, int tpad,
    const float* wmain, const float* bmain, const float* dw, const float* lnw,
    const float* lnb, const float* w, const float* b, const float* wg, const float* bg,
    const float* battn, const float* wproj, const float* bproj, const float* wfinal,
    const float* bfinal, float eps, const bf16* g, bf16* dx, bf16* dguide, float* gwmain,
    float* gbmain, float* gdw, float* glnw, float* glnb, float* gw, float* gb, float* gwg,
    float* gbg, float* gbattn, float* gwproj, float* gbproj, float* gwfinal,
    float* gbfinal, float* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int H = attn_heads, emb = mid, hc = emb / H, och = mid / H, C6 = 6 * mid;
  const long P = (long)R * T, Z = (long)R * H, MM = (long)mid * mid;
  if (R % Rj || tpad < T || emb % H || mid % H) return (int)cudaErrorInvalidValue;
  Bump bump{reinterpret_cast<char*>(scratch), 0};
  const CspBwdBufs u = csp_bwd_bf16_buffers(bump, R, T, Cin, mid, Ng, Fg, Cout, H, mhca_heads);
  const XSplit split{u.split, u.split_floats, xgemm_max_chunks(R)};
  CastList l;
  l.count = 0;
  const struct { bf16* dst; const float* src; long n; int perm; } casts[] = {
      {u.wmain, wmain, 2L * mid * Cin, CAST_AS_IS}, {u.bmain, bmain, 2L * mid, CAST_AS_IS},
      {u.w, w, 12L * MM, CAST_AS_IS}, {u.b, b, 12L * mid, CAST_AS_IS},
      {u.wg, wg, (long)mid * Fg, CAST_AS_IS}, {u.bg, bg, mid, CAST_AS_IS},
      {u.wproj, wproj, 3L * MM, CAST_SWAP12}, {u.wproj_t, wproj, 3L * MM, CAST_LAST_FIRST},
      {u.bproj, bproj, mid, CAST_AS_IS}, {u.wfinal, wfinal, 6L * mid * Cout, CAST_AS_IS},
      {u.bfinal, bfinal, Cout, CAST_AS_IS}};
  for (const auto& c : casts) {
    bf16* next = c.dst;
    cast_push(l, next, c.src, c.n, c.perm, mid, 3);
  }
  int rc = launch_cast(l, s);
  if (rc) return rc;

  // ---- the forward, recomputed; each MHCA keeps its recompute
  if ((rc = launch_gemm_bf16_one(
           bf16_gemm(x, Cin, u.wmain, Cin, u.cat, C6, u.bmain, mask, (int)P, 2 * mid, Cin), s)))
    return rc;
  for (int bi = 0; bi < 3; ++bi) {
    const bf16* src = u.cat + (1 + bi) * mid;
    rc = mhca_bf16_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                                dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                                lnb + (long)bi * 3 * mid, u.w + (long)bi * 4 * MM,
                                u.b + (long)bi * 4 * mid, eps, u.cat + (2 + bi) * mid, C6,
                                u.mb[bi].y3, s, u.mb[bi].o);
    if (rc) return rc;
  }
  Bf16Batch gb2;
  gb2.g[0] = bf16_gemm(guide, Fg, u.wg, Fg, u.gp, emb, u.bg, nullptr, R * Ng, emb, Fg);
  gb2.g[1] = bf16_gemm(u.cat + 4 * mid, C6, u.wproj, 3 * mid, u.pc, mid, u.bproj, mask, (int)P,
                       mid, 3 * mid);
  gb2.g[1].taps = 3; gb2.g[1].Kc = mid; gb2.g[1].seq = T;
  if ((rc = launch_gemm_bf16(gb2, 2, s))) return rc;
  const float sqrt_hc = (float)sqrt((double)hc);
  rc = with_gate_hp(hc, [&](auto hp) {
    constexpr int HP = decltype(hp)::value;
    const size_t smem = gate_bf16_smem(HP);
    static int limit = 0;
    raise_smem_limit((const void*)gate_scores_bf16_kernel<HP>, (int)smem, limit);
    gate_scores_bf16_kernel<HP><<<dim3(ceil_div(T, GB_T), H, R), 128, smem, s>>>(
        u.cat + 4 * mid, C6, u.gp, battn, u.pc, T, Ng, emb, H, sqrt_hc, och, u.sc, u.stat,
        u.cat + 5 * mid, C6);
  });
  if (rc) return rc;

  // ---- final conv: its output's grad g . m, the mask read with g
  XGemm fw = xgemm(Cout, C6, (int)P);
  xg_at(fw, g, Cout);
  fw.amask = mask;
  xg_b(fw, u.cat, C6);
  xg_c(fw, gwfinal, C6, 1);
  xg_blocks(fw, Rj * T);
  if ((rc = launch_xgemm(fw, s, split))) return rc;
  XGemm fx = xgemm((int)P, C6, Cout);
  xg_a(fx, g, Cout);
  fx.amask = mask;
  xg_b(fx, u.wfinal, C6);
  xg_c(fx, u.dcat, C6, 0);
  if ((rc = launch_xgemm(fx, s))) return rc;

  // ---- the gate; with it the projection conv's products (the taps (left,
  // centre, right) read p[t-1], p[t], p[t+1])
  gate_bwd_bf16_kernel<<<ceil_div(Z * T, 8), 256, 0, s>>>(
      u.dcat + 5 * mid, C6, u.pc, mask, u.sc, u.stat, R, T, Ng, H, sqrt_hc, och, u.dpc, u.dbias,
      u.dsc);
  UNAV_RETURN_IF_ERROR();
  const long TN = (long)T * Ng;
  XGemm xa[4];
  xa[0] = xgemm(T, hc, Ng);   // d(p) of the scores: dsc . gp_h
  xg_a(xa[0], u.dsc, Ng, 1);
  xg_b(xa[0], u.gp, emb);
  xg_c(xa[0], u.de, mid, 0);
  xg_batch(xa[0], (int)Z, H, H * TN, TN, (long)Ng * emb, hc, (long)T * mid, hc);
  for (int tap = 0; tap < 3; ++tap) {   // d(p) of the taps: dL, dC, dR
    xa[1 + tap] = xgemm((int)P, mid, mid);
    xg_a(xa[1 + tap], u.dpc, mid);
    xg_b(xa[1 + tap], u.wproj_t + tap * MM, mid);
    xg_c(xa[1 + tap], u.dL + tap * P * mid, mid, 0);
  }
  if ((rc = launch_xgemms(xa, 4, s))) return rc;
  xa[0] = xgemm(Ng, hc, T);   // d(gp): dsc^T . p_h
  xg_at(xa[0], u.dsc, Ng, 1);
  xg_b(xa[0], u.cat + 4 * mid, C6);
  xg_c(xa[0], u.dgp, emb, 0);
  xg_batch(xa[0], (int)Z, H, H * TN, TN, (long)T * C6, hc, (long)Ng * emb, hc);
  for (int tap = 0; tap < 3; ++tap) {   // Wproj's grad, written as (mid, mid, 3)
    XGemm& pw = xa[1 + tap];
    pw = xgemm(mid, mid, (int)P);
    xg_at(pw, u.dpc, mid);
    xg_b(pw, u.cat + 4 * mid, C6);
    pw.b_seq = T;
    pw.b_shift = tap - 1;
    xg_c(pw, gwproj + tap, 3L * mid, 1);
    pw.c_n = 3;
    xg_blocks(pw, Rj * T);
  }
  if ((rc = launch_xgemms(xa, 4, s, split))) return rc;
  p_grad_bf16_kernel<<<ceil_div(P * mid, 256), 256, 0, s>>>(u.dcat + 4 * mid, C6, u.de, u.dC,
                                                            u.dR, u.dL, P, T, mid);
  UNAV_RETURN_IF_ERROR();

  // ---- guide_fc
  XGemm gw_ = xgemm(emb, Fg, R * Ng);
  xg_at(gw_, u.dgp, emb);
  xg_b(gw_, guide, Fg);
  xg_c(gw_, gwg, Fg, 1);
  xg_blocks(gw_, Rj * Ng);
  if ((rc = launch_xgemm(gw_, s, split))) return rc;
  XGemm gx = xgemm(R * Ng, Fg, emb);
  xg_a(gx, u.dgp, emb);
  xg_b(gx, u.wg, Fg);
  xg_c(gx, dguide, Fg, 0);
  if ((rc = launch_xgemm(gx, s))) return rc;

  // ---- the three MHCAs in reverse: block bi reads slice bi+1, its output's
  // grad is slice bi+2, its input's grads go after the concat's, in place;
  // their sums join the layer's
  FJobs fj;
  XJobs xj;
  SumLists lists{&fj, 0, &xj, 0};
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
        Rj, tpad, u.mb[bi], false, &lists, split, s);
    if (rc) return rc;
  }

  // ---- main conv: its output's grad is slices 0, 1 times the mask
  XGemm mw = xgemm(2 * mid, Cin, (int)P);
  xg_at(mw, u.dcat, C6);
  mw.amask = mask;
  xg_b(mw, x, Cin);
  xg_c(mw, gwmain, Cin, 1);
  xg_blocks(mw, Rj * T);
  if ((rc = launch_xgemm(mw, s, split))) return rc;
  XGemm mx = xgemm((int)P, Cin, 2 * mid);
  xg_a(mx, u.dcat, C6);
  mx.amask = mask;
  xg_b(mx, u.wmain, Cin);
  xg_c(mx, dx, Cin, 0);
  if ((rc = launch_xgemm(mx, s))) return rc;

  // ---- the sums: the biases and taps in XLA's order per block, the three
  // MHCAs' with them; the LayerNorms' affine and battn's in fp32
  if (lists.nx + 4 > XJ_MAX || lists.nf + 1 > FJ_MAX) return (int)cudaErrorInvalidValue;
  xj.j[lists.nx++] = xjob(g, Cout, gbfinal, Cout, T, tpad, mask);
  xj.j[lists.nx++] = xjob(u.dpc, mid, gbproj, mid, T, tpad);
  xj.j[lists.nx++] = xjob(u.dcat, C6, gbmain, 2 * mid, T, tpad, mask);
  xj.j[lists.nx++] = xjob(u.dgp, emb, gbg, emb, Ng, Ng);
  if ((rc = launch_xla_sums(xj, lists.nx, R / Rj, Rj, u.xwork, u.xwork_floats, s))) return rc;
  fj.j[lists.nf++] = fjob(u.dbias, H, 0, (int)P, H, gbattn);
  rc = launch_fsums(fj, lists.nf, u.partial, s);
  return rc;
}
