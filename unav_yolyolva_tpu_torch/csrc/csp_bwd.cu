// MaxSigmoidCSPLayer backward for Hopper: the port of the Pallas kernel
// `_csp_bwd_kernel` / `_csp_diff_bwd` (unav_yolyolva_tpu/ops/pallas_csp.py).
// unav_csp_backward saves nothing from the forward but its inputs: like the
// TPU kernel, which takes one vjp of `_csp_compute`, it recomputes the layer
// once (the concat buffer, gp, the pre-gate projection, each inner MHCA's
// intermediates for its backward, and the gate's per-(frame, head) max, tie
// count and first argmax) and walks the chain in reverse, into one grad
// buffer dcat of the concat's shape:
//   final conv: dcat = (g . mm) Wfinal, Wfinal's grad over all rows;
//   gate_bwd_kernel: d(pc) = dgated * gate, d(bias) = dgated . pc *
//     sigmoid', and the max's grad goes to the argmax token(s) the
//     recompute found, split evenly over ties as jnp.max / torch.amax do:
//     d(p) += coef * gp[argmax] straight into dcat's slice 4;
//   gate_bwd_guide_kernel: d(gp) per (row, head) accumulated over the
//     frames in order in shared memory, each token's sum by one warp (no
//     atomics);
//   k=3 projection conv: d(p) += the transposed conv (the product's shifted
//     loader with the taps reversed), its weight grad over shifted rows;
//   guide_fc: dguide = d(gp) Wg and Wg's grad;
//   the three MHCA blocks in reverse (mhca_backward_saved, from the
//     recompute's intermediates), each adding its input grad into the slice
//     of the part before it, which also fed the concat;
//   main conv: dx and Wmain's grad; then one batched column-sum launch for
//     the biases.
// Recomputing costs one forward; saving the concat and the MHCAs'
// intermediates instead would hold ~27 R*T*mid floats per layer from the
// forward to the backward, for all ten layers at once. Within the call the
// recompute keeps ~21 R*T*mid floats of MHCA intermediates (77 MB at 2B=16,
// T=224), so that each block's forward runs once.
// Bound: operations. Every product (the recompute's, the convs' and
// guide_fc's input and weight grads, the MHCAs' dense layers and attention
// forward and backward) runs in 3xTF32 on the tensor cores (gemm_tc.cuh);
// the gate's scores, and the recompute of a tied frame's scores, stay fp32
// FFMA so that the backward routes ties by the forward's very values. The
// recompute's products have bits that do not depend on batching, so the
// batched guide_fc + projection conv give the forward's exact scores.
#include "csp.cuh"
#include "mhca_bwd.cuh"

// grid (ceil(T/32), H, R), 256 threads; warp w owns frames 4w .. 4w+3 of
// the tile. mxi / cnti / idxi: the recompute's gate statistics
// (gate_kernel<true>). A frame whose max is tied scores every token again
// with gate_kernel's fmaf chain to find the tokens that reach it.
__global__ void __launch_bounds__(256) gate_bwd_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp,
    const float* __restrict__ battn, const float* __restrict__ pc,
    const float* __restrict__ dgated, long ldd, const unsigned char* __restrict__ mask,
    int T, int Ng, int emb, int H, float sqrt_hc, int och, const float* __restrict__ mxi,
    const int* __restrict__ idxi, const int* __restrict__ cnti, float* __restrict__ dpc,
    float* __restrict__ dz, float* __restrict__ coef, float* dp, long lddp) {
  const int hc = emb / H, mid = och * H;
  const int r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GATE_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + warp * 4 + i;
    if (t >= T) break;
    const long row = (long)r * T + t, s = ((long)r * H + h) * T + t;
    const float mx = mxi[s];
    const int cnt = cnti[s];
    const float gate = 1.f / (1.f + expf(-(mx / sqrt_hc + battn[h])));
    const float mval = mask[row] ? 1.f : 0.f;
    float dg = 0.f;
    for (int j = lane; j < och; j += 32) {
      const float gd = dgated[row * ldd + h * och + j];
      dg += gd * pc[row * mid + h * och + j];
      dpc[row * mid + h * och + j] = gd * gate * mval;
    }
    dg = warp_sum(dg);
    const float dzv = dg * gate * (1.f - gate);
    const float cf = dzv / sqrt_hc / (float)cnt;
    if (lane == 0) {
      dz[row * H + h] = dzv;
      coef[s] = cf;
    }
    if (cf == 0.f) continue;   // e.g. a masked frame, where all tokens tie at 0
    float* dprow = dp + row * lddp + h * hc;
    if (cnt == 1) {
      const float* g = gp + ((long)r * Ng + idxi[s]) * emb + h * hc;
      for (int c = lane; c < hc; c += 32) dprow[c] += cf * g[c];
      continue;
    }
    // tied maxima: find every token that reaches the max, in token order
    const float* prow = p + row * ldp + h * hc;
    for (int nb = 0; nb < Ng; nb += 32) {
      const int n = nb + lane;
      bool hit = false;
      if (n < Ng) {
        const float* g = gp + ((long)r * Ng + n) * emb + h * hc;
        float a = 0.f;
        for (int c = 0; c < hc; ++c) a = fmaf(prow[c], g[c], a);
        hit = a == mx;
      }
      unsigned bal = __ballot_sync(0xffffffffu, hit);
      while (bal) {
        const int b = __ffs(bal) - 1;
        bal &= bal - 1;
        const float* g = gp + ((long)r * Ng + nb + b) * emb + h * hc;
        for (int c = lane; c < hc; c += 32) dprow[c] += cf * g[c];
      }
    }
  }
}

constexpr int GUIDE_NB = 128;   // guide tokens per block of gate_bwd_guide_kernel
constexpr int GUIDE_FT = 64;    // frames of p per shared-memory tile

// grid (ceil(Ng / GUIDE_NB), H, R), 256 threads: d(gp) of one row's head h
// for GUIDE_NB tokens. The block walks the frames once, in order, GUIDE_FT
// at a time (their coef / count / argmax / max and p rows staged in shared
// memory by all threads, so that the loads overlap), and adds coef *
// p[frame] to the argmax token's row of a shared-memory accumulator: warp w
// owns the tokens n0 + w, + 8, .., so each token's sum runs over the frames
// in order, by one warp, without atomics. A frame whose max is tied scores
// the warp's tokens with gate_kernel's fmaf chain to find those that reach
// it. Shared memory: GUIDE_NB x hc accumulators, a GUIDE_FT x hc tile of p,
// 4 x T frame values.
__global__ void __launch_bounds__(256) gate_bwd_guide_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp, int T, int Ng,
    int emb, int H, const float* __restrict__ coef, const float* __restrict__ mxo,
    const int* __restrict__ idxo, const int* __restrict__ cnto, float* __restrict__ dgp) {
  extern __shared__ float gsm[];
  const int hc = emb / H;
  float* acc = gsm;                          // GUIDE_NB x hc
  float* pt = acc + GUIDE_NB * hc;           // GUIDE_FT x hc
  float* cfs = pt + GUIDE_FT * hc;           // T
  float* mxs = cfs + T;                      // T
  int* idxs = (int*)(mxs + T);               // T
  int* cnts = idxs + T;                      // T
  const int n0 = blockIdx.x * GUIDE_NB, h = blockIdx.y, r = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long sb = ((long)r * H + h) * T;
  for (int e = threadIdx.x; e < GUIDE_NB * hc; e += 256) acc[e] = 0.f;
  for (int t = threadIdx.x; t < T; t += 256) {
    cfs[t] = coef[sb + t];
    mxs[t] = mxo[sb + t];
    idxs[t] = idxo[sb + t];
    cnts[t] = cnto[sb + t];
  }
  for (int f0 = 0; f0 < T; f0 += GUIDE_FT) {
    __syncthreads();   // the frame values landed; the last tile is consumed
    for (int e = threadIdx.x; e < GUIDE_FT * hc; e += 256) {
      const int i = e / hc, c = e - i * hc, t = f0 + i;
      pt[e] = t < T && cfs[t] != 0.f ? p[((long)r * T + t) * ldp + h * hc + c] : 0.f;
    }
    __syncthreads();
    const int nf = min(GUIDE_FT, T - f0);
    for (int i = 0; i < nf; ++i) {
      const float cf = cfs[f0 + i];
      if (cf == 0.f) continue;
      const float* prow = pt + i * hc;
      if (cnts[f0 + i] == 1) {
        const int n = idxs[f0 + i] - n0;
        if (n < 0 || n >= GUIDE_NB || (n & 7) != warp) continue;
        for (int c = lane; c < hc; c += 32) acc[n * hc + c] = fmaf(cf, prow[c], acc[n * hc + c]);
        continue;
      }
      // tied maxima: the warp's tokens that reach the max, by the forward's
      // fmaf chain
      for (int j0 = 0; j0 < GUIDE_NB / 8; j0 += 32) {
        const int n = (j0 + lane) * 8 + warp;
        bool hit = false;
        if (j0 + lane < GUIDE_NB / 8 && n0 + n < Ng) {
          const float* g = gp + ((long)r * Ng + n0 + n) * emb + h * hc;
          float a = 0.f;
          for (int c = 0; c < hc; ++c) a = fmaf(prow[c], g[c], a);
          hit = a == mxs[f0 + i];
        }
        unsigned bal = __ballot_sync(0xffffffffu, hit);
        while (bal) {
          const int b = __ffs(bal) - 1, nn = (j0 + b) * 8 + warp;
          bal &= bal - 1;
          for (int c = lane; c < hc; c += 32)
            acc[nn * hc + c] = fmaf(cf, prow[c], acc[nn * hc + c]);
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GUIDE_NB * hc; e += 256) {
    const int n = e / hc, c = e - n * hc;
    if (n0 + n < Ng) dgp[((long)r * Ng + n0 + n) * emb + h * hc + c] = acc[e];
  }
}

static size_t gate_guide_smem_bytes(int hc, int T) {
  return sizeof(float) * ((size_t)(GUIDE_NB + GUIDE_FT) * hc + 4 * T);
}

struct CspScratch {
  float *cat, *dcat, *gp, *pc, *dpc, *dgp, *dz, *coef, *mx;
  int *idx, *cnt;
  float *saved[3], *work, *partial, *split;
  long total, split_floats;
};

static CspScratch csp_scratch(float* base, int R, int T, int Cin, int mid, int Ng, int Fg,
                              int Cout, int H, int mh) {
  const long P = (long)R * T, HT = (long)R * H * T;
  CspScratch s;
  long off = 0;
  // every part starts on 16 bytes: the tensor-core products' ring copies
  auto take = [&](long n) {
    float* q = base ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return q;
  };
  s.cat = take(P * 6 * mid);
  s.dcat = take(P * 6 * mid);
  s.gp = take((long)R * Ng * mid);
  s.pc = take(P * mid);
  s.dpc = take(P * mid);
  s.dgp = take((long)R * Ng * mid);
  s.dz = take(P * H);
  s.coef = take(HT);
  s.mx = take(HT);
  s.idx = (int*)take(HT);
  s.cnt = (int*)take(HT);
  for (auto& sv : s.saved) sv = take(mhca_saved_floats(R, T, mid, mh));
  s.work = take(mhca_backward_work_floats(R, T, mid, mh));
  s.partial = take(colsum_scratch_floats(std::max(P, (long)R * Ng), std::max(Cout, 2 * mid)));
  // the largest weight grad: wfinal, wmain, wproj or wg
  s.split_floats = gemm_splitk_floats(std::max<long>(
      {(long)Cout * 6 * mid, 2L * mid * Cin, 3L * mid * mid, (long)mid * Fg}));
  s.split = take(s.split_floats);
  s.total = off;
  return s;
}

// floats of scratch unav_csp_backward needs
extern "C" long unav_csp_backward_scratch(int R, int T, int Cin, int mid, int Ng, int Fg,
                                          int Cout, int attn_heads, int mhca_heads) {
  return csp_scratch(nullptr, R, T, Cin, mid, Ng, Fg, Cout, attn_heads, mhca_heads).total;
}

// The grads of one CSP layer forward (operands as unav_csp_forward, plus
// wprojT (3, mid, mid) [tap, out, in]) for the upstream grad gout (R*T, Cout):
// dx, dguide, and one fp32 grad per weight in the weight's own layout
// (gwproj (mid, 3, mid) as wproj is passed).
extern "C" int unav_csp_backward(
    const float* x, const float* guide, const unsigned char* mask,
    int R, int T, int Cin, int mid, int Ng, int Fg, int Cout, int attn_heads,
    int mhca_heads, const float* wmain, const float* bmain, const float* dw,
    const float* lnw, const float* lnb, const float* w, const float* b,
    const float* wg, const float* bg, const float* battn, const float* wproj,
    const float* wprojT, const float* bproj, const float* wfinal, const float* bfinal,
    float eps, const float* gout, float* dx, float* dguide, float* gwmain, float* gbmain,
    float* gdw, float* glnw, float* glnb, float* gw, float* gb, float* gwg, float* gbg,
    float* gbattn, float* gwproj, float* gbproj, float* gwfinal, float* gbfinal,
    float* scratch, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int P = R * T, C6 = 6 * mid, emb = mid, H = attn_heads, hc = emb / H;
  const CspScratch s = csp_scratch(scratch, R, T, Cin, mid, Ng, Fg, Cout, H, mhca_heads);
  const long MM = (long)mid * mid;
  int rc;
  GemmBatch g;

  // ---- recompute the forward: cat slices 0-4 and the MHCAs' intermediates,
  // gp, pc, cat slice 5 and the gate's statistics ----------------------------
  g.g[0] = gemm_args(x, Cin, wmain, Cin, s.cat, C6, bmain, mask, 1.f, P, 2 * mid, Cin);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  MhcaSaved sv[3];
  for (int bi = 0; bi < 3; ++bi) {
    const float* src = s.cat + (1 + bi) * mid;
    sv[bi] = mhca_saved(s.saved[bi], R, T, mid);
    rc = mhca_recompute(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                        dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                        lnb + (long)bi * 3 * mid, w + (long)bi * 4 * MM, b + (long)bi * 4 * mid,
                        eps, sv[bi], s.cat + (2 + bi) * mid, C6, stream);
    if (rc) return rc;
  }
  g.g[0] = gemm_args(guide, Fg, wg, Fg, s.gp, emb, bg, nullptr, 1.f, R * Ng, emb, Fg);
  g.g[1] = gemm_args(s.cat + 4 * mid, C6, wproj, 3 * mid, s.pc, mid, bproj, mask, 1.f, P,
                     mid, 3 * mid);
  g.g[1].taps = 3; g.g[1].Kc = mid; g.g[1].seq = T;
  if ((rc = launch_gemm(g, 2, stream))) return rc;
  cudaMemcpy2DAsync(s.cat + 5 * mid, sizeof(float) * C6, s.pc, sizeof(float) * mid,
                    sizeof(float) * mid, P, cudaMemcpyDeviceToDevice, stream);
  const size_t smem = gate_smem_bytes(hc);
  static int limit = 0;
  raise_smem_limit((const void*)gate_kernel<true>, (int)smem, limit);
  const float sqrt_hc = (float)sqrt((double)hc);
  const dim3 tgrid(ceil_div(T, GATE_T), H, R);
  gate_kernel<true><<<tgrid, 256, smem, stream>>>(s.cat + 4 * mid, C6, s.gp, battn, T, Ng, emb,
                                                  H, sqrt_hc, s.cat + 5 * mid, C6, mid / H,
                                                  s.mx, s.idx, s.cnt);
  UNAV_RETURN_IF_ERROR();

  // ---- final conv ----------------------------------------------------------
  g.g[0] = gemm_nn(gout, Cout, wfinal, C6, s.dcat, C6, mask, P, C6, Cout);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  g.g[0] = gemm_wgrad(gout, Cout, s.cat, C6, gwfinal, mask, Cout, C6, P);
  if ((rc = launch_gemm(g, 1, stream, s.split, s.split_floats))) return rc;

  // ---- gate: d(pc), d(bias), d(p) into slice 4, d(gp) --------------------
  gate_bwd_kernel<<<tgrid, 256, 0, stream>>>(
      s.cat + 4 * mid, C6, s.gp, battn, s.pc, s.dcat + 5 * mid, C6, mask, T, Ng, emb, H,
      sqrt_hc, mid / H, s.mx, s.idx, s.cnt, s.dpc, s.dz, s.coef, s.dcat + 4 * mid, C6);
  UNAV_RETURN_IF_ERROR();
  const size_t gsmem = gate_guide_smem_bytes(hc, T);
  static int glimit = 0;
  raise_smem_limit((const void*)gate_bwd_guide_kernel, (int)gsmem, glimit);
  gate_bwd_guide_kernel<<<dim3(ceil_div(Ng, GUIDE_NB), H, R), 256, gsmem, stream>>>(
      s.cat + 4 * mid, C6, s.gp, T, Ng, emb, H, s.coef, s.mx, s.idx, s.cnt, s.dgp);
  UNAV_RETURN_IF_ERROR();

  // ---- k=3 projection conv, guide_fc -------------------------------------
  g.g[0] = gemm_nn(s.dpc, mid, wprojT, mid, s.dcat + 4 * mid, C6, nullptr, P, mid, 3 * mid);
  g.g[0].taps = 3; g.g[0].tapdir = -1; g.g[0].Kc = mid; g.g[0].seq = T; g.g[0].beta = 1;
  g.g[1] = gemm_nn(s.dgp, emb, wg, Fg, dguide, Fg, nullptr, R * Ng, Fg, emb);
  if ((rc = launch_gemm(g, 2, stream))) return rc;
  g.g[0] = gemm_wgrad(s.dpc, mid, s.cat + 4 * mid, C6, gwproj, nullptr, mid, 3 * mid, P);
  g.g[0].btaps = 3; g.g[0].Kc = mid; g.g[0].seq = T;
  g.g[1] = gemm_wgrad(s.dgp, emb, guide, Fg, gwg, nullptr, emb, Fg, R * Ng);
  if ((rc = launch_gemm(g, 2, stream, s.split, s.split_floats))) return rc;

  // ---- the three MHCA blocks in reverse ----------------------------------
  for (int bi = 2; bi >= 0; --bi) {
    const float* src = s.cat + (1 + bi) * mid;
    rc = mhca_backward_saved(
        src, C6, src, C6, mask, R, T, mid, mhca_heads, dw + (long)bi * 3 * mid * 3,
        lnw + (long)bi * 3 * mid, w + (long)bi * 4 * MM, eps, sv[bi], s.dcat + (2 + bi) * mid,
        C6, s.dcat + (1 + bi) * mid, C6, s.dcat + (1 + bi) * mid, C6, 1,
        gdw + (long)bi * 3 * mid * 3, glnw + (long)bi * 3 * mid, glnb + (long)bi * 3 * mid,
        gw + (long)bi * 4 * MM, gb + (long)bi * 4 * mid, s.work, stream);
    if (rc) return rc;
  }

  // ---- main conv -----------------------------------------------------------
  g.g[0] = gemm_nn(s.dcat, C6, wmain, Cin, dx, Cin, mask, P, Cin, 2 * mid);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  g.g[0] = gemm_wgrad(s.dcat, C6, x, Cin, gwmain, mask, 2 * mid, Cin, P);
  if ((rc = launch_gemm(g, 1, stream, s.split, s.split_floats))) return rc;

  ColBatch cb;
  int n = 0;
  cb.j[n] = col_job(gout, Cout, P, Cout, gbfinal);
  cb.j[n++].rowmask = mask;
  cb.j[n++] = col_job(s.dpc, mid, P, mid, gbproj);
  cb.j[n++] = col_job(s.dgp, emb, R * Ng, emb, gbg);
  cb.j[n] = col_job(s.dcat, C6, P, 2 * mid, gbmain);
  cb.j[n++].rowmask = mask;
  cb.j[n++] = col_job(s.dz, H, P, H, gbattn);
  rc = launch_colsum(cb, n, s.partial, stream);
  return rc;
}
