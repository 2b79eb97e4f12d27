// MaxSigmoidCSPLayer backward for Hopper: the port of the Pallas kernel
// `_csp_bwd_kernel` / `_csp_diff_bwd` (unav_yolyolva_tpu/ops/pallas_csp.py).
// unav_csp_backward saves nothing from the forward but its inputs: like the
// TPU kernel it recomputes the layer (the concat buffer, gp and the
// pre-gate projection) and walks the chain in reverse, into one grad buffer
// dcat of the concat's shape:
//   final conv: dcat = (g . mm) Wfinal, Wfinal's grad over all rows;
//   gate_bwd_kernel: per (frame, head) the max over guide tokens again, with
//     the count of tied maxima and the first argmax; d(pc) = dgated * gate,
//     d(bias) = dgated . pc * sigmoid', and the max's grad goes to the
//     argmax token(s), split evenly over ties as jnp.max / torch.amax do:
//     d(p) += coef * gp[argmax] straight into dcat's slice 4;
//   gate_bwd_guide_kernel: d(gp) per (token, head) gathered over frames
//     (no scatter, no atomics);
//   k=3 projection conv: d(p) += the transposed conv (the GEMM's shifted
//     loader with the taps reversed), its weight grad over shifted rows;
//   guide_fc: dguide = d(gp) Wg and Wg's grad;
//   the three MHCA blocks in reverse (mhca_backward_impl), each adding its
//     input grad into the slice of the part before it, which also fed the
//     concat;
//   main conv: dx and Wmain's grad; then one batched column-sum launch for
//     the biases.
// Recomputing costs one forward; saving the concat instead would hold
// R*T*6*mid floats (22 MB at 2B=16, T=224) per layer from the forward to
// the backward, for all ten layers at once. Recompute keeps the memory of
// a train step at the eval step's and matches the TPU kernel. The
// recompute's products run on the tensor cores (gemm_tc.cuh) with bits that
// do not depend on batching, so the batched guide_fc + projection conv
// below give the forward's exact scores, ties included.
// Bound: operations (the backward's own products on FFMA).
#include "csp.cuh"
#include "mhca_bwd.cuh"

// grid (ceil(T/32), H, R), 256 threads; warp w owns frames 4w .. 4w+3 of the
// tile. Scores are computed exactly as gate_kernel does (the same fmaf
// chain), so the max and its ties are those of the forward.
__global__ void __launch_bounds__(256) gate_bwd_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp,
    const float* __restrict__ battn, const float* __restrict__ pc,
    const float* __restrict__ dgated, long ldd, const unsigned char* __restrict__ mask,
    int T, int Ng, int emb, int H, float sqrt_hc, int och, float* __restrict__ dpc,
    float* __restrict__ dz, float* __restrict__ coef, float* __restrict__ mxo,
    int* __restrict__ idxo, int* __restrict__ cnto, float* dp, long lddp) {
  extern __shared__ float sm[];
  const int hc = emb / H, hp = hc + 1, mid = och * H;
  float* Ps = sm;                 // GATE_T x hp
  float* Gs = sm + GATE_T * hp;   // GATE_N x hp
  const int r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GATE_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < GATE_T * hc; e += 256) {
    const int i = e / hc, c = e - i * hc, t = t0 + i;
    Ps[i * hp + c] = t < T ? p[((long)r * T + t) * ldp + h * hc + c] : 0.f;
  }
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int cnt[4] = {0, 0, 0, 0}, idx[4] = {Ng, Ng, Ng, Ng};
  for (int n0 = 0; n0 < Ng; n0 += GATE_N) {
    __syncthreads();
    for (int e = tid; e < GATE_N * hc; e += 256) {
      const int i = e / hc, c = e - i * hc, n = n0 + i;
      Gs[i * hp + c] = n < Ng ? gp[((long)r * Ng + n) * emb + h * hc + c] : 0.f;
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
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + lane + 32 * j;
      if (n < Ng)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (acc[i][j] > mx[i]) {
            mx[i] = acc[i][j]; cnt[i] = 1; idx[i] = n;
          } else if (acc[i][j] == mx[i]) {
            ++cnt[i];
          }
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[i], off);
      const int oc = __shfl_xor_sync(0xffffffffu, cnt[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
      if (om > mx[i]) {
        mx[i] = om; cnt[i] = oc; idx[i] = oi;
      } else if (om == mx[i]) {
        cnt[i] += oc; idx[i] = min(idx[i], oi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    const long row = (long)r * T + t;
    const float gate = 1.f / (1.f + expf(-(mx[i] / sqrt_hc + battn[h])));
    const float mval = mask[row] ? 1.f : 0.f;
    float dg = 0.f;
    for (int j = lane; j < och; j += 32) {
      const float gd = dgated[row * ldd + h * och + j];
      dg += gd * pc[row * mid + h * och + j];
      dpc[row * mid + h * och + j] = gd * gate * mval;
    }
    dg = warp_sum(dg);
    const float dzv = dg * gate * (1.f - gate);
    const float cf = dzv / sqrt_hc / (float)cnt[i];
    const long s = ((long)r * H + h) * T + t;
    if (lane == 0) {
      dz[row * H + h] = dzv;
      coef[s] = cf; mxo[s] = mx[i]; idxo[s] = idx[i]; cnto[s] = cnt[i];
    }
    if (cf == 0.f) continue;   // e.g. a masked frame, where all tokens tie at 0
    float* dprow = dp + row * lddp + h * hc;
    if (cnt[i] == 1) {
      const float* g = gp + ((long)r * Ng + idx[i]) * emb + h * hc;
      for (int c = lane; c < hc; c += 32) dprow[c] += cf * g[c];
      continue;
    }
    // tied maxima: find every token that reaches the max, in token order
    for (int nb = 0; nb < Ng; nb += 32) {
      const int n = nb + lane;
      bool hit = false;
      if (n < Ng) {
        const float* g = gp + ((long)r * Ng + n) * emb + h * hc;
        float a = 0.f;
        for (int c = 0; c < hc; ++c) a = fmaf(Ps[(warp * 4 + i) * hp + c], g[c], a);
        hit = a == mx[i];
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

// grid (ceil(Ng/32), H, R), 256 threads: thread (ni, g8) owns guide token ni
// of the tile and dims g8 + 8j of the head; gathers d(gp) over all frames.
__global__ void __launch_bounds__(256) gate_bwd_guide_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp, int T, int Ng,
    int emb, int H, const float* __restrict__ coef, const float* __restrict__ mxo,
    const int* __restrict__ idxo, const int* __restrict__ cnto, float* __restrict__ dgp) {
  const int hc = emb / H;
  const int r = blockIdx.z, h = blockIdx.y, n = blockIdx.x * 32 + (threadIdx.x >> 3);
  const int g8 = threadIdx.x & 7;
  const long sb = ((long)r * H + h) * T;
  const float* gprow = gp + ((long)r * Ng + min(n, Ng - 1)) * emb + h * hc;
  float acc[ATT_MAX_D / 8];
#pragma unroll
  for (int j = 0; j < ATT_MAX_D / 8; ++j) acc[j] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float cf = coef[sb + t];
    if (cf == 0.f) continue;
    const float* prow = p + ((long)r * T + t) * ldp + h * hc;
    bool hit;
    if (cnto[sb + t] == 1) {
      hit = idxo[sb + t] == n;
    } else {
      // tied maxima: the same fmaf chain as the forward's scores
      float a = 0.f;
      if (g8 == 0 && n < Ng)
        for (int c = 0; c < hc; ++c) a = fmaf(prow[c], gprow[c], a);
      a = __shfl_sync(0xffffffffu, a, 0, 8);
      hit = n < Ng && a == mxo[sb + t];
    }
    if (hit)
#pragma unroll
      for (int j = 0; j < ATT_MAX_D / 8; ++j) {
        const int dd = g8 + 8 * j;
        if (dd < hc) acc[j] = fmaf(cf, prow[dd], acc[j]);
      }
  }
  if (n < Ng)
#pragma unroll
    for (int j = 0; j < ATT_MAX_D / 8; ++j) {
      const int dd = g8 + 8 * j;
      if (dd < hc) dgp[((long)r * Ng + n) * emb + h * hc + dd] = acc[j];
    }
}

struct CspScratch {
  float *cat, *dcat, *gp, *pc, *dpc, *dgp, *dz, *coef, *mx;
  int *idx, *cnt;
  float *mhca, *partial, *split;
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
  s.mhca = take(std::max(6 * P * mid, mhca_backward_scratch_floats(R, T, mid, mh)));
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
  cudaStream_t stream = (cudaStream_t)stream_;
  const int P = R * T, C6 = 6 * mid, emb = mid, H = attn_heads, hc = emb / H;
  const CspScratch s = csp_scratch(scratch, R, T, Cin, mid, Ng, Fg, Cout, H, mhca_heads);
  const long MM = (long)mid * mid;
  int rc;
  GemmBatch g;

  // ---- recompute the forward: cat slices 0-4, gp, pc, cat slice 5 -------
  g.g[0] = gemm_args(x, Cin, wmain, Cin, s.cat, C6, bmain, mask, 1.f, P, 2 * mid, Cin);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  for (int bi = 0; bi < 3; ++bi) {
    const float* src = s.cat + (1 + bi) * mid;
    rc = mhca_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                           dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                           lnb + (long)bi * 3 * mid, w + (long)bi * 4 * MM,
                           b + (long)bi * 4 * mid, eps, s.cat + (2 + bi) * mid, C6,
                           s.mhca, stream);
    if (rc) return rc;
  }
  g.g[0] = gemm_args(guide, Fg, wg, Fg, s.gp, emb, bg, nullptr, 1.f, R * Ng, emb, Fg);
  g.g[1] = gemm_args(s.cat + 4 * mid, C6, wproj, 3 * mid, s.pc, mid, bproj, mask, 1.f, P,
                     mid, 3 * mid);
  g.g[1].taps = 3; g.g[1].Kc = mid; g.g[1].seq = T;
  if ((rc = launch_gemm(g, 2, stream))) return rc;
  cudaMemcpy2DAsync(s.cat + 5 * mid, sizeof(float) * C6, s.pc, sizeof(float) * mid,
                    sizeof(float) * mid, P, cudaMemcpyDeviceToDevice, stream);
  const size_t smem = sizeof(float) * (GATE_T + GATE_N) * (hc + 1);
  const float sqrt_hc = (float)sqrt((double)hc);
  const dim3 tgrid(ceil_div(T, GATE_T), H, R);
  cudaFuncSetAttribute(gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  gate_kernel<<<tgrid, 256, smem, stream>>>(s.cat + 4 * mid, C6, s.gp, battn, T, Ng, emb, H,
                                            sqrt_hc, s.cat + 5 * mid, C6, mid / H);
  UNAV_RETURN_IF_ERROR();

  // ---- final conv ----------------------------------------------------------
  g.g[0] = gemm_nn(gout, Cout, wfinal, C6, s.dcat, C6, mask, P, C6, Cout);
  g.g[1] = gemm_wgrad(gout, Cout, s.cat, C6, gwfinal, mask, Cout, C6, P);
  if ((rc = launch_gemm(g, 2, stream, s.split, s.split_floats))) return rc;

  // ---- gate: d(pc), d(bias), d(p) into slice 4, d(gp) --------------------
  cudaFuncSetAttribute(gate_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  gate_bwd_kernel<<<tgrid, 256, smem, stream>>>(
      s.cat + 4 * mid, C6, s.gp, battn, s.pc, s.dcat + 5 * mid, C6, mask, T, Ng, emb, H,
      sqrt_hc, mid / H, s.dpc, s.dz, s.coef, s.mx, s.idx, s.cnt, s.dcat + 4 * mid, C6);
  UNAV_RETURN_IF_ERROR();
  gate_bwd_guide_kernel<<<dim3(ceil_div(Ng, 32), H, R), 256, 0, stream>>>(
      s.cat + 4 * mid, C6, s.gp, T, Ng, emb, H, s.coef, s.mx, s.idx, s.cnt, s.dgp);
  UNAV_RETURN_IF_ERROR();

  // ---- k=3 projection conv, guide_fc -------------------------------------
  g.g[0] = gemm_nn(s.dpc, mid, wprojT, mid, s.dcat + 4 * mid, C6, nullptr, P, mid, 3 * mid);
  g.g[0].taps = 3; g.g[0].tapdir = -1; g.g[0].Kc = mid; g.g[0].seq = T; g.g[0].beta = 1;
  g.g[1] = gemm_wgrad(s.dpc, mid, s.cat + 4 * mid, C6, gwproj, nullptr, mid, 3 * mid, P);
  g.g[1].btaps = 3; g.g[1].Kc = mid; g.g[1].seq = T;
  g.g[2] = gemm_nn(s.dgp, emb, wg, Fg, dguide, Fg, nullptr, R * Ng, Fg, emb);
  g.g[3] = gemm_wgrad(s.dgp, emb, guide, Fg, gwg, nullptr, emb, Fg, R * Ng);
  if ((rc = launch_gemm(g, 4, stream, s.split, s.split_floats))) return rc;

  // ---- the three MHCA blocks in reverse ----------------------------------
  for (int bi = 2; bi >= 0; --bi) {
    const float* src = s.cat + (1 + bi) * mid;
    rc = mhca_backward_impl(
        src, C6, src, C6, mask, R, T, mid, mhca_heads, dw + (long)bi * 3 * mid * 3,
        lnw + (long)bi * 3 * mid, lnb + (long)bi * 3 * mid, w + (long)bi * 4 * MM,
        b + (long)bi * 4 * mid, eps, s.dcat + (2 + bi) * mid, C6, s.dcat + (1 + bi) * mid,
        C6, s.dcat + (1 + bi) * mid, C6, 1, gdw + (long)bi * 3 * mid * 3,
        glnw + (long)bi * 3 * mid, glnb + (long)bi * 3 * mid, gw + (long)bi * 4 * MM,
        gb + (long)bi * 4 * mid, s.mhca, stream);
    if (rc) return rc;
  }

  // ---- main conv -----------------------------------------------------------
  g.g[0] = gemm_nn(s.dcat, C6, wmain, Cin, dx, Cin, mask, P, Cin, 2 * mid);
  g.g[1] = gemm_wgrad(s.dcat, C6, x, Cin, gwmain, mask, 2 * mid, Cin, P);
  if ((rc = launch_gemm(g, 2, stream, s.split, s.split_floats))) return rc;

  ColBatch cb;
  int n = 0;
  cb.j[n] = col_job(gout, Cout, P, Cout, gbfinal);
  cb.j[n++].rowmask = mask;
  cb.j[n++] = col_job(s.dpc, mid, P, mid, gbproj);
  cb.j[n++] = col_job(s.dgp, emb, R * Ng, emb, gbg);
  cb.j[n] = col_job(s.dcat, C6, P, 2 * mid, gbmain);
  cb.j[n++].rowmask = mask;
  cb.j[n++] = col_job(s.dz, H, P, H, gbattn);
  return launch_colsum(cb, n, s.partial, stream);
}
