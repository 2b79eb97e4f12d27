// MaxSigmoidCSPLayer forward in bf16 for Hopper: the bf16 instantiation of the
// Pallas kernel `_csp_kernel` / `_csp_compute`
// (unav_yolyolva_tpu/ops/pallas_csp.py), the launches of csp.cu on the bf16
// kernels of bf16.cuh over one (R*T, 6*mid) bf16 concat buffer:
//   0. the layer's fp32 weights cast to bf16 into scratch (one launch);
//   1. main 1x1 conv, bias, row mask                    -> slices 0, 1
//      and guide_fc over the whole batch's guide tokens (the same launch)
//   2. three MaskedMHCA blocks (bf16.cuh)                -> slices 2, 3, 4
//   3. k=3 projection conv of slice 4, one product of depth 3*mid, bias,
//      row mask                                          -> slice 5
//   4. gate_bf16_kernel: the scores on the bf16 tensor cores (fp32 sums),
//      max, sigmoid, the gate rounded to bf16 and multiplied into slice 5
//   5. final 1x1 conv, bias, row mask                    -> out
// 17 launches. Bound: operations; every product, the MHCAs' attention and
// the gate's scores on the bf16 tensor cores, the MHCAs' conv + LayerNorm
// on the FP32 pipes.
#include "bf16.cuh"

static long csp_bf16_weight_elems(int Cin, int mid, int Fg, int Cout) {
  return cast_elems(2L * mid * Cin) + cast_elems(2L * mid) + cast_elems(12L * mid * mid) +
         cast_elems(12L * mid) + cast_elems((long)mid * Fg) + cast_elems(mid) +
         cast_elems(3L * mid * mid) + cast_elems(mid) + cast_elems(6L * mid * Cout) +
         cast_elems(Cout);
}

// bf16 elements of scratch unav_csp_bf16_forward needs: the concat, the
// projected guide, one MHCA's scratch, the cast weights
extern "C" long unav_csp_bf16_scratch(int R, int T, int Cin, int mid, int Ng, int Fg,
                                      int Cout) {
  const long P = (long)R * T;
  return cast_elems(P * 6 * mid) + cast_elems((long)R * Ng * mid) +
         mhca_bf16_scratch_elems(R, T, mid) + csp_bf16_weight_elems(Cin, mid, Fg, Cout);
}

// x (R*T, Cin), guide (R*Ng, Fg), out (R*T, Cout) bf16; mask (R*T). fp32
// weights in torch layout: wmain (2mid, Cin); per MHCA block (3, stacked) dw
// (3, mid, 3), lnw / lnb (3, mid), w (4, mid, mid), b (4, mid); wg (emb,
// Fg); battn (H); wproj (mid, mid, 3) [out, in, tap] as the layer keeps it
// (the weights' cast writes the product's (mid, 3, mid)); wfinal (Cout,
// 6mid).
extern "C" int unav_csp_bf16_forward(
    const bf16* x, const bf16* guide, const unsigned char* mask, int R, int T, int Cin,
    int mid, int Ng, int Fg, int Cout, int attn_heads, int mhca_heads, const float* wmain,
    const float* bmain, const float* dw, const float* lnw, const float* lnb, const float* w,
    const float* b, const float* wg, const float* bg, const float* battn, const float* wproj,
    const float* bproj, const float* wfinal, const float* bfinal, float eps, bf16* out,
    bf16* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int P = R * T, C6 = 6 * mid, emb = mid;
  bf16* cat = scratch;
  bf16* gp = cat + cast_elems((long)P * C6);
  bf16* mhca = gp + cast_elems((long)R * Ng * mid);
  bf16* next = mhca + mhca_bf16_scratch_elems(R, T, mid);
  CastList l;
  l.count = 0;
  const bf16* wmain_b = cast_push(l, next, wmain, 2L * mid * Cin);
  const bf16* bmain_b = cast_push(l, next, bmain, 2L * mid);
  const bf16* w_b = cast_push(l, next, w, 12L * mid * mid);
  const bf16* b_b = cast_push(l, next, b, 12L * mid);
  const bf16* wg_b = cast_push(l, next, wg, (long)mid * Fg);
  const bf16* bg_b = cast_push(l, next, bg, mid);
  const bf16* wproj_b = cast_push(l, next, wproj, 3L * mid * mid, CAST_SWAP12, mid, 3);
  const bf16* bproj_b = cast_push(l, next, bproj, mid);
  const bf16* wfinal_b = cast_push(l, next, wfinal, 6L * mid * Cout);
  const bf16* bfinal_b = cast_push(l, next, bfinal, Cout);
  int rc = launch_cast(l, s);
  if (rc) return rc;

  Bf16Batch mg;   // the main conv and guide_fc: independent products, one launch
  mg.g[0] = bf16_gemm(x, Cin, wmain_b, Cin, cat, C6, bmain_b, mask, P, 2 * mid, Cin);
  mg.g[1] = bf16_gemm(guide, Fg, wg_b, Fg, gp, emb, bg_b, nullptr, R * Ng, emb, Fg);
  if ((rc = launch_gemm_bf16(mg, 2, s))) return rc;
  for (int bi = 0; bi < 3; ++bi) {
    const bf16* src = cat + (1 + bi) * mid;
    rc = mhca_bf16_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                                dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                                lnb + (long)bi * 3 * mid, w_b + (long)bi * 4 * mid * mid,
                                b_b + (long)bi * 4 * mid, eps, cat + (2 + bi) * mid, C6, mhca,
                                s);
    if (rc) return rc;
  }
  Bf16Gemm pj = bf16_gemm(cat + 4 * mid, C6, wproj_b, 3 * mid, cat + 5 * mid, C6, bproj_b, mask,
                          P, mid, 3 * mid);
  pj.taps = 3; pj.Kc = mid; pj.seq = T;
  if ((rc = launch_gemm_bf16_one(pj, s))) return rc;

  const int hc = emb / attn_heads;
  rc = with_gate_hp(hc, [&](auto hp) {
    constexpr int HP = decltype(hp)::value;
    const size_t smem = gate_bf16_smem(HP);
    static int limit = 0;
    raise_smem_limit((const void*)gate_bf16_kernel<HP>, (int)smem, limit);
    gate_bf16_kernel<HP><<<dim3(ceil_div(T, GB_T), attn_heads, R), 128, smem, s>>>(
        cat + 4 * mid, C6, gp, battn, T, Ng, emb, attn_heads, (float)sqrt((double)hc),
        cat + 5 * mid, C6, mid / attn_heads);
  });
  if (rc) return rc;

  rc = launch_gemm_bf16_one(
      bf16_gemm(cat, C6, wfinal_b, C6, out, Cout, bfinal_b, mask, P, Cout, C6), s);
  return rc;
}
