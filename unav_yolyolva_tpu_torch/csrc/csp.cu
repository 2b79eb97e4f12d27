// MaxSigmoidCSPLayer forward for Hopper: the port of the Pallas kernel
// `_csp_kernel` / `_csp_compute` (unav_yolyolva_tpu/ops/pallas_csp.py).
//
// The TPU kernel runs the whole layer per batch block in VMEM. Here it is
// a sequence of the port's own launches over one (R*T, 6*mid) concat
// buffer, each part written straight into its column slice:
//   [main0, main1, mhca0, mhca1, mhca2, gated]
//   1. main 1x1 conv (Cin -> 2*mid) GEMM, row mask      -> slices 0, 1
//   2. three MaskedMHCA blocks (mhca.cuh), chained       -> slices 2, 3, 4
//   3. guide_fc: ONE GEMM over the whole batch, (R*Ng, Fg) x (Fg, emb); it
//      does not depend on the level, so it is not recomputed per row block
//   4. k=3 projection conv of slice 4 as one GEMM of depth 3*mid with zero
//      edges, bias, row mask                             -> slice 5
//   5. gate_kernel: per (row, t, head) sigmoid(max_n <e_h, g_h>/sqrt(hc) +
//      bias_h) multiplied into slice 5 (guide tokens are not masked)
//   6. final 1x1 conv GEMM (6*mid -> Cout), row mask     -> out
// Ragged T (7, 14, 28 at the small levels) is handled by the bounds checks
// of every kernel; nothing is padded.
// Bound: operations; at T=224 the products are ~95% of the work. Every
// product (the four convs, and the MHCAs' dense layers and attention) runs
// in 3xTF32 on the tensor cores (gemm_tc.cuh); the gate's scores and the
// MHCAs' conv + LayerNorm stay fp32 FFMA.
#include "csp.cuh"

// x (R*T, Cin), guide (R*Ng, Fg), mask (R*T). Weights in torch layout:
// wmain (2mid, Cin); per MHCA block bi (3 of them, stacked): dw (3, mid, 3),
// lnw/lnb (3, mid), w (4, mid, mid), b (4, mid); wg (emb, Fg); battn (H);
// wproj (mid, 3, mid) [out, tap, in]; wfinal (Cout, 6mid).
// Scratch: cat (R*T*6mid), gp (R*Ng*emb), mhca (6*R*T*mid). marks, if
// given, gets an event after each launch (CSP_STAGES of them).
static int csp_forward_impl(
    const float* x, const float* guide, const unsigned char* mask,
    int R, int T, int Cin, int mid, int Ng, int Fg, int Cout, int attn_heads,
    int mhca_heads, const float* wmain, const float* bmain, const float* dw,
    const float* lnw, const float* lnb, const float* w, const float* b,
    const float* wg, const float* bg, const float* battn, const float* wproj,
    const float* bproj, const float* wfinal, const float* bfinal, float eps,
    float* out, float* cat, float* gp, float* scratch, cudaStream_t stream,
    StageMarks* marks) {
  const int P = R * T, C6 = 6 * mid, emb = mid;
  int rc;

  GemmBatch g;
  g.g[0] = gemm_args(x, Cin, wmain, Cin, cat, C6, bmain, mask, 1.f, P, 2 * mid, Cin);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  mark_stage(marks, stream);

  for (int bi = 0; bi < 3; ++bi) {
    const float* src = cat + (1 + bi) * mid;
    rc = mhca_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                           dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                           lnb + (long)bi * 3 * mid, w + (long)bi * 4 * mid * mid,
                           b + (long)bi * 4 * mid, eps, cat + (2 + bi) * mid, C6,
                           scratch, stream, marks);
    if (rc) return rc;
  }

  g.g[0] = gemm_args(guide, Fg, wg, Fg, gp, emb, bg, nullptr, 1.f, R * Ng, emb, Fg);
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  mark_stage(marks, stream);

  g.g[0] = gemm_args(cat + 4 * mid, C6, wproj, 3 * mid, cat + 5 * mid, C6, bproj, mask,
                     1.f, P, mid, 3 * mid);
  g.g[0].taps = 3; g.g[0].Kc = mid; g.g[0].seq = T;
  if ((rc = launch_gemm(g, 1, stream))) return rc;
  mark_stage(marks, stream);

  const int hc = emb / attn_heads;
  const size_t smem = gate_smem_bytes(hc);
  static int limit = 0;
  raise_smem_limit((const void*)gate_kernel<false>, (int)smem, limit);
  dim3 grid(ceil_div(T, GATE_T), attn_heads, R);
  gate_kernel<false><<<grid, 256, smem, stream>>>(
      cat + 4 * mid, C6, gp, battn, T, Ng, emb, attn_heads,
      (float)sqrt((double)hc), cat + 5 * mid, C6, mid / attn_heads, nullptr, nullptr, nullptr);
  UNAV_RETURN_IF_ERROR();
  mark_stage(marks, stream);

  g.g[0] = gemm_args(cat, C6, wfinal, C6, out, Cout, bfinal, mask, 1.f, P, Cout, C6);
  rc = launch_gemm(g, 1, stream);
  mark_stage(marks, stream);
  return rc;
}

#define UNAV_CSP_PARAMS                                                               \
  const float *x, const float *guide, const unsigned char *mask, int R, int T, int Cin, \
      int mid, int Ng, int Fg, int Cout, int attn_heads, int mhca_heads,               \
      const float *wmain, const float *bmain, const float *dw, const float *lnw,       \
      const float *lnb, const float *w, const float *b, const float *wg,               \
      const float *bg, const float *battn, const float *wproj, const float *bproj,     \
      const float *wfinal, const float *bfinal, float eps, float *out, float *cat,     \
      float *gp, float *scratch, void *stream
#define UNAV_CSP_ARGS                                                                  \
  x, guide, mask, R, T, Cin, mid, Ng, Fg, Cout, attn_heads, mhca_heads, wmain, bmain,  \
      dw, lnw, lnb, w, b, wg, bg, battn, wproj, bproj, wfinal, bfinal, eps, out, cat,  \
      gp, scratch, (cudaStream_t)stream

extern "C" int unav_csp_forward(UNAV_CSP_PARAMS) {
  return csp_forward_impl(UNAV_CSP_ARGS, nullptr);
}

// stages of one forward, in launch order: main conv; per MHCA block its
// conv + LayerNorm, q/k/v, attention and proj; guide_fc; projection conv;
// gate; final conv
constexpr int CSP_STAGES = 1 + 3 * 4 + 4;

// The same forward, synchronised, with the device time of each stage in
// stage_ms (CSP_STAGES floats, CUDA events between the launches).
extern "C" int unav_csp_forward_stages(UNAV_CSP_PARAMS, float* stage_ms) {
  return time_stages<CSP_STAGES>((cudaStream_t)stream, stage_ms, [&](StageMarks* marks) {
    return csp_forward_impl(UNAV_CSP_ARGS, marks);
  });
}
