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
// Scratch: cat (R*T*6mid), gp (R*Ng*emb), mhca (6*R*T*mid).
extern "C" int unav_csp_forward(
    const float* x, const float* guide, const unsigned char* mask,
    int R, int T, int Cin, int mid, int Ng, int Fg, int Cout, int attn_heads,
    int mhca_heads, const float* wmain, const float* bmain, const float* dw,
    const float* lnw, const float* lnb, const float* w, const float* b,
    const float* wg, const float* bg, const float* battn, const float* wproj,
    const float* bproj, const float* wfinal, const float* bfinal, float eps,
    float* out, float* cat, float* gp, float* scratch, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int P = R * T, C6 = 6 * mid, emb = mid;
  int rc;

  GemmBatch g;
  g.g[0] = gemm_args(x, Cin, wmain, Cin, cat, C6, bmain, mask, 1.f, P, 2 * mid, Cin);
  if ((rc = launch_gemm(g, 1, stream))) return rc;

  for (int bi = 0; bi < 3; ++bi) {
    const float* src = cat + (1 + bi) * mid;
    rc = mhca_forward_impl(src, C6, src, C6, mask, R, T, mid, mhca_heads,
                           dw + (long)bi * 3 * mid * 3, lnw + (long)bi * 3 * mid,
                           lnb + (long)bi * 3 * mid, w + (long)bi * 4 * mid * mid,
                           b + (long)bi * 4 * mid, eps, cat + (2 + bi) * mid, C6,
                           scratch, stream);
    if (rc) return rc;
  }

  g.g[0] = gemm_args(guide, Fg, wg, Fg, gp, emb, bg, nullptr, 1.f, R * Ng, emb, Fg);
  if ((rc = launch_gemm(g, 1, stream))) return rc;

  g.g[0] = gemm_args(cat + 4 * mid, C6, wproj, 3 * mid, cat + 5 * mid, C6, bproj, mask,
                     1.f, P, mid, 3 * mid);
  g.g[0].taps = 3; g.g[0].Kc = mid; g.g[0].seq = T;
  if ((rc = launch_gemm(g, 1, stream))) return rc;

  const int hc = emb / attn_heads;
  const size_t smem = gate_smem_bytes(hc);
  static int limit = 0;
  raise_smem_limit((const void*)gate_kernel<false>, (int)smem, limit);
  dim3 grid(ceil_div(T, GATE_T), attn_heads, R);
  gate_kernel<false><<<grid, 256, smem, stream>>>(
      cat + 4 * mid, C6, gp, battn, T, Ng, emb, attn_heads,
      (float)sqrt((double)hc), cat + 5 * mid, C6, mid / attn_heads, nullptr, nullptr, nullptr);
  UNAV_RETURN_IF_ERROR();

  g.g[0] = gemm_args(cat, C6, wfinal, C6, out, Cout, bfinal, mask, 1.f, P, Cout, C6);
  rc = launch_gemm(g, 1, stream);
  return rc;
}
