// Whole stride-1 TransformerBlock forward in bf16 for Hopper: the bf16
// instantiation (cdtype bfloat16) of the Pallas kernel `_tblock_kernel` /
// `_tblock_compute` (unav_yolyolva_tpu/ops/pallas_tblock.py). The residual
// stream x, the output and the branch multipliers are fp32; the LayerNorms
// store bf16, the MHCA and the MLP run on the bf16 kernels of bf16.cuh:
//   0. the block's dense weights cast to bf16 into scratch (one launch);
//   1. ln_pair_bf16_kernel: ln11, ln12 of x;
//   2-5. the bf16 MaskedMHCA (k/v from ln11, q from ln12);
//   6. residual_ln2_bf16_kernel: out = x * m + attn * mult_a (fp32), ln2;
//   7. fc1 with bias and exact erf GELU, bf16 in and out;
//   8. fc2 with bias and row mask, out += y * mult_m in fp32.
// Bound: operations (the MLP's products ~2/3 of the FLOPs at the stem). The
// MLP's two products run on bf16_wgmma.cuh (wgmma fed by TMA, persistent
// blocks, GELU and the residual tail in their epilogues); the MHCA and the
// glue as bf16.cuh has them.
#include "bf16_wgmma.cuh"

static long tblock_bf16_act_elems(int R, int T, int C, int Hd) {
  const long P = (long)R * T, PC = P * C;
  return std::max(mhca_bf16_scratch_elems(R, T, C), PC + P * Hd) + PC;
}

// bf16 elements of scratch unav_tblock_bf16_forward needs
extern "C" long unav_tblock_bf16_scratch(int R, int T, int C, int Hd) {
  return tblock_bf16_act_elems(R, T, C, Hd) + cast_elems(4L * C * C) + cast_elems(4L * C) +
         cast_elems((long)Hd * C) + cast_elems(Hd) + cast_elems((long)C * Hd) + cast_elems(C);
}

// x, out (R*T, C) fp32, mask (R*T) bool, mult_a / mult_m (R, C) fp32; the
// packed fp32 weights as TBlockWeights lists them (tblock.cuh).
extern "C" int unav_tblock_bf16_forward(const float* x, const unsigned char* mask, int R, int T,
                                        int C, int Hd, int heads, const float* mult_a,
                                        const float* mult_m, const float* lnw3,
                                        const float* lnb3, const float* dw, const float* lnw,
                                        const float* lnb, const float* w, const float* b,
                                        const float* w1, const float* b1, const float* w2,
                                        const float* b2, float eps, float* out, bf16* scratch,
                                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long P = (long)R * T, PC = P * C;
  bf16* attn = scratch + tblock_bf16_act_elems(R, T, C, Hd) - PC;
  bf16* next = attn + PC;
  CastList l;
  l.count = 0;
  const bf16* wb = cast_push(l, next, w, 4L * C * C);
  const bf16* bb = cast_push(l, next, b, 4L * C);
  const bf16* w1b = cast_push(l, next, w1, (long)Hd * C);
  const bf16* b1b = cast_push(l, next, b1, Hd);
  const bf16* w2b = cast_push(l, next, w2, (long)C * Hd);
  const bf16* b2b = cast_push(l, next, b2, C);
  int rc = launch_cast(l, s);
  if (rc) return rc;

  // ln11 / ln12 go into the MHCA's q/k/v region: only its first launch
  // reads them, and its second overwrites them (stream order)
  bf16* h1 = scratch + 3 * PC;
  bf16* h2 = h1 + PC;
  rc = with_cpl(C, [&](auto cpl) {
    ln_pair_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, P, C, lnw3, lnb3, eps, h1, h2);
  });
  if (rc) return rc;
  rc = mhca_bf16_forward_impl(h1, C, h2, C, mask, R, T, C, heads, dw, lnw, lnb, wb, bb, eps,
                              attn, C, scratch, s);
  if (rc) return rc;
  bf16* h = scratch;          // ln2 output
  bf16* hid = scratch + PC;   // GELU(fc1), (P, Hd)
  rc = with_cpl(C, [&](auto cpl) {
    residual_ln2_bf16_kernel<decltype(cpl)::value><<<ceil_div(P, 8), 256, 0, s>>>(
        x, mask, mult_a, attn, P, T, C, lnw3 + 2L * C, lnb3 + 2L * C, eps, out, h);
  });
  if (rc) return rc;
  WgProduct fc1 = wg_product(h, C, w1b, C, hid, Hd, (int)P, Hd, C);
  fc1.bias = b1b;
  if ((rc = launch_wgmma_bf16<0, 0, WG_GELU>(fc1, s))) return rc;
  WgProduct fc2 = wg_product(hid, Hd, w2b, Hd, out, C, (int)P, C, Hd);
  fc2.bias = b2b;
  fc2.rowmask = mask;
  fc2.seqmul = mult_m;
  fc2.mseq = T;
  rc = launch_wgmma_bf16<0, 0, WG_RES>(fc2, s);
  return rc;
}
