// C entry points of the bf16 MaskedMHCA backward (see bf16_bwd.cuh): the port
// of the Pallas kernel `_mhca_diff_bwd` (unav_yolyolva_tpu/ops/
// pallas_fusion.py) with bf16 inputs, form MHCA_HAND: the forward recomputed
// (conv + LN, q/k/v, the attention's output), then the backward's products,
// its fused attention backward, the LN and conv backward and one launch of
// the weight sums.
#include "bf16_bwd.cuh"

// floats of split scratch the four fp32 weight grads take (rows R * T)
static long mhca_hand_split_floats(int R, int T, int C) {
  XGemm wg = xgemm(C, C, R * T);
  xg_c(wg, nullptr, C, 1);
  return 4 * xgemm_split_floats(wg, xgemm_max_chunks(R));
}

static long mhca_bf16_bwd_bytes(int R, int T, int C, int H) {
  Bump b{nullptr, 0};
  b.take<bf16>(cast_elems(4L * C * C) + cast_elems(4L * C));
  mhca_bwd_bf16_buffers(b, R, T, C, H);
  b.take<float>(mhca_hand_split_floats(R, T, C));
  return b.used;
}

// floats of scratch unav_mhca_bf16_backward needs
extern "C" long unav_mhca_bf16_backward_scratch(int R, int T, int C, int heads) {
  return (mhca_bf16_bwd_bytes(R, T, C, heads) + 3) / 4;
}

// The grads of one bf16 forward for the upstream grad g (R*T, C) bf16: dx1,
// dx2 (R*T, C) bf16; fp32 gdw (3, C, 3), glnw / glnb (3, C), gw (4, C, C),
// gb (4, C). x1, x2 bf16; fp32 weights, cast to bf16 once here.
extern "C" int unav_mhca_bf16_backward(const bf16* x1, const bf16* x2, const unsigned char* mask,
                                       int R, int T, int C, int heads, const float* dw,
                                       const float* lnw, const float* lnb, const float* w,
                                       const float* b, float eps, const bf16* g, bf16* dx1,
                                       bf16* dx2, float* gdw, float* glnw, float* glnb, float* gw,
                                       float* gb, float* scratch, void* stream_) {
  const cudaStream_t s = (cudaStream_t)stream_;
  Bump bump{reinterpret_cast<char*>(scratch), 0};
  bf16* next = bump.take<bf16>(cast_elems(4L * C * C) + cast_elems(4L * C));
  CastList l;
  l.count = 0;
  const bf16* wb = cast_push(l, next, w, 4L * C * C);
  const bf16* bb = cast_push(l, next, b, 4L * C);
  if (const int rc = launch_cast(l, s)) return rc;
  const MhcaBwdBufs bu = mhca_bwd_bf16_buffers(bump, R, T, C, heads);
  const long split_floats = mhca_hand_split_floats(R, T, C);
  const XSplit split{bump.take<float>(split_floats), split_floats,
                      xgemm_max_chunks(R)};
  return mhca_bf16_backward(MHCA_HAND, x1, C, x2, C, mask, R, T, C, heads, dw, lnw, lnb, wb,
                            bb, eps, g, C, nullptr, 0, dx1, C, dx2, C,
                            MhcaGrads{gdw, glnw, glnb, gw, gb}, R, T, bu, true, nullptr, split,
                            s);
}

// The fused attention backward alone (launch_attn_bwd_bf16): q (scaled), k,
// v, go (R*T, C) bf16 in the MHCA's layout, heads of C / heads; form
// MHCA_HAND or MHCA_VJP; scale = bf16(1 / sqrt(d)). Writes dq, dk, dv (R*T,
// C) bf16; stat (R*heads*T*3 floats) gets each query row's softmax max, sum
// and D.
extern "C" int unav_attn_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* go,
                                  const unsigned char* mask, int R, int T, int C, int heads,
                                  int form, float scale, bf16* dq, bf16* dk, bf16* dv,
                                  float* stat, void* stream) {
  if (form != MHCA_HAND && form != MHCA_VJP) return (int)cudaErrorInvalidValue;
  return launch_attn_bwd_bf16(q, k, v, go, mask, R, T, C, heads, form == MHCA_VJP, scale, dq,
                              dk, dv, stat, (cudaStream_t)stream);
}
