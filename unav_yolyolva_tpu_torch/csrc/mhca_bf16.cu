// C entry points of the bf16 MaskedMHCA forward (see bf16.cuh) and of its
// attention alone.
#include "bf16.cuh"

// bf16 elements of scratch unav_mhca_bf16_forward needs: the forward's
// activations, then the bf16 dense weights and biases
extern "C" long unav_mhca_bf16_scratch(int R, int T, int C) {
  return mhca_bf16_scratch_elems(R, T, C) + cast_elems(4L * C * C) + cast_elems(4L * C);
}

// x1 (k/v source), x2 (q source), out (R*T, C) bf16; mask (R*T) bool;
// fp32 weights dw (3, C, 3), lnw / lnb (3, C), w (4, C, C), b (4, C).
extern "C" int unav_mhca_bf16_forward(const bf16* x1, const bf16* x2, const unsigned char* mask,
                                      int R, int T, int C, int heads, const float* dw,
                                      const float* lnw, const float* lnb, const float* w,
                                      const float* b, float eps, bf16* out, bf16* scratch,
                                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  CastList l;
  l.count = 0;
  bf16* next = scratch + mhca_bf16_scratch_elems(R, T, C);
  const bf16* wb = cast_push(l, next, w, 4L * C * C);
  const bf16* bb = cast_push(l, next, b, 4L * C);
  if (const int rc = launch_cast(l, s)) return rc;
  return mhca_bf16_forward_impl(x1, C, x2, C, mask, R, T, C, heads, dw, lnw, lnb, wb, bb, eps,
                                out, C, scratch, s);
}

// The attention alone (ops/fused_mhca.py:attention_forward): q (scaled by
// bf16(1/sqrt(d))), k, v, out (R*T, C) bf16, mask (R*T) bool.
extern "C" int unav_attn_bf16(const bf16* q, const bf16* k, const bf16* v,
                              const unsigned char* mask, int R, int T, int C, int heads,
                              bf16* out, void* stream) {
  return launch_attn_bf16(q, k, v, mask, R, T, C, heads, out, (cudaStream_t)stream);
}

// The attention's resident blocks a SM at this shape (occupancy calculator)
// into *blocks.
extern "C" int unav_attn_bf16_blocks_per_sm(int T, int C, int heads, int* blocks) {
  return launch_attn_bf16(nullptr, nullptr, nullptr, nullptr, 1, T, C, heads, nullptr, nullptr,
                          blocks);
}
