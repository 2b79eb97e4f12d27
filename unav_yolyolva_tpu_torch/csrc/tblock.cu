// C entry points of the whole-TransformerBlock forward (see tblock.cuh).
#include "tblock.cuh"

// floats of scratch unav_tblock_forward needs
extern "C" long unav_tblock_forward_scratch(int R, int T, int C, int Hd) {
  return tblock_forward_scratch_floats(R, T, C, Hd);
}

// x (R*T, C), mask (R*T) bool, mult_a / mult_m (R, C); the weights as
// TBlockWeights lists them; out (R*T, C).
extern "C" int unav_tblock_forward(const float* x, const unsigned char* mask, int R, int T, int C,
                                   int Hd, int heads, const float* mult_a, const float* mult_m,
                                   const float* lnw3, const float* lnb3, const float* dw,
                                   const float* lnw, const float* lnb, const float* w,
                                   const float* b, const float* w1, const float* b1,
                                   const float* w2, const float* b2, float eps, float* out,
                                   float* scratch, void* stream) {
  return tblock_forward_impl(x, mask, R, T, C, Hd, heads, mult_a, mult_m,
                             TBlockWeights{lnw3, lnb3, dw, lnw, lnb, w, b, w1, b1, w2, b2}, eps,
                             out, scratch, (cudaStream_t)stream);
}
