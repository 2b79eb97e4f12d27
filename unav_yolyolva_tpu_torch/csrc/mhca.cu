// C entry points of the MaskedMHCA kernels (see mhca.cuh).
#include "mhca.cuh"

extern "C" int unav_mhca_forward(const float* x1, const float* x2,
                                 const unsigned char* mask, int R, int T, int C,
                                 int heads, const float* dw, const float* lnw,
                                 const float* lnb, const float* w, const float* b,
                                 float eps, float* out, float* scratch, void* stream) {
  return mhca_forward_impl(x1, C, x2, C, mask, R, T, C, heads, dw, lnw, lnb, w, b,
                           eps, out, C, scratch, (cudaStream_t)stream);
}
