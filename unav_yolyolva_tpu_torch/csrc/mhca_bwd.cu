// C entry points of the MaskedMHCA backward (see mhca_bwd.cuh).
#include "mhca_bwd.cuh"

// floats of scratch unav_mhca_backward needs
extern "C" long unav_mhca_backward_scratch(int R, int T, int C, int heads) {
  return mhca_saved_floats(R, T, C, heads) + mhca_backward_work_floats(R, T, C, heads);
}

// The grads of one forward for the upstream grad g (R*T, C): dx1, dx2
// (R*T, C), gdw (3, C, 3), glnw/glnb (3, C), gw (4, C, C), gb (4, C).
extern "C" int unav_mhca_backward(const float* x1, const float* x2,
                                  const unsigned char* mask, int R, int T, int C,
                                  int heads, const float* dw, const float* lnw,
                                  const float* lnb, const float* w, const float* b,
                                  float eps, const float* g, float* dx1, float* dx2,
                                  float* gdw, float* glnw, float* glnb, float* gw,
                                  float* gb, float* scratch, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const MhcaSaved sv = mhca_saved(scratch, R, T, C);
  const int rc = mhca_recompute(x1, C, x2, C, mask, R, T, C, heads, dw, lnw, lnb, w, b, eps,
                                sv, nullptr, 0, stream);
  if (rc) return rc;
  return mhca_backward_saved(x1, C, x2, C, mask, R, T, C, heads, dw, lnw, w, eps, sv, g, C,
                             dx1, C, dx2, C, 0, gdw, glnw, glnb, gw, gb,
                             scratch + mhca_saved_floats(R, T, C, heads), stream);
}
