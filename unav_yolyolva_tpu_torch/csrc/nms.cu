// Merged class-masked Soft-NMS for Hopper: the port of the Pallas kernel
// `_kernel_classmasked` (unav_yolyolva_tpu/ops/pallas_nms.py).
//
// One block of 1024 threads per candidate row (a video); each thread keeps
// ITEMS candidates (index tid + 1024 * j) with their score and class in
// registers. Per step: a block-wide argmax (ties: lowest index, as
// jnp.argmax), the winner is emitted with its current score, same-class
// lanes decay by the Gaussian weight exp(-iou^2 / sigma) (IoU with the
// x2 - x1 + 1e-6 area epsilon) and die below min_score, the winner dies.
// A row with nothing alive emits -1 / 0 for the rest and stops early. Segments are read from
// device memory only for same-class lanes (~1% of them at 100 classes).
// Bound: latency, max_out dependent steps of two block barriers each; the
// candidate bytes are read once.
#include "common.cuh"

template <int ITEMS>
__global__ void __launch_bounds__(1024) msnms_kernel(
    const float* __restrict__ segs, const float* __restrict__ scores,
    const int* __restrict__ cls, int N, int max_out, float sigma,
    float min_score, int* __restrict__ out_idx,
    float* __restrict__ out_score) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ float best_s;
  __shared__ int best_i;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* seg = segs + (long)row * N * 2;
  int* oi = out_idx + (long)row * max_out;
  float* os = out_score + (long)row * max_out;

  float s[ITEMS];
  int c[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + 1024 * j;
    s[j] = i < N ? scores[(long)row * N + i] : -INFINITY;
    c[j] = i < N ? cls[(long)row * N + i] : -1;
  }

  for (int k = 0; k < max_out; ++k) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (s[j] > bs) { bs = s[j]; bi = tid + 1024 * j; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
      if (os_ > bs || (os_ == bs && oi_ < bi)) { bs = os_; bi = oi_; }
    }
    if (lane == 0) { red_s[warp] = bs; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
        if (os_ > bs || (os_ == bs && oi_ < bi)) { bs = os_; bi = oi_; }
      }
      if (lane == 0) { best_s = bs; best_i = bi; }
    }
    __syncthreads();
    bs = best_s;
    bi = best_i;
    if (bs == -INFINITY) {  // nothing alive: the rest of the row is empty
      for (int kk = k + tid; kk < max_out; kk += 1024) { oi[kk] = -1; os[kk] = 0.f; }
      return;
    }
    if (tid == 0) { oi[k] = bi; os[k] = bs; }
    const float sx1 = seg[2 * bi], sx2 = seg[2 * bi + 1];
    const int scls = cls[(long)row * N + bi];
    const float area_i = sx2 - sx1 + 1e-6f;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid + 1024 * j;
      if (s[j] == -INFINITY) continue;
      if (i == bi) { s[j] = -INFINITY; continue; }
      if (c[j] != scls) continue;  // other classes are untouched
      const float x1 = seg[2 * i], x2 = seg[2 * i + 1];
      const float inter = fmaxf(0.f, fminf(sx2, x2) - fmaxf(sx1, x1));
      const float iou = inter / (area_i + (x2 - x1 + 1e-6f) - inter);
      const float sn = s[j] * expf(-(iou * iou) / sigma);
      s[j] = sn < min_score ? -INFINITY : sn;
    }
  }
}

// segs (G, N, 2), scores (G, N) with -inf for invalid candidates, cls (G, N)
// int32. out_idx (G, max_out) int32 with -1 for empty slots, out_score
// (G, max_out). N <= 16384.
extern "C" int unav_multiclass_soft_nms(const float* segs, const float* scores,
                                        const int* cls, int G, int N, int max_out,
                                        float sigma, float min_score, int* out_idx,
                                        float* out_score, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  int items = 1;
  while (1024 * items < N) items *= 2;
  switch (items) {
#define UNAV_NMS_CASE(n) case n: msnms_kernel<n><<<G, 1024, 0, stream>>>( \
      segs, scores, cls, N, max_out, sigma, min_score, out_idx, out_score); break;
    UNAV_NMS_CASE(1) UNAV_NMS_CASE(2) UNAV_NMS_CASE(4) UNAV_NMS_CASE(8)
    UNAV_NMS_CASE(16)
#undef UNAV_NMS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  UNAV_RETURN_IF_ERROR();
  return 0;
}
