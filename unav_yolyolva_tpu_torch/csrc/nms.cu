// Soft-NMS scans for Hopper: the ports of the Pallas kernels
// `_kernel_classmasked` (merged multiclass, Gaussian) and `_kernel`
// (single-class, hard / linear / Gaussian) of
// unav_yolyolva_tpu/ops/pallas_nms.py. One templated scan serves both.
//
// A row (one candidate set) belongs to TPR threads: a whole 1024-thread
// block for the long rows (a video's ~10^4 candidates), or one warp for
// rows of at most 1024 (the per-class buffers, thousands of rows: a block
// per row would leave most of its threads idle and pay two barriers a
// step). Each thread keeps ITEMS candidates (index tid + TPR * j) with
// their score (and class) in registers; a warp row keeps its segments in
// registers too. Per step: a row-wide argmax (ties: lowest index, as
// jnp.argmax), the winner is emitted with its current score, the other
// live lanes (of the winner's class, when classed) are multiplied by the
// method's weight (0 hard: iou < thr; 1 linear: 1 - iou above thr; 2
// Gaussian: exp(-iou^2 / sigma); IoU with the x2 - x1 + 1e-6 area epsilon)
// and die below min_score, the winner dies. A row with nothing alive emits
// -1 / 0 for the rest and stops early. Bound: latency, max_out dependent
// steps; the candidate bytes are read once (a block row re-reads segments
// from L1/L2).
#include "common.cuh"

template <int TPR, int ITEMS, bool CLASSED>
__global__ void __launch_bounds__(TPR == 32 ? 128 : 1024) nms_scan_kernel(
    const float* __restrict__ segs, const float* __restrict__ scores,
    const int* __restrict__ cls, int G, int N, int max_out, int method, float iou_threshold,
    float sigma, float min_score, int* __restrict__ out_idx, float* __restrict__ out_score) {
  constexpr bool SEGREG = TPR == 32;
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ float best_s;
  __shared__ int best_i;
  const int tid = TPR == 32 ? threadIdx.x & 31 : threadIdx.x;
  const int row = TPR == 32 ? blockIdx.x * 4 + (threadIdx.x >> 5) : blockIdx.x;
  if (row >= G) return;  // a whole warp row: no block barrier in that mode
  const int lane = threadIdx.x & 31, warp = tid >> 5;
  const float* seg = segs + (long)row * N * 2;
  int* oi = out_idx + (long)row * max_out;
  float* os = out_score + (long)row * max_out;

  float s[ITEMS];
  int c[CLASSED ? ITEMS : 1];
  float x1r[SEGREG ? ITEMS : 1], x2r[SEGREG ? ITEMS : 1];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + TPR * j;
    s[j] = i < N ? scores[(long)row * N + i] : -INFINITY;
    if (CLASSED) c[j] = i < N ? cls[(long)row * N + i] : -1;
    if (SEGREG) {
      x1r[j] = i < N ? seg[2 * i] : 0.f;
      x2r[j] = i < N ? seg[2 * i + 1] : 0.f;
    }
  }

  for (int k = 0; k < max_out; ++k) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (s[j] > bs) { bs = s[j]; bi = tid + TPR * j; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os_ = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi_ = __shfl_down_sync(0xffffffffu, bi, off);
      if (os_ > bs || (os_ == bs && oi_ < bi)) { bs = os_; bi = oi_; }
    }
    if (TPR == 32) {
      bs = __shfl_sync(0xffffffffu, bs, 0);
      bi = __shfl_sync(0xffffffffu, bi, 0);
    } else {
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
    }
    if (bs == -INFINITY) {  // nothing alive: the rest of the row is empty
      for (int kk = k + tid; kk < max_out; kk += TPR) { oi[kk] = -1; os[kk] = 0.f; }
      return;
    }
    if (tid == 0) { oi[k] = bi; os[k] = bs; }
    const float sx1 = seg[2 * bi], sx2 = seg[2 * bi + 1];
    const int scls = CLASSED ? cls[(long)row * N + bi] : 0;
    const float area_i = sx2 - sx1 + 1e-6f;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid + TPR * j;
      if (s[j] == -INFINITY) continue;
      if (i == bi) { s[j] = -INFINITY; continue; }
      if (CLASSED && c[j] != scls) continue;  // other classes are untouched
      const float x1 = SEGREG ? x1r[j] : seg[2 * i], x2 = SEGREG ? x2r[j] : seg[2 * i + 1];
      const float inter = fmaxf(0.f, fminf(sx2, x2) - fmaxf(sx1, x1));
      const float iou = inter / (area_i + (x2 - x1 + 1e-6f) - inter);
      float wgt;
      if (method == 0) wgt = iou < iou_threshold ? 1.f : 0.f;
      else if (method == 1) wgt = iou >= iou_threshold ? 1.f - iou : 1.f;
      else wgt = expf(-(iou * iou) / sigma);
      const float sn = s[j] * wgt;
      s[j] = sn < min_score ? -INFINITY : sn;
    }
  }
}

// segs (G, N, 2), scores (G, N) with -inf for invalid candidates, cls (G, N)
// int32. out_idx (G, max_out) int32 with -1 for empty slots, out_score
// (G, max_out). Gaussian weights, same-class decay only. N <= 16384.
extern "C" int unav_multiclass_soft_nms(const float* segs, const float* scores,
                                        const int* cls, int G, int N, int max_out,
                                        float sigma, float min_score, int* out_idx,
                                        float* out_score, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  int items = 1;
  while (1024 * items < N) items *= 2;
  switch (items) {
#define UNAV_NMS_CASE(n) case n: nms_scan_kernel<1024, n, true><<<G, 1024, 0, stream>>>( \
      segs, scores, cls, G, N, max_out, 2, 0.f, sigma, min_score, out_idx, out_score); break;
    UNAV_NMS_CASE(1) UNAV_NMS_CASE(2) UNAV_NMS_CASE(4) UNAV_NMS_CASE(8)
    UNAV_NMS_CASE(16)
#undef UNAV_NMS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// Single-class scan of G independent rows: segs (G, N, 2), scores (G, N)
// with -inf for invalid candidates; method 0 hard, 1 linear, 2 Gaussian;
// every live lane is decayed and killed below min_score. Outputs as above.
// Rows of N <= 1024 run one warp each (4 per block), longer rows a block
// each. N <= 16384.
extern "C" int unav_soft_nms(const float* segs, const float* scores, int G, int N,
                             int max_out, int method, float iou_threshold, float sigma,
                             float min_score, int* out_idx, float* out_score, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (method < 0 || method > 2) return (int)cudaErrorInvalidValue;
  int items = 1;
  if (N <= 1024) {
    while (32 * items < N) items *= 2;
    switch (items) {
#define UNAV_WNMS_CASE(n) case n: nms_scan_kernel<32, n, false><<<ceil_div(G, 4), 128, 0, \
      stream>>>(segs, scores, nullptr, G, N, max_out, method, iou_threshold, sigma, min_score, \
                out_idx, out_score); break;
      UNAV_WNMS_CASE(1) UNAV_WNMS_CASE(2) UNAV_WNMS_CASE(4) UNAV_WNMS_CASE(8)
      UNAV_WNMS_CASE(16) UNAV_WNMS_CASE(32)
#undef UNAV_WNMS_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    while (1024 * items < N) items *= 2;
    switch (items) {
#define UNAV_BNMS_CASE(n) case n: nms_scan_kernel<1024, n, false><<<G, 1024, 0, stream>>>( \
      segs, scores, nullptr, G, N, max_out, method, iou_threshold, sigma, min_score, out_idx, \
      out_score); break;
      UNAV_BNMS_CASE(1) UNAV_BNMS_CASE(2) UNAV_BNMS_CASE(4) UNAV_BNMS_CASE(8)
      UNAV_BNMS_CASE(16)
#undef UNAV_BNMS_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
  UNAV_RETURN_IF_ERROR();
  return 0;
}
