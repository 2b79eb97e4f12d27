// The max-sigmoid gate of the CSP layer, shared by its forward (csp.cu)
// and its backward's recompute (csp_bwd.cu). Its scores (R * T * Ng * emb
// products a layer) stay fp32 FFMA: ties between guide tokens are decided
// on these exact values, by the forward and by the backward's routing.
#pragma once

#include "mhca.cuh"

constexpr int GATE_T = 32;   // frames per gate block (8 warps x 4)
constexpr int GATE_N = 128;  // guide tokens per shared-memory tile (32 lanes x 4)

static size_t gate_smem_bytes(int hc) { return sizeof(float) * (GATE_T + GATE_N) * (hc + 1); }

// grid (ceil(T/32), H, R), 256 threads. p: slice 4 (row stride ldp);
// gp: (R, Ng, emb); dst: slice 5 (row stride ldd), multiplied in place.
// STATS (the backward's recompute only): also writes, per (row, head,
// frame) at ((r * H + h) * T + t), the max score mxo, how many tokens reach
// it cnto and the first that does idxo, for gate_bwd_kernel.
template <bool STATS>
__global__ void __launch_bounds__(256) gate_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp,
    const float* __restrict__ battn, int T, int Ng, int emb, int H,
    float sqrt_hc, float* __restrict__ dst, long ldd, int och, float* __restrict__ mxo,
    int* __restrict__ idxo, int* __restrict__ cnto) {
  extern __shared__ float sm[];
  const int hc = emb / H, hp = hc + 1;
  float* Ps = sm;                 // GATE_T x hp
  float* Gs = sm + GATE_T * hp;   // GATE_N x hp
  const int r = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * GATE_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < GATE_T * hc; e += 256) {
    const int i = e / hc, c = e - i * hc, t = t0 + i;
    Ps[i * hp + c] = t < T ? p[((long)r * T + t) * ldp + h * hc + c] : 0.f;
  }
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int cnt[4] = {0, 0, 0, 0}, idx[4] = {Ng, Ng, Ng, Ng};
  for (int n0 = 0; n0 < Ng; n0 += GATE_N) {
    __syncthreads();
    for (int e = tid; e < GATE_N * hc; e += 256) {
      const int i = e / hc, c = e - i * hc, n = n0 + i;
      Gs[i * hp + c] = n < Ng ? gp[((long)r * Ng + n) * emb + h * hc + c] : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int c = 0; c < hc; ++c) {
      float pv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(warp * 4 + i) * hp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = Gs[(lane + 32 * j) * hp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], gv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + lane + 32 * j < Ng)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!STATS) {
            mx[i] = fmaxf(mx[i], acc[i][j]);
          } else if (acc[i][j] > mx[i]) {
            mx[i] = acc[i][j]; cnt[i] = 1; idx[i] = n0 + lane + 32 * j;
          } else if (acc[i][j] == mx[i]) {
            ++cnt[i];
          }
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (STATS) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[i], off);
        const int oc = __shfl_xor_sync(0xffffffffu, cnt[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
        if (om > mx[i]) {
          mx[i] = om; cnt[i] = oc; idx[i] = oi;
        } else if (om == mx[i]) {
          cnt[i] += oc; idx[i] = min(idx[i], oi);
        }
      }
    }
    const float m = STATS ? mx[i] : warp_max(mx[i]);
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    if (STATS && lane == 0) {
      const long st = ((long)r * H + h) * T + t;
      mxo[st] = m; cnto[st] = cnt[i]; idxo[st] = idx[i];
    }
    const float gate = 1.f / (1.f + expf(-(m / sqrt_hc + battn[h])));
    float* row = dst + ((long)r * T + t) * ldd + h * och;
    for (int j = lane; j < och; j += 32) row[j] *= gate;
  }
}
