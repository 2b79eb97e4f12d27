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
// Bound: operations (FFMA, fp32 non-tensor peak); at T=224 the products
// are ~95% of the work.
#include "mhca.cuh"

constexpr int GATE_T = 32;   // frames per gate block (8 warps x 4)
constexpr int GATE_N = 128;  // guide tokens per shared-memory tile (32 lanes x 4)

// grid (ceil(T/32), H, R), 256 threads. p: slice 4 (row stride ldp);
// gp: (R, Ng, emb); dst: slice 5 (row stride ldd), multiplied in place.
__global__ void __launch_bounds__(256) gate_kernel(
    const float* __restrict__ p, long ldp, const float* __restrict__ gp,
    const float* __restrict__ battn, int T, int Ng, int emb, int H,
    float sqrt_hc, float* __restrict__ dst, long ldd, int och) {
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
        for (int i = 0; i < 4; ++i) mx[i] = fmaxf(mx[i], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m = warp_max(mx[i]);
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    const float gate = 1.f / (1.f + expf(-(m / sqrt_hc + battn[h])));
    float* row = dst + ((long)r * T + t) * ldd + h * och;
    for (int j = lane; j < och; j += 32) row[j] *= gate;
  }
}

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
  cudaStream_t stream = (cudaStream_t)stream_;
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
  const size_t smem = sizeof(float) * (GATE_T + GATE_N) * (hc + 1);
  cudaFuncSetAttribute(gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(ceil_div(T, GATE_T), attn_heads, R);
  gate_kernel<<<grid, 256, smem, stream>>>(
      cat + 4 * mid, C6, gp, battn, T, Ng, emb, attn_heads,
      (float)sqrt((double)hc), cat + 5 * mid, C6, mid / attn_heads);
  UNAV_RETURN_IF_ERROR();

  g.g[0] = gemm_args(cat, C6, wfinal, C6, out, Cout, bfinal, mask, 1.f, P, Cout, C6);
  return launch_gemm(g, 1, stream);
}
