// The bf16 policy's products alone, for testing and timing them by
// themselves: bf16.cuh's (ops/gemm_tc.py:bf16_products, `count` products in
// one launch), the backward's strided product of bf16_bwd.cuh
// (bf16_layout_product) and the TBlock MLP's wgmma product of
// bf16_wgmma.cuh (mlp_product).
#include "bf16_wgmma.cuh"
#include "bf16_xgemm.cuh"

constexpr int BG_PTRS = 6, BG_INTS = 10;

// Per product i: ptrs[6i..6i+5] = A, B, C, bias, rowmask, seqmul (the last
// three may be null); ints[10i..10i+9] = lda, ldb, ldc, M, N, K, taps (1,
// or 3: the k=3 conv loader on A, Kc = K / 3), seq (rows per sequence of
// the conv and of seqmul), act (BF16_ACT_*), raw; scales[i] (a bf16 value).
extern "C" int unav_gemm_bf16(int count, void* const* ptrs, const long* ints,
                              const float* scales, void* stream) {
  if (count < 1 || count > BG_MAX_BATCH) return (int)cudaErrorInvalidValue;
  Bf16Batch batch;
  for (int i = 0; i < count; ++i) {
    void* const* p = ptrs + BG_PTRS * i;
    const long* n = ints + BG_INTS * i;
    Bf16Gemm& a = batch.g[i];
    a = bf16_gemm((const bf16*)p[0], n[0], (const bf16*)p[1], n[1], p[2], n[2],
                  (const bf16*)p[3], (const unsigned char*)p[4], (int)n[3], (int)n[4], (int)n[5]);
    a.seqmul = (const float*)p[5];
    a.taps = (int)n[6];
    a.seq = a.mseq = (int)n[7];
    a.act = (int)n[8];
    a.raw = (int)n[9];
    a.scale = scales[i];
    if (a.taps == 3) a.Kc = a.K / 3;
    if (a.act != BF16_ACT_NONE && a.act != BF16_ACT_GELU) return (int)cudaErrorInvalidValue;
  }
  return launch_gemm_bf16(batch, count, (cudaStream_t)stream);
}

// One xgemm (bf16_bwd.cuh) on contiguous row-major operands: layout 0 A (M,
// K) . B (N, K)^T, 1 A (M, K) . B (K, N), 2 A (K, M)^T . B (K, N); A bf16 or
// (a_f32) fp32, B bf16; K in blocks of kblock, rounded per block with
// round_blocks; C (M, N) fp32 (c_f32) or bf16 with the epilogue's scale.
extern "C" int unav_xgemm_bf16(int layout, int M, int N, int K, int kblock, int round_blocks,
                               const void* A, int a_f32, const bf16* B, void* C, int c_f32,
                               float scale, void* stream) {
  if (layout < 0 || layout > 2) return (int)cudaErrorInvalidValue;
  XGemm g = xgemm(M, N, K);
  if (layout == 2)
    xg_at(g, A, M, a_f32);
  else
    xg_a(g, A, K, a_f32);
  if (layout == 0)
    xg_bt(g, B, K);
  else
    xg_b(g, B, N);
  xg_c(g, C, N, c_f32);
  g.kblock = kblock;
  g.round_blocks = round_blocks;
  g.scale = scale;
  return launch_xgemm(g, (cudaStream_t)stream);
}

// One product of bf16_wgmma.cuh on row-major operands: layout 0 A (M, K) .
// B (N, K)^T, 1 A (M, K) . B (K, N), 2 A (K, M)^T . B (K, N) (K in blocks of
// kb rows, each rounded to bf16; 0: one block); epilogue epi (WG_*): C (ldc)
// bf16, or fp32 for WG_RAW and WG_RES; C2 a (WG_UA), aux u (WG_DU), both
// with C's row stride; bias, rowmask, seqmul (M / mseq, N) optional as the
// epilogue reads them.
extern "C" int unav_wgmma_bf16(int layout, int epi, int M, int N, int K, int kb, const bf16* A,
                               long lda, const bf16* B, long ldb, void* C, long ldc, bf16* C2,
                               const bf16* aux, const bf16* bias, const unsigned char* rowmask,
                               const float* seqmul, int mseq, void* stream) {
  WgProduct p = wg_product(A, lda, B, ldb, C, ldc, M, N, K);
  p.C2 = C2;
  p.aux = aux;
  p.bias = bias;
  p.rowmask = rowmask;
  p.seqmul = seqmul;
  p.mseq = mseq;
  p.kb = kb;
  const cudaStream_t s = (cudaStream_t)stream;
  if (layout == 0) {
    switch (epi) {
      case WG_RAW: return launch_wgmma_bf16<0, 0, WG_RAW>(p, s);
      case WG_STORE: return launch_wgmma_bf16<0, 0, WG_STORE>(p, s);
      case WG_GELU: return launch_wgmma_bf16<0, 0, WG_GELU>(p, s);
      case WG_UA: return launch_wgmma_bf16<0, 0, WG_UA>(p, s);
      case WG_RES: return launch_wgmma_bf16<0, 0, WG_RES>(p, s);
    }
  } else if (layout == 1) {
    switch (epi) {
      case WG_RAW: return launch_wgmma_bf16<0, 1, WG_RAW>(p, s);
      case WG_STORE: return launch_wgmma_bf16<0, 1, WG_STORE>(p, s);
      case WG_DU: return launch_wgmma_bf16<0, 1, WG_DU>(p, s);
    }
  } else if (layout == 2 && epi == WG_RAW) {
    return launch_wgmma_bf16<1, 1, WG_RAW>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
