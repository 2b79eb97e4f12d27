// Deterministic column sums over R*T rows: the bias, LayerNorm-affine,
// depthwise-tap and head-bias gradients of the backward kernels.
//
//   out[c * ostride] = sum_m  A(m + shift, c) * B(m, c) * rowmask[m]
//
// A is read at row m + shift within the same sequence (zero outside it; rows
// are (sequence, t) with t = m % seq), B and rowmask are optional. Several
// such sums ("jobs") run as one launch. Two passes, no atomics, a fixed
// order: pass 1 gives one partial per (job, 256-row chunk, column), summed
// by the 8 row lanes of a block in order; pass 2 adds the chunks in order.
// So two runs give the same bits. Bound: bytes (each input read once).
#pragma once

#include "common.cuh"

struct ColJob {
  const float* a; long lda;
  const float* b; long ldb;      // nullptr: B == 1
  const unsigned char* rowmask;  // nullptr: all rows
  float* out; long ostride;
  int shift;                     // -1, 0 or +1
  int M, C, seq;
};

constexpr int COL_MAX_JOBS = 20;
constexpr int COL_CHUNK = 256;   // rows per partial
struct ColBatch { ColJob j[COL_MAX_JOBS]; };

// grid (ceil(Cmax / 32), chunks, jobs), block (32, 8)
__global__ void __launch_bounds__(256) colsum_partial_kernel(const ColBatch batch,
                                                             float* __restrict__ partial,
                                                             int chunks, int cmax) {
  const ColJob& jb = batch.j[blockIdx.z];
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int m0 = blockIdx.y * COL_CHUNK;
  float s = 0.f;
  if (c < jb.C) {
    const int m1 = min(m0 + COL_CHUNK, jb.M);
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      if (jb.rowmask && !jb.rowmask[m]) continue;
      const int t = m % jb.seq + jb.shift;
      if (t < 0 || t >= jb.seq) continue;
      float v = jb.a[(long)(m + jb.shift) * jb.lda + c];
      if (jb.b) v *= jb.b[(long)m * jb.ldb + c];
      s += v;
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < jb.C) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    partial[((long)blockIdx.z * chunks + blockIdx.y) * cmax + c] = tot;
  }
}

// grid (ceil(Cmax / 256), jobs), 256 threads
__global__ void __launch_bounds__(256) colsum_final_kernel(const ColBatch batch,
                                                           const float* __restrict__ partial,
                                                           int chunks, int cmax) {
  const ColJob& jb = batch.j[blockIdx.y];
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= jb.C) return;
  const int used = (jb.M + COL_CHUNK - 1) / COL_CHUNK;
  float tot = 0.f;
  for (int i = 0; i < used; ++i) tot += partial[((long)blockIdx.y * chunks + i) * cmax + c];
  jb.out[(long)c * jb.ostride] = tot;
}

static ColJob col_job(const float* a, long lda, int M, int C, float* out) {
  ColJob j;
  j.a = a; j.lda = lda; j.b = nullptr; j.ldb = 0; j.rowmask = nullptr;
  j.out = out; j.ostride = 1; j.shift = 0; j.M = M; j.C = C; j.seq = 1;
  return j;
}

// floats of partial scratch that launch_colsum needs for rows M, columns C
static long colsum_scratch_floats(long M, long C) {
  return (long)COL_MAX_JOBS * ceil_div(M, COL_CHUNK) * C;
}

static int launch_colsum(const ColBatch& batch, int count, float* partial,
                         cudaStream_t stream) {
  int mmax = 1, cmax = 1;
  for (int i = 0; i < count; ++i) {
    mmax = std::max(mmax, batch.j[i].M);
    cmax = std::max(cmax, batch.j[i].C);
  }
  const int chunks = ceil_div(mmax, COL_CHUNK);
  colsum_partial_kernel<<<dim3(ceil_div(cmax, 32), chunks, count), dim3(32, 8), 0, stream>>>(
      batch, partial, chunks, cmax);
  UNAV_RETURN_IF_ERROR();
  colsum_final_kernel<<<dim3(ceil_div(cmax, 256), count), 256, 0, stream>>>(
      batch, partial, chunks, cmax);
  UNAV_RETURN_IF_ERROR();
  return 0;
}
