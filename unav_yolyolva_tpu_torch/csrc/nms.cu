// Soft-NMS scans for Hopper: the ports of the Pallas kernels
// `_kernel_classmasked` (merged multiclass, Gaussian; the eval main path)
// and `_kernel` (single-class, hard / linear / Gaussian) of
// unav_yolyolva_tpu/ops/pallas_nms.py.
//
// Both scans run max_out dependent steps: argmax (ties: lowest index, as
// jnp.argmax), emit the winner with its current score, multiply the other
// live lanes (of the winner's class, when classed) by the method's weight
// (0 hard: iou < thr; 1 linear: 1 - iou from thr on; 2 Gaussian:
// exp(-iou^2 / sigma); IoU with the x2 - x1 + 1e-6 area epsilon), kill
// them below min_score and kill the winner. A row with nothing alive
// emits -1 / 0 for the rest and stops early. The candidates are read once,
// at setup (10.4 MB for 64 rows of 10100: 3 us of bytes); what bounds a
// row is its dependent steps times the latency of one step. So each design
// makes a step cost what changes at that step, not N, and keeps the
// divisions off a step's path where it can: a lane that does not overlap
// the winner has IoU exactly +-0, whose weight is taken once per kernel
// (the same bits; a zero dividend would send both IEEE divisions down
// their slow path).
//
// Merged scan (merged_nms_kernel, one 1024-thread block per row). Classes
// never interact, so the global argmax is the argmax over the heads of the
// classes (a class's best lane), and a step changes only the winner's
// class. Setup loads the row once into registers, drops the dead lanes,
// buckets the live ones by cls mod NB (NB = 128; any class values, C > NB
// included: a bucket that holds two classes is flagged, and then its lanes
// compare their class, read through L2) with a counting sort in shared
// memory, and takes each bucket's head. Shared memory holds each lane's
// segment (8 B), score (4 B) and original index (2 B): 14 B x N, 229,376
// B at N = 16384, beside 2.7 KB of heads, offsets and partials. A step
// belongs to a group of GROUP = 128 threads that keep the 128 heads in
// registers: the argmax over them (two redux.sync passes over a key of the
// order-preserving score bits and the inverted original index, so ties go
// to the lowest index whatever the order inside a bucket), one pass of the
// group over the winner's bucket (one lane a thread at ~101 lanes a bucket)
// that decays and keeps each thread's next best, and one named barrier
// (the partials double-buffered, each warp reducing them itself). Nothing
// is read from global memory. Only a bucket of more than SMALL_BUCKET
// lanes (one class holding much of the row) takes the whole block: every
// thread decays a strided share, two block barriers.
//
// Single-class scan (soft_nms_kernel<TPR, ITEMS>). A row first compacts
// its live lanes, in order (ballot + popc in a warp, a scan of the 32 warp
// counts for a block row), with their segments (8 B) and original indices
// (2 B) in shared memory; the scores sit in registers, slot j of thread t
// holding compacted lane t + TPR j. Every step walks ceil(n_live / TPR)
// slots, not N / TPR (per-class buffers: ~101 live of 1024), and a single
// pass both decays and yields each thread's next best, so the argmax needs
// no second walk. Compacted order is original order, so ties go to the
// lowest compacted position, mapped back to the original index on
// emission. Rows of N <= 1024 run a warp each (4 per block, no barrier at
// all; at most 96 registers, so that five blocks fit an SM); longer rows a
// 1024-thread block with one barrier a step (the warps' partial argmaxes,
// double-buffered, are reduced by every warp itself).
#include "common.cuh"

namespace {

constexpr int NB = 128;             // class buckets of the merged scan
constexpr int MERGED_THREADS = 1024;
constexpr int GROUP = 128;          // threads that take a small bucket's step
constexpr int SMALL_BUCKET = 256;   // the largest bucket the group takes
constexpr int MAX_N = 16384;        // 14-bit indices; 14 B x N of shared memory

// Order-preserving bits of a live score (either zero as +0); 0 marks dead.
__device__ __forceinline__ unsigned score_key(float s) {
  if (s == -INFINITY) return 0u;
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned h) {
  return __uint_as_float((h & 0x80000000u) ? (h & 0x7fffffffu) : ~h);
}

// Barrier 1 for the first GROUP threads alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(GROUP) : "memory");
}

// Lexicographic (hi, lo) max over the warp, left in every lane; returns the
// lane that held it. Dead entries are (0, 0).
__device__ __forceinline__ int warp_argmax(unsigned& hi, unsigned& lo) {
  const unsigned h = __reduce_max_sync(0xffffffffu, hi);
  const unsigned l = __reduce_max_sync(0xffffffffu, hi == h ? lo : 0u);
  const int src = __ffs(__ballot_sync(0xffffffffu, hi == h && lo == l)) - 1;
  hi = h;
  lo = l;
  return src;
}

// The method's weight at IoU `iou`, as in the Pallas kernels.
template <int METHOD>
__device__ __forceinline__ float weight(float iou, int method, float thr, float sigma) {
  const int m = METHOD >= 0 ? METHOD : method;
  if (m == 0) return iou < thr ? 1.f : 0.f;
  if (m == 1) return iou >= thr ? 1.f - iou : 1.f;
  return expf(-(iou * iou) / sigma);
}

// The decayed score, or -inf below min_score. A lane that does not overlap
// the winner has IoU exactly +-0, whose weight w0 = weight(0) is taken
// once per kernel: the same bits without the two divisions (a zero
// dividend sends an IEEE division down its slow path).
template <int METHOD>
__device__ __forceinline__ float decayed(float s, float x1, float x2, float sx1, float sx2,
                                         float area_i, int method, float thr, float sigma,
                                         float min_score, float w0) {
  const float inter = fmaxf(0.f, fminf(sx2, x2) - fmaxf(sx1, x1));
  const float den = area_i + (x2 - x1 + 1e-6f) - inter;
  const float w = inter == 0.f && den > 0.f ? w0
                                            : weight<METHOD>(inter / den, method, thr, sigma);
  const float sn = s * w;
  return sn < min_score ? -INFINITY : sn;
}

// One pass over the winner's bucket [p0, p1) in steps of `stride`: kill the
// winner, decay the lanes of its class, and keep this thread's best
// (key, position) of what stays alive.
__device__ __forceinline__ void decay_bucket(float* bs, const float2* bseg,
                                             const unsigned short* bidx, int p0, int p1,
                                             int stride, int wpos, float2 wseg, bool mixed,
                                             const int* crow, int wcls, float sigma,
                                             float min_score, float w0, unsigned& bh,
                                             unsigned& bl, int& bp) {
  const float area_i = wseg.y - wseg.x + 1e-6f;
  bh = bl = 0u;
  bp = 0;
#pragma unroll 4
  for (int p = p0; p < p1; p += stride) {
    float s = bs[p];
    if (s == -INFINITY) continue;
    if (p == wpos) {
      bs[p] = -INFINITY;
      continue;
    }
    const int i = bidx[p];
    if (!mixed || crow[i] == wcls) {
      const float2 x = bseg[p];
      s = decayed<2>(s, x.x, x.y, wseg.x, wseg.y, area_i, 2, 0.f, sigma, min_score, w0);
      bs[p] = s;
    }
    const unsigned h = score_key(s), l = ~(unsigned)i;
    if (h && (h > bh || (h == bh && l > bl))) {
      bh = h;
      bl = l;
      bp = p;
    }
  }
}

__global__ void __launch_bounds__(MERGED_THREADS) merged_nms_kernel(
    const float* __restrict__ segs, const float* __restrict__ scores,
    const int* __restrict__ cls, int N, int max_out, float sigma, float min_score,
    int* __restrict__ out_idx, float* __restrict__ out_score) {
  constexpr int HEADS = NB / 32;                    // heads a lane holds
  constexpr int SETUP = MAX_N / MERGED_THREADS;     // candidates a thread loads
  extern __shared__ __align__(16) unsigned char smem[];
  float2* bseg = reinterpret_cast<float2*>(smem);                        // N
  float* bs = reinterpret_cast<float*>(bseg + N);                         // N
  unsigned short* bidx = reinterpret_cast<unsigned short*>(bs + N);       // N
  __shared__ unsigned head_hi[NB], head_lo[NB];
  __shared__ int off[NB + 1];
  __shared__ unsigned short head_pos[NB];
  __shared__ unsigned char mixed[NB];
  __shared__ unsigned part_hi[2][32], part_lo[2][32];
  __shared__ int part_pos[2][32];
  __shared__ unsigned sh_hi, sh_lo;
  __shared__ int sh_k, sh_b, sh_pos;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, row = blockIdx.x;
  const float* srow = scores + (long)row * N;
  const int* crow = cls + (long)row * N;
  const float* grow = segs + (long)row * N * 2;
  int* oi = out_idx + (long)row * max_out;
  float* os = out_score + (long)row * max_out;

  // ---- setup: counting sort of the live lanes into the buckets ----------
  int* cnt = reinterpret_cast<int*>(head_hi);     // the head arrays serve
  int* cls_of = reinterpret_cast<int*>(head_lo);  // as scratch until the heads
  for (int b = tid; b < NB; b += MERGED_THREADS) { cnt[b] = 0; mixed[b] = 0; }
  float sv[SETUP];
  int cv[SETUP];
#pragma unroll
  for (int j = 0; j < SETUP; ++j) {                // every load in flight at once
    const int i = tid + MERGED_THREADS * j;
    sv[j] = i < N ? srow[i] : -INFINITY;
    cv[j] = i < N ? crow[i] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SETUP; ++j)
    if (sv[j] > -INFINITY) {
      atomicAdd(&cnt[cv[j] & (NB - 1)], 1);
      cls_of[cv[j] & (NB - 1)] = cv[j];            // any one class of the bucket
    }
  __syncthreads();
  if (warp == 0) {                                 // exclusive scan: offsets, cursors
    int v[HEADS], sum = 0;
#pragma unroll
    for (int t = 0; t < HEADS; ++t) { v[t] = cnt[lane * HEADS + t]; sum += v[t]; }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    int run = incl - sum;
#pragma unroll
    for (int t = 0; t < HEADS; ++t) {
      off[lane * HEADS + t] = run;
      cnt[lane * HEADS + t] = run;
      run += v[t];
    }
    if (lane == 31) off[NB] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SETUP; ++j) {
    const int i = tid + MERGED_THREADS * j;
    if (sv[j] > -INFINITY) {
      const int c = cv[j], b = c & (NB - 1);
      if (c != cls_of[b]) mixed[b] = 1;
      const int p = atomicAdd(&cnt[b], 1);
      bseg[p] = make_float2(grow[2 * i], grow[2 * i + 1]);
      bs[p] = sv[j];
      bidx[p] = (unsigned short)i;
    }
  }
  __syncthreads();
  for (int b = warp; b < NB; b += 32) {            // each bucket's head
    unsigned bh = 0u, bl = 0u;
    int bp = 0;
    for (int p = off[b] + lane; p < off[b + 1]; p += 32) {
      const unsigned h = score_key(bs[p]), l = ~(unsigned)bidx[p];
      if (h > bh || (h == bh && l > bl)) { bh = h; bl = l; bp = p; }
    }
    bp = __shfl_sync(0xffffffffu, bp, warp_argmax(bh, bl));
    if (lane == 0) { head_hi[b] = bh; head_lo[b] = bl; head_pos[b] = (unsigned short)bp; }
  }
  __syncthreads();

  // ---- steps ---------------------------------------------------------------
  const float w0 = weight<2>(0.f, 2, 0.f, sigma);
  int k = 0;
  for (;;) {
    if (tid < GROUP) {    // the group takes the small buckets, heads in its registers
      group_sync();       // the heads a block step wrote are visible
      unsigned rh[HEADS], rl[HEADS];
      int rp[HEADS];
#pragma unroll
      for (int t = 0; t < HEADS; ++t) {
        rh[t] = head_hi[lane + 32 * t];
        rl[t] = head_lo[lane + 32 * t];
        rp[t] = head_pos[lane + 32 * t];
      }
      unsigned hi = 0u, lo = 0u;
      int b = 0, wpos = 0;
      for (; k < max_out; ++k) {
        hi = lo = 0u;
#pragma unroll
        for (int t = 0; t < HEADS; ++t)
          if (rh[t] > hi || (rh[t] == hi && rl[t] > lo)) {
            hi = rh[t]; lo = rl[t]; b = lane + 32 * t; wpos = rp[t];
          }
        const int src = warp_argmax(hi, lo);
        b = __shfl_sync(0xffffffffu, b, src);
        wpos = __shfl_sync(0xffffffffu, wpos, src);
        if (hi == 0u || off[b + 1] - off[b] > SMALL_BUCKET) break;
        const int wcls = mixed[b] ? crow[~lo] : 0;
        unsigned bh, bl;
        int bp;
        decay_bucket(bs, bseg, bidx, off[b] + tid, off[b + 1], GROUP, wpos, bseg[wpos],
                     mixed[b], crow, wcls, sigma, min_score, w0, bh, bl, bp);
        bp = __shfl_sync(0xffffffffu, bp, warp_argmax(bh, bl));
        const int buf = k & 1;                      // double-buffered: one barrier a step
        if (lane == 0) { part_hi[buf][warp] = bh; part_lo[buf][warp] = bl; part_pos[buf][warp] = bp; }
        group_sync();
        const bool mine = lane < GROUP / 32;        // every warp reduces the partials itself
        bh = mine ? part_hi[buf][lane] : 0u;
        bl = mine ? part_lo[buf][lane] : 0u;
        bp = __shfl_sync(0xffffffffu, mine ? part_pos[buf][lane] : 0, warp_argmax(bh, bl));
#pragma unroll
        for (int t = 0; t < HEADS; ++t)
          if (lane + 32 * t == b) { rh[t] = bh; rl[t] = bl; rp[t] = bp; }
        if (tid == 0) {                             // shared copy, for a later block step
          head_hi[b] = bh;
          head_lo[b] = bl;
          head_pos[b] = (unsigned short)bp;
          oi[k] = (int)~lo;
          os[k] = key_score(hi);
        }
      }
      if (tid == 0) { sh_k = k; sh_hi = hi; sh_lo = lo; sh_b = b; sh_pos = wpos; }
    }
    __syncthreads();
    k = sh_k;
    if (k >= max_out) return;
    const unsigned hi = sh_hi, lo = sh_lo;
    const int b = sh_b, wpos = sh_pos;
    if (hi == 0u) {                                 // nothing alive: the rest is empty
      for (int kk = k + tid; kk < max_out; kk += MERGED_THREADS) { oi[kk] = -1; os[kk] = 0.f; }
      return;
    }
    // a large bucket: the whole block decays it
    const int wcls = mixed[b] ? crow[~lo] : 0;
    unsigned bh, bl;
    int bp;
    decay_bucket(bs, bseg, bidx, off[b] + tid, off[b + 1], MERGED_THREADS, wpos, bseg[wpos],
                 mixed[b], crow, wcls, sigma, min_score, w0, bh, bl, bp);
    bp = __shfl_sync(0xffffffffu, bp, warp_argmax(bh, bl));
    if (lane == 0) { part_hi[0][warp] = bh; part_lo[0][warp] = bl; part_pos[0][warp] = bp; }
    __syncthreads();
    if (warp == 0) {
      bh = part_hi[0][lane];
      bl = part_lo[0][lane];
      bp = __shfl_sync(0xffffffffu, part_pos[0][lane], warp_argmax(bh, bl));
      if (lane == 0) {
        head_hi[b] = bh;
        head_lo[b] = bl;
        head_pos[b] = (unsigned short)bp;
        oi[k] = (int)~lo;
        os[k] = key_score(hi);
      }
    }
    ++k;
  }
}

template <int TPR, int ITEMS>
__global__ void __launch_bounds__(TPR == 32 ? 128 : 1024, TPR == 32 ? 5 : 1) soft_nms_kernel(
    const float* __restrict__ segs, const float* __restrict__ scores, int G, int N,
    int max_out, int method, float iou_threshold, float sigma, float min_score,
    int* __restrict__ out_idx, float* __restrict__ out_score) {
  constexpr int ROWS = TPR == 32 ? 4 : 1;          // rows per block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned part_hi[2][32], part_lo[2][32];
  __shared__ int wcount[2][32];
  const int lane = threadIdx.x & 31;
  const int tid = TPR == 32 ? lane : threadIdx.x, warp = tid >> 5;
  const int slot = TPR == 32 ? threadIdx.x >> 5 : 0;
  const int row = blockIdx.x * ROWS + slot;
  if (row >= G) return;  // a whole warp row: no block barrier in that mode
  float2* cseg = reinterpret_cast<float2*>(smem) + (long)slot * N;
  unsigned short* cidx = reinterpret_cast<unsigned short*>(
      reinterpret_cast<float2*>(smem) + (long)ROWS * N) + (long)slot * N;
  const float* srow = scores + (long)row * N;
  const float* grow = segs + (long)row * N * 2;
  int* oi = out_idx + (long)row * max_out;
  float* os = out_score + (long)row * max_out;

  // ---- compact the live lanes, in order -------------------------------------
  const unsigned lt = (1u << lane) - 1u;
  int n_live = 0, buf = 0;
  for (int c = 0; c < N; c += TPR) {
    const int i = c + tid;
    const bool live = i < N && srow[i] > -INFINITY;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    int pos = n_live + __popc(m & lt);
    if (TPR == 32) {
      n_live += __popc(m);
    } else {
      if (lane == 0) wcount[buf][warp] = __popc(m);
      __syncthreads();
      const int cw = wcount[buf][lane];
      int incl = cw;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      pos += __shfl_sync(0xffffffffu, incl - cw, warp);
      n_live += __shfl_sync(0xffffffffu, incl, 31);
      buf ^= 1;
    }
    if (live) {
      cseg[pos] = make_float2(grow[2 * i], grow[2 * i + 1]);
      cidx[pos] = (unsigned short)i;
    }
  }
  if (TPR == 32) __syncwarp(); else __syncthreads();

  const int nslots = (n_live + TPR - 1) / TPR;
  float s[ITEMS];
  unsigned bh = 0u, bl = 0u;                        // this thread's best
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = tid + TPR * j;
    s[j] = q < n_live ? srow[cidx[q]] : -INFINITY;
    const unsigned h = score_key(s[j]);
    if (h > bh) { bh = h; bl = ~(unsigned)q; }      // slots rise with q: first max kept
  }

  // ---- steps: argmax, emit, one decay pass that also finds the next best ----
  const float w0 = weight<-1>(0.f, method, iou_threshold, sigma);
  int k = 0;
  for (; k < max_out; ++k) {
    unsigned hi = bh, lo = bl;
    warp_argmax(hi, lo);
    if (TPR != 32) {
      if (lane == 0) { part_hi[k & 1][warp] = hi; part_lo[k & 1][warp] = lo; }
      __syncthreads();
      hi = part_hi[k & 1][lane];
      lo = part_lo[k & 1][lane];
      warp_argmax(hi, lo);
    }
    if (hi == 0u) break;
    const int wq = (int)~lo;
    const float2 w = cseg[wq];
    if (tid == 0) { oi[k] = cidx[wq]; os[k] = key_score(hi); }
    const float area_i = w.y - w.x + 1e-6f;
    bh = bl = 0u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (j >= nslots) break;
      const int q = tid + TPR * j;
      if (s[j] != -INFINITY) {
        if (q == wq) {
          s[j] = -INFINITY;
        } else {
          const float2 x = cseg[q];
          s[j] = decayed<-1>(s[j], x.x, x.y, w.x, w.y, area_i, method, iou_threshold, sigma,
                             min_score, w0);
        }
      }
      const unsigned h = score_key(s[j]);
      if (h > bh) { bh = h; bl = ~(unsigned)q; }
    }
  }
  for (int kk = k + tid; kk < max_out; kk += TPR) { oi[kk] = -1; os[kk] = 0.f; }
}

using SoftFn = void (*)(const float*, const float*, int, int, int, int, float, float, float,
                        int*, float*);

// Dynamic shared memory above 48 KB is allowed once per kernel: the
// helper's static holds the limit set so far, one per instantiation.
template <auto F>
void ensure_smem(int bytes) {
  static int limit = 0;
  if (bytes > 48 * 1024 && bytes > limit) {
    cudaFuncSetAttribute((const void*)F, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    limit = bytes;
  }
}

// The instantiation, block, rows per block and dynamic shared memory for
// rows of N candidates.
struct SoftLaunch {
  SoftFn fn;
  void (*ensure)(int);                            // ensure_smem<fn>
  int threads, rows, items, smem;
};

static SoftLaunch soft_launch(int N) {
  int items = 1;
  SoftLaunch l{nullptr, nullptr, 0, 0, 0, 0};
#define UNAV_SOFT_CASE(tpr, n)                                                   \
  case n:                                                                        \
    l.fn = soft_nms_kernel<tpr, n>;                                              \
    l.ensure = ensure_smem<soft_nms_kernel<tpr, n>>;                             \
    break;
  if (N <= 1024) {                                // a warp a row, 4 rows a block
    while (32 * items < N) items *= 2;
    switch (items) {
      UNAV_SOFT_CASE(32, 1) UNAV_SOFT_CASE(32, 2) UNAV_SOFT_CASE(32, 4)
      UNAV_SOFT_CASE(32, 8) UNAV_SOFT_CASE(32, 16) UNAV_SOFT_CASE(32, 32)
    }
    l.threads = 128;
    l.rows = 4;
  } else {                                        // a block a row
    items = 2;
    while (1024 * items < N) items *= 2;
    switch (items) {
      UNAV_SOFT_CASE(1024, 2) UNAV_SOFT_CASE(1024, 4) UNAV_SOFT_CASE(1024, 8)
      UNAV_SOFT_CASE(1024, 16)
    }
    l.threads = 1024;
    l.rows = 1;
  }
#undef UNAV_SOFT_CASE
  l.items = items;
  l.smem = l.rows * N * 10;                       // compacted segments and indices
  return l;
}

static int merged_smem(int N) { return N * 14; }

}  // namespace

// segs (G, N, 2), scores (G, N) with -inf for invalid candidates, cls (G, N)
// int32. out_idx (G, max_out) int32 with -1 for empty slots, out_score
// (G, max_out). Gaussian weights, same-class decay only. N <= 16384.
extern "C" int unav_multiclass_soft_nms(const float* segs, const float* scores,
                                        const int* cls, int G, int N, int max_out,
                                        float sigma, float min_score, int* out_idx,
                                        float* out_score, void* stream_) {
  if (N < 0 || N > MAX_N) return (int)cudaErrorInvalidValue;
  ensure_smem<merged_nms_kernel>(merged_smem(N));
  merged_nms_kernel<<<G, MERGED_THREADS, merged_smem(N), (cudaStream_t)stream_>>>(
      segs, scores, cls, N, max_out, sigma, min_score, out_idx, out_score);
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
  if (method < 0 || method > 2 || N < 0 || N > MAX_N) return (int)cudaErrorInvalidValue;
  const SoftLaunch l = soft_launch(N);
  if (!l.fn) return (int)cudaErrorInvalidValue;
  l.ensure(l.smem);
  l.fn<<<ceil_div(G, l.rows), l.threads, l.smem, (cudaStream_t)stream_>>>(
      segs, scores, G, N, max_out, method, iou_threshold, sigma, min_score, out_idx,
      out_score);
  UNAV_RETURN_IF_ERROR();
  return 0;
}

// What a launch at N runs: info = {resident blocks per SM, threads per
// block, rows per block, register slots per thread, dynamic shared bytes,
// registers per thread, local (spill) bytes per thread}. merged != 0 for
// the merged scan.
extern "C" int unav_nms_launch_info(int merged, int N, int* info) {
  if (N < 0 || N > MAX_N) return (int)cudaErrorInvalidValue;
  const void* fn;
  int threads, rows, items, smem;
  if (merged) {
    fn = (const void*)merged_nms_kernel;
    threads = MERGED_THREADS;
    rows = 1;
    items = 0;
    smem = merged_smem(N);
    ensure_smem<merged_nms_kernel>(smem);
  } else {
    const SoftLaunch l = soft_launch(N);
    if (!l.fn) return (int)cudaErrorInvalidValue;
    fn = (const void*)l.fn;
    threads = l.threads;
    rows = l.rows;
    items = l.items;
    smem = l.smem;
    l.ensure(smem);
  }
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fn);
  UNAV_RETURN_IF_ERROR();
  info[0] = blocks;
  info[1] = threads;
  info[2] = rows;
  info[3] = items;
  info[4] = smem;
  info[5] = attr.numRegs;
  info[6] = (int)attr.localSizeBytes;
  return 0;
}
