// ALF encoder statistics: the per-group normal equations of the luma Wiener
// filter on the 2×2-subsampled grid.
//
// Replaces vvc/kernels/alf.py:330 alf_stats_dev (jitted at :347): 12
// diamond-pair features F = r[a] + r[b] − 2r (edge-padded by 3) and the
// target t = o − r at every even row and column; a group key class·4 +
// transpose from the 4×4 classification; per group (100) FᵀF and Fᵀt, per
// class (25) Σt² and the count.  vvc runs a lax.scan of 100 masked float32
// dots over all P = ⌈H/2⌉·⌈W/2⌉ points (Eigen contractions on XLA-CPU) and
// 25 masked sums.
//
// Design: the sums are taken exactly and rounded once (by the wrapper's
// int64 → float32 cast).  One pass over the grid: each thread takes points
// (grid-stride), computes the 12 features and t in int32 (|F| ≤ 2·(2^bd −
// 1), so a product stays below 2^27 at 12 bit) and adds the 78 distinct
// FᵀF products (upper triangle, row-major), the 12 Fᵀt products, t² and 1
// into int64 accumulators in shared memory (100 · 90 + 25 · 2 = 9050, 72 KB
// of dynamic shared memory) with shared atomics.  Each CTA writes its
// partial sums to a scratch row; a second kernel adds the rows per entry.
// Order-free and exact: every sum of int64 products is an exact integer.
//
// B100 (Fᵀt) on grids of 4096 points or more: vvc's dot lowers there to
// XLA-CPU's tiled GEMV, whose float32 order is reproduced bit for bit by a
// third kernel (alf_b100_kernel): lane j of row k sums the products of
// the points p ≡ j (mod 8) in increasing p from 0, and the eight lanes
// meet in a fixed tree (rows 0..7: ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7));
// rows 8..11: ((a0+a4)+(a2+a6))+((a1+a5)+(a3+a7))) — read from the
// optimised IR of vvc's _alf_stats_impl, jax 0.9.0, at 416×240 and 1080p
// (P is a multiple of 16: the picture's sides are multiples of 8).  A
// product F·t is exact in float32 up to 10 bit (|F·t| < 2^24), so adding
// it is vvc's FMA.  One CTA per group, one warp per lane (below).
//
// Bound per 1080p picture: bytes — r read whole (8.3 MB), the even rows of
// o at 32-B sector granularity (4.1 MB), cls4 and tr4 (1.0 MB), about
// 13.4 MB, 0.004 ms at 3.35 TB/s; the arithmetic (518,400 points × 90
// multiply-adds) is far below the card's integer rate.  The B100 pass is
// latency-bound: 800 warps walk P/8 points each, 32 at a time.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 12;
constexpr int kGroupStride = 90;          // 78 FᵀF + 12 Fᵀt
constexpr int kGroups = 100;
constexpr int kEntries = kGroups * kGroupStride + 25 * 2;

// canonical members (dy, dx) of vvc/kernels/alf.py diamond_pairs(3), in its
// order; the partner is (−dy, −dx)
__constant__ int kPair[kPairs][2] = {
    {-3, 0}, {-2, -1}, {-2, 0}, {-2, 1}, {-1, -2}, {-1, -1},
    {-1, 0}, {-1, 1},  {-1, 2}, {0, -3}, {0, -2}, {0, -1}};

__device__ __forceinline__ void point_features(const int* __restrict__ o,
                                               const int* __restrict__ r,
                                               int h, int w, int y, int x,
                                               int* f, int* t) {
  const int c = r[(long long)y * w + x];
  *t = o[(long long)y * w + x] - c;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int dy = kPair[k][0], dx = kPair[k][1];
    const int ya = min(max(y + dy, 0), h - 1), xa = min(max(x + dx, 0), w - 1);
    const int yb = min(max(y - dy, 0), h - 1), xb = min(max(x - dx, 0), w - 1);
    f[k] = r[(long long)ya * w + xa] + r[(long long)yb * w + xb] - 2 * c;
  }
}

__global__ void alf_stats_kernel(const int* __restrict__ o,
                                 const int* __restrict__ r,
                                 const int* __restrict__ cls4,
                                 const int* __restrict__ tr4, int h, int w,
                                 int w4, long long* __restrict__ partial) {
  extern __shared__ unsigned long long acc[];
  for (int i = threadIdx.x; i < kEntries; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const int ws = (w + 1) / 2;
  const long long npts = (long long)((h + 1) / 2) * ws;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < npts; p += (long long)gridDim.x * blockDim.x) {
    const int y = 2 * (int)(p / ws), x = 2 * (int)(p % ws);
    int f[kPairs], t;
    point_features(o, r, h, w, y, x, f, &t);
    const int cls = cls4[(y >> 2) * w4 + (x >> 2)];
    unsigned long long* g =
        acc + (cls * 4 + tr4[(y >> 2) * w4 + (x >> 2)]) * kGroupStride;
    int idx = 0;
#pragma unroll
    for (int a = 0; a < kPairs; ++a) {
#pragma unroll
      for (int b = a; b < kPairs; ++b)
        atomicAdd(g + idx++, (unsigned long long)(long long)(f[a] * f[b]));
    }
#pragma unroll
    for (int a = 0; a < kPairs; ++a)
      atomicAdd(g + 78 + a, (unsigned long long)(long long)(f[a] * t));
    unsigned long long* s = acc + kGroups * kGroupStride + cls * 2;
    atomicAdd(s, (unsigned long long)(long long)(t * t));
    atomicAdd(s + 1, 1ULL);
  }
  __syncthreads();
  long long* out = partial + (long long)blockIdx.x * kEntries;
  for (int i = threadIdx.x; i < kEntries; i += blockDim.x)
    out[i] = (long long)acc[i];
}

// B100 in the GEMV's order: one CTA per group g, one warp per lane j.  A
// warp walks lane j's points (p = j, j + 8, ...) 32 at a
// time: each thread tests one point's key and, on a match, puts its 12
// products F·t in shared memory; then thread k < 12 adds the matches'
// products of row k in increasing p (the ballot's set bits in order).
// Thread k < 12 of warp 0 then meets the eight lane sums in the GEMV's
// tree.
__global__ void alf_b100_kernel(const int* __restrict__ o,
                                const int* __restrict__ r,
                                const int* __restrict__ cls4,
                                const int* __restrict__ tr4, int h, int w,
                                int w4, float* __restrict__ b100) {
  __shared__ int prod[8][32][kPairs];
  __shared__ float lanes[8][kPairs];
  const int g = blockIdx.x;
  const int j = threadIdx.x >> 5, u = threadIdx.x & 31;
  const int ws = (w + 1) / 2;
  const int npts = ((h + 1) / 2) * ws;           // a multiple of 8
  float acc = 0.f;                                 // row u < 12
  for (int base = 0; base < npts / 8; base += 32) {
    const int p = 8 * (base + u) + j;
    bool hit = false;
    if (p < npts) {
      const int y = 2 * (p / ws), x = 2 * (p % ws);
      const int q = (y >> 2) * w4 + (x >> 2);
      hit = cls4[q] * 4 + tr4[q] == g;
      if (hit) {
        int f[kPairs], tt;
        point_features(o, r, h, w, y, x, f, &tt);
#pragma unroll
        for (int k = 0; k < kPairs; ++k) prod[j][u][k] = f[k] * tt;
      }
    }
    unsigned mask = __ballot_sync(0xffffffffu, hit);
    __syncwarp();
    if (u < kPairs) {
      while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        acc = __fadd_rn(acc, (float)prod[j][b][u]);
      }
    }
    __syncwarp();
  }
  if (u < kPairs) lanes[j][u] = acc;
  __syncthreads();
  if (threadIdx.x >= kPairs) return;
  const int k = threadIdx.x;
  float v[8];
  for (int l = 0; l < 8; ++l) v[l] = lanes[l][k];
  // rows 0..7 pair the lanes (0,1)(2,3)(4,5)(6,7); rows 8..11 (0,4)(2,6)
  // (1,5)(3,7)
  const int a1 = k < 8 ? 1 : 4, a3 = k < 8 ? 3 : 6;
  const int a4 = k < 8 ? 4 : 1, a6 = k < 8 ? 6 : 3;
  const float tree = __fadd_rn(
      __fadd_rn(__fadd_rn(v[0], v[a1]), __fadd_rn(v[2], v[a3])),
      __fadd_rn(__fadd_rn(v[a4], v[5]), __fadd_rn(v[a6], v[7])));
  b100[g * kPairs + k] = tree;
}

__global__ void alf_stats_reduce(const long long* __restrict__ partial,
                                 int rows, long long* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kEntries) return;
  long long s = 0;
  for (int k = 0; k < rows; ++k) s += partial[(long long)k * kEntries + i];
  acc[i] = s;
}

}  // namespace

// acc [9050] int64: per group g (class·4 + transpose) 78 FᵀF entries
// (upper triangle, row-major) then 12 Fᵀt; then per class Σt² and the
// count.  partial: scratch of blocks · 9050 int64.  With gemv set, b100
// [100, 12] float32 receives Fᵀt in the GEMV's order.
extern "C" int alf_stats_launch(const int* o, const int* r, const int* cls4,
                                const int* tr4, int h, int w, int w4,
                                long long* partial, int blocks,
                                long long* acc, float* b100, int gemv,
                                void* stream) {
  const size_t smem = kEntries * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      alf_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  alf_stats_kernel<<<blocks, 512, smem, s>>>(o, r, cls4, tr4, h, w, w4,
                                              partial);
  alf_stats_reduce<<<(kEntries + 255) / 256, 256, 0, s>>>(partial, blocks,
                                                           acc);
  if (gemv)
    alf_b100_kernel<<<kGroups, 256, 0, s>>>(o, r, cls4, tr4, h, w, w4, b100);
  return (int)cudaGetLastError();
}
