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
// Bound per 1080p picture: bytes — r read whole (8.3 MB), the even rows of
// o at 32-B sector granularity (4.1 MB), cls4 and tr4 (1.0 MB), about
// 13.4 MB, 0.004 ms at 3.35 TB/s; the arithmetic (518,400 points × 90
// multiply-adds) is far below the card's integer rate.
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
    const int c = r[(long long)y * w + x];
    const int t = o[(long long)y * w + x] - c;
    int f[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int dy = kPair[k][0], dx = kPair[k][1];
      const int ya = min(max(y + dy, 0), h - 1), xa = min(max(x + dx, 0), w - 1);
      const int yb = min(max(y - dy, 0), h - 1), xb = min(max(x - dx, 0), w - 1);
      f[k] = r[(long long)ya * w + xa] + r[(long long)yb * w + xb] - 2 * c;
    }
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
// count.  partial: scratch of blocks · 9050 int64.
extern "C" int alf_stats_launch(const int* o, const int* r, const int* cls4,
                                const int* tr4, int h, int w, int w4,
                                long long* partial, int blocks,
                                long long* acc, void* stream) {
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
  return (int)cudaGetLastError();
}
