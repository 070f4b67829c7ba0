// SAO encoder statistics: per-CTU sums of (orig − rec) and counts for the
// 4 edge-offset classes × 4 categories and the 32 bands of one component.
//
// Replaces vvc/kernels/sao.py:157 sao_stats_dev (jitted at :177), which
// builds 16 EO and 32 BO masks over the whole plane and block-sums
// diff·mask and mask per CTU in float32 (96 masked reductions).
//
// Design: one CTA per CTU, threads striding over the CTU's samples clipped
// to the plane (the picture's last partial CTU row and column sum only the
// samples that exist, as vvc's zero padding does).  Per sample: the
// difference, the 4 EO categories — sign(c − a) + sign(c − b) with the
// neighbours a, b read edge-clamped (vvc's jnp.pad(mode="edge")), category
// 0 where validx (classes with dx ≠ 0) or validy (dy ≠ 0) is false at the
// sample — and the band rec >> (bd − 5).  96 int32 accumulators in shared
// memory (16 EO sums, 16 EO counts, 32 BO sums, 32 BO counts), shared
// atomics, written out as float32 to out[ctu][96].
//
// Exactness: every partial sum is an integer of magnitude at most
// cs² · (2^bd − 1) = 4096 · 4095 < 2^24 for bd ≤ 12, so the int32 sums are
// exact in any order, and so are vvc's float32 block sums: the two agree
// exactly (tests/test_torch_sao.py holds this near the bound).
//
// Bound per 1080p picture (3 launches: Y at cs 64, Cb and Cr at cs 32):
// bytes — orig and rec of the three planes as int32 read once (16.6 + 8.3
// MB) plus the statistics written (0.6 MB): 25.5 MB, about 0.0076 ms at
// 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int eo_cat(int t) {
  // sign sum −2, −1, 0, 1, 2 → category 1, 2, 0, 3, 4
  return t == -2 ? 1 : t == -1 ? 2 : t == 1 ? 3 : t == 2 ? 4 : 0;
}

__global__ void sao_stats_kernel(const int* __restrict__ orig,
                                 const int* __restrict__ rec,
                                 const unsigned char* __restrict__ validx,
                                 const unsigned char* __restrict__ validy,
                                 int h, int w, int cs, int bit_depth,
                                 float* __restrict__ out) {
  __shared__ int acc[96];
  for (int i = threadIdx.x; i < 96; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  const int nx = (w + cs - 1) / cs;
  const int y0 = (blockIdx.x / nx) * cs, x0 = (blockIdx.x % nx) * cs;
  const int bh = min(cs, h - y0), bw = min(cs, w - x0);
  const int shift = bit_depth - 5;
  for (int i = threadIdx.x; i < bh * bw; i += blockDim.x) {
    const int y = y0 + i / bw, x = x0 + i % bw;
    const int ym = max(y - 1, 0), yp = min(y + 1, h - 1);
    const int xm = max(x - 1, 0), xp = min(x + 1, w - 1);
    const int* row = rec + (long long)y * w;
    const int* up = rec + (long long)ym * w;
    const int* dn = rec + (long long)yp * w;
    const int c = row[x];
    const int d = orig[(long long)y * w + x] - c;
    const bool vx = validx[x] != 0, vy = validy[y] != 0;
    // EO classes (dx, dy): 0° (1,0), 90° (0,1), 135° (1,1), 45° (1,−1);
    // neighbours at (x − dx, y − dy) and (x + dx, y + dy)
    const int cat[4] = {
        vx ? eo_cat(sgn(c - row[xm]) + sgn(c - row[xp])) : 0,
        vy ? eo_cat(sgn(c - up[x]) + sgn(c - dn[x])) : 0,
        vx && vy ? eo_cat(sgn(c - up[xm]) + sgn(c - dn[xp])) : 0,
        vx && vy ? eo_cat(sgn(c - dn[xm]) + sgn(c - up[xp])) : 0};
#pragma unroll
    for (int ec = 0; ec < 4; ++ec) {
      if (cat[ec]) {
        atomicAdd(&acc[ec * 4 + cat[ec] - 1], d);
        atomicAdd(&acc[16 + ec * 4 + cat[ec] - 1], 1);
      }
    }
    const int band = c >> shift;
    atomicAdd(&acc[32 + band], d);
    atomicAdd(&acc[64 + band], 1);
  }
  __syncthreads();
  float* o = out + (long long)blockIdx.x * 96;
  for (int i = threadIdx.x; i < 96; i += blockDim.x) o[i] = (float)acc[i];
}

}  // namespace

extern "C" int sao_stats_launch(const int* orig, const int* rec,
                                const unsigned char* validx,
                                const unsigned char* validy, int h, int w,
                                int cs, int bit_depth, float* out,
                                void* stream) {
  const int ctus = ((h + cs - 1) / cs) * ((w + cs - 1) / cs);
  if (ctus == 0) return 0;
  sao_stats_kernel<<<ctus, 256, 0, (cudaStream_t)stream>>>(
      orig, rec, validx, validy, h, w, cs, bit_depth, out);
  return (int)cudaGetLastError();
}
