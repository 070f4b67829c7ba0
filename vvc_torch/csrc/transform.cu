// Forward and inverse 2-D integer transforms of W x H blocks (DCT2, DST7,
// DCT8; W, H in 4..64 points, the 64-point side DCT2 only), batched over
// the RDO's candidate blocks: the squares of every size, the MTT lattice's
// rectangles and the ISP sub-TUs (4-point sides).
//
// Replaces vvc/kernels/transform.py:78 fwd_transform_batch and :94
// inv_transform_batch (jitted jnp int32 einsums on the TPU).  Integer
// semantics are the reference's exactly: int32 products and sums (the
// largest partial sum is about 2.7e8 < 2^31), the spec's rounding offsets,
// arithmetic right shifts, the inverse's 16-bit clamp of the intermediate
// and the [-32768, 32767] clamp of the output.  No float path: stage 2 is
// not exact in float32 (a 16-bit intermediate times a 7-bit matrix entry,
// summed over 64 terms, passes 2^24).
//
//   forward:  tmp[h][u]  = (sum_w x[h][w]·Th[u][w] + 2^(s1-1)) >> s1,
//             s1 = log2(W) + B - 9   (Th: W x W, Tv: H x H)
//             out[v][u]  = clip16((sum_h Tv[v][h]·tmp[h][u] + 2^(s2-1)) >> s2),
//             s2 = log2(H) + 6
//   inverse:  tmp[h][u]  = clip16((sum_v Tv[v][h]·x[v][u] + 64) >> 7)
//             out[h][w]  = clip16((sum_u tmp[h][u]·Th[u][w] + 2^(s2-1)) >> s2),
//             s2 = 20 - B
//
// One CTA per block: the H×W input and the stage-1 result sit in shared
// memory (32 KB at 64×64), and for the forward transform Th transposed
// too (48 KB at 64×64, so that neighbouring threads read neighbouring
// banks); the other matrix reads go through the read-only cache, where
// every CTA of the launch hits them, as broadcasts or coalesced rows.
// Each thread computes whole output samples (a length-W or length-H dot
// product), so no sum is split.  Bound: bytes — 8 B moved per sample (4
// read, 4 written).  The W + H int32 MACs per sample take less time than
// those bytes at the card's peak rates for sides ≤ 32, and most of a
// search's samples are at those sizes, so its bound is the byte time.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

__global__ void transform_fwd_kernel(const int* __restrict__ in,
                                     const int* __restrict__ th,
                                     const int* __restrict__ tv,
                                     int* __restrict__ out, int w, int h,
                                     int log2w, int shift1, int shift2) {
  extern __shared__ int sm[];
  const int nn = w * h;
  int* sx = sm;
  int* st = sm + nn;
  int* tht = sm + 2 * nn;  // Th transposed: neighbouring u, neighbouring banks
  const long long base = (long long)blockIdx.x * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) sx[i] = in[base + i];
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int u = i >> log2w, x = i & (w - 1);
    tht[x * w + u] = __ldg(th + i);
  }
  __syncthreads();
  const int rnd1 = 1 << (shift1 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i >> log2w, u = i & (w - 1);
    const int* xr = sx + y * w;
    int acc = 0;
    for (int x = 0; x < w; ++x) acc += xr[x] * tht[x * w + u];
    st[i] = (acc + rnd1) >> shift1;
  }
  __syncthreads();
  const int rnd2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int v = i >> log2w, u = i & (w - 1);
    const int* tr = tv + v * h;
    int acc = 0;
    for (int y = 0; y < h; ++y) acc += __ldg(tr + y) * st[y * w + u];
    out[base + i] = clip16((acc + rnd2) >> shift2);
  }
}

__global__ void transform_inv_kernel(const int* __restrict__ in,
                                     const int* __restrict__ th,
                                     const int* __restrict__ tv,
                                     int* __restrict__ out, int w, int h,
                                     int log2w, int shift2) {
  extern __shared__ int sm[];
  const int nn = w * h;
  int* sx = sm;
  int* st = sm + nn;
  const long long base = (long long)blockIdx.x * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) sx[i] = in[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i >> log2w, u = i & (w - 1);
    int acc = 0;
    for (int v = 0; v < h; ++v) acc += __ldg(tv + v * h + y) * sx[v * w + u];
    st[i] = clip16((acc + 64) >> 7);
  }
  __syncthreads();
  const int rnd2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int y = i >> log2w, x = i & (w - 1);
    const int* tr = st + y * w;
    int acc = 0;
    for (int u = 0; u < w; ++u) acc += tr[u] * __ldg(th + u * w + x);
    out[base + i] = clip16((acc + rnd2) >> shift2);
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

bool side_ok(int s) {
  return s == 4 || s == 8 || s == 16 || s == 32 || s == 64;
}

bool valid(int n, int w, int h, int bit_depth) {
  return n >= 0 && side_ok(w) && side_ok(h) && bit_depth >= 8 &&
         bit_depth <= 12;
}

}  // namespace

extern "C" int transform_fwd_launch(const int* in, const int* th,
                                    const int* tv, int* out, int n, int w,
                                    int h, int bit_depth, void* stream) {
  if (!valid(n, w, h, bit_depth)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = w * h < 256 ? w * h : 256;
  const size_t smem = (2 * (size_t)w * h + (size_t)w * w) * sizeof(int);
  transform_fwd_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      in, th, tv, out, w, h, log2i(w), log2i(w) + bit_depth - 9,
      log2i(h) + 6);
  return (int)cudaGetLastError();
}

extern "C" int transform_inv_launch(const int* in, const int* th,
                                    const int* tv, int* out, int n, int w,
                                    int h, int bit_depth, void* stream) {
  if (!valid(n, w, h, bit_depth)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = w * h < 256 ? w * h : 256;
  const size_t smem = 2 * (size_t)w * h * sizeof(int);
  transform_inv_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      in, th, tv, out, w, h, log2i(w), 20 - bit_depth);
  return (int)cudaGetLastError();
}
