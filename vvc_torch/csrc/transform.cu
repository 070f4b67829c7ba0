// Forward and inverse 2-D integer transforms of square blocks (DCT2, DST7,
// DCT8; 4..64 points), batched over the RDO's candidate blocks.
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
//             s1 = log2(S) + B - 9
//             out[v][u]  = clip16((sum_h Tv[v][h]·tmp[h][u] + 2^(s2-1)) >> s2),
//             s2 = log2(S) + 6
//   inverse:  tmp[h][u]  = clip16((sum_v Tv[v][h]·x[v][u] + 64) >> 7)
//             out[h][w]  = clip16((sum_u tmp[h][u]·Th[u][w] + 2^(s2-1)) >> s2),
//             s2 = 20 - B
//
// One CTA per block: the S×S input and the stage-1 result sit in shared
// memory (32 KB at S = 64), and for the forward transform Th transposed
// too (48 KB at S = 64, so that neighbouring threads read neighbouring
// banks); the other matrix reads go through the read-only cache, where
// every CTA of the launch hits them, as broadcasts or coalesced rows.
// Each thread computes whole output samples (a length-S dot product), so
// no sum is split.  Bound: bytes — 8 B moved per sample (4 read, 4
// written).  The 2·S int32 MACs per sample and stage take less time than
// those bytes at the card's peak rates for S ≤ 32, and most of a search's
// samples are at those sizes, so its bound is the byte time.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

__global__ void transform_fwd_kernel(const int* __restrict__ in,
                                     const int* __restrict__ th,
                                     const int* __restrict__ tv,
                                     int* __restrict__ out, int s, int shift1,
                                     int shift2) {
  extern __shared__ int sm[];
  const int nn = s * s;
  int* sx = sm;
  int* st = sm + nn;
  int* tht = sm + 2 * nn;  // Th transposed: neighbouring u, neighbouring banks
  const long long base = (long long)blockIdx.x * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    sx[i] = in[base + i];
    const int u = i / s, w = i - u * s;
    tht[w * s + u] = __ldg(th + i);
  }
  __syncthreads();
  const int rnd1 = 1 << (shift1 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int h = i / s, u = i - h * s;
    const int* xr = sx + h * s;
    int acc = 0;
    for (int w = 0; w < s; ++w) acc += xr[w] * tht[w * s + u];
    st[i] = (acc + rnd1) >> shift1;
  }
  __syncthreads();
  const int rnd2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int v = i / s, u = i - v * s;
    const int* tr = tv + v * s;
    int acc = 0;
    for (int h = 0; h < s; ++h) acc += __ldg(tr + h) * st[h * s + u];
    out[base + i] = clip16((acc + rnd2) >> shift2);
  }
}

__global__ void transform_inv_kernel(const int* __restrict__ in,
                                     const int* __restrict__ th,
                                     const int* __restrict__ tv,
                                     int* __restrict__ out, int s,
                                     int shift2) {
  extern __shared__ int sm[];
  const int nn = s * s;
  int* sx = sm;
  int* st = sm + nn;
  const long long base = (long long)blockIdx.x * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) sx[i] = in[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int h = i / s, u = i - h * s;
    int acc = 0;
    for (int v = 0; v < s; ++v) acc += __ldg(tv + v * s + h) * sx[v * s + u];
    st[i] = clip16((acc + 64) >> 7);
  }
  __syncthreads();
  const int rnd2 = 1 << (shift2 - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int h = i / s, w = i - h * s;
    const int* tr = st + h * s;
    int acc = 0;
    for (int u = 0; u < s; ++u) acc += tr[u] * __ldg(th + u * s + w);
    out[base + i] = clip16((acc + rnd2) >> shift2);
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

bool valid(int n, int s, int bit_depth) {
  return n >= 0 && (s == 4 || s == 8 || s == 16 || s == 32 || s == 64) &&
         bit_depth >= 8 && bit_depth <= 12;
}

}  // namespace

extern "C" int transform_fwd_launch(const int* in, const int* th,
                                    const int* tv, int* out, int n, int s,
                                    int bit_depth, void* stream) {
  if (!valid(n, s, bit_depth)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = s * s < 256 ? s * s : 256;
  const size_t smem = 3 * (size_t)s * s * sizeof(int);  // 48 KB at S = 64
  transform_fwd_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      in, th, tv, out, s, log2i(s) + bit_depth - 9, log2i(s) + 6);
  return (int)cudaGetLastError();
}

extern "C" int transform_inv_launch(const int* in, const int* th,
                                    const int* tv, int* out, int n, int s,
                                    int bit_depth, void* stream) {
  if (!valid(n, s, bit_depth)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = s * s < 256 ? s * s : 256;
  const size_t smem = 2 * (size_t)s * s * sizeof(int);
  transform_inv_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      in, th, tv, out, s, 20 - bit_depth);
  return (int)cudaGetLastError();
}
