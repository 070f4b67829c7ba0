// Matrix intra prediction (MIP) of all K = 9 modes for a batch of square
// blocks (S = 8, 16, 32) from their reference lines.
//
// Replaces vvc/kernels/mip.py:112 mip_predict_all_batch (a jitted jnp
// program on the TPU: boundary pooling, one [N,8]×[K,64,8] einsum,
// boundary-anchored upsampling).  Integer semantics are the reference's,
// all in int32:
//   pool:  b[j] = (sum of S/4 top (j < 4) or left samples + S/8) >> log2(S/4)
//   mean:  m = (sum b + 4) >> 3
//   red:   red[k][o] = clip(((sum_i W[k][o][i]·(b[i] - m) + 32) >> 6) + m)
//   up:    horizontal pass anchored on left[(i+1)u-1] at x = -1, then a
//          vertical pass anchored on top[x] at y = -1, u = S/8, each
//          ((u-d)·a + d·b + u/2) >> log2(u)
// The reference line C holds left[k] at C[2S-1-k] and top[k] at C[2S+1+k].
//
// One CTA per block: the [9,64,8] weights (18 KB), the reduced grids and
// the horizontal pass sit in shared memory; the output is written once.
// Bound: bytes — 9·S² int32 written per block (the 4S+3 line read is
// small beside it).
#include <cuda_runtime.h>

namespace {

constexpr int kK = 9;

__global__ void mip_kernel(const int* __restrict__ refs,
                           const int* __restrict__ weights,
                           int* __restrict__ out, int s, int lp, int lu,
                           int maxv) {
  __shared__ int sw[kK * 64 * 8];
  __shared__ int red[kK * 64];
  __shared__ int hor[kK * 8 * 32];
  __shared__ int top[32], left[32];
  __shared__ int bnd[8];
  __shared__ int mean;
  const int tid = threadIdx.x;
  const int* c = refs + (long long)blockIdx.x * (4 * s + 3);
  for (int i = tid; i < kK * 64 * 8; i += blockDim.x) sw[i] = __ldg(weights + i);
  for (int i = tid; i < s; i += blockDim.x) {
    top[i] = c[2 * s + 1 + i];
    left[i] = c[2 * s - 1 - i];
  }
  __syncthreads();
  if (tid < 8) {
    const int pool = s >> 2;
    const int* src = tid < 4 ? top : left;
    const int j = tid & 3;
    int sum = 0;
    for (int p = 0; p < pool; ++p) sum += src[j * pool + p];
    bnd[tid] = (sum + (pool >> 1)) >> lp;
  }
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int i = 0; i < 8; ++i) sum += bnd[i];
    mean = (sum + 4) >> 3;
  }
  __syncthreads();
  const int m = mean;
  for (int i = tid; i < kK * 64; i += blockDim.x) {
    const int* wr = sw + i * 8;
    int acc = 0;
    for (int j = 0; j < 8; ++j) acc += wr[j] * (bnd[j] - m);
    red[i] = min(max(((acc + 32) >> 6) + m, 0), maxv);
  }
  __syncthreads();
  const int ss = s * s;
  int* o = out + (long long)blockIdx.x * kK * ss;
  if (s == 8) {
    for (int i = tid; i < kK * 64; i += blockDim.x) o[i] = red[i];
    return;
  }
  const int u = s >> 3, half = u >> 1;
  for (int i = tid; i < kK * 8 * s; i += blockDim.x) {
    const int k = i / (8 * s), r = (i / s) & 7, x = i % s;
    const int j0 = x >> lu, d = (x & (u - 1)) + 1;
    const int* rr = red + k * 64 + r * 8;
    const int a = j0 == 0 ? left[(r + 1) * u - 1] : rr[j0 - 1];
    hor[(k * 8 + r) * s + x] = ((u - d) * a + d * rr[j0] + half) >> lu;
  }
  __syncthreads();
  for (int i = tid; i < kK * ss; i += blockDim.x) {
    const int k = i / ss, y = (i / s) % s, x = i % s;
    const int j0 = y >> lu, d = (y & (u - 1)) + 1;
    const int* hk = hor + k * 8 * s;
    const int a = j0 == 0 ? top[x] : hk[(j0 - 1) * s + x];
    o[i] = ((u - d) * a + d * hk[j0 * s + x] + half) >> lu;
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << (l + 1)) <= v) ++l;
  return l;
}

}  // namespace

extern "C" int mip_pred_all_launch(const int* refs, const int* weights,
                                   int* out, int n, int s, int bit_depth,
                                   void* stream) {
  if (n < 0 || !(s == 8 || s == 16 || s == 32) || bit_depth < 8 ||
      bit_depth > 12)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  mip_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(
      refs, weights, out, s, log2i(s >> 2), log2i(s >> 3),
      (1 << bit_depth) - 1);
  return (int)cudaGetLastError();
}
