// Hadamard SATD of M predictions per block against the block's original.
//
// Replaces vvc/kernels/satd.py:37 satd_batch (a jitted jnp int32 einsum
// H.D.H over 8x8 tiles on the TPU), fed there with an [N*67,S,S] broadcast
// copy of the originals (vvc/enc/rdo.py:206-208).  Here pred [N,M,H,W] is
// read against orig [N,H,W] by index, so that copy never exists.
//
// Per t x t tile (t = 8, or 4 when a block side is 4): difference, 2-D
// fast Walsh-Hadamard transform in registers (butterflies give the
// Sylvester-ordered H, the same as the reference's matrix), sum of
// absolute values, then the VTM normalisation (x+2)>>2 for t=8 or
// (x+1)>>1 for t=4.  Sums stay int32: the largest 64x64 total is about
// 6.7e7 < 2^31.
//
// One thread per tile.  The T tiles of one (block, mode) pair sit in T
// neighbouring lanes (T is a power of two): lanes reduce with shuffles,
// and for T > 32 each warp adds its share with an integer atomic into a
// zeroed output (integer addition, so the result does not depend on the
// order).  Bound: bytes — the predictions are read once (N*M*H*W*4 B).
//
// block_dist replaces vvc/kernels/satd.py:26,33 sse_batch and sad_batch
// ([N,H,W] x [N,H,W] -> [N], eager jnp sums on the TPU), and the float32
// block error of vvc/enc/inter_search.py:391 me_pred_program.  SAD is an
// exact int32 sum.  SSE is vvc's float32 sum of d^2: below 2^24 every
// order gives the exact integer, which the kernel sums in int64; above it
// takes the order XLA-CPU compiles the eager reduce to (jax 0.9.0, read
// from the object code and held by tests/test_torch_r4me.py): 8x8 row
// lanes (lane r sums row r left to right, then the halving tree
// ((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7))), 64x64 four 32x32 windows each
// row-major from 0 then (W00+W01)+(W10+W11), every other shape row-major
// from 0.  One thread per block: the sums above 2^24 are sequential, and a
// block is at most 4096 samples.  Bound: bytes (both inputs read once).
#include <cuda_runtime.h>

template <int T>
__device__ __forceinline__ void fwht(int* v) {
#pragma unroll
  for (int len = 1; len < T; len <<= 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if ((i & len) == 0) {
        const int a = v[i], b = v[i + len];
        v[i] = a + b;
        v[i + len] = a - b;
      }
    }
  }
}

template <int T>
__device__ __forceinline__ int tile_satd(const int* __restrict__ p,
                                         const int* __restrict__ o, int w) {
  int d[T][T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
#pragma unroll
    for (int q = 0; q < T; ++q) d[r][q] = p[r * w + q] - o[r * w + q];
    fwht<T>(d[r]);
  }
  int sum = 0;
#pragma unroll
  for (int q = 0; q < T; ++q) {
    int col[T];
#pragma unroll
    for (int r = 0; r < T; ++r) col[r] = d[r][q];
    fwht<T>(col);
#pragma unroll
    for (int r = 0; r < T; ++r) sum += abs(col[r]);
  }
  return T == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1;
}

__global__ void satd_kernel(const int* __restrict__ pred,
                            const int* __restrict__ orig,
                            int* __restrict__ out, int m, int h, int w, int t,
                            int tiles_x, int tiles, int lanes,
                            long long total) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int val = 0;
  long long nm = 0;
  if (g < total) {
    nm = g / tiles;
    const int tile = (int)(g - nm * tiles);
    const long long bn = nm / m;
    const int y0 = (tile / tiles_x) * t, x0 = (tile % tiles_x) * t;
    const int* p = pred + nm * h * w + y0 * w + x0;
    const int* o = orig + bn * h * w + y0 * w + x0;
    val = t == 8 ? tile_satd<8>(p, o, w) : tile_satd<4>(p, o, w);
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    val += __shfl_xor_sync(0xffffffffu, val, off);
  if (g < total && (threadIdx.x & (lanes - 1)) == 0) {
    if (tiles <= 32)
      out[nm] = val;
    else
      atomicAdd(out + nm, val);
  }
}

extern "C" int satd_launch(const int* pred, const int* orig, int* out, int n,
                           int m, int h, int w, void* stream) {
  const int t = (h < w ? h : w) >= 8 ? 8 : (h < w ? h : w);
  if (t != 8 && t != 4) return (int)cudaErrorInvalidValue;
  const int tiles_x = w / t, tiles = (h / t) * tiles_x;
  if ((tiles & (tiles - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * m * tiles;
  if (total == 0) return 0;
  const int lanes = tiles < 32 ? tiles : 32;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  satd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pred, orig, out, m, h, w, t, tiles_x, tiles, lanes, total);
  return (int)cudaGetLastError();
}

namespace {

__device__ __forceinline__ float seq_sq(const int* a, const int* b, int w,
                                        int y0, int y1, int x0, int x1) {
  float acc = 0.0f;
  for (int y = y0; y < y1; ++y)
    for (int x = x0; x < x1; ++x) {
      const float d = (float)(a[y * w + x] - b[y * w + x]);
      acc = __fadd_rn(acc, __fmul_rn(d, d));
    }
  return acc;
}

__global__ void block_dist_kernel(const int* __restrict__ a,
                                  const int* __restrict__ b, int n, int h,
                                  int w, int sad, float* __restrict__ sse,
                                  int* __restrict__ sad_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long hw = (long long)h * w;
  const int* pa = a + i * hw;
  const int* pb = b + i * hw;
  if (sad) {
    int s = 0;
    for (long long k = 0; k < hw; ++k) s += abs(pa[k] - pb[k]);
    sad_out[i] = s;
    return;
  }
  long long ex = 0;
  for (long long k = 0; k < hw; ++k) {
    const long long d = pa[k] - pb[k];
    ex += d * d;
  }
  if (ex < (1LL << 24)) {
    sse[i] = (float)ex;
    return;
  }
  if (h == 8 && w == 8) {
    float l[8];
    for (int r = 0; r < 8; ++r) l[r] = seq_sq(pa, pb, w, r, r + 1, 0, 8);
    sse[i] = __fadd_rn(__fadd_rn(__fadd_rn(l[0], l[4]), __fadd_rn(l[2], l[6])),
                       __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
  } else if (h == 64 && w == 64) {
    const float w00 = seq_sq(pa, pb, w, 0, 32, 0, 32);
    const float w01 = seq_sq(pa, pb, w, 0, 32, 32, 64);
    const float w10 = seq_sq(pa, pb, w, 32, 64, 0, 32);
    const float w11 = seq_sq(pa, pb, w, 32, 64, 32, 64);
    sse[i] = __fadd_rn(__fadd_rn(w00, w01), __fadd_rn(w10, w11));
  } else {
    sse[i] = seq_sq(pa, pb, w, 0, h, 0, w);
  }
}

}  // namespace

extern "C" int block_dist_launch(const int* a, const int* b, int n, int h,
                                 int w, int sad, float* sse, int* sad_out,
                                 void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  block_dist_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(a, b, n, h, w, sad, sse,
                                              sad_out);
  return (int)cudaGetLastError();
}
