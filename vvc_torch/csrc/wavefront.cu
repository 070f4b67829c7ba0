// The last step of the decoder's wavefront reconstruction: commit the N
// square S x S leaves of one wave (one component) into the plane.
//
// `wave_commit` replaces vvc/dec/wavefront.py:111-114 (lossless luma:
// the BDPCM inverse, a prefix sum of the levels along rows, bdpcm = 1, or
// columns, bdpcm = 2, taken in int64 and cut to int32 as numpy's
// cumsum(dtype=int64).astype(int32)) and :134-138 (rec = clip(pred +
// resi, 0, 2^bd - 1), the int32 sum wrapping as numpy's; rec scattered
// into the plane at (x0, y0); the leaf's z-order index zi written into
// its max(1, S/4)^2 units of the order map).  One CTA per leaf, in place:
// the leaves of one wave never overlap.  A BDPCM leaf runs one thread
// per row (or column) along its prefix sum; any other leaf one thread per
// sample.  Bound: bytes — pred and resi read, the plane written (12 B per
// sample) and the order map's units written; a wave holds few leaves, so
// it is launch-bound.
#include <cuda_runtime.h>

namespace {

__global__ void wave_commit_kernel(int* __restrict__ plane, int pw,
                                   int* __restrict__ order, int ow,
                                   const int* __restrict__ pred,
                                   const int* __restrict__ resi,
                                   const int* __restrict__ xs,
                                   const int* __restrict__ ys,
                                   const int* __restrict__ zis,
                                   const int* __restrict__ bdpcm, int s,
                                   int maxv) {
  const int b = blockIdx.x;
  const int x0 = xs[b], y0 = ys[b];
  const int mode = bdpcm[b];
  const long long base = (long long)b * s * s;
  const int* p = pred + base;
  const int* r = resi + base;
  if (mode == 0) {
    for (int i = threadIdx.x; i < s * s; i += blockDim.x) {
      const int y = i / s, x = i - y * s;
      const int v = (int)((unsigned)p[i] + (unsigned)r[i]);
      plane[(long long)(y0 + y) * pw + x0 + x] = min(max(v, 0), maxv);
    }
  } else if (threadIdx.x < s) {
    // bdpcm 1: thread t sums row t left to right; 2: column t top down
    const int t = threadIdx.x;
    const int step = mode == 1 ? 1 : s;
    const int start = mode == 1 ? t * s : t;
    long long acc = 0;
    for (int k = 0; k < s; ++k) {
      const int i = start + k * step;
      acc += r[i];
      const int v = (int)((unsigned)p[i] + (unsigned)(int)acc);
      const int y = i / s, x = i - y * s;
      plane[(long long)(y0 + y) * pw + x0 + x] = min(max(v, 0), maxv);
    }
  }
  const int s4 = max(1, s >> 2);
  for (int i = threadIdx.x; i < s4 * s4; i += blockDim.x) {
    const int uy = i / s4, ux = i - uy * s4;
    order[(long long)((y0 >> 2) + uy) * ow + (x0 >> 2) + ux] = zis[b];
  }
}

}  // namespace

extern "C" int wave_commit_launch(int* plane, int h, int w, int* order,
                                  int ow, const int* pred, const int* resi,
                                  const int* xs, const int* ys,
                                  const int* zis, const int* bdpcm, int n,
                                  int s, int bit_depth, void* stream) {
  if (n < 0 || s < 4 || s > 64 || ow != (w + 3) / 4 || h < s || w < s)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  wave_commit_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(
      plane, w, order, ow, pred, resi, xs, ys, zis, bdpcm, s,
      (1 << bit_depth) - 1);
  return (int)cudaGetLastError();
}
