// Reference lines of N square blocks from the original luma plane.
//
// Replaces vvc/enc/rdo.py:59 build_ref_lines_device (a jitted jnp
// clamp-gather on the TPU).  Output layout per block, length 4S+3:
//   [ left[2S-1] .. left[0], corner, top[0] .. top[2S-1], top[2S-1] x2 ]
// with edge clamping inside the plane and the substitution at the frame
// edges (no row above: top/corner take left[0], or mid-grey when there is
// no column to the left either; no column to the left: left takes top[0]).
//
// Bound: bytes.  One thread per output sample; each reads one plane sample
// (neighbouring threads read neighbouring top samples) and writes one int.
// The whole output is a few MB at 1080p, so the kernel is launch-bound in
// practice; no shared memory or tiling is needed.
#include <cuda_runtime.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void ref_lines_kernel(const int* __restrict__ plane, int h, int w,
                                 const int* __restrict__ xs,
                                 const int* __restrict__ ys, int n, int s,
                                 int mid, int* __restrict__ out) {
  const int len = 4 * s + 3;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * len) return;
  const int b = (int)(g / len);
  const int j = (int)(g - (long long)b * len);
  const int x0 = xs[b], y0 = ys[b];
  const int lx = clampi(x0 - 1, 0, w - 1);
  const int ty = clampi(y0 - 1, 0, h - 1);
  // raw clamped gathers: left[k] = plane[y0+k, x0-1], top[k] = plane[y0-1, x0+k]
  const int left0 = plane[clampi(y0, 0, h - 1) * w + lx];
  int v;
  if (j < 2 * s) {
    const int k = 2 * s - 1 - j;
    v = x0 > 0 ? plane[clampi(y0 + k, 0, h - 1) * w + lx]
               : (y0 > 0 ? plane[ty * w + clampi(x0, 0, w - 1)] : mid);
  } else if (j == 2 * s) {
    v = y0 > 0 ? plane[ty * w + lx] : (x0 > 0 ? left0 : mid);
  } else {
    const int k = min(j - 2 * s - 1, 2 * s - 1);
    v = y0 > 0 ? plane[ty * w + clampi(x0 + k, 0, w - 1)]
               : (x0 > 0 ? left0 : mid);
  }
  out[g] = v;
}

extern "C" int ref_lines_launch(const int* plane, int h, int w, const int* xs,
                                const int* ys, int n, int s, int bit_depth,
                                int* out, void* stream) {
  const long long total = (long long)n * (4 * s + 3);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ref_lines_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      plane, h, w, xs, ys, n, s, 1 << (bit_depth - 1), out);
  return (int)cudaGetLastError();
}
