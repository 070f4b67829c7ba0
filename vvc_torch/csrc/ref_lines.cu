// Reference lines of N blocks of W x H from the original luma plane.
//
// Replaces vvc/enc/rdo.py:59 build_ref_lines_device (squares, W = H = S)
// and :86 build_ref_lines_device_rect (the MTT lattice's rectangles and
// the ISP sub-TUs): jitted jnp clamp-gathers on the TPU.  Output layout
// per block, length 2H+2W+3:
//   [ left[2H-1] .. left[0], corner, top[0] .. top[2W-1], top[2W-1] x2 ]
// with edge clamping inside the plane and the substitution at the frame
// edges (no row above: top/corner take left[0], or mid-grey when there is
// no column to the left either; no column to the left: left takes top[0]).
// `ref_lines_launch` is the square entry (4S+3 samples), counted as
// `ref_lines`; `ref_lines_rect_launch` the W x H one, counted as
// `ref_lines_rect`.  Both run the one kernel.
//
// `wave_ref_lines_launch` (counted as `wave_ref_lines`) is the decoder's:
// it replaces the per-leaf host build_ref_line of vvc/dec/wavefront.py:78-82
// (vvc/kernels/intra.py:147) for the N square S x S leaves of one wave,
// read from the plane reconstructed so far.  A sample is available iff it
// lies inside the plane and its 4x4 unit's order-map entry is below the
// leaf's z-order index zi (the sequential decoder's availability: the unit
// was reconstructed and precedes the leaf).  Unavailable samples read 0;
// then the substitution of spec 8.4.5.2.8 as build_ref_line does it: none
// available -> every sample 1 << (bd - 1); else each position takes the
// last available sample at or before it, positions before the first
// available one take that one; C[4S+1] = C[4S+2] = C[4S].  One CTA per
// leaf: each thread gathers samples and flags into shared memory, the
// first available index is an atomicMin, and each thread then looks back
// for its source (the line is at most 259 samples).  Bound: bytes, as the
// encoder's entry; in practice launch-bound (a wave holds a few leaves).
//
// Bound: bytes.  One thread per output sample; each reads one plane sample
// (neighbouring threads read neighbouring top samples) and writes one int.
// The whole output is a few MB at 1080p, so the kernel is launch-bound in
// practice; no shared memory or tiling is needed.
#include <cuda_runtime.h>

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void ref_lines_kernel(const int* __restrict__ plane, int ph,
                                 int pw, const int* __restrict__ xs,
                                 const int* __restrict__ ys, int n, int bw,
                                 int bh, int mid, int* __restrict__ out) {
  const int len = 2 * bh + 2 * bw + 3;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n * len) return;
  const int b = (int)(g / len);
  const int j = (int)(g - (long long)b * len);
  const int x0 = xs[b], y0 = ys[b];
  const int lx = clampi(x0 - 1, 0, pw - 1);
  const int ty = clampi(y0 - 1, 0, ph - 1);
  // raw clamped gathers: left[k] = plane[y0+k, x0-1], top[k] = plane[y0-1, x0+k]
  const int left0 = plane[clampi(y0, 0, ph - 1) * pw + lx];
  int v;
  if (j < 2 * bh) {
    const int k = 2 * bh - 1 - j;
    v = x0 > 0 ? plane[clampi(y0 + k, 0, ph - 1) * pw + lx]
               : (y0 > 0 ? plane[ty * pw + clampi(x0, 0, pw - 1)] : mid);
  } else if (j == 2 * bh) {
    v = y0 > 0 ? plane[ty * pw + lx] : (x0 > 0 ? left0 : mid);
  } else {
    const int k = min(j - 2 * bh - 1, 2 * bw - 1);
    v = y0 > 0 ? plane[ty * pw + clampi(x0 + k, 0, pw - 1)]
               : (x0 > 0 ? left0 : mid);
  }
  out[g] = v;
}

static int launch(const int* plane, int ph, int pw, const int* xs,
                  const int* ys, int n, int bw, int bh, int bit_depth,
                  int* out, void* stream) {
  if (n < 0 || bw < 1 || bw > 64 || bh < 1 || bh > 64)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * (2 * bh + 2 * bw + 3);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ref_lines_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      plane, ph, pw, xs, ys, n, bw, bh, 1 << (bit_depth - 1), out);
  return (int)cudaGetLastError();
}

extern "C" int ref_lines_launch(const int* plane, int h, int w, const int* xs,
                                const int* ys, int n, int s, int bit_depth,
                                int* out, void* stream) {
  return launch(plane, h, w, xs, ys, n, s, s, bit_depth, out, stream);
}

extern "C" int ref_lines_rect_launch(const int* plane, int h, int w,
                                     const int* xs, const int* ys, int n,
                                     int bw, int bh, int bit_depth, int* out,
                                     void* stream) {
  return launch(plane, h, w, xs, ys, n, bw, bh, bit_depth, out, stream);
}

namespace {

constexpr int kMaxLine = 4 * 64 + 3;

__global__ void wave_ref_lines_kernel(const int* __restrict__ plane, int ph,
                                      int pw, const int* __restrict__ order,
                                      int ow, const int* __restrict__ xs,
                                      const int* __restrict__ ys,
                                      const int* __restrict__ zis, int s,
                                      int mid, int* __restrict__ out) {
  __shared__ int c[kMaxLine];
  __shared__ unsigned char av[kMaxLine];
  __shared__ int first;
  const int b = blockIdx.x;
  const int x0 = xs[b], y0 = ys[b], zi = zis[b];
  const int len = 4 * s + 1;  // the two pads copy C[4S]
  if (threadIdx.x == 0) first = len;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    int px, py;
    bool ok;
    if (i < 2 * s) {  // left: C[2S-1-k] = plane[y0+k][x0-1]
      py = y0 + (2 * s - 1 - i);
      px = x0 - 1;
      ok = x0 > 0 && py < ph;
    } else if (i == 2 * s) {  // corner
      py = y0 - 1;
      px = x0 - 1;
      ok = x0 > 0 && y0 > 0;
    } else {  // top: C[2S+1+k] = plane[y0-1][x0+k]
      py = y0 - 1;
      px = x0 + (i - 2 * s - 1);
      ok = y0 > 0 && px < pw;
    }
    ok = ok && order[(long long)(py >> 2) * ow + (px >> 2)] < zi;
    c[i] = ok ? plane[(long long)py * pw + px] : 0;
    av[i] = ok;
    if (ok) atomicMin(&first, i);
  }
  __syncthreads();
  int* o = out + (long long)b * (len + 2);
  for (int i = threadIdx.x; i < len + 2; i += blockDim.x) {
    int v;
    if (first == len) {
      v = mid;
    } else {
      int j = min(i, len - 1);
      while (j >= 0 && !av[j]) --j;
      v = c[j >= 0 ? j : first];
    }
    o[i] = v;
  }
}

}  // namespace

extern "C" int wave_ref_lines_launch(const int* plane, int h, int w,
                                     const int* order, int ow, const int* xs,
                                     const int* ys, const int* zis, int n,
                                     int s, int bit_depth, int* out,
                                     void* stream) {
  if (n < 0 || s < 4 || s > 64 || ow != (w + 3) / 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  wave_ref_lines_kernel<<<n, 128, 0, (cudaStream_t)stream>>>(
      plane, h, w, order, ow, xs, ys, zis, s, 1 << (bit_depth - 1), out);
  return (int)cudaGetLastError();
}
