// Quarter-pel phase planes and the gather of predictions from them: the
// r4 motion-search engine's interpolation (two kernels).
//
// Replace the device functions of vvc/kernels/mc.py (jitted jnp programs on
// the TPU):
//   interp_planes <- :438 interp_luma_planes (body :456 _interp_impl)
//                    [H,W] int32 -> [4,4,H,W] int32, phase [fy][fx]
//   phase_gather  <- :482 gather_pred_planes
//                    [4,4,H,W] + block origins and qpel MVs [N] -> [N,S,S]
// Their plain twins are in vvc_torch/kernels/mc.py.  Both are exact
// integer functions: the horizontal 8-tap pass is kept unshifted in int32
// (|acc| <= 112 * (2^bd - 1)), the vertical pass too (<= 112^2 * (2^bd - 1)
// < 2^31 up to 16 bit), then (acc + 2048) >> 12 and the clip; the edges
// replicate (vvc pads 3 left/top and 4 right/bottom with mode="edge").
//
// Bounds (1080p reference): interp_planes reads the plane once and writes
// 16 planes (bytes; 384 integer multiply-adds per sample are well under
// the bytes' time); phase_gather reads and writes N*S*S samples (bytes).
// interp_planes stages a 15 x 39 tile of the plane in shared memory per
// 8 x 32 outputs, so each input sample is read from device memory about
// 2.3 times at most, and each thread keeps its 4 x 8 horizontal sums in
// registers; the 16 outputs of a sample go to 16 planes, coalesced along x.
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;   // outputs per tile row
constexpr int kTy = 8;    // outputs per tile column

__constant__ int kFilt[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

__global__ void interp_planes_kernel(const int* __restrict__ plane,
                                     int* __restrict__ out, int h, int w,
                                     int maxv) {
  __shared__ int tile[kTy + 7][kTx + 7];
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int i = tid; i < (kTy + 7) * (kTx + 7); i += kTx * kTy) {
    const int r = i / (kTx + 7), c = i % (kTx + 7);
    const int y = min(max(y0 + r - 3, 0), h - 1);
    const int x = min(max(x0 + c - 3, 0), w - 1);
    tile[r][c] = plane[(long long)y * w + x];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  // horizontal pass of the 8 rows this output needs, for each fx
  int hor[4][8];
#pragma unroll
  for (int fx = 0; fx < 4; ++fx)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc += kFilt[fx][k] * tile[threadIdx.y + r][threadIdx.x + k];
      hor[fx][r] = acc;
    }
  const long long hw = (long long)h * w;
  const long long at = (long long)y * w + x;
#pragma unroll
  for (int fy = 0; fy < 4; ++fy)
#pragma unroll
    for (int fx = 0; fx < 4; ++fx) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kFilt[fy][k] * hor[fx][k];
      out[(fy * 4 + fx) * hw + at] = min(max((acc + 2048) >> 12, 0), maxv);
    }
}

// One thread per predicted sample: the phase from the MV's two low bits,
// the integer part by an arithmetic shift, both coordinates clamped to
// the plane (vvc's jnp.clip of the gather indices).
__global__ void phase_gather_kernel(const int* __restrict__ planes,
                                    const int* __restrict__ xs,
                                    const int* __restrict__ ys,
                                    const int* __restrict__ mvx,
                                    const int* __restrict__ mvy,
                                    int* __restrict__ out, int n, int s,
                                    int h, int w) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ss = (long long)s * s;
  if (g >= (long long)n * ss) return;
  const int b = (int)(g / ss);
  const int i = (int)((g % ss) / s), j = (int)(g % s);
  const int vx = mvx[b], vy = mvy[b];
  const int yy = min(max(ys[b] + (vy >> 2) + i, 0), h - 1);
  const int xx = min(max(xs[b] + (vx >> 2) + j, 0), w - 1);
  const long long hw = (long long)h * w;
  out[g] = planes[((vy & 3) * 4 + (vx & 3)) * hw + (long long)yy * w + xx];
}

}  // namespace

extern "C" int interp_planes_launch(const int* plane, int* out, int h, int w,
                                    int maxv, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTx, kTy);
  const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy);
  interp_planes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(plane, out,
                                                                 h, w, maxv);
  return (int)cudaGetLastError();
}

extern "C" int phase_gather_launch(const int* planes, const int* xs,
                                   const int* ys, const int* mvx,
                                   const int* mvy, int* out, int n, int s,
                                   int h, int w, void* stream) {
  const long long total = (long long)n * s * s;
  if (total == 0) return 0;
  const int threads = 256;
  phase_gather_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(planes, xs, ys, mvx, mvy,
                                                   out, n, s, h, w);
  return (int)cudaGetLastError();
}
