// CCLM on the device: the 4:2:0 luma downsample of a plane, and the
// per-block linear models (α, β) of the RD search's chroma decision.
//
// `luma_ds` replaces vvc/kernels/cclm.py:173 luma_ds_plane_jnp:
//   ds[y][x] = (L[2y][xm] + 2·L[2y][2x] + L[2y][xp]
//             + L[2y+1][xm] + 2·L[2y+1][2x] + L[2y+1][xp] + 4) >> 3,
//   xm = max(2x − 1, 0), xp = min(2x + 1, W − 1)   (columns clamped).
// One thread per output sample; bound: bytes (the plane read once, a
// quarter of it written: 8.3 MB and 2.1 MB for a 1080p frame, 0.003 ms).
//
// `cclm_models` replaces vvc/kernels/cclm.py:187 derive_models_batch_jnp,
// for one variant (1 LM, 2 LM_L, 3 LM_T) and one chroma plane per launch.
// One thread per block:
//   * the 4 neighbour points as jnp picks them — top and left both
//     available: 2 from the row above (x + cs/4, x + 3cs/4), 2 from the
//     column left (y + cs/4, y + 3cs/4); one side only: 4 points k·cs/4
//     along it; coordinates clamped into the plane;
//   * a STABLE sort of the 4 luma values (insertion sort, strict `>`), so
//     that tied luma values keep their order, as jnp.argsort(stable=True);
//   * lmin/lmax/cmin/cmax as the rounded means of the pairs;
//   * α = floor(((cmax − cmin) << 13) / den) with an explicit floor (C's
//     `/` truncates; the numerator can be negative), clamped to ±2^17;
//     β = cmin − ((α·lmin) >> 13), an arithmetic shift; den = 0 → (0,
//     cmin); no neighbour at all → (0, 1 << (bd − 1)).
// int32 throughout (|num| < 2^23, |α·lmin| < 2^27).  Bound: bytes — the
// distinct 32-B sectors of ds and chroma that the points fall in
// (neighbouring blocks share their row-above and left-column sectors;
// chip_smoke.py counts them per launch), plus xs, ys, α and β (16 B per
// block): 30.0 MB, about 0.009 ms at 3.35 TB/s, for the 24 launches
// (4 sizes, 2 planes, 3 variants) of a 1080p frame.
//
// `wave_cclm` is the decoder's CCLM prediction for the S x S chroma leaves
// of one wave, replacing the per-leaf host predict_cclm of
// vvc/dec/wavefront.py:100-104 (vvc/kernels/cclm.py:232).  Unlike
// `cclm_models` it follows gather_model_points with the decoder's
// availability: a point (px, py) counts iff it lies in the plane and its
// 4x4 unit's order-map entry is below the leaf's zi.  top_ok / left_ok
// test the samples right above and left of the leaf's corner; the points
// are taken in gather_model_points' order (the row above first), each
// coordinate clamped into the plane and dropped if unavailable; fewer than
// 4 points repeat as Python's `pts + pts` does (point j of the 4 is point
// j mod count); then derive_model (stable sort by luma, the rounded means,
// floor division, the ±2^17 clamp) and pred = clip(((α·ds) >> 13) + β).
// A leaf whose variant is 0 is not a CCLM leaf: its prediction is left as
// it is.  One CTA per leaf: thread 0 derives the model into shared memory,
// then every thread writes S·S/blockDim samples.  Bound: bytes — the
// leaf's ds block read and its prediction written (8 B per sample); a wave
// holds few leaves, so it is launch-bound.
#include <cuda_runtime.h>

namespace {

__global__ void luma_ds_kernel(const int* __restrict__ luma, int h, int w,
                               int* __restrict__ out) {
  const int hw = w >> 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(h >> 1) * hw) return;
  const int y = (int)(i / hw), x = (int)(i - (long long)y * hw);
  const int x0 = 2 * x;
  const int xm = max(x0 - 1, 0), xp = min(x0 + 1, w - 1);
  const int* r0 = luma + (long long)(2 * y) * w;
  const int* r1 = r0 + w;
  out[i] = (r0[xm] + 2 * r0[x0] + r0[xp] + r1[xm] + 2 * r1[x0] + r1[xp]
            + 4) >> 3;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void cclm_models_kernel(const int* __restrict__ ds,
                                   const int* __restrict__ chroma,
                                   const int* __restrict__ xs,
                                   const int* __restrict__ ys, int n, int ch,
                                   int cw, int cs, int bit_depth, int variant,
                                   int* __restrict__ alpha,
                                   int* __restrict__ beta) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int x = xs[b], y = ys[b];
  const bool top_ok = y > 0 && variant != 2;
  const bool left_ok = x > 0 && variant != 3;
  if (!top_ok && !left_ok) {
    alpha[b] = 0;
    beta[b] = 1 << (bit_depth - 1);
    return;
  }
  const bool both = top_ok && left_ok;
  const int q = cs / 4, q3 = 3 * cs / 4;
  int lum[4], chr[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool use_top;
    int xt, yl;
    if (both) {
      use_top = k < 2;
      xt = x + ((k & 1) ? q3 : q);
      yl = y + (k == 2 ? q : (k == 3 ? q3 : 0));
    } else {
      use_top = top_ok;
      xt = x + k * cs / 4;
      yl = y + k * cs / 4;
    }
    const int px = use_top ? min(xt, cw - 1) : max(x - 1, 0);
    const int py = use_top ? max(y - 1, 0) : min(yl, ch - 1);
    const long long o = (long long)py * cw + px;
    lum[k] = ds[o];
    chr[k] = chroma[o];
  }
  for (int i = 1; i < 4; ++i) {  // stable: an equal key stays behind
    const int kl = lum[i], kc = chr[i];
    int j = i - 1;
    while (j >= 0 && lum[j] > kl) {
      lum[j + 1] = lum[j];
      chr[j + 1] = chr[j];
      --j;
    }
    lum[j + 1] = kl;
    chr[j + 1] = kc;
  }
  const int lmin = (lum[0] + lum[1] + 1) >> 1;
  const int lmax = (lum[2] + lum[3] + 1) >> 1;
  const int cmin = (chr[0] + chr[1] + 1) >> 1;
  const int cmax = (chr[2] + chr[3] + 1) >> 1;
  const int den = lmax - lmin;
  if (den == 0) {
    alpha[b] = 0;
    beta[b] = cmin;
    return;
  }
  int a = floor_div((cmax - cmin) * (1 << 13), den);
  a = min(max(a, -(1 << 17)), (1 << 17) - 1);
  alpha[b] = a;
  beta[b] = cmin - ((a * lmin) >> 13);
}

__global__ void wave_cclm_kernel(const int* __restrict__ ds,
                                 const int* __restrict__ chroma, int ch,
                                 int cw, const int* __restrict__ order,
                                 int ow, const int* __restrict__ xs,
                                 const int* __restrict__ ys,
                                 const int* __restrict__ zis,
                                 const int* __restrict__ variants, int cs,
                                 int bit_depth, int* __restrict__ pred) {
  __shared__ int model[2];
  const int b = blockIdx.x;
  const int variant = variants[b];
  if (variant == 0) return;
  const int x0 = xs[b], y0 = ys[b], zi = zis[b];
  if (threadIdx.x == 0) {
    auto avail = [&](int px, int py) {
      return px >= 0 && px < cw && py >= 0 && py < ch &&
             order[(long long)(py >> 2) * ow + (px >> 2)] < zi;
    };
    const bool top_ok = y0 > 0 && avail(x0, y0 - 1) && variant != 2;
    const bool left_ok = x0 > 0 && avail(x0 - 1, y0) && variant != 3;
    int lum[4], chr[4], cnt = 0;
    for (int k = 0; k < 4 && (top_ok || left_ok); ++k) {
      bool top;
      int p;
      if (top_ok && left_ok) {
        top = k < 2;
        p = (k & 1) ? (3 * cs) / 4 : cs / 4;
      } else {
        top = top_ok;
        p = k * cs / 4;
      }
      const int px = top ? min(x0 + p, cw - 1) : x0 - 1;
      const int py = top ? y0 - 1 : min(y0 + p, ch - 1);
      if (avail(px, py)) {
        const long long o = (long long)py * cw + px;
        lum[cnt] = ds[o];
        chr[cnt] = chroma[o];
        ++cnt;
      }
    }
    int a = 0, bb = 1 << (bit_depth - 1);
    if (cnt > 0) {
      for (int k = cnt; k < 4; ++k) {  // pts + pts until four
        lum[k] = lum[k % cnt];
        chr[k] = chr[k % cnt];
      }
      for (int i = 1; i < 4; ++i) {  // stable: an equal key stays behind
        const int kl = lum[i], kc = chr[i];
        int j = i - 1;
        while (j >= 0 && lum[j] > kl) {
          lum[j + 1] = lum[j];
          chr[j + 1] = chr[j];
          --j;
        }
        lum[j + 1] = kl;
        chr[j + 1] = kc;
      }
      const int lmin = (lum[0] + lum[1] + 1) >> 1;
      const int lmax = (lum[2] + lum[3] + 1) >> 1;
      const int cmin = (chr[0] + chr[1] + 1) >> 1;
      const int cmax = (chr[2] + chr[3] + 1) >> 1;
      const int den = lmax - lmin;
      bb = cmin;
      if (den != 0) {
        a = floor_div((cmax - cmin) * (1 << 13), den);
        a = min(max(a, -(1 << 17)), (1 << 17) - 1);
        bb = cmin - ((a * lmin) >> 13);
      }
    }
    model[0] = a;
    model[1] = bb;
  }
  __syncthreads();
  const long long alpha = model[0];
  const int beta = model[1], maxv = (1 << bit_depth) - 1;
  int* o = pred + (long long)b * cs * cs;
  for (int i = threadIdx.x; i < cs * cs; i += blockDim.x) {
    const int y = i / cs, x = i - y * cs;
    const int v = (int)((alpha * ds[(long long)(y0 + y) * cw + x0 + x]) >> 13)
                  + beta;
    o[i] = min(max(v, 0), maxv);
  }
}

}  // namespace

extern "C" int wave_cclm_launch(const int* ds, const int* chroma, int ch,
                                int cw, const int* order, int ow,
                                const int* xs, const int* ys, const int* zis,
                                const int* variants, int n, int cs,
                                int bit_depth, int* pred, void* stream) {
  if (n < 0 || cs < 4 || cs > 32 || ow != (cw + 3) / 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  wave_cclm_kernel<<<n, 128, 0, (cudaStream_t)stream>>>(
      ds, chroma, ch, cw, order, ow, xs, ys, zis, variants, cs, bit_depth,
      pred);
  return (int)cudaGetLastError();
}

extern "C" int luma_ds_launch(const int* luma, int h, int w, int* out,
                              void* stream) {
  const long long total = (long long)(h >> 1) * (w >> 1);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  luma_ds_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(luma, h, w,
                                                                out);
  return (int)cudaGetLastError();
}

extern "C" int cclm_models_launch(const int* ds, const int* chroma,
                                  const int* xs, const int* ys, int n,
                                  int ch, int cw, int cs, int bit_depth,
                                  int variant, int* alpha, int* beta,
                                  void* stream) {
  if (n == 0) return 0;
  if (variant < 1 || variant > 3 || cs < 4) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  cclm_models_kernel<<<(n + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(ds, chroma, xs, ys, n, ch, cw,
                                               cs, bit_depth, variant, alpha,
                                               beta);
  return (int)cudaGetLastError();
}
