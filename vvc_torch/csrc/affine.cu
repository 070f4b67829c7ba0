// Affine motion search of the inter search: two kernels.
//
// Replace the device functions of vvc/enc/me.py that the inter search's
// program (2) runs with affine on, per size 16, 32 and 64 and per list
// (reference 0), for every P and B picture (jitted jnp/lax programs on the
// TPU):
//   affine_search <- :272 affine_search_win   corner-delta CPMV search
//   affine_dctif  <- :374 _affine_dctif_pred  the winner's 8-tap prediction
// and, below, affine_gn <- vvc/kernels/affine.py:253 affine_me_batch (the
// r4 engine's Gauss-Newton CPMV search, :295 _affine_me_jit).
// Their plain twins are in vvc_torch/enc/me.py.  Both read vvc's re-centred
// window w2 ((S+12)^2 samples at padded (ys+16+iy-6, xs+16+ix-6)) from the
// padded reference into shared memory.
//
// affine_search: one CTA per block.  vvc scores 49 candidates (da, db) of
// AFF_DELTAS x AFF_DELTAS (da outer), then 8 +-1 steps around the running
// best, each step depending on the one before; the first minimum wins
// (strict <).  A candidate's prediction is bilinear per 4x4 subblock at
// the position M2 + (q0 + dq)/4, dq = ((da*cu - db*cv)/S, (db*cu + da*cv)/S)
// with cu, cv the subblock centre relative to the block centre.  vvc
// computes it in float32 with one-hot sums over 13 taps, but only two taps
// of each pass are non-zero and all values are exact (|da|, |db| <= 16 keep
// every position a multiple of 1/128 inside [1.5, 10.5]: 17 bits after the
// row pass, 24 after the column pass), so the kernel computes the same
// numbers in int32 scaled by 128^2 and rounds half to even (jnp.round).
// The SATD is the 8x8 Hadamard of the satd kernel.  Costs, as XLA-CPU
// computes them (read from vvc's optimised HLO and LLVM IR, jax 0.9.0):
// X = abits[|da|] + mvb[|db|] (abits = fma(log(1+|d|), 2/ln 2, 19), XLA's
// fold of AFFINE_BITS + bits(da)); stage 1 adds the scalar product
// sqrt(lambda)*X apart (two roundings), stage 2 contracts it into one FMA.
// Stage 1's 49 x (S/8)^2 tile jobs run in parallel, each adding its SATD to
// its candidate's sum with a shared integer atomic (exact); stage 2's
// steps run one after the other, (S/8)^2 tile jobs each.  The kernel also
// writes the winner's per-subblock quarter-pel offsets
// clip(round(q0 + dq), -12, 11) (half to even) for affine_dctif.
//
// affine_dctif: one CTA per block; each thread computes output samples as
// the exact int32 sum of the separable 8-tap DCTIF at its subblock's
// offsets (sum_t F[fy][t] * sum_t' F[fx][t'] * w2, below 2^24 at 10 bit as
// in vvc's float32 sums), then clip(round(sum / 4096)), half to even.
//
// Bounds (1080p picture, reference 0 of one list, N = 8040 / 1980 / 480
// blocks at S = 16 / 32 / 64): operations, 57 candidates x S^2 samples x
// (bilinear + difference + 8x8 Hadamard) on the CUDA cores for
// affine_search; 64 multiply-adds per sample for affine_dctif (small).
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 16;   // PAD
constexpr int kM2 = 6;     // re-centred window margin
constexpr int kSc = 128;   // bilinear position scale (7 fractional bits)
__constant__ int kDeltas[7] = {-8, -4, -2, 0, 2, 4, 8};
__constant__ int kSteps[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                 {0, 1},   {1, -1}, {1, 0},  {1, 1}};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ void fwht8(int* v) {
#pragma unroll
  for (int len = 1; len < 8; len <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i & len) == 0) {
        const int a = v[i], b = v[i + len];
        v[i] = a + b;
        v[i + len] = a - b;
      }
    }
  }
}

// SATD of one 8x8 tile (ty, tx) of candidate (da, db)'s bilinear
// prediction against the block.
template <int S>
__device__ int tile_satd(const int* w2, const int* blk, int q0y, int q0x,
                         int da, int db, int ty, int tx, int maxv) {
  constexpr int M = S + 2 * kM2;
  int d[8][8];
#pragma unroll
  for (int sv = 0; sv < 2; ++sv) {
#pragma unroll
    for (int su = 0; su < 2; ++su) {
      const int v = (ty >> 2) + sv, u = (tx >> 2) + su;
      const int cu = 4 * u + 2 - S / 2, cv = 4 * v + 2 - S / 2;
      // position * 128 = M2*128 + 32*q0 + 32*num/S (num even: exact)
      const int by = kM2 * kSc + 32 * q0y + (32 * (db * cu + da * cv)) / S;
      const int bx = kM2 * kSc + 32 * q0x + (32 * (da * cu - db * cv)) / S;
      const int iby = by >> 7, ay = by & (kSc - 1);
      const int ibx = bx >> 7, ax = bx & (kSc - 1);
#pragma unroll
      for (int py = 0; py < 4; ++py) {
        const int y = 4 * v + py;
        const int* r0 = w2 + (y + iby) * M + 4 * u + ibx;
        const int* r1 = r0 + M;
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int a = (kSc - ay) * r0[px] + ay * r1[px];
          const int b = (kSc - ay) * r0[px + 1] + ay * r1[px + 1];
          const int p = (kSc - ax) * a + ax * b;   // < 2^24
          int q = p >> 14;
          const int rem = p & 16383;
          q += (rem > 8192 || (rem == 8192 && (q & 1))) ? 1 : 0;
          q = min(max(q, 0), maxv);
          const int x = 4 * u + px;
          d[4 * sv + py][4 * su + px] = q - blk[y * S + x];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) fwht8(d[r]);
  int sum = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) col[r] = d[r][c];
    fwht8(col);
#pragma unroll
    for (int r = 0; r < 8; ++r) sum += abs(col[r]);
  }
  return (sum + 2) >> 2;
}

template <int S>
__device__ void load_w2(const int* refpad, int wp, int oy, int ox, int* w2) {
  constexpr int M = S + 2 * kM2;
  for (int i = threadIdx.x; i < M * M; i += blockDim.x)
    w2[i] = refpad[(long long)(oy + i / M) * wp + ox + i % M];
}

template <int S>
__global__ void affine_search_kernel(
    const int* __restrict__ refpad, const int* __restrict__ ob,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const int* __restrict__ mvy0, const int* __restrict__ mvx0,
    const int* __restrict__ iy, const int* __restrict__ ix,
    const float* __restrict__ abits, const float* __restrict__ mvb, int wp,
    float lam_m, int maxv, float* __restrict__ cost_out,
    int* __restrict__ da_out, int* __restrict__ db_out,
    int* __restrict__ qy_out, int* __restrict__ qx_out) {
  constexpr int M = S + 2 * kM2;
  constexpr int T = (S / 8) * (S / 8);
  constexpr int NSB = S / 4;
  __shared__ int w2[M * M];
  __shared__ int blk[S * S];
  __shared__ int satd[49];
  __shared__ float best_c;
  __shared__ int best_a, best_b;
  const int n = blockIdx.x;
  const int q0y = mvy0[n] - 4 * iy[n], q0x = mvx0[n] - 4 * ix[n];
  load_w2<S>(refpad, wp, ys[n] + kPad + iy[n] - kM2,
             xs[n] + kPad + ix[n] - kM2, w2);
  for (int i = threadIdx.x; i < S * S; i += blockDim.x)
    blk[i] = ob[(long long)n * S * S + i];
  for (int i = threadIdx.x; i < 49; i += blockDim.x) satd[i] = 0;
  __syncthreads();
  // stage 1: the 49 grid candidates, all tiles in parallel
  for (int j = threadIdx.x; j < 49 * T; j += blockDim.x) {
    const int c = j / T, tile = j % T;
    const int ty = (tile / (S / 8)) * 8, tx = (tile % (S / 8)) * 8;
    atomicAdd(&satd[c], tile_satd<S>(w2, blk, q0y, q0x, kDeltas[c / 7],
                                     kDeltas[c % 7], ty, tx, maxv));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bc = __int_as_float(0x7f800000);
    int ba = 0, bb = 0;
    for (int c = 0; c < 49; ++c) {
      const int da = kDeltas[c / 7], db = kDeltas[c % 7];
      const float x = __fadd_rn(abits[abs(da)], mvb[abs(db)]);
      const float cst = __fadd_rn((float)satd[c], __fmul_rn(lam_m, x));
      if (cst < bc) { bc = cst; ba = da; bb = db; }
    }
    best_c = bc; best_a = ba; best_b = bb;
    satd[0] = 0;
  }
  __syncthreads();
  // stage 2: 8 unit steps, each around the running best
  for (int k = 0; k < 8; ++k) {
    const int da = best_a + kSteps[k][0], db = best_b + kSteps[k][1];
    for (int tile = threadIdx.x; tile < T; tile += blockDim.x) {
      const int ty = (tile / (S / 8)) * 8, tx = (tile % (S / 8)) * 8;
      atomicAdd(&satd[0], tile_satd<S>(w2, blk, q0y, q0x, da, db, ty, tx,
                                       maxv));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const float x = __fadd_rn(abits[abs(da)], mvb[abs(db)]);
      const float cst = __fmaf_rn(lam_m, x, (float)satd[0]);
      if (cst < best_c) { best_c = cst; best_a = da; best_b = db; }
      satd[0] = 0;
    }
    __syncthreads();
  }
  const int da = best_a, db = best_b;
  if (threadIdx.x == 0) {
    cost_out[n] = best_c;
    da_out[n] = da;
    db_out[n] = db;
  }
  // the winner's DCTIF offsets: clip(round(q0 + num/S), -12, 11)
  for (int i = threadIdx.x; i < NSB * NSB; i += blockDim.x) {
    const int v = i / NSB, u = i % NSB;
    const int cu = 4 * u + 2 - S / 2, cv = 4 * v + 2 - S / 2;
    const int ty = q0y * S + db * cu + da * cv;
    const int tx = q0x * S + da * cu - db * cv;
    int qy = floor_div(ty, S), qx = floor_div(tx, S);
    const int ry = 2 * (ty - qy * S), rx = 2 * (tx - qx * S);
    qy += (ry > S || (ry == S && (qy & 1))) ? 1 : 0;
    qx += (rx > S || (rx == S && (qx & 1))) ? 1 : 0;
    qy_out[(long long)n * NSB * NSB + i] = min(max(qy, -12), 11);
    qx_out[(long long)n * NSB * NSB + i] = min(max(qx, -12), 11);
  }
}

template <int S>
__global__ void affine_dctif_kernel(const int* __restrict__ refpad,
                                    const int* __restrict__ ys,
                                    const int* __restrict__ xs,
                                    const int* __restrict__ iy,
                                    const int* __restrict__ ix,
                                    const int* __restrict__ qy,
                                    const int* __restrict__ qx,
                                    const int* __restrict__ filt_g, int wp,
                                    int maxv, int* __restrict__ pred) {
  constexpr int M = S + 2 * kM2;
  constexpr int NSB = S / 4;
  __shared__ int w2[M * M];
  __shared__ int filt[32];
  const int n = blockIdx.x;
  load_w2<S>(refpad, wp, ys[n] + kPad + iy[n] - kM2,
             xs[n] + kPad + ix[n] - kM2, w2);
  for (int i = threadIdx.x; i < 32; i += blockDim.x) filt[i] = filt_g[i];
  __syncthreads();
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int y = i / S, x = i % S;
    const long long sb = (long long)n * NSB * NSB + (y >> 2) * NSB + (x >> 2);
    const int q_y = qy[sb], q_x = qx[sb];
    const int* fy = filt + (q_y & 3) * 8;
    const int* fx = filt + (q_x & 3) * 8;
    const int* row = w2 + (y + (q_y >> 2) + 3) * M + x + (q_x >> 2) + 3;
    int acc = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      int h = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) h += fx[u] * row[t * M + u];
      acc += fy[t] * h;
    }
    int q = acc >> 12;   // floor
    const int rem = acc & 4095;
    q += (rem > 2048 || (rem == 2048 && (q & 1))) ? 1 : 0;
    pred[(long long)n * S * S + i] = min(max(q, 0), maxv);
  }
}

template <int S>
int launch_search(const int* refpad, const int* ob, const int* ys,
                  const int* xs, const int* mvy0, const int* mvx0,
                  const int* iy, const int* ix, const float* abits,
                  const float* mvb, int wp, int n, float lam_m, int maxv,
                  float* cost, int* da, int* db, int* qy, int* qx,
                  cudaStream_t st) {
  affine_search_kernel<S><<<n, 256, 0, st>>>(refpad, ob, ys, xs, mvy0, mvx0,
                                             iy, ix, abits, mvb, wp, lam_m,
                                             maxv, cost, da, db, qy, qx);
  return (int)cudaGetLastError();
}

template <int S>
int launch_dctif(const int* refpad, const int* ys, const int* xs,
                 const int* iy, const int* ix, const int* qy, const int* qx,
                 const int* filt, int wp, int n, int maxv, int* pred,
                 cudaStream_t st) {
  affine_dctif_kernel<S><<<n, 256, 0, st>>>(refpad, ys, xs, iy, ix, qy, qx,
                                            filt, wp, maxv, pred);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int affine_search_launch(const int* refpad, const int* ob,
                                    const int* ys, const int* xs,
                                    const int* mvy0, const int* mvx0,
                                    const int* iy, const int* ix,
                                    const float* abits, const float* mvb,
                                    int wp, int n, float lam_m, int s,
                                    int maxv, float* cost, int* da, int* db,
                                    int* qy, int* qx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define AFF_SEARCH(S)                                                       \
  return launch_search<S>(refpad, ob, ys, xs, mvy0, mvx0, iy, ix, abits, mvb, \
                          wp, n, lam_m, maxv, cost, da, db, qy, qx, st)
  switch (s) {
    case 16: AFF_SEARCH(16);
    case 32: AFF_SEARCH(32);
    case 64: AFF_SEARCH(64);
  }
#undef AFF_SEARCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int affine_dctif_launch(const int* refpad, const int* ys,
                                   const int* xs, const int* iy,
                                   const int* ix, const int* qy,
                                   const int* qx, const int* filt, int wp,
                                   int n, int s, int maxv, int* pred,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define AFF_DCTIF(S) \
  return launch_dctif<S>(refpad, ys, xs, iy, ix, qy, qx, filt, wp, n, maxv, \
                         pred, st)
  switch (s) {
    case 16: AFF_DCTIF(16);
    case 32: AFF_DCTIF(32);
    case 64: AFF_DCTIF(64);
  }
#undef AFF_DCTIF
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// affine_gn: vvc/kernels/affine.py:253 affine_me_batch (:295 _affine_me_jit,
// :274 _solve_small).  One CTA of 256 threads per block, `iters`
// Gauss-Newton steps of a 4- or 6-parameter model.  Every operation is one
// float32 rounding in vvc's written order (__f*_rn: nothing is contracted):
// per step the bilinear warp of the reference at positions clipped to
// [0, w - 1.001] into shared memory, the gradients with a wrap at the block
// edge (jnp.roll), the basis, then the NPAR(NPAR+1)/2 entries of B^T B and
// the NPAR of B^T e.  Each of those S^2-term sums takes the port's order,
// shared with the plain twin (vvc_torch/kernels/affine.py _lane_sum): lane
// t of min(256, S^2) sums the products t, t + 256, ... from 0, then a
// halving tree over the lanes in shared memory.  Thread 0 solves
// [A + 0.01 I | rhs] by vvc's unpivoted Gauss-Jordan and updates theta.
// Then the corner MVs, rounded half to even (jnp.round) and clipped to
// +-2^17.  Bound: operations, about 60 per sample and step (warp, gradient,
// basis, 14 or 27 product-sums), small against the launch at 1080p.
// ---------------------------------------------------------------------------
namespace {

template <int NPAR>
__device__ __forceinline__ void gn_field(const float* th, float x, float y,
                                         float* vx, float* vy) {
  if constexpr (NPAR == 4) {
    *vx = __fsub_rn(__fadd_rn(th[0], __fmul_rn(th[2], x)), __fmul_rn(th[3], y));
    *vy = __fadd_rn(__fadd_rn(th[1], __fmul_rn(th[3], x)), __fmul_rn(th[2], y));
  } else {
    *vx = __fadd_rn(__fadd_rn(th[0], __fmul_rn(th[2], x)), __fmul_rn(th[4], y));
    *vy = __fadd_rn(__fadd_rn(th[1], __fmul_rn(th[3], x)), __fmul_rn(th[5], y));
  }
}

template <int NPAR>
__global__ void affine_gn_kernel(const float* __restrict__ blocks,
                                 const float* __restrict__ ref,
                                 const int* __restrict__ xs,
                                 const int* __restrict__ ys,
                                 const int* __restrict__ mv0x,
                                 const int* __restrict__ mv0y, int s, int h,
                                 int w, int iters, float hx, float hy,
                                 int* __restrict__ out) {
  constexpr int NA = NPAR * (NPAR + 1) / 2;   // entries of A (i <= j)
  constexpr int NQ = NA + NPAR;               // + rhs
  extern __shared__ float sm[];
  const int ss = s * s;
  const int lanes = ss < 256 ? ss : 256;
  float* pred = sm;                 // ss
  float* err = pred + ss;           // ss
  float* part = err + ss;           // NQ * lanes
  __shared__ float th[NPAR];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* blk = blocks + (long long)b * ss;
  const float xf = (float)xs[b], yf = (float)ys[b];
  if (tid < NPAR)
    th[tid] = tid == 0 ? __fdiv_rn((float)mv0x[b], 4.0f)
              : tid == 1 ? __fdiv_rn((float)mv0y[b], 4.0f) : 0.0f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int p = tid; p < ss; p += blockDim.x) {
      const float gx = (float)(p % s), gy = (float)(p / s);
      float vx, vy;
      gn_field<NPAR>(th, gx, gy, &vx, &vy);
      const float px = fminf(fmaxf(__fadd_rn(__fadd_rn(xf, gx), vx), 0.0f), hx);
      const float py = fminf(fmaxf(__fadd_rn(__fadd_rn(yf, gy), vy), 0.0f), hy);
      const float x0 = floorf(px), y0 = floorf(py);
      const float ax = __fsub_rn(px, x0), ay = __fsub_rn(py, y0);
      const int x0i = (int)x0, y0i = (int)y0;
      const int x1i = min(x0i + 1, w - 1), y1i = min(y0i + 1, h - 1);
      const float p00 = ref[(long long)y0i * w + x0i];
      const float p01 = ref[(long long)y0i * w + x1i];
      const float p10 = ref[(long long)y1i * w + x0i];
      const float p11 = ref[(long long)y1i * w + x1i];
      const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
      const float r0 = __fadd_rn(__fmul_rn(bx, p00), __fmul_rn(ax, p01));
      const float r1 = __fadd_rn(__fmul_rn(bx, p10), __fmul_rn(ax, p11));
      const float v = __fadd_rn(__fmul_rn(by, r0), __fmul_rn(ay, r1));
      pred[p] = v;
      err[p] = __fsub_rn(blk[p], v);
    }
    __syncthreads();
    if (tid < lanes) {
      float acc[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;
      for (int p = tid; p < ss; p += lanes) {
        const int i = p / s, j = p % s;
        const float* row = pred + i * s;
        const float gx = __fdiv_rn(
            __fsub_rn(row[(j + 1) % s], row[(j + s - 1) % s]), 2.0f);
        const float gy = __fdiv_rn(
            __fsub_rn(pred[((i + 1) % s) * s + j], pred[((i + s - 1) % s) * s + j]),
            2.0f);
        const float X = (float)j, Y = (float)i;
        float bv[NPAR];
        bv[0] = gx;
        bv[1] = gy;
        if constexpr (NPAR == 4) {
          bv[2] = __fadd_rn(__fmul_rn(gx, X), __fmul_rn(gy, Y));
          bv[3] = __fadd_rn(__fmul_rn(-gx, Y), __fmul_rn(gy, X));
        } else {
          bv[2] = __fmul_rn(gx, X);
          bv[3] = __fmul_rn(gy, X);
          bv[4] = __fmul_rn(gx, Y);
          bv[5] = __fmul_rn(gy, Y);
        }
        int q = 0;
#pragma unroll
        for (int u = 0; u < NPAR; ++u)
#pragma unroll
          for (int v = u; v < NPAR; ++v, ++q)
            acc[q] = __fadd_rn(acc[q], __fmul_rn(bv[u], bv[v]));
        const float e = err[p];
#pragma unroll
        for (int u = 0; u < NPAR; ++u)
          acc[NA + u] = __fadd_rn(acc[NA + u], __fmul_rn(bv[u], e));
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) part[q * lanes + tid] = acc[q];
    }
    __syncthreads();
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      for (int k = tid; k < NQ * off; k += blockDim.x) {
        const int q = k / off, t = k % off;
        part[q * lanes + t] = __fadd_rn(part[q * lanes + t],
                                        part[q * lanes + t + off]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      float m[NPAR][NPAR + 1];
      int q = 0;
      for (int u = 0; u < NPAR; ++u)
        for (int v = u; v < NPAR; ++v, ++q) {
          const float a = part[q * lanes];
          m[u][v] = u == v ? __fadd_rn(a, 0.01f) : a;
          m[v][u] = m[u][v];
        }
      for (int u = 0; u < NPAR; ++u) m[u][NPAR] = part[(NA + u) * lanes];
      for (int k = 0; k < NPAR; ++k) {
        const float d = m[k][k];
        for (int c = 0; c <= NPAR; ++c) m[k][c] = __fdiv_rn(m[k][c], d);
        for (int r = 0; r < NPAR; ++r) {
          if (r == k) continue;
          const float f = m[r][k];
          for (int c = 0; c <= NPAR; ++c)
            m[r][c] = __fsub_rn(m[r][c], __fmul_rn(f, m[k][c]));
        }
      }
      for (int u = 0; u < NPAR; ++u) th[u] = __fadd_rn(th[u], m[u][NPAR]);
    }
    __syncthreads();
  }
  if (tid < 3) {
    const float px = tid == 1 ? (float)s : 0.0f;
    const float py = tid == 2 ? (float)s : 0.0f;
    float c[2];
    gn_field<NPAR>(th, px, py, &c[0], &c[1]);
    for (int k = 0; k < 2; ++k) {
      const float r = fminf(fmaxf(rintf(__fmul_rn(c[k], 4.0f)), -131072.0f),
                            131071.0f);
      out[((long long)b * 3 + tid) * 2 + k] = (int)r;
    }
  }
}

}  // namespace

extern "C" int affine_gn_launch(const float* blocks, const float* ref,
                                const int* xs, const int* ys, const int* mv0x,
                                const int* mv0y, int n, int s, int h, int w,
                                int npar, int iters, float hx, float hy,
                                int* out, void* stream) {
  if (n == 0) return 0;
  if (npar != 4 && npar != 6) return (int)cudaErrorInvalidValue;
  const int ss = s * s, lanes = ss < 256 ? ss : 256;
  const int nq = npar * (npar + 1) / 2 + npar;
  const size_t smem = (size_t)(2 * ss + nq * lanes) * sizeof(float);
  cudaError_t err;
  if (npar == 4) {
    err = cudaFuncSetAttribute(affine_gn_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    affine_gn_kernel<4><<<n, 256, smem, (cudaStream_t)stream>>>(
        blocks, ref, xs, ys, mv0x, mv0y, s, h, w, iters, hx, hy, out);
  } else {
    err = cudaFuncSetAttribute(affine_gn_kernel<6>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    affine_gn_kernel<6><<<n, 256, smem, (cudaStream_t)stream>>>(
        blocks, ref, xs, ys, mv0x, mv0y, s, h, w, iters, hx, hy, out);
  }
  return (int)cudaGetLastError();
}
