// Window motion estimation of the inter search and of MCTF: five kernels.
//
// Replace the device functions of vvc/enc/me.py that the inter search's
// program (2) runs for every P and B picture (jitted jnp/lax programs on
// the TPU):
//   me_prep   <- :73  _prep_ref        edge pad by 16 + 4x4-mean ds4 plane
//   me_coarse <- :108 _coarse_program  full search on ds4, 17x17 offsets
//   me_int    <- :150 _gather_windows, :156 _win_centers, :167 _int_refine
//   me_qpel   <- :203 _qpel_refine     49 quarter-pel offsets, DCTIF + SATD
//   me_block_err <- the tail of :423 me_pred_v2 (MCTF): prediction plane and
//                the per-16x16-block float32 mean of (pred - cur)^2
// and one of vvc/enc/inter_search.py (the r4 engine, below):
//   me_full   <- :70  _int_me_dev      full search over (2R+1)^2 offsets
// Their plain twins are in vvc_torch/enc/me.py; the float32 costs are
// bit-equal to vvc's on XLA-CPU: XLA's own log is read from a table
// (mvb[|d|] = fma(log(1+|d|), 2/ln 2, 1), built on the host), the costs
// are fma(sqrt(lambda), bits_y + bits_x, sse) with one rounding
// (__fmaf_rn), and sums follow XLA's order where float32 rounds (below).
// Every argmin keeps the first minimum, as vvc's strict `<` scans do.
//
// Bounds (1080p inter picture): me_prep and me_coarse move a few MB (bytes);
// me_int does 81 SSEs of s*s samples per block and me_qpel 7 horizontal
// and 49 vertical 8-tap passes plus 49 SATDs per block (integer operations,
// CUDA cores); me_block_err reads the prediction and the picture and writes
// the plane once (bytes).
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 16;    // PAD
constexpr int kR2 = 4;      // integer refine radius
constexpr int kWinM = 10;   // window margin (R2 + M2)
constexpr int kM2 = 6;      // re-centred window margin
constexpr int kR = 8;       // COARSE_R
constexpr int kD = 2 * kR + 1;

// ---------------------------------------------------------------------------
// me_prep: one thread per output sample.  pp[y][x] = plane[clamp(y-16)]
// [clamp(x-16)]; ds[y][x] = floor(sum of the 4x4 block of the plane
// edge-padded to a multiple of 4, / 16).  Bound: bytes.
// ---------------------------------------------------------------------------
__global__ void me_prep_kernel(const int* __restrict__ plane,
                               int* __restrict__ pp, int* __restrict__ ds,
                               int h, int w, int pad) {
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const int h4 = (h + 3) / 4, w4 = (w + 3) / 4;
  const long long npp = (long long)hp * wp;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < npp) {
    const int y = (int)(i / wp), x = (int)(i % wp);
    const int sy = min(max(y - pad, 0), h - 1);
    const int sx = min(max(x - pad, 0), w - 1);
    pp[i] = plane[(long long)sy * w + sx];
  } else if (i < npp + (long long)h4 * w4) {
    const int j = (int)(i - npp);
    const int y0 = (j / w4) * 4, x0 = (j % w4) * 4;
    int s = 0;
    for (int dy = 0; dy < 4; ++dy)
      for (int dx = 0; dx < 4; ++dx)
        s += plane[(long long)min(y0 + dy, h - 1) * w + min(x0 + dx, w - 1)];
    ds[j] = s >> 4;   // floor division by 16
  }
}

// ---------------------------------------------------------------------------
// me_coarse: one CTA per (ref, 16x16 ds4 region) = one c16 cell, four c8
// cells, sixteen c4 cells.  256 threads = 16 c4 cells x 16 displacement
// groups; group g takes d = g, g+16, ... in increasing order.  Per d:
// c4 = (float)(exact integer SSE of the 4x4 ds samples, zero outside the
// h4 x w4 plane) + bias[d]; c8 = (c4_00 + c4_01) + (c4_10 + c4_11) and
// c16 likewise from the c8 (the order of vvc's program, read from its
// IR).  Each thread keeps its first minimum over its own d (strict <);
// the 16 groups then meet in a lexicographic (cost, d) minimum, which is
// the first minimum over all d.  The reference is read edge-clamped (the
// jnp.pad(mode="edge") of vvc).  Bound: operations (289 x 256 SSE terms
// per CTA), small.
// ---------------------------------------------------------------------------
__global__ void me_coarse_kernel(const int* __restrict__ yds,
                                 const int* __restrict__ refds,
                                 const float* __restrict__ bias,
                                 int* __restrict__ g4, int* __restrict__ g8,
                                 int* __restrict__ g16, int h4, int w4,
                                 int n4y, int n4x) {
  __shared__ int cur[16][16];
  __shared__ int ref[16 + 2 * kR][16 + 2 * kR];
  __shared__ float c4s[16][16];
  __shared__ float c8s[16][4];
  __shared__ float bc[3][16][16];
  __shared__ int bd[3][16][16];
  const int rx = blockIdx.x, ry = blockIdx.y, r = blockIdx.z;
  const int y0 = ry * 16, x0 = rx * 16;
  const int tid = threadIdx.x;
  const int* rp = refds + (long long)r * h4 * w4;
  {
    const int py = tid >> 4, px = tid & 15;
    const int yy = y0 + py, xx = x0 + px;
    cur[py][px] = (yy < h4 && xx < w4) ? yds[yy * w4 + xx] : -1;
  }
  for (int i = tid; i < (16 + 2 * kR) * (16 + 2 * kR); i += blockDim.x) {
    const int py = i / (16 + 2 * kR), px = i % (16 + 2 * kR);
    const int yy = min(max(y0 + py - kR, 0), h4 - 1);
    const int xx = min(max(x0 + px - kR, 0), w4 - 1);
    ref[py][px] = rp[yy * w4 + xx];
  }
  __syncthreads();
  const int cell = tid & 15, g = tid >> 4;
  const int cy4 = cell >> 2, cx4 = cell & 3;
  float b4 = __int_as_float(0x7f800000), b8 = b4, b16 = b4;
  int a4 = 0, a8 = 0, a16 = 0;
  for (int it = 0; it < (kD * kD + 15) / 16; ++it) {
    const int d = g + 16 * it;
    const bool ok = d < kD * kD;
    if (ok) {
      const int dy = d / kD - kR, dx = d % kD - kR;
      int s = 0;
      for (int py = 0; py < 4; ++py)
        for (int px = 0; px < 4; ++px) {
          const int yy = cy4 * 4 + py, xx = cx4 * 4 + px;
          const int c = cur[yy][xx];
          if (c >= 0) {
            const int e = c - ref[yy + dy + kR][xx + dx + kR];
            s += e * e;
          }
        }
      const float c4 = __fadd_rn((float)s, bias[d]);
      c4s[g][cell] = c4;
      if (c4 < b4) { b4 = c4; a4 = d; }
    }
    __syncthreads();
    if (ok && cell < 4) {
      const int q = ((cell >> 1) * 2) * 4 + (cell & 1) * 2;   // top-left c4
      const float c8 = __fadd_rn(__fadd_rn(c4s[g][q], c4s[g][q + 1]),
                                 __fadd_rn(c4s[g][q + 4], c4s[g][q + 5]));
      c8s[g][cell] = c8;
      if (c8 < b8) { b8 = c8; a8 = d; }
    }
    __syncthreads();
    if (ok && cell == 4) {
      const float c16 = __fadd_rn(__fadd_rn(c8s[g][0], c8s[g][1]),
                                  __fadd_rn(c8s[g][2], c8s[g][3]));
      if (c16 < b16) { b16 = c16; a16 = d; }
    }
    __syncthreads();
  }
  bc[0][g][cell] = b4;  bd[0][g][cell] = a4;
  bc[1][g][cell] = b8;  bd[1][g][cell] = a8;
  bc[2][g][cell] = b16; bd[2][g][cell] = a16;
  __syncthreads();
  if (g == 0) {
    for (int lvl = 0; lvl < 3; ++lvl) {
      const int ncell = lvl == 0 ? 16 : (lvl == 1 ? 4 : 1);
      const int src = lvl == 2 ? 4 : cell;   // the c16 tracker is cell 4
      if (cell >= ncell) continue;
      float bcost = bc[lvl][0][src];
      int barg = bd[lvl][0][src];
      for (int gg = 1; gg < 16; ++gg) {
        const float c = bc[lvl][gg][src];
        const int a = bd[lvl][gg][src];
        if (c < bcost || (c == bcost && a < barg)) { bcost = c; barg = a; }
      }
      const int mvy = (barg / kD - kR) * 4, mvx = (barg % kD - kR) * 4;
      int* out;
      long long idx;
      if (lvl == 0) {
        out = g4;
        idx = ((long long)r * n4y + ry * 4 + cy4) * n4x + rx * 4 + cx4;
      } else if (lvl == 1) {
        out = g8;
        idx = ((long long)r * (n4y / 2) + ry * 2 + (cell >> 1)) * (n4x / 2)
              + rx * 2 + (cell & 1);
      } else {
        out = g16;
        idx = ((long long)r * (n4y / 4) + ry) * (n4x / 4) + rx;
      }
      out[2 * idx] = mvy;
      out[2 * idx + 1] = mvx;
    }
  }
}

// ---------------------------------------------------------------------------
// me_int: one CTA per block.  Clips the coarse centre as _win_centers
// (min(max(c, lo), hi)), clamps the window start as lax.dynamic_slice,
// loads the (S+20)^2 window and the block, and evaluates the 81 integer
// displacements in raster order (dy outer): each warp takes candidates
// k = warp, warp+8, ..., its lanes sum d^2 exactly in 64-bit integers.  At
// or above 2^24 the float32 sum of vvc's program is recomputed in XLA's
// order: row-major from 0 (S = 8, 16, 32), or four 32x32 windows row-major
// then (W00 + W01) + (W10 + W11) (S = 64).  Cost = fma(sqrt(lambda),
// mvb[|4(cy+dy)|] + mvb[|4(cx+dx)|], sse); the first minimum wins.
// Writes the integer MV (iy, ix) and the clipped centre.  The re-centred
// window w2 is not written: me_qpel reads it from refpad.
// ---------------------------------------------------------------------------
template <int S>
__global__ void me_int_kernel(const int* __restrict__ refpad,
                              const int* __restrict__ ob,
                              const int* __restrict__ ys,
                              const int* __restrict__ xs,
                              const int* __restrict__ cy_in,
                              const int* __restrict__ cx_in,
                              const float* __restrict__ mvb, int hp, int wp,
                              float lam_m, int h, int w,
                              int* __restrict__ iy_out,
                              int* __restrict__ ix_out,
                              int* __restrict__ cy_out,
                              int* __restrict__ cx_out) {
  constexpr int WS = S + 2 * kWinM;
  constexpr int NC = (2 * kR2 + 1) * (2 * kR2 + 1);
  __shared__ int win[WS * WS];
  __shared__ int blk[S * S];
  __shared__ float cost[NC];
  const int n = blockIdx.x;
  const int by = ys[n], bx = xs[n];
  const int cy = min(max(cy_in[n], kWinM - (by + kPad)),
                     (h + kPad - WS) - by + kWinM);
  const int cx = min(max(cx_in[n], kWinM - (bx + kPad)),
                     (w + kPad - WS) - bx + kWinM);
  const int sy = min(max(by + kPad + cy - kWinM, 0), hp - WS);
  const int sx = min(max(bx + kPad + cx - kWinM, 0), wp - WS);
  for (int i = threadIdx.x; i < WS * WS; i += blockDim.x)
    win[i] = refpad[(long long)(sy + i / WS) * wp + sx + i % WS];
  for (int i = threadIdx.x; i < S * S; i += blockDim.x)
    blk[i] = ob[(long long)n * S * S + i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int k = warp; k < NC; k += nwarps) {
    const int dy = k / (2 * kR2 + 1) - kR2, dx = k % (2 * kR2 + 1) - kR2;
    const int t = dy + kWinM, l = dx + kWinM;
    long long acc = 0;
    for (int i = lane; i < S * S; i += 32) {
      const long long e = win[(t + i / S) * WS + l + i % S] - blk[i];
      acc += e * e;
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float sse;
      if (acc < (1LL << 24)) {
        sse = (float)acc;
      } else if (S == 64) {
        float wv[4];
        for (int q = 0; q < 4; ++q) {
          const int r0 = (q >> 1) * 32, c0 = (q & 1) * 32;
          float a = 0.f;
          for (int rr = 0; rr < 32; ++rr)
            for (int cc = 0; cc < 32; ++cc) {
              const int e = win[(t + r0 + rr) * WS + l + c0 + cc]
                            - blk[(r0 + rr) * S + c0 + cc];
              a = __fadd_rn(a, (float)(e * e));
            }
          wv[q] = a;
        }
        sse = __fadd_rn(__fadd_rn(wv[0], wv[1]), __fadd_rn(wv[2], wv[3]));
      } else {
        float a = 0.f;
        for (int i = 0; i < S * S; ++i) {
          const int e = win[(t + i / S) * WS + l + i % S] - blk[i];
          a = __fadd_rn(a, (float)(e * e));
        }
        sse = a;
      }
      const float bits = __fadd_rn(mvb[abs(4 * (cy + dy))],
                                   mvb[abs(4 * (cx + dx))]);
      cost[k] = __fmaf_rn(lam_m, bits, sse);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int kb = 0;
    float cb = cost[0];
    for (int k = 1; k < NC; ++k)
      if (cost[k] < cb) { cb = cost[k]; kb = k; }
    iy_out[n] = cy + kb / (2 * kR2 + 1) - kR2;
    ix_out[n] = cx + kb % (2 * kR2 + 1) - kR2;
    cy_out[n] = cy;
    cx_out[n] = cx;
  }
}

// ---------------------------------------------------------------------------
// me_qpel: one CTA per block.  Loads the re-centred window w2 (M = S+12
// square at padded (ys+16+iy-6, xs+16+ix-6)).  For each horizontal phase
// qx = -3..3: the horizontal 8-tap pass into shared memory (unshifted, or
// <<6 at fx = 0), then 7 (qy) x T (8x8 tiles) jobs, one per thread: the
// vertical pass of the tile (unshifted, or <<6 at fy = 0), (acc+2048)>>12,
// clip, difference with the block, 8x8 Hadamard, (sum|.|+2)>>2, added to
// the candidate's SATD with a shared integer atomic (exact).  Then the
// costs fma(sqrt(lambda), mvb[|mvy|] + mvb[|mvx|], (float)satd) are
// scanned in vvc's order (qy outer, qx inner) for the first minimum, and
// the winner's prediction is recomputed and written.  The CTA has as many
// threads as a phase has jobs, rounded to warps (32 at S = 8 and 16, 128
// at 32, 256 at 64), so that small blocks do not leave most idle.  int32
// is enough:
// the largest magnitude is about 1023 * 112 * 112 < 1.3e7 (10 bit).
// ---------------------------------------------------------------------------
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

template <int S>
__device__ void hor_pass(const int* w2, int* hor, const int* filt, int qx) {
  constexpr int M = S + 2 * kM2;
  const int ixo = qx >> 2, fx = qx & 3;
  const int c0 = ixo + kM2 - 3;
  for (int i = threadIdx.x; i < M * S; i += blockDim.x) {
    const int r = i / S, c = i % S;
    int acc;
    if (fx == 0) {
      acc = w2[r * M + kM2 + c] << 6;
    } else {
      acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc += filt[fx * 8 + k] * w2[r * M + c0 + k + c];
    }
    hor[i] = acc;
  }
}

__device__ __forceinline__ int ver_pass(const int* hor, const int* filt, int S,
                                        int qy, int r, int c, int maxv) {
  const int iyo = qy >> 2, fy = qy & 3;
  int acc;
  if (fy == 0) {
    acc = hor[(kM2 + r) * S + c] << 6;
  } else {
    const int r0 = iyo + kM2 - 3;
    acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc += filt[fy * 8 + k] * hor[(r0 + k + r) * S + c];
  }
  return min(max((acc + 2048) >> 12, 0), maxv);
}

template <int S>
__global__ void me_qpel_kernel(const int* __restrict__ refpad,
                               const int* __restrict__ ob,
                               const int* __restrict__ ys,
                               const int* __restrict__ xs,
                               const int* __restrict__ iy,
                               const int* __restrict__ ix,
                               const int* __restrict__ filt_g,
                               const float* __restrict__ mvb, int wp,
                               float lam_m, int maxv,
                               int* __restrict__ mvy_out,
                               int* __restrict__ mvx_out,
                               float* __restrict__ cost_out,
                               int* __restrict__ pred_out) {
  constexpr int M = S + 2 * kM2;
  constexpr int T = (S / 8) * (S / 8);
  __shared__ int w2[M * M];
  __shared__ int hor[M * S];
  __shared__ int satd[49];
  __shared__ int filt[32];
  __shared__ int win_q;
  const int n = blockIdx.x;
  const int oy = ys[n] + kPad + iy[n] - kM2, ox = xs[n] + kPad + ix[n] - kM2;
  for (int i = threadIdx.x; i < M * M; i += blockDim.x)
    w2[i] = refpad[(long long)(oy + i / M) * wp + ox + i % M];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) filt[i] = filt_g[i];
  for (int i = threadIdx.x; i < 49; i += blockDim.x) satd[i] = 0;
  const int* o = ob + (long long)n * S * S;
  __syncthreads();
  for (int qxi = 0; qxi < 7; ++qxi) {
    hor_pass<S>(w2, hor, filt, qxi - 3);
    __syncthreads();
    for (int j = threadIdx.x; j < 7 * T; j += blockDim.x) {
      const int qyi = j / T, tile = j % T;
      const int ty = (tile / (S / 8)) * 8, tx = (tile % (S / 8)) * 8;
      int d[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          d[r][c] = ver_pass(hor, filt, S, qyi - 3, ty + r, tx + c, maxv)
                    - o[(ty + r) * S + tx + c];
        fwht8(d[r]);
      }
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
      atomicAdd(&satd[qyi * 7 + qxi], (sum + 2) >> 2);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int kb = 0;
    float cb = 0.f;
    for (int k = 0; k < 49; ++k) {
      const int mvy = 4 * iy[n] + k / 7 - 3, mvx = 4 * ix[n] + k % 7 - 3;
      const float bits = __fadd_rn(mvb[abs(mvy)], mvb[abs(mvx)]);
      const float c = __fmaf_rn(lam_m, bits, (float)satd[k]);
      if (k == 0 || c < cb) { cb = c; kb = k; }
    }
    mvy_out[n] = 4 * iy[n] + kb / 7 - 3;
    mvx_out[n] = 4 * ix[n] + kb % 7 - 3;
    cost_out[n] = cb;
    win_q = kb;
  }
  __syncthreads();
  const int kb = win_q;
  hor_pass<S>(w2, hor, filt, kb % 7 - 3);
  __syncthreads();
  for (int i = threadIdx.x; i < S * S; i += blockDim.x)
    pred_out[(long long)n * S * S + i] =
        ver_pass(hor, filt, S, kb / 7 - 3, i / S, i % S, maxv);
}

// ---------------------------------------------------------------------------
// me_block_err: one CTA of 256 threads per 16x16 block (raster order).  Each
// thread writes one sample of the prediction plane and its squared
// difference; thread 0 then sums the 256 squares in vvc's float32 order
// (read from the LLVM IR and x86 object code of its me_pred_v2 program):
// per row, the running total joins lane 0 of 8 lanes, the row's two parts
// of 8 are added lane-wise, then ((l0+l4)+(l2+l6)) + ((l1+l5)+(l3+l7)).
// Below 2^24 every partial sum is exact.  err = total * (1/256), exact.
// ---------------------------------------------------------------------------
__global__ void me_block_err_kernel(const int* __restrict__ pred,
                                    const int* __restrict__ cur, int w,
                                    int nx, int* __restrict__ plane,
                                    float* __restrict__ err) {
  __shared__ float sq[256];
  const int n = blockIdx.x;
  const int by = n / nx, bx = n % nx;
  const int i = threadIdx.x;
  const int y = by * 16 + (i >> 4), x = bx * 16 + (i & 15);
  const int p = pred[(long long)n * 256 + i];
  plane[(long long)y * (nx * 16) + x] = p;
  const int d = p - cur[(long long)y * w + x];
  sq[i] = (float)(d * d);
  __syncthreads();
  if (i == 0) {
    float tot = 0.f;
    for (int r = 0; r < 16; ++r) {
      float l[8];
      for (int j = 0; j < 8; ++j) l[j] = sq[r * 16 + j];
      l[0] = __fadd_rn(tot, l[0]);
      for (int j = 0; j < 8; ++j) l[j] = __fadd_rn(l[j], sq[r * 16 + 8 + j]);
      tot = __fadd_rn(__fadd_rn(__fadd_rn(l[0], l[4]), __fadd_rn(l[2], l[6])),
                      __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
    }
    err[n] = __fmul_rn(tot, 0.00390625f);
  }
}

template <int S>
int launch_int(const int* refpad, const int* ob, const int* ys, const int* xs,
               const int* cy, const int* cx, const float* mvb, int hp, int wp,
               float lam_m, int n, int h, int w, int* iy, int* ix, int* cyo,
               int* cxo, cudaStream_t st) {
  me_int_kernel<S><<<n, 256, 0, st>>>(refpad, ob, ys, xs, cy, cx, mvb, hp, wp,
                                      lam_m, h, w, iy, ix, cyo, cxo);
  return (int)cudaGetLastError();
}

template <int S>
int launch_qpel(const int* refpad, const int* ob, const int* ys, const int* xs,
                const int* iy, const int* ix, const int* filt,
                const float* mvb,
                int wp, int n, float lam_m, int maxv, int* mvy, int* mvx,
                float* cost, int* pred, cudaStream_t st) {
  // one thread per (qy, tile) job of a horizontal phase: 7·(S/8)² jobs
  constexpr int kThreads = S <= 16 ? 32 : (S == 32 ? 128 : 256);
  me_qpel_kernel<S><<<n, kThreads, 0, st>>>(refpad, ob, ys, xs, iy, ix, filt,
                                            mvb, wp, lam_m, maxv, mvy, mvx,
                                            cost, pred);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int me_prep_launch(const int* plane, int* pp, int* ds, int h, int w,
                              int pad, void* stream) {
  const long long total = (long long)(h + 2 * pad) * (w + 2 * pad)
                          + (long long)((h + 3) / 4) * ((w + 3) / 4);
  const int threads = 256;
  me_prep_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(plane, pp, ds, h, w, pad);
  return (int)cudaGetLastError();
}

extern "C" int me_coarse_launch(const int* yds, const int* refds,
                                const float* bias, int* g4, int* g8, int* g16,
                                int nref, int h4, int w4, int n4y, int n4x,
                                void* stream) {
  if (n4y % 4 || n4x % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid(n4x / 4, n4y / 4, nref);
  me_coarse_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      yds, refds, bias, g4, g8, g16, h4, w4, n4y, n4x);
  return (int)cudaGetLastError();
}

extern "C" int me_block_err_launch(const int* pred, const int* cur, int w,
                                   int ny, int nx, int* plane, float* err,
                                   void* stream) {
  me_block_err_kernel<<<ny * nx, 256, 0, (cudaStream_t)stream>>>(
      pred, cur, w, nx, plane, err);
  return (int)cudaGetLastError();
}

extern "C" int me_int_launch(const int* refpad, const int* ob, const int* ys,
                             const int* xs, const int* cy, const int* cx,
                             const float* mvb, int hp, int wp, float lam_m,
                             int n, int s, int h, int w, int* iy, int* ix,
                             int* cyo, int* cxo, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ME_INT(S)                                                          \
  return launch_int<S>(refpad, ob, ys, xs, cy, cx, mvb, hp, wp, lam_m, n, h, \
                       w, iy, ix, cyo, cxo, st)
  switch (s) {
    case 8: ME_INT(8);
    case 16: ME_INT(16);
    case 32: ME_INT(32);
    case 64: ME_INT(64);
  }
#undef ME_INT
  return (int)cudaErrorInvalidValue;
}

extern "C" int me_qpel_launch(const int* refpad, const int* ob, const int* ys,
                              const int* xs, const int* iy, const int* ix,
                              const int* filt, const float* mvb, int wp, int n,
                              float lam_m, int s, int maxv, int* mvy, int* mvx,
                              float* cost, int* pred, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ME_QPEL(S)                                                        \
  return launch_qpel<S>(refpad, ob, ys, xs, iy, ix, filt, mvb, wp, n, lam_m, \
                        maxv, mvy, mvx, cost, pred, st)
  switch (s) {
    case 8: ME_QPEL(8);
    case 16: ME_QPEL(16);
    case 32: ME_QPEL(32);
    case 64: ME_QPEL(64);
  }
#undef ME_QPEL
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// me_full: vvc/enc/inter_search.py:70 _int_me_dev, the r4 engine's integer
// full search.  One CTA per block.  The (S+2R)^2 window (edge-clamped to
// the picture, as vvc's clipped gather) and the block go to shared memory;
// then, as vvc computes it in float32:
//   ii   = the integral image of win^2: two cumsums, along y then x, each
//          in XLA-CPU's blocked order (its reduce-window rewrite: blocks of
//          16, a sequential prefix inside each, plus the sequential sum of
//          the earlier blocks' totals), zero-padded on the top and left;
//   e    = ((ii[d+S][d'+S] - ii[d+S][d']) - ii[d][d'+S]) + ii[d][d'];
//   corr = the correlation, summed exactly in integers and rounded once
//          (vvc's grouped convolution is a runtime Eigen call whose order
//          is not reproduced; below 2^24, as at 8 bit and S <= 16, every
//          order gives the exact value);
//   cost = fma(lam, bits(4(cy+d-R)) + bits(4(cx+d'-R)), e - 2 corr).
// Thread t scores the offsets t, t + 256, ... (raster order, dy outer)
// keeping its first minimum; a lexicographic (cost, index) reduction then
// gives the first minimum of all.  Bound: operations, (2R+1)^2 S^2
// multiply-adds per block on the CUDA cores.
// ---------------------------------------------------------------------------
namespace {

__device__ __forceinline__ void xla_prefix(float* v, int n, int stride) {
  // v[0], v[stride], ... <- their float32 prefix sums in XLA-CPU's order
  float base = 0.0f;
  for (int b = 0; b < n; b += 16) {
    float acc = 0.0f;
    const int e = min(b + 16, n);
    for (int i = b; i < e; ++i) {
      acc = __fadd_rn(acc, v[i * stride]);
      v[i * stride] = __fadd_rn(acc, base);
    }
    base = __fadd_rn(base, acc);
  }
}

template <typename Acc>
__global__ void me_full_kernel(const int* __restrict__ blocks,
                               const int* __restrict__ ref,
                               const int* __restrict__ xs,
                               const int* __restrict__ ys,
                               const int* __restrict__ cx0,
                               const int* __restrict__ cy0,
                               const float* __restrict__ mvb, float lam_m,
                               int s, int r, int h, int w,
                               int* __restrict__ mvx, int* __restrict__ mvy) {
  extern __shared__ int smem[];
  const int L = s + 2 * r, D = 2 * r + 1, L1 = L + 1;
  int* win = smem;                              // L*L
  int* blk = win + L * L;                       // s*s
  float* ii = (float*)(blk + s * s);            // (L+1)^2
  float* rc = ii + L1 * L1;                     // blockDim.x costs
  int* ri = (int*)(rc + blockDim.x);            // blockDim.x indices
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cx = cx0[b], cy = cy0[b];
  const int oy = ys[b] + cy - r, ox = xs[b] + cx - r;
  for (int i = tid; i < L * L; i += blockDim.x) {
    const int y = min(max(oy + i / L, 0), h - 1);
    const int x = min(max(ox + i % L, 0), w - 1);
    win[i] = ref[(long long)y * w + x];
  }
  for (int i = tid; i < s * s; i += blockDim.x)
    blk[i] = blocks[(long long)b * s * s + i];
  for (int i = tid; i < L1; i += blockDim.x) {
    ii[i] = 0.0f;
    ii[i * L1] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < L * L; i += blockDim.x) {
    const float v = (float)win[i];
    ii[(i / L + 1) * L1 + i % L + 1] = __fmul_rn(v, v);
  }
  __syncthreads();
  if (tid < L) xla_prefix(ii + L1 + tid + 1, L, L1);    // along y
  __syncthreads();
  if (tid < L) xla_prefix(ii + (tid + 1) * L1 + 1, L, 1);  // along x
  __syncthreads();
  float best = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int k = tid; k < D * D; k += blockDim.x) {
    const int dy = k / D, dx = k % D;
    Acc corr = 0;
    for (int i = 0; i < s; ++i) {
      const int* wr = win + (dy + i) * L + dx;
      const int* br = blk + i * s;
      for (int j = 0; j < s; ++j) corr += (Acc)wr[j] * (Acc)br[j];
    }
    const float e = __fadd_rn(
        __fsub_rn(__fsub_rn(ii[(dy + s) * L1 + dx + s], ii[(dy + s) * L1 + dx]),
                  ii[dy * L1 + dx + s]),
        ii[dy * L1 + dx]);
    const float sse = __fsub_rn(e, __fmul_rn(2.0f, (float)corr));
    const float bits = __fadd_rn(mvb[abs(4 * (cy + dy - r))],
                                 mvb[abs(4 * (cx + dx - r))]);
    const float c = __fmaf_rn(lam_m, bits, sse);
    if (c < best) {
      best = c;
      bi = k;
    }
  }
  rc[tid] = best;
  ri[tid] = bi;
  __syncthreads();
  for (int off = blockDim.x >> 1; off > 0; off >>= 1) {
    if (tid < off) {
      const float c2 = rc[tid + off];
      const int i2 = ri[tid + off];
      if (c2 < rc[tid] || (c2 == rc[tid] && i2 < ri[tid])) {
        rc[tid] = c2;
        ri[tid] = i2;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    mvx[b] = cx + ri[0] % D - r;
    mvy[b] = cy + ri[0] / D - r;
  }
}

}  // namespace

extern "C" int me_full_launch(const int* blocks, const int* ref,
                              const int* xs, const int* ys, const int* cx0,
                              const int* cy0, const float* mvb, float lam_m,
                              int n, int s, int r, int h, int w, int maxv,
                              int* mvx, int* mvy, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int L = s + 2 * r;
  const size_t smem = (size_t)(L * L + s * s) * sizeof(int)
      + (size_t)(L + 1) * (L + 1) * sizeof(float)
      + (size_t)threads * (sizeof(float) + sizeof(int));
  // the correlation fits 32 unsigned bits when s^2 maxv^2 < 2^32
  const bool narrow = (double)s * s * maxv * (double)maxv < 4294967296.0;
  cudaError_t err;
  if (narrow) {
    err = cudaFuncSetAttribute(me_full_kernel<unsigned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    me_full_kernel<unsigned><<<n, threads, smem, (cudaStream_t)stream>>>(
        blocks, ref, xs, ys, cx0, cy0, mvb, lam_m, s, r, h, w, mvx, mvy);
  } else {
    err = cudaFuncSetAttribute(me_full_kernel<unsigned long long>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    me_full_kernel<unsigned long long>
        <<<n, threads, smem, (cudaStream_t)stream>>>(
            blocks, ref, xs, ys, cx0, cy0, mvb, lam_m, s, r, h, w, mvx, mvy);
  }
  return (int)cudaGetLastError();
}
