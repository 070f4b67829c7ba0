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
// me_int does 81 SSEs of s*s samples per block and me_qpel filters 3
// horizontal and 12 vertical phase planes and takes 49 SATDs per block
// (operations, CUDA cores); me_block_err reads the prediction and the
// picture and writes the plane once (bytes).
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
// me_qpel: the 49 quarter-pel candidates (qy, qx) in ±3 around the integer
// winner (iy, ix).  Every candidate's prediction is a sub-window of one of
// 16 phase planes P[fy][fx] of (S+1)^2 samples:
//   pred(qy, qx)[r][c] = P[fy][fx][r + 1 + iyo][c + 1 + ixo],
//   fy = qy & 3, iyo = qy >> 2 (-1 or 0), and likewise fx, ixo.
// With W the window w2[2 .. S+9][2 .. S+9] (w2: the re-centred window at
// padded (ys+16+iy-6, xs+16+ix-6)):
//   H[fx][a][j] = sum_k f[fx][k] W[a][j+k]   (fx = 1..3, unshifted)
//   H[0][a][j]  = W[a][j+3] << 6
//   P[fy][fx][i][j] = clip((sum_k f[fy][k] H[fx][i+k][j] + 2048) >> 12)
//                     (fy = 1..3), or clip(((H[fx][i+3][j] << 6) + 2048)
//                     >> 12) at fy = 0
// — vvc's two passes (the horizontal unshifted or << 6 at fx = 0, the
// vertical unshifted or << 6 at fy = 0, then (acc + 2048) >> 12 and the
// clip), each plane filtered once instead of once per candidate.  The
// arithmetic is float32 on the CUDA cores: every value is an integer below
// 1023 * 112 * 112 < 1.3e7 < 2^24, so each FMA, the + 2048, the * 2^-12 and
// the floor are exact; the SATD's differences, butterflies and sums stay
// below 2^23 too.
//
// A CTA takes NB blocks (4 at S = 8, else 1) and walks each block in row
// strips of R rows (R = S at S <= 16, 8 above, so that a strip's planes fit
// in shared memory beside the others of the SM): per strip it loads the
// R+8 window rows it needs (plain loads converted to float: a window row
// starts at any column, so 16-byte cp.async does not apply, and the load
// is a few percent of the work), filters the 4 horizontal planes, then
// the 16 phase planes on its R+1 rows, then scores the 49 candidates on
// the strip's 8x8 tiles.  A tile's SATD is taken by 8 lanes, lane c holding
// its column: the 8-point Hadamard down the column in registers, across
// the 8 lanes by xor shuffles, then sum |.| by shuffles and
// (sum + 2) >> 2 for the tile (vvc rounds per tile).  The CTA has 7 x U
// such 8-lane groups, U = the tiles of all its blocks' strips: group g
// scores tile g % U for qx = g / U - 3 and the 7 qy in turn, so that every
// lane has a job in each of the 7 rounds, lanes next to each other read
// samples next to each other, and each lane keeps its block column in
// registers.  The tiles' SATDs go to shared memory per (candidate, tile)
// and are summed per candidate (integers, no atomics), the costs
// fma(sqrt(lambda), mvb[|mvy|] + mvb[|mvx|], (float)satd) follow, and a
// warp per block takes the lexicographic (cost, k) minimum, k = (qy+3)*7 +
// (qx+3) — the first minimum of vvc's strict `<` scan in qy-outer order.
// The winner's prediction is copied from its plane where the block was one
// strip; a strip-mined block (S = 32, 64) has lost its planes by then and
// filters the winner's one plane once more.  Bound: operations (the three
// horizontal planes, the twelve vertical ones and 49 SATDs of S^2 samples,
// CUDA cores; no tensor cores: the values need exact 24-bit products).
// ---------------------------------------------------------------------------
template <int F>
__device__ __forceinline__ float luma_tap8(const float* x) {
  // the normative 8-tap luma DCTIF, phases 0, 1/4, 1/2, 3/4
  constexpr int kF[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                            {-1, 4, -10, 58, 17, -5, 1, 0},
                            {-1, 4, -11, 40, 40, -11, 4, -1},
                            {0, 1, -5, 17, 58, -10, 4, -1}};
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (kF[F][k] != 0) acc = __fmaf_rn((float)kF[F][k], x[k], acc);
  return acc;
}

__device__ __forceinline__ float luma_tap8(int f, const float* x) {
  switch (f) {
    case 1: return luma_tap8<1>(x);
    case 2: return luma_tap8<2>(x);
    case 3: return luma_tap8<3>(x);
  }
  return __fmul_rn(x[3], 64.f);
}

// (acc + 2048) >> 12, clipped to [0, maxv]: exact for integer |acc| < 2^24
__device__ __forceinline__ float qpel_round(float acc, float maxf) {
  return fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(acc, 2048.f), 1.f / 4096.f)),
                     0.f), maxf);
}

template <int S, int R, int NB>
struct QpelShape {
  static constexpr int TX = S / 8;             // tiles in a row
  static constexpr int TS = (R / 8) * TX;      // tiles in a strip
  static constexpr int U = NB * TS;            // tiles of the CTA's strips
  static constexpr int THREADS = 56 * U;       // 7 candidate rounds x U x 8
  static constexpr int NSTRIP = S / R;
  static constexpr int WW = S + 8;             // window row
  static constexpr int HR = R + 8;             // window / H rows of a strip
  static constexpr int HP = S + 1;             // H row
  static constexpr int HPL = HR * HP;          // one H plane
  // P row: at S = 16 a warp's four tiles are 2 x 2, and 18 puts their
  // columns on four distinct bank octets
  static constexpr int PP = S == 16 ? 18 : S + 1;
  static constexpr int PPL = (R + 1) * PP;     // one P plane (strip)
  static constexpr int PB0 = 16 * PPL;
  // the blocks' P areas 8 banks apart (mod 32), for the same reason
  static constexpr int PB = NB == 1 ? PB0 : PB0 + ((8 - PB0 % 32) + 32) % 32;
  static constexpr int SMEM_WORDS = NB * PB + NB * 4 * HPL + 49 * U
                                    + 49 * NB + 3 * NB;
  static_assert(HR * WW <= PB0, "the window must fit in the P area");
  static_assert(NB == 1 || NSTRIP == 1, "several blocks only unstripped");
  static_assert(THREADS / 32 >= NB, "a warp per block for the argmin");
  // the final pass of a strip-mined block: its whole window and one
  // horizontal plane in the P and H areas
  static_assert(NSTRIP == 1 || (S + 8) * (S + 8) + (S + 8) * (S + 1)
                                   <= PB + 4 * HPL, "final pass");
};

// `rows` window rows from row0 + 2 and the columns 2 .. S+9 of each
// block's w2, as float, into W (which shares the P area); org[b] is the
// offset of w2[2][2] in refpad, -1 past n
template <int S, int R, int NB>
__device__ __forceinline__ void qpel_load_window(
    float* W, const int* __restrict__ refpad, const long long* org, int wp,
    int row0, int rows) {
  using Q = QpelShape<S, R, NB>;
  for (int i = threadIdx.x; i < NB * rows * Q::WW; i += Q::THREADS) {
    const int b = i / (rows * Q::WW), rem = i % (rows * Q::WW);
    const int a = rem / Q::WW, x = rem % Q::WW;
    W[b * Q::PB + rem] = org[b] < 0 ? 0.f : (float)refpad[
        org[b] + (long long)(row0 + a) * wp + x];
  }
}

template <int S, int R, int NB>
__global__ void __launch_bounds__(QpelShape<S, R, NB>::THREADS)
me_qpel_kernel(const int* __restrict__ refpad, const int* __restrict__ ob,
               const int* __restrict__ ys, const int* __restrict__ xs,
               const int* __restrict__ iy, const int* __restrict__ ix,
               const float* __restrict__ mvb, int wp, int n, float lam_m,
               int maxv, int* __restrict__ mvy_out,
               int* __restrict__ mvx_out, float* __restrict__ cost_out,
               int* __restrict__ pred_out) {
  using Q = QpelShape<S, R, NB>;
  extern __shared__ __align__(16) float qpel_smem[];
  long long* org = (long long*)qpel_smem;      // [NB] window origins
  float* Ps = qpel_smem + 2 * NB;              // NB x [16][R+1][PP]
  float* Hs = Ps + NB * Q::PB;                 // NB x [4][R+8][S+1]
  int* ts = (int*)(Hs + NB * 4 * Q::HPL);      // [49][U] tile SATDs
  float* cs = (float*)(ts + 49 * Q::U);        // [NB][49] costs
  int* win = (int*)(cs + 49 * NB);             // [NB] winners
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NB;
  if (tid < NB) {
    const int nb = n0 + tid;
    org[tid] = nb < n ? (long long)(ys[nb] + kPad + iy[nb] - kM2 + 2) * wp
                            + xs[nb] + kPad + ix[nb] - kM2 + 2
                      : -1;
  }
  __syncthreads();
  const float maxf = (float)maxv;
  // this lane's SATD job: tile u of the strip, qx fixed, the 7 qy in turn
  const int c = tid & 7, g = tid >> 3;
  const int u = g % Q::U, k0 = g / Q::U;       // k0 = qx + 3
  const int bu = u / Q::TS, t = u % Q::TS;
  const int tr = t / Q::TX, tc = t % Q::TX;
  const int fx = (k0 - 3) & 3, ixo = (k0 - 3) >> 2;
  const int nu = n0 + bu;
  const float* pcol = Ps + bu * Q::PB + fx * Q::PPL + (tr * 8 + 1) * Q::PP
                      + tc * 8 + c + 1 + ixo;
  int sat = 0;                                  // candidate tid's SATD
  for (int s = 0; s < Q::NSTRIP; ++s) {
    qpel_load_window<S, R, NB>(Ps, refpad, org, wp, s * R, Q::HR);
    __syncthreads();
    // the four horizontal planes on the strip's R+8 window rows
    for (int i = tid; i < NB * Q::HR * Q::HP; i += Q::THREADS) {
      const int b = i / (Q::HR * Q::HP), a = (i / Q::HP) % Q::HR;
      const int j = i % Q::HP;
      const float* w = Ps + b * Q::PB + a * Q::WW + j;
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = w[k];
      float* h = Hs + b * 4 * Q::HPL + a * Q::HP + j;
      h[0] = __fmul_rn(x[3], 64.f);
      h[Q::HPL] = luma_tap8<1>(x);
      h[2 * Q::HPL] = luma_tap8<2>(x);
      h[3 * Q::HPL] = luma_tap8<3>(x);
    }
    __syncthreads();
    // the 16 phase planes on the strip's R+1 rows
    for (int i = tid; i < NB * 4 * (R + 1) * Q::HP; i += Q::THREADS) {
      const int j = i % Q::HP, rest = i / Q::HP;
      const int r = rest % (R + 1), bf = rest / (R + 1);   // bf = b*4 + fx
      const float* h = Hs + bf * Q::HPL + r * Q::HP + j;
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = h[k * Q::HP];
      float* p = Ps + (bf >> 2) * Q::PB + (bf & 3) * Q::PPL + r * Q::PP + j;
      p[0] = qpel_round(__fmul_rn(x[3], 64.f), maxf);
      p[4 * Q::PPL] = qpel_round(luma_tap8<1>(x), maxf);
      p[8 * Q::PPL] = qpel_round(luma_tap8<2>(x), maxf);
      p[12 * Q::PPL] = qpel_round(luma_tap8<3>(x), maxf);
    }
    // this lane's column of the block (zero for a block past n)
    float o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      o[r] = nu < n ? (float)ob[(long long)nu * S * S
                                + (s * R + tr * 8 + r) * S + tc * 8 + c]
                    : 0.f;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 7; ++m) {                // qy = m - 3
      const int fy = (m - 3) & 3, iyo = (m - 3) >> 2;
      const float* p = pcol + fy * 4 * Q::PPL + iyo * Q::PP;
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = __fsub_rn(p[r * Q::PP], o[r]);
#pragma unroll
      for (int len = 1; len < 8; len <<= 1) {    // down the column
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if ((r & len) == 0) {
            const float a = v[r], b = v[r + len];
            v[r] = __fadd_rn(a, b);
            v[r + len] = __fsub_rn(a, b);
          }
        }
      }
#pragma unroll
      for (int len = 1; len < 8; len <<= 1) {    // across the 8 lanes
        const float sg = (c & len) ? -1.f : 1.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = __fmaf_rn(sg, v[r], __shfl_xor_sync(0xffffffffu, v[r], len));
      }
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) sum = __fadd_rn(sum, fabsf(v[r]));
#pragma unroll
      for (int len = 1; len < 8; len <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, len));
      if (c == 0) ts[(m * 7 + k0) * Q::U + u] = ((int)sum + 2) >> 2;
    }
    __syncthreads();
    if (tid < NB * 49) {
      const int b = tid / 49, k = tid % 49;
#pragma unroll
      for (int i = 0; i < Q::TS; ++i) sat += ts[k * Q::U + b * Q::TS + i];
    }
  }
  if (tid < NB * 49) {
    const int b = tid / 49, k = tid % 49, nb = n0 + b;
    float cost = __int_as_float(0x7f800000);
    if (nb < n) {
      const int mvy = 4 * iy[nb] + k / 7 - 3, mvx = 4 * ix[nb] + k % 7 - 3;
      const float bits = __fadd_rn(mvb[abs(mvy)], mvb[abs(mvx)]);
      cost = __fmaf_rn(lam_m, bits, (float)sat);
    }
    cs[tid] = cost;
  }
  __syncthreads();
  if ((tid >> 5) < NB) {
    const int b = tid >> 5, lane = tid & 31, nb = n0 + b;
    float cb = cs[b * 49 + lane];
    int kb = lane;
    if (lane + 32 < 49 && cs[b * 49 + lane + 32] < cb) {
      cb = cs[b * 49 + lane + 32];
      kb = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float c2 = __shfl_xor_sync(0xffffffffu, cb, off);
      const int k2 = __shfl_xor_sync(0xffffffffu, kb, off);
      if (c2 < cb || (c2 == cb && k2 < kb)) {
        cb = c2;
        kb = k2;
      }
    }
    if (lane == 0) {
      win[b] = kb;
      if (nb < n) {
        mvy_out[nb] = 4 * iy[nb] + kb / 7 - 3;
        mvx_out[nb] = 4 * ix[nb] + kb % 7 - 3;
        cost_out[nb] = cb;
      }
    }
  }
  __syncthreads();
  if constexpr (Q::NSTRIP == 1) {
    // the winner's prediction, copied from its phase plane
    for (int i = tid; i < NB * S * S; i += Q::THREADS) {
      const int b = i / (S * S), rc = i % (S * S), nb = n0 + b;
      if (nb >= n) continue;
      const int kb = win[b], qy = kb / 7 - 3, qx = kb % 7 - 3;
      const int r = rc / S, cc = rc % S;
      pred_out[(long long)nb * S * S + rc] = (int)Ps[
          b * Q::PB + ((qy & 3) * 4 + (qx & 3)) * Q::PPL
          + (r + 1 + (qy >> 2)) * Q::PP + cc + 1 + (qx >> 2)];
    }
  } else {
    // strip-mined (NB = 1): the strips' planes are gone; filter the
    // winner's one plane again over the whole block, its window and
    // horizontal plane in the P and H areas
    constexpr int WR = S + 8;
    const int kb = win[0], qy = kb / 7 - 3, qx = kb % 7 - 3;
    const int fyw = qy & 3, iyw = qy >> 2, fxw = qx & 3, ixw = qx >> 2;
    float* hw = Ps + WR * Q::WW;                 // [S+8][S+1]
    qpel_load_window<S, R, NB>(Ps, refpad, org, wp, 0, WR);
    __syncthreads();
    for (int i = tid; i < WR * Q::HP; i += Q::THREADS) {
      const int a = i / Q::HP, j = i % Q::HP;
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = Ps[a * Q::WW + j + k];
      hw[i] = luma_tap8(fxw, x);
    }
    __syncthreads();
    for (int i = tid; i < S * S; i += Q::THREADS) {
      const int r = i / S, cc = i % S;
      const float* h = hw + (r + 1 + iyw) * Q::HP + cc + 1 + ixw;
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = h[k * Q::HP];
      pred_out[(long long)n0 * S * S + i] =
          (int)qpel_round(luma_tap8(fyw, x), maxf);
    }
  }
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

template <int S, int R, int NB>
int launch_qpel(const int* refpad, const int* ob, const int* ys, const int* xs,
                const int* iy, const int* ix, const float* mvb, int wp, int n,
                float lam_m, int maxv, int* mvy, int* mvx, float* cost,
                int* pred, cudaStream_t st) {
  using Q = QpelShape<S, R, NB>;
  const int smem = Q::SMEM_WORDS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      me_qpel_kernel<S, R, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  me_qpel_kernel<S, R, NB><<<(n + NB - 1) / NB, Q::THREADS, smem, st>>>(
      refpad, ob, ys, xs, iy, ix, mvb, wp, n, lam_m, maxv, mvy, mvx, cost,
      pred);
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
                              const float* mvb, int wp, int n, float lam_m,
                              int s, int maxv, int* mvy, int* mvx, float* cost,
                              int* pred, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // (S, strip rows, blocks per CTA)
#define ME_QPEL(S, R, NB)                                                     \
  return launch_qpel<S, R, NB>(refpad, ob, ys, xs, iy, ix, mvb, wp, n, lam_m, \
                               maxv, mvy, mvx, cost, pred, st)
  switch (s) {
    case 8: ME_QPEL(8, 8, 4);
    case 16: ME_QPEL(16, 16, 1);
    case 32: ME_QPEL(32, 8, 1);
    case 64: ME_QPEL(64, 8, 1);
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
