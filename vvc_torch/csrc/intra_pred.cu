// Intra prediction of N square S x S blocks: all 67 modes of each block
// (`intra_pred_all`), or one mode per block (`intra_pred_one`); and of N
// W x H rectangles (`intra_pred_all_rect`, `intra_pred_one_rect`).
//
// `intra_pred_all` replaces vvc/kernels/intra.py:671
// predict_all_modes_batch, and `intra_pred_one` vvc/kernels/intra.py:878
// predict_modes_batch (jitted jnp gathers + multiply-adds over static
// tables on the TPU; the one-mode version serves the RD search's chroma DM
// prediction at S = 4..32).  Integer semantics are those of the
// reference, exactly:
//   * planar and DC, each followed by the two-sided PDPC blend;
//   * vertical family (modes 34..66): 4-tap filter over the reference
//     line C with the stacked tables idx/co [33,4,S,S], then angular PDPC
//     (tables W/I [33,S,S], diff [33]);
//   * horizontal family (modes 2..33): vertical mode 68-m applied to the
//     reversed line ct(i) = C[max(4S-i, 0)] and transposed — the transpose
//     is index math on the table element, not a copy;
//   * clip to [0, 2^bd - 1].
// Right shifts of negative PDPC terms are arithmetic, as in jnp.  For a
// mode outside 0..66 `intra_pred_one` does what predict_modes_batch's
// clamped table rows do (mv = clip(m-34, 0, 32), mh = clip(34-m, 0, 32)):
// m > 66 predicts as 66, m < 0 as 2; planar and DC read no table row.
//
// `intra_pred_all_rect` replaces vvc/kernels/intra.py:799
// predict_all_modes_batch_rect (the MTT lattice's rectangles, 67 modes),
// `intra_pred_one_rect` :822 predict_modes_batch_rect (one mode per ISP
// sub-TU).  Rect semantics: the line is [left 2H reversed, corner, top 2W,
// 2 pads]; a signaled mode m >= 2 is remapped (wide angles, remap[67]);
// a remapped mode rm >= 34 takes row rm-34 of the vertical family's
// tables [49,4,H,W] (PDPC [49,H,W]), any other row 68-rm-34 of the
// horizontal family's [49,4,W,H] applied to the reversed line
// ct(i) = C[max(2H+2W-i, 0)] and transposed; rows clipped to 0..48 as
// vvc clips them.  Planar: ((H-1-y)·top[x] + (y+1)·left[H]) << log2 W plus
// ((W-1-x)·left[y] + (x+1)·top[W]) << log2 H, + W·H, >> log2(W·H) + 1;
// DC averages the longer side (both when square); both then take the
// PDPC blend with scale (log2 W + log2 H - 2) >> 2.
//
// `intra_pred_all`: grid (N, 67), one CTA per (block, mode);
// `intra_pred_one`: grid N, one CTA per block with the block's own mode.
// Each CTA stages its block's reference line (at most 259 ints) in shared
// memory and loops over the S*S samples.  Bound: bytes — each output
// sample is written once (67*N*S*S*4 B, or N*S*S*4 B, per size: the
// chroma DM of a 1080p frame writes about 16 MB, 0.008 ms); the
// tables (<= 4.3 MB at S=64) stay resident in L2.  Fusing the 67 modes
// with the SATD that consumes them, so the [N,67,S,S] tensor never
// reaches HBM, is the next step for speed.
#include <cuda_runtime.h>

#define MAX_LINE (4 * 64 + 3)  // also 2H + 2W + 3 of every rectangle

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Mode m of one block, from its reference line c (in shared memory), into
// o[S*S]; every thread of the CTA takes part.
__device__ void predict_block(const int* c, int m, int s, int log2s, int maxv,
                              const int* __restrict__ idx,
                              const int* __restrict__ co,
                              const int* __restrict__ pw,
                              const int* __restrict__ pi,
                              const int* __restrict__ pdiff,
                              int* __restrict__ o) {
  const int ss = s * s;
  if (m == 0 || m == 1) {
    int dc = 0;
    if (m == 1) {
      // top[0..S-1] = C[2S+1..3S], left[0..S-1] = C[2S-1..S]
      int sum = 0;
      for (int k = 0; k < s; ++k) sum += c[2 * s + 1 + k] + c[s + k];
      dc = (sum + s) >> (log2s + 1);
    }
    const int scale = (2 * log2s - 2) >> 2;
    const int below_left = c[s - 1];      // left[S]
    const int above_right = c[3 * s + 1]; // top[S]
    for (int t = threadIdx.x; t < ss; t += blockDim.x) {
      const int y = t >> log2s, x = t & (s - 1);
      const int left_y = c[2 * s - 1 - y];
      const int top_x = c[2 * s + 1 + x];
      int p;
      if (m == 0) {
        const int pv = ((s - 1 - y) * top_x + (y + 1) * below_left) << log2s;
        const int ph = ((s - 1 - x) * left_y + (x + 1) * above_right) << log2s;
        p = (pv + ph + ss) >> (2 * log2s + 1);
      } else {
        p = dc;
      }
      const int wl = 32 >> min(31, (2 * x) >> scale);
      const int wt = 32 >> min(31, (2 * y) >> scale);
      p = (wl * left_y + wt * top_x + (64 - wl - wt) * p + 32) >> 6;
      o[t] = clampi(p, 0, maxv);
    }
    return;
  }

  const bool vert = m >= 34;
  // table position of the vertical mode, clamped as predict_modes_batch
  const int pos = vert ? min(m - 34, 32) : min(34 - m, 32);
  const int* ti = idx + (long long)pos * 4 * ss;
  const int* tc = co + (long long)pos * 4 * ss;
  const int* tw = pw + (long long)pos * ss;
  const int* tI = pi + (long long)pos * ss;
  const int diff = pdiff[pos];
  const int corner = c[2 * s];  // also ct[2S]
  const int rev = 4 * s;
  for (int t = threadIdx.x; t < ss; t += blockDim.x) {
    const int y = t >> log2s, x = t & (s - 1);
    const int e = vert ? t : ((x << log2s) | y);  // transposed for horizontal
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int id = ti[k * ss + e];
      const int r = vert ? c[id] : c[max(rev - id, 0)];
      acc += tc[k * ss + e] * r;
    }
    int p = (acc + 32) >> 6;
    const int wgt = tw[e];
    const int id = tI[e];
    const int ref = vert ? c[id] : c[max(rev - id, 0)];
    p += diff ? (wgt * (ref - corner)) >> 6 : (wgt * (ref - p) + 32) >> 6;
    o[t] = clampi(p, 0, maxv);
  }
}

__device__ __forceinline__ void stage_line(const int* __restrict__ refs,
                                           int b, int len, int* c) {
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    c[i] = refs[(long long)b * len + i];
  __syncthreads();
}

__global__ void intra_pred_all_kernel(
    const int* __restrict__ refs, int s, int log2s, int maxv,
    const int* __restrict__ idx, const int* __restrict__ co,
    const int* __restrict__ pw, const int* __restrict__ pi,
    const int* __restrict__ pdiff, int* __restrict__ out) {
  __shared__ int c[MAX_LINE];
  const int b = blockIdx.x;
  const int m = blockIdx.y;
  stage_line(refs, b, 4 * s + 3, c);
  predict_block(c, m, s, log2s, maxv, idx, co, pw, pi, pdiff,
                out + ((long long)b * 67 + m) * s * s);
}

__global__ void intra_pred_one_kernel(
    const int* __restrict__ refs, const int* __restrict__ modes, int s,
    int log2s, int maxv, const int* __restrict__ idx,
    const int* __restrict__ co, const int* __restrict__ pw,
    const int* __restrict__ pi, const int* __restrict__ pdiff,
    int* __restrict__ out) {
  __shared__ int c[MAX_LINE];
  const int b = blockIdx.x;
  stage_line(refs, b, 4 * s + 3, c);
  predict_block(c, modes[b], s, log2s, maxv, idx, co, pw, pi, pdiff,
                out + (long long)b * s * s);
}

extern "C" int intra_pred_all_launch(const int* refs, int n, int s, int log2s,
                                     int bit_depth, const int* idx,
                                     const int* co, const int* pw,
                                     const int* pi, const int* pdiff,
                                     int* out, void* stream) {
  if (n == 0) return 0;
  if (s > 64 || s < 4) return (int)cudaErrorInvalidValue;
  const int threads = s * s < 256 ? s * s : 256;
  dim3 grid((unsigned)n, 67);
  intra_pred_all_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      refs, s, log2s, (1 << bit_depth) - 1, idx, co, pw, pi, pdiff, out);
  return (int)cudaGetLastError();
}

extern "C" int intra_pred_one_launch(const int* refs, const int* modes, int n,
                                     int s, int log2s, int bit_depth,
                                     const int* idx, const int* co,
                                     const int* pw, const int* pi,
                                     const int* pdiff, int* out,
                                     void* stream) {
  if (n == 0) return 0;
  if (s > 64 || s < 4) return (int)cudaErrorInvalidValue;
  const int threads = s * s < 256 ? s * s : 256;
  intra_pred_one_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      refs, modes, s, log2s, (1 << bit_depth) - 1, idx, co, pw, pi, pdiff,
      out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W x H rectangles
// ---------------------------------------------------------------------------

struct RectTables {
  const int* remap;                     // [67]
  const int *vidx, *vco, *vw, *vi, *vd;  // [49,4,H,W] x2, [49,H,W] x2, [49]
  const int *hidx, *hco, *hw, *hi, *hd;  // [49,4,W,H] x2, [49,W,H] x2, [49]
};

// Mode m (0..66, signaled) of one W x H block from its line c (shared
// memory) into o[H*W]; every thread of the CTA takes part.
__device__ void predict_block_rect(const int* c, int m, int w, int h,
                                   int log2w, int log2h, int maxv,
                                   const RectTables& t, int* __restrict__ o) {
  const int hw = w * h;
  if (m == 0 || m == 1) {
    int dc = 0;
    if (m == 1) {
      // top[k] = C[2H+1+k], left[k] = C[2H-1-k]
      int st = 0, sl = 0;
      if (w >= h)
        for (int k = 0; k < w; ++k) st += c[2 * h + 1 + k];
      if (h >= w)
        for (int k = 0; k < h; ++k) sl += c[2 * h - 1 - k];
      if (w == h)
        dc = (st + sl + w) >> (log2w + 1);
      else if (w > h)
        dc = (st + (w >> 1)) >> log2w;
      else
        dc = (sl + (h >> 1)) >> log2h;
    }
    const int scale = (log2w + log2h - 2) >> 2;
    const int below_left = c[h - 1];          // left[H]
    const int above_right = c[2 * h + 1 + w]; // top[W]
    for (int e = threadIdx.x; e < hw; e += blockDim.x) {
      const int y = e >> log2w, x = e & (w - 1);
      const int left_y = c[2 * h - 1 - y];
      const int top_x = c[2 * h + 1 + x];
      int p;
      if (m == 0) {
        const int pv = ((h - 1 - y) * top_x + (y + 1) * below_left) << log2w;
        const int ph = ((w - 1 - x) * left_y + (x + 1) * above_right) << log2h;
        p = (pv + ph + hw) >> (log2w + log2h + 1);
      } else {
        p = dc;
      }
      const int wl = 32 >> min(31, (2 * x) >> scale);
      const int wt = 32 >> min(31, (2 * y) >> scale);
      p = (wl * left_y + wt * top_x + (64 - wl - wt) * p + 32) >> 6;
      o[e] = clampi(p, 0, maxv);
    }
    return;
  }
  const int rm = __ldg(t.remap + m);
  const bool vert = rm >= 34;
  const int pos = vert ? clampi(rm - 34, 0, 48) : clampi(34 - rm, 0, 48);
  const long long tab = (long long)pos * 4 * hw;
  const int* ti = (vert ? t.vidx : t.hidx) + tab;
  const int* tc = (vert ? t.vco : t.hco) + tab;
  const int* tw = (vert ? t.vw : t.hw) + (long long)pos * hw;
  const int* tI = (vert ? t.vi : t.hi) + (long long)pos * hw;
  const int diff = __ldg((vert ? t.vd : t.hd) + pos);
  const int corner = c[2 * h];  // also ct[2W]
  const int rev = 2 * h + 2 * w;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    const int y = e >> log2w, x = e & (w - 1);
    // v-space index: W x H for the vertical family, H x W transposed
    const int v = vert ? e : x * h + y;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int id = __ldg(ti + k * hw + v);
      const int r = vert ? c[id] : c[max(rev - id, 0)];
      acc += __ldg(tc + k * hw + v) * r;
    }
    int p = (acc + 32) >> 6;
    const int wgt = __ldg(tw + v);
    const int id = __ldg(tI + v);
    const int ref = vert ? c[id] : c[max(rev - id, 0)];
    p += diff ? (wgt * (ref - corner)) >> 6 : (wgt * (ref - p) + 32) >> 6;
    o[e] = clampi(p, 0, maxv);
  }
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

__global__ void intra_pred_all_rect_kernel(const int* __restrict__ refs,
                                           int w, int h, int maxv,
                                           RectTables t,
                                           int* __restrict__ out) {
  __shared__ int c[MAX_LINE];
  const int b = blockIdx.x;
  const int m = blockIdx.y;
  stage_line(refs, b, 2 * h + 2 * w + 3, c);
  predict_block_rect(c, m, w, h, log2i(w), log2i(h), maxv, t,
                     out + ((long long)b * 67 + m) * w * h);
}

__global__ void intra_pred_one_rect_kernel(const int* __restrict__ refs,
                                           const int* __restrict__ modes,
                                           int w, int h, int maxv,
                                           RectTables t,
                                           int* __restrict__ out) {
  __shared__ int c[MAX_LINE];
  const int b = blockIdx.x;
  stage_line(refs, b, 2 * h + 2 * w + 3, c);
  // a mode outside 0..66 reads the remap entry jnp's clamped gather reads
  predict_block_rect(c, clampi(modes[b], 0, 66), w, h, log2i(w), log2i(h),
                     maxv, t, out + (long long)b * w * h);
}

static bool rect_ok(int w, int h) {
  auto side = [](int s) {
    return s == 4 || s == 8 || s == 16 || s == 32 || s == 64;
  };
  return side(w) && side(h);
}

extern "C" int intra_pred_all_rect_launch(
    const int* refs, int n, int w, int h, int bit_depth, const int* remap,
    const int* vidx, const int* vco, const int* vw, const int* vi,
    const int* vd, const int* hidx, const int* hco, const int* hw,
    const int* hi, const int* hd, int* out, void* stream) {
  if (n < 0 || !rect_ok(w, h)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  RectTables t{remap, vidx, vco, vw, vi, vd, hidx, hco, hw, hi, hd};
  const int threads = w * h < 256 ? w * h : 256;
  dim3 grid((unsigned)n, 67);
  intra_pred_all_rect_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      refs, w, h, (1 << bit_depth) - 1, t, out);
  return (int)cudaGetLastError();
}

extern "C" int intra_pred_one_rect_launch(
    const int* refs, const int* modes, int n, int w, int h, int bit_depth,
    const int* remap, const int* vidx, const int* vco, const int* vw,
    const int* vi, const int* vd, const int* hidx, const int* hco,
    const int* hw, const int* hi, const int* hd, int* out, void* stream) {
  if (n < 0 || !rect_ok(w, h)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  RectTables t{remap, vidx, vco, vw, vi, vd, hidx, hco, hw, hi, hd};
  const int threads = w * h < 256 ? w * h : 256;
  intra_pred_one_rect_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      refs, modes, w, h, (1 << bit_depth) - 1, t, out);
  return (int)cudaGetLastError();
}
