// Quantise, price and dequantise H x W coefficient blocks in one pass.
//
// Replaces three TPU device functions that the RDO's rd_pass chains:
// vvc/kernels/quant.py:87 quant_batch (dead zone `offset`: 171/512 for the
// intra search, 85/512 for the inter search),
// vvc/cabac/rates.py:41 level_bits_jnp (+ jnp.sum over the block) and
// vvc/kernels/quant.py:106 dequant_batch.  Per coefficient c, in int32:
//   level = sign(c)·min((|c|·scale + offset) >> qbits, 32767)   (not stored)
//   bits  = fma(log(1 + over), 2/ln 2, base[min(|level|, 9)]),
//           over = max(|level| - 9, 0)     (one rounding, as XLA's FMA)
//   deq   = clip16(((clamp(level·dscale, ±2^29 >> sh6) << sh6)
//                   + 2^(shift-1)) >> shift)
// `log` is XLA-CPU's own float32 log of 1..32768, read from a table
// (vvc_torch/rom/log_table.py), never log2f/logf: those differ from it in
// the last bit.  The block's rate is summed in the order XLA-CPU's fused
// program uses for the shape (vvc_torch/kernels/quant.py xla_block_sum,
// rate_order), so it is bit-equal:
//   order 0, W = 8..32: per row v, lanes k = 0..7 hold x[v][k] +
//     x[v][8+k] + ... (part p added onto the sum of parts < p), the
//     running total joins lane 0 first, then ((l0+l4)+(l2+l6)) +
//     ((l1+l5)+(l3+l7));
//   order 0 with a side of 64: windows of min(H,32) x min(W,32) summed
//     row-major, then W0+W1 or (W00+W01)+(W10+W11);
//   order 1 (row lanes, H = 8..32): lane v sums rows v, v+8, ... each
//     left to right, then the same halving tree (4-wide blocks, the
//     LFNST stage's 8x8 rate, and the 8-wide blocks of vvc's sharded
//     program); at H = 4, four lanes, then (l0+l2)+(l1+l3);
//   order 2 (tail, W = 16, 32): per row, columns 0..W-9 as in order 0,
//     the tree, then the last 8 columns one by one (blocks of <= 8 rows).
//
// One CTA per block; the H*W level bits sit in shared memory.  Lanes 1..7
// of every row are summed in parallel; one thread then walks the rows
// (lane 0 carries the running total); with a side of 64 one thread per
// window walks it.  The levels themselves are never written: the RD
// search reads only the rate and the dequantised block, which both follow
// from them.  Bound: bytes — 4 B read and 4 B written per coefficient,
// plus 4 B per block.
//
// `dequant` is the decoder's dequantisation alone: levels read from the
// stream -> coefficients, replacing vvc/kernels/quant.py:106 dequant_batch
// where vvc's wavefront decoder calls it (vvc/dec/wavefront.py:123-125).
// Per level, in int32 as jnp: deq = clip16((clamp(level·dscale,
// ±2^29 >> sh6) << sh6) + 2^(shift-1)) >> shift), or << -shift where the
// shift is not positive; level·dscale wraps as jnp's int32 product does.
// One thread per coefficient over the N·H·W of a launch; bound: bytes (4 B
// read and 4 B written per coefficient).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64 * 64;

__device__ __forceinline__ float tree8(const float* ln) {
  return __fadd_rn(__fadd_rn(__fadd_rn(ln[0], ln[4]), __fadd_rn(ln[2], ln[6])),
                   __fadd_rn(__fadd_rn(ln[1], ln[5]), __fadd_rn(ln[3], ln[7])));
}

__global__ void quant_rate_kernel(const int* __restrict__ coeff,
                                  const float* __restrict__ log_tab,
                                  const float* __restrict__ base_tab,
                                  int* __restrict__ deq,
                                  float* __restrict__ rate, int w, int h,
                                  int scale, int offset, int qbits,
                                  int dscale, int sh6, int shift,
                                  float log_scale, int order) {
  __shared__ float bits[kMaxN];
  __shared__ float lanes[32 * 8];
  __shared__ float win[4];
  const int nn = w * h;
  const long long base = (long long)blockIdx.x * nn;
  const int guard = (1 << 29) >> sh6;
  const int rnd = 1 << (shift - 1);
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int c = coeff[base + i];
    const int a = abs(c);
    const int l = min(max((a * scale + offset) >> qbits, 0), 32767);
    const int level = c > 0 ? l : (c < 0 ? -l : 0);
    const int al = abs(level);
    bits[i] = __fmaf_rn(__ldg(log_tab + max(al - 9, 0)), log_scale,
                        __ldg(base_tab + min(al, 9)));
    const int lv = min(max(level * dscale, -guard), guard) << sh6;
    deq[base + i] = min(max((lv + rnd) >> shift, -32768), 32767);
  }
  __syncthreads();
  if (order == 0 && (w == 64 || h == 64)) {
    const int wh = min(h, 32), ww = min(w, 32);
    const int nx = w / ww, nwin = (h / wh) * nx;
    if (threadIdx.x < nwin) {
      const int wy = threadIdx.x / nx, wx = threadIdx.x - wy * nx;
      float acc = 0.0f;
      for (int r = 0; r < wh; ++r) {
        const float* row = bits + (wy * wh + r) * w + wx * ww;
        for (int c = 0; c < ww; ++c) acc = __fadd_rn(acc, row[c]);
      }
      win[threadIdx.x] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      rate[blockIdx.x] =
          nwin == 4 ? __fadd_rn(__fadd_rn(win[0], win[1]),
                                __fadd_rn(win[2], win[3]))
                    : __fadd_rn(win[0], win[1]);
    return;
  }
  if (order == 1) {  // row lanes: 8 at 8 <= h <= 32, 4 at h = 4
    const int nl = h < 8 ? h : 8;
    if (threadIdx.x < nl) {
      const int v = threadIdx.x;
      float acc = bits[v * w];
      for (int r = 0; r < h; r += nl) {
        const float* row = bits + (r + v) * w;
        for (int c = (r == 0); c < w; ++c) acc = __fadd_rn(acc, row[c]);
      }
      lanes[v] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      rate[blockIdx.x] = nl == 4 ? __fadd_rn(__fadd_rn(lanes[0], lanes[2]),
                                             __fadd_rn(lanes[1], lanes[3]))
                                 : tree8(lanes);
    return;
  }
  // order 0 (all W/8 parts in lanes) or 2 (the last 8 columns one by one)
  const int parts = order == 2 ? (w - 8) >> 3 : w >> 3;
  if (threadIdx.x < h * 8) {
    const int v = threadIdx.x >> 3, k = threadIdx.x & 7;
    if (k > 0) {
      const float* row = bits + v * w;
      float r = row[k];
      for (int p = 1; p < parts; ++p) r = __fadd_rn(row[8 * p + k], r);
      lanes[threadIdx.x] = r;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int v = 0; v < h; ++v) {
      const float* row = bits + v * w;
      float* ln = lanes + v * 8;
      float l0 = __fadd_rn(tot, row[0]);
      for (int p = 1; p < parts; ++p) l0 = __fadd_rn(row[8 * p], l0);
      ln[0] = l0;
      tot = tree8(ln);
      if (order == 2)
        for (int c = w - 8; c < w; ++c) tot = __fadd_rn(tot, row[c]);
    }
    rate[blockIdx.x] = tot;
  }
}

bool side_ok(int s) { return s == 4 || s == 8 || s == 16 || s == 32 || s == 64; }

__global__ void dequant_kernel(const int* __restrict__ level, long long total,
                               int dscale, int sh6, int shift,
                               int* __restrict__ deq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int guard = (1 << 29) >> sh6;
  const int p = (int)((unsigned)level[i] * (unsigned)dscale);
  const int lv = (int)((unsigned)min(max(p, -guard), guard) << sh6);
  const int c = shift > 0 ? (lv + (1 << (shift - 1))) >> shift
                          : (int)((unsigned)lv << -shift);
  deq[i] = min(max(c, -32768), 32767);
}

}  // namespace

extern "C" int quant_rate_launch(const int* coeff, const float* log_tab,
                                 const float* base_tab, int* deq,
                                 float* rate, int n, int w, int h, int scale,
                                 int offset, int qbits, int dscale, int sh6,
                                 int shift, float log_scale, int order,
                                 void* stream) {
  const bool shape_ok =
      side_ok(w) && side_ok(h) &&
      (order == 1 ? (h == 4 || (h >= 8 && h <= 32))
                  : (order == 2 ? (h <= 8 && (w == 16 || w == 32))
                                : (order == 0 && w >= 8)));
  if (n < 0 || !shape_ok || shift <= 0 || qbits <= 0 || sh6 < 0 || sh6 > 29)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = w * h < 256 ? w * h : 256;
  quant_rate_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      coeff, log_tab, base_tab, deq, rate, w, h, scale, offset, qbits,
      dscale, sh6, shift, log_scale, order);
  return (int)cudaGetLastError();
}

extern "C" int dequant_launch(const int* level, int* deq, int n, int w, int h,
                              int dscale, int sh6, int shift, void* stream) {
  if (n < 0 || !side_ok(w) || !side_ok(h) || sh6 < 0 || sh6 > 29 ||
      shift < -16 || shift > 30)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * w * h;
  if (total == 0) return 0;
  const int threads = 256;
  dequant_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(level, total, dscale, sh6, shift,
                                           deq);
  return (int)cudaGetLastError();
}
