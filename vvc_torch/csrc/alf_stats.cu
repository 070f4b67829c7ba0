// ALF encoder statistics: the per-group normal equations of the luma Wiener
// filter on the 2×2-subsampled grid.
//
// Replaces vvc/kernels/alf.py:330 alf_stats_dev (jitted at :347): 12
// diamond-pair features F = r[a] + r[b] − 2r (edge-padded by 3) and the
// target t = o − r at every even row and column; a group key class·4 +
// transpose from the 4×4 classification; per group (100) FᵀF and Fᵀt, per
// class (25) Σt² and the count.  vvc runs a lax.scan of 100 masked float32
// dots over all P = ⌈H/2⌉·⌈W/2⌉ points (Eigen contractions on XLA-CPU) and
// 25 masked sums.
//
// The sums are taken exactly and rounded once, except B100 (Fᵀt) from 4096
// grid points on, where vvc's dot lowers to XLA-CPU's tiled GEMV, whose
// float32 order is reproduced bit for bit: lane j of row k sums the
// products of the points p ≡ j (mod 8) in increasing p from 0, and the
// eight lanes meet in a fixed tree (rows 0..7: ((a0+a1)+(a2+a3))+((a4+a5)+
// (a6+a7)); rows 8..11: ((a0+a4)+(a2+a6))+((a1+a5)+(a3+a7))) — read from
// the optimised IR of vvc's _alf_stats_impl, jax 0.9.0, at 416×240 and
// 1080p.  A product F·t is exact in float32 up to 10 bit (|F·t| < 2^24).
// Where Σ|F·t| of a (group, row) entry stays below 2^24 every partial sum
// of that order is an exact integer, so the exact sum rounded once is the
// answer; only the other entries need the ordered walk.
//
// One call is three launches on the caller's stream, no host sync:
//   1. a memset of the int64 sums (kEnt a key) and the walk's counters;
//   2. alf_tile_kernel, one CTA per 32×32 grid points (a 64×64 CTU): r
//      with its 3-sample edge-clamped halo staged in shared memory; each
//      point's key and a counting sort of the tile's points by key (one
//      shared int32 atomic a point); the 12 features and t of each point
//      in int32, stored in key order.  Each warp then walks a contiguous
//      eighth of the sorted points, its lanes summing the 104 entries of
//      the current key in int64 registers, and adds them to the global
//      sums with one int64 atomic per (tile, key, entry) when the key
//      changes: exact and independent of order.  For the walk it also
//      writes each point's key byte and its 12 products F·t in float32
//      (`keys`, `ft`), lane-major: p mod 8, then p / 8;
//   3. alf_final_kernel, one CTA per group and lane j: A100 mirrored,
//      B100, sse0 and npx rounded once to float32 in their final layout;
//      where the walk decides (P ≥ 4096 and Σ|F·t| ≥ 2^24 for some row),
//      the GEMV's order.  Lane j's chains depend on lane j's points
//      alone, so a group's 8 lanes walk on 8 SMs.  8 producer warps take
//      2048 of the lane's points a chunk, compact the group's in
//      increasing p with ballots and one exchange of counts, and copy
//      their products to shared memory (key bytes and products loaded a
//      chunk ahead into registers, 512 contiguous bytes a warp load);
//      12 chain threads, one a row k, add the previous chunk's products
//      with __fadd_rn (double-buffered).  The last of the group's 8 CTAs
//      to end meets the lane sums in the tree.
//
// Samples stay below 2^14: a product of two features (|F| ≤ 2·(2^14 − 1))
// fits int32.
//
// Bound per 1080p picture: bytes — r read whole (8.3 MB), the even rows of
// o at 32-B sector granularity (4.1 MB), cls4 and tr4 (1.0 MB), about
// 13.4 MB, 0.004 ms at 3.35 TB/s; the arithmetic (518,400 points × 92
// products) is far below the card's integer rate.  The tile pass is
// bound by its per-key int64 sums (about half its time on an H100) and
// the walk's scratch (25.4 MB written whenever P ≥ 4096).  The ordered
// walk is latency-bound: its longest chain (the most points of one group
// in one lane j) is a sequence of dependent float32 adds that no design
// shortens.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 12;
constexpr int kLanes = 8;                  // the GEMV's lanes p mod 8
constexpr int kGroups = 100;
constexpr int kClasses = 25;
// per key: 78 FᵀF (upper triangle, row-major), 12 Fᵀt, Σt², 12 Σ|F·t|,
// the count (the sums' buffer then holds, per key, the number of its
// lanes whose walk has ended)
constexpr int kEnt = 104;
constexpr int kFt = 78, kT2 = 90, kAbs = 91, kCount = 103;
constexpr int kRow = 14;         // a point's sorted row: 12 F, t, 1

constexpr int kTile = 32;                  // grid points a tile side
constexpr int kTilePts = kTile * kTile;
constexpr int kSide = 2 * kTile + 6;       // staged r samples a side
constexpr int kTileThreads = 256;
constexpr size_t kTileSmem =
    (size_t)(kSide * kSide + kTilePts * kRow) * sizeof(int) + kTilePts;

constexpr int kWalkRows = 8;               // rows of 256 points a chunk
constexpr int kChunk = kWalkRows * 256;    // points of one lane a chunk
constexpr int kProducers = 256;
constexpr int kAhead = 16;                 // a chain thread's loads in flight
constexpr int kWalkThreads = kProducers + 32;
constexpr size_t kWalkSmem = (size_t)2 * kChunk * kPairs * sizeof(float);
constexpr long long kExactLimit = 1LL << 24;

// canonical members (dy, dx) of vvc/kernels/alf.py diamond_pairs(3), in its
// order; the partner is (−dy, −dx)
__constant__ int kPair[kPairs][2] = {
    {-3, 0}, {-2, -1}, {-2, 0}, {-2, 1}, {-1, -2}, {-1, -1},
    {-1, 0}, {-1, 1},  {-1, 2}, {0, -3}, {0, -2}, {0, -1}};

// entry e of a key → the two factors (indices into a sorted row) and
// whether the product's magnitude is summed; entries past kCount are
// never flushed
__device__ __forceinline__ void entry_factors(int e, int* a, int* b,
                                              bool* mag) {
  *mag = false;
  if (e < kFt) {
    int i = 0, rest = e;
    while (rest >= kPairs - i) rest -= kPairs - i++;
    *a = i;
    *b = i + rest;
  } else if (e < kT2) {
    *a = e - kFt;
    *b = kPairs;
  } else if (e == kT2) {
    *a = *b = kPairs;
  } else if (e < kCount) {
    *a = e - kAbs;
    *b = kPairs;
    *mag = true;
  } else {
    *a = *b = kPairs + 1;
  }
}

// the walk's layout of a grid point p: lane p mod 8 major, then p / 8 (P
// a multiple of 8, nu = P / 8)
__device__ __forceinline__ long long lane_major(int p, int nu) {
  return (long long)(p & (kLanes - 1)) * nu + (p >> 3);
}

__device__ __forceinline__ int tri_index(int a, int b) {   // a ≤ b
  return a * kPairs - a * (a - 1) / 2 + (b - a);
}

__global__ void __launch_bounds__(kTileThreads)
alf_tile_kernel(const int* __restrict__ o, const int* __restrict__ r,
                const int* __restrict__ cls4, const int* __restrict__ tr4,
                int h, int w, int w4, unsigned long long* __restrict__ acc,
                unsigned char* __restrict__ keys,
                float* __restrict__ ft) {
  extern __shared__ int smem[];
  int* rs = smem;                                  // [kSide][kSide]
  int* rows = rs + kSide * kSide;                  // [kTilePts][kRow]
  unsigned char* skey = (unsigned char*)(rows + kTilePts * kRow);
  __shared__ int hist[kGroups], start[kGroups], npts_tile;

  const int tid = threadIdx.x;
  const int hs = (h + 1) / 2, ws = (w + 1) / 2, nu = hs * ws / kLanes;
  const int gy0 = blockIdx.y * kTile, gx0 = blockIdx.x * kTile;
  const int y0 = 2 * gy0 - 3, x0 = 2 * gx0 - 3;
  if (tid < kGroups) hist[tid] = 0;
  for (int i = tid; i < kSide * kSide; i += kTileThreads) {
    const int sy = min(max(y0 + i / kSide, 0), h - 1);
    const int sx = min(max(x0 + i % kSide, 0), w - 1);
    rs[i] = r[(long long)sy * w + sx];
  }
  __syncthreads();

  // keys and ranks by key (counting sort)
  constexpr int kPer = kTilePts / kTileThreads;
  int key[kPer], rank[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int q = tid + m * kTileThreads;
    const int gy = gy0 + q / kTile, gx = gx0 + q % kTile;
    key[m] = -1;
    if (gy < hs && gx < ws) {
      const int c = (gy >> 1) * w4 + (gx >> 1);
      key[m] = cls4[c] * 4 + tr4[c];
      rank[m] = atomicAdd(&hist[key[m]], 1);
      if (keys) keys[lane_major(gy * ws + gx, nu)] = (unsigned char)key[m];
    }
  }
  __syncthreads();
  if (tid < 32) {                                  // exclusive scan
    int v[4], s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tid * 4 + i;
      v[i] = k < kGroups ? hist[k] : 0;
      s += v[i];
    }
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += u;
    }
    int run = incl - s;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tid * 4 + i;
      if (k < kGroups) start[k] = run;
      run += v[i];
    }
    if (tid == 31) npts_tile = incl;
  }
  __syncthreads();

  // features and target in key order
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (key[m] < 0) continue;
    const int q = tid + m * kTileThreads;
    const int ly = q / kTile, lx = q % kTile;
    const int slot = start[key[m]] + rank[m];
    const int cy = 2 * ly + 3, cx = 2 * lx + 3;
    const int c = rs[cy * kSide + cx];
    int* row = rows + slot * kRow;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int dy = kPair[k][0], dx = kPair[k][1];
      row[k] = rs[(cy + dy) * kSide + cx + dx] +
               rs[(cy - dy) * kSide + cx - dx] - 2 * c;
    }
    const int y = 2 * (gy0 + ly), x = 2 * (gx0 + lx);
    row[kPairs] = o[(long long)y * w + x] - c;
    row[kPairs + 1] = 1;
    skey[slot] = (unsigned char)key[m];
    if (ft) {
      float pf[kPairs];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) pf[k] = (float)(row[k] * row[kPairs]);
      float4* d =
          (float4*)(ft + lane_major((y >> 1) * ws + (x >> 1), nu) * kPairs);
      d[0] = make_float4(pf[0], pf[1], pf[2], pf[3]);
      d[1] = make_float4(pf[4], pf[5], pf[6], pf[7]);
      d[2] = make_float4(pf[8], pf[9], pf[10], pf[11]);
    }
  }
  __syncthreads();

  // each warp: a contiguous eighth of the sorted points; lane entries
  // e = lane + 32 s
  const int lane = tid & 31, warp = tid >> 5;
  const int n = npts_tile;
  const int lo = n * warp / 8, hi = n * (warp + 1) / 8;
  int fa[4], fb[4];
  bool mag[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) entry_factors(lane + 32 * s, &fa[s], &fb[s],
                                            &mag[s]);
  long long sum[4] = {0, 0, 0, 0};
  int cur = -1;
  auto flush = [&](int k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int e = lane + 32 * s;
      if (e < kEnt && sum[s] != 0)
        atomicAdd(acc + k * kEnt + e, (unsigned long long)sum[s]);
      sum[s] = 0;
    }
  };
  for (int i = lo; i < hi; ++i) {
    const int k = skey[i];
    if (k != cur) {
      if (cur >= 0) flush(cur);
      cur = k;
    }
    const int* row = rows + i * kRow;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = row[fa[s]] * row[fb[s]];
      sum[s] += mag[s] ? abs(p) : p;
    }
  }
  if (cur >= 0) flush(cur);
}

// one CTA per group g and lane j: lane 0 rounds the group's outputs once;
// where the walk decides, each CTA sums lane j's products of its rows in
// increasing p, and the last of the group's 8 CTAs to end meets the lane
// sums in the GEMV's tree
__global__ void __launch_bounds__(kWalkThreads)
alf_final_kernel(const unsigned char* __restrict__ keys,
                 const float* __restrict__ ft, int h, int w,
                 long long* __restrict__ acc, float* __restrict__ lane_sums,
                 int gemv, float* __restrict__ a100, float* __restrict__ b100,
                 float* __restrict__ sse0, float* __restrict__ npx) {
  extern __shared__ float prod[];                  // [2][kChunk][kPairs]
  __shared__ int cnt[kProducers / 32], nlist[2];
  __shared__ bool last;
  const int j = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const long long* ga = acc + g * kEnt;
  if (j == 0) {
    for (int i = tid; i < kPairs * kPairs; i += kWalkThreads) {
      const int a = i / kPairs, b = i % kPairs;
      a100[g * kPairs * kPairs + i] =
          __ll2float_rn(ga[tri_index(min(a, b), max(a, b))]);
    }
    if (g < kClasses && tid < 2) {
      const int e = tid ? kCount : kT2;
      const long long* gc = acc + 4 * g * kEnt + e;
      const float v =
          __ll2float_rn(gc[0] + gc[kEnt] + gc[2 * kEnt] + gc[3 * kEnt]);
      (tid ? npx : sse0)[g] = v;
    }
  }
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) any |= ga[kAbs + k] >= kExactLimit;
  any &= gemv != 0;
  if (j == 0 && tid < kPairs && !(any && ga[kAbs + tid] >= kExactLimit))
    b100[g * kPairs + tid] = __ll2float_rn(ga[kFt + tid]);
  if (!any) return;

  // lane j's points p = 8u + j, u < nu (P is a multiple of 8), stored
  // lane-major by the tile pass
  const int nu = ((h + 1) / 2) * ((w + 1) / 2) / kLanes;
  const int nchunks = (nu + kChunk - 1) / kChunk;
  const int lane = tid & 31, warp = tid >> 5, ck = tid - kProducers;
  // producer warp w: the points u = 256·w + 32·s + l (lane l, s < 8) of
  // a chunk; its key bytes and its hits' products (as 96 pieces of 16 B,
  // piece i·32 + l by lane l) one chunk ahead, in registers
  const unsigned char* lkeys = keys + (long long)j * nu;
  const float4* lft = (const float4*)ft + 3LL * j * nu;
  int kn[kWalkRows], pos[kWalkRows], run = 0;
  unsigned bal[kWalkRows];
  float4 pr[kWalkRows][3];
  auto load_keys = [&](int chunk) {
#pragma unroll
    for (int s = 0; s < kWalkRows; ++s) {
      const int u = chunk * kChunk + 256 * warp + 32 * s + lane;
      kn[s] = u < nu ? lkeys[u] : kGroups;
    }
  };
  auto classify = [&](int chunk) {   // hits, ranks, product loads
    run = 0;
#pragma unroll
    for (int s = 0; s < kWalkRows; ++s) {
      bal[s] = __ballot_sync(0xffffffffu, kn[s] == g);
      pos[s] = run + __popc(bal[s] & ((1u << lane) - 1));
      run += __popc(bal[s]);
      const long long u0 = chunk * kChunk + 256 * warp + 32 * s;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if ((bal[s] >> ((32 * i + lane) / 3)) & 1)
          pr[s][i] = lft[3 * u0 + 32 * i + lane];
    }
  };
  if (tid < kProducers) {
    load_keys(0);
    classify(0);
    load_keys(1);
  }
  float chain = 0.f;
  for (int it = 0; it <= nchunks; ++it) {
    if (tid < kProducers) {
      if (it < nchunks) {
        // the order is (warp, s, l): offset by the earlier warps' counts
        if (lane == 0) cnt[warp] = run;
        asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
        int off = 0, total = 0;
#pragma unroll
        for (int v = 0; v < kProducers / 32; ++v) {
          off += v < warp ? cnt[v] : 0;
          total += cnt[v];
        }
        if (tid == 0) nlist[it & 1] = total;
        // zeros after the list, up to a multiple of 32 entries
        float* list = prod + (it & 1) * kChunk * kPairs;
        for (int i = total * kPairs + tid; i < ((total + 31) & ~31) * kPairs;
             i += kProducers)
          list[i] = 0.f;
        float4* dst = (float4*)list;
#pragma unroll
        for (int s = 0; s < kWalkRows; ++s) {
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int q = 32 * i + lane;       // piece q: point q / 3
            const int at = __shfl_sync(0xffffffffu, pos[s], q / 3);
            if ((bal[s] >> (q / 3)) & 1) dst[3 * (off + at) + q % 3] = pr[s][i];
          }
        }
        if (it + 1 < nchunks) {
          classify(it + 1);
          load_keys(it + 2);
        }
      }
    } else if (it > 0 && ck < kPairs) {
      // chain thread k: the previous chunk's products of row k in
      // increasing p, each load issued 16 adds ahead of its add; the list
      // runs on in zeros to a multiple of 32 (x + 0 = x for every sum
      // here: it is never −0)
      const float* src = prod + ((it - 1) & 1) * kChunk * kPairs + ck;
      const int m = (nlist[(it - 1) & 1] + 31) & ~31;
      float x[kAhead], y[kAhead];
      if (m > 0) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) x[u] = src[u * kPairs];
      }
      for (int i0 = 0; i0 < m; i0 += 2 * kAhead) {
        const float* q = src + i0 * kPairs;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          y[u] = q[(kAhead + u) * kPairs];
          chain = __fadd_rn(chain, x[u]);
        }
        const bool more = i0 + 2 * kAhead < m;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (more) x[u] = q[(2 * kAhead + u) * kPairs];
          chain = __fadd_rn(chain, y[u]);
        }
      }
    }
    __syncthreads();
  }
  // the lane sums meet in the last of the group's CTAs to end
  if (ck >= 0 && ck < kPairs) {
    lane_sums[(g * kLanes + j) * kPairs + ck] = chain;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd((unsigned long long*)(acc + kGroups * kEnt + g), 1ULL) ==
           kLanes - 1;
  __syncthreads();
  if (!last || tid >= kPairs || ga[kAbs + tid] < kExactLimit) return;
  __threadfence();
  const int k = tid;
  float v[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
    v[l] = __ldcg(lane_sums + (g * kLanes + l) * kPairs + k);
  // rows 0..7 pair the lanes (0,1)(2,3)(4,5)(6,7); rows 8..11 (0,4)(2,6)
  // (1,5)(3,7)
  const bool head = k < 8;
  const float v1 = head ? v[1] : v[4], v3 = head ? v[3] : v[6];
  const float v4 = head ? v[4] : v[1], v6 = head ? v[6] : v[3];
  b100[g * kPairs + k] = __fadd_rn(
      __fadd_rn(__fadd_rn(v[0], v1), __fadd_rn(v[2], v3)),
      __fadd_rn(__fadd_rn(v4, v[5]), __fadd_rn(v6, v[7])));
}

}  // namespace

// o, r [h, w] int32; cls4, tr4 [⌈h/4⌉, w4 ≥ ⌈w/4⌉] int32.  acc: scratch of
// 100 · (kEnt + 1) int64.  Writes a100 [100, 12, 12], b100 [100, 12],
// sse0 [25], npx [25] float32.  With gemv set (P = ⌈h/2⌉·⌈w/2⌉ ≥ 4096, a
// multiple of 8) B100 takes the GEMV's order where Σ|F·t| ≥ 2^24, and
// keys (P bytes), ft (P · 12 float32) and lane_sums (100 · 8 · 12
// float32) are scratch (else unused).
extern "C" int alf_stats_launch(const int* o, const int* r, const int* cls4,
                                const int* tr4, int h, int w, int w4,
                                long long* acc, unsigned char* keys,
                                float* ft, float* lane_sums, float* a100,
                                float* b100, float* sse0, float* npx,
                                int gemv, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      alf_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(alf_final_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kWalkSmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(acc, 0, sizeof(long long) * kGroups * (kEnt + 1), s);
  if (err != cudaSuccess) return (int)err;
  const int hs = (h + 1) / 2, ws = (w + 1) / 2;
  const dim3 tiles((ws + kTile - 1) / kTile, (hs + kTile - 1) / kTile);
  alf_tile_kernel<<<tiles, kTileThreads, kTileSmem, s>>>(
      o, r, cls4, tr4, h, w, w4, (unsigned long long*)acc,
      gemv ? keys : nullptr, gemv ? ft : nullptr);
  alf_final_kernel<<<dim3(kLanes, kGroups), kWalkThreads, kWalkSmem, s>>>(
      keys, ft, h, w, acc, lane_sums, gemv, a100, b100, sse0, npx);
  return (int)cudaGetLastError();
}
