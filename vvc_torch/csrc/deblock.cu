// One shard's tile-edge luma deblock (BS 2) for the sharded encoder.
//
// `tile_edge_deblock` replaces the shard body of vvc/shard/filter.py:119-131
// (`deblock_tile_edges`), which runs vvc/shard/filter.py:35
// `_filter_edge_cols` on the vertical edge at each side of a tile stripe:
//   left edge:  p = the left halo (the previous tile's last 4 columns),
//               q = the stripe's first 4 columns;
//   right edge: p = the stripe's last 4 columns,
//               q = the right halo (the next tile's first 4 columns).
// Only the stripe's own columns are written (q side of the left edge, p
// side of the right one); the left edge is skipped on the first tile and
// the right edge on the last (`left`, `right`).  The output is a copy of
// the stripe made by the wrapper; the kernel reads the input stripe, so
// the two edges never race (Wt >= 8).
//
// Mapping: one thread per (edge, 4-row segment).  It reads the segment's
// 4 x 8 window, takes the on / strong / side decisions from rows 0 and 3,
// and filters its 4 rows.  All int32: `>>` of a negative value is an
// arithmetic shift, as jnp's; the strong filter clips to p +- 2tC first,
// then to [0, maxv].  Bound: bytes — 2 x 4 x 8 x 4 B read and 2 x 4 x 4 x 4
// B written per segment (under 1 MB at 1080p); a launch is a few hundred
// threads, so it is launch-bound.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void tile_edge_deblock_kernel(int* __restrict__ out,
                                         const int* __restrict__ x,
                                         const int* __restrict__ fl,
                                         const int* __restrict__ fr, int h,
                                         int wt, int left, int right,
                                         int beta, int tc, int maxv) {
  const int g = h >> 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * g) return;
  const int edge = t / g;  // 0: left edge, 1: right edge
  const int seg = t - edge * g;
  if ((edge == 0 && !left) || (edge == 1 && !right)) return;
  // the window's 8 columns for the segment's 4 rows: p3 p2 p1 p0 q0 q1 q2 q3
  int w[4][8];
  for (int r = 0; r < 4; ++r) {
    const int y = seg * 4 + r;
    const int* row = x + (long long)y * wt;
    for (int c = 0; c < 4; ++c) {
      if (edge == 0) {
        w[r][c] = fl[y * 4 + c];
        w[r][4 + c] = row[c];
      } else {
        w[r][c] = row[wt - 4 + c];
        w[r][4 + c] = fr[y * 4 + c];
      }
    }
  }
  // decisions from rows 0 and 3
  const int dp0 = abs(w[0][1] - 2 * w[0][2] + w[0][3]);
  const int dp3 = abs(w[3][1] - 2 * w[3][2] + w[3][3]);
  const int dq0 = abs(w[0][6] - 2 * w[0][5] + w[0][4]);
  const int dq3 = abs(w[3][6] - 2 * w[3][5] + w[3][4]);
  const int d = dp0 + dp3 + dq0 + dq3;
  const bool on = d < beta;
  if (!on) return;  // out already holds the unfiltered stripe
  const int thr = (5 * tc + 1) >> 1;
  const bool strong =
      (2 * (dp0 + dq0) < (beta >> 2)) && (2 * (dp3 + dq3) < (beta >> 2)) &&
      (abs(w[0][0] - w[0][3]) + abs(w[0][4] - w[0][7]) < (beta >> 3)) &&
      (abs(w[0][3] - w[0][4]) < thr) &&
      (abs(w[3][0] - w[3][3]) + abs(w[3][4] - w[3][7]) < (beta >> 3)) &&
      (abs(w[3][3] - w[3][4]) < thr);
  const int act = (beta + (beta >> 1)) >> 3;
  const bool side_p_seg = (dp0 + dp3) < act;
  const bool side_q_seg = (dq0 + dq3) < act;
  const int c2 = 2 * tc;
  const int tch = tc >> 1;
  for (int r = 0; r < 4; ++r) {
    const int p3 = w[r][0], p2 = w[r][1], p1 = w[r][2], p0 = w[r][3];
    const int q0 = w[r][4], q1 = w[r][5], q2 = w[r][6], q3 = w[r][7];
    int o[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
    if (strong) {
      o[3] = clip3(clip3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                         p0 - c2, p0 + c2), 0, maxv);
      o[2] = clip3(clip3((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2), 0,
                   maxv);
      o[1] = clip3(clip3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                         p2 - c2, p2 + c2), 0, maxv);
      o[4] = clip3(clip3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                         q0 - c2, q0 + c2), 0, maxv);
      o[5] = clip3(clip3((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2), 0,
                   maxv);
      o[6] = clip3(clip3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                         q2 - c2, q2 + c2), 0, maxv);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (abs(delta) < 10 * tc) {
        const int dlt = clip3(delta, -tc, tc);
        o[3] = clip3(p0 + dlt, 0, maxv);
        o[4] = clip3(q0 - dlt, 0, maxv);
        if (side_p_seg) {
          const int dp1 = clip3((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch,
                                tch);
          o[2] = clip3(p1 + dp1, 0, maxv);
        }
        if (side_q_seg) {
          const int dq1 = clip3((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch,
                                tch);
          o[5] = clip3(q1 + dq1, 0, maxv);
        }
      }
    }
    int* orow = out + (long long)(seg * 4 + r) * wt;
    for (int c = 0; c < 4; ++c) {
      if (edge == 0)
        orow[c] = o[4 + c];
      else
        orow[wt - 4 + c] = o[c];
    }
  }
}

}  // namespace

extern "C" int tile_edge_deblock_launch(int* out, const int* x,
                                        const int* from_left,
                                        const int* from_right, int h, int wt,
                                        int left, int right, int beta, int tc,
                                        int maxv, void* stream) {
  if (h <= 0 || (h & 3) || wt < 8) return (int)cudaErrorInvalidValue;
  const int n = 2 * (h >> 2);
  const int threads = 128;
  tile_edge_deblock_kernel<<<(n + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      out, x, from_left, from_right, h, wt, left, right, beta, tc, maxv);
  return (int)cudaGetLastError();
}
