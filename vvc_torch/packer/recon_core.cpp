// Native sequential reconstruction core (intra predict + DCT2 + quant).
//
// TPU-native framework's host runtime analog of the reference's native
// reconstruction loop (VTM/source/Lib/DecoderLib/DecCu.cpp →
// xIntraRecBlk; CommonLib/IntraPrediction.cpp, TrQuant.cpp, Quant.cpp;
// OpenVVC libovvc/rcn_intra*.c, rcn_transform.c).  The batched TPU kernels
// (vvc_torch.kernels.*) remain the compute path for the RDO search and the
// future wavefront decoder; this core services the latency-bound
// sequential z-order recon exactly like the reference's native loop, and
// is the bit-exact mirror of vvc_torch/model/recon.py + vvc_torch/kernels/{intra,
// transform,quant}.py numpy oracles (enforced by tests/test_torch_encode.py).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o librecon.so recon_core.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int PLANAR = 0, DC = 1, VER = 50, DIA = 34;

// transform matrices by [type][log2 size]: type 0=DCT2 (log2 2..6),
// 1=DST7, 2=DCT8 (log2 2..5)
const int32_t* g_mats_t[3][7] = {{nullptr}};
#define g_mats g_mats_t[0]

const int ABS_ANG[17] = {0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32};

int pred_angle(int mode) {
  int idx = mode - VER;
  int a = ABS_ANG[idx < 0 ? -idx : idx];
  return idx < 0 ? -a : a;
}
int inv_angle(int angle) {
  int a = angle < 0 ? -angle : angle;
  return (512 * 32 + a / 2) / a;
}

struct Block {
  std::vector<int32_t> v;
  int s;
  int32_t* data() { return v.data(); }
};

// ---- reference line (mirror of vvc/kernels/intra.py build_ref_line) ----

void build_ref_line(const int32_t* plane, int h, int w, const uint8_t* coded,
                    int cw4, int x0, int y0, int s, int bit_depth,
                    int log2_unit, int32_t* c /*4s+3*/) {
  int n = 4 * s + 3;
  std::vector<uint8_t> avail(n, 0);
  std::memset(c, 0, sizeof(int32_t) * n);
  if (x0 > 0) {
    for (int k = 0; k < 2 * s; k++) {
      int py = y0 + k;
      if (py < h && coded[(py >> log2_unit) * cw4 + ((x0 - 1) >> log2_unit)]) {
        c[2 * s - 1 - k] = plane[py * w + x0 - 1];
        avail[2 * s - 1 - k] = 1;
      }
    }
  }
  if (x0 > 0 && y0 > 0 &&
      coded[((y0 - 1) >> log2_unit) * cw4 + ((x0 - 1) >> log2_unit)]) {
    c[2 * s] = plane[(y0 - 1) * w + x0 - 1];
    avail[2 * s] = 1;
  }
  if (y0 > 0) {
    for (int k = 0; k < 2 * s; k++) {
      int px = x0 + k;
      if (px < w && coded[((y0 - 1) >> log2_unit) * cw4 + (px >> log2_unit)]) {
        c[2 * s + 1 + k] = plane[(y0 - 1) * w + px];
        avail[2 * s + 1 + k] = 1;
      }
    }
  }
  int first = -1;
  for (int i = 0; i < n; i++)
    if (avail[i]) {
      first = i;
      break;
    }
  if (first < 0) {
    for (int i = 0; i < n; i++) c[i] = 1 << (bit_depth - 1);
    return;
  }
  for (int i = 0; i < first; i++) c[i] = c[first];
  for (int i = first + 1; i < 4 * s + 1; i++)
    if (!avail[i]) c[i] = c[i - 1];
  c[4 * s + 1] = c[4 * s];
  c[4 * s + 2] = c[4 * s];
}

// ---- MIP (mirror of vvc/kernels/mip.py mip_predict_np) ----

constexpr int K_MIP_MODES = 9;
int32_t g_mip_w[K_MIP_MODES * 64 * 8];  // int8 table widened at init

// LFNST kernels [4 sets][2][16][64] (vvc/rom/lfnst_mats.py), widened at init
int32_t g_lfnst_w[4 * 2 * 16 * 64];

// mirror of vvc/kernels/lfnst.py lfnst_set: mode -> (set, transpose)
void lfnst_set(int mode, int* g, int* t) {
  if (mode >= 67) { *g = 0; *t = 0; return; }  // MIP
  *t = mode > 34;
  int m = *t ? 68 - mode : mode;
  *g = m <= 1 ? 0 : (m <= 12 ? 1 : (m <= 23 ? 2 : 3));
}

// forward: top-left 8x8 primary coeffs -> 16 secondary in top-left 4x4,
// everything else zeroed (mirror of fwd_lfnst_np)
void fwd_lfnst(int32_t* coeff, int s, int mode, int li) {
  int g, t;
  lfnst_set(mode, &g, &t);
  const int32_t* b = g_lfnst_w + ((g * 2) + (li - 1)) * 16 * 64;
  int64_t c8[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      c8[y * 8 + x] = t ? coeff[x * s + y] : coeff[y * s + x];
  int32_t out16[16];
  for (int o = 0; o < 16; o++) {
    int64_t acc = 32;
    for (int k = 0; k < 64; k++) acc += (int64_t)b[o * 64 + k] * c8[k];
    acc >>= 6;
    out16[o] = acc < -32768 ? -32768 : (acc > 32767 ? 32767 : (int32_t)acc);
  }
  std::memset(coeff, 0, sizeof(int32_t) * s * s);
  for (int o = 0; o < 16; o++) coeff[(o / 4) * s + (o % 4)] = out16[o];
}

// inverse: 16 secondary (top-left 4x4) -> top-left 8x8 primary coeffs
// (mirror of inv_lfnst_np)
void inv_lfnst(int32_t* deq, int s, int mode, int li) {
  int g, t;
  lfnst_set(mode, &g, &t);
  const int32_t* b = g_lfnst_w + ((g * 2) + (li - 1)) * 16 * 64;
  int64_t y16[16];
  for (int o = 0; o < 16; o++) y16[o] = deq[(o / 4) * s + (o % 4)];
  int32_t c8[64];
  for (int k = 0; k < 64; k++) {
    int64_t acc = 32;
    for (int o = 0; o < 16; o++) acc += (int64_t)b[o * 64 + k] * y16[o];
    acc >>= 6;
    c8[k] = acc < -32768 ? -32768 : (acc > 32767 ? 32767 : (int32_t)acc);
  }
  std::memset(deq, 0, sizeof(int32_t) * s * s);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      deq[y * s + x] = t ? c8[x * 8 + y] : c8[y * 8 + x];
}
bool g_mip_ready = false;

void predict_mip(const int32_t* c, int k, int s, int bit_depth,
                 int32_t* pred /*s*s*/) {
  const int32_t* top = c + 2 * s + 1;
  auto leftv = [&](int i) { return c[2 * s - 1 - i]; };
  int pool = s >> 2, lp = 0;
  while ((1 << lp) < pool) lp++;
  int64_t b[8];
  for (int j = 0; j < 4; j++) {
    int64_t st = 0, sl = 0;
    for (int t = 0; t < pool; t++) {
      st += top[j * pool + t];
      sl += leftv(j * pool + t);
    }
    b[j] = (st + (pool >> 1)) >> lp;
    b[4 + j] = (sl + (pool >> 1)) >> lp;
  }
  int64_t m = (b[0] + b[1] + b[2] + b[3] + b[4] + b[5] + b[6] + b[7] + 4) >> 3;
  const int32_t* w = g_mip_w + k * 64 * 8;
  int mx = (1 << bit_depth) - 1;
  int32_t red[64];
  for (int o = 0; o < 64; o++) {
    int64_t acc = 0;
    for (int i = 0; i < 8; i++) acc += (int64_t)w[o * 8 + i] * (b[i] - m);
    int64_t v = ((acc + 32) >> 6) + m;
    red[o] = v < 0 ? 0 : (v > mx ? mx : (int32_t)v);
  }
  int u = s >> 3;
  if (u == 1) {
    for (int i = 0; i < 64; i++) pred[i] = red[i];
    return;
  }
  int lu = 0;
  while ((1 << lu) < u) lu++;
  // horizontal: anchors left[(i+1)u-1] at x=-1 and red[i][j] at x=(j+1)u-1
  std::vector<int32_t> hor(8 * s);
  for (int i = 0; i < 8; i++) {
    int la = leftv((i + 1) * u - 1);
    for (int x = 0; x < s; x++) {
      int j0 = x >> lu, d = (x & (u - 1)) + 1;
      int a = j0 == 0 ? la : red[i * 8 + j0 - 1];
      int bb = red[i * 8 + j0];
      hor[i * s + x] = ((u - d) * a + d * bb + (u >> 1)) >> lu;
    }
  }
  // vertical: anchors top[x] at y=-1 and hor[i][x] at y=(i+1)u-1
  for (int y = 0; y < s; y++) {
    int i0 = y >> lu, d = (y & (u - 1)) + 1;
    for (int x = 0; x < s; x++) {
      int a = i0 == 0 ? top[x] : hor[(i0 - 1) * s + x];
      int bb = hor[i0 * s + x];
      pred[y * s + x] = ((u - d) * a + d * bb + (u >> 1)) >> lu;
    }
  }
}

// intra 4-tap fractional filters [32][4] (vvc/rom/intra_filters.py)
int32_t g_fc[32 * 4];
int32_t g_fg[32 * 4];

// mirror of vvc/rom/intra_filters.py use_smooth_filter
bool use_smooth_filter(int mode, int log2s) {
  if (mode < 2 || mode > 66) return false;
  int d1 = mode - 18 < 0 ? 18 - mode : mode - 18;
  int d2 = mode - 50 < 0 ? 50 - mode : mode - 50;
  int dist = d1 < d2 ? d1 : d2;
  int thres = log2s == 2 ? 24 : (log2s == 3 ? 14 : (log2s == 4 ? 2 : 0));
  return dist > thres;
}

// ---- intra prediction (mirror of predict_intra) ----

void predict_intra(const int32_t* c, int mode, int s, int bit_depth,
                   int32_t* pred /*s*s*/) {
  int log2s = 0;
  while ((1 << log2s) < s) log2s++;
  const int32_t* top = c + 2 * s + 1;  // top[k]
  // left[k] = c[2s-1-k]
  auto leftv = [&](int k) { return c[2 * s - 1 - k]; };

  if (mode == PLANAR) {
    int bl = leftv(s);   // below-left L[s]
    int ar = top[s];     // above-right T[s]
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++) {
        int pv = ((s - 1 - y) * top[x] + (y + 1) * bl) << log2s;
        int ph = ((s - 1 - x) * leftv(y) + (x + 1) * ar) << log2s;
        pred[y * s + x] = (pv + ph + s * s) >> (2 * log2s + 1);
      }
  } else if (mode == DC) {
    int64_t sum = 0;
    for (int k = 0; k < s; k++) sum += top[k] + leftv(k);
    int dc = (int)((sum + s) >> (log2s + 1));
    for (int i = 0; i < s * s; i++) pred[i] = dc;
  } else {
    bool vertical = mode >= DIA;
    int m = vertical ? mode : 68 - mode;
    int angle = pred_angle(m);
    int ia = angle < 0 ? inv_angle(angle) : 0;
    std::vector<int32_t> ct;
    const int32_t* cc = c;
    if (!vertical) {
      // reversed line (left/top swap), +2 pad — mirror of the oracle
      ct.resize(4 * s + 3);
      for (int i = 0; i <= 4 * s; i++) ct[i] = c[4 * s - i];
      ct[4 * s + 1] = ct[4 * s];
      ct[4 * s + 2] = ct[4 * s];
      cc = ct.data();
    }
    auto c_pos = [&](int k) -> int {
      if (k >= 0) return 2 * s + k <= 4 * s + 2 ? 2 * s + k : 4 * s + 2;
      int i = -k;
      int v = 2 * s - ((i * ia + 256) >> 9);
      return v < 0 ? 0 : v;
    };
    const int32_t* filt = use_smooth_filter(m, log2s) ? g_fg : g_fc;
    std::vector<int32_t> pv(s * s);
    for (int y = 0; y < s; y++) {
      int off = ((y + 1) * angle) >> 5;
      int f = ((y + 1) * angle) & 31;
      const int32_t* fr = filt + 4 * f;
      for (int x = 0; x < s; x++) {
        int e = x + off + 1;
        int acc = 32;
        for (int k = 0; k < 4; k++) acc += fr[k] * cc[c_pos(e + k - 1)];
        pv[y * s + x] = acc >> 6;
      }
    }
    // angular PDPC in v-space (mirror of intra.py pdpc_ang_tables /
    // apply_pdpc_ang_np; spec 8.4.5.2.14 analog)
    if (m == 50) {
      int scale = (2 * log2s - 2) >> 2;
      int corner = cc[2 * s];
      for (int y = 0; y < s; y++) {
        int left = cc[2 * s - 1 - y];
        for (int x = 0; x < s; x++) {
          int sh = (2 * x) >> scale;
          int wl = sh < 31 ? 32 >> sh : 0;
          pv[y * s + x] += (wl * (left - corner)) >> 6;
        }
      }
    } else if (m > 50) {
      int ia2 = inv_angle(angle);
      int v = 3 * ia2 - 2, fl = 0;
      while ((1 << (fl + 1)) <= v) fl++;
      int scale = log2s - (fl - 8);
      if (scale > 2) scale = 2;
      if (scale >= 0) {
        int xmax = std::min(3 << scale, s);
        for (int x = 0; x < xmax; x++) {
          int sh = (2 * x) >> scale;
          int wl = sh < 31 ? 32 >> sh : 0;
          if (!wl) continue;
          int dy = (256 + (x + 1) * ia2) >> 9;
          for (int y = 0; y < s; y++) {
            int row = y + dy;
            if (row >= 2 * s) continue;
            int ref = cc[2 * s - 1 - row];
            int p = pv[y * s + x];
            pv[y * s + x] = p + ((wl * (ref - p) + 32) >> 6);
          }
        }
      }
    }
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++)
        pred[vertical ? y * s + x : x * s + y] = pv[y * s + x];
  }

  if ((mode == PLANAR || mode == DC) && s >= 4) {
    int scale = (2 * log2s - 2) >> 2;
    for (int y = 0; y < s; y++) {
      int sh_y = (2 * y) >> scale;
      int wt = sh_y < 31 ? 32 >> sh_y : 0;
      for (int x = 0; x < s; x++) {
        int sh_x = (2 * x) >> scale;
        int wl = sh_x < 31 ? 32 >> sh_x : 0;
        pred[y * s + x] = (wl * leftv(y) + wt * top[x] +
                           (64 - wl - wt) * pred[y * s + x] + 32) >> 6;
      }
    }
  }
  int mx = (1 << bit_depth) - 1;
  for (int i = 0; i < s * s; i++) {
    int v = pred[i];
    pred[i] = v < 0 ? 0 : (v > mx ? mx : v);
  }
}

// ---- transforms (mirror of fwd/inv_transform_np, DCT2 square) ----

void fwd_dct2(const int32_t* resi, int s, int bit_depth, int32_t* coeff,
              int tr_h = 0, int tr_v = 0) {
  int log2s = 0;
  while ((1 << log2s) < s) log2s++;
  const int32_t* th = g_mats_t[tr_h][log2s];
  const int32_t* tv = g_mats_t[tr_v][log2s];
  int shift1 = log2s + bit_depth - 9;
  int shift2 = log2s + 6;
  std::vector<int64_t> tmp(s * s);
  // horizontal: tmp[y][u] = sum_w resi[y][w] * th[u][w]
  for (int y = 0; y < s; y++)
    for (int u = 0; u < s; u++) {
      int64_t acc = 0;
      for (int wi = 0; wi < s; wi++)
        acc += (int64_t)resi[y * s + wi] * th[u * s + wi];
      tmp[y * s + u] = (acc + (1 << (shift1 - 1))) >> shift1;
    }
  for (int v = 0; v < s; v++)
    for (int u = 0; u < s; u++) {
      int64_t acc = 0;
      for (int y = 0; y < s; y++) acc += (int64_t)tv[v * s + y] * tmp[y * s + u];
      int64_t r = (acc + (1 << (shift2 - 1))) >> shift2;
      coeff[v * s + u] = r < -32768 ? -32768 : (r > 32767 ? 32767 : (int32_t)r);
    }
}

void inv_dct2(const int32_t* coeff, int s, int bit_depth, int32_t* resi,
              int tr_h = 0, int tr_v = 0) {
  int log2s = 0;
  while ((1 << log2s) < s) log2s++;
  const int32_t* th = g_mats_t[tr_h][log2s];
  const int32_t* tv = g_mats_t[tr_v][log2s];
  int shift2 = 20 - bit_depth;
  std::vector<int64_t> tmp(s * s);
  // vertical inverse: tmp[y][u] = sum_v tv[v][y]*coeff[v][u]
  for (int y = 0; y < s; y++)
    for (int u = 0; u < s; u++) {
      int64_t acc = 0;
      for (int v = 0; v < s; v++) acc += (int64_t)tv[v * s + y] * coeff[v * s + u];
      int64_t r = (acc + 64) >> 7;
      tmp[y * s + u] = r < -32768 ? -32768 : (r > 32767 ? 32767 : r);
    }
  for (int y = 0; y < s; y++)
    for (int x = 0; x < s; x++) {
      int64_t acc = 0;
      for (int u = 0; u < s; u++) acc += tmp[y * s + u] * th[u * s + x];
      int64_t r = (acc + (1 << (shift2 - 1))) >> shift2;
      resi[y * s + x] = r < -32768 ? -32768 : (r > 32767 ? 32767 : (int32_t)r);
    }
}

// ---- quant (mirror of quant_np/dequant_np) ----

const int32_t QUANT_SCALES[6] = {26214, 23302, 20560, 18396, 16384, 14564};
const int32_t INV_QUANT_SCALES[6] = {40, 45, 51, 57, 64, 72};
constexpr int64_t DEQ_GUARD = 1 << 29;

int quant(const int32_t* coeff, int s, int qp, int bit_depth, int32_t* lev) {
  int log2s = 0;
  while ((1 << log2s) < s) log2s++;
  int tshift = 15 - bit_depth - log2s;
  int qbits = 14 + qp / 6 + tshift;
  int64_t scale = QUANT_SCALES[qp % 6];
  int64_t offset = (int64_t)171 << (qbits - 9);
  int nz = 0;
  for (int i = 0; i < s * s; i++) {
    int64_t a = coeff[i] < 0 ? -(int64_t)coeff[i] : coeff[i];
    int64_t l = (a * scale + offset) >> qbits;
    if (l > 32767) l = 32767;
    lev[i] = coeff[i] < 0 ? (int32_t)-l : (int32_t)l;
    nz |= l != 0;
  }
  return nz;
}

void dequant(const int32_t* lev, int s, int qp, int bit_depth, int32_t* coeff) {
  int log2s = 0;
  while ((1 << log2s) < s) log2s++;
  int tshift = 15 - bit_depth - log2s;
  int shift = 6 - tshift;
  int64_t scale = INV_QUANT_SCALES[qp % 6];
  int sh6 = qp / 6;
  int64_t guard = DEQ_GUARD >> sh6;
  for (int i = 0; i < s * s; i++) {
    int64_t lv = (int64_t)lev[i] * scale;
    if (lv > guard) lv = guard;
    if (lv < -guard) lv = -guard;
    lv <<= sh6;
    int64_t cfin;
    if (shift > 0)
      cfin = (lv + (1 << (shift - 1))) >> shift;
    else
      cfin = lv << (-shift);
    coeff[i] = cfin < -32768 ? -32768 : (cfin > 32767 ? 32767 : (int32_t)cfin);
  }
}

// ---- dependent quantization (mirror of vvc/kernels/depquant.py) ----
//
// 4-state trellis quantizer (reference: DepQuant.cpp → DQIntern::DepQuant
// Viterbi over scan positions) + state-walk dequant.  Bit-identical to the
// Python oracle: same double-precision op order in the cost recursion, the
// same measured level-rate LUT (uploaded at init), the same forward-diag
// scan walked in coding order.

static const int DQ_NEXT[4][2] = {{0, 2}, {2, 0}, {1, 3}, {3, 1}};
static std::vector<double> g_dq_rate;  // measured level-rate LUT
static double g_dq_last = 0.0, g_dq_slope = 0.0;
static int g_dq_tab_len = 0;           // len(LEVEL_BITS_TABLE) in Python

static inline double dq_rate(int64_t l) {
  if (l < (int64_t)g_dq_rate.size()) return g_dq_rate[(size_t)l];
  return g_dq_last + g_dq_slope * std::log2(1.0 + (double)l -
                                            (double)(g_dq_tab_len - 1));
}

// full_scan_rect (vvc/cabac/residual.py): CGs in up-right diagonal order,
// 4x4 diagonal inside; plain diagonal when a side is < 4.  Emitted in
// FORWARD order (DC first); callers walk it backwards for coding order.
static void dq_scan(int w, int h, std::vector<int>& xs, std::vector<int>& ys) {
  xs.clear(); ys.clear();
  auto diag = [](int dw, int dh, std::vector<int>& ox, std::vector<int>& oy) {
    for (int d = 0; d < dw + dh - 1; d++) {
      int y = d < dh - 1 ? d : dh - 1;
      while (y >= 0 && (d - y) < dw) { ox.push_back(d - y); oy.push_back(y); y--; }
    }
  };
  if (w < 4 || h < 4) { diag(w, h, xs, ys); return; }
  std::vector<int> cgx, cgy, ix, iy;
  diag(w >> 2, h >> 2, cgx, cgy);
  diag(4, 4, ix, iy);
  for (size_t g = 0; g < cgx.size(); g++)
    for (size_t i = 0; i < 16; i++) {
      xs.push_back(cgx[g] * 4 + ix[i]);
      ys.push_back(cgy[g] * 4 + iy[i]);
    }
}

void dequant_depquant(const int32_t* levels, int w, int h, int qp,
                      int bit_depth, int32_t* out) {
  int lw = 0, lh = 0;
  while ((1 << lw) < w) lw++;
  while ((1 << lh) < h) lh++;
  int tshift = 15 - bit_depth - ((lw + lh) >> 1);
  int shift = 6 - tshift + 1;            // +1: half-step granularity
  int64_t scale = INV_QUANT_SCALES[qp % 6];
  int sh6 = qp / 6;
  std::vector<int> xs, ys;
  dq_scan(w, h, xs, ys);
  std::memset(out, 0, sizeof(int32_t) * w * h);
  int state = 0;
  for (int i = (int)xs.size() - 1; i >= 0; i--) {
    int x = xs[i], y = ys[i];
    int64_t l = levels[y * w + x];
    if (l != 0) {
      int64_t a = l < 0 ? -l : l;
      int64_t t = 2 * a - (state > 1 ? 1 : 0);
      int64_t v = (t * scale) << sh6;
      int64_t c = shift > 0 ? ((v + (1 << (shift - 1))) >> shift)
                            : (v << (-shift));
      int64_t sv = l > 0 ? c : -c;
      if (sv > 32767) sv = 32767;
      if (sv < -32768) sv = -32768;
      out[y * w + x] = (int32_t)sv;
    }
    state = DQ_NEXT[state][(int)((l < 0 ? -l : l) & 1)];
  }
}

int quant_depquant(const int32_t* coeff, int w, int h, int qp, int bit_depth,
                   double lam_t, int32_t* out) {
  int lw = 0, lh = 0;
  while ((1 << lw) < w) lw++;
  while ((1 << lh) < h) lh++;
  int tshift = 15 - bit_depth - ((lw + lh) >> 1);
  int qbits = 14 + qp / 6 + tshift;
  double scale = (double)QUANT_SCALES[qp % 6];
  std::vector<int> xs, ys;
  dq_scan(w, h, xs, ys);
  int n = (int)xs.size();
  double denom = (double)((int64_t)1 << (qbits - 1));
  const double INF = std::numeric_limits<double>::infinity();
  double cost[4] = {0.0, INF, INF, INF};
  std::vector<int32_t> ch_l(n * 4), ch_s(n * 4);
  // walk in coding order (reversed forward scan)
  for (int i = 0; i < n; i++) {
    int x = xs[n - 1 - i], y = ys[n - 1 - i];
    int32_t c0 = coeff[y * w + x];
    double t = (double)(c0 < 0 ? -(int64_t)c0 : (int64_t)c0) * scale / denom;
    double ncost[4] = {INF, INF, INF, INF};
    int nl[4] = {0, 0, 0, 0}, nps[4] = {0, 0, 0, 0};
    for (int s = 0; s < 4; s++) {
      if (cost[s] == INF) continue;
      int64_t base = s < 2 ? (int64_t)(t / 2) : (int64_t)((t + 1) / 2);
      if (base < 0) base = 0;
      int64_t cands[3] = {0, base, base + 1};
      for (int k = 0; k < 3; k++) {
        int64_t l = cands[k];
        if (k == 1 && l == 0) continue;  // python set {0, base, base+1}
        double rec = l == 0 ? 0.0 : 2.0 * (double)l - (s > 1 ? 1.0 : 0.0);
        double d = (t - rec) * (t - rec);
        double c = cost[s] + d + lam_t * dq_rate(l);
        int ns = DQ_NEXT[s][(int)(l & 1)];
        if (c < ncost[ns]) {
          ncost[ns] = c;
          nl[ns] = (int)l;
          nps[ns] = s;
        }
      }
    }
    for (int s = 0; s < 4; s++) {
      cost[s] = ncost[s];
      ch_l[i * 4 + s] = nl[s];
      ch_s[i * 4 + s] = nps[s];
    }
  }
  int s = 0;
  for (int k = 1; k < 4; k++)
    if (cost[k] < cost[s]) s = k;
  std::memset(out, 0, sizeof(int32_t) * w * h);
  int cbf = 0;
  for (int i = n - 1; i >= 0; i--) {
    int x = xs[n - 1 - i], y = ys[n - 1 - i];
    int l = ch_l[i * 4 + s];
    int ps = ch_s[i * 4 + s];
    out[y * w + x] = coeff[y * w + x] < 0 ? -l : l;
    cbf |= l != 0;
    s = ps;
  }
  return cbf;
}

}  // namespace

extern "C" {

// matrices: flat int32 tables (row-major, rows = frequency).  DCT2 sizes
// 4..64; DST7/DCT8 sizes 4..32 (spec limit).
void recon_init(const int32_t* t4, const int32_t* t8, const int32_t* t16,
                const int32_t* t32, const int32_t* t64, const int32_t* d7_4,
                const int32_t* d7_8, const int32_t* d7_16, const int32_t* d7_32,
                const int32_t* d8_4, const int32_t* d8_8, const int32_t* d8_16,
                const int32_t* d8_32) {
  static std::vector<int32_t> store[3][7];
  const int32_t* src[3][7] = {
      {nullptr, nullptr, t4, t8, t16, t32, t64},
      {nullptr, nullptr, d7_4, d7_8, d7_16, d7_32, nullptr},
      {nullptr, nullptr, d8_4, d8_8, d8_16, d8_32, nullptr}};
  for (int ty = 0; ty < 3; ty++)
    for (int l = 2; l <= 6; l++) {
      if (!src[ty][l]) continue;
      int s = 1 << l;
      store[ty][l].assign(src[ty][l], src[ty][l] + s * s);
      g_mats_t[ty][l] = store[ty][l].data();
    }
}

// dep-quant rate model upload: measured level-rate LUT (level_bits_scalar
// values for 0..n-1) + the tail formula parameters
void depquant_init(const double* lut, int n, int tab_len, double slope) {
  g_dq_rate.assign(lut, lut + n);
  g_dq_last = lut[tab_len - 1];
  g_dq_tab_len = tab_len;
  g_dq_slope = slope;
}

void quant_depquant_c(const int32_t* coeff, int w, int h, int qp,
                      int bit_depth, double lam_t, int32_t* out) {
  quant_depquant(coeff, w, h, qp, bit_depth, lam_t, out);
}

void dequant_depquant_c(const int32_t* levels, int w, int h, int qp,
                        int bit_depth, int32_t* out) {
  dequant_depquant(levels, w, h, qp, bit_depth, out);
}

// MIP weight upload: [K_MIP_MODES, 64, 8] int8 (vvc/rom/mip_mats.py)
void mip_init(const int8_t* w) {
  for (int i = 0; i < K_MIP_MODES * 64 * 8; i++) g_mip_w[i] = w[i];
  g_mip_ready = true;
}

// intra filter upload: fc/fg [32][4] int32 (vvc/rom/intra_filters.py)
void intra_filt_init(const int32_t* fc, const int32_t* fg) {
  for (int i = 0; i < 32 * 4; i++) { g_fc[i] = fc[i]; g_fg[i] = fg[i]; }
}

// LFNST kernel upload: [4, 2, 16, 64] int8 (vvc/rom/lfnst_mats.py)
void lfnst_init(const int8_t* w) {
  for (int i = 0; i < 4 * 2 * 16 * 64; i++) g_lfnst_w[i] = w[i];
}

// direct MIP predict (test harness entry)
void predict_mip_c(const int32_t* c, int k, int s, int bit_depth,
                   int32_t* pred) {
  predict_mip(c, k, s, bit_depth, pred);
}

// direct intra predict (test harness entry)
void predict_intra_c(const int32_t* c, int mode, int s, int bit_depth,
                     int32_t* pred) {
  predict_intra(c, mode, s, bit_depth, pred);
}

// CCLM support (mirror of vvc/kernels/cclm.py) --------------------------

static int cclm_luma_ds(const int32_t* luma, int lh, int lw, int cx, int cy) {
  int x = 2 * cx;
  int y0 = 2 * cy < lh - 1 ? 2 * cy : lh - 1;
  int y1 = 2 * cy + 1 < lh - 1 ? 2 * cy + 1 : lh - 1;
  int xm = x - 1 > 0 ? x - 1 : 0;
  int xp = x + 1 < lw - 1 ? x + 1 : lw - 1;
  return (luma[y0 * lw + xm] + 2 * luma[y0 * lw + x] + luma[y0 * lw + xp] +
          luma[y1 * lw + xm] + 2 * luma[y1 * lw + x] + luma[y1 * lw + xp] +
          4) >> 3;
}

constexpr int CCLM_SHIFT = 13;

// variant: 1 = LM (both sides), 2 = LM_L (left only), 3 = LM_T (top only)
static void cclm_predict(const int32_t* luma, int lh, int lw,
                         const int32_t* chroma, int ch, int cw,
                         const uint8_t* coded, int cw4, int log2_unit,
                         int cx0, int cy0, int cs, int bit_depth,
                         int32_t* pred, int variant) {
  // gather up to 4 (lumaDS, chroma) pairs — mirror gather_model_points
  auto avail = [&](int px, int py) {
    return px >= 0 && py >= 0 && px < cw && py < ch &&
           coded[(py >> log2_unit) * cw4 + (px >> log2_unit)];
  };
  int pl[4], pc[4];
  int np = 0;
  bool top_ok = cy0 > 0 && avail(cx0, cy0 - 1) && variant != 2;
  bool left_ok = cx0 > 0 && avail(cx0 - 1, cy0) && variant != 3;
  int xs[4], nxs = 0, ys[4], nys = 0;
  if (top_ok && left_ok) {
    xs[nxs++] = cx0 + cs / 4;
    xs[nxs++] = cx0 + (3 * cs) / 4;
    ys[nys++] = cy0 + cs / 4;
    ys[nys++] = cy0 + (3 * cs) / 4;
  } else if (top_ok) {
    for (int k = 0; k < 4; k++) xs[nxs++] = cx0 + k * cs / 4;
  } else if (left_ok) {
    for (int k = 0; k < 4; k++) ys[nys++] = cy0 + k * cs / 4;
  }
  for (int k = 0; k < nxs && np < 4; k++) {
    int x = xs[k] < cw - 1 ? xs[k] : cw - 1;
    if (avail(x, cy0 - 1)) {
      pl[np] = cclm_luma_ds(luma, lh, lw, x, cy0 - 1);
      pc[np] = chroma[(cy0 - 1) * cw + x];
      np++;
    }
  }
  for (int k = 0; k < nys && np < 4; k++) {
    int y = ys[k] < ch - 1 ? ys[k] : ch - 1;
    if (avail(cx0 - 1, y)) {
      pl[np] = cclm_luma_ds(luma, lh, lw, cx0 - 1, y);
      pc[np] = chroma[y * cw + cx0 - 1];
      np++;
    }
  }
  int64_t alpha = 0, beta = 1 << (bit_depth - 1);
  if (np > 0) {
    // cyclic duplication to 4 (mirror: while len<4: pts += pts; pts[:4])
    int fl[4], fc[4];
    for (int k = 0; k < 4; k++) {
      fl[k] = pl[k % np];
      fc[k] = pc[k % np];
    }
    // stable sort by luma (4 elements — insertion sort keeps stability)
    for (int i = 1; i < 4; i++) {
      int kl = fl[i], kc = fc[i], j = i - 1;
      while (j >= 0 && fl[j] > kl) {
        fl[j + 1] = fl[j];
        fc[j + 1] = fc[j];
        j--;
      }
      fl[j + 1] = kl;
      fc[j + 1] = kc;
    }
    int lmin = (fl[0] + fl[1] + 1) >> 1, lmax = (fl[2] + fl[3] + 1) >> 1;
    int cmin = (fc[0] + fc[1] + 1) >> 1, cmax = (fc[2] + fc[3] + 1) >> 1;
    if (lmax == lmin) {
      alpha = 0;
      beta = cmin;
    } else {
      int64_t num = (int64_t)(cmax - cmin) << CCLM_SHIFT;
      int64_t den = lmax - lmin;  // > 0
      // floor division (python // semantics)
      alpha = num >= 0 ? num / den : -((-num + den - 1) / den);
      if (alpha > (1 << 17) - 1) alpha = (1 << 17) - 1;
      if (alpha < -(1 << 17)) alpha = -(1 << 17);
      beta = cmin - ((alpha * lmin) >> CCLM_SHIFT);
    }
  }
  int mx = (1 << bit_depth) - 1;
  for (int yy = 0; yy < cs; yy++)
    for (int xx = 0; xx < cs; xx++) {
      int64_t l = cclm_luma_ds(luma, lh, lw, cx0 + xx, cy0 + yy);
      int64_t v = ((alpha * l) >> CCLM_SHIFT) + beta;
      pred[yy * cs + xx] = v < 0 ? 0 : (v > mx ? (int64_t)mx : v);
    }
}

// One block recon.  enc_mode: derive levels from orig (returns cbf);
// otherwise apply provided levels (levels may be null → all-zero).
// ext_pred: optional externally computed prediction (CCLM).
int recon_block_p(int32_t* plane, int h, int w, uint8_t* coded, int cw4,
                  const int32_t* orig, int x0, int y0, int size, int mode,
                  int qp, int bit_depth, int log2_unit, int32_t* levels_io,
                  int enc_mode, int tr_h, int tr_v, int lossless,
                  const int32_t* ext_pred, int lfnst = 0) {
  int s = size;
  std::vector<int32_t> c(4 * s + 3), pred(s * s), buf(s * s), buf2(s * s);
  if (ext_pred) {
    std::memcpy(pred.data(), ext_pred, sizeof(int32_t) * s * s);
  } else {
    build_ref_line(plane, h, w, coded, cw4, x0, y0, s, bit_depth, log2_unit,
                   c.data());
    if (mode >= 67)
      predict_mip(c.data(), mode - 67, s, bit_depth, pred.data());
    else
      predict_intra(c.data(), mode, s, bit_depth, pred.data());
  }
  int cbf;
  if (enc_mode) {
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++)
        buf[y * s + x] = orig[(y0 + y) * w + x0 + x] - pred[y * s + x];
    if (lossless) {
      cbf = 0;
      for (int i = 0; i < s * s; i++) {
        levels_io[i] = buf[i];
        cbf |= buf[i] != 0;
      }
    } else {
      fwd_dct2(buf.data(), s, bit_depth, buf2.data(), tr_h, tr_v);
      if (lfnst) fwd_lfnst(buf2.data(), s, mode, lfnst);
      cbf = quant(buf2.data(), s, qp, bit_depth, levels_io);
    }
  } else {
    cbf = 0;
    if (levels_io)
      for (int i = 0; i < s * s; i++) cbf |= levels_io[i] != 0;
  }
  int mx = (1 << bit_depth) - 1;
  if (cbf) {
    if (lossless) {
      std::memcpy(buf.data(), levels_io, sizeof(int32_t) * s * s);
    } else {
      dequant(levels_io, s, qp, bit_depth, buf2.data());
      if (lfnst) inv_lfnst(buf2.data(), s, mode, lfnst);
      inv_dct2(buf2.data(), s, bit_depth, buf.data(), tr_h, tr_v);
    }
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++) {
        int v = pred[y * s + x] + buf[y * s + x];
        plane[(y0 + y) * w + x0 + x] = v < 0 ? 0 : (v > mx ? mx : v);
      }
  } else {
    for (int y = 0; y < s; y++)
      for (int x = 0; x < s; x++)
        plane[(y0 + y) * w + x0 + x] = pred[y * s + x];
  }
  // mark availability in the per-unit coded map
  int u0x = x0 >> log2_unit, u0y = y0 >> log2_unit;
  int us = s >> log2_unit ? s >> log2_unit : 1;
  for (int uy = 0; uy < us; uy++)
    std::memset(coded + (u0y + uy) * cw4 + u0x, 1, us);
  return cbf;
}

int recon_block(int32_t* plane, int h, int w, uint8_t* coded, int cw4,
                const int32_t* orig, int x0, int y0, int size, int mode,
                int qp, int bit_depth, int log2_unit, int32_t* levels_io,
                int enc_mode, int tr_h, int tr_v, int lossless) {
  return recon_block_p(plane, h, w, coded, cw4, orig, x0, y0, size, mode, qp,
                       bit_depth, log2_unit, levels_io, enc_mode, tr_h, tr_v,
                       lossless, nullptr);
}

// Batched tile reconstruction: one call per (tile, component).
// meta: int32 [n][7] = (x0, y0, size, mode, tr_h, tr_v, lfnst) in plane
// coords.
// levels: packed int32 buffer; offsets[i] = start of leaf i's size*size
// block.  enc_mode: derives levels into the buffer, writes cbf[i].
// Decode: cbf[i] on input says whether levels are present for leaf i.
// cmodes: per-leaf chroma mode (1 = CCLM) or null; luma_plane: recon luma
// for CCLM (chroma passes only).
void recon_leaves(int32_t* plane, int h, int w, uint8_t* coded, int cw4,
                  const int32_t* orig, const int32_t* meta, int n,
                  int32_t* levels, const int64_t* offsets, int32_t* cbf,
                  int qp, int bit_depth, int log2_unit, int enc_mode,
                  int lossless, const int32_t* luma_plane, int lh, int lw,
                  const int32_t* cmodes) {
  std::vector<int32_t> predbuf;
  for (int i = 0; i < n; i++) {
    const int32_t* m = meta + 7 * i;
    int32_t* lv = levels + offsets[i];
    int32_t* lv_arg = lv;
    if (!enc_mode && !cbf[i]) lv_arg = nullptr;
    const int32_t* ext = nullptr;
    if (cmodes && cmodes[i] >= 1 && luma_plane) {
      int s = m[2];
      predbuf.resize(s * s);
      cclm_predict(luma_plane, lh, lw, plane, h, w, coded, cw4, log2_unit,
                   m[0], m[1], s, bit_depth, predbuf.data(), cmodes[i]);
      ext = predbuf.data();
    }
    cbf[i] = recon_block_p(plane, h, w, coded, cw4, orig, m[0], m[1], m[2],
                           m[3], qp, bit_depth, log2_unit, lv_arg, enc_mode,
                           m[4], m[5], lossless, ext, m[6]);
  }
}

// ---- ALF (mirror of vvc/kernels/alf.py alf_classify /
// alf_delta_classified — bit-exact, test-enforced) ---------------------

static const int32_t ALF_ACT_TAB[16] = {0, 1, 2, 2, 2, 2, 2, 3,
                                        3, 3, 3, 3, 3, 3, 3, 4};
static const int32_t ALF_TR_TAB[8] = {0, 1, 0, 2, 2, 3, 1, 3};

void alf_classify_c(const int32_t* rec, int h, int w, int bit_depth,
                    int32_t* cls /*h4*w4*/, int32_t* tr /*h4*w4*/) {
  int h4 = h / 4, w4 = w / 4;
  auto at = [&](int y, int x) {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    x = x < 0 ? 0 : (x >= w ? w - 1 : x);
    return (int64_t)rec[y * w + x];
  };
  // laplacians at sample positions -1..h (edge-clamped neighbours), then
  // the 8x8 window reads them with one more clamp ring (the numpy twin's
  // pad-by-1 of the lap plane)
  auto iabs = [](int64_t v) { return v < 0 ? -v : v; };
  auto lap = [&](int kind, int y, int x) {
    int64_t c = at(y, x);
    switch (kind) {
      case 0: return iabs(2 * c - at(y - 1, x) - at(y + 1, x));
      case 1: return iabs(2 * c - at(y, x - 1) - at(y, x + 1));
      case 2: return iabs(2 * c - at(y - 1, x - 1) - at(y + 1, x + 1));
      default: return iabs(2 * c - at(y - 1, x + 1) - at(y + 1, x - 1));
    }
  };
  for (int by = 0; by < h4; by++)
    for (int bx = 0; bx < w4; bx++) {
      int64_t sv = 0, sh2 = 0, s0 = 0, s1 = 0;
      for (int wy = 0; wy < 8; wy++) {
        int ly = 4 * by - 2 + wy;           // sample row (window -2..+5)
        ly = ly < -1 ? -1 : (ly > h ? h : ly);  // lap exists for -1..h
        for (int wx = 0; wx < 8; wx++) {
          int lx = 4 * bx - 2 + wx;
          lx = lx < -1 ? -1 : (lx > w ? w : lx);
          sv += lap(0, ly, lx);
          sh2 += lap(1, ly, lx);
          s0 += lap(2, ly, lx);
          s1 += lap(3, ly, lx);
        }
      }
      int64_t hv1 = sv > sh2 ? sv : sh2, hv0 = sv > sh2 ? sh2 : sv;
      int dir_hv = sv > sh2 ? 1 : 3;
      int64_t d1 = s0 > s1 ? s0 : s1, d0 = s0 > s1 ? s1 : s0;
      int dir_d = s0 > s1 ? 0 : 2;
      bool hv_stronger = hv1 * d0 > d1 * hv0;
      int64_t hvd1 = hv_stronger ? hv1 : d1, hvd0 = hv_stronger ? hv0 : d0;
      int main_dir = hv_stronger ? dir_hv : dir_d;
      int sec_dir = hv_stronger ? dir_d : dir_hv;
      int strength = 2 * hvd1 > 9 * hvd0 ? 2 : (hvd1 > 2 * hvd0 ? 1 : 0);
      int64_t act = ((sv + sh2) * 64) >> (4 + bit_depth);
      if (act > 15) act = 15;
      int c = ALF_ACT_TAB[act];
      if (strength > 0) c += (((main_dir & 1) << 1) + strength) * 5;
      cls[by * w4 + bx] = c;
      tr[by * w4 + bx] = ALF_TR_TAB[main_dir * 2 + (sec_dir >> 1)];
    }
}

// pairs: [np][4] = (ady, adx, bdy, bdx); perms: [4][np]
void alf_delta_classified_c(const int32_t* rec, int h, int w,
                            const int32_t* coeffs, const int32_t* clips,
                            int nf, const int32_t* fmap, const int32_t* cls,
                            const int32_t* tr, const int32_t* pairs,
                            const int32_t* perms, int npair,
                            int32_t* delta) {
  (void)nf;
  int w4 = w / 4;
  auto at = [&](int y, int x) {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    x = x < 0 ? 0 : (x >= w ? w - 1 : x);
    return rec[y * w + x];
  };
  // per-(filter, transpose) permuted coefficient rows + precomputed pair
  // strides for the interior fast path (no clamping)
  std::vector<int32_t> offa(npair), offb(npair);
  for (int i = 0; i < npair; i++) {
    offa[i] = pairs[4 * i] * w + pairs[4 * i + 1];
    offb[i] = pairs[4 * i + 2] * w + pairs[4 * i + 3];
  }
  for (int y = 0; y < h; y++) {
    bool yin = y >= 3 && y < h - 3;
    for (int x = 0; x < w; x++) {
      int blk = (y >> 2) * w4 + (x >> 2);
      int f = fmap[cls[blk]];
      int t = tr[blk];
      int32_t b = clips[f] > 0 ? clips[f] : (1 << 12);
      const int32_t* base = rec + y * w + x;
      int32_t cur = *base;
      int32_t acc = 1 << (7 - 1);
      const int32_t* cf = coeffs + f * npair;
      const int32_t* pm = perms + t * npair;
      if (yin && x >= 3 && x < w - 3) {
        for (int i = 0; i < npair; i++) {
          int32_t da = base[offa[i]] - cur;
          int32_t db = base[offb[i]] - cur;
          da = da < -b ? -b : (da > b ? b : da);
          db = db < -b ? -b : (db > b ? b : db);
          acc += cf[pm[i]] * (da + db);
        }
      } else {
        for (int i = 0; i < npair; i++) {
          const int32_t* pr = pairs + 4 * i;
          int32_t da = at(y + pr[0], x + pr[1]) - cur;
          int32_t db = at(y + pr[2], x + pr[3]) - cur;
          da = da < -b ? -b : (da > b ? b : da);
          db = db < -b ? -b : (db > b ? b : db);
          acc += cf[pm[i]] * (da + db);
        }
      }
      delta[y * w + x] = acc >> 7;
    }
  }
}

}  // extern "C"

// ===========================================================================
// v2: full-tool sequential reconstruction — rect/MTT leaves (wide-angle
// intra), MRL reference lines, ISP sub-TUs (implicit DST7), dependent
// quantization, LMCS chroma residual scaling, inter leaves (prediction
// supplied by the batched MC prepass / mode-decision pass), CIIP blending.
// Mirrors vvc/model/recon.py reconstruct_leaves bit-exactly (tests).
// Reference: DecCu.cpp xReconIntraQT/xReconInter; IntraSearch.cpp
// xIntraCodingTUBlock; the SIMD-everywhere architecture of
// CommonLib/x86/*X86.h (SURVEY.md §2.2) — the tools-on path must never
// fall back to per-leaf interpreted code (VERDICT r3 task 1).
// ===========================================================================

namespace {

// extended intraPredAngle table (wide-angle modes; spec 8.4.5.2.7 range)
const int ABS_ANG_EXT[33] = {0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20,
                             23, 26, 29, 32, 35, 39, 45, 51, 57, 64, 73,
                             86, 102, 128, 171, 256, 341, 512, 682, 1024};

int pred_angle_ext(int vmode) {
  int idx = vmode - 50;
  int a = ABS_ANG_EXT[idx < 0 ? -idx : idx];
  return idx < 0 ? -a : a;
}

int log2i(int v) { int l = 0; while ((1 << l) < v) l++; return l; }

// mirror of vvc/kernels/intra.py wide_angle_remap (spec 8.4.5.2.7)
int wide_angle_remap_c(int mode, int w, int h) {
  if (w == h || mode < 2 || mode > 66) return mode;
  int d = log2i(w) - log2i(h);
  int ratio = d < 0 ? -d : d;
  if (ratio > 2) ratio = 2;
  if (w > h && mode < (ratio > 1 ? 8 + 2 * ratio : 8)) return mode + 65;
  if (h > w && mode > (ratio > 1 ? 60 - 2 * ratio : 60)) return mode - 67;
  return mode;
}

// rect reference line: C of length 2H+2W+3 (left 2H reversed, corner,
// top 2W, 2 pads) — mirror of build_ref_line_rect
void build_ref_line_rect_c(const int32_t* plane, int ph, int pw,
                           const uint8_t* coded, int cw4, int x0, int y0,
                           int bw, int bh, int bit_depth, int log2_unit,
                           int32_t* c) {
  int n = 2 * bh + 2 * bw + 3;
  std::vector<uint8_t> avail(n, 0);
  std::memset(c, 0, sizeof(int32_t) * n);
  if (x0 > 0) {
    for (int k = 0; k < 2 * bh; k++) {
      int py = y0 + k;
      int pyc = py < ph - 1 ? py : ph - 1;
      if (py < ph &&
          coded[(pyc >> log2_unit) * cw4 + ((x0 - 1) >> log2_unit)]) {
        c[2 * bh - 1 - k] = plane[pyc * pw + x0 - 1];
        avail[2 * bh - 1 - k] = 1;
      }
    }
  }
  if (x0 > 0 && y0 > 0 &&
      coded[((y0 - 1) >> log2_unit) * cw4 + ((x0 - 1) >> log2_unit)]) {
    c[2 * bh] = plane[(y0 - 1) * pw + x0 - 1];
    avail[2 * bh] = 1;
  }
  if (y0 > 0) {
    for (int k = 0; k < 2 * bw; k++) {
      int px = x0 + k;
      int pxc = px < pw - 1 ? px : pw - 1;
      if (px < pw &&
          coded[((y0 - 1) >> log2_unit) * cw4 + (pxc >> log2_unit)]) {
        c[2 * bh + 1 + k] = plane[(y0 - 1) * pw + pxc];
        avail[2 * bh + 1 + k] = 1;
      }
    }
  }
  int lim = 2 * bh + 2 * bw + 1;
  int first = -1;
  for (int i = 0; i < lim; i++)
    if (avail[i]) { first = i; break; }
  if (first < 0) {
    for (int i = 0; i < n; i++) c[i] = 1 << (bit_depth - 1);
    return;
  }
  for (int i = 0; i < first; i++) c[i] = c[first];
  for (int i = first + 1; i < lim; i++)
    if (!avail[i]) c[i] = c[i - 1];
  c[lim] = c[lim - 1];
  c[lim + 1] = c[lim - 1];
}

// MRL reference line at offset k (square; mirror of build_ref_line_mrl —
// the offset line substitutes as the adjacent line, alternative-line
// deviation documented there)
void build_ref_line_mrl_c(const int32_t* plane, int ph, int pw,
                          const uint8_t* coded, int cw4, int x0, int y0,
                          int s, int bit_depth, int k, int log2_unit,
                          int32_t* c) {
  int n = 4 * s + 3;
  std::vector<uint8_t> avail(n, 0);
  std::memset(c, 0, sizeof(int32_t) * n);
  int xl = x0 - 1 - k, yt = y0 - 1 - k;
  if (xl >= 0) {
    for (int i = 0; i < 2 * s; i++) {
      int py = y0 + i;
      int pyc = py < ph - 1 ? py : ph - 1;
      if (py < ph && coded[(pyc >> log2_unit) * cw4 + (xl >> log2_unit)]) {
        c[2 * s - 1 - i] = plane[pyc * pw + xl];
        avail[2 * s - 1 - i] = 1;
      }
    }
  }
  if (xl >= 0 && yt >= 0 &&
      coded[(yt >> log2_unit) * cw4 + (xl >> log2_unit)]) {
    c[2 * s] = plane[yt * pw + xl];
    avail[2 * s] = 1;
  }
  if (yt >= 0) {
    for (int i = 0; i < 2 * s; i++) {
      int px = x0 + i;
      int pxc = px < pw - 1 ? px : pw - 1;
      if (px < pw && coded[(yt >> log2_unit) * cw4 + (pxc >> log2_unit)]) {
        c[2 * s + 1 + i] = plane[yt * pw + pxc];
        avail[2 * s + 1 + i] = 1;
      }
    }
  }
  int lim = 4 * s + 1;
  int first = -1;
  for (int i = 0; i < lim; i++)
    if (avail[i]) { first = i; break; }
  if (first < 0) {
    for (int i = 0; i < n; i++) c[i] = 1 << (bit_depth - 1);
    return;
  }
  for (int i = 0; i < first; i++) c[i] = c[first];
  for (int i = first + 1; i < lim; i++)
    if (!avail[i]) c[i] = c[i - 1];
  c[lim] = c[lim - 1];
  c[lim + 1] = c[lim - 1];
}

// v-space angular prediction (wv×hv block, extended vertical-family mode
// 34..82) incl. angular PDPC — mirror of angular_tables4_rect +
// apply_pdpc_ang_np evaluated inline
void predict_ang_vspace(const int32_t* cc, int vmode, int wv, int hv,
                        int32_t* pv) {
  int angle = pred_angle_ext(vmode);
  int ia = angle < 0 ? inv_angle(angle) : 0;
  int smooth_mode = vmode <= 66 ? vmode : 66;
  int log2s = (log2i(wv) + log2i(hv)) >> 1;
  const int32_t* filt = use_smooth_filter(smooth_mode, log2s) ? g_fg : g_fc;
  int base = 2 * hv, last = 2 * hv + 2 * wv + 2;
  auto c_pos = [&](int k) -> int {
    if (k >= 0) return base + k <= last ? base + k : last;
    int i = -k;
    int v = base - ((i * ia + 256) >> 9);
    return v < 0 ? 0 : v;
  };
  for (int y = 0; y < hv; y++) {
    int off = ((y + 1) * angle) >> 5;
    int f = ((y + 1) * angle) & 31;
    const int32_t* fr = filt + 4 * f;
    for (int x = 0; x < wv; x++) {
      int e = x + off + 1;
      int acc = 32;
      for (int k = 0; k < 4; k++) acc += fr[k] * cc[c_pos(e + k - 1)];
      pv[y * wv + x] = acc >> 6;
    }
  }
  // angular PDPC (mirror of pdpc_ang_tables: diff form at 50, avg form
  // 51..82)
  if (vmode == 50) {
    int scale = (log2i(wv) + log2i(hv) - 2) >> 2;
    int corner = cc[2 * hv];
    for (int y = 0; y < hv; y++) {
      int left = cc[2 * hv - 1 - y];
      for (int x = 0; x < wv; x++) {
        int sh = (2 * x) >> scale;
        int wl = sh < 31 ? 32 >> sh : 0;
        pv[y * wv + x] += (wl * (left - corner)) >> 6;
      }
    }
  } else if (vmode > 50) {
    int ia2 = inv_angle(angle);
    int v = 3 * ia2 - 2, fl = 0;
    while ((1 << (fl + 1)) <= v) fl++;
    int scale = log2i(hv) - (fl - 8);
    if (scale > 2) scale = 2;
    if (scale >= 0) {
      int xmax = (3 << scale) < wv ? (3 << scale) : wv;
      for (int x = 0; x < xmax; x++) {
        int sh = (2 * x) >> scale;
        int wl = sh < 31 ? 32 >> sh : 0;
        if (!wl) continue;
        int dy = (256 + (x + 1) * ia2) >> 9;
        for (int y = 0; y < hv; y++) {
          int row = y + dy;
          if (row >= 2 * hv) continue;
          int ref = cc[2 * hv - 1 - row];
          int p = pv[y * wv + x];
          pv[y * wv + x] = p + ((wl * (ref - p) + 32) >> 6);
        }
      }
    }
  }
}

// rect intra prediction (mirror of predict_intra_rect); c has layout
// [left 2H rev, corner, top 2W, 2 pads]
void predict_intra_rect_c(const int32_t* c, int mode, int bw, int bh,
                          int bit_depth, int32_t* pred) {
  int log2w = log2i(bw), log2h = log2i(bh);
  auto leftv = [&](int k) { return c[2 * bh - 1 - k]; };
  const int32_t* top = c + 2 * bh + 1;
  if (mode == PLANAR) {
    int bl = leftv(bh);
    int ar = top[bw];
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++) {
        int pv = ((bh - 1 - y) * top[x] + (y + 1) * bl) << log2w;
        int ph = ((bw - 1 - x) * leftv(y) + (x + 1) * ar) << log2h;
        pred[y * bw + x] = (pv + ph + bw * bh) >> (log2w + log2h + 1);
      }
  } else if (mode == DC) {
    int64_t sum = 0;
    int dc;
    if (bw == bh) {
      for (int k = 0; k < bw; k++) sum += top[k] + leftv(k);
      dc = (int)((sum + bw) >> (log2w + 1));
    } else if (bw > bh) {
      for (int k = 0; k < bw; k++) sum += top[k];
      dc = (int)((sum + (bw >> 1)) >> log2w);
    } else {
      for (int k = 0; k < bh; k++) sum += leftv(k);
      dc = (int)((sum + (bh >> 1)) >> log2h);
    }
    for (int i = 0; i < bw * bh; i++) pred[i] = dc;
  } else {
    int m = wide_angle_remap_c(mode, bw, bh);
    if (m >= DIA) {
      std::vector<int32_t> pv(bw * bh);
      predict_ang_vspace(c, m, bw, bh, pv.data());
      std::memcpy(pred, pv.data(), sizeof(int32_t) * bw * bh);
    } else {
      // horizontal family: reversed line, v-space (h, w), transpose
      int lim = 2 * bh + 2 * bw + 1;
      std::vector<int32_t> ct(lim + 2);
      for (int i = 0; i < lim; i++) ct[i] = c[lim - 1 - i];
      ct[lim] = ct[lim - 1];
      ct[lim + 1] = ct[lim - 1];
      std::vector<int32_t> pv(bw * bh);
      predict_ang_vspace(ct.data(), 68 - m, bh, bw, pv.data());
      for (int y = 0; y < bw; y++)
        for (int x = 0; x < bh; x++)
          pred[x * bw + y] = pv[y * bh + x];
    }
  }
  if ((mode == PLANAR || mode == DC) && (bw < bh ? bw : bh) >= 4) {
    int scale = (log2w + log2h - 2) >> 2;
    for (int y = 0; y < bh; y++) {
      int sh_y = (2 * y) >> scale;
      int wt = sh_y < 31 ? 32 >> sh_y : 0;
      for (int x = 0; x < bw; x++) {
        int sh_x = (2 * x) >> scale;
        int wl = sh_x < 31 ? 32 >> sh_x : 0;
        int64_t p = (int64_t)wl * leftv(y) + (int64_t)wt * top[x] +
                    (int64_t)(64 - wl - wt) * pred[y * bw + x] + 32;
        pred[y * bw + x] = (int32_t)(p >> 6);
      }
    }
  }
  int mx = (1 << bit_depth) - 1;
  for (int i = 0; i < bw * bh; i++) {
    int vv = pred[i];
    pred[i] = vv < 0 ? 0 : (vv > mx ? mx : vv);
  }
}

// rect transforms (mirror of fwd/inv_transform_np)
void fwd_tr_wh(const int32_t* resi, int bw, int bh, int bit_depth,
               int tr_h, int tr_v, int32_t* coeff) {
  int log2w = log2i(bw), log2h = log2i(bh);
  const int32_t* th = g_mats_t[tr_h][log2w];
  const int32_t* tv = g_mats_t[tr_v][log2h];
  int shift1 = log2w + bit_depth - 9;
  int shift2 = log2h + 6;
  std::vector<int64_t> tmp(bw * bh);
  for (int y = 0; y < bh; y++)
    for (int u = 0; u < bw; u++) {
      int64_t acc = 0;
      for (int x = 0; x < bw; x++)
        acc += (int64_t)resi[y * bw + x] * th[u * bw + x];
      tmp[y * bw + u] = (acc + (1 << (shift1 - 1))) >> shift1;
    }
  for (int v = 0; v < bh; v++)
    for (int u = 0; u < bw; u++) {
      int64_t acc = 0;
      for (int y = 0; y < bh; y++)
        acc += (int64_t)tv[v * bh + y] * tmp[y * bw + u];
      int64_t r = (acc + (1 << (shift2 - 1))) >> shift2;
      coeff[v * bw + u] =
          r < -32768 ? -32768 : (r > 32767 ? 32767 : (int32_t)r);
    }
}

void inv_tr_wh(const int32_t* coeff, int bw, int bh, int bit_depth,
               int tr_h, int tr_v, int32_t* resi) {
  int log2w = log2i(bw), log2h = log2i(bh);
  const int32_t* th = g_mats_t[tr_h][log2w];
  const int32_t* tv = g_mats_t[tr_v][log2h];
  int shift2 = 20 - bit_depth;
  std::vector<int64_t> tmp(bw * bh);
  for (int y = 0; y < bh; y++)
    for (int u = 0; u < bw; u++) {
      int64_t acc = 0;
      for (int v = 0; v < bh; v++)
        acc += (int64_t)tv[v * bh + y] * coeff[v * bw + u];
      int64_t r = (acc + 64) >> 7;
      tmp[y * bw + u] = r < -32768 ? -32768 : (r > 32767 ? 32767 : r);
    }
  for (int y = 0; y < bh; y++)
    for (int x = 0; x < bw; x++) {
      int64_t acc = 0;
      for (int u = 0; u < bw; u++) acc += tmp[y * bw + u] * th[u * bw + x];
      int64_t r = (acc + (1 << (shift2 - 1))) >> shift2;
      resi[y * bw + x] =
          r < -32768 ? -32768 : (r > 32767 ? 32767 : (int32_t)r);
    }
}

// rect-aware scalar quant (sqrt2-compensated scales on odd log2 area;
// intra/inter dead-zone offsets 171/85 — mirror of quant_np/dequant_np;
// rect scales derived exactly like rom/transform_mats.py *_RECT)
int64_t rect_qscale(int base) { return ((int64_t)base * 181 + 128) >> 8; }
int64_t rect_iqscale(int base) { return ((int64_t)base * 181 + 64) >> 7; }

int quant_wh(const int32_t* coeff, int bw, int bh, int qp, int bit_depth,
             int intra, int32_t* lev) {
  int log2w = log2i(bw), log2h = log2i(bh);
  int tshift = 15 - bit_depth - ((log2w + log2h) >> 1);
  int qbits = 14 + qp / 6 + tshift;
  int rect = (log2w + log2h) & 1;
  int64_t scale = rect ? rect_qscale(QUANT_SCALES[qp % 6])
                       : QUANT_SCALES[qp % 6];
  int64_t offset = (int64_t)(intra ? 171 : 85) << (qbits - 9);
  int nz = 0;
  for (int i = 0; i < bw * bh; i++) {
    int64_t a = coeff[i] < 0 ? -(int64_t)coeff[i] : coeff[i];
    int64_t l = (a * scale + offset) >> qbits;
    if (l > 32767) l = 32767;
    lev[i] = coeff[i] < 0 ? (int32_t)-l : (int32_t)l;
    nz |= l != 0;
  }
  return nz;
}

void dequant_wh(const int32_t* lev, int bw, int bh, int qp, int bit_depth,
                int32_t* coeff) {
  int log2w = log2i(bw), log2h = log2i(bh);
  int tshift = 15 - bit_depth - ((log2w + log2h) >> 1);
  int shift = 6 - tshift;
  int rect = (log2w + log2h) & 1;
  int64_t scale = rect ? rect_iqscale(INV_QUANT_SCALES[qp % 6])
                       : INV_QUANT_SCALES[qp % 6];
  int sh6 = qp / 6;
  int64_t guard = DEQ_GUARD >> sh6;
  for (int i = 0; i < bw * bh; i++) {
    int64_t lv = (int64_t)lev[i] * scale;
    if (lv > guard) lv = guard;
    if (lv < -guard) lv = -guard;
    lv <<= sh6;
    int64_t cfin;
    if (shift > 0)
      cfin = (lv + (1 << (shift - 1))) >> shift;
    else
      cfin = lv << (-shift);
    coeff[i] = cfin < -32768 ? -32768 : (cfin > 32767 ? 32767 : (int32_t)cfin);
  }
}

// ISP geometry (mirror of vvc/kernels/isp.py)
int isp_parts_c(int bw, int bh, int dir, int parts[4][4]) {
  if (dir == 1) {              // horizontal
    int k = bh >= 16 ? 4 : 2;
    int sh = bh / k;
    for (int i = 0; i < k; i++) {
      parts[i][0] = 0; parts[i][1] = i * sh; parts[i][2] = bw;
      parts[i][3] = sh;
    }
    return k;
  }
  int k = bw >= 16 ? 4 : 2;    // vertical
  int sw = bw / k;
  for (int i = 0; i < k; i++) {
    parts[i][0] = i * sw; parts[i][1] = 0; parts[i][2] = sw;
    parts[i][3] = bh;
  }
  return k;
}

void isp_tr_types_c(int sw, int sh, int* th, int* tv) {
  *th = (sw >= 4 && sw <= 16) ? 1 : 0;   // DST7 : DCT2
  *tv = (sh >= 4 && sh <= 16) ? 1 : 0;
}

// one v2 block: predict (unless ext_pred) + transform/quant roundtrip.
// chroma_scale: cs_fwd/cs_inv (1<<11 fixed point) or 0 = off.
// Returns cbf.  levels_io indexed [bh][bw] at the given stride.
int recon_block_v2(int32_t* plane, int ph, int pw, uint8_t* coded, int cw4,
                   const int32_t* orig, int x0, int y0, int bw, int bh,
                   int mode, int qp, int bit_depth, int log2_unit,
                   int32_t* levels_io, int lstride, int enc_mode, int tr_h,
                   int tr_v, int lfnst, int mrl, int intra_blk,
                   int dep_quant, double dq_lam, int64_t cs_fwd,
                   int64_t cs_inv, const int32_t* ext_pred, int ciip) {
  std::vector<int32_t> pred(bw * bh), buf(bw * bh), buf2(bw * bh);
  if (ext_pred) {
    std::memcpy(pred.data(), ext_pred, sizeof(int32_t) * bw * bh);
    if (ciip) {
      // CIIP: equal-weight blend with planar from RECON neighbours
      std::vector<int32_t> c(4 * bw + 3), pl(bw * bh);
      build_ref_line(plane, ph, pw, coded, cw4, x0, y0, bw, bit_depth,
                     log2_unit, c.data());
      predict_intra(c.data(), PLANAR, bw, bit_depth, pl.data());
      for (int i = 0; i < bw * bh; i++)
        pred[i] = (pred[i] + pl[i] + 1) >> 1;
    }
  } else if (bw == bh) {
    std::vector<int32_t> c(4 * bw + 3);
    if (mrl > 0)
      build_ref_line_mrl_c(plane, ph, pw, coded, cw4, x0, y0, bw,
                           bit_depth, mrl, log2_unit, c.data());
    else
      build_ref_line(plane, ph, pw, coded, cw4, x0, y0, bw, bit_depth,
                     log2_unit, c.data());
    if (mode >= 67)
      predict_mip(c.data(), mode - 67, bw, bit_depth, pred.data());
    else
      predict_intra(c.data(), mode, bw, bit_depth, pred.data());
  } else {
    std::vector<int32_t> c(2 * bh + 2 * bw + 3);
    build_ref_line_rect_c(plane, ph, pw, coded, cw4, x0, y0, bw, bh,
                          bit_depth, log2_unit, c.data());
    predict_intra_rect_c(c.data(), mode, bw, bh, bit_depth, pred.data());
  }
  int cbf = 0;
  if (enc_mode) {
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++)
        buf[y * bw + x] = orig[(y0 + y) * pw + x0 + x] - pred[y * bw + x];
    if (cs_fwd) {
      for (int i = 0; i < bw * bh; i++)
        buf[i] = (int32_t)(((int64_t)buf[i] * cs_fwd + 1024) >> 11);
    }
    fwd_tr_wh(buf.data(), bw, bh, bit_depth, tr_h, tr_v, buf2.data());
    if (lfnst) fwd_lfnst(buf2.data(), bw, mode, lfnst);
    std::vector<int32_t> lv(bw * bh);
    if (dep_quant) {
      quant_depquant(buf2.data(), bw, bh, qp, bit_depth, dq_lam, lv.data());
      cbf = 0;
      for (int i = 0; i < bw * bh; i++) cbf |= lv[i] != 0;
    } else {
      cbf = quant_wh(buf2.data(), bw, bh, qp, bit_depth, intra_blk,
                     lv.data());
    }
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++)
        levels_io[y * lstride + x] = lv[y * bw + x];
  } else {
    if (levels_io)
      for (int y = 0; y < bh && !cbf; y++)
        for (int x = 0; x < bw; x++)
          if (levels_io[y * lstride + x]) { cbf = 1; break; }
  }
  int mx = (1 << bit_depth) - 1;
  if (cbf) {
    std::vector<int32_t> lv(bw * bh);
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++)
        lv[y * bw + x] = levels_io[y * lstride + x];
    if (dep_quant)
      dequant_depquant(lv.data(), bw, bh, qp, bit_depth, buf2.data());
    else
      dequant_wh(lv.data(), bw, bh, qp, bit_depth, buf2.data());
    if (lfnst) inv_lfnst(buf2.data(), bw, mode, lfnst);
    inv_tr_wh(buf2.data(), bw, bh, bit_depth, tr_h, tr_v, buf.data());
    if (cs_inv) {
      for (int i = 0; i < bw * bh; i++)
        buf[i] = (int32_t)(((int64_t)buf[i] * cs_inv + 1024) >> 11);
    }
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++) {
        int v = pred[y * bw + x] + buf[y * bw + x];
        plane[(y0 + y) * pw + x0 + x] = v < 0 ? 0 : (v > mx ? mx : v);
      }
  } else {
    for (int y = 0; y < bh; y++)
      for (int x = 0; x < bw; x++)
        plane[(y0 + y) * pw + x0 + x] = pred[y * bw + x];
  }
  // availability marking (mirror: whole block after recon)
  int u0x = x0 >> log2_unit, u0y = y0 >> log2_unit;
  int usw = bw >> log2_unit ? bw >> log2_unit : 1;
  int ush = bh >> log2_unit ? bh >> log2_unit : 1;
  for (int uy = 0; uy < ush; uy++)
    std::memset(coded + (u0y + uy) * cw4 + u0x, 1, usw);
  return cbf;
}

}  // namespace

extern "C" {

// v2 batched reconstruction — one call per (tile, component).
// meta: int32 [n][16] = (x0, y0, w, h, pred, luma_mode, tr_h, tr_v,
//   lfnst, chroma_mode, isp, mrl, ciip, 0, 0, 0) in LUMA coords.
// comp: 0=Y, 1=Cb, 2=Cr (chroma geometry derived by >>1 here).
// levels/offsets/cbf per component; preds: packed int32 prediction
// buffer for inter leaves (this component's geometry), pred_off[i] or -1.
// cs_*: LMCS chroma scaling tables (17 starts + 16 fwd + 16 inv, null =
// off); luma_plane: full recon luma (CCLM + LMCS piece derivation).
void recon_leaves_v2(int32_t* plane, int ph, int pw, uint8_t* coded,
                     int cw4, const int32_t* orig, const int32_t* meta,
                     int n, int32_t* levels, const int64_t* offsets,
                     int32_t* cbf, const int32_t* preds,
                     const int64_t* pred_off, int qp, int bit_depth,
                     int log2_unit, int enc_mode, int dep_quant,
                     double dq_lam, const int64_t* cs_starts,
                     const int64_t* cs_fwd_t, const int64_t* cs_inv_t,
                     const int32_t* luma_plane, int lh, int lw, int comp) {
  std::vector<int32_t> predbuf;
  for (int i = 0; i < n; i++) {
    const int32_t* m = meta + 16 * i;
    int x0 = m[0], y0 = m[1], bw = m[2], bh = m[3];
    int is_inter = m[4], mode = m[5];
    int tr_h = m[6], tr_v = m[7], lfnst = m[8], cmode = m[9];
    int isp = m[10], mrl = m[11], ciip = m[12];
    int64_t csf = 0, csi = 0;
    if (comp != 0) {
      x0 >>= 1; y0 >>= 1; bw >>= 1; bh >>= 1;
      tr_h = tr_v = 0;
      lfnst = 0;
      isp = 0;
      mrl = 0;
      if (mode >= 67) mode = 0;   // chroma DM of a MIP leaf = planar
      if (cs_starts) {
        // LMCS chroma residual scaling: piece from the mapped-domain
        // luma recon average of this leaf (luma pass already complete)
        int64_t sum = 0;
        int lx0 = m[0], ly0 = m[1], lbw = m[2], lbh = m[3];
        for (int y = 0; y < lbh; y++)
          for (int x = 0; x < lbw; x++)
            sum += luma_plane[(ly0 + y) * lw + lx0 + x];
        int64_t avg = sum / (lbw * lbh);
        int pi = 0;
        for (int k = 1; k <= 16; k++) {
          if (cs_starts[k] <= avg) pi = k; else break;
        }
        if (pi > 15) pi = 15;
        csf = cs_fwd_t[pi];
        csi = cs_inv_t[pi];
      }
    }
    int32_t* lv = levels + offsets[i];
    int32_t* lv_arg = lv;
    if (!enc_mode && !cbf[i]) lv_arg = nullptr;
    const int32_t* ext = nullptr;
    if (is_inter && pred_off[i] >= 0) {
      ext = preds + pred_off[i];
    } else if (comp != 0 && cmode >= 1 && luma_plane && !is_inter) {
      predbuf.resize(bw * bh);
      cclm_predict(luma_plane, lh, lw, plane, ph, pw, coded, cw4,
                   log2_unit, x0, y0, bw, bit_depth, predbuf.data(),
                   cmode);
      ext = predbuf.data();
    }
    if (isp && comp == 0 && !is_inter) {
      // ISP: sub-TUs in coding order, each seeing the previous through
      // the availability map; implicit DST7/DCT2 per dimension
      int parts[4][4];
      int k = isp_parts_c(bw, bh, isp, parts);
      int any = 0;
      for (int p = 0; p < k; p++) {
        int xo = parts[p][0], yo = parts[p][1];
        int sw = parts[p][2], sh = parts[p][3];
        int sth, stv;
        isp_tr_types_c(sw, sh, &sth, &stv);
        any |= recon_block_v2(
            plane, ph, pw, coded, cw4, orig, x0 + xo, y0 + yo, sw, sh,
            mode, qp, bit_depth, log2_unit, lv + yo * bw + xo, bw,
            enc_mode, sth, stv, 0, 0, 1, dep_quant, dq_lam, 0, 0,
            nullptr, 0);
      }
      cbf[i] = any;
    } else {
      cbf[i] = recon_block_v2(plane, ph, pw, coded, cw4, orig, x0, y0, bw,
                              bh, mode, qp, bit_depth, log2_unit, lv, bw,
                              enc_mode, tr_h, tr_v, lfnst, mrl,
                              is_inter ? 0 : 1, dep_quant, dq_lam, csf,
                              csi, ext, ciip);
    }
  }
}

}  // extern "C"
