// Native CABAC packer: arithmetic engine + batched residual coding.
//
// TPU-native analog of the reference's native entropy coder
// (VTM/source/Lib/EncoderLib/BinEncoder.cpp,
//  DecoderLib/BinDecoder.cpp, CABACWriter/CABACReader residual_coding;
//  OpenVVC libovvc/vcl_cabac.c).  Per the locked architecture
// (SURVEY.md §7.0 tenet 4) the host packer is native C++ like the
// reference's, while bin *modeling* stays device-friendly.
//
// Semantics are the bit-exact mirror of the Python oracle
// vvc/cabac/engine.py + vvc/cabac/residual.py — every construct here has a
// line-for-line counterpart there, and tests/test_packer.py enforces
// byte-identical streams.  Context state is a shared int32 [n,4] array
// (s0, s1, rate0, rate1) owned by numpy.
//
// Build: g++ -O2 -shared -fPIC -o libcabac.so cabac_core.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int PROB_BITS = 15;
constexpr int HALF_PROB = 1 << 14;

struct CtxArray {
  int32_t* a;  // [n][4]
  int32_t& s0(int i) { return a[4 * i + 0]; }
  int32_t& s1(int i) { return a[4 * i + 1]; }
  int32_t r0(int i) { return a[4 * i + 2]; }
  int32_t r1(int i) { return a[4 * i + 3]; }
  int prob(int i) { return (s0(i) + s1(i)) >> 1; }
  int mps(int i) { return prob(i) >= HALF_PROB ? 1 : 0; }
  int lps_range(int i, int rng) {
    int p = prob(i);
    int q = p < HALF_PROB ? p : ((1 << PROB_BITS) - 1 - p);
    return (((q >> 9) * (rng >> 5)) >> 1) + 4;
  }
  void update(int i, int bin) {
    int target = bin << PROB_BITS;
    s0(i) += (target - s0(i)) >> r0(i);
    s1(i) += (target - s1(i)) >> r1(i);
  }
};

// ---------------------------------------------------------------- encoder

struct Enc {
  int low = 0;
  int range = 510;
  std::vector<uint8_t> bytes;
  uint32_t tail = 0;
  int ntail = 0;
  int64_t nbits = 0;

  void emit(int bit) {
    tail = (tail << 1) | (unsigned)bit;
    ntail++;
    nbits++;
    if (ntail == 8) {
      bytes.push_back((uint8_t)tail);
      tail = 0;
      ntail = 0;
    }
  }
  void carry() {
    tail += 1;
    if (tail >> ntail) {
      tail = ntail == 0 ? 0 : (tail & ((1u << ntail) - 1));
      int i = (int)bytes.size() - 1;
      while (i >= 0 && bytes[i] == 0xFF) bytes[i--] = 0;
      // i >= 0 guaranteed by the interval invariant (see engine.py)
      if (i >= 0) bytes[i]++;
    }
  }
  void renorm() {
    while (range < 256) {
      emit(low >> 8);
      low = (low & 0xFF) << 1;
      range <<= 1;
    }
  }
  void bin(CtxArray& c, int i, int b) {
    int rlps = c.lps_range(i, range);
    int m = c.mps(i);
    range -= rlps;
    if (b != m) {
      low += range;
      if (low >= 512) {
        carry();
        low -= 512;
      }
      range = rlps;
    }
    c.update(i, b);
    renorm();
  }
  void ep(int b) {
    int x = (low << 1) + (b ? range : 0);
    if (x >= 1024) {
      carry();
      x -= 1024;
    }
    emit(x >> 9);
    low = x & 0x1FF;
  }
  void eps(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) ep((v >> i) & 1);
  }
  void trm(int b) {
    range -= 2;
    if (b) {
      low += range;
      if (low >= 512) {
        carry();
        low -= 512;
      }
      range = 2;
    }
    renorm();
  }
  void finish() {
    int v = low + 1;
    for (int i = 8; i >= 0; i--) emit((v >> i) & 1);
    while (ntail != 0) emit(0);
  }
};

// ---------------------------------------------------------------- decoder

struct Dec {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  int range = 510;
  int offset = 0;

  Dec(const uint8_t* d, int64_t l) : data(d), len(l) {
    for (int i = 0; i < 9; i++) offset = (offset << 1) | bit();
  }
  int bit() {
    int64_t p = pos++;
    if ((p >> 3) >= len) return 0;
    return (data[p >> 3] >> (7 - (p & 7))) & 1;
  }
  int bin(CtxArray& c, int i) {
    int rlps = c.lps_range(i, range);
    int m = c.mps(i);
    range -= rlps;
    int b;
    if (offset >= range) {
      b = 1 - m;
      offset -= range;
      range = rlps;
    } else {
      b = m;
    }
    c.update(i, b);
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return b;
  }
  int ep() {
    offset = (offset << 1) | bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  uint32_t eps(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (unsigned)ep();
    return v;
  }
  int trm() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return 0;
  }
};

// ------------------------------------------------------------ scan tables

struct ScanTables {
  // forward scan positions for a WxH TB (CGs diagonal, 4x4 diag inside)
  std::vector<int> sx, sy;   // [nposs]
  std::vector<int> cg_index; // [sbw*sbh] (cgy*sbw+cgx) -> sb scan index
  int nposs = 0, sbw = 1, sbh = 1;
};

void diag_scan(int w, int h, std::vector<int>& xs, std::vector<int>& ys) {
  for (int d = 0; d < w + h - 1; d++) {
    int y = d < h ? d : h - 1;
    while (y >= 0 && (d - y) < w) {
      xs.push_back(d - y);
      ys.push_back(y);
      y--;
    }
  }
}

const ScanTables& scan_tables(int log2w, int log2h) {
  static ScanTables cache[8][8];
  static bool init[8][8] = {{false}};
  if (!init[log2w][log2h]) {
    ScanTables& t = cache[log2w][log2h];
    int w = 1 << log2w, h = 1 << log2h;
    if (w < 4 || h < 4) {
      diag_scan(w, h, t.sx, t.sy);
      t.sbw = 1;
      t.sbh = 1;
      t.cg_index.assign(1, 0);
    } else {
      std::vector<int> cx, cy, ix, iy;
      diag_scan(w >> 2, h >> 2, cx, cy);
      diag_scan(4, 4, ix, iy);
      t.sbw = w >> 2;
      t.sbh = h >> 2;
      t.cg_index.assign(t.sbw * t.sbh, 0);
      for (size_t g = 0; g < cx.size(); g++) {
        t.cg_index[cy[g] * t.sbw + cx[g]] = (int)g;
        for (int k = 0; k < 16; k++) {
          t.sx.push_back(cx[g] * 4 + ix[k]);
          t.sy.push_back(cy[g] * 4 + iy[k]);
        }
      }
    }
    t.nposs = (int)t.sx.size();
    init[log2w][log2h] = true;
  }
  return cache[log2w][log2h];
}

// ------------------------------------------------- residual coding shared

int group_idx(int v) {
  if (v < 4) return v;
  int k = 31 - __builtin_clz((unsigned)v);
  return (k << 1) + ((v >> (k - 1)) & 1);
}
int min_in_group(int g) {
  if (g < 4) return g;
  return (2 + (g & 1)) << ((g >> 1) - 1);
}
int last_ctx(int bin_idx, int log2s, int is_luma) {
  int offset, shift;
  if (is_luma) {
    offset = 3 * (log2s - 2) + ((log2s - 1) >> 2);
    shift = (log2s + 1) >> 2;
  } else {
    offset = 0;
    shift = log2s - 2 > 0 ? log2s - 2 : 0;
  }
  return offset + (bin_idx >> shift);
}

// residual set order — keep in sync with vvc/cabac/ctx.py RESIDUAL_SET_ORDER
enum RSet {
  R_LAST_X_LUMA = 0, R_LAST_Y_LUMA, R_LAST_X_CHROMA, R_LAST_Y_CHROMA,
  R_SB_LUMA, R_SB_CHROMA, R_SIG_LUMA, R_SIG_CHROMA, R_GT1_LUMA,
  R_GT1_CHROMA, R_PAR_LUMA, R_PAR_CHROMA, R_GT3_LUMA, R_GT3_CHROMA,
  R_NSETS
};

struct ResCtx {
  CtxArray ctx;
  const int32_t* off;  // [R_NSETS] offsets into ctx array
  int idx(int set, int i) const { return off[set] + i; }
};

int templ_sum(const int32_t* m, int w, int h, int x, int y) {
  static const int dx[5] = {1, 2, 0, 0, 1};
  static const int dy[5] = {0, 0, 1, 2, 1};
  int acc = 0;
  for (int k = 0; k < 5; k++) {
    int nx = x + dx[k], ny = y + dy[k];
    if (nx < w && ny < h) acc += m[ny * w + nx];
  }
  return acc;
}
int sig_ctx(int x, int y, const int32_t* p1, int w, int h, int is_luma) {
  int acc = templ_sum(p1, w, h, x, y);
  int diag = x + y;
  int base;
  if (is_luma)
    base = diag < 2 ? 8 : (diag < 5 ? 4 : 0);
  else
    base = diag < 2 ? 4 : 0;
  int o = (acc + 1) >> 1;
  return base + (o < 3 ? o : 3);
}
int gtx_ctx(int x, int y, const int32_t* p1, int w, int h, int is_luma) {
  int acc = templ_sum(p1, w, h, x, y);
  if (acc > 4) acc = 4;
  if (is_luma) {
    int diag = x + y;
    int base = diag == 0 ? 10 : (diag < 3 ? 5 : 0);
    return base + acc;
  }
  return acc;
}
int rice_param(int x, int y, const int32_t* full, int w, int h) {
  int acc = templ_sum(full, w, h, x, y);
  if (acc < 7) return 0;
  if (acc < 14) return 1;
  if (acc < 28) return 2;
  return 3;
}

constexpr int GR_THRESH = 6;

void write_gr(Enc& e, int rem, int rice) {
  int q = rem >> rice;
  if (q < GR_THRESH) {
    for (int i = 0; i < q; i++) e.ep(1);
    e.ep(0);
    if (rice) e.eps((unsigned)rem & ((1u << rice) - 1), rice);
  } else {
    for (int i = 0; i < GR_THRESH; i++) e.ep(1);
    int v = rem - (GR_THRESH << rice);
    int m = rice + 1;
    while (v >= (1 << m)) {
      e.ep(1);
      v -= 1 << m;
      m++;
    }
    e.ep(0);
    e.eps((unsigned)v, m);
  }
}
int read_gr(Dec& d, int rice) {
  int q = 0;
  while (q < GR_THRESH && d.ep()) q++;
  if (q < GR_THRESH) {
    int rem = q << rice;
    if (rice) rem |= (int)d.eps(rice);
    return rem;
  }
  int m = rice + 1;
  int v = GR_THRESH << rice;
  while (d.ep()) {
    v += 1 << m;
    m++;
  }
  return v + (int)d.eps(m);
}

// -------------------------------------------------------- residual encode

void enc_residual(Enc& e, ResCtx& rc, const int32_t* levels, int w, int h,
                  int is_luma) {
  int log2w = 0, log2h = 0;
  while ((1 << log2w) < w) log2w++;
  while ((1 << log2h) < h) log2h++;
  const ScanTables& t = scan_tables(log2w, log2h);
  int nposs = t.nposs;

  int last = -1;
  for (int i = nposs - 1; i >= 0; i--)
    if (levels[t.sy[i] * w + t.sx[i]] != 0) {
      last = i;
      break;
    }
  int lx = t.sx[last], ly = t.sy[last];
  int set_x = is_luma ? R_LAST_X_LUMA : R_LAST_X_CHROMA;
  int set_y = is_luma ? R_LAST_Y_LUMA : R_LAST_Y_CHROMA;
  int coords[2] = {lx, ly};
  int sets[2] = {set_x, set_y};
  int lgs[2] = {log2w, log2h};
  for (int c = 0; c < 2; c++) {
    int gmax = group_idx((1 << lgs[c]) - 1);
    int g = group_idx(coords[c]);
    for (int i = 0; i < (g < gmax ? g : gmax); i++)
      e.bin(rc.ctx, rc.idx(sets[c], last_ctx(i, lgs[c], is_luma)), 1);
    if (g < gmax)
      e.bin(rc.ctx, rc.idx(sets[c], last_ctx(g, lgs[c], is_luma)), 0);
  }
  for (int c = 0; c < 2; c++) {
    int g = group_idx(coords[c]);
    if (g > 3) e.eps((unsigned)(coords[c] - min_in_group(g)), (g >> 1) - 1);
  }

  int set_sb = is_luma ? R_SB_LUMA : R_SB_CHROMA;
  int set_sig = is_luma ? R_SIG_LUMA : R_SIG_CHROMA;
  int set_gt1 = is_luma ? R_GT1_LUMA : R_GT1_CHROMA;
  int set_par = is_luma ? R_PAR_LUMA : R_PAR_CHROMA;
  int set_gt3 = is_luma ? R_GT3_LUMA : R_GT3_CHROMA;

  int last_sb = last >> 4;
  std::vector<int32_t> p1(w * h, 0), full(w * h, 0);
  std::vector<int32_t> sb_coded((nposs + 15) >> 4, 0);
  int sbw = t.sbw, sbh = t.sbh;
  std::vector<int> gt3_pos, nz_pos;

  for (int sb = last_sb; sb >= 0; sb--) {
    int sb_end = (sb + 1) * 16 < nposs ? (sb + 1) * 16 : nposs;
    int sb_has = 0;
    for (int i = sb * 16; i < sb_end; i++)
      if (levels[t.sy[i] * w + t.sx[i]] != 0) {
        sb_has = 1;
        break;
      }
    int expl = (sb != last_sb && sb != 0);
    if (expl) {
      int cgx = t.sx[sb * 16] >> 2, cgy = t.sy[sb * 16] >> 2;
      int nb = 0;
      if (cgx + 1 < sbw && sb_coded[t.cg_index[cgy * sbw + cgx + 1]]) nb = 1;
      if (cgy + 1 < sbh && sb_coded[t.cg_index[(cgy + 1) * sbw + cgx]]) nb = 1;
      e.bin(rc.ctx, rc.idx(set_sb, nb), sb_has);
    }
    sb_coded[sb] = (sb_has || !expl) ? 1 : 0;
    if (!sb_coded[sb]) continue;

    int start = (sb == last_sb) ? last : sb_end - 1;
    int sig_found = 0;
    gt3_pos.clear();
    nz_pos.clear();
    for (int i = start; i >= sb * 16; i--) {
      int x = t.sx[i], y = t.sy[i];
      int32_t lv = levels[y * w + x];
      int a = lv < 0 ? -lv : lv;
      int sig;
      if (i == last) {
        sig = 1;
      } else {
        int infer_dc = expl && (i == sb * 16) && !sig_found;
        if (infer_dc) {
          sig = 1;
        } else {
          sig = a > 0 ? 1 : 0;
          e.bin(rc.ctx,
                rc.idx(set_sig, sig_ctx(x, y, p1.data(), w, h, is_luma)), sig);
        }
      }
      if (sig) {
        sig_found = 1;
        nz_pos.push_back(i);
        int gctx = gtx_ctx(x, y, p1.data(), w, h, is_luma);
        int gt1 = a > 1 ? 1 : 0;
        e.bin(rc.ctx, rc.idx(set_gt1, gctx), gt1);
        int par = 0, gt3 = 0;
        if (gt1) {
          par = (a - 2) & 1;
          e.bin(rc.ctx, rc.idx(set_par, gctx), par);
          gt3 = a > 3 ? 1 : 0;
          e.bin(rc.ctx, rc.idx(set_gt3, gctx), gt3);
          if (gt3) gt3_pos.push_back(i);
        }
        p1[y * w + x] = 1 + gt1 + par + 2 * gt3;
        full[y * w + x] = p1[y * w + x];
      }
    }
    for (int i : gt3_pos) {
      int x = t.sx[i], y = t.sy[i];
      int32_t lv = levels[y * w + x];
      int a = lv < 0 ? -lv : lv;
      int par = (a - 2) & 1;
      int rem = (a - 4 - par) >> 1;
      write_gr(e, rem, rice_param(x, y, full.data(), w, h));
      full[y * w + x] += 2 * rem;
    }
    for (int i : nz_pos) {
      int x = t.sx[i], y = t.sy[i];
      e.ep(levels[y * w + x] < 0 ? 1 : 0);
    }
  }
}

// -------------------------------------------------------- residual decode

void dec_residual(Dec& d, ResCtx& rc, int32_t* levels, int w, int h,
                  int is_luma) {
  int log2w = 0, log2h = 0;
  while ((1 << log2w) < w) log2w++;
  while ((1 << log2h) < h) log2h++;
  const ScanTables& t = scan_tables(log2w, log2h);
  int nposs = t.nposs;
  std::memset(levels, 0, sizeof(int32_t) * w * h);

  int set_x = is_luma ? R_LAST_X_LUMA : R_LAST_X_CHROMA;
  int set_y = is_luma ? R_LAST_Y_LUMA : R_LAST_Y_CHROMA;
  int groups[2];
  int sets[2] = {set_x, set_y};
  int lgs[2] = {log2w, log2h};
  for (int c = 0; c < 2; c++) {
    int gmax = group_idx((1 << lgs[c]) - 1);
    int g = 0;
    while (g < gmax &&
           d.bin(rc.ctx, rc.idx(sets[c], last_ctx(g, lgs[c], is_luma))))
      g++;
    groups[c] = g;
  }
  int coords[2];
  for (int c = 0; c < 2; c++) {
    int v = min_in_group(groups[c]);
    if (groups[c] > 3) v += (int)d.eps((groups[c] >> 1) - 1);
    coords[c] = v;
  }
  int last = -1;
  for (int i = 0; i < nposs; i++)
    if (t.sx[i] == coords[0] && t.sy[i] == coords[1]) {
      last = i;
      break;
    }

  int set_sb = is_luma ? R_SB_LUMA : R_SB_CHROMA;
  int set_sig = is_luma ? R_SIG_LUMA : R_SIG_CHROMA;
  int set_gt1 = is_luma ? R_GT1_LUMA : R_GT1_CHROMA;
  int set_par = is_luma ? R_PAR_LUMA : R_PAR_CHROMA;
  int set_gt3 = is_luma ? R_GT3_LUMA : R_GT3_CHROMA;

  int last_sb = last >> 4;
  std::vector<int32_t> p1(w * h, 0), full(w * h, 0);
  std::vector<int32_t> sb_coded((nposs + 15) >> 4, 0);
  int sbw = t.sbw, sbh = t.sbh;
  std::vector<int> gt3_pos, nz_pos;

  for (int sb = last_sb; sb >= 0; sb--) {
    int sb_end = (sb + 1) * 16 < nposs ? (sb + 1) * 16 : nposs;
    int expl = (sb != last_sb && sb != 0);
    int coded;
    if (expl) {
      int cgx = t.sx[sb * 16] >> 2, cgy = t.sy[sb * 16] >> 2;
      int nb = 0;
      if (cgx + 1 < sbw && sb_coded[t.cg_index[cgy * sbw + cgx + 1]]) nb = 1;
      if (cgy + 1 < sbh && sb_coded[t.cg_index[(cgy + 1) * sbw + cgx]]) nb = 1;
      coded = d.bin(rc.ctx, rc.idx(set_sb, nb));
    } else {
      coded = 1;
    }
    sb_coded[sb] = coded;
    if (!coded) continue;

    int start = (sb == last_sb) ? last : sb_end - 1;
    int sig_found = 0;
    gt3_pos.clear();
    nz_pos.clear();
    for (int i = start; i >= sb * 16; i--) {
      int x = t.sx[i], y = t.sy[i];
      int sig;
      if (i == last) {
        sig = 1;
      } else {
        int infer_dc = expl && (i == sb * 16) && !sig_found;
        sig = infer_dc
                  ? 1
                  : d.bin(rc.ctx, rc.idx(set_sig, sig_ctx(x, y, p1.data(), w,
                                                          h, is_luma)));
      }
      if (sig) {
        sig_found = 1;
        nz_pos.push_back(i);
        int gctx = gtx_ctx(x, y, p1.data(), w, h, is_luma);
        int gt1 = d.bin(rc.ctx, rc.idx(set_gt1, gctx));
        int par = 0, gt3 = 0;
        if (gt1) {
          par = d.bin(rc.ctx, rc.idx(set_par, gctx));
          gt3 = d.bin(rc.ctx, rc.idx(set_gt3, gctx));
          if (gt3) gt3_pos.push_back(i);
        }
        int v = 1 + gt1 + par + 2 * gt3;
        p1[y * w + x] = v;
        full[y * w + x] = v;
        levels[y * w + x] = v;
      }
    }
    for (int i : gt3_pos) {
      int x = t.sx[i], y = t.sy[i];
      int rem = read_gr(d, rice_param(x, y, full.data(), w, h));
      levels[y * w + x] += 2 * rem;
      full[y * w + x] = levels[y * w + x];
    }
    for (int i : nz_pos) {
      int x = t.sx[i], y = t.sy[i];
      if (d.ep()) levels[y * w + x] = -levels[y * w + x];
    }
  }
}

// ------------------------------------------------------- tree syntax writer
//
// Native port of the Python TreeWriter intra path (vvc/cabac/cu_syntax.py)
// + SAO params (vvc/cabac/sao_syntax.py) — the per-CU syntax driving is the
// encoder's host hot loop, so it runs here in one call per tile / WPP row
// (the reference's CABACWriter::coding_tree_unit is likewise native C++).
// Byte-equality with the Python writer is enforced by tests/test_packer.py.

// context-set order — keep in sync with vvc/packer/native.py TW_SET_ORDER
enum TwSet {
  T_SPLIT = 0, T_SAO_TYPE, T_SAO_MERGE, T_REF_IDX, T_MPM_FLAG,
  T_NOT_PLANAR, T_CHROMA_PRED, T_CCLM_FLAG, T_CCLM_MODE, T_CBF_LUMA,
  T_MTS_IDX, T_LFNST_IDX, T_CBF_CB, T_CBF_CR, T_MIP_FLAG, T_NSETS
};

// leaf record fields — keep in sync with vvc/packer/native.py serialization
enum LeafRec {
  L_X0 = 0, L_Y0, L_SIZE, L_MODE, L_MTS, L_LFNST, L_CHROMA,
  L_OFF_Y, L_OFF_CB, L_OFF_CR, L_NREC
};

constexpr int K_MIP_MODES = 9;   // vvc/rom/mip_mats.py
constexpr int PLANAR = 0, DC = 1, HOR = 18, VER = 50;
constexpr int MAX_SAO_OFF = 7;   // vvc/kernels/sao.py MAX_SAO_OFFSET

struct TreeCtx {
  int w, h, ctu, min_cu;
  bool mts, cclm, mip, lfnst;
  int w4, h4;
  std::vector<int16_t> mode_map;   // -1 = unset
  std::vector<int8_t> depth_map;
  std::vector<uint8_t> coded_map;

  TreeCtx(int w_, int h_, int ctu_, int mc, int flags)
      : w(w_), h(h_), ctu(ctu_), min_cu(mc),
        mts(flags & 1), cclm(flags & 2), mip(flags & 4), lfnst(flags & 8),
        w4((w_ + 3) >> 2), h4((h_ + 3) >> 2),
        mode_map((size_t)w4 * h4, -1), depth_map((size_t)w4 * h4, 0),
        coded_map((size_t)w4 * h4, 0) {}

  int mode_at(int x, int y) const {
    if (x < 0 || y < 0 || (x >> 2) >= w4 || (y >> 2) >= h4) return -1;
    size_t i = (size_t)(y >> 2) * w4 + (x >> 2);
    return coded_map[i] ? mode_map[i] : -1;
  }
  int depth_at(int x, int y) const {
    if (x < 0 || y < 0 || (x >> 2) >= w4 || (y >> 2) >= h4) return -1;
    size_t i = (size_t)(y >> 2) * w4 + (x >> 2);
    return coded_map[i] ? depth_map[i] : -1;
  }
  void set_cu(int x0, int y0, int size, int mode, int depth) {
    int s4 = size >> 2;
    for (int yy = y0 >> 2; yy < (y0 >> 2) + s4; yy++)
      for (int xx = x0 >> 2; xx < (x0 >> 2) + s4; xx++) {
        size_t i = (size_t)yy * w4 + xx;
        mode_map[i] = (int16_t)mode;
        depth_map[i] = (int8_t)depth;
        coded_map[i] = 1;
      }
  }
  int log2(int v) const { return 31 - __builtin_clz((unsigned)v); }
};

// 6-entry MPM list — exact port of cu_syntax.mpm_list
void mpm_list6(int left, int above, int* out) {
  auto adj = [](int m, int d) {
    int r = (m - 2 + d) % 65;
    return 2 + (r < 0 ? r + 65 : r);
  };
  int l = left >= 0 ? left : PLANAR;
  int a = above >= 0 ? above : PLANAR;
  int lst[5];
  if (l == a) {
    if (l > DC) {
      lst[0] = l; lst[1] = adj(l, -1); lst[2] = adj(l, 1);
      lst[3] = adj(l, -2); lst[4] = adj(l, 2);
    } else {
      lst[0] = DC; lst[1] = VER; lst[2] = HOR;
      lst[3] = VER - 4; lst[4] = VER + 4;
    }
  } else if (l > DC && a > DC) {
    lst[0] = l; lst[1] = a;
    int mx = l > a ? l : a, mn = l < a ? l : a;
    if (mx - mn == 1) {
      lst[2] = adj(mn, -1); lst[3] = adj(mx, 1); lst[4] = adj(mn, -2);
    } else if (mx - mn >= 62) {
      lst[2] = adj(mn, 1); lst[3] = adj(mx, -1); lst[4] = adj(mn, 2);
    } else if (mx - mn == 2) {
      lst[2] = adj(mn, 1); lst[3] = adj(mn, -1); lst[4] = adj(mx, 1);
    } else {
      lst[2] = adj(mn, -1); lst[3] = adj(mn, 1); lst[4] = adj(mx, -1);
    }
  } else if (l > DC || a > DC) {
    int m = l > a ? l : a;
    lst[0] = m; lst[1] = adj(m, -1); lst[2] = adj(m, 1);
    lst[3] = adj(m, -2); lst[4] = adj(m, 2);
  } else {
    lst[0] = DC; lst[1] = VER; lst[2] = HOR;
    lst[3] = VER - 4; lst[4] = VER + 4;
  }
  out[0] = PLANAR;
  for (int i = 0; i < 5; i++) out[i + 1] = lst[i];
}

void tb_write(Enc& e, int x, int n) {   // truncated binary (spec 9.3.3.7)
  int k = 31 - __builtin_clz((unsigned)n);
  int u = (1 << (k + 1)) - n;
  if (x < u) {
    if (k) e.eps((unsigned)x, k);
  } else {
    e.eps((unsigned)(x + u), k + 1);
  }
}

struct TwArgs {
  CtxArray ctx;
  const int32_t* setoff;          // [T_NSETS]
  const int32_t* res_off;         // residual sets (RESIDUAL_SET_ORDER)
  const uint8_t* size_map;        // [h/min][sm_stride] leaf size log2
  int sm_stride;                  // full-frame width / min_cu
  const int32_t* leafs;           // [n][L_NREC], traversal order
  const int32_t* levels;          // concatenated level buffers
  const int32_t* sao;             // [n_ctus][21] or nullptr
  int sao_stride;                 // CTUs per frame row
  int tile_x0;                    // SAO merge-left availability bound
  int64_t cursor;
  int tid(int set, int i) const { return setoff[set] + i; }
};

void tw_sao(Enc& e, TwArgs& a, int cx, int cy, int ctu) {
  int ci = (cy / ctu) * a.sao_stride + (cx / ctu);
  const int32_t* p = a.sao + (size_t)ci * 21;
  const int32_t* lft = cx - ctu >= a.tile_x0
                           ? a.sao + (size_t)(ci - 1) * 21 : nullptr;
  const int32_t* up = cy >= ctu
                          ? a.sao + (size_t)(ci - a.sao_stride) * 21 : nullptr;
  if (lft) {
    bool eq = std::memcmp(p, lft, 21 * sizeof(int32_t)) == 0;
    e.bin(a.ctx, a.tid(T_SAO_MERGE, 0), eq);
    if (eq) return;
  }
  if (up) {
    bool eq = std::memcmp(p, up, 21 * sizeof(int32_t)) == 0;
    e.bin(a.ctx, a.tid(T_SAO_MERGE, 0), eq);
    if (eq) return;
  }
  for (int c = 0; c < 3; c++) {
    const int32_t* q = p + c * 7;  // mode, eo_class, band_pos, off[4]
    int mode = q[0];
    if (mode == 0) {
      e.bin(a.ctx, a.tid(T_SAO_TYPE, 0), 0);
      continue;
    }
    e.bin(a.ctx, a.tid(T_SAO_TYPE, 0), 1);
    e.ep(mode == 2 ? 1 : 0);
    for (int k = 0; k < 4; k++) {
      int m = q[3 + k] < 0 ? -q[3 + k] : q[3 + k];
      for (int i = 0; i < m; i++) e.ep(1);
      if (m < MAX_SAO_OFF) e.ep(0);
    }
    if (mode == 1) {  // BO
      for (int k = 0; k < 4; k++)
        if (q[3 + k] != 0) e.ep(q[3 + k] < 0 ? 1 : 0);
      e.eps((unsigned)q[2], 5);
    } else {
      e.eps((unsigned)q[1], 2);
    }
  }
}

void tw_cu(Enc& e, TreeCtx& t, TwArgs& a, const int32_t* rec) {
  int x0 = rec[L_X0], y0 = rec[L_Y0], size = rec[L_SIZE];
  int mode = rec[L_MODE];
  bool is_mip = mode >= 67;
  bool mip_ok = t.mip && size >= 8 && size <= 32;
  if (mip_ok) {
    e.bin(a.ctx, a.tid(T_MIP_FLAG, 0), is_mip);
    if (is_mip) tb_write(e, mode - 67, K_MIP_MODES);
  }
  if (!is_mip) {
    if ((y0 % t.ctu) > 0) e.bin(a.ctx, a.tid(T_REF_IDX, 0), 0);
    int left = t.mode_at(x0 - 1, y0 + size - 1);
    int above = (y0 % t.ctu) == 0 ? -1 : t.mode_at(x0 + size - 1, y0 - 1);
    int mpm[6];
    mpm_list6(left, above, mpm);
    int idx = -1;
    for (int i = 0; i < 6; i++)
      if (mpm[i] == mode) { idx = i; break; }
    if (idx >= 0) {
      e.bin(a.ctx, a.tid(T_MPM_FLAG, 0), 1);
      e.bin(a.ctx, a.tid(T_NOT_PLANAR, 0), idx != 0);
      if (idx > 0) {
        for (int i = 0; i < idx - 1; i++) e.ep(1);
        if (idx - 1 < 4) e.ep(0);
      }
    } else {
      e.bin(a.ctx, a.tid(T_MPM_FLAG, 0), 0);
      // rank of mode among non-MPM modes (sorted remainder)
      bool in_mpm[67] = {false};
      int n_mpm = 0;
      for (int i = 0; i < 6; i++)
        if (!in_mpm[mpm[i]]) { in_mpm[mpm[i]] = true; n_mpm++; }
      int rank = 0;
      for (int m = 0; m < mode; m++)
        if (!in_mpm[m]) rank++;
      tb_write(e, rank, 67 - n_mpm);
    }
  }
  int chroma = rec[L_CHROMA];
  if (t.cclm) {
    e.bin(a.ctx, a.tid(T_CCLM_FLAG, 0), chroma != 0);
    if (chroma != 0) {
      e.bin(a.ctx, a.tid(T_CCLM_MODE, 0), chroma == 1);
      if (chroma != 1) e.ep(chroma - 2);
    }
  }
  if (!(t.cclm && chroma)) e.bin(a.ctx, a.tid(T_CHROMA_PRED, 0), 1);
  // residuals: cbf cb, cr, luma; then mts/lfnst idx; then level arrays
  int cbf_cb = rec[L_OFF_CB] >= 0, cbf_cr = rec[L_OFF_CR] >= 0;
  int cbf_y = rec[L_OFF_Y] >= 0;
  e.bin(a.ctx, a.tid(T_CBF_CB, 0), cbf_cb);
  e.bin(a.ctx, a.tid(T_CBF_CR, cbf_cb), cbf_cr);
  e.bin(a.ctx, a.tid(T_CBF_LUMA, 0), cbf_y);
  int mts = rec[L_MTS], lfn = rec[L_LFNST];
  if (t.mts && cbf_y && size >= 8 && size <= 32) {
    for (int i = 0; i < mts; i++) e.bin(a.ctx, a.tid(T_MTS_IDX, i), 1);
    if (mts < 4) e.bin(a.ctx, a.tid(T_MTS_IDX, mts), 0);
  }
  if (t.lfnst && cbf_y && mts == 0 && size >= 8) {
    e.bin(a.ctx, a.tid(T_LFNST_IDX, 0), lfn != 0);
    if (lfn) e.bin(a.ctx, a.tid(T_LFNST_IDX, 1), lfn - 1);
  }
  ResCtx rc{a.ctx, a.res_off};
  int cs = size >> 1;
  if (cbf_cb) enc_residual(e, rc, a.levels + rec[L_OFF_CB], cs, cs, 0);
  if (cbf_cr) enc_residual(e, rc, a.levels + rec[L_OFF_CR], cs, cs, 0);
  if (cbf_y) enc_residual(e, rc, a.levels + rec[L_OFF_Y], size, size, 1);
  int d = 2 * (t.log2(t.ctu) - t.log2(size));  // node_depth (QT adds 2)
  t.set_cu(x0, y0, size, is_mip ? PLANAR : mode, d);
}

// ------------------------------------------------------- native tree READER
//
// Full-tool-set CU syntax parser (decoder side): the per-bin Python ↔
// ctypes loop of vvc/cabac/cu_syntax.py:TreeReader was the decode wall
// (VERDICT r4 #2: 1.2 fps vs the reference decoders' 30–60).  Parsing in
// VVC is deliberately decoupled from motion derivation (OpenVVC's
// vcl_*.c / drv_*.c split, SURVEY §2.6) — this parser emits flat int32
// leaf records + a level buffer; Python derives merge/AMVP lists from
// the records afterwards.  Bit-exact mirror of TreeReader (non-lossless
// paths; lossless/BDPCM streams fall back to Python).

constexpr int TR_NREC = 56;
enum TrRec {
  R_X0, R_Y0, R_W, R_H, R_KIND, R_SKIP, R_MERGE, R_MERGE_IDX,
  R_MMVD, R_MMVD_CI, R_MMVD_DI, R_MMVD_GI,
  R_GPM, R_GPM_GM, R_GPM_I0, R_GPM_I1, R_CIIP,
  R_DIR, R_AFFINE, R_SMVD, R_IMV, R_BCW,
  R_REF0, R_REF1, R_MVP0, R_MVP1,
  R_MVD0X, R_MVD0Y, R_MVD1X, R_MVD1Y,
  R_CP0 = 30,            // 30..41: cpmvd [list][cp][xy]
  R_MODE = 42, R_MIP, R_MRL, R_ISP, R_CHROMA, R_MTS, R_LFNST, R_BDPCM,
  R_CBF_Y = 50, R_CBF_CB, R_CBF_CR, R_OFF_Y, R_OFF_CB, R_OFF_CR,
};

// context-set order — keep in sync with native.py TR_SET_ORDER
enum TrSet {
  S_SPLIT, S_SPLIT_QT, S_MTT_VERT, S_MTT_BIN,
  S_SAO_TYPE, S_SAO_MERGE,
  S_SKIP, S_PRED_MODE, S_MERGE_FLAG, S_MERGE_IDX,
  S_GPM_FLAG, S_GPM_IDX, S_MMVD_FLAG, S_MMVD_CAND, S_MMVD_DIST,
  S_CIIP, S_AFFINE_FLAG, S_AFFINE_TYPE, S_INTER_DIR, S_REF_IDX,
  S_MVP, S_MVD, S_IMV, S_SMVD, S_BCW, S_ROOT_CBF,
  S_MIP, S_MRL, S_ISP, S_MPM_FLAG, S_NOT_PLANAR,
  S_CCLM_FLAG, S_CCLM_MODE, S_CHROMA_DM,
  S_CBF_LUMA, S_MTS_IDX, S_LFNST_IDX, S_CBF_CB, S_CBF_CR,
  S_NSETS
};

int tb_read(Dec& d, int n) {
  int k = 31 - __builtin_clz((unsigned)n);
  int u = (1 << (k + 1)) - n;
  int v = k ? (int)d.eps(k) : 0;
  if (v >= u) {
    v = (v << 1) | d.ep();
    v -= u;
  }
  return v;
}

int eg_read(Dec& d, int k) {
  int v = 0;
  while (d.ep()) {
    v += 1 << k;
    k++;
  }
  if (k) v += (int)d.eps(k);
  return v;
}

// tool-flag bits for tr_create (keep in sync with native.py)
enum TrFlag {
  F_MTS = 1, F_CCLM = 2, F_MIP = 4, F_LFNST = 8, F_ISP = 16, F_MTT = 32,
  F_AFFINE = 64, F_MMVD = 128, F_CIIP = 256, F_GPM = 512, F_AMVR = 1024,
  F_SMVD = 2048, F_BCW = 4096, F_HAS_SMVD_REFS = 8192,
};

struct TrCtx {
  int w, h, ctu, min_cu;
  int flags;
  int slice_type;                 // 0=B 1=P 2=I
  int n_ref0, n_ref1, max_merge;
  int w4, h4;
  std::vector<int16_t> mode_map;  // intra mode (inter/uncoded → planar/-1)
  std::vector<int8_t> depth_map;
  std::vector<uint8_t> coded_map;
  std::vector<uint8_t> skip_map;
  std::vector<uint8_t> intra_map;  // coded && !inter (for pred_mode ctx)

  TrCtx(int w_, int h_, int ctu_, int mc, int flags_, int st, int nr0,
        int nr1, int mm)
      : w(w_), h(h_), ctu(ctu_), min_cu(mc), flags(flags_), slice_type(st),
        n_ref0(nr0), n_ref1(nr1), max_merge(mm),
        w4((w_ + 3) >> 2), h4((h_ + 3) >> 2),
        mode_map((size_t)w4 * h4, -1), depth_map((size_t)w4 * h4, 0),
        coded_map((size_t)w4 * h4, 0), skip_map((size_t)w4 * h4, 0),
        intra_map((size_t)w4 * h4, 0) {}

  bool f(int bit) const { return (flags & bit) != 0; }
  bool inter_slice() const { return slice_type != 2; }
  bool is_b() const { return slice_type == 0; }
  int log2(int v) const { return 31 - __builtin_clz((unsigned)v); }

  bool in4(int x, int y) const {
    return x >= 0 && y >= 0 && (x >> 2) < w4 && (y >> 2) < h4;
  }
  size_t i4(int x, int y) const {
    return (size_t)(y >> 2) * w4 + (x >> 2);
  }
  int mode_at(int x, int y) const {
    if (!in4(x, y)) return -1;
    size_t i = i4(x, y);
    return coded_map[i] ? mode_map[i] : -1;
  }
  int depth_at(int x, int y) const {
    if (!in4(x, y)) return -1;
    size_t i = i4(x, y);
    return coded_map[i] ? depth_map[i] : -1;
  }
  void set_cu(int x0, int y0, int bw, int bh, int mode, int depth,
              int skip, int is_intra) {
    for (int yy = y0 >> 2; yy < ((y0 + bh) >> 2) && yy < h4; yy++)
      for (int xx = x0 >> 2; xx < ((x0 + bw) >> 2) && xx < w4; xx++) {
        size_t i = (size_t)yy * w4 + xx;
        mode_map[i] = (int16_t)mode;
        depth_map[i] = (int8_t)depth;
        coded_map[i] = 1;
        skip_map[i] = (uint8_t)skip;
        intra_map[i] = (uint8_t)is_intra;
      }
  }
  int skip_ctx(int x0, int y0) const {
    int c = 0;
    if (in4(x0 - 1, y0) && skip_map[i4(x0 - 1, y0)]) c++;
    if (in4(x0, y0 - 1) && skip_map[i4(x0, y0 - 1)]) c++;
    return c;
  }
  int pred_mode_ctx(int x0, int y0) const {
    if (in4(x0 - 1, y0) && intra_map[i4(x0 - 1, y0)]) return 1;
    if (in4(x0, y0 - 1) && intra_map[i4(x0, y0 - 1)]) return 1;
    return 0;
  }
};

struct TrArgs {
  CtxArray ctx;
  const int32_t* setoff;          // [S_NSETS]
  const int32_t* res_off;
  int32_t* recs;                  // [cap][TR_NREC]
  int64_t rec_cap;
  int32_t* levels;
  int64_t lev_cap;
  int32_t* sao;                   // [n_ctus][21] or nullptr
  int sao_stride;
  int tile_x0;
  int tile_y0;
  int64_t n_rec = 0;
  int64_t lev_cursor = 0;
  bool overflow = false;
  int tid(int set, int i) const { return setoff[set] + i; }
};

// partition legality — exact port of vvc/model/partition.py
constexpr int P_MIN_QT_LEAF = 8, P_MIN_SIDE = 8, P_MAX_BT = 64,
              P_MAX_TT = 32, P_MAX_AR_LOG2 = 2;

bool shape_ok(int w, int h) {
  int lw = 31 - __builtin_clz((unsigned)w);
  int lh = 31 - __builtin_clz((unsigned)h);
  int d = lw > lh ? lw - lh : lh - lw;
  return (w < h ? w : h) >= P_MIN_SIDE && d <= P_MAX_AR_LOG2;
}

void allowed_splits_c(int w, int h, bool qt_allowed, bool mtt, bool* out) {
  out[0] = qt_allowed && w == h && w > P_MIN_QT_LEAF;
  if (!mtt) {
    out[1] = out[2] = out[3] = out[4] = false;
    return;
  }
  out[1] = h >= 2 * P_MIN_SIDE && h <= P_MAX_BT && w <= P_MAX_BT &&
           shape_ok(w, h >> 1);
  out[2] = w >= 2 * P_MIN_SIDE && w <= P_MAX_BT && h <= P_MAX_BT &&
           shape_ok(w >> 1, h);
  out[3] = h >= 4 * P_MIN_SIDE && h <= P_MAX_TT && w <= P_MAX_TT &&
           shape_ok(w, h >> 2);
  out[4] = w >= 4 * P_MIN_SIDE && w <= P_MAX_TT && h <= P_MAX_TT &&
           shape_ok(w >> 2, h);
}

int32_t* tr_alloc_rec(TrArgs& a, int x0, int y0, int w, int h) {
  if (a.n_rec >= a.rec_cap) {
    a.overflow = true;
    return nullptr;
  }
  int32_t* r = a.recs + a.n_rec * TR_NREC;
  a.n_rec++;
  for (int i = 0; i < TR_NREC; i++) r[i] = 0;
  r[R_X0] = x0; r[R_Y0] = y0; r[R_W] = w; r[R_H] = h;
  r[R_OFF_Y] = r[R_OFF_CB] = r[R_OFF_CR] = -1;
  r[R_BCW] = 2;
  return r;
}

int32_t* tr_lev(TrArgs& a, int n) {
  if (a.lev_cursor + n > a.lev_cap) {
    a.overflow = true;
    return nullptr;
  }
  int32_t* p = a.levels + a.lev_cursor;
  a.lev_cursor += n;
  return p;
}

void tr_residuals(Dec& d, TrCtx& t, TrArgs& a, int32_t* r, int pred) {
  int w = r[R_W], h = r[R_H];
  int cbf_cb = d.bin(a.ctx, a.tid(S_CBF_CB, 0));
  int cbf_cr = d.bin(a.ctx, a.tid(S_CBF_CR, cbf_cb));
  r[R_CBF_CB] = cbf_cb;
  r[R_CBF_CR] = cbf_cr;
  ResCtx rc{a.ctx, a.res_off};
  int cw = w >> 1, ch = h >> 1;
  if (r[R_ISP]) {
    if (cbf_cb) {
      int32_t* p = tr_lev(a, cw * ch);
      if (!p) return;
      r[R_OFF_CB] = (int32_t)(p - a.levels);
      dec_residual(d, rc, p, cw, ch, 0);
    }
    if (cbf_cr) {
      int32_t* p = tr_lev(a, cw * ch);
      if (!p) return;
      r[R_OFF_CR] = (int32_t)(p - a.levels);
      dec_residual(d, rc, p, cw, ch, 0);
    }
    // sub-TU luma: assemble into one w×h block
    int32_t* p = tr_lev(a, w * h);
    if (!p) return;
    std::memset(p, 0, (size_t)w * h * sizeof(int32_t));
    bool any = false;
    int prev = 0;
    int k, sw, sh;
    if (r[R_ISP] == 1) {               // ISP_HOR
      k = h >= 16 ? 4 : 2; sw = w; sh = h / k;
    } else {                           // ISP_VER
      k = w >= 16 ? 4 : 2; sw = w / k; sh = h;
    }
    std::vector<int32_t> sub((size_t)sw * sh);
    for (int i = 0; i < k; i++) {
      int xo = r[R_ISP] == 2 ? i * sw : 0;
      int yo = r[R_ISP] == 1 ? i * sh : 0;
      int sub_cbf = d.bin(a.ctx, a.tid(S_CBF_LUMA, 2 + prev));
      if (sub_cbf) {
        dec_residual(d, rc, sub.data(), sw, sh, 1);
        for (int yy = 0; yy < sh; yy++)
          std::memcpy(p + (size_t)(yo + yy) * w + xo,
                      sub.data() + (size_t)yy * sw,
                      (size_t)sw * sizeof(int32_t));
        any = true;
      }
      prev = sub_cbf;
    }
    if (any) {
      r[R_OFF_Y] = (int32_t)(p - a.levels);
      r[R_CBF_Y] = 1;
    } else {
      a.lev_cursor -= (int64_t)w * h;  // roll back unused buffer
    }
    return;
  }
  int cbf_y = d.bin(a.ctx, a.tid(S_CBF_LUMA, 0));
  r[R_CBF_Y] = cbf_y;
  int mts = 0, lfn = 0;
  bool mts_sig = t.f(F_MTS) && cbf_y && w >= 8 && w <= 32 && h >= 8 &&
                 h <= 32 && pred == 0;
  if (mts_sig)
    while (mts < 4 && d.bin(a.ctx, a.tid(S_MTS_IDX, mts))) mts++;
  bool lfn_sig = t.f(F_LFNST) && cbf_y && mts == 0 && pred == 0 &&
                 w == h && w >= 8;
  if (lfn_sig && d.bin(a.ctx, a.tid(S_LFNST_IDX, 0)))
    lfn = 1 + d.bin(a.ctx, a.tid(S_LFNST_IDX, 1));
  r[R_MTS] = mts;
  r[R_LFNST] = lfn;
  if (cbf_cb) {
    int32_t* p = tr_lev(a, cw * ch);
    if (!p) return;
    r[R_OFF_CB] = (int32_t)(p - a.levels);
    dec_residual(d, rc, p, cw, ch, 0);
  }
  if (cbf_cr) {
    int32_t* p = tr_lev(a, cw * ch);
    if (!p) return;
    r[R_OFF_CR] = (int32_t)(p - a.levels);
    dec_residual(d, rc, p, cw, ch, 0);
  }
  if (cbf_y) {
    int32_t* p = tr_lev(a, w * h);
    if (!p) return;
    r[R_OFF_Y] = (int32_t)(p - a.levels);
    dec_residual(d, rc, p, w, h, 1);
  }
}

int tr_read_merge_idx(Dec& d, TrCtx& t, TrArgs& a) {
  if (t.max_merge <= 1) return 0;
  if (!d.bin(a.ctx, a.tid(S_MERGE_IDX, 0))) return 0;
  int idx = 1;
  while (idx < t.max_merge - 1 && d.ep()) idx++;
  return idx;
}

int tr_read_gpm_idx(Dec& d, TrArgs& a, int n) {
  if (n <= 1) return 0;
  if (!d.bin(a.ctx, a.tid(S_GPM_IDX, 0))) return 0;
  int idx = 1;
  while (idx < n - 1 && d.ep()) idx++;
  return idx;
}

int tr_read_ref_idx(Dec& d, TrCtx& t, TrArgs& a, int lst) {
  int n = lst == 0 ? t.n_ref0 : t.n_ref1;
  if (n <= 1) return 0;
  if (!d.bin(a.ctx, a.tid(S_REF_IDX, 0))) return 0;
  if (n == 2 || !d.bin(a.ctx, a.tid(S_REF_IDX, 1))) return 1;
  int ridx = 2;
  while (ridx < n - 1 && d.ep()) ridx++;
  return ridx;
}

void tr_read_mvd(Dec& d, TrArgs& a, int* out) {
  int gt0[2], gt1[2];
  for (int i = 0; i < 2; i++) gt0[i] = d.bin(a.ctx, a.tid(S_MVD, 0));
  for (int i = 0; i < 2; i++)
    gt1[i] = gt0[i] ? d.bin(a.ctx, a.tid(S_MVD, 1)) : 0;
  for (int i = 0; i < 2; i++) {
    if (!gt0[i]) {
      out[i] = 0;
      continue;
    }
    int v = gt1[i] ? (eg_read(d, 1) + 2) : 1;
    out[i] = d.ep() ? -v : v;
  }
}

void tr_cu_intra(Dec& d, TrCtx& t, TrArgs& a, int x0, int y0, int w, int h) {
  int32_t* r = tr_alloc_rec(a, x0, y0, w, h);
  if (!r) return;
  int mode;
  int is_mip = 0, mrl = 0, isp = 0;
  if (t.f(F_MIP) && w == h && w >= 8 && w <= 32)
    is_mip = d.bin(a.ctx, a.tid(S_MIP, 0));
  if (is_mip) {
    mode = 67 + tb_read(d, K_MIP_MODES);
  } else {
    if ((y0 % t.ctu) > 0 && d.bin(a.ctx, a.tid(S_MRL, 0)))
      mrl = 1 + d.bin(a.ctx, a.tid(S_MRL, 1));
    if (t.f(F_ISP) && mrl == 0 && w <= 64 && h <= 64) {
      bool can_h = h >= 8, can_v = w >= 8;
      if ((can_h || can_v) && d.bin(a.ctx, a.tid(S_ISP, 0))) {
        if (can_h && can_v)
          isp = 1 + d.bin(a.ctx, a.tid(S_ISP, 1));
        else
          isp = can_h ? 1 : 2;
      }
    }
    int left = t.mode_at(x0 - 1, y0 + h - 1);
    int above = (y0 % t.ctu) == 0 ? -1 : t.mode_at(x0 + w - 1, y0 - 1);
    int mpm[6];
    mpm_list6(left, above, mpm);
    if (d.bin(a.ctx, a.tid(S_MPM_FLAG, 0))) {
      if (d.bin(a.ctx, a.tid(S_NOT_PLANAR, 0))) {
        int idx = 1;
        while (idx - 1 < 4 && d.ep()) idx++;
        mode = mpm[idx];
      } else {
        mode = mpm[0];
      }
    } else {
      bool in_mpm[67] = {false};
      int n_mpm = 0;
      for (int i = 0; i < 6; i++)
        if (!in_mpm[mpm[i]]) { in_mpm[mpm[i]] = true; n_mpm++; }
      int rank = tb_read(d, 67 - n_mpm);
      mode = 0;
      for (int m = 0; m < 67; m++) {
        if (in_mpm[m]) continue;
        if (rank == 0) { mode = m; break; }
        rank--;
      }
    }
  }
  int chroma = 0;
  if (t.f(F_CCLM) && w == h) {
    if (d.bin(a.ctx, a.tid(S_CCLM_FLAG, 0))) {
      if (d.bin(a.ctx, a.tid(S_CCLM_MODE, 0)))
        chroma = 1;
      else
        chroma = 2 + d.ep();
    }
  }
  if (!chroma) d.bin(a.ctx, a.tid(S_CHROMA_DM, 0));  // DM (must be 1)
  r[R_KIND] = 0;
  r[R_MODE] = mode;
  r[R_MIP] = is_mip;
  r[R_MRL] = is_mip ? 0 : mrl;
  r[R_ISP] = isp;
  r[R_CHROMA] = chroma;
  tr_residuals(d, t, a, r, 0);
  int dep = 2 * t.log2(t.ctu) - t.log2(w) - t.log2(h);
  t.set_cu(x0, y0, w, h, is_mip ? PLANAR : mode, dep, 0, 1);
}

void tr_cu(Dec& d, TrCtx& t, TrArgs& a, int x0, int y0, int w, int h) {
  if (!t.inter_slice() || w != h) {
    // rect leaves are intra-only (MTT gated to intra slices)
    tr_cu_intra(d, t, a, x0, y0, w, h);
    return;
  }
  int size = w;
  int dep = 2 * t.log2(t.ctu) - 2 * t.log2(size);
  int skip = d.bin(a.ctx, a.tid(S_SKIP, t.skip_ctx(x0, y0)));
  if (skip) {
    int32_t* r = tr_alloc_rec(a, x0, y0, w, h);
    if (!r) return;
    r[R_KIND] = 1;
    r[R_SKIP] = 1;
    r[R_MERGE] = 1;
    r[R_MERGE_IDX] = tr_read_merge_idx(d, t, a);
    r[R_DIR] = 1;  // derived later from the candidate
    t.set_cu(x0, y0, w, h, PLANAR, dep, 1, 0);
    return;
  }
  int intra = d.bin(a.ctx, a.tid(S_PRED_MODE, t.pred_mode_ctx(x0, y0)));
  if (intra) {
    tr_cu_intra(d, t, a, x0, y0, w, h);
    return;
  }
  int32_t* r = tr_alloc_rec(a, x0, y0, w, h);
  if (!r) return;
  r[R_KIND] = 1;
  int merge = d.bin(a.ctx, a.tid(S_MERGE_FLAG, 0));
  if (merge) {
    r[R_MERGE] = 1;
    bool gpm_sig = t.f(F_GPM) && t.is_b() && size >= 8 && size <= 64 &&
                   t.max_merge >= 2;
    int is_gpm = gpm_sig ? d.bin(a.ctx, a.tid(S_GPM_FLAG, 0)) : 0;
    if (is_gpm) {
      r[R_GPM] = 1;
      r[R_GPM_GM] = (int32_t)d.eps(6);
      int i0 = tr_read_gpm_idx(d, a, t.max_merge);
      int j1 = tr_read_gpm_idx(d, a, t.max_merge - 1);
      r[R_GPM_I0] = i0;
      r[R_GPM_I1] = j1 + (j1 >= i0 ? 1 : 0);
      if (d.bin(a.ctx, a.tid(S_ROOT_CBF, 0))) tr_residuals(d, t, a, r, 1);
      t.set_cu(x0, y0, w, h, PLANAR, dep, 0, 0);
      return;
    }
    int is_mmvd = t.f(F_MMVD) ? d.bin(a.ctx, a.tid(S_MMVD_FLAG, 0)) : 0;
    if (is_mmvd) {
      r[R_MMVD] = 1;
      r[R_MMVD_CI] = d.bin(a.ctx, a.tid(S_MMVD_CAND, 0));
      int di = 0;
      if (d.bin(a.ctx, a.tid(S_MMVD_DIST, 0))) {
        di = 1;
        while (di < 7 && d.ep()) di++;
      }
      r[R_MMVD_DI] = di;
      r[R_MMVD_GI] = (int32_t)d.eps(2);
    } else {
      r[R_MERGE_IDX] = tr_read_merge_idx(d, t, a);
      bool ciip_sig = t.f(F_CIIP) && size * size >= 64 && size < 128;
      if (ciip_sig) r[R_CIIP] = d.bin(a.ctx, a.tid(S_CIIP, 0));
    }
  } else {
    int affine = 0;
    if (t.f(F_AFFINE) && size >= 16 && d.bin(a.ctx, a.tid(S_AFFINE_FLAG, 0)))
      affine = d.bin(a.ctx, a.tid(S_AFFINE_TYPE, 0)) ? 6 : 4;
    r[R_AFFINE] = affine;
    int dir = 1;
    if (t.is_b()) {
      int lg = t.log2(size);
      int c = lg + 1 - 4;           // size.bit_length()-4 = log2+1-4
      if (c > 4) c = 4;
      if (d.bin(a.ctx, a.tid(S_INTER_DIR, c)))
        dir = 3;
      else if (d.bin(a.ctx, a.tid(S_INTER_DIR, 5)))
        dir = 2;
    }
    r[R_DIR] = dir;
    if (affine) {
      int ncp = affine == 4 ? 2 : 3;
      for (int l = 0; l < 2; l++) {
        if (!((dir >> l) & 1)) continue;
        r[l == 0 ? R_REF0 : R_REF1] = tr_read_ref_idx(d, t, a, l);
        for (int cp = 0; cp < ncp; cp++) {
          int mvd[2];
          tr_read_mvd(d, a, mvd);
          r[R_CP0 + l * 6 + cp * 2] = mvd[0];
          r[R_CP0 + l * 6 + cp * 2 + 1] = mvd[1];
        }
        r[l == 0 ? R_MVP0 : R_MVP1] = d.bin(a.ctx, a.tid(S_MVP, 0));
      }
    } else {
      int smvd = 0;
      if (t.f(F_SMVD) && dir == 3 && t.f(F_HAS_SMVD_REFS))
        smvd = d.bin(a.ctx, a.tid(S_SMVD, 0));
      r[R_SMVD] = smvd;
      bool any_mvd = false;
      for (int l = 0; l < 2; l++) {
        if (!((dir >> l) & 1)) continue;
        if (smvd && l == 1) {
          r[l == 0 ? R_MVP0 : R_MVP1] = d.bin(a.ctx, a.tid(S_MVP, 0));
          continue;
        }
        if (!smvd) r[l == 0 ? R_REF0 : R_REF1] = tr_read_ref_idx(d, t, a, l);
        int mvd[2];
        tr_read_mvd(d, a, mvd);
        r[l == 0 ? R_MVD0X : R_MVD1X] = mvd[0];
        r[l == 0 ? R_MVD0Y : R_MVD1Y] = mvd[1];
        if (mvd[0] || mvd[1]) any_mvd = true;
        r[l == 0 ? R_MVP0 : R_MVP1] = d.bin(a.ctx, a.tid(S_MVP, 0));
      }
      int imv = 0;
      if (t.f(F_AMVR) && any_mvd && d.bin(a.ctx, a.tid(S_IMV, 0)))
        imv = 1 + d.bin(a.ctx, a.tid(S_IMV, 1));
      r[R_IMV] = imv;
      if (t.f(F_BCW) && dir == 3 && d.bin(a.ctx, a.tid(S_BCW, 0))) {
        static const int32_t kBcw[4] = {0, 1, 3, 4};
        r[R_BCW] = kBcw[d.eps(2)];
      }
    }
  }
  if (d.bin(a.ctx, a.tid(S_ROOT_CBF, 0))) tr_residuals(d, t, a, r, 1);
  t.set_cu(x0, y0, w, h, PLANAR, dep, 0, 0);
}

void tr_tree(Dec& d, TrCtx& t, TrArgs& a, int x0, int y0, int w, int h,
             bool qt_allowed) {
  if (x0 >= t.w || y0 >= t.h || a.overflow) return;
  bool inside = (x0 + w <= t.w) && (y0 + h <= t.h);
  if (!inside || w > 64 || h > 64) {
    int half = w >> 1;
    tr_tree(d, t, a, x0, y0, half, half, qt_allowed);
    tr_tree(d, t, a, x0 + half, y0, half, half, qt_allowed);
    tr_tree(d, t, a, x0, y0 + half, half, half, qt_allowed);
    tr_tree(d, t, a, x0 + half, y0 + half, half, half, qt_allowed);
    return;
  }
  bool can[5];
  allowed_splits_c(w, h, qt_allowed, t.f(F_MTT), can);
  bool any = can[0] || can[1] || can[2] || can[3] || can[4];
  int dep = 2 * t.log2(t.ctu) - t.log2(w) - t.log2(h);
  int c = (t.depth_at(x0 - 1, y0) > dep ? 1 : 0) +
          (t.depth_at(x0, y0 - 1) > dep ? 1 : 0);
  int split = any ? d.bin(a.ctx, a.tid(S_SPLIT, c)) : 0;
  if (!split) {
    tr_cu(d, t, a, x0, y0, w, h);
    return;
  }
  bool is_qt;
  if (can[0] && (can[1] || can[2] || can[3] || can[4]))
    is_qt = d.bin(a.ctx, a.tid(S_SPLIT_QT, w == t.ctu ? 1 : 0));
  else
    is_qt = can[0];
  if (is_qt) {
    int hw = w >> 1, hh = h >> 1;
    tr_tree(d, t, a, x0, y0, hw, hh, true);
    tr_tree(d, t, a, x0 + hw, y0, hw, hh, true);
    tr_tree(d, t, a, x0, y0 + hh, hw, hh, true);
    tr_tree(d, t, a, x0 + hw, y0 + hh, hw, hh, true);
    return;
  }
  bool can_hor = can[1] || can[3], can_ver = can[2] || can[4];
  bool vert;
  if (can_hor && can_ver)
    vert = d.bin(a.ctx, a.tid(S_MTT_VERT, w == h ? 0 : 1));
  else
    vert = can_ver;
  bool can_b = vert ? can[2] : can[1];
  bool can_t = vert ? can[4] : can[3];
  bool is_bt;
  if (can_b && can_t)
    is_bt = d.bin(a.ctx, a.tid(S_MTT_BIN, 0));
  else
    is_bt = can_b;
  if (is_bt) {
    if (vert) {
      int hw = w >> 1;
      tr_tree(d, t, a, x0, y0, hw, h, false);
      tr_tree(d, t, a, x0 + hw, y0, hw, h, false);
    } else {
      int hh = h >> 1;
      tr_tree(d, t, a, x0, y0, w, hh, false);
      tr_tree(d, t, a, x0, y0 + hh, w, hh, false);
    }
  } else {
    if (vert) {
      int q = w >> 2;
      tr_tree(d, t, a, x0, y0, q, h, false);
      tr_tree(d, t, a, x0 + q, y0, 2 * q, h, false);
      tr_tree(d, t, a, x0 + 3 * q, y0, q, h, false);
    } else {
      int q = h >> 2;
      tr_tree(d, t, a, x0, y0, w, q, false);
      tr_tree(d, t, a, x0, y0 + q, w, 2 * q, false);
      tr_tree(d, t, a, x0, y0 + 3 * q, w, q, false);
    }
  }
}

void tr_sao(Dec& d, TrCtx& t, TrArgs& a, int cx, int cy) {
  int ci = (cy / t.ctu) * a.sao_stride + (cx / t.ctu);
  int32_t* p = a.sao + (size_t)ci * 21;
  const int32_t* lft = cx - t.ctu >= a.tile_x0
                           ? a.sao + (size_t)(ci - 1) * 21 : nullptr;
  const int32_t* up = cy - t.ctu >= a.tile_y0
                          ? a.sao + (size_t)(ci - a.sao_stride) * 21
                          : nullptr;
  if (lft && d.bin(a.ctx, a.tid(S_SAO_MERGE, 0))) {
    std::memcpy(p, lft, 21 * sizeof(int32_t));
    return;
  }
  if (up && d.bin(a.ctx, a.tid(S_SAO_MERGE, 0))) {
    std::memcpy(p, up, 21 * sizeof(int32_t));
    return;
  }
  for (int comp = 0; comp < 3; comp++) {
    int32_t* q = p + comp * 7;
    if (!d.bin(a.ctx, a.tid(S_SAO_TYPE, 0))) {
      for (int i = 0; i < 7; i++) q[i] = 0;
      continue;
    }
    int mode = d.ep() ? 2 : 1;   // EO : BO
    q[0] = mode;
    int mags[4];
    for (int k = 0; k < 4; k++) {
      int m = 0;
      while (m < MAX_SAO_OFF && d.ep()) m++;
      mags[k] = m;
    }
    if (mode == 1) {  // BO
      for (int k = 0; k < 4; k++)
        q[3 + k] = (mags[k] != 0 && d.ep()) ? -mags[k] : mags[k];
      q[2] = (int32_t)d.eps(5);
      q[1] = 0;
    } else {          // EO: cats 1,2 positive; 3,4 negative
      q[3] = mags[0]; q[4] = mags[1]; q[5] = -mags[2]; q[6] = -mags[3];
      q[1] = (int32_t)d.eps(2);
      q[2] = 0;
    }
  }
}

void tw_tree(Enc& e, TreeCtx& t, TwArgs& a, int x0, int y0, int size) {
  if (x0 >= t.w || y0 >= t.h) return;
  bool inside = (x0 + size <= t.w) && (y0 + size <= t.h);
  bool split;
  if (!inside) {
    split = true;
  } else if (size <= t.min_cu) {
    split = false;
  } else {
    // leaf iff the size map records this exact size at this origin
    int lg = a.size_map[(size_t)(y0 / t.min_cu) * a.sm_stride
                        + (x0 / t.min_cu)];
    split = (1 << lg) != size;
    int d = 2 * (t.log2(t.ctu) - t.log2(size));  // node_depth (QT adds 2)
    int c = (t.depth_at(x0 - 1, y0) > d ? 1 : 0) +
            (t.depth_at(x0, y0 - 1) > d ? 1 : 0);
    e.bin(a.ctx, a.tid(T_SPLIT, c), split);
  }
  if (split) {
    int half = size >> 1;
    tw_tree(e, t, a, x0, y0, half);
    tw_tree(e, t, a, x0 + half, y0, half);
    tw_tree(e, t, a, x0, y0 + half, half);
    tw_tree(e, t, a, x0 + half, y0 + half, half);
  } else {
    tw_cu(e, t, a, a.leafs + a.cursor * L_NREC);
    a.cursor++;
  }
}

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

void* enc_create() { return new Enc(); }
void enc_destroy(void* e) { delete (Enc*)e; }
void enc_bin(void* e, int32_t* states, int idx, int bin) {
  CtxArray c{states};
  ((Enc*)e)->bin(c, idx, bin);
}
void enc_ep(void* e, int bin) { ((Enc*)e)->ep(bin); }
void enc_eps(void* e, uint32_t v, int n) { ((Enc*)e)->eps(v, n); }
void enc_trm(void* e, int bin) { ((Enc*)e)->trm(bin); }
void enc_residual_c(void* e, int32_t* states, const int32_t* offsets,
                    const int32_t* levels, int w, int h, int is_luma) {
  ResCtx rc{CtxArray{states}, offsets};
  enc_residual(*(Enc*)e, rc, levels, w, h, is_luma);
}
int64_t enc_finish(void* e, uint8_t* out, int64_t cap) {
  Enc* enc = (Enc*)e;
  enc->finish();
  int64_t n = (int64_t)enc->bytes.size();
  if (n > cap) return -n;
  std::memcpy(out, enc->bytes.data(), (size_t)n);
  return n;
}
int64_t enc_bit_count(void* e) { return ((Enc*)e)->nbits + 9; }

void* dec_create(const uint8_t* data, int64_t len) { return new Dec(data, len); }
void dec_destroy(void* d) { delete (Dec*)d; }
int dec_bin(void* d, int32_t* states, int idx) {
  CtxArray c{states};
  return ((Dec*)d)->bin(c, idx);
}
int dec_ep(void* d) { return ((Dec*)d)->ep(); }
uint32_t dec_eps(void* d, int n) { return ((Dec*)d)->eps(n); }
int dec_trm(void* d) { return ((Dec*)d)->trm(); }
void dec_residual_c(void* d, int32_t* states, const int32_t* offsets,
                    int32_t* levels, int w, int h, int is_luma) {
  ResCtx rc{CtxArray{states}, offsets};
  dec_residual(*(Dec*)d, rc, levels, w, h, is_luma);
}

void* tr_create(int w, int h, int ctu, int min_cu, int flags,
                int slice_type, int nr0, int nr1, int max_merge) {
  return new TrCtx(w, h, ctu, min_cu, flags, slice_type, nr0, nr1,
                   max_merge);
}
void tr_destroy(void* t) { delete (TrCtx*)t; }

// Reads the CTUs in [cx0,cx1) x [cy0,cy1).  Emits leaf records into
// recs (cap rec_cap) + level buffer (cap lev_cap); sao != null → per-CTU
// SAO params read first into sao[ci*21..].  snapshot_out != null copies
// the full ctx state after the FIRST CTU (WPP stagger).  Returns the
// number of leaf records, or -1 on buffer overflow; *lev_used gets the
// level-buffer cursor.
int64_t tr_read(void* tr, void* dec, int32_t* states,
                const int32_t* set_offsets, const int32_t* res_offsets,
                int cx0, int cx1, int cy0, int cy1,
                int32_t* recs, int64_t rec_cap,
                int32_t* levels, int64_t lev_cap,
                int32_t* sao, int sao_stride, int tile_x0, int tile_y0,
                int32_t* snapshot_out, int n_ctx, int64_t* lev_used) {
  TrCtx& t = *(TrCtx*)tr;
  Dec& d = *(Dec*)dec;
  TrArgs a{CtxArray{states}, set_offsets, res_offsets, recs, rec_cap,
           levels, lev_cap, sao, sao_stride, tile_x0, tile_y0};
  bool first = true;
  for (int cy = cy0; cy < cy1; cy += t.ctu)
    for (int cx = cx0; cx < cx1; cx += t.ctu) {
      if (sao) tr_sao(d, t, a, cx, cy);
      tr_tree(d, t, a, cx, cy, t.ctu, t.ctu, true);
      if (first && snapshot_out)
        std::memcpy(snapshot_out, states,
                    (size_t)n_ctx * 4 * sizeof(int32_t));
      first = false;
      if (a.overflow) return -1;
    }
  *lev_used = a.lev_cursor;
  return a.n_rec;
}

void* tw_create(int w, int h, int ctu, int min_cu, int flags) {
  return new TreeCtx(w, h, ctu, min_cu, flags);
}
void tw_destroy(void* t) { delete (TreeCtx*)t; }

// Writes the CTUs in [cx0,cx1) x [cy0,cy1) (luma sample bounds, CTU grid)
// into encoder e.  Returns leaves consumed.  snapshot_out != null copies
// the full context state after the FIRST CTU (WPP 1-CTU-stagger).
int64_t tw_write(void* tw, void* enc, int32_t* states,
                 const int32_t* set_offsets, const int32_t* res_offsets,
                 const uint8_t* size_map, int sm_stride, const int32_t* leafs,
                 const int32_t* levels, const int32_t* sao, int sao_stride,
                 int cx0, int cx1, int cy0, int cy1, int tile_x0,
                 int32_t* snapshot_out, int n_ctx) {
  TreeCtx& t = *(TreeCtx*)tw;
  Enc& e = *(Enc*)enc;
  TwArgs a{CtxArray{states}, set_offsets, res_offsets, size_map, sm_stride,
           leafs, levels, sao, sao_stride, tile_x0, 0};
  bool first = true;
  for (int cy = cy0; cy < cy1; cy += t.ctu)
    for (int cx = cx0; cx < cx1; cx += t.ctu) {
      if (sao) tw_sao(e, a, cx, cy, t.ctu);
      tw_tree(e, t, a, cx, cy, t.ctu);
      if (first && snapshot_out) {
        std::memcpy(snapshot_out, states, (size_t)n_ctx * 4 * sizeof(int32_t));
      }
      first = false;
    }
  return a.cursor;
}

}  // extern "C"
