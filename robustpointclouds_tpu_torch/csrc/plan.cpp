// Native sparse-plan builder: the C++ twin of models/voxelnet.sparse_plan_core.
//
// The host input pipeline feeds the TPU step a "sparse plan" (voxelization +
// every encoder neighbor/downsample index — see ops/sparse.py and
// nn/sparse_encoder.encoder_plan). The JAX/CPU builder expresses those as
// big sorts (XLA-CPU runs them single-threaded, ~1.4 s per KITTI B=6 batch
// on one core); this builder replaces them with stable sorts over per-sample
// point sets and two-pointer merges over already-sorted id streams, landing
// around 20x faster — fast enough that one prefetch thread hides the whole
// plan behind a ~250 ms device step even on a weak host.
//
// Exactness contract: outputs are BIT-equal to the JAX builder
// (tests/test_native_plan.py) — integer index machinery is replicated
// operation-for-operation (insertion-rank 'left' semantics, window position
// arithmetic with pure value-presence, candidate enumeration order and
// stable tie-breaks, truncation ranks, padding/sentinel patterns), and the
// only float arithmetic (voxel binning: floor((p - pcr)/vs)) uses the same
// IEEE f32 ops XLA emits.
//
// Layout contract (fixed to the SparseEncoder defaults, asserted Python-side):
//   grid0 --subm rel0(xwin)--> down1(k3 s2 pz1, xwin fwd) -> rel1(xwin)
//   -> down2(k3 s2 pz1, xwin fwd) -> rel2(dense) -> down3(k3 s2 pz0, dense)
//   -> rel3(dense) -> conv_out(k(3,1,1) s(2,1,1) p0, dense)
// with stage caps floor(n_cap * {1.0, 0.75, 0.5}) and out cap 0.5.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t I32_MAX = INT32_MAX;

struct Grid {
  // active sites sorted by flat4 id; n_real <= cap rows are real
  std::vector<int32_t> ids;      // [cap] flat4, padding = I32_MAX
  std::vector<int32_t> coords;   // [cap*4] (b,z,y,x), padding = -1
  int64_t cap = 0;
  int64_t n_real = 0;
  // dense spatial shape (B, D, H, W) and row-major strides
  int64_t B, D, H, W;
  int64_t sD, sH, sW, sB;  // strides: sB = D*H*W etc.
  void set_shape(int64_t b, int64_t d, int64_t h, int64_t w) {
    B = b; D = d; H = h; W = w;
    sW = 1; sH = w; sD = h * w; sB = d * h * w;
  }
};

// ---- submanifold x-window relation (neighbor_xwin_info, packed-sort path) --
// kernel (1,3,3,3), stride 1, padding (0,1,1,1): 9 (z,y) groups, kx=3.
void subm_xwin(const Grid& g, int32_t* rows /*[cap*9]*/, uint8_t* xvalid /*[cap*3]*/) {
  const int64_t n = g.cap;
  const int32_t miss = static_cast<int32_t>(n * 3);
  // deltas per (z,y) group of the group's base query: ids + delta
  int64_t deltas[9];
  int k = 0;
  for (int dz = 0; dz < 3; ++dz)
    for (int dy = 0; dy < 3; ++dy)
      deltas[k++] = (int64_t)(dz - 1) * g.sD + (int64_t)(dy - 1) * g.sH - 1;

  for (int gi = 0; gi < 9; ++gi) {
    const int64_t delta = deltas[gi];
    const int dz = gi / 3 - 1, dy = gi % 3 - 1;
    int64_t p = 0;  // rank pointer: queries ascend with i
    for (int64_t i = 0; i < g.n_real; ++i) {
      const int32_t* c = &g.coords[i * 4];
      const int64_t z = c[1] + dz, y = c[2] + dy;
      const bool valid = z >= 0 && z < g.D && y >= 0 && y < g.H;
      int32_t out = miss;
      if (valid) {
        const int64_t q = (int64_t)g.ids[i] + delta;
        while (p < g.n_real && g.ids[p] < q) ++p;
        if (p < g.n_real) {
          const int64_t d0 = (int64_t)g.ids[p] - q;
          if (d0 < 3) out = static_cast<int32_t>(p * 3 + d0);
        }
      } else {
        // ranks must keep advancing monotonically even for skipped queries?
        // No: each group's pointer only serves ITS queries, and those ascend
        // regardless of validity — invalid queries are simply not looked up.
      }
      rows[i * 9 + gi] = out;
    }
    for (int64_t i = g.n_real; i < n; ++i) rows[i * 9 + gi] = miss;
  }
  // x-bounds per tap: lx = (x - 1) + t in [0, W). Padding rows keep the
  // JAX pattern (coords = -1 -> lx = -2,-1,0 -> [F,F,T] when W > 0).
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = g.coords[i * 4 + 3];
    for (int t = 0; t < 3; ++t) {
      const int64_t lx = x - 1 + t;
      xvalid[i * 3 + t] = (lx >= 0 && lx < g.W) ? 1 : 0;
    }
  }
}

// ---- dense submanifold neighbor index (_neighbor_index_windowed) ----------
// kernel (1,3,3,3), stride 1, padding (0,1,1,1): [cap, 27] with the taps in
// kernel_offsets order (groups-major over (batch,z,y), dx-minor).
void subm_dense_idx(const Grid& g, int32_t* idx /*[cap*27]*/) {
  const int64_t n = g.cap;
  const int32_t miss = static_cast<int32_t>(n);
  int64_t deltas[9];
  int k = 0;
  for (int dz = 0; dz < 3; ++dz)
    for (int dy = 0; dy < 3; ++dy)
      deltas[k++] = (int64_t)(dz - 1) * g.sD + (int64_t)(dy - 1) * g.sH - 1;

  for (int64_t i = 0; i < n * 27; ++i) idx[i] = miss;

  for (int gi = 0; gi < 9; ++gi) {
    const int64_t delta = deltas[gi];
    const int dz = gi / 3 - 1, dy = gi % 3 - 1;
    int64_t p = 0;
    for (int64_t i = 0; i < g.n_real; ++i) {
      const int32_t* c = &g.coords[i * 4];
      const int64_t z = c[1] + dz, y = c[2] + dy;
      if (!(z >= 0 && z < g.D && y >= 0 && y < g.H)) continue;  // all 3 taps miss
      const int64_t q0 = (int64_t)g.ids[i] + delta;
      while (p < g.n_real && g.ids[p] < q0) ++p;
      // window walk: present by pure id-value match within ids[p..p+2];
      // pos accumulates presence, per-tap hit additionally needs x bounds
      const int64_t x0 = c[3] - 1;
      int64_t pos = p;
      bool prev_present = false;
      for (int dx = 0; dx < 3; ++dx) {
        const int64_t target = q0 + dx;
        if (dx > 0) pos += prev_present ? 1 : 0;
        bool present = false;
        for (int r = 0; r < 3; ++r) {
          const int64_t pr = p + r;
          if (pr < g.n_real && g.ids[pr] == target) { present = true; break; }
        }
        const int64_t lx = x0 + dx;
        if (present && lx >= 0 && lx < g.W) {
          idx[i * 27 + gi * 3 + dx] =
              static_cast<int32_t>(std::min<int64_t>(pos, n - 1));
        }
        prev_present = present;
      }
    }
  }
}

// ---- strided downsample: sites + inverse + forward index ------------------
// (downsample_with_index semantics, incl. candidate enumeration order and
// stable tie-breaks by (combo, input-row)).
struct DownResult {
  Grid out;
  std::vector<int32_t> inv;  // [in_cap * K] output row per (input, tap), miss = out_cap
  std::vector<int32_t> idx;  // [out_cap * K] input row per (output, tap), miss = in_cap
};

void downsample(const Grid& g, const int kernel[4], const int stride[4],
                const int pad[4], int64_t out_cap, DownResult* res) {
  int64_t K = 1;
  for (int a = 0; a < 4; ++a) K *= kernel[a];
  // kernel-tap flattening strides, row-major over kernel dims
  int64_t kstr[4];
  kstr[3] = 1;
  for (int a = 2; a >= 0; --a) kstr[a] = kstr[a + 1] * kernel[a + 1];

  // Python floor division (numerator may be negative for degenerate shapes)
  auto fdiv = [](int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
  };
  const int64_t oB = fdiv(g.B + 2 * pad[0] - kernel[0], stride[0]) + 1;
  const int64_t oD = fdiv(g.D + 2 * pad[1] - kernel[1], stride[1]) + 1;
  const int64_t oH = fdiv(g.H + 2 * pad[2] - kernel[2], stride[2]) + 1;
  const int64_t oW = fdiv(g.W + 2 * pad[3] - kernel[3], stride[3]) + 1;
  const int64_t oshape[4] = {oB, oD, oH, oW};
  int64_t ostr[4];
  ostr[3] = 1; ostr[2] = oW; ostr[1] = oH * oW; ostr[0] = oD * oH * oW;

  // per-axis candidate counts, ceil(k/s)
  int jcnt[4];
  for (int a = 0; a < 4; ++a) jcnt[a] = (kernel[a] + stride[a] - 1) / stride[a];

  struct Cand {
    int32_t id;  // output flat id
    int32_t in_row;
    int32_t tap;
  };
  std::vector<Cand> cands;
  cands.reserve(g.n_real * jcnt[0] * jcnt[1] * jcnt[2] * jcnt[3]);

  int combo = 0;
  int j[4];
  for (j[0] = 0; j[0] < jcnt[0]; ++j[0])
    for (j[1] = 0; j[1] < jcnt[1]; ++j[1])
      for (j[2] = 0; j[2] < jcnt[2]; ++j[2])
        for (j[3] = 0; j[3] < jcnt[3]; ++j[3]) {
          for (int64_t i = 0; i < g.n_real; ++i) {
            int64_t oid = 0, tapf = 0;
            bool valid = true;
            for (int a = 0; a < 4 && valid; ++a) {
              const int64_t top = g.coords[i * 4 + a] + pad[a];
              const int64_t o = top / stride[a] - j[a];  // top >= 0 always
              const int64_t tap = top - o * stride[a];
              valid = (o * stride[a] >= top - kernel[a] + 1) && o >= 0 &&
                      o < oshape[a];
              oid += o * ostr[a];
              tapf += tap * kstr[a];
            }
            if (valid) {
              cands.push_back(Cand{static_cast<int32_t>(oid),
                                   static_cast<int32_t>(i),
                                   static_cast<int32_t>(tapf)});
            }
          }
          ++combo;
        }
  (void)combo;

  // candidates were pushed in exactly (combo, input-row) order — the JAX
  // builder's stable tie-break — so a STABLE sort by id alone reproduces
  // its (id, combo*cap + row) order. LSD radix, 8-bit digits, passes
  // bounded by the id range: ~3x the throughput of std::sort here.
  {
    int32_t maxid = 0;
    for (const Cand& c : cands) maxid = std::max(maxid, c.id);
    int passes = 0;
    while (maxid >> (8 * passes) && passes < 4) ++passes;
    std::vector<Cand> tmp(cands.size());
    for (int pass = 0; pass < passes; ++pass) {
      size_t cnt[257] = {0};
      const int shift = 8 * pass;
      for (const Cand& c : cands) ++cnt[((c.id >> shift) & 0xff) + 1];
      for (int d = 0; d < 256; ++d) cnt[d + 1] += cnt[d];
      for (const Cand& c : cands) tmp[cnt[(c.id >> shift) & 0xff]++] = c;
      cands.swap(tmp);
    }
  }

  res->out.cap = out_cap;
  res->out.set_shape(oB, oD, oH, oW);
  res->out.ids.assign(out_cap, I32_MAX);
  res->out.coords.assign(out_cap * 4, -1);
  res->inv.assign(g.cap * K, static_cast<int32_t>(out_cap));
  res->idx.assign(out_cap * K, static_cast<int32_t>(g.cap));

  int64_t rank = -1;
  int32_t prev = I32_MAX;
  for (const Cand& c : cands) {
    if (c.id != prev) { ++rank; prev = c.id; }
    if (rank >= out_cap) break;  // spatial-order truncation
    if (res->out.ids[rank] == I32_MAX) {
      res->out.ids[rank] = c.id;
      int64_t rem = c.id;
      for (int a = 0; a < 4; ++a) {
        res->out.coords[rank * 4 + a] = static_cast<int32_t>(rem / ostr[a]);
        rem %= ostr[a];
      }
    }
    res->inv[(int64_t)c.in_row * K + c.tap] = static_cast<int32_t>(rank);
    res->idx[rank * K + c.tap] = c.in_row;
  }
  res->out.n_real = std::min<int64_t>(rank + 1, out_cap);
}

// ---- x-window info derived from a dense index (xwin_from_index) -----------
void xwin_from_idx(const int32_t* idx, const Grid& out_g, int64_t n_in, int kx,
                   int stride_x, int pad_x, int64_t w_dim, int K,
                   int32_t* rows /*[out_cap * (K/kx)]*/,
                   uint8_t* xvalid /*[out_cap * kx]*/) {
  const int gcnt = K / kx;
  const int32_t miss = static_cast<int32_t>(n_in * kx);
  for (int64_t o = 0; o < out_g.cap; ++o) {
    for (int gi = 0; gi < gcnt; ++gi) {
      int t0 = 0;
      bool any = false;
      int32_t r = 0;
      for (int t = 0; t < kx; ++t) {
        const int32_t v = idx[o * K + gi * kx + t];
        if (v < n_in) { t0 = t; r = v; any = true; break; }
      }
      rows[o * gcnt + gi] = any ? r * kx + t0 : miss;
    }
    const bool m = o < out_g.n_real;
    const int64_t lx0 = (int64_t)out_g.coords[o * 4 + 3] * stride_x - pad_x;
    for (int t = 0; t < kx; ++t) {
      const int64_t lx = lx0 + t;
      xvalid[o * kx + t] = (m && lx >= 0 && lx < w_dim) ? 1 : 0;
    }
  }
}

}  // namespace

namespace {

// shared per-batch hard voxelization (ops/voxelize semantics); fills the
// [B,V,T,F] voxel tensors and returns per-sample counts + per-(b,v) flat3 ids
void voxelize_all(const float* points, const uint8_t* points_mask,
                  int64_t Bn, int64_t P, int64_t F,
                  const float* pcr, const float* vs,
                  int64_t V, int64_t T, int64_t nx, int64_t ny, int64_t nz,
                  float* out_voxels, uint8_t* out_pmask,
                  std::vector<int32_t>* counts, std::vector<int32_t>* vflat,
                  int32_t* out_slot_point /*[B,V,T] or null*/,
                  int32_t* out_point_slot /*[B,P] or null*/) {
  const int64_t sentinel = nz * ny * nx;
  counts->assign(Bn, 0);
  vflat->assign(Bn * V, static_cast<int32_t>(sentinel));
  std::memset(out_voxels, 0, sizeof(float) * Bn * V * T * F);
  std::memset(out_pmask, 0, sizeof(uint8_t) * Bn * V * T);
  // point <-> slot bijection (ops/voxelize slot_point/point_slot semantics):
  // slot_point miss = P; point_slot for dropped/out-of-range points = V*T
  if (out_slot_point)
    for (int64_t i = 0; i < Bn * V * T; ++i)
      out_slot_point[i] = static_cast<int32_t>(P);
  if (out_point_slot)
    for (int64_t i = 0; i < Bn * P; ++i)
      out_point_slot[i] = static_cast<int32_t>(V * T);

  std::vector<std::pair<int32_t, int32_t>> keyed(P);
  for (int64_t b = 0; b < Bn; ++b) {
    const float* pts = points + b * P * F;
    const uint8_t* msk = points_mask + b * P;
    int64_t nvalid = 0;
    for (int64_t p = 0; p < P; ++p) {
      int32_t flat = static_cast<int32_t>(sentinel);
      if (msk[p]) {
        const float fx = std::floor((pts[p * F + 0] - pcr[0]) / vs[0]);
        const float fy = std::floor((pts[p * F + 1] - pcr[1]) / vs[1]);
        const float fz = std::floor((pts[p * F + 2] - pcr[2]) / vs[2]);
        if (fx >= 0 && fx < (float)nx && fy >= 0 && fy < (float)ny &&
            fz >= 0 && fz < (float)nz) {
          flat = static_cast<int32_t>((int64_t)fz * ny * nx +
                                      (int64_t)fy * nx + (int64_t)fx);
        }
      }
      keyed[p] = {flat, static_cast<int32_t>(p)};
    }
    std::stable_sort(keyed.begin(), keyed.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    int64_t vr = -1;
    int32_t cur = -1;
    int64_t slot = 0;
    for (int64_t s = 0; s < P; ++s) {
      const int32_t flat = keyed[s].first;
      if (flat == sentinel) break;
      if (flat != cur) { ++vr; cur = flat; slot = 0; } else { ++slot; }
      if (vr >= V || slot >= T) continue;
      const int64_t src = keyed[s].second;
      std::memcpy(out_voxels + ((b * V + vr) * T + slot) * F,
                  pts + src * F, sizeof(float) * F);
      out_pmask[(b * V + vr) * T + slot] = 1;
      if (out_slot_point)
        out_slot_point[(b * V + vr) * T + slot] = static_cast<int32_t>(src);
      if (out_point_slot)
        out_point_slot[b * P + src] = static_cast<int32_t>(vr * T + slot);
      if (slot == 0) {
        (*vflat)[b * V + vr] = flat;
        ++nvalid;
      }
    }
    (*counts)[b] = static_cast<int32_t>(std::min<int64_t>(nvalid, V));
  }
}

}  // namespace

extern "C" {

// Pillar-family plan: voxelization + merged 2D (batch, y, x) BEV grid +
// dense-cell gather map (models/pointpillars.build_pillar_plan twin).
// Requires nz == 1 (single z pillar) so per-sample voxel order equals
// ascending 2D flat order (asserted Python-side).
int rpc_build_pillar_plan(const float* points, const uint8_t* points_mask,
                          int64_t Bn, int64_t P, int64_t F,
                          const float* pcr, const float* vs,
                          int64_t V, int64_t T, int64_t nx, int64_t ny,
                          int64_t nz, void** outs) {
  int oi = 0;
  float* out_voxels = static_cast<float*>(outs[oi++]);      // [B,V,T,F]
  int32_t* out_vcoords = static_cast<int32_t*>(outs[oi++]); // [B,V,3]
  int32_t* out_npoints = static_cast<int32_t*>(outs[oi++]); // [B,V]
  uint8_t* out_vmask = static_cast<uint8_t*>(outs[oi++]);   // [B,V]
  uint8_t* out_pmask = static_cast<uint8_t*>(outs[oi++]);   // [B,V,T]
  int32_t* out_order = static_cast<int32_t*>(outs[oi++]);   // [B*V]
  int32_t* out_gids = static_cast<int32_t*>(outs[oi++]);    // [B*V]
  int32_t* out_gcoords = static_cast<int32_t*>(outs[oi++]); // [B*V,3]
  uint8_t* out_gmask = static_cast<uint8_t*>(outs[oi++]);   // [B*V]
  int32_t* out_dense = static_cast<int32_t*>(outs[oi++]);   // [B*ny*nx]
  int32_t* out_slotp = static_cast<int32_t*>(outs[oi++]);   // [B,V,T]
  int32_t* out_pslot = static_cast<int32_t*>(outs[oi++]);   // [B,P]

  const int64_t N = Bn * V;
  std::vector<int32_t> counts;
  std::vector<int32_t> vflat;
  voxelize_all(points, points_mask, Bn, P, F, pcr, vs, V, T, nx, ny, nz,
               out_voxels, out_pmask, &counts, &vflat, out_slotp, out_pslot);

  for (int64_t b = 0; b < Bn; ++b) {
    for (int64_t v = 0; v < V; ++v) {
      int32_t np = 0;
      for (int64_t t = 0; t < T; ++t) np += out_pmask[(b * V + v) * T + t];
      out_npoints[b * V + v] = np;
      out_vmask[b * V + v] = np > 0 ? 1 : 0;
      const int64_t flat = vflat[b * V + v];
      if (np > 0) {
        out_vcoords[(b * V + v) * 3 + 0] = static_cast<int32_t>(flat / (ny * nx));
        out_vcoords[(b * V + v) * 3 + 1] =
            static_cast<int32_t>((flat % (ny * nx)) / nx);
        out_vcoords[(b * V + v) * 3 + 2] = static_cast<int32_t>(flat % nx);
      } else {
        out_vcoords[(b * V + v) * 3 + 0] = -1;
        out_vcoords[(b * V + v) * 3 + 1] = -1;
        out_vcoords[(b * V + v) * 3 + 2] = -1;
      }
    }
  }

  // merged 2D grid over (B, ny, nx); nz == 1 makes per-sample flat3 == flat2
  const int64_t size = Bn * ny * nx;
  for (int64_t i = 0; i < size; ++i) out_dense[i] = static_cast<int32_t>(N);
  int64_t w = 0;
  for (int64_t b = 0; b < Bn; ++b) {
    for (int64_t v = 0; v < counts[b]; ++v) {
      const int64_t flat3 = vflat[b * V + v];
      const int64_t y = (flat3 % (ny * nx)) / nx, x = flat3 % nx;
      const int64_t id2 = b * ny * nx + y * nx + x;
      out_gids[w] = static_cast<int32_t>(id2);
      out_gcoords[w * 3 + 0] = static_cast<int32_t>(b);
      out_gcoords[w * 3 + 1] = static_cast<int32_t>(y);
      out_gcoords[w * 3 + 2] = static_cast<int32_t>(x);
      out_gmask[w] = 1;
      out_dense[id2] = static_cast<int32_t>(w);
      out_order[w] = static_cast<int32_t>(b * V + v);
      ++w;
    }
  }
  for (int64_t i = w; i < N; ++i) {
    out_gids[i] = INT32_MAX;
    out_gcoords[i * 3 + 0] = -1;
    out_gcoords[i * 3 + 1] = -1;
    out_gcoords[i * 3 + 2] = -1;
    out_gmask[i] = 0;
  }
  for (int64_t b = 0; b < Bn; ++b)
    for (int64_t v = counts[b]; v < V; ++v)
      out_order[w++] = static_cast<int32_t>(b * V + v);
  return 0;
}

// Builds the full sparse plan for the default encoder layout.
// Returns 0 on success. All output buffers are caller-allocated with the
// exact static shapes listed in data/native_plan.py (which documents the
// pointer order of `outs`).
int rpc_build_plan(const float* points, const uint8_t* points_mask,
                   int64_t Bn, int64_t P, int64_t F,
                   const float* pcr /*[6]*/, const float* vs /*[3]*/,
                   int64_t V, int64_t T, int64_t nx, int64_t ny, int64_t nz,
                   const double* cap_factors /*[4]: s2, s3, s4, out*/,
                   void** outs) {
  int oi = 0;
  float* out_voxels = static_cast<float*>(outs[oi++]);        // [B,V,T,F]
  int32_t* out_vcoords = static_cast<int32_t*>(outs[oi++]);   // [B,V,3]
  int32_t* out_npoints = static_cast<int32_t*>(outs[oi++]);   // [B,V]
  uint8_t* out_vmask = static_cast<uint8_t*>(outs[oi++]);     // [B,V]
  uint8_t* out_pmask = static_cast<uint8_t*>(outs[oi++]);     // [B,V,T]
  int32_t* out_order = static_cast<int32_t*>(outs[oi++]);     // [B*V]
  int32_t* out_gids = static_cast<int32_t*>(outs[oi++]);      // [B*V]
  int32_t* out_gcoords = static_cast<int32_t*>(outs[oi++]);   // [B*V,4]
  uint8_t* out_gmask = static_cast<uint8_t*>(outs[oi++]);     // [B*V]
  int32_t* rel0_rows = static_cast<int32_t*>(outs[oi++]);     // [N,9]
  uint8_t* rel0_xv = static_cast<uint8_t*>(outs[oi++]);       // [N,3]
  int32_t* d1_ids = static_cast<int32_t*>(outs[oi++]);        // [N1]
  int32_t* d1_coords = static_cast<int32_t*>(outs[oi++]);     // [N1,4]
  uint8_t* d1_mask = static_cast<uint8_t*>(outs[oi++]);       // [N1]
  int32_t* d1_inv = static_cast<int32_t*>(outs[oi++]);        // [N,27]
  int32_t* d1_rows = static_cast<int32_t*>(outs[oi++]);       // [N1,9]
  uint8_t* d1_xv = static_cast<uint8_t*>(outs[oi++]);         // [N1,3]
  int32_t* rel1_rows = static_cast<int32_t*>(outs[oi++]);     // [N1,9]
  uint8_t* rel1_xv = static_cast<uint8_t*>(outs[oi++]);       // [N1,3]
  int32_t* d2_ids = static_cast<int32_t*>(outs[oi++]);        // [N2]
  int32_t* d2_coords = static_cast<int32_t*>(outs[oi++]);     // [N2,4]
  uint8_t* d2_mask = static_cast<uint8_t*>(outs[oi++]);       // [N2]
  int32_t* d2_inv = static_cast<int32_t*>(outs[oi++]);        // [N1,27]
  int32_t* d2_rows = static_cast<int32_t*>(outs[oi++]);       // [N2,9]
  uint8_t* d2_xv = static_cast<uint8_t*>(outs[oi++]);         // [N2,3]
  int32_t* rel2_idx = static_cast<int32_t*>(outs[oi++]);      // [N2,27]
  int32_t* d3_ids = static_cast<int32_t*>(outs[oi++]);        // [N3]
  int32_t* d3_coords = static_cast<int32_t*>(outs[oi++]);     // [N3,4]
  uint8_t* d3_mask = static_cast<uint8_t*>(outs[oi++]);       // [N3]
  int32_t* d3_inv = static_cast<int32_t*>(outs[oi++]);        // [N2,27]
  int32_t* d3_idx = static_cast<int32_t*>(outs[oi++]);        // [N3,27]
  int32_t* rel3_idx = static_cast<int32_t*>(outs[oi++]);      // [N3,27]
  int32_t* o_ids = static_cast<int32_t*>(outs[oi++]);         // [N4]
  int32_t* o_coords = static_cast<int32_t*>(outs[oi++]);      // [N4,4]
  uint8_t* o_mask = static_cast<uint8_t*>(outs[oi++]);        // [N4]
  int32_t* o_inv = static_cast<int32_t*>(outs[oi++]);         // [N3,3]
  int32_t* o_idx = static_cast<int32_t*>(outs[oi++]);         // [N4,3]
  int32_t* out_slotp = static_cast<int32_t*>(outs[oi++]);     // [B,V,T]
  int32_t* out_pslot = static_cast<int32_t*>(outs[oi++]);     // [B,P]

  const int64_t N = Bn * V;
  const int64_t D = nz + 1;  // sparse z (SECOND convention)

  // ---- per-sample hard voxelization (ops/voxelize.voxelize semantics) ----
  std::vector<int32_t> counts;
  std::vector<int32_t> vflat;   // per (b, v): flat3 id, ascending per sample
  voxelize_all(points, points_mask, Bn, P, F, pcr, vs, V, T, nx, ny, nz,
               out_voxels, out_pmask, &counts, &vflat, out_slotp, out_pslot);
  for (int64_t b = 0; b < Bn; ++b) {
    for (int64_t v = 0; v < V; ++v) {
      int32_t np = 0;
      for (int64_t t = 0; t < T; ++t) np += out_pmask[(b * V + v) * T + t];
      out_npoints[b * V + v] = np;
      const bool vm = np > 0;
      out_vmask[b * V + v] = vm ? 1 : 0;
      if (vm) {
        const int64_t flat = vflat[b * V + v];
        out_vcoords[(b * V + v) * 3 + 0] = static_cast<int32_t>(flat / (ny * nx));
        out_vcoords[(b * V + v) * 3 + 1] =
            static_cast<int32_t>((flat % (ny * nx)) / nx);
        out_vcoords[(b * V + v) * 3 + 2] = static_cast<int32_t>(flat % nx);
      } else {
        out_vcoords[(b * V + v) * 3 + 0] = -1;
        out_vcoords[(b * V + v) * 3 + 1] = -1;
        out_vcoords[(b * V + v) * 3 + 2] = -1;
      }
    }
  }

  // ---- merged 4D grid + order (sparse.with_batch_axis semantics) ---------
  // per-sample ids ascend and real rows are v < counts[b]; batch-prefixed
  // flat4 makes the merged order sample-major, padding rows last in
  // original (b*V + v) order (stable argsort of equal sentinel keys).
  Grid g0;
  g0.cap = N;
  g0.set_shape(Bn, D, ny, nx);
  g0.ids.assign(N, I32_MAX);
  g0.coords.assign(N * 4, -1);
  int64_t w = 0;
  for (int64_t b = 0; b < Bn; ++b) {
    for (int64_t v = 0; v < counts[b]; ++v) {
      const int64_t flat3 = vflat[b * V + v];
      const int64_t z = flat3 / (ny * nx), y = (flat3 % (ny * nx)) / nx,
                    x = flat3 % nx;
      g0.ids[w] = static_cast<int32_t>(b * g0.sB + z * g0.sD + y * g0.sH + x);
      g0.coords[w * 4 + 0] = static_cast<int32_t>(b);
      g0.coords[w * 4 + 1] = static_cast<int32_t>(z);
      g0.coords[w * 4 + 2] = static_cast<int32_t>(y);
      g0.coords[w * 4 + 3] = static_cast<int32_t>(x);
      out_order[w] = static_cast<int32_t>(b * V + v);
      ++w;
    }
  }
  g0.n_real = w;
  for (int64_t b = 0; b < Bn; ++b)
    for (int64_t v = counts[b]; v < V; ++v)
      out_order[w++] = static_cast<int32_t>(b * V + v);

  std::memcpy(out_gids, g0.ids.data(), sizeof(int32_t) * N);
  std::memcpy(out_gcoords, g0.coords.data(), sizeof(int32_t) * N * 4);
  for (int64_t i = 0; i < N; ++i) out_gmask[i] = i < g0.n_real ? 1 : 0;

  // ---- encoder traversal ---------------------------------------------------
  subm_xwin(g0, rel0_rows, rel0_xv);

  const int k3[4] = {1, 3, 3, 3}, s2[4] = {1, 2, 2, 2};
  const int p_z1[4] = {0, 1, 1, 1}, p_z0[4] = {0, 0, 1, 1};
  auto capof = [&](double f) {
    return std::max<int64_t>(static_cast<int64_t>((double)N * f), 1);
  };

  DownResult d1;
  downsample(g0, k3, s2, p_z1, capof(cap_factors[0]), &d1);
  std::memcpy(d1_ids, d1.out.ids.data(), sizeof(int32_t) * d1.out.cap);
  std::memcpy(d1_coords, d1.out.coords.data(), sizeof(int32_t) * d1.out.cap * 4);
  for (int64_t i = 0; i < d1.out.cap; ++i) d1_mask[i] = i < d1.out.n_real;
  std::memcpy(d1_inv, d1.inv.data(), sizeof(int32_t) * g0.cap * 27);
  xwin_from_idx(d1.idx.data(), d1.out, g0.cap, 3, 2, 1, g0.W, 27, d1_rows, d1_xv);
  subm_xwin(d1.out, rel1_rows, rel1_xv);

  DownResult d2;
  downsample(d1.out, k3, s2, p_z1, capof(cap_factors[1]), &d2);
  std::memcpy(d2_ids, d2.out.ids.data(), sizeof(int32_t) * d2.out.cap);
  std::memcpy(d2_coords, d2.out.coords.data(), sizeof(int32_t) * d2.out.cap * 4);
  for (int64_t i = 0; i < d2.out.cap; ++i) d2_mask[i] = i < d2.out.n_real;
  std::memcpy(d2_inv, d2.inv.data(), sizeof(int32_t) * d1.out.cap * 27);
  xwin_from_idx(d2.idx.data(), d2.out, d1.out.cap, 3, 2, 1, d1.out.W, 27,
                d2_rows, d2_xv);
  subm_dense_idx(d2.out, rel2_idx);

  DownResult d3;
  downsample(d2.out, k3, s2, p_z0, capof(cap_factors[2]), &d3);
  std::memcpy(d3_ids, d3.out.ids.data(), sizeof(int32_t) * d3.out.cap);
  std::memcpy(d3_coords, d3.out.coords.data(), sizeof(int32_t) * d3.out.cap * 4);
  for (int64_t i = 0; i < d3.out.cap; ++i) d3_mask[i] = i < d3.out.n_real;
  std::memcpy(d3_inv, d3.inv.data(), sizeof(int32_t) * d2.out.cap * 27);
  std::memcpy(d3_idx, d3.idx.data(), sizeof(int32_t) * d3.out.cap * 27);
  subm_dense_idx(d3.out, rel3_idx);

  const int ko[4] = {1, 3, 1, 1}, so[4] = {1, 2, 1, 1}, po[4] = {0, 0, 0, 0};
  DownResult dout;
  downsample(d3.out, ko, so, po, capof(cap_factors[3]), &dout);
  std::memcpy(o_ids, dout.out.ids.data(), sizeof(int32_t) * dout.out.cap);
  std::memcpy(o_coords, dout.out.coords.data(), sizeof(int32_t) * dout.out.cap * 4);
  for (int64_t i = 0; i < dout.out.cap; ++i) o_mask[i] = i < dout.out.n_real;
  std::memcpy(o_inv, dout.inv.data(), sizeof(int32_t) * d3.out.cap * 3);
  std::memcpy(o_idx, dout.idx.data(), sizeof(int32_t) * dout.out.cap * 3);

  return 0;
}

}  // extern "C"
