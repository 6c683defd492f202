// K3: carry_sweep_project — batched projection of TT/CP-format inputs by a
// TT/CP operator, all four pairings, orders 2..8, runtime dims and ranks:
//   y[b, i] = scale * < S_i, X_b >,  S_i the i-th operator row tensor,
//   X_b the b-th structured input, never densified.
// K6: carry_sweep_project_pipelined — the same function, one block per
//   k-tile, with the batch tiles of input cores double-buffered.
//
// Replace the Pallas TPU kernels repro/kernels/struct/carry.py::
// carry_sweep_project (_carry_kernel) and carry_sweep_project_pipelined
// (_carry_pipelined_kernel). The computation is the planner's carry program
// (repro_torch/kernels/struct/plan.py::_carry_program, the reference's
// einsum strings), lowered to one opcode per mode
// (struct/carry.py::carry_codes): mode 0 opens the (R_op, R_in) bond carry,
// each interior mode updates it, the last mode closes it to a scalar.
//
// What bounds it on an H100: per (item, k-row) a mode costs
// 2*d*R*R~*(R + R~) flops (tt x tt) on d*R*R + d*R~*R~ core floats, so it is
// bound by instruction issue (FMAs and shared-memory loads) of tiny
// contractions, not by device memory. The design:
//  * Threads over (item, k-row) pairs, carries in registers. A block owns
//    tk k-rows x tb items. A pair's carry, padded to nv x nf register tiles
//    of RO operator-bond rows x RI input-bond columns (CARRY_TILES), sits in
//    shared memory between modes; each of the pair's tps tile threads owns
//    output tiles tps apart (one where tps = nv * nf, the common case) and
//    loads the carry tiles it contracts into registers once per chunk of d.
//    Per d it reads its tile's core values once from shared memory and
//    reuses them across the register tile. A TT operator mixes its bond in
//    every mode, so an output tile sums over every carry tile of its
//    columns (TT input: every carry tile); a CP operator never mixes its r
//    channels before the last mode, so it reads only its own rows. A bond
//    of any size is more tiles, not a larger register tile.
//  * tpd threads of a tile split each mode's d range (a B=8 serve tick
//    needs them to fill the card).
//  * Each mode's two einsum steps are fused over d: the program's temp
//    (bkedv, bkrdf) is formed one d-slice at a time in registers.
//  * At the end of a mode the partial tiles are summed in d-part order (no
//    atomics) into the carry; the last mode's partial outputs are summed in
//    thread order, so a second call gives the same bits.
//  * Carry entries past the true bonds are held at zero, so a thread reads
//    a core's columns past its bonds (inside the row stride the planner
//    sizes: finite data) and clamps its rows, and the register loops have
//    no branch.
//  * K3 stages, mode by mode and chunk by chunk of dc values of d, its
//    k-rows of operator core n and its items' input core n into one of two
//    shared-memory slots with 16-byte cp.async (4-byte where a row is not a
//    multiple of 16 bytes), the next chunk streaming in while this one
//    computes: each staged operator value serves tb items, each input value
//    tk k-rows. K6 keeps every operator core of its k-tile resident and
//    streams the input cores of the next batch tile into the second slot.
//  * Ragged edges (k, B) are zero-filled rows whose outputs are not
//    written; input TT bond ranks are per-bond runtime arguments.
// All arithmetic is IEEE fp32 FMA.
#include <cuda_runtime.h>

#include "sweep_stage.cuh"

#define CARRY_MAX_ORDER 8

enum CarryOp {
  C_FIRST = 1,       // c[a,b]  = sum_d G[d,a] X[d,b]                 mode 0
  C_MIX_TT_TT = 2,   // c'[v,f] = sum_{d,u,e} c[u,e] g[u,d,v] x[e,d,f]
  C_MIX_TT_CP = 3,   // c'[v,p] = sum_{d,u} c[u,p] g[u,d,v] a[d,p]
  C_MIX_CP_TT = 4,   // c'[r,f] = sum_{d,e} c[r,e] x[e,d,f] f[d,r]
  C_MIX_CP_CP = 5,   // c'[r,p] = c[r,p] sum_d f[d,r] a[d,p]
  C_LAST_TT_TT = 6,  // y = sum_{d,u,e} c[u,e] g[u,d] x[e,d]           last
  C_LAST_TT_CP = 7,  // y = sum_{d,u,p} c[u,p] g[u,d] a[d,p]
  C_LAST_CP_TT = 8,  // y = sum_{d,r,e} c[r,e] x[e,d] f[d,r]
  C_LAST_CP_CP = 9,  // y = sum_{r,p} c[r,p] sum_d f[d,r] a[d,p]
};

// Register tiles (RO, RI) compiled (struct/plan.py's CARRY_TILES holds the
// same list): (5, 4) is the serving shapes' carry whole (TT(5) x rank 4) or
// a fifth of it (CP(25)); (8, 8) takes larger bonds in fewer tiles.
#define CARRY_TILES(X) X(5, 4) X(8, 8)
#define CARRY_THREADS 256

struct CarryArgs {
  const float* op[CARRY_MAX_ORDER];   // squeezed operator cores, k leading
  const float* in[CARRY_MAX_ORDER];   // squeezed input cores, batch leading
  float* y;                           // (B, K)
  int dims[CARRY_MAX_ORDER];
  int codes[CARRY_MAX_ORDER];         // opcode of mode n
  int rin[CARRY_MAX_ORDER + 1];       // input bonds r_0..r_N (CP: R~ at all)
  int order, B, K, R, op_tt, in_tt;
  float scale;
};

// The planner's schedule (struct/plan.py::CarryPlan).
struct CarryTiles {
  int tk, tb, tps, tpd, dc, uc, ro, ri, rin_max, smem_bytes;
};

// A pair's carry geometry (struct/plan.py::CarryPlan's nv, nf, n_tiles and
// carry_stride).
struct Geometry {
  int nv, nf, nt;  // operator-bond tiles, input-bond tiles, nv * nf
  int rp, fp;      // padded carry rows nv * RO and columns nf * RI
  int cst;         // floats between two pairs' carries (odd: no bank conflict)
  int tts;         // floats a partial tile takes in the exchange buffer
  bool single;     // each tile thread owns one tile (tps == nt)
  bool xbuf;       // partial tiles meet in the exchange buffer
};
static __device__ inline Geometry geometry(const CarryArgs& a, const CarryTiles& t) {
  Geometry g;
  g.nv = (a.R + t.ro - 1) / t.ro;
  g.nf = (t.rin_max + t.ri - 1) / t.ri;
  g.nt = g.nv * g.nf;
  g.rp = g.nv * t.ro;
  g.fp = g.nf * t.ri;
  g.cst = g.rp * g.fp | 1;
  g.tts = t.ro * t.ri | 1;
  g.single = t.tps == g.nt;
  g.xbuf = !g.single || t.tpd > 1;
  return g;
}
// Floats of the carry and exchange regions of `pairs` pairs.
static __device__ inline size_t pair_floats(const Geometry& g, const CarryTiles& t,
                                            int pairs) {
  size_t f = up4(static_cast<long long>(pairs) * g.cst);
  if (g.xbuf) f += up4(static_cast<long long>(pairs) * g.nt * t.tpd * g.tts);
  return f;
}

// A core row's chunk [a][L][c], read at columns < cr (rows are clamped to
// a - 1, so only columns may pass the bonds).
struct RowShape {
  int a, c, cr;
};
static __host__ __device__ inline int row_stride(int a, int L, int c, int cr) {
  // struct/plan.py::row_extent and row_stride
  long long s = up4(static_cast<long long>(a) * L * c + (cr > c ? cr - c : 0));
  if (s % 32 == 0) s += 4;
  return static_cast<int>(s);
}
// Mode n's operator row (struct/plan.py::core_bounds).
static __device__ inline RowShape op_shape(const CarryArgs& a, const Geometry& g, int n) {
  if (!a.op_tt) return {1, a.R, g.rp};
  const bool first = n == 0, last = n == a.order - 1;
  return {first ? 1 : a.R, last ? 1 : a.R, last ? 1 : g.rp};
}
// K3 stages an interior TT operator core uc rows at a time (all of them
// unless one value of d of a k-row outgrows the block); other cores whole.
static __device__ inline bool u_chunked(const CarryArgs& a, int n) {
  return a.op_tt && n > 0 && n < a.order - 1;
}
static __device__ inline int op_stride(const CarryArgs& a, const Geometry& g, int n, int L,
                                       int rows) {
  const RowShape s = op_shape(a, g, n);
  return row_stride(min(s.a, rows), L, s.c, s.cr);
}
// Mode n's input row as planned: the planner's input rank r_in at every
// interior bond, read at columns < fp.
static __device__ inline int in_stride(const CarryArgs& a, const CarryTiles& t,
                                       const Geometry& g, int n, int L) {
  const bool first = n == 0, last = n == a.order - 1;
  const int r = t.rin_max;
  if (!a.in_tt) return row_stride(1, L, r, g.fp);
  return row_stride(first ? 1 : r, L, last ? 1 : r, last ? 1 : g.fp);
}
static __device__ inline int in_c(const CarryArgs& a, int n) {
  return a.in_tt ? (n == a.order - 1 ? 1 : a.rin[n + 1]) : a.rin[0];
}
static __device__ inline int in_a(const CarryArgs& a, int n) {
  return a.in_tt && n > 0 ? a.rin[n] : 1;
}

// Copies rows [row0, row0 + nrows) of a core [rows][A][D][C], its bond
// rows [a0, a0 + na) and values [d0, d0 + dlen) of d, into
// dst[r * stride + (a * L + dd) * C + c]; rows at or past `limit` are
// zero-filled. 16-byte copies where D*C and L*C are multiples of 4 floats
// and the core is 16-byte aligned, else 4-byte.
static __device__ void stage_rows(float* dst, int stride, const float* src, int row0,
                                  int nrows, int limit, int A, int a0, int na, int D, int C,
                                  int L, int d0, int dlen, int tid, int nt) {
  const bool vec = (D * C) % 4 == 0 && (L * C) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int w = vec ? 4 : 1, q = dlen * C / w, per_row = na * q;
  for (int u = tid; u < nrows * per_row; u += nt) {
    const int r = u / per_row, rem = u - r * per_row, a = rem / q, i = rem - a * q;
    const bool ok = row0 + r < limit;
    const float* sp = ok ? src + (static_cast<size_t>(row0 + r) * A + a0 + a) * D * C +
                               static_cast<size_t>(d0) * C + w * i
                         : src;
    float* dp = dst + r * stride + a * L * C + w * i;
    if (vec) cp_async16(dp, sp, ok);
    else cp_async4(dp, sp, ok);
  }
}

// One (item, k-row) pair's thread: its registers and where it stands.
template <int RO, int RI>
struct PairThread {
  float n[RO][RI];   // partial successor of the own tile (single tile only)
  float y;           // partial output of the last mode
  int j, ot, dp;     // thread of the pair, its tile thread and d-part
  float* C;          // the pair's carry, [rp][fp]
  float* xb;         // the pair's partial tiles, [nt][tpd][tts]
};

// The chunk of mode n a thread sees: G (this k-row's staged operator row,
// its bond rows [u0, u0 + ua) of ga, [ua][L][gc]) and X (this item's staged
// input row, [xa][L][xc]); rows past ga / xa read row ga - 1 / xa - 1
// (their carry entries are zero). The thread takes d values dd0,
// dd0 + step, ... < dlen.
struct Chunk {
  const float* G;
  const float* X;
  int ga, gc, xa, xc, L, dlen, dd0, step, u0, ua;
};

// Mode n of the carry program for one output tile (V, F) of the pair, on
// one chunk of d. kind: 0 first, 1 interior (n += the tile's successor),
// 2 last (y += the tile's output, carry tile (V, F)).
template <bool OT, bool IT, int RO, int RI>
static __device__ __forceinline__ void tile_mode(float (&n)[RO][RI], float& y, int kind,
                                                 int V, int F, const Geometry& gm,
                                                 const float* C, const Chunk& k) {
  const int v0 = V * RO, f0 = F * RI, fp = gm.fp;
  if (kind == 0 || (!OT && !IT && kind == 1)) {
    // first mode (all pairings) and CP x CP's sum_d f[d,r] a[d,p]
    for (int dd = k.dd0; dd < k.dlen; dd += k.step) {
      float g[RO], x[RI];
#pragma unroll
      for (int v = 0; v < RO; ++v) g[v] = k.G[dd * k.gc + v0 + v];
#pragma unroll
      for (int f = 0; f < RI; ++f) x[f] = k.X[dd * k.xc + f0 + f];
#pragma unroll
      for (int v = 0; v < RO; ++v)
#pragma unroll
        for (int f = 0; f < RI; ++f) n[v][f] = fmaf(g[v], x[f], n[v][f]);
    }
    return;
  }
  if (kind == 2) {
    float c[RO][RI], s[!OT && !IT ? RO : 1][!OT && !IT ? RI : 1] = {};
#pragma unroll
    for (int u = 0; u < RO; ++u)
#pragma unroll
      for (int e = 0; e < RI; ++e) c[u][e] = C[(v0 + u) * fp + f0 + e];
    for (int dd = k.dd0; dd < k.dlen; dd += k.step) {
      if constexpr (OT) {  // the operator's last core [u][d]
        float g[RO];
#pragma unroll
        for (int u = 0; u < RO; ++u) g[u] = k.G[min(v0 + u, k.ga - 1) * k.L + dd];
#pragma unroll
        for (int e = 0; e < RI; ++e) {
          float s = 0.f;
#pragma unroll
          for (int u = 0; u < RO; ++u) s = fmaf(c[u][e], g[u], s);
          y = fmaf(s, IT ? k.X[min(f0 + e, k.xa - 1) * k.L + dd] : k.X[dd * k.xc + f0 + e],
                   y);
        }
      } else if constexpr (IT) {  // CP x TT: f[d,r] (c[r,:] . x[:,d])
        float x[RI];
#pragma unroll
        for (int e = 0; e < RI; ++e) x[e] = k.X[min(f0 + e, k.xa - 1) * k.L + dd];
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < RI; ++e) s = fmaf(c[r][e], x[e], s);
          y = fmaf(k.G[dd * k.gc + v0 + r], s, y);
        }
      } else {  // CP x CP: s[r,p] = sum_d f[d,r] a[d,p] over the chunk
        float g[RO], x[RI];
#pragma unroll
        for (int r = 0; r < RO; ++r) g[r] = k.G[dd * k.gc + v0 + r];
#pragma unroll
        for (int p = 0; p < RI; ++p) x[p] = k.X[dd * k.xc + f0 + p];
#pragma unroll
        for (int r = 0; r < RO; ++r)
#pragma unroll
          for (int p = 0; p < RI; ++p) s[r][p] = fmaf(g[r], x[p], s[r][p]);
      }
    }
    if constexpr (!OT && !IT) {  // y += sum_{r,p} c[r,p] s[r,p]
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int p = 0; p < RI; ++p) y = fmaf(c[r][p], s[r][p], y);
    }
    return;
  }
  if constexpr (OT && IT) {
    // n[v,f] += sum_e t[v,e] x[e,d,f], t[v,e] = sum_u c[u,e] g[u,d,v], carry
    // tile (U, E) by carry tile
    const int U1 = min(gm.nv, (k.u0 + k.ua + RO - 1) / RO);
    for (int U = k.u0 / RO; U < U1; ++U)
      for (int E = 0; E < gm.nf; ++E) {
        float c[RO][RI];
#pragma unroll
        for (int u = 0; u < RO; ++u)
#pragma unroll
          for (int e = 0; e < RI; ++e) c[u][e] = C[(U * RO + u) * fp + E * RI + e];
        for (int dd = k.dd0; dd < k.dlen; dd += k.step) {
          float g[RO][RO];
#pragma unroll
          for (int u = 0; u < RO; ++u)
#pragma unroll
            for (int v = 0; v < RO; ++v)
              g[u][v] = k.G[((min(U * RO + u, k.ga - 1) - k.u0) * k.L + dd) * k.gc + v0 + v];
#pragma unroll
          for (int e = 0; e < RI; ++e) {
            float t[RO];
#pragma unroll
            for (int v = 0; v < RO; ++v) {
              float s = 0.f;
#pragma unroll
              for (int u = 0; u < RO; ++u) s = fmaf(c[u][e], g[u][v], s);
              t[v] = s;
            }
            float x[RI];
#pragma unroll
            for (int f = 0; f < RI; ++f)
              x[f] = k.X[(min(E * RI + e, k.xa - 1) * k.L + dd) * k.xc + f0 + f];
#pragma unroll
            for (int v = 0; v < RO; ++v)
#pragma unroll
              for (int f = 0; f < RI; ++f) n[v][f] = fmaf(t[v], x[f], n[v][f]);
          }
        }
      }
  } else if constexpr (OT) {
    // n[v,p] += (c[:,p] . g[:,d,v]) a[d,p], carry tile (U, F) by carry tile
    const int U1 = min(gm.nv, (k.u0 + k.ua + RO - 1) / RO);
    for (int U = k.u0 / RO; U < U1; ++U) {
      float c[RO][RI];
#pragma unroll
      for (int u = 0; u < RO; ++u)
#pragma unroll
        for (int q = 0; q < RI; ++q) c[u][q] = C[(U * RO + u) * fp + f0 + q];
      for (int dd = k.dd0; dd < k.dlen; dd += k.step) {
        float x[RI];
#pragma unroll
        for (int q = 0; q < RI; ++q) x[q] = k.X[dd * k.xc + f0 + q];
#pragma unroll
        for (int v = 0; v < RO; ++v) {
          float g[RO];
#pragma unroll
          for (int u = 0; u < RO; ++u)
            g[u] = k.G[((min(U * RO + u, k.ga - 1) - k.u0) * k.L + dd) * k.gc + v0 + v];
#pragma unroll
          for (int q = 0; q < RI; ++q) {
            float s = 0.f;
#pragma unroll
            for (int u = 0; u < RO; ++u) s = fmaf(c[u][q], g[u], s);
            n[v][q] = fmaf(s, x[q], n[v][q]);
          }
        }
      }
    }
  } else {
    // CP x TT: n[r,f] += f[d,r] (c[r,:] . x[:,d,f]), carry tile (V, E) by
    // carry tile
    for (int E = 0; E < gm.nf; ++E) {
      float c[RO][RI];
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int e = 0; e < RI; ++e) c[r][e] = C[(v0 + r) * fp + E * RI + e];
      for (int dd = k.dd0; dd < k.dlen; dd += k.step) {
        float g[RO];
#pragma unroll
        for (int r = 0; r < RO; ++r) g[r] = k.G[dd * k.gc + v0 + r];
#pragma unroll
        for (int f = 0; f < RI; ++f) {
          float x[RI];
#pragma unroll
          for (int e = 0; e < RI; ++e)
            x[e] = k.X[(min(E * RI + e, k.xa - 1) * k.L + dd) * k.xc + f0 + f];
#pragma unroll
          for (int r = 0; r < RO; ++r) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < RI; ++e) s = fmaf(c[r][e], x[e], s);
            n[r][f] = fmaf(g[r], s, n[r][f]);
          }
        }
      }
    }
  }
}

// One chunk of mode n for every output tile the thread owns (tiles ot,
// ot + tps, ...). A single tile's partial stays in registers across the
// mode's chunks; several tiles' partials live in the exchange buffer and
// pass through the same registers one tile at a time.
template <bool OT, bool IT, int RO, int RI>
static __device__ __forceinline__ void run_chunk(PairThread<RO, RI>& p, int kind,
                                                 bool first_chunk, const Geometry& gm,
                                                 int tps, int tpd, const Chunk& k) {
  const bool held = gm.single || kind == 2;
  for (int o = p.ot; o < gm.nt; o += tps) {
    const int V = o / gm.nf, F = o - V * gm.nf;
    float* slot = p.xb + (o * tpd + p.dp) * gm.tts;
    if (!held) {
#pragma unroll
      for (int v = 0; v < RO; ++v)
#pragma unroll
        for (int f = 0; f < RI; ++f) p.n[v][f] = first_chunk ? 0.f : slot[v * RI + f];
    }
    tile_mode<OT, IT, RO, RI>(p.n, p.y, kind, V, F, gm, p.C, k);
    if (!held) {
#pragma unroll
      for (int v = 0; v < RO; ++v)
#pragma unroll
        for (int f = 0; f < RI; ++f) slot[v * RI + f] = p.n[v][f];
    }
  }
}

// The end of a first or interior mode: the partial tiles summed in d-part
// order into the pair's carry, masked to the true bonds (operator rows < R,
// input columns < F); CP x CP multiplies its carry by the sum. Every thread
// of the block calls it (it holds barriers where a pair has more than one
// thread; a pair of one thread is the only reader of its carry).
template <bool OT, bool IT, int RO, int RI>
static __device__ __forceinline__ void mode_end(PairThread<RO, RI>& p, int kind,
                                                const Geometry& gm, int R, int F, int tps,
                                                int tpd) {
  const bool hadamard = !OT && !IT && kind == 1, alone = tps * tpd == 1;
  if (gm.single && tpd > 1) {
    float* slot = p.xb + p.j * gm.tts;  // tile ot, d-part dp
#pragma unroll
    for (int v = 0; v < RO; ++v)
#pragma unroll
      for (int f = 0; f < RI; ++f) slot[v * RI + f] = p.n[v][f];
  }
  if (!alone) __syncthreads();  // every read of the carry and partial is done
  if (!gm.xbuf) {
    const int V = p.ot / gm.nf, F0 = p.ot - V * gm.nf;
#pragma unroll
    for (int v = 0; v < RO; ++v)
#pragma unroll
      for (int f = 0; f < RI; ++f) {
        const int row = V * RO + v, col = F0 * RI + f;
        float* c = p.C + row * gm.fp + col;
        const float s = p.n[v][f];
        *c = row < R && col < F ? (hadamard ? *c * s : s) : 0.f;
      }
  } else {
    const int tpp = tps * tpd;
    for (int e = p.j; e < gm.nt * RO * RI; e += tpp) {
      const int o = e / (RO * RI), i = e - o * (RO * RI), v = i / RI, f = i - v * RI;
      const int V = o / gm.nf, F0 = o - V * gm.nf;
      const int row = V * RO + v, col = F0 * RI + f;
      float s = 0.f;
      for (int q = 0; q < tpd; ++q) s += p.xb[(o * tpd + q) * gm.tts + i];
      float* c = p.C + row * gm.fp + col;
      *c = row < R && col < F ? (hadamard ? *c * s : s) : 0.f;
    }
  }
#pragma unroll
  for (int v = 0; v < RO; ++v)
#pragma unroll
    for (int f = 0; f < RI; ++f) p.n[v][f] = 0.f;
  if (!alone) __syncthreads();  // the carry is whole before the next mode reads it
}

// The end of the last mode: the partial outputs of the pair's threads
// summed in thread order (through the carry, which is read no more);
// returns y on thread 0 of the pair.
template <int RO, int RI>
static __device__ __forceinline__ float last_end(PairThread<RO, RI>& p, int tpp) {
  float y = p.y;
  if (tpp > 1) {
    __syncthreads();
    p.C[p.j] = p.y;
    __syncthreads();
    y = 0.f;
    if (p.j == 0)
      for (int q = 0; q < tpp; ++q) y += p.C[q];
  }
  return y;
}

// Sets up a thread's pair: its place in the pair and the pair's regions.
template <int RO, int RI>
static __device__ inline PairThread<RO, RI> pair_thread(const CarryTiles& t,
                                                        const Geometry& gm, float* carry,
                                                        float* xbuf, int pair) {
  PairThread<RO, RI> p;
  const int tpp = t.tps * t.tpd;
  p.j = threadIdx.x % tpp;
  p.ot = p.j / t.tpd;
  p.dp = p.j % t.tpd;
  p.C = carry + static_cast<size_t>(pair) * gm.cst;
  p.xb = xbuf + static_cast<size_t>(pair) * gm.nt * t.tpd * gm.tts;
  p.y = 0.f;
#pragma unroll
  for (int v = 0; v < RO; ++v)
#pragma unroll
    for (int f = 0; f < RI; ++f) p.n[v][f] = 0.f;
  return p;
}

// Writes NaN to the block's outputs (which every check refuses) when the
// layout outgrows the shared memory the launch allocated
// (struct/plan.py::carry_smem_bytes sizes it).
static __device__ bool layout_fits(size_t floats, const CarryArgs& a, int k0, int tk,
                                   int b0, int nb) {
  unsigned have;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
  if (floats * sizeof(float) <= have) return true;
  for (int e = threadIdx.x; e < tk * nb; e += blockDim.x) {
    const int kg = k0 + e % tk, bg = b0 + e / tk;
    if (kg < a.K && bg < a.B)
      a.y[static_cast<size_t>(bg) * a.K + kg] = __int_as_float(0x7fc00000);
  }
  return false;
}

static __device__ inline void zero_smem(float* smem, size_t floats) {
  for (size_t e = threadIdx.x; e < floats; e += blockDim.x) smem[e] = 0.f;
}

// K3. blockDim = tk * tb * tps * tpd (thread: pair = tid / tpp, k-row =
// pair % tk, item = pair / tk); grid = (ceil(B / tb), ceil(K / tk)). Two
// slots, each tk operator rows and tb input rows of one chunk; chunk i + 1
// is copied into one while chunk i computes from the other. Then the
// pairs' carries and (where partial tiles meet) the exchange buffer.
template <bool OT, bool IT, int RO, int RI>
__global__ void __launch_bounds__(CARRY_THREADS) carry_k3(CarryArgs a, CarryTiles t) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.order, tid = threadIdx.x, nt = blockDim.x;
  const int tpp = t.tps * t.tpd, pair = tid / tpp;
  const int kl = pair % t.tk, bl = pair / t.tk;
  const int k0 = blockIdx.y * t.tk, b0 = blockIdx.x * t.tb;
  const Geometry gm = geometry(a, t);
  // mode n's chunks: d chunks of dc values, each in nuc[n] row chunks
  int ostr = 0, istr = 0, nch[CARRY_MAX_ORDER], nuc[CARRY_MAX_ORDER], total = 0;
  for (int n = 0; n < N; ++n) {
    const int L = min(t.dc, a.dims[n]);
    ostr = max(ostr, op_stride(a, gm, n, L, u_chunked(a, n) ? t.uc : a.R));
    istr = max(istr, in_stride(a, t, gm, n, L));
    nuc[n] = u_chunked(a, n) ? (a.R + t.uc - 1) / t.uc : 1;
    nch[n] = (a.dims[n] + L - 1) / L * nuc[n];
    total += nch[n];
  }
  const size_t op_f = up4(static_cast<long long>(t.tk) * ostr);
  const size_t slot_f = op_f + up4(static_cast<long long>(t.tb) * istr);
  const int pairs = t.tk * t.tb;
  float* carry = smem + 2 * slot_f;
  float* xbuf = carry + up4(static_cast<long long>(pairs) * gm.cst);
  const size_t floats = 2 * slot_f + pair_floats(gm, t, pairs);
  if (!layout_fits(floats, a, k0, t.tk, b0, t.tb)) return;
  zero_smem(smem, floats);
  __syncthreads();
  PairThread<RO, RI> p = pair_thread<RO, RI>(t, gm, carry, xbuf, pair);

  // chunk c of mode n: d values [d0, d0 + dlen), operator rows [u0, u0 + ua)
  auto chunk = [&](int n, int c, int& d0, int& dlen, int& u0, int& ua) {
    const int D = a.dims[n], L = min(t.dc, D), dci = c / nuc[n];
    const RowShape os = op_shape(a, gm, n);
    d0 = dci * L;
    dlen = min(L, D - d0);
    u0 = (c - dci * nuc[n]) * t.uc;  // 0 where nuc[n] = 1
    ua = u_chunked(a, n) ? min(t.uc, os.a - u0) : os.a;
  };
  auto stage = [&](int n, int c, int slot) {
    const int D = a.dims[n], L = min(t.dc, D);
    int d0, dlen, u0, ua;
    chunk(n, c, d0, dlen, u0, ua);
    const RowShape os = op_shape(a, gm, n);
    float* base = smem + slot * slot_f;
    stage_rows(base, ostr, a.op[n], k0, t.tk, a.K, os.a, u0, ua, D, os.c, L, d0, dlen, tid,
               nt);
    const int ia = in_a(a, n);
    stage_rows(base + op_f, istr, a.in[n], b0, t.tb, a.B, ia, 0, ia, D, in_c(a, n), L, d0,
               dlen, tid, nt);
    cp_async_commit();
  };
  stage(0, 0, 0);
  int n = 0, c = 0;
  for (int i = 0; i < total; ++i) {
    const int nn = c + 1 < nch[n] ? n : n + 1, cn = c + 1 < nch[n] ? c + 1 : 0;
    if (i + 1 < total) stage(nn, cn, (i + 1) & 1);
    else cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int L = min(t.dc, a.dims[n]);
    const int kind = n == 0 ? 0 : n == N - 1 ? 2 : 1;
    const float* base = smem + (i & 1) * slot_f;
    const RowShape os = op_shape(a, gm, n);
    int d0, dlen, u0, ua;
    chunk(n, c, d0, dlen, u0, ua);
    const Chunk ch{base + kl * ostr, base + op_f + bl * istr, os.a, os.c, in_a(a, n),
                   in_c(a, n), L, dlen, p.dp, t.tpd, u0, ua};
    run_chunk<OT, IT, RO, RI>(p, kind, c == 0, gm, t.tps, t.tpd, ch);
    if (c + 1 == nch[n]) {
      if (kind < 2) {
        mode_end<OT, IT, RO, RI>(p, kind, gm, a.R, a.rin[n + 1], t.tps, t.tpd);
      } else {
        const float y = last_end<RO, RI>(p, tpp);
        const int kk = k0 + kl, bb = b0 + bl;
        if (p.j == 0 && kk < a.K && bb < a.B)
          a.y[static_cast<size_t>(bb) * a.K + kk] = y * a.scale;
      }
    }
    __syncthreads();  // slot i & 1 consumed before chunk i + 2 refills it
    n = nn;
    c = cn;
  }
}

// K6. blockDim = tk * tb * tps * tpd; grid = (ceil(K / tk),). The block's
// k-rows of every operator core stay resident; batch tile i (tb items,
// every input core) is in slot i % 2, and tile i + 1 is copied into the
// other slot while tile i's carries run.
template <bool OT, bool IT, int RO, int RI>
__global__ void __launch_bounds__(CARRY_THREADS) carry_k6(CarryArgs a, CarryTiles t) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.order, tid = threadIdx.x, nt = blockDim.x;
  const int tpp = t.tps * t.tpd, pair = tid / tpp;
  const int kl = pair % t.tk, bl = pair / t.tk;
  const int k0 = blockIdx.x * t.tk;
  const Geometry gm = geometry(a, t);
  int ostr[CARRY_MAX_ORDER], istr[CARRY_MAX_ORDER];
  size_t op_off[CARRY_MAX_ORDER + 1], in_off[CARRY_MAX_ORDER + 1];
  op_off[0] = in_off[0] = 0;
  for (int n = 0; n < N; ++n) {
    ostr[n] = op_stride(a, gm, n, a.dims[n], a.R);
    istr[n] = in_stride(a, t, gm, n, a.dims[n]);
    op_off[n + 1] = op_off[n] + up4(static_cast<long long>(t.tk) * ostr[n]);
    in_off[n + 1] = in_off[n] + up4(static_cast<long long>(t.tb) * istr[n]);
  }
  const size_t slot_f = in_off[N];
  const int pairs = t.tk * t.tb;
  float* ins = smem + op_off[N];
  float* carry = ins + 2 * slot_f;
  float* xbuf = carry + up4(static_cast<long long>(pairs) * gm.cst);
  const size_t floats = op_off[N] + 2 * slot_f + pair_floats(gm, t, pairs);
  if (!layout_fits(floats, a, k0, t.tk, 0, a.B)) return;
  zero_smem(smem, floats);
  __syncthreads();

  for (int n = 0; n < N; ++n) {  // committed with batch tile 0's group
    const RowShape os = op_shape(a, gm, n);
    stage_rows(smem + op_off[n], ostr[n], a.op[n], k0, t.tk, a.K, os.a, 0, os.a, a.dims[n],
               os.c, a.dims[n], 0, a.dims[n], tid, nt);
  }
  const int nbt = (a.B + t.tb - 1) / t.tb;
  auto stage = [&](int i, int slot) {
    for (int n = 0; n < N; ++n)
      stage_rows(ins + slot * slot_f + in_off[n], istr[n], a.in[n], i * t.tb, t.tb, a.B,
                 in_a(a, n), 0, in_a(a, n), a.dims[n], in_c(a, n), a.dims[n], 0, a.dims[n],
                 tid, nt);
    cp_async_commit();
  };
  stage(0, 0);
  for (int i = 0; i < nbt; ++i) {
    if (i + 1 < nbt) stage(i + 1, (i + 1) & 1);
    else cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    PairThread<RO, RI> p = pair_thread<RO, RI>(t, gm, carry, xbuf, pair);
    const float* slot = ins + (i & 1) * slot_f;
    for (int n = 0; n < N; ++n) {
      const int D = a.dims[n], kind = n == 0 ? 0 : n == N - 1 ? 2 : 1;
      const RowShape os = op_shape(a, gm, n);
      const Chunk ch{smem + op_off[n] + kl * ostr[n], slot + in_off[n] + bl * istr[n],
                     os.a, os.c, in_a(a, n), in_c(a, n), D, D, p.dp, t.tpd, 0, os.a};
      run_chunk<OT, IT, RO, RI>(p, kind, true, gm, t.tps, t.tpd, ch);
      if (kind < 2) {
        mode_end<OT, IT, RO, RI>(p, kind, gm, a.R, a.rin[n + 1], t.tps, t.tpd);
      } else {
        const float y = last_end<RO, RI>(p, tpp);
        const int kk = k0 + kl, bb = i * t.tb + bl;
        if (p.j == 0 && kk < a.K && bb < a.B)
          a.y[static_cast<size_t>(bb) * a.K + kk] = y * a.scale;
      }
    }
    __syncthreads();  // slot i & 1 consumed before tile i + 2 refills it
  }
}

template <bool OT, bool IT, int RO, int RI>
static cudaError_t launch_tile(bool pipelined, const CarryArgs& a, const CarryTiles& t,
                               cudaStream_t s) {
  const void* fn = pipelined ? reinterpret_cast<const void*>(carry_k6<OT, IT, RO, RI>)
                             : reinterpret_cast<const void*>(carry_k3<OT, IT, RO, RI>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = t.tk * t.tb * t.tps * t.tpd;
  const size_t smem = static_cast<size_t>(t.smem_bytes);
  if (pipelined) {
    carry_k6<OT, IT, RO, RI><<<(a.K + t.tk - 1) / t.tk, threads, smem, s>>>(a, t);
  } else {
    dim3 grid((a.B + t.tb - 1) / t.tb, (a.K + t.tk - 1) / t.tk);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    carry_k3<OT, IT, RO, RI><<<grid, threads, smem, s>>>(a, t);
  }
  return cudaGetLastError();
}

template <bool OT, bool IT>
static cudaError_t dispatch(bool pipelined, const CarryArgs& a, const CarryTiles& t,
                            cudaStream_t s) {
#define CARRY_TRY(RO, RI) \
  if (t.ro == RO && t.ri == RI) return launch_tile<OT, IT, RO, RI>(pipelined, a, t, s);
  CARRY_TILES(CARRY_TRY)
#undef CARRY_TRY
  return cudaErrorInvalidValue;  // a register tile not compiled
}

static bool fill_args(CarryArgs& a, const void* const* op, const void* const* in, void* y,
                      const int* dims, const int* codes, const int* rin, int order,
                      int B, int K, int R, int op_tt, int in_tt, float scale) {
  if (order < 2 || order > CARRY_MAX_ORDER || R < 1 || B < 1 || K < 1) return false;
  a.order = order; a.B = B; a.K = K; a.R = R; a.op_tt = op_tt; a.in_tt = in_tt;
  a.scale = scale;
  a.y = static_cast<float*>(y);
  // the opcodes must be the program of this pairing: FIRST, MIX..., LAST
  const int mix = op_tt ? (in_tt ? C_MIX_TT_TT : C_MIX_TT_CP)
                        : (in_tt ? C_MIX_CP_TT : C_MIX_CP_CP);
  for (int n = 0; n < order; ++n) {
    const int want = n == 0 ? C_FIRST : n == order - 1 ? mix + 4 : mix;
    if (codes[n] != want || dims[n] < 1) return false;
    a.op[n] = static_cast<const float*>(op[n]);
    a.in[n] = static_cast<const float*>(in[n]);
    a.dims[n] = dims[n];
    a.codes[n] = codes[n];
  }
  for (int n = 0; n <= order; ++n) {
    if (rin[n] < 1) return false;
    a.rin[n] = rin[n];
  }
  return !in_tt || (rin[0] == 1 && rin[order] == 1);
}

// The planner's tiles must describe a block this source runs: at most
// CARRY_THREADS threads, no more tile threads than a pair has tiles, and
// every input bond within the planned rank.
static bool tiles_ok(const CarryArgs& a, const CarryTiles& t) {
  if (t.tk < 1 || t.tb < 1 || t.tps < 1 || t.tpd < 1 || t.dc < 1 || t.ro < 1 ||
      t.ri < 1 || t.uc < 1 || t.uc % t.ro != 0 || t.smem_bytes < 1)
    return false;
  if (t.tk * t.tb * t.tps * t.tpd > CARRY_THREADS) return false;
  const int nt = ((a.R + t.ro - 1) / t.ro) * ((t.rin_max + t.ri - 1) / t.ri);
  if (t.tps > nt) return false;
  for (int n = 0; n <= a.order; ++n)
    if (a.rin[n] > t.rin_max) return false;
  return true;
}

static int launch(bool pipelined, const void* const* op, const void* const* in, void* y,
                  const int* dims, const int* codes, const int* rin, const int* tiles,
                  int order, int B, int K, int R, int op_tt, int in_tt, float scale,
                  void* stream) {
  CarryArgs a{};
  const CarryTiles t{tiles[0], tiles[1], tiles[2], tiles[3], tiles[4],
                     tiles[5], tiles[6], tiles[7], tiles[8], tiles[9]};
  if (!fill_args(a, op, in, y, dims, codes, rin, order, B, K, R, op_tt, in_tt, scale) ||
      !tiles_ok(a, t))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op_tt) err = in_tt ? dispatch<true, true>(pipelined, a, t, s)
                         : dispatch<true, false>(pipelined, a, t, s);
  else err = in_tt ? dispatch<false, true>(pipelined, a, t, s)
                   : dispatch<false, false>(pipelined, a, t, s);
  return static_cast<int>(err);
}

// op, in: MAX_ORDER pointers; dims, codes: per mode; rin: order+1 input
// bonds; tiles: tk, tb, tps, tpd, dc, uc, ro, ri, r_in, smem_bytes (the
// planner's CarryPlan).
extern "C" int carry_sweep_project_launch(const void* const* op, const void* const* in,
                                          void* y, const int* dims, const int* codes,
                                          const int* rin, const int* tiles, int order,
                                          int B, int K, int R, int op_tt, int in_tt,
                                          float scale, void* stream) {
  return launch(false, op, in, y, dims, codes, rin, tiles, order, B, K, R, op_tt, in_tt,
                scale, stream);
}

extern "C" int carry_sweep_project_pipelined_launch(
    const void* const* op, const void* const* in, void* y, const int* dims,
    const int* codes, const int* rin, const int* tiles, int order, int B, int K, int R,
    int op_tt, int in_tt, float scale, void* stream) {
  return launch(true, op, in, y, dims, codes, rin, tiles, order, B, K, R, op_tt, in_tt,
                scale, stream);
}
