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
// 2*d*R*R~*(R + R~) flops (tt x tt) on d*R*R + d*R~*R~ core floats read
// from shared memory, so it is bound by instruction issue (FMAs and shared
// loads) of tiny contractions, not by device memory. Design answers, kept
// simple:
//  * Work per thread: one (item, k-row) pair per WARP, its lanes over the
//    entries of the carry (R*R~: 20 for TT(5) x 4, 100 for CP(25) x 4), so a
//    B=8 tick at k=512 still runs 4,096 warps. A CP operator never mixes its
//    r channel until the last mode, so (r, p) entries are independent lanes.
//  * No mode-axis temp: the program's temp keeps the mode axis d (bkedv,
//    bkrdf). Here the two steps of a mode are fused over d: for TT x TT a
//    d-slice t_d = carry . g[:, d] (R~ x R floats) is formed and folded into
//    the successor at once; the other pairings need no temp at all. Only
//    the carry, its successor and one d-slice are live.
//  * Shared memory: K3 stages mode by mode its items' input core n (only the
//    carry crosses modes) and reads the operator cores through the L1/L2
//    caches: on an H100 SXM (700 W), staging them per mode as well was
//    slower at every serving shape (0.30 against 0.42 ms for CP(25) x CP(4)
//    at B=64, k=512, dims 64^3; PERF.md), since each block re-staged them
//    for a few items. K6 keeps all operator cores of its k-tile resident
//    and streams every input core of the next batch tile into a second slot
//    with cp.async while the current tile's carries run; the planner
//    refuses a shape whose k-tile operator cores outgrow shared memory.
//  * Ragged edges (k, B) are masked, not padded; input TT bond ranks are
//    per-bond runtime arguments (boundary 1, interior bucketed).
// All arithmetic is IEEE fp32 FMA.
#include <cuda_runtime.h>

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

// Per-k-row floats of operator core n and per-item floats of input core n.
static __device__ __host__ inline int op_elems(const CarryArgs& a, int n) {
  if (!a.op_tt) return a.dims[n] * a.R;
  const int rl = n == 0 ? 1 : a.R, rr = n == a.order - 1 ? 1 : a.R;
  return rl * a.dims[n] * rr;
}
static __device__ __host__ inline int in_elems(const CarryArgs& a, int n) {
  if (!a.in_tt) return a.dims[n] * a.rin[n];
  return a.rin[n] * a.dims[n] * a.rin[n + 1];
}
static __device__ __host__ inline int max_rin(const CarryArgs& a) {
  int m = 1;
  for (int n = 0; n <= a.order; ++n) m = a.rin[n] > m ? a.rin[n] : m;
  return m;
}
// Floats of one warp's carry region: carry, successor, TT x TT d-slice.
static __device__ __host__ inline int warp_floats(const CarryArgs& a) {
  const int cm = a.R * max_rin(a);
  return 2 * cm + (a.op_tt && a.in_tt ? cm : 0);
}
static __device__ __host__ inline long long up4(long long n) {
  return (n + 3) / 4 * 4;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One mode of the carry program for one (item, k-row) pair, run by one warp.
// G: the k-row's operator core n (K3: device memory; K6: shared memory),
// X: the item's input core n (shared memory), c: the carry entering mode n
// (R x E), out: the carry leaving it (R x F), t: the TT x TT d-slice.
// Returns y (all lanes) for a LAST opcode.
static __device__ float warp_mode(int code, const float* G, const float* X, int D,
                                  int R, int E, int F, const float* c, float* out,
                                  float* t, int lane) {
  float y = 0.f;
  switch (code) {
    case C_FIRST:  // G [D][R], X [D][F]
      for (int j = lane; j < R * F; j += 32) {
        const int r = j / F, f = j - r * F;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(G[d * R + r], X[d * F + f], s);
        out[j] = s;
      }
      break;
    case C_MIX_TT_TT:  // c [U][E], G [U][D][V], X [E][D][F], t [E][V]
      for (int j = lane; j < R * F; j += 32) out[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        __syncwarp();
        for (int j = lane; j < E * R; j += 32) {
          const int e = j / R, v = j - e * R;
          float s = 0.f;
          for (int u = 0; u < R; ++u) s = fmaf(c[u * E + e], G[(u * D + d) * R + v], s);
          t[j] = s;
        }
        __syncwarp();
        for (int j = lane; j < R * F; j += 32) {
          const int v = j / F, f = j - v * F;
          float s = out[j];
          for (int e = 0; e < E; ++e) s = fmaf(t[e * R + v], X[(e * D + d) * F + f], s);
          out[j] = s;
        }
      }
      break;
    case C_MIX_TT_CP:  // c [U][P], G [U][D][V], X [D][P]
      for (int j = lane; j < R * F; j += 32) {
        const int v = j / F, p = j - v * F;
        float s = 0.f;
        for (int d = 0; d < D; ++d) {
          float tv = 0.f;
          for (int u = 0; u < R; ++u) tv = fmaf(c[u * F + p], G[(u * D + d) * R + v], tv);
          s = fmaf(tv, X[d * F + p], s);
        }
        out[j] = s;
      }
      break;
    case C_MIX_CP_TT:  // c [R][E], X [E][D][F], G [D][R]
      for (int j = lane; j < R * F; j += 32) {
        const int r = j / F, f = j - r * F;
        float s = 0.f;
        for (int d = 0; d < D; ++d) {
          float tv = 0.f;
          for (int e = 0; e < E; ++e) tv = fmaf(c[r * E + e], X[(e * D + d) * F + f], tv);
          s = fmaf(tv, G[d * R + r], s);
        }
        out[j] = s;
      }
      break;
    case C_MIX_CP_CP:  // c [R][P], G [D][R], X [D][P]
      for (int j = lane; j < R * F; j += 32) {
        const int r = j / F, p = j - r * F;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(G[d * R + r], X[d * F + p], s);
        out[j] = c[j] * s;
      }
      break;
    case C_LAST_TT_TT:  // c [U][E], G [U][D], X [E][D]; lanes over d
      for (int d = lane; d < D; d += 32)
        for (int e = 0; e < E; ++e) {
          float tv = 0.f;
          for (int u = 0; u < R; ++u) tv = fmaf(c[u * E + e], G[u * D + d], tv);
          y = fmaf(tv, X[e * D + d], y);
        }
      y = warp_sum(y);
      break;
    case C_LAST_TT_CP:  // c [U][P], G [U][D], X [D][P]
      for (int d = lane; d < D; d += 32)
        for (int p = 0; p < E; ++p) {
          float tv = 0.f;
          for (int u = 0; u < R; ++u) tv = fmaf(c[u * E + p], G[u * D + d], tv);
          y = fmaf(tv, X[d * E + p], y);
        }
      y = warp_sum(y);
      break;
    case C_LAST_CP_TT:  // c [R][E], X [E][D], G [D][R]
      for (int d = lane; d < D; d += 32)
        for (int r = 0; r < R; ++r) {
          float tv = 0.f;
          for (int e = 0; e < E; ++e) tv = fmaf(c[r * E + e], X[e * D + d], tv);
          y = fmaf(tv, G[d * R + r], y);
        }
      y = warp_sum(y);
      break;
    default:  // C_LAST_CP_CP: c [R][P], G [D][R], X [D][P]; lanes over (r, p)
      for (int j = lane; j < R * E; j += 32) {
        const int r = j / E, p = j - r * E;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(G[d * R + r], X[d * E + p], s);
        y = fmaf(c[j], s, y);
      }
      y = warp_sum(y);
      break;
  }
  __syncwarp();
  return y;
}

// One 4-byte asynchronous copy global -> shared; zero-fills dst when !valid.
static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}

// Writes NaN to the block's outputs (which every check refuses) when the
// layout with this launch's ranks outgrows the shared memory the planner
// sized (struct/plan.py::carry_smem_bytes).
static __device__ bool layout_fits(const float* end, const float* smem, const CarryArgs& a,
                                   int k0, int tk, int b0, int nb) {
  unsigned have;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
  if (static_cast<size_t>(end - smem) * sizeof(float) <= have) return true;
  for (int e = threadIdx.x; e < tk * nb; e += blockDim.x) {
    const int kg = k0 + e % tk, bg = b0 + e / tk;
    if (kg < a.K && bg < a.B)
      a.y[static_cast<size_t>(bg) * a.K + kg] = __int_as_float(0x7fc00000);
  }
  return false;
}

// K3. blockDim = 32 * tk * tb (warp w: k-row w % tk, item w / tk);
// grid = (ceil(B / tb), ceil(K / tk)): the batch on x, which has room for
// any batch (y stops at 65,535 blocks). Mode by mode, the block stages its
// items' input core n, then each warp runs mode n on its carry, reading its
// k-row of operator core n from device memory.
__global__ void carry_sweep_kernel(CarryArgs a, int tk, int tb) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.order, R = a.R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = warp % tk, bl = warp / tk;
  const int k0 = blockIdx.y * tk, b0 = blockIdx.x * tb;
  const int kk = k0 + kl, bb = b0 + bl;
  const bool valid = kk < a.K && bb < a.B;
  int in_max = 0;
  for (int n = 0; n < N; ++n) in_max = max(in_max, in_elems(a, n));
  const int wf = warp_floats(a), cm = R * max_rin(a);
  float* ins = smem;                                          // [tb][in_max]
  float* cbase = ins + up4(static_cast<long long>(tb) * in_max);
  float* end = cbase + up4(static_cast<long long>(tk) * tb * wf);
  if (!layout_fits(end, smem, a, k0, tk, b0, tb)) return;
  float* cur = cbase + warp * wf;
  float* nxt = cur + cm;
  float* tmp = cur + 2 * cm;
  float y = 0.f;
  for (int n = 0; n < N; ++n) {
    const int oe = op_elems(a, n), ie = in_elems(a, n);
    __syncthreads();  // mode n-1 done with the staged cores
    for (int e = threadIdx.x; e < tb * ie; e += blockDim.x) {
      const int item = e / ie;
      ins[item * in_max + e - item * ie] =
          b0 + item < a.B ? a.in[n][static_cast<size_t>(b0) * ie + e] : 0.f;
    }
    __syncthreads();
    if (valid) {
      y = warp_mode(a.codes[n], a.op[n] + static_cast<size_t>(kk) * oe,
                    ins + bl * in_max, a.dims[n], R,
                    a.rin[n], a.rin[n + 1], cur, nxt, tmp, lane);
      float* sw = cur; cur = nxt; nxt = sw;
    }
  }
  if (valid && lane == 0) a.y[static_cast<size_t>(bb) * a.K + kk] = y * a.scale;
}

// K6. blockDim = 32 * tk * tb; grid = (ceil(K / tk),). The block's k-rows
// of every operator core stay resident; batch tile i (tb items, every input
// core) is in slot i % 2, and tile i+1 is copied into the other slot with
// cp.async while tile i's carries run.
__global__ void carry_sweep_pipelined_kernel(CarryArgs a, int tk, int tb) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.order, R = a.R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = warp % tk, bl = warp / tk;
  const int k0 = blockIdx.x * tk, kk = k0 + kl;
  int op_off[CARRY_MAX_ORDER + 1], in_off[CARRY_MAX_ORDER + 1];
  op_off[0] = in_off[0] = 0;
  for (int n = 0; n < N; ++n) {
    op_off[n + 1] = op_off[n] + op_elems(a, n);
    in_off[n + 1] = in_off[n] + in_elems(a, n);
  }
  const int op_sum = op_off[N], in_sum = in_off[N];
  const int wf = warp_floats(a), cm = R * max_rin(a);
  const long long slot_f = up4(static_cast<long long>(tb) * in_sum);
  float* ops = smem;                                          // per mode n: [tk][oe]
  float* ins = ops + up4(static_cast<long long>(tk) * op_sum);
  float* cbase = ins + 2 * slot_f;
  float* end = cbase + up4(static_cast<long long>(tk) * tb * wf);
  if (!layout_fits(end, smem, a, k0, tk, 0, a.B)) return;
  float* cur0 = cbase + warp * wf;

  // the k-tile's operator cores: copied once, with batch tile 0's group
  for (int n = 0; n < N; ++n) {
    const int oe = op_elems(a, n);
    for (int e = threadIdx.x; e < tk * oe; e += blockDim.x) {
      const bool ok = k0 + e / oe < a.K;
      cp_async4(ops + static_cast<long long>(tk) * op_off[n] + e,
                ok ? a.op[n] + static_cast<size_t>(k0) * oe + e : a.op[n], ok);
    }
  }
  const int nbt = (a.B + tb - 1) / tb;
  auto stage = [&](int i, int slot) {
    float* dst = ins + slot * slot_f;
    for (int n = 0; n < N; ++n) {
      const int ie = in_elems(a, n);
      const size_t first = static_cast<size_t>(i) * tb * ie;
      for (int e = threadIdx.x; e < tb * ie; e += blockDim.x) {
        const int item = e / ie;
        const bool ok = i * tb + item < a.B;
        cp_async4(dst + item * in_sum + in_off[n] + e - item * ie,
                  ok ? a.in[n] + first + e : a.in[n], ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0, 0);
  for (int i = 0; i < nbt; ++i) {
    const int slot = i & 1;
    if (i + 1 < nbt) stage(i + 1, slot ^ 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int bb = i * tb + bl;
    if (kk < a.K && bb < a.B) {
      const float* xin = ins + slot * slot_f + bl * in_sum;
      float* cur = cur0;
      float* nxt = cur0 + cm;
      float y = 0.f;
      for (int n = 0; n < N; ++n) {
        const int oe = op_elems(a, n);
        const float* G = ops + static_cast<long long>(tk) * op_off[n] + kl * oe;
        y = warp_mode(a.codes[n], G, xin + in_off[n], a.dims[n], R, a.rin[n], a.rin[n + 1], cur, nxt,
                      cur0 + 2 * cm, lane);
        float* sw = cur; cur = nxt; nxt = sw;
      }
      if (lane == 0) a.y[static_cast<size_t>(bb) * a.K + kk] = y * a.scale;
    }
    __syncthreads();  // slot consumed before tile i+2 refills it
  }
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

static cudaError_t launch(bool pipelined, const CarryArgs& a, int tk, int tb,
                          int smem_bytes, void* stream) {
  if (tk < 1 || tb < 1 || tk * tb > 32 || smem_bytes < 1) return cudaErrorInvalidValue;
  const void* fn = pipelined ? reinterpret_cast<const void*>(carry_sweep_pipelined_kernel)
                             : reinterpret_cast<const void*>(carry_sweep_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (pipelined) {
    dim3 grid((a.K + tk - 1) / tk);
    carry_sweep_pipelined_kernel<<<grid, 32 * tk * tb, smem, s>>>(a, tk, tb);
  } else {
    dim3 grid((a.B + tb - 1) / tb, (a.K + tk - 1) / tk);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    carry_sweep_kernel<<<grid, 32 * tk * tb, smem, s>>>(a, tk, tb);
  }
  return cudaGetLastError();
}

// op, in: MAX_ORDER pointers; dims, codes: per mode; rin: order+1 input
// bonds; tk, tb, smem_bytes: the planner's CarryPlan.
extern "C" int carry_sweep_project_launch(const void* const* op, const void* const* in,
                                          void* y, const int* dims, const int* codes,
                                          const int* rin, int order, int B, int K, int R,
                                          int op_tt, int in_tt, int tk, int tb,
                                          int smem_bytes, float scale, void* stream) {
  CarryArgs a{};
  if (!fill_args(a, op, in, y, dims, codes, rin, order, B, K, R, op_tt, in_tt, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(false, a, tk, tb, smem_bytes, stream));
}

extern "C" int carry_sweep_project_pipelined_launch(
    const void* const* op, const void* const* in, void* y, const int* dims,
    const int* codes, const int* rin, int order, int B, int K, int R, int op_tt,
    int in_tt, int tk, int tb, int smem_bytes, float scale, void* stream) {
  CarryArgs a{};
  if (!fill_args(a, op, in, y, dims, codes, rin, order, B, K, R, op_tt, in_tt, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(true, a, tk, tb, smem_bytes, stream));
}
