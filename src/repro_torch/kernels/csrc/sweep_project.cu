// K1: sweep_project — batched dense-input TT/CP projection for orders 2..8,
//   y[n,i] = scale * < S_i, X_n >,  S_i the i-th TT/CP row tensor.
//
// Replaces the Pallas TPU kernel repro/kernels/_sweep.py::sweep_project
// (_project_kernel). The computation is the planner's einsum program
// (repro_torch/kernels/ops.py::_project_steps), lowered to one opcode per
// step: the rightmost mode is contracted first and the TT bond / CP rank is
// carried between steps. The program is evaluated depth-first: for each
// prefix (i_1, ..., i_{N-1}) of the input the first step gives the bond
// vector z (R floats per batch row), which is folded into the next step's
// accumulator at once; a level's accumulator is folded one step further
// when its mode's index wraps. Every level thus holds one R-vector instead
// of the whole (B, k, d1..d_{N-1}, R) intermediate, and the sum over d1 —
// which the TPU grid carried across grid steps in the revisited output
// block — is a loop inside the block: a block owns a (tk k-rows x tb batch
// rows) output tile, its tg thread groups share the d1 loop (group g takes
// every tg-th leading index), and the block sums the groups' partials in
// shared memory and writes its tile once with the 1/sqrt(k) scale fused.
//
// What bounds it on an H100: the first step does 2*B*k*R*prod(dims) flops on
// B*prod(dims) input floats, far above the card's fp32 flops-per-byte ratio,
// so the kernel is bound by fp32 FMA issue, not memory. Its design answer,
// kept simple: the block's k-rows of the last core sit in shared memory
// (padded rows, conflict-free across k), each thread keeps a TBT x RCH
// register tile so one shared load of the input feeds RCH FMAs and one of
// the core feeds TBT, and all arithmetic is IEEE fp32 FMA (no TF32). Its
// parallelism: B*k/TBT (batch, k) thread slots are too few to fill the card
// at small B, so the planner adds thread groups along d1 until a call has
// about 1024 threads per SM (or shared memory runs out).
//
// K5: sweep_project_pipelined — the same function and the same device sweep
// code (PIPE = true below). Replaces repro/kernels/_sweep.py::
// sweep_project_pipelined (_project_pipelined_kernel), which moved the d1
// axis inside the kernel and double-buffered the input block and the
// leading-core tile with explicit DMAs. K1 already loops over d1 inside
// the block, but stages each chunk of input rows with plain loads between
// two barriers, so the block idles while the chunk arrives. K5 keeps two
// slots of the staged input and of the block's (tk, tg, R) leading-core
// tile, and issues the cp.async copies of chunk i+1 into the other slot
// before it contracts chunk i: the copies overlap the FMAs. What bounds it
// is what bounds K1 (fp32 FMA issue); the second slots cost shared memory,
// which the planner charges (ops.py::project_smem_bytes), so it may run
// fewer thread groups than K1 at the same shape.
#include <cstdint>

#include "sweep_common.cuh"

#define TBT 4   // batch rows per thread (ops.py: TBT)
#define XPAD 4  // floats between thread groups' input slabs (ops.py)

struct ProjectArgs {
  const float* x;                        // (B, d1, ..., dN)
  float* y;                              // (B, K)
  const float* core[SWEEP_MAX_ORDER];    // squeezed TT cores / CP factors
  int dims[SWEEP_MAX_ORDER];
  int ops[SWEEP_MAX_ORDER];              // ops[s]: opcode of step s
  int order, B, K, R, ba;
  long long n_prefix;                    // prod(d1..d_{N-1})
  float scale;
};

static __device__ inline long long up4(long long n) {
  return (n + 3) / 4 * 4;
}

// One 4-byte asynchronous copy global -> shared; zero-fills dst when !valid
// (src-size 0 reads nothing, but src must still be a mapped address).
static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A core element: through the read-only cache from device memory (GLOBAL),
// or a plain load from K5's staged leading-core tile in shared memory.
template <bool GLOBAL>
static __device__ __forceinline__ float ld_core(const float* p) {
  if (GLOBAL) return __ldg(p);
  return *p;
}

// Fold one level's accumulator (R x TBT, per-thread strided in shared
// memory) through step `op` with the core's slice at mode index `idx`.
template <bool GLOBAL>
static __device__ __forceinline__ void fold(int op, const float* __restrict__ core,
                                            int d, int idx, int kk, int R,
                                            const float* src, float* dst,
                                            float* yv, int stride) {
  if (op == OP_MIX_TT) {
    for (int v = 0; v < R; ++v) {
      const float* g = core + ((static_cast<size_t>(kk) * R + v) * d + idx) * R;
      float s[TBT] = {};
      for (int u = 0; u < R; ++u) {
        const float w = ld_core<GLOBAL>(g + u);
#pragma unroll
        for (int t = 0; t < TBT; ++t) s[t] = fmaf(src[(u * TBT + t) * stride], w, s[t]);
      }
#pragma unroll
      for (int t = 0; t < TBT; ++t) dst[(v * TBT + t) * stride] += s[t];
    }
  } else if (op == OP_HAD_CP) {
    const float* g = core + (static_cast<size_t>(kk) * d + idx) * R;
    for (int u = 0; u < R; ++u) {
      const float w = ld_core<GLOBAL>(g + u);
#pragma unroll
      for (int t = 0; t < TBT; ++t)
        dst[(u * TBT + t) * stride] = fmaf(src[(u * TBT + t) * stride], w,
                                           dst[(u * TBT + t) * stride]);
    }
  } else {  // OP_LAST
    const float* g = core + (static_cast<size_t>(kk) * d + idx) * R;
    for (int u = 0; u < R; ++u) {
      const float w = ld_core<GLOBAL>(g + u);
#pragma unroll
      for (int t = 0; t < TBT; ++t) yv[t] = fmaf(src[(u * TBT + t) * stride], w, yv[t]);
    }
  }
}

// The same fold for bond rows u0..u0+RCH of the first level, held in
// registers (z) instead of shared memory.
template <int RCH, bool GLOBAL>
static __device__ __forceinline__ void fold_regs(int op, const float* __restrict__ core,
                                                 int d, int idx, int kk, int R, int u0,
                                                 const float (&z)[TBT][RCH], float* dst,
                                                 float* yv, int stride) {
  if (op == OP_MIX_TT) {
    for (int v = 0; v < R; ++v) {
      const float* g = core + ((static_cast<size_t>(kk) * R + v) * d + idx) * R + u0;
      float s[TBT] = {};
#pragma unroll
      for (int u = 0; u < RCH; ++u) {
        const float w = (u0 + u < R) ? ld_core<GLOBAL>(g + u) : 0.f;
#pragma unroll
        for (int t = 0; t < TBT; ++t) s[t] = fmaf(z[t][u], w, s[t]);
      }
#pragma unroll
      for (int t = 0; t < TBT; ++t) dst[(v * TBT + t) * stride] += s[t];
    }
  } else {
    const float* g = core + (static_cast<size_t>(kk) * d + idx) * R + u0;
#pragma unroll
    for (int u = 0; u < RCH; ++u) {
      if (u0 + u < R) {
        const float w = ld_core<GLOBAL>(g + u);
#pragma unroll
        for (int t = 0; t < TBT; ++t) {
          if (op == OP_HAD_CP) {
            float* a = dst + ((u0 + u) * TBT + t) * stride;
            *a = fmaf(z[t][u], w, *a);
          } else {  // OP_LAST
            yv[t] = fmaf(z[t][u], w, yv[t]);
          }
        }
      }
    }
  }
}

// blockDim = (tb / TBT threads along the batch, tk threads along k, tg
// thread groups along d1); grid = (ceil(K / tk), ceil(B / tb)). Group g
// takes the leading indices g, g + tg, ...; the groups' partial outputs are
// summed in shared memory before the block writes its tile once.
// RCH: bond rows per register tile. PIPE: K5's double-buffered schedule.
template <int RCH, bool PIPE>
__global__ void sweep_project_kernel(ProjectArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.order, R = a.R, dN = a.dims[N - 1], d1 = a.dims[0];
  const int ntb = blockDim.x, TK = blockDim.y, TG = blockDim.z, TB = ntb * TBT;
  const int tn = threadIdx.x, tkl = threadIdx.y, grp = threadIdx.z;
  const int ngrp = ntb * TK;                      // threads per group
  const int tig = tkl * ntb + tn;                 // thread in group
  const int tid = grp * ngrp + tig, nthr = ngrp * TG;
  const int k0 = blockIdx.x * TK, b0 = blockIdx.y * TB;
  const int kk = k0 + tkl;
  const bool kval = kk < a.K;
  const int gstride = R * dN + 1;
  const int xstride = a.ba * dN * TB + XPAD;      // per group, padded
                                                  // against bank conflicts
  const long long xslot = up4(static_cast<long long>(TG) * xstride);
  const long long cslot = up4(static_cast<long long>(TK) * TG * R);
  float* gs = smem;                                         // [TK][R*dN (+1)]
  float* xs = gs + up4(static_cast<long long>(TK) * gstride);   // [TG][ba][dN][TB]
  // K5: a second input slot, then two slots of the leading-core tile
  // cs[slot][TK][TG][R]
  float* cs = xs + (PIPE ? 2 : 1) * xslot;
  float* acc = cs + (PIPE ? 2 * cslot : 0);
  // acc: level l (1..N-2), bond u, row t of this thread at
  //      (((l-1)*R + u)*TBT + t)*nthr + tid
  float* yred = acc + up4(static_cast<long long>(N - 2) * R * TBT * nthr);
  // The launch sized shared memory by the planner's formula
  // (ops.py::project_smem_bytes); should this layout ever outgrow it, the
  // block writes NaN to its tile, which every check of the output refuses.
  unsigned smem_have;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(smem_have));
  if (static_cast<size_t>(yred + TBT * nthr - smem) * sizeof(float) > smem_have) {
    if (grp == 0 && kval)
      for (int t = 0; t < TBT; ++t) {
        const int n = b0 + tn * TBT + t;
        if (n < a.B) a.y[static_cast<size_t>(n) * a.K + kk] = __int_as_float(0x7fc00000);
      }
    return;
  }

  // Stage this block's k-rows of the last core as gs[row][u*dN + c].
  const float* gN = a.core[N - 1];
  const bool tt_first = a.ops[0] == OP_FIRST_TT;
  for (int e = tid; e < TK * R * dN; e += nthr) {
    const int row = e / (R * dN), rem = e - row * (R * dN);
    const int u = rem / dN, c = rem - u * dN;
    const int kg = k0 + row;
    float v = 0.f;
    if (kg < a.K)
      v = tt_first ? gN[(static_cast<size_t>(kg) * R + u) * dN + c]
                   : gN[(static_cast<size_t>(kg) * dN + c) * R + u];
    gs[row * gstride + rem] = v;
  }
  for (int e = 0; e < (N - 2) * R * TBT; ++e) acc[e * nthr + tid] = 0.f;

  float yv[TBT] = {};
  int digit[SWEEP_MAX_ORDER] = {};   // current prefix: indices of modes 0..N-2
  const float* gk = gs + tkl * gstride;
  const int lvl = R * TBT * nthr;    // floats per accumulator level
  const long long n_sub = a.n_prefix / d1;        // prod(d2..d_{N-1})

  // The block walks chunks i = (leading tile a0, prefix chunk p0), the
  // prefix chunks of one leading tile in order (the digits wrap to 0 at
  // the end of each leading tile).
  const long long n_p = (n_sub + a.ba - 1) / a.ba;
  const long long n_steps = (d1 + TG - 1) / TG * n_p;
  const float* g0 = a.core[0];
  // stage chunk i into `slot`: the input rows, and under PIPE the block's
  // leading-core tile, each as 4-byte cp.async copies; else plain loads
  auto stage = [&](long long i, int slot) {
    const int a0 = static_cast<int>(i / n_p) * TG;
    const long long p0 = (i % n_p) * a.ba;
    const int np = static_cast<int>(min(static_cast<long long>(a.ba), n_sub - p0));
    float* xd = xs + slot * xslot;
    for (int e = tid; e < TG * np * TB * dN; e += nthr) {
      const int c = e % dN, r1 = e / dN;
      const int nl = r1 % TB, r2 = r1 / TB;
      const int pp = r2 % np, g = r2 / np;
      const int n = b0 + nl, ag = a0 + g;
      const bool ok = n < a.B && ag < d1;
      const float* src =
          ok ? a.x + ((static_cast<size_t>(n) * d1 + ag) * n_sub + p0 + pp) * dN + c : a.x;
      float* dst = xd + g * xstride + (pp * dN + c) * TB + nl;
      if (PIPE) cp_async4(dst, src, ok);
      else *dst = ok ? *src : 0.f;
    }
    if (PIPE) {
      float* cd = cs + slot * cslot;
      for (int e = tid; e < TK * TG * R; e += nthr) {
        const int u = e % R, r1 = e / R;
        const int g = r1 % TG, row = r1 / TG;
        const int kg = k0 + row, ag = a0 + g;
        const bool ok = kg < a.K && ag < d1;
        cp_async4(cd + e, ok ? g0 + (static_cast<size_t>(kg) * d1 + ag) * R + u : g0, ok);
      }
      cp_async_commit();
    }
  };

  if (PIPE) stage(0, 0);
  for (long long i = 0; i < n_steps; ++i) {
    const int slot = PIPE ? static_cast<int>(i & 1) : 0;
    const int a0 = static_cast<int>(i / n_p) * TG;
    const long long p0 = (i % n_p) * a.ba;
    const int np = static_cast<int>(min(static_cast<long long>(a.ba), n_sub - p0));
    const int ia = a0 + grp;
    const bool aval = ia < d1;
    digit[0] = ia;
    if (PIPE) {
      // chunk i+1 streams into the other slot while chunk i contracts (an
      // empty group keeps the wait count right on the last chunk)
      if (i + 1 < n_steps) stage(i + 1, slot ^ 1);
      else cp_async_commit();
      cp_async_wait1();      // this thread's copies of chunk i have landed
      __syncthreads();       // ... and every other thread's
    } else {
      __syncthreads();       // previous chunk fully consumed
      stage(i, 0);
      __syncthreads();
    }
    // the leading core: K1 reads it from device memory at (kk, ia); K5 from
    // its staged tile, row tkl of TK, column grp of TG
    const float* lead = PIPE ? cs + slot * cslot : g0;
    const int lead_k = PIPE ? tkl : kk, lead_d = PIPE ? TG : d1,
              lead_i = PIPE ? grp : ia;
    if (kval && aval) {
      const float* xbase = xs + slot * xslot;
      for (int pp = 0; pp < np; ++pp) {
        const float* xp = xbase + grp * xstride + pp * dN * TB + tn * TBT;
        // step 0 contracts the last mode, RCH bond rows at a time; step 1
        // folds each chunk at once into level 1 (into y at order 2)
        for (int u0 = 0; u0 < R; u0 += RCH) {
          float z[TBT][RCH] = {};
#pragma unroll 4
          for (int c = 0; c < dN; ++c) {
            const float4 xv = *reinterpret_cast<const float4*>(xp + c * TB);
            const float xr[TBT] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int u = 0; u < RCH; ++u) {
              const float g = (u0 + u < R) ? gk[(u0 + u) * dN + c] : 0.f;
#pragma unroll
              for (int t = 0; t < TBT; ++t) z[t][u] = fmaf(xr[t], g, z[t][u]);
            }
          }
          if (N == 2)
            fold_regs<RCH, !PIPE>(a.ops[1], lead, lead_d, lead_i, lead_k, R, u0, z, acc + tid,
                           yv, nthr);
          else
            fold_regs<RCH, true>(a.ops[1], a.core[N - 2], a.dims[N - 2], digit[N - 2], kk, R,
                           u0, z, acc + tid, yv, nthr);
        }
        // steps 2..N-1: step s contracts mode m = N-1-s; level s-1 is
        // complete once mode m+1 wrapped, and folds into level s (y at s=N-1)
        for (int s = 2; s < N; ++s) {
          const int m = N - 1 - s;
          if (digit[m + 1] != a.dims[m + 1] - 1) break;
          float* src = acc + (s - 2) * lvl + tid;
          float* dst = s < N - 1 ? acc + (s - 1) * lvl + tid : nullptr;
          if (m == 0)
            fold<!PIPE>(a.ops[s], lead, lead_d, lead_i, lead_k, R, src, dst, yv, nthr);
          else
            fold<true>(a.ops[s], a.core[m], a.dims[m], digit[m], kk, R, src, dst, yv, nthr);
          for (int e = 0; e < R * TBT; ++e) src[e * nthr] = 0.f;
        }
        for (int m = N - 2; m >= 1; --m) {   // next prefix, last mode fastest
          if (++digit[m] < a.dims[m]) break;
          digit[m] = 0;
        }
      }
    }
    if (PIPE) __syncthreads();   // slot consumed before chunk i+2 refills it
  }
  // sum the groups' partial outputs, then write the tile once
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TBT; ++t) yred[tid * TBT + t] = yv[t];
  __syncthreads();
  if (grp != 0 || !kval) return;
#pragma unroll
  for (int t = 0; t < TBT; ++t) {
    float s = 0.f;
    for (int g = 0; g < TG; ++g) s += yred[(g * ngrp + tig) * TBT + t];
    const int n = b0 + tn * TBT + t;
    if (n < a.B) a.y[static_cast<size_t>(n) * a.K + kk] = s * a.scale;
  }
}

template <int RCH, bool PIPE>
static cudaError_t launch_rch(const ProjectArgs& a, int tk, int tb, int tg,
                              size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sweep_project_kernel<RCH, PIPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 block(tb / TBT, tk, tg);
  dim3 grid((a.K + tk - 1) / tk, (a.B + tb - 1) / tb);
  sweep_project_kernel<RCH, PIPE><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool PIPE>
static int project_launch(const void* x, void* y, const void* const* cores,
                          const int* dims, const int* ops, int order, int B, int K,
                          int R, int tk, int tb, int ba, int tg, int rch,
                          int smem_bytes, float scale, void* stream) {
  // smem_bytes: the planner's ContractionPlan.smem_bytes
  // (ops.py::project_smem_bytes), the size of the regions the kernel lays out
  if (order < 2 || order > SWEEP_MAX_ORDER || tb % TBT != 0 || rch < 1 || rch > 8 ||
      tg < 1 || (tb / TBT) * tk * tg > 1024 || smem_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ProjectArgs a{};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n_prefix = 1;
  for (int i = 0; i < order; ++i) {
    a.core[i] = static_cast<const float*>(cores[i]);
    a.dims[i] = dims[i];
    a.ops[i] = ops[i];
    if (i < order - 1) a.n_prefix *= dims[i];
  }
  a.order = order; a.B = B; a.K = K; a.R = R; a.ba = ba; a.scale = scale;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rch) {
    case 1: err = launch_rch<1, PIPE>(a, tk, tb, tg, smem, s); break;
    case 2: err = launch_rch<2, PIPE>(a, tk, tb, tg, smem, s); break;
    case 3: err = launch_rch<3, PIPE>(a, tk, tb, tg, smem, s); break;
    case 4: err = launch_rch<4, PIPE>(a, tk, tb, tg, smem, s); break;
    case 5: err = launch_rch<5, PIPE>(a, tk, tb, tg, smem, s); break;
    case 6: err = launch_rch<6, PIPE>(a, tk, tb, tg, smem, s); break;
    case 7: err = launch_rch<7, PIPE>(a, tk, tb, tg, smem, s); break;
    default: err = launch_rch<8, PIPE>(a, tk, tb, tg, smem, s); break;
  }
  return static_cast<int>(err);
}

// K1
extern "C" int sweep_project_launch(const void* x, void* y, const void* const* cores,
                                    const int* dims, const int* ops, int order,
                                    int B, int K, int R, int tk, int tb, int ba,
                                    int tg, int rch, int smem_bytes, float scale,
                                    void* stream) {
  return project_launch<false>(x, y, cores, dims, ops, order, B, K, R, tk, tb, ba,
                               tg, rch, smem_bytes, scale, stream);
}

// K5: the same arguments; smem_bytes is the planner's 'double' figure
extern "C" int sweep_project_pipelined_launch(const void* x, void* y,
                                              const void* const* cores,
                                              const int* dims, const int* ops,
                                              int order, int B, int K, int R, int tk,
                                              int tb, int ba, int tg, int rch,
                                              int smem_bytes, float scale,
                                              void* stream) {
  return project_launch<true>(x, y, cores, dims, ops, order, B, K, R, tk, tb, ba, tg,
                              rch, smem_bytes, scale, stream);
}
