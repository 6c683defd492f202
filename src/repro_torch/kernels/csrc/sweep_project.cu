// K1: sweep_project — batched dense-input TT/CP projection for orders 2..8,
//   y[n,i] = scale * < S_i, X_n >,  S_i the i-th TT/CP row tensor.
//
// Replaces the Pallas TPU kernel repro/kernels/_sweep.py::sweep_project
// (_project_kernel), which evaluated the planner's mode-sweep program
// (repro_torch/kernels/ops.py::_project_steps) on every batch row: 2*B*k*R*D
// flops for D = prod(dims). On an H100 that is the wrong program. Here the
// same function takes the dense-operator route, in three launches on the
// caller's stream:
//  1. fold_m_kernel (sweep_fold.cuh, K2's fold, unchanged) folds the trailing
//     cores into the transfer block m (k, R, T), T = prod(d2..dN), once per
//     call: the program of ops.py::_reconstruct_steps' m steps.
//  2. project_gemm_kernel: the operator is S[i, a, t] = sum_u g1[i, a, u]
//     m[i, u, t] (g1 the squeezed leading core), and y[n, i] = sum_{a,t}
//     X[n, a, t] S[i, a, t] is one (B, D) x (D, k) product. A block owns
//     (tile_m batch rows) x (tile_k k-rows) x (one group of T-chunks of
//     tile_t columns). It stages each chunk m[k-tile, :, chunk] in shared
//     memory once and keeps it while it walks the leading index, tile_a
//     values (a slab) at a time: it stages X[n-tile, slab, chunk] and
//     g1[k-tile, slab, :], builds the operator tile S[k-tile, slab, chunk] in
//     shared memory (R FMAs an element, one float4 read of m feeding four
//     leading indices), and accumulates the product in registers (TM x TN
//     outputs a thread, float4 reads of S, as K2's product). It writes its
//     partial tile to a (groups, B, k) scratch.
//  3. reduce_partials_kernel sums the groups in a fixed order, scales, and
//     writes y: no atomics, so a call gives the same bits every time.
// Flops: the fold, 2*k*D*R per batch tile (the build) and 2*B*k*D (the
// product): 8-18x fewer than the program at the shapes the port runs.
//
// What bounds it on an H100: the product does 2*B*k*D flops on B*D + k*R*T
// input floats, above the card's fp32 flops-per-byte ratio, so fp32 FMA
// issue bounds it. Design answer, kept simple: m is read from device memory
// once per batch tile (the loop over a runs inside the block over the
// resident chunk; a grid over a would re-read m d1 times), X once per
// k-tile; the leading core is re-staged for every chunk, so the wrapper
// hands it over transposed to (d1, R, k) and every operand is staged 16
// bytes at a time where its rows allow; IEEE fp32 FMAs only (no TF32, no
// tensor cores). The grid splits T into groups so that it holds at least
// two blocks per SM at small batches.
//
// K5: sweep_project_pipelined — the same function and the same device code
// (PIPE = true). Replaces repro/kernels/_sweep.py::sweep_project_pipelined
// (_project_pipelined_kernel), which double-buffered the input and the
// leading-core tile with explicit DMAs. K5 keeps two slots of the staged X
// and g1 slab, and two of the m chunk where the planner finds room
// (m_slots), and issues the cp.async copies of the next slab (and chunk)
// before it computes the current one, so the copies overlap the FMAs. K1
// stages with plain loads, a few in flight per thread.
#include <cstdint>

#include "sweep_fold.cuh"
#include "sweep_stage.cuh"

#define PROJ_THREADS 256  // 16 x 16 threads; ops.py: PROJECT_THREADS
#define STAGE_BATCH 4     // loads in flight per thread while K1 stages (2 beside
                          // the 8 x 8 register tile, which would spill)

struct ProjectArgs {
  const float* x;   // (B, d1, T)
  const float* g1;  // the leading core transposed: (d1, R, K)
  const float* m;   // (K, R, T), the fold's output
  float* part;      // (groups, B, K)
  int B, d1, K, R, tc, ac, m_slots, ms;  // ms: m row stride in shared memory
  long long T, n_chunks, cpg;            // chunks per group
};

// Shared-memory layout in floats, each region a multiple of 4 (16 bytes):
//   ms  m_slots x [BN][ms]          m[k0+i, u, t0+t] at i*ms + u*tc + t
//   xs  xslots  x [ac*tc][BM+1]     X[n0+n, a0+al, t0+t] at (al*tc+t)*(BM+1)+n
//   gs  xslots  x [ac*R][BN]        g1[k0+i, a0+al, u] at (al*R+u)*BN+i
//   ss            [ac*tc][BN]       S[k0+i, a0+al, t0+t] at (al*tc+t)*BN+i
// ms = R*tc padded to 4 (mod 32) floats, so the float4 reads of eight
// consecutive k-rows fall in distinct banks (ops.py::project_smem_bytes).
struct Layout {
  long long m_slot, x_slot, g_slot, s_size, total;
};
static __host__ __device__ inline Layout layout(int BM, int BN, int R, int tc, int ac,
                                                int ms, int m_slots, bool pipe) {
  Layout l;
  const int xslots = pipe ? 2 : 1;
  l.m_slot = static_cast<long long>(BN) * ms;
  l.x_slot = up4(static_cast<long long>(ac) * tc * (BM + 1));
  l.g_slot = static_cast<long long>(ac) * R * BN;
  l.s_size = static_cast<long long>(ac) * tc * BN;
  l.total = m_slots * l.m_slot + xslots * (l.x_slot + l.g_slot) + l.s_size;
  return l;
}

// grid = (k tiles, batch tiles, groups), PROJ_THREADS threads: thread (tx,
// ty) = (tid % 16, tid / 16) owns batch rows ty*TM + {0..TM-1} and k columns
// tx*4 + {0..3} (+ 64 + tx*4 + {0..3} when TN = 8).
template <int TM, int TN, bool PIPE>
__global__ void __launch_bounds__(PROJ_THREADS, 2) project_gemm_kernel(ProjectArgs a) {
  constexpr int BM = 16 * TM, BN = 16 * TN, XS = BM + 1;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int R = a.R, tc = a.tc, ac = a.ac, d1 = a.d1;
  const int k0 = blockIdx.x * BN, n0 = blockIdx.y * BM;
  const long long c_begin = blockIdx.z * a.cpg;
  const long long c_end = min(c_begin + a.cpg, a.n_chunks);
  const Layout L = layout(BM, BN, R, tc, ac, a.ms, a.m_slots, PIPE);
  float* ms = smem;
  float* xs = ms + a.m_slots * L.m_slot;
  float* gs = xs + (PIPE ? 2 : 1) * L.x_slot;
  float* ss = gs + (PIPE ? 2 : 1) * L.g_slot;

  // Staging (stage_copy, sweep_stage.cuh): K1 loads SB pieces into
  // registers before it stores them, so their latencies overlap; K5 issues
  // them as cp.async copies.
  const int lt = __ffs(tc) - 1;
  constexpr int SB = TM * TN >= 64 ? 2 : STAGE_BATCH;
  auto copy = [&](auto width, int n, auto piece, const float* base) {
    stage_copy<PROJ_THREADS, SB, PIPE>(width, tid, n, piece, base);
  };
  // m[k-tile, :, chunk c] into m slot `slot`: pieces (i, u, t), t fastest
  const FastDiv by_r = fast_div(R);
  const bool tvec = (a.T & 3) == 0, kvec = (a.K & 3) == 0;
  auto stage_m = [&](long long c, int slot) {
    float* d = ms + slot * L.m_slot;
    const long long t0 = c * tc;
    auto piece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value, lw = W == 4 ? 2 : 0;
      const int row = e >> (lt - lw), t = (e & ((tc >> lw) - 1)) * W;
      const int i = by_r(row), u = row - i * R;
      return Piece{a.m + (static_cast<long long>(k0 + i) * R + u) * a.T + t0 + t,
                   d + i * a.ms + u * tc + t, 1, k0 + i < a.K && t0 + t < a.T};
    };
    if (tvec) copy(Int<4>{}, (BN * R) << (lt - 2), piece, a.m);
    else copy(Int<1>{}, (BN * R) << lt, piece, a.m);
  };
  // X[n-tile, a0 .. a0+ac, chunk c] (pieces (al, n, t), t fastest, stored
  // transposed) and g1t[a0 .. a0+ac, :, k-tile] (pieces (al*R + u, i), i
  // fastest) into slot `slot`
  auto stage_slab = [&](long long c, int a0, int slot) {
    float* xd = xs + slot * L.x_slot;
    const long long t0 = c * tc;
    auto xpiece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value, lw = W == 4 ? 2 : 0;
      const int r = e >> (lt - lw), t = (e & ((tc >> lw) - 1)) * W;
      const int n = r % BM, al = r / BM;
      return Piece{a.x + (static_cast<long long>(n0 + n) * d1 + a0 + al) * a.T + t0 + t,
                   xd + (al * tc + t) * XS + n, XS,
                   n0 + n < a.B && a0 + al < d1 && t0 + t < a.T};
    };
    if (tvec) copy(Int<4>{}, (ac * BM) << (lt - 2), xpiece, a.x);
    else copy(Int<1>{}, (ac * BM) << lt, xpiece, a.x);
    float* gd = gs + slot * L.g_slot;
    const int valid = min(ac, d1 - a0) * R;  // rows al*R + u inside d1
    auto gpiece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value;
      const int row = e / (BN / W), i = (e % (BN / W)) * W;
      return Piece{a.g1 + (static_cast<long long>(a0) * R + row) * a.K + k0 + i,
                   gd + row * BN + i, 1, row < valid && k0 + i < a.K};
    };
    if (kvec) copy(Int<4>{}, ac * R * (BN / 4), gpiece, a.g1);
    else copy(Int<1>{}, ac * R * BN, gpiece, a.g1);
  };

  float acc[TM][TN] = {};
  const int nsa = (d1 + ac - 1) / ac;  // slabs per chunk
  const long long nslab = (c_end - c_begin) * nsa;
  if (PIPE && nslab > 0) {
    stage_m(c_begin, 0);
    stage_slab(c_begin, 0, 0);
    cp_async_commit();
  }
  for (long long j = 0; j < nslab; ++j) {
    const long long c = c_begin + j / nsa;
    const int a0 = static_cast<int>(j % nsa) * ac;
    const bool new_chunk = a0 == 0;
    const int xslot = PIPE ? static_cast<int>(j & 1) : 0;
    const int mslot = a.m_slots == 2 ? static_cast<int>((c - c_begin) & 1) : 0;
    if (PIPE) {
      // one m slot: chunk c's m streams in now, its slot free since the
      // previous slab's closing barrier
      if (a.m_slots == 1 && new_chunk && j > 0) {
        stage_m(c, 0);
        cp_async_commit();
      }
      // the next slab (and, with two m slots, its new chunk) streams into
      // the other slots while this one computes; an empty group on the last
      // slab keeps the wait count right
      if (j + 1 < nslab) {
        const long long cn = c_begin + (j + 1) / nsa;
        const int an = static_cast<int>((j + 1) % nsa) * ac;
        if (a.m_slots == 2 && an == 0) stage_m(cn, static_cast<int>((cn - c_begin) & 1));
        stage_slab(cn, an, xslot ^ 1);
      }
      cp_async_commit();
      cp_async_wait1();  // this thread's copies of slab j have landed
      __syncthreads();   // ... and every other thread's
    } else {
      if (new_chunk) stage_m(c, 0);
      stage_slab(c, a0, 0);
      __syncthreads();
    }
    // the operator tile S[k-tile, slab, chunk], stored (a, t)-major with
    // the k-rows contiguous
    build_operator_tile<BN, PROJ_THREADS>(
        gs + xslot * L.g_slot, ms + mslot * L.m_slot, a.ms, R, tc, lt, ac, tid,
        [&](int i, int al, int t, float4 s) {
          float* sp = ss + (al * tc + t) * BN + i;
          sp[0] = s.x;
          sp[BN] = s.y;
          sp[2 * BN] = s.z;
          sp[3 * BN] = s.w;
        });
    __syncthreads();
    // acc[n, i] += sum over the slab's (a, t) of X[n, a, t] S[i, a, t]
    {
      const float* xsl = xs + xslot * L.x_slot + ty * TM;
      const float* ssl = ss + tx * 4;
      const int depth = ac * tc;
#pragma unroll 4
      for (int q = 0; q < depth; ++q) {
        float xr[TM], sr[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) xr[r] = xsl[q * XS + r];
        const float4 s0 = *reinterpret_cast<const float4*>(ssl + q * BN);
        sr[0] = s0.x; sr[1] = s0.y; sr[2] = s0.z; sr[3] = s0.w;
        if constexpr (TN == 8) {
          const float4 s1 = *reinterpret_cast<const float4*>(ssl + q * BN + 64);
          sr[TN - 4] = s1.x; sr[TN - 3] = s1.y; sr[TN - 2] = s1.z; sr[TN - 1] = s1.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int jn = 0; jn < TN; ++jn) acc[r][jn] = fmaf(xr[r], sr[jn], acc[r][jn]);
      }
    }
    __syncthreads();  // slots consumed before the next slab refills them
  }
  // this block's partial tile of group blockIdx.z (zeros for an empty group)
  float* out = a.part + static_cast<long long>(blockIdx.z) * a.B * a.K;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int n = n0 + ty * TM + r;
    if (n >= a.B) continue;
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) {
      const int i = k0 + (jn < 4 ? tx * 4 + jn : 64 + tx * 4 + jn - 4);
      if (i < a.K) out[static_cast<long long>(n) * a.K + i] = acc[r][jn];
    }
  }
}

// y[e] = scale * sum_g part[g, e] over e in (B, K), groups in order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ y,
                                       int groups, long long BK, float scale) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= BK) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[g * BK + e];
  y[e] = s * scale;
}

template <int TM, int TN, bool PIPE>
static cudaError_t launch_gemm(const ProjectArgs& a, int groups, size_t smem,
                               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(project_gemm_kernel<TM, TN, PIPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.K + 16 * TN - 1) / (16 * TN), (a.B + 16 * TM - 1) / (16 * TM), groups);
  project_gemm_kernel<TM, TN, PIPE><<<grid, PROJ_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int TN, bool PIPE>
static cudaError_t launch_tn(const ProjectArgs& a, int tm, int groups, size_t smem,
                             cudaStream_t s) {
  switch (tm) {
    case 1: return launch_gemm<1, TN, PIPE>(a, groups, smem, s);
    case 2: return launch_gemm<2, TN, PIPE>(a, groups, smem, s);
    case 3: return launch_gemm<3, TN, PIPE>(a, groups, smem, s);
    case 4: return launch_gemm<4, TN, PIPE>(a, groups, smem, s);
    case 6: return launch_gemm<6, TN, PIPE>(a, groups, smem, s);
    default: return launch_gemm<8, TN, PIPE>(a, groups, smem, s);
  }
}

template <bool PIPE>
static int project_launch(const void* x, void* y, void* m_scratch, void* part_scratch,
                          const void* const* cores, const int* dims, const int* fold_ops,
                          int order, int B, int K, int R, int tile_m, int tile_k,
                          int tile_a, int tile_t, int groups, int m_slots,
                          int smem_bytes, float scale, void* stream) {
  // cores[0]: the leading core transposed to (d1, R, K), so a slab of it is
  // rows of k contiguous in memory; the fold reads cores[1..N-1] as K2's.
  // tile_*, groups, m_slots, smem_bytes: the planner's ContractionPlan
  // (ops.py::plan_contraction, kind='project'); the layout it charged must
  // be the one this source lays out
  const int tm = tile_m / 16, tn = tile_k / 16;
  if (order < 2 || order > SWEEP_MAX_ORDER || R < 1 || R > MAXR || B < 1 || K < 1 ||
      tile_m % 16 != 0 || !(tm == 1 || tm == 2 || tm == 3 || tm == 4 || tm == 6 || tm == 8) ||
      !(tn == 4 || tn == 8) || tile_k % 16 != 0 || tile_t < 4 || tile_t > 64 ||
      (tile_t & (tile_t - 1)) != 0 ||
      tile_a < 1 || tile_a > dims[0] || groups < 1 || m_slots < 1 || m_slots > (PIPE ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs f{};
  f.T = 1;
  for (int i = 0; i < order; ++i) {
    f.core[i] = static_cast<const float*>(cores[i]);
    f.dims[i] = dims[i];
    if (i > 0) f.T *= dims[i];
  }
  for (int j = 0; j < order - 1; ++j) f.ops[j] = fold_ops[j];
  f.order = order; f.K = K; f.R = R;
  f.m = static_cast<float*>(m_scratch);

  ProjectArgs a{};
  a.x = static_cast<const float*>(x);
  a.g1 = f.core[0];
  a.m = f.m;
  a.part = static_cast<float*>(part_scratch);
  a.B = B; a.d1 = dims[0]; a.K = K; a.R = R; a.tc = tile_t; a.ac = tile_a;
  a.m_slots = m_slots;
  a.ms = R * tile_t + ((4 - (R * tile_t) % 32) + 32) % 32;
  a.T = f.T;
  a.n_chunks = (f.T + tile_t - 1) / tile_t;
  a.cpg = (a.n_chunks + groups - 1) / groups;
  const Layout l = layout(tile_m, tile_k, R, tile_t, tile_a, a.ms, m_slots, PIPE);
  if (l.total * static_cast<long long>(sizeof(float)) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_fold = static_cast<long long>(K) * f.T;
  fold_m_kernel<<<static_cast<unsigned>((n_fold + 255) / 256), 256, 0, s>>>(f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(smem_bytes);
  err = tn == 8 ? launch_tn<8, PIPE>(a, tm, groups, smem, s)
                : launch_tn<4, PIPE>(a, tm, groups, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bk = static_cast<long long>(B) * K;
  reduce_partials_kernel<<<static_cast<unsigned>((bk + 255) / 256), 256, 0, s>>>(
      a.part, static_cast<float*>(y), groups, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

// K1
extern "C" int sweep_project_launch(const void* x, void* y, void* m_scratch,
                                    void* part_scratch, const void* const* cores,
                                    const int* dims, const int* fold_ops, int order, int B,
                                    int K, int R, int tile_m, int tile_k, int tile_a,
                                    int tile_t, int groups, int m_slots, int smem_bytes,
                                    float scale, void* stream) {
  return project_launch<false>(x, y, m_scratch, part_scratch, cores, dims, fold_ops, order,
                               B, K, R, tile_m, tile_k, tile_a, tile_t, groups, m_slots,
                               smem_bytes, scale, stream);
}

// K5: the same arguments; smem_bytes is the planner's 'double' figure
extern "C" int sweep_project_pipelined_launch(const void* x, void* y, void* m_scratch,
                                              void* part_scratch, const void* const* cores,
                                              const int* dims, const int* fold_ops,
                                              int order, int B, int K, int R, int tile_m,
                                              int tile_k, int tile_a, int tile_t,
                                              int groups, int m_slots, int smem_bytes,
                                              float scale, void* stream) {
  return project_launch<true>(x, y, m_scratch, part_scratch, cores, dims, fold_ops, order,
                              B, K, R, tile_m, tile_k, tile_a, tile_t, groups, m_slots,
                              smem_bytes, scale, stream);
}
