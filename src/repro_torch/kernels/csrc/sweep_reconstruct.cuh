// Device code of the reconstruct sweep, shared by K2 (sweep_reconstruct.cu)
// and K4 (fused_update.cu), which differ only in what the product kernel does
// with each finished output element (the `Epi` template parameter). The
// function is x_hat[n, a, t] = sum_k y[n, k] S[k, a, t] with the operator
// S[k, a, t] = sum_u g1[k, a, u] m[k, u, t] (a the leading index, t the
// position in d2..dN, T = prod(d2..dN)). Two launches:
//  1. fold_m_kernel (sweep_fold.cuh, shared with K1/K5) folds the trailing
//     cores right-to-left into the batch-independent transfer block m
//     (k, R, T), written once per call to a scratch buffer the wrapper
//     allocates.
//  2. recon_gemm_kernel<TM, TK, Epi>: a block owns the output tile
//     x_hat[n-tile, slab, chunk] of 16*TM batch rows x a slab of ba leading
//     indices x a chunk of tc columns of T (ba*tc = RECON_BN = 128). It
//     walks the depth k in chunks of TK: it stages y[n-tile, k-chunk],
//     g1[k-chunk, slab, :] (the wrapper hands the leading core over
//     transposed to (d1, R, k), so a slab of it is rows of k-contiguous
//     floats) and m[k-chunk, :, chunk], builds the operator tile
//     S[k-chunk, slab, chunk] in shared memory (R FMAs an element,
//     build_operator_tile in sweep_stage.cuh, K1's build), and accumulates
//     acc[n, (a, t)] += sum_k y[n, k] S[k, (a, t)] in a TM x 8 register tile
//     per thread. The epilogue gets each element with its dense offset
//     (n*d1 + a)*T + t.
// Flops: the fold, 2*k*D*R per batch tile (the build) and 2*B*k*D (the
// product), where the (B*d1, k*R) x (k*R, T) graft of the reference's
// program did 2*B*k*R*D. The depth is short (k = 512-1024 on the port's
// paths) and the output large (B*D), so every element is summed by one
// thread in one fixed order: no split-K, no atomics, the same bits on every
// call.
//
// What bounds it on an H100: the product does 2*B*k*D flops on k*(B + R*T)
// input floats, far above the card's fp32 flops-per-byte ratio, so fp32 FMA
// issue bounds it. Traffic design: the slabs of one chunk all read the same
// chunk of m (k*R*tc floats; m is 1 GiB at the training shape, so a re-read
// from device memory per slab would cost d1/ba times that). The block index
// runs slab fastest, then batch tile, then chunk, so the blocks that share a
// chunk of m are launched together and L2 serves their repeats; m goes
// through device memory about once. (The other design, a block walking all
// d1 leading indices over a resident chunk as K1 does, would need a register
// tile of 16*TM x d1*tc outputs: tc = 2 at d1 = 64, too narrow for 16-byte
// staging.) y and the leading core are small beside L2 and stay there. The
// planner takes the batch tile as large as B allows (up to 128 rows), so the
// build costs R/(16*TM) of the product, and picks ba*tc near square, which
// minimises what the blocks stage per output element. IEEE fp32 FMAs only
// (no TF32, no tensor cores); every operand is staged 16 bytes at a time
// where its rows allow, else 4 bytes.
#pragma once

#include <cstdint>

#include "sweep_fold.cuh"
#include "sweep_stage.cuh"

#define RECON_THREADS 256  // 16 x 16 threads; ops.py: RECON_THREADS
#define RECON_BN 128       // output columns (a, t) of a block; ops.py: RECON_TILE_N
#define RECON_SS 132       // row stride of the operator tile; ops.py: RECON_S_STRIDE

struct ReconArgs {
  const float* y;   // (B, K)
  const float* g1;  // the leading core transposed: (d1, R, K)
  const float* m;   // (K, R, T), the fold's output
  int B, d1, K, R, tc, ba, ms;  // ms: m row stride in shared memory
  int n_slabs, n_btiles;
  long long T;
};

// Shared-memory layout in floats, each region a multiple of 4 (16 bytes):
//   ys  [TK][BM+1]   y[n0+n, k0+i] at i*(BM+1) + n
//   gs  [ba*R][TK]   g1[k0+i, a0+al, u] at (al*R+u)*TK + i
//   ms  [TK][ms]     m[k0+i, u, t0+t] at i*ms + u*tc + t
//   ss  [TK][SS]     S[k0+i, a0+al, t0+t] at i*SS + al*tc + t
// ms = R*tc padded to 4 (mod 32) floats and SS = 132 (33 16-byte groups), so
// the float4 reads of m and writes of S by eight consecutive k-rows fall in
// distinct banks (ops.py::recon_smem_bytes).
static __host__ __device__ inline long long recon_smem_floats(int BM, int TK, int R,
                                                              int ba, int ms) {
  return up4(static_cast<long long>(TK) * (BM + 1)) + static_cast<long long>(TK) * ba * R +
         static_cast<long long>(TK) * ms + static_cast<long long>(TK) * RECON_SS;
}

// One block per (slab, batch tile, chunk), slab fastest; RECON_THREADS
// threads: thread (tx, ty) = (tid % 16, tid / 16) owns batch rows
// ty*TM + {0..TM-1} and tile columns tx*4 + {0..3} and 64 + tx*4 + {0..3},
// so the float4 reads of S of a warp stay conflict-free.
template <int TM, int TK, class Epi>
__global__ void __launch_bounds__(RECON_THREADS, 2) recon_gemm_kernel(ReconArgs a, Epi epi) {
  constexpr int BM = 16 * TM, YS = BM + 1, SS = RECON_SS;
  constexpr int SB = TM >= 8 ? 2 : 4;  // loads in flight per thread while staging
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int R = a.R, tc = a.tc, ba = a.ba, d1 = a.d1, K = a.K;
  const long long bid = blockIdx.x, rest = bid / a.n_slabs;
  const int a0 = static_cast<int>(bid % a.n_slabs) * ba;
  const int n0 = static_cast<int>(rest % a.n_btiles) * BM;
  const long long t0 = rest / a.n_btiles * tc;
  float* ys = smem;
  float* gs = ys + up4(TK * YS);
  float* ms = gs + TK * ba * R;
  float* ss = ms + TK * a.ms;

  const int lt = __ffs(tc) - 1;
  const FastDiv by_r = fast_div(R);
  const bool tvec = (a.T & 3) == 0, kvec = (K & 3) == 0;
  const bool yvec = kvec && (reinterpret_cast<uintptr_t>(a.y) & 15) == 0;
  auto copy = [&](auto width, int n, auto piece, const float* base) {
    stage_copy<RECON_THREADS, SB, false>(width, tid, n, piece, base);
  };
  const int g_valid = min(ba, d1 - a0) * R;  // rows al*R + u inside d1
  const bool has_rows = n0 + ty * TM < a.B;  // this thread holds a batch row

  float acc[TM][8] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    // y[n-tile, k-chunk], stored transposed: pieces (n, i), i fastest
    auto ypiece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value;
      const int n = e / (TK / W), i = (e % (TK / W)) * W;
      return Piece{a.y + static_cast<long long>(n0 + n) * K + k0 + i, ys + i * YS + n, YS,
                   n0 + n < a.B && k0 + i < K};
    };
    if (yvec) copy(Int<4>{}, BM * (TK / 4), ypiece, a.y);
    else copy(Int<1>{}, BM * TK, ypiece, a.y);
    // g1t[a0 .. a0+ba, :, k-chunk]: pieces (al*R + u, i), i fastest
    auto gpiece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value;
      const int row = e / (TK / W), i = (e % (TK / W)) * W;
      return Piece{a.g1 + (static_cast<long long>(a0) * R + row) * K + k0 + i,
                   gs + row * TK + i, 1, row < g_valid && k0 + i < K};
    };
    if (kvec) copy(Int<4>{}, ba * R * (TK / 4), gpiece, a.g1);
    else copy(Int<1>{}, ba * R * TK, gpiece, a.g1);
    // m[k-chunk, :, chunk]: pieces (i, u, t), t fastest
    auto mpiece = [&](int e, auto width) {
      constexpr int W = decltype(width)::value, lw = W == 4 ? 2 : 0;
      const int row = e >> (lt - lw), t = (e & ((tc >> lw) - 1)) * W;
      const int i = by_r(row), u = row - i * R;
      return Piece{a.m + (static_cast<long long>(k0 + i) * R + u) * a.T + t0 + t,
                   ms + i * a.ms + u * tc + t, 1, k0 + i < K && t0 + t < a.T};
    };
    if (tvec) copy(Int<4>{}, (TK * R) << (lt - 2), mpiece, a.m);
    else copy(Int<1>{}, (TK * R) << lt, mpiece, a.m);
    __syncthreads();
    // the operator tile S[k-chunk, slab, chunk], stored k-row by k-row
    build_operator_tile<TK, RECON_THREADS>(
        gs, ms, a.ms, R, tc, lt, ba, tid, [&](int i, int al, int t, float4 s) {
          *reinterpret_cast<float4*>(ss + i * SS + al * tc + t) = s;
        });
    __syncthreads();
    // acc[n, c] += sum over the k-chunk of y[n, k] S[k, c]
    if (has_rows) {
      const float* ysl = ys + ty * TM;
      const float* ssl = ss + tx * 4;
#pragma unroll 4
      for (int q = 0; q < TK; ++q) {
        float yr[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) yr[r] = ysl[q * YS + r];
        const float4 s0 = *reinterpret_cast<const float4*>(ssl + q * SS);
        const float4 s1 = *reinterpret_cast<const float4*>(ssl + q * SS + 64);
        const float sr[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(yr[r], sr[j], acc[r][j]);
      }
    }
    __syncthreads();  // staged tiles consumed before the next chunk refills them
  }
  epi.begin();
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const long long n = n0 + ty * TM + r;
    if (n >= a.B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      const int al = c >> lt;
      const long long t = t0 + (c & (tc - 1));
      if (a0 + al < d1 && t < a.T) epi((n * d1 + a0 + al) * a.T + t, acc[r][j]);
    }
  }
}

template <int TM, int TK, class Epi>
static cudaError_t recon_gemm(const ReconArgs& a, long long blocks, size_t smem, Epi epi,
                              cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(recon_gemm_kernel<TM, TK, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  recon_gemm_kernel<TM, TK, Epi>
      <<<static_cast<unsigned>(blocks), RECON_THREADS, smem, s>>>(a, epi);
  return cudaGetLastError();
}

template <int TK, class Epi>
static cudaError_t recon_tm(const ReconArgs& a, int tm, long long blocks, size_t smem,
                            Epi epi, cudaStream_t s) {
  switch (tm) {
    case 1: return recon_gemm<1, TK>(a, blocks, smem, epi, s);
    case 2: return recon_gemm<2, TK>(a, blocks, smem, epi, s);
    case 3: return recon_gemm<3, TK>(a, blocks, smem, epi, s);
    case 4: return recon_gemm<4, TK>(a, blocks, smem, epi, s);
    case 6: return recon_gemm<6, TK>(a, blocks, smem, epi, s);
    default: return recon_gemm<8, TK>(a, blocks, smem, epi, s);
  }
}

// Fold, then the product with epilogue `epi`, on `stream`. Returns a
// cudaError_t (0 on success); refuses what the kernels do not take.
template <class Epi>
int recon_launch(const void* y, void* m_scratch, const void* const* cores,
                 const int* dims, const int* ops, int order, int B, int K, int R,
                 int tile_m, int tile_k, int tile_a, int tile_t, int smem_bytes, Epi epi,
                 void* stream) {
  // cores[0]: the leading core transposed to (d1, R, K); the fold reads
  // cores[1..N-1]. tile_*, smem_bytes: the planner's ContractionPlan
  // (ops.py::plan_contraction, kind='reconstruct'); the tiles must be ones
  // this source was compiled for and the layout it charged the one laid out
  const int tm = tile_m / 16;
  if (order < 2 || order > SWEEP_MAX_ORDER || R < 1 || R > MAXR || B < 1 || K < 1 ||
      tile_m % 16 != 0 || !(tm == 1 || tm == 2 || tm == 3 || tm == 4 || tm == 6 || tm == 8) ||
      !(tile_k == 64 || tile_k == 32 || tile_k == 16) || tile_t < 4 || tile_t > RECON_BN ||
      (tile_t & (tile_t - 1)) != 0 || tile_a * tile_t != RECON_BN)
    return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs f{};
  f.T = 1;
  for (int i = 0; i < order; ++i) {
    f.core[i] = static_cast<const float*>(cores[i]);
    f.dims[i] = dims[i];
    if (i > 0) f.T *= dims[i];
  }
  for (int j = 0; j < order - 1; ++j) f.ops[j] = ops[j];
  f.order = order; f.K = K; f.R = R;
  f.m = static_cast<float*>(m_scratch);

  ReconArgs a{};
  a.y = static_cast<const float*>(y);
  a.g1 = f.core[0];
  a.m = f.m;
  a.B = B; a.d1 = dims[0]; a.K = K; a.R = R; a.tc = tile_t; a.ba = tile_a;
  a.ms = R * tile_t + ((4 - (R * tile_t) % 32) + 32) % 32;
  a.T = f.T;
  a.n_slabs = (dims[0] + tile_a - 1) / tile_a;
  a.n_btiles = (B + tile_m - 1) / tile_m;
  if (recon_smem_floats(tile_m, tile_k, R, tile_a, a.ms) *
          static_cast<long long>(sizeof(float)) != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(a.n_slabs) * a.n_btiles * ((f.T + tile_t - 1) / tile_t);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_fold = static_cast<long long>(K) * f.T;
  fold_m_kernel<<<static_cast<unsigned>((n_fold + 255) / 256), 256, 0, s>>>(f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(smem_bytes);
  err = tile_k == 64   ? recon_tm<64>(a, tm, blocks, smem, epi, s)
        : tile_k == 32 ? recon_tm<32>(a, tm, blocks, smem, epi, s)
                       : recon_tm<16>(a, tm, blocks, smem, epi, s);
  return static_cast<int>(err);
}
