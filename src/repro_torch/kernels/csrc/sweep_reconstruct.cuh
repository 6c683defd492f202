// Device code of the reconstruct sweep, shared by K2 (sweep_reconstruct.cu)
// and K4 (fused_update.cu), which differ only in what the product kernel does
// with each finished output tile (the `Epi` template parameter):
//  1. fold_m_kernel (sweep_fold.cuh, shared with K1/K5) folds the trailing
//     cores right-to-left into the batch-independent transfer block m
//     (k, R, d2..dN), written once per call to a scratch buffer the wrapper
//     allocates.
//  2. recon_gemm_kernel<Epi> grafts the sketch onto the leading core,
//     h[(n,a), (k,u)] = y[n,k] g1[k,a,u], while it loads h's tiles, and
//     computes the (B*d1, k*R) x (k*R, d2..dN) contraction. A block owns a
//     (128 rows of (n, d1)) x (128 columns of d2..dN) output tile (grid x:
//     column tiles, grid y: row tiles), loops over the k*R depth inside the
//     block and keeps the tile in registers until the epilogue, which gets
//     each element with its dense offset row * T + col.
// IEEE fp32 FMAs only (no TF32, no tensor cores).
#pragma once

#include <cstdint>

#include "sweep_fold.cuh"

#define BM 128   // ops.py: RECON_TILE
#define BN 128
#define BK 8

// acc[(n,a), t] = sum_q h[(n,a), q] m[q, t], q = (k, u), with
// h[(n,a), (k,u)] = y[n,k] g1[k,a,u]; then epi(row * T + col, acc) for every
// element inside (M, T). 256 threads, 8x8 outputs each: rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, columns likewise with tx, so the float4 shared
// loads of a warp stay conflict-free.
template <class Epi>
__global__ void __launch_bounds__(256)
recon_gemm_kernel(const float* __restrict__ y, const float* __restrict__ g1,
                  const float* __restrict__ m, int B, int d1, int K, int R,
                  long long T, Epi epi) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long M = static_cast<long long>(B) * d1;
  const long long Q = static_cast<long long>(K) * R;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;
  float acc[8][8] = {};
  for (long long q0 = 0; q0 < Q; q0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / 256; ++i) {
      const int e = tid + i * 256, r = e % BM, qq = e / BM;
      const long long row = row0 + r, q = q0 + qq;
      float v = 0.f;
      if (row < M && q < Q) {
        const long long n = row / d1, aa = row - n * d1;
        const long long kq = q / R, u = q - kq * R;
        v = y[n * K + kq] * g1[(kq * d1 + aa) * R + u];
      }
      As[qq][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / 256; ++i) {
      const int e = tid + i * 256, c = e % BN, qq = e / BN;
      const long long col = col0 + c, q = q0 + qq;
      Bs[qq][c] = (col < T && q < Q) ? m[q * T + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int qq = 0; qq < BK; ++qq) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[qq][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[qq][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[qq][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[qq][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  epi.begin();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < T) epi(row * T + col, acc[i][j]);
    }
  }
}

// Fold, then the product with epilogue `epi`, on `stream`. Returns a
// cudaError_t (0 on success); refuses what the kernels do not take.
template <class Epi>
int recon_launch(const void* y, void* m_scratch, const void* const* cores,
                 const int* dims, const int* ops, int order, int B, int K, int R,
                 int tile_m, int tile_n, int tile_k, Epi epi, void* stream) {
  // tile_*: the planner's product tile (ops.py: RECON_TILE), which must be
  // the one this source was compiled with
  if (order < 2 || order > SWEEP_MAX_ORDER || R < 1 || R > MAXR || tile_m != BM ||
      tile_n != BN || tile_k != BK)
    return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs a{};
  a.T = 1;
  for (int i = 0; i < order; ++i) {
    a.core[i] = static_cast<const float*>(cores[i]);
    a.dims[i] = dims[i];
    if (i > 0) a.T *= dims[i];
  }
  for (int j = 0; j < order - 1; ++j) a.ops[j] = ops[j];
  a.order = order; a.K = K; a.R = R;
  a.m = static_cast<float*>(m_scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_fold = static_cast<long long>(K) * a.T;
  fold_m_kernel<<<static_cast<unsigned>((n_fold + 255) / 256), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((a.T + BN - 1) / BN),
            static_cast<unsigned>((static_cast<long long>(B) * dims[0] + BM - 1) / BM));
  recon_gemm_kernel<Epi><<<grid, 256, 0, s>>>(static_cast<const float*>(y),
                                              a.core[0], a.m, B, dims[0], K, R,
                                              a.T, epi);
  return static_cast<int>(cudaGetLastError());
}
