// The fold of the trailing cores into the transfer block m (k, R, d2..dN),
//   m[k, :, (i2..iN)] = G_2[k, :, i2, :] ... G_N[k, :, iN]   (TT)
//   m[k, r, (i2..iN)] = A_2[k, i2, r] ... A_N[k, iN, r]       (CP),
// the program of ops.py::_reconstruct_steps' m_steps lowered to opcodes.
// Shared by the project sweep (K1, K5: sweep_project.cu) and the
// reconstruct sweep (K2, K4: sweep_reconstruct.cuh), which both build the
// operator tiles S[k, a, t] = sum_u g1[k, a, u] m[k, u, t] from it.
#pragma once

#include <cstdint>

#include "sweep_common.cuh"

#define MAXR 64  // bond rank held per thread by the fold (ops.py: MAX_RANK)

struct FoldArgs {
  const float* core[SWEEP_MAX_ORDER];
  int dims[SWEEP_MAX_ORDER];
  int ops[SWEEP_MAX_ORDER];  // ops[j]: opcode of transfer-block step j
  int order, K, R;
  long long T;               // prod(d2..dN)
  float* m;                  // (K, R, T)
};

// One thread per (k, position in d2..dN): the R-vector m[k, :, t].
__global__ void fold_m_kernel(FoldArgs a) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(a.K) * a.T) return;
  const int N = a.order, R = a.R;
  const int kk = static_cast<int>(e / a.T);
  const long long t = e - static_cast<long long>(kk) * a.T;
  int digit[SWEEP_MAX_ORDER];
  long long rem = t;
  for (int m = N - 1; m >= 1; --m) {
    digit[m] = static_cast<int>(rem % a.dims[m]);
    rem /= a.dims[m];
  }
  float w[MAXR], w2[MAXR];
  const int dN = a.dims[N - 1];
  const float* gN = a.core[N - 1];
  for (int u = 0; u < R; ++u)
    w[u] = a.ops[0] == OP_M_INIT_TT
               ? gN[(static_cast<size_t>(kk) * R + u) * dN + digit[N - 1]]
               : gN[(static_cast<size_t>(kk) * dN + digit[N - 1]) * R + u];
  for (int j = 1; j <= N - 2; ++j) {
    const int m = N - 1 - j, d = a.dims[m];
    const float* g = a.core[m];
    if (a.ops[j] == OP_M_MIX_TT) {
      for (int v = 0; v < R; ++v) {
        const float* gv = g + ((static_cast<size_t>(kk) * R + v) * d + digit[m]) * R;
        float s = 0.f;
        for (int u = 0; u < R; ++u) s = fmaf(gv[u], w[u], s);
        w2[v] = s;
      }
      for (int v = 0; v < R; ++v) w[v] = w2[v];
    } else {  // OP_M_HAD_CP
      const float* gv = g + (static_cast<size_t>(kk) * d + digit[m]) * R;
      for (int r = 0; r < R; ++r) w[r] *= gv[r];
    }
  }
  for (int v = 0; v < R; ++v) a.m[(static_cast<size_t>(kk) * R + v) * a.T + t] = w[v];
}
