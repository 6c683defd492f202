// Shared definitions of the mode-sweep kernels (K1/K5 sweep_project.cu,
// K2 sweep_reconstruct.cu, K4 fused_update.cu). The opcodes are the lowered
// fold of the trailing cores (repro_torch/kernels/ops.py `program_codes`),
// which holds the same values.
#pragma once

#include <cuda_runtime.h>

#define SWEEP_MAX_ORDER 8

enum SweepOp {
  OP_M_INIT_TT = 6,  // m[k,u,c] = g[k,u,c]
  OP_M_INIT_CP = 7,  // m[k,r,c] = f[k,c,r]
  OP_M_MIX_TT = 8,   // m'[k,v,i,..] = sum_u g[k,v,i,u] m[k,u,..]
  OP_M_HAD_CP = 9,   // m'[k,r,i,..] = f[k,i,r] m[k,r,..]
};
