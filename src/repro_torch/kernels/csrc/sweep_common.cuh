// Shared definitions of the mode-sweep kernels (K1 sweep_project.cu,
// K2 sweep_reconstruct.cu). The opcodes are the lowered einsum program of
// repro_torch/kernels/ops.py (`program_codes`), which holds the same values.
#pragma once

#include <cuda_runtime.h>

#define SWEEP_MAX_ORDER 8

enum SweepOp {
  OP_FIRST_TT = 1,   // z[u]  = sum_c x[c] g[k,u,c]            core (k,R,dN)
  OP_FIRST_CP = 2,   // z[r]  = sum_c x[c] f[k,c,r]            core (k,dN,R)
  OP_MIX_TT = 3,     // z'[v] += sum_u z[u] g[k,v,i,u]         core (k,R,d,R)
  OP_HAD_CP = 4,     // z'[r] += z[r] f[k,i,r]                 core (k,d,R)
  OP_LAST = 5,       // y     += sum_u z[u] g[k,i,u]           core (k,d1,R)
  OP_M_INIT_TT = 6,  // m[k,u,c] = g[k,u,c]
  OP_M_INIT_CP = 7,  // m[k,r,c] = f[k,c,r]
  OP_M_MIX_TT = 8,   // m'[k,v,i,..] = sum_u g[k,v,i,u] m[k,u,..]
  OP_M_HAD_CP = 9,   // m'[k,r,i,..] = f[k,i,r] m[k,r,..]
};
