// K2: sweep_reconstruct — batched adjoint of the TT/CP projection, orders 2..8,
//   x_hat[n, i1, ..., iN] = scale * sum_k y[n,k] S_k[i1, ..., iN].
//
// Replaces the Pallas TPU kernel repro/kernels/_sweep.py::sweep_reconstruct
// (_reconstruct_kernel) and runs the same program
// (repro_torch/kernels/ops.py::_reconstruct_steps) in two launches, whose
// device code is in sweep_reconstruct.cuh (shared with K4, fused_update.cu):
//  1. fold_m_kernel folds the trailing cores into the batch-independent
//     transfer block m (k, R, d2..dN) once per call (the TPU kernel refolded
//     it in VMEM for every grid step).
//  2. recon_gemm_kernel computes the (B*d1, k*R) x (k*R, d2..dN) contraction
//     with y grafted onto the leading core; here its epilogue stores the
//     scaled tile. The loop over the k*R depth inside the block is the TPU's
//     k-innermost grid axis that accumulated in the revisited output block.
//
// What bounds it on an H100: the contraction does 2*B*d1*k*R*prod(d2..dN)
// flops, far more per byte than the card's fp32 ratio, so fp32 FMA issue
// bounds it. Design answer, kept simple: a classic shared-memory tiled product
// with an 8x8 register tile per thread (each shared load feeds eight FMAs),
// IEEE fp32 FMAs only (no TF32, no tensor cores); wgmma/TMA are later work.
#include "sweep_reconstruct.cuh"

struct StoreEpilogue {
  float* out;
  float scale;
  __device__ void begin() {}
  __device__ void operator()(long long off, float acc) const {
    out[off] = acc * scale;
  }
};

extern "C" int sweep_reconstruct_launch(const void* y, void* out, void* m_scratch,
                                        const void* const* cores, const int* dims,
                                        const int* ops, int order, int B, int K,
                                        int R, int tile_m, int tile_n, int tile_k,
                                        float scale, void* stream) {
  return recon_launch(y, m_scratch, cores, dims, ops, order, B, K, R, tile_m,
                      tile_n, tile_k,
                      StoreEpilogue{static_cast<float*>(out), scale}, stream);
}
