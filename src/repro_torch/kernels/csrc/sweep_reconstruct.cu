// K2: sweep_reconstruct — batched adjoint of the TT/CP projection, orders 2..8,
//   x_hat[n, i1, ..., iN] = scale * sum_k y[n,k] S_k[i1, ..., iN].
//
// Replaces the Pallas TPU kernel repro/kernels/_sweep.py::sweep_reconstruct
// (_reconstruct_kernel), which grafted the sketch onto the leading core and
// ran the (B*d1, k*R) x (k*R, d2..dN) contraction of the reference's program
// (repro_torch/kernels/ops.py::_reconstruct_steps), 2*B*k*R*D flops. Here the
// same function takes the dense-operator route in two launches, whose device
// code is in sweep_reconstruct.cuh (shared with K4, fused_update.cu):
//  1. fold_m_kernel folds the trailing cores into the batch-independent
//     transfer block m (k, R, d2..dN) once per call (the TPU kernel refolded
//     it in VMEM for every grid step).
//  2. recon_gemm_kernel builds the operator tiles S[k, a, t] = sum_u
//     g1[k, a, u] m[k, u, t] in shared memory, once per batch tile, and
//     accumulates the (B, k) x (k, D) product in registers over the whole
//     depth (the TPU's k-innermost grid axis, which accumulated in the
//     revisited output block); here its epilogue stores the scaled element.
// 2*k*D*R flops per batch tile for the build and 2*B*k*D for the product.
//
// What bounds it on an H100: fp32 FMA issue (the product's flops per byte are
// far above the card's ratio); the design answers in sweep_reconstruct.cuh.
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
                                        int R, int tile_m, int tile_k, int tile_a,
                                        int tile_t, int smem_bytes, float scale,
                                        void* stream) {
  return recon_launch(y, m_scratch, cores, dims, ops, order, B, K, R, tile_m,
                      tile_k, tile_a, tile_t, smem_bytes,
                      StoreEpilogue{static_cast<float*>(out), scale}, stream);
}
