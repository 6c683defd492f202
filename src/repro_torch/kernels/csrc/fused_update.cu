// K4: fused_update — unsketch + error feedback + AdamW for one leaf's buckets,
// orders 2..8, TT and CP:
//   g     = scale * sum_k y[n,k] S_k[i1..iN]        (scale = alpha / sqrt(k))
//   resid = p - g
//   m'    = b1 m + (1-b1) g
//   v'    = b2 v + (1-b2) g^2
//   w'    = w - lr ((m'/c1) / (sqrt(v'/c2) + eps) + wd w)
// with p, w, m, v, resid, w', m', v' all (nb, d1..dN) float32 buckets.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_update.py::_fused_launch
// (_fused_kernel), which accumulated the reconstruction of a tile in its
// revisited residual block over the k grid axis and ran the optimizer
// epilogue on the last k step, so the dense g never went to HBM.
//
// Design: K2's two launches (sweep_reconstruct.cuh) with a new epilogue in
// place of the store. fold_m_kernel writes the transfer block m once per
// call; recon_gemm_kernel builds the operator tiles S = sum_u g1 m in shared
// memory and keeps each (16*TM batch rows x 128 columns) output tile in
// registers across the whole k depth, so the finished tile IS g, and the
// epilogue reads p, w, m, v at each element's dense offset and writes the
// four outputs. g is never stored.
// lr, c1 and c2 change every step, so they are read from a small float32
// device array (the TPU kernel's s_ref) and never force a host sync; b1, b2,
// eps, wd and the scale are plain arguments. The ragged edges are masked, as
// in K2; nothing is padded.
//
// What bounds it on an H100: the product, 2*nb*k*prod(dims) fp32 flops, and
// the build of the operator tiles, 2*k*prod(dims)*R a batch tile, as K2; the
// epilogue adds 8 dense passes (32 bytes per element), small beside the
// product at the shapes the trainer gives it. The epilogue math is IEEE
// fp32: sqrtf and true division (nvcc's defaults without fast math), because
// the AdamW step amplifies relative error where v' is small.
#include "sweep_reconstruct.cuh"

struct FusedEpilogue {
  const float* p;
  const float* w;
  const float* m1;   // first moment in
  const float* v2;   // second moment in
  float* resid;
  float* w_out;
  float* m1_out;
  float* v2_out;
  const float* scal;  // [lr, c1, c2, unused] on the device
  float scale, b1, omb1, b2, omb2, eps, wd;
  float lr, c1, c2;
  __device__ void begin() {
    lr = scal[0];
    c1 = scal[1];
    c2 = scal[2];
  }
  __device__ void operator()(long long off, float acc) const {
    const float g = acc * scale;
    const float wv = w[off];
    const float m = b1 * m1[off] + omb1 * g;
    const float v = b2 * v2[off] + omb2 * g * g;
    const float step = (m / c1) / (sqrtf(v / c2) + eps);
    resid[off] = p[off] - g;
    w_out[off] = wv - lr * (step + wd * wv);
    m1_out[off] = m;
    v2_out[off] = v;
  }
};

// omb1 = 1 - b1 and omb2 = 1 - b2 come rounded from the caller's doubles.
extern "C" int fused_update_launch(const void* y, const void* scal, const void* p,
                                   const void* w, const void* m1, const void* v2,
                                   void* resid, void* w_out, void* m1_out,
                                   void* v2_out, void* m_scratch,
                                   const void* const* cores, const int* dims,
                                   const int* ops, int order, int B, int K, int R,
                                   int tile_m, int tile_k, int tile_a, int tile_t,
                                   int smem_bytes, float scale,
                                   float b1, float omb1, float b2, float omb2,
                                   float eps, float wd, void* stream) {
  FusedEpilogue epi{static_cast<const float*>(p), static_cast<const float*>(w),
                    static_cast<const float*>(m1), static_cast<const float*>(v2),
                    static_cast<float*>(resid), static_cast<float*>(w_out),
                    static_cast<float*>(m1_out), static_cast<float*>(v2_out),
                    static_cast<const float*>(scal), scale, b1, omb1, b2, omb2,
                    eps, wd, 0.f, 0.f, 0.f};
  return recon_launch(y, m_scratch, cores, dims, ops, order, B, K, R, tile_m,
                      tile_k, tile_a, tile_t, smem_bytes, epi, stream);
}
