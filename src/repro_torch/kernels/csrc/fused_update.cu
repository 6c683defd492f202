// K4: fused_update — unsketch + error feedback + AdamW for one leaf's buckets,
// orders 2..8, TT and CP:
//   g     = scale * sum_k y[n,k] S_k[i1..iN]        (scale = alpha / sqrt(k))
//   resid = p - g
//   m'    = b1 m + (1-b1) g
//   v'    = b2 v + (1-b2) g^2
//   w'    = w - lr ((m'/c1) / (sqrt(v'/c2) + eps) + wd w)
// with p, w, m, v, resid, w', m', v' all (nb, d1..dN) float32 buckets; or, in
// the block form (fused_update_block_launch, a data mesh's rank, and
// fused_update_block2_launch, a rank of a (data, model) mesh whose block is
// split on two dims), p and resid the whole leaf and w, m, v, w', m', v' the
// rank's block of it.
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
//
// The block forms share the kernels: the whole-leaf form is their case of a
// block that is the whole of its buckets (lo = 0, hi = n_d), for which the
// block offset is the element's own and the epilogue skips the index
// arithmetic (a branch the same for every thread of the launch), and the
// one-dim block the case without a second range. One epilogue type keeps
// one set of recon_gemm instantiations, so the source builds in one of K2's
// times; the block offset's 64-bit arithmetic sits out of line, one copy for
// all of them.
#include "sweep_reconstruct.cuh"

// nvcc's headers define __noinline__; a host compiler that checks the index
// arithmetic against a stand-in runtime may not.
#ifndef __noinline__
#define __noinline__ __attribute__((noinline))
#endif

// Where a block holds the element at flat offset `off` of the leaf: the
// offset in the block, or -1 outside it (see FusedEpilogue).
struct BlockIndex {
  long long span, inner, lo, hi;                // dim a: span = n_d * inner
  long long span_b, inner_b, lo_b, hi_b, inner_blk;  // dim b: span_b = n_b * inner_b
  bool two;                                     // a second range
};

// (the fields as scalars: a struct argument of an out-of-line call would go
// through local memory)
__device__ __noinline__ long long block_offset(long long off, long long span,
                                               long long inner, long long lo,
                                               long long hi, long long span_b,
                                               long long inner_b, long long lo_b,
                                               long long hi_b, long long inner_blk,
                                               bool two) {
  const long long o = off / span, r = off - o * span, j = r / inner;
  if (j < lo || j >= hi) return -1;
  long long r1 = r - j * inner;
  if (two) {
    const long long mi = r1 / span_b, r2 = r1 - mi * span_b, jb = r2 / inner_b;
    if (jb < lo_b || jb >= hi_b) return -1;
    r1 = (mi * (hi_b - lo_b) + jb - lo_b) * inner_b + (r2 - jb * inner_b);
  }
  return (o * (hi - lo) + j - lo) * inner_blk + r1;
}

// The epilogue, block-addressed. Around its split dim a the leaf is (outer,
// n_d, inner); the caller holds [lo, hi) of that dim. A two-dim block (a
// second split dim b > a) reads inner as (mid, n_b, inner_b) and holds
// [lo_b, hi_b) of dim b too; the block (outer, hi - lo, inner_blk) is
// contiguous, inner_blk = inner for a one-dim block and mid * (hi_b - lo_b)
// * inner_b for a two-dim one. recon_gemm hands over each element's flat
// offset in the leaf's buckets (y starts at the leaf's first bucket). An
// element at off < size writes resid[off]; it writes the AdamW outputs
// only where its indices on the split dims lie in their ranges, at the
// block's offset, reading w, m, v there. Offsets past size are the padded
// last bucket and write nothing. The whole-leaf form passes size = every
// element of its buckets, n_d = size, inner = 1, lo = 0, hi = size.
struct FusedEpilogue {
  const float* p;     // the error-fed gradient (size floats)
  const float* w;     // w, m, v: the block
  const float* m1;    // first moment in
  const float* v2;    // second moment in
  float* resid;       // size floats
  float* w_out;       // w', m', v': the block
  float* m1_out;
  float* v2_out;
  const float* scal;  // [lr, c1, c2, unused] on the device
  long long size;
  BlockIndex index;
  float scale, b1, omb1, b2, omb2, eps, wd;
  float lr, c1, c2;
  bool whole;         // lo = 0 and hi = n_d, no second range
  __device__ void begin() {
    lr = scal[0];
    c1 = scal[1];
    c2 = scal[2];
  }
  __device__ void operator()(long long off, float acc) const {
    if (off >= size) return;
    const float g = acc * scale;
    long long b = off;
    if (!whole) {
      const BlockIndex& x = index;
      b = block_offset(off, x.span, x.inner, x.lo, x.hi, x.span_b, x.inner_b, x.lo_b,
                       x.hi_b, x.inner_blk, x.two);
      if (b < 0) {
        resid[off] = p[off] - g;
        return;
      }
    }
    // the loads before the first store, as the whole-leaf epilogue always
    // had them: the outputs may alias nothing the compiler can prove
    const float wv = w[b];
    const float m = b1 * m1[b] + omb1 * g;
    const float v = b2 * v2[b] + omb2 * g * g;
    const float step = (m / c1) / (sqrtf(v / c2) + eps);
    resid[off] = p[off] - g;
    w_out[b] = wv - lr * (step + wd * wv);
    m1_out[b] = m;
    v2_out[b] = v;
  }
};

static int fused_launch(const void* y, const void* scal, const void* p, const void* w,
                        const void* m1, const void* v2, void* resid, void* w_out,
                        void* m1_out, void* v2_out, void* m_scratch,
                        const void* const* cores, const int* dims, const int* ops,
                        int order, int B, int K, int R, int tile_m, int tile_k,
                        int tile_a, int tile_t, int smem_bytes, float scale, float b1,
                        float omb1, float b2, float omb2, float eps, float wd,
                        long long size, long long n_d, long long inner, long long lo,
                        long long hi, long long n_b, long long inner_b, long long lo_b,
                        long long hi_b, void* stream) {
  if (size < 1 || n_d < 1 || inner < 1 || size % (n_d * inner) != 0 || lo < 0 ||
      hi > n_d || lo >= hi || n_b < 1 || inner_b < 1 || inner % (n_b * inner_b) != 0 ||
      lo_b < 0 || hi_b > n_b || lo_b >= hi_b)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = !(n_b == 1 && inner_b == 1 && lo_b == 0 && hi_b == 1);
  const long long inner_blk =
      two ? inner / (n_b * inner_b) * (hi_b - lo_b) * inner_b : inner;
  const BlockIndex index{n_d * inner, inner, lo, hi, n_b * inner_b, inner_b, lo_b,
                         hi_b, inner_blk, two};
  FusedEpilogue epi{static_cast<const float*>(p), static_cast<const float*>(w),
                    static_cast<const float*>(m1), static_cast<const float*>(v2),
                    static_cast<float*>(resid), static_cast<float*>(w_out),
                    static_cast<float*>(m1_out), static_cast<float*>(v2_out),
                    static_cast<const float*>(scal), size, index, scale, b1,
                    omb1, b2, omb2, eps, wd, 0.f, 0.f, 0.f,
                    lo == 0 && hi == n_d && !two};
  return recon_launch(y, m_scratch, cores, dims, ops, order, B, K, R, tile_m,
                      tile_k, tile_a, tile_t, smem_bytes, epi, stream);
}

// p, w, m, v and the outputs: (B, d1..dN) buckets. omb1 = 1 - b1 and
// omb2 = 1 - b2 come rounded from the caller's doubles.
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
  long long size = B;
  for (int i = 0; i < order && i < SWEEP_MAX_ORDER; ++i) size *= dims[i];
  return fused_launch(y, scal, p, w, m1, v2, resid, w_out, m1_out, v2_out, m_scratch,
                      cores, dims, ops, order, B, K, R, tile_m, tile_k, tile_a, tile_t,
                      smem_bytes, scale, b1, omb1, b2, omb2, eps, wd, size, size, 1, 0,
                      size, 1, 1, 0, 1, stream);
}

// The block form, for a rank of a data mesh: p and resid the whole leaf
// (size floats), w, m1, v2 and their outputs the rank's block; y holds the
// leaf's B buckets.
extern "C" int fused_update_block_launch(
    const void* y, const void* scal, const void* p, const void* w, const void* m1,
    const void* v2, void* resid, void* w_out, void* m1_out, void* v2_out,
    void* m_scratch, const void* const* cores, const int* dims, const int* ops,
    int order, int B, int K, int R, int tile_m, int tile_k, int tile_a, int tile_t,
    int smem_bytes, float scale, float b1, float omb1, float b2, float omb2,
    float eps, float wd, long long size, long long n_d, long long inner,
    long long lo, long long hi, void* stream) {
  return fused_launch(y, scal, p, w, m1, v2, resid, w_out, m1_out, v2_out, m_scratch,
                      cores, dims, ops, order, B, K, R, tile_m, tile_k, tile_a, tile_t,
                      smem_bytes, scale, b1, omb1, b2, omb2, eps, wd, size, n_d, inner,
                      lo, hi, 1, 1, 0, 1, stream);
}

// The two-dim block form, for a rank of a (data, model) mesh: the one-dim
// block's arguments, then the second split dim's n_b and inner_b (the
// elements after it) and the rank's range [lo_b, hi_b) of it.
extern "C" int fused_update_block2_launch(
    const void* y, const void* scal, const void* p, const void* w, const void* m1,
    const void* v2, void* resid, void* w_out, void* m1_out, void* v2_out,
    void* m_scratch, const void* const* cores, const int* dims, const int* ops,
    int order, int B, int K, int R, int tile_m, int tile_k, int tile_a, int tile_t,
    int smem_bytes, float scale, float b1, float omb1, float b2, float omb2,
    float eps, float wd, long long size, long long n_d, long long inner,
    long long lo, long long hi, long long n_b, long long inner_b, long long lo_b,
    long long hi_b, void* stream) {
  return fused_launch(y, scal, p, w, m1, v2, resid, w_out, m1_out, v2_out, m_scratch,
                      cores, dims, ops, order, B, K, R, tile_m, tile_k, tile_a, tile_t,
                      smem_bytes, scale, b1, omb1, b2, omb2, eps, wd, size, n_d, inner,
                      lo, hi, n_b, inner_b, lo_b, hi_b, stream);
}
