// Staging and operator-tile helpers shared by the project sweep (K1/K5,
// sweep_project.cu) and the reconstruct sweep (K2/K4, sweep_reconstruct.cuh),
// which both build operator tiles S[i, a, t] = sum_u g1[i, a, u] m[i, u, t]
// in shared memory from the leading core and the fold's transfer block m.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

static __device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                                 bool valid) {
  // 4-byte asynchronous copy global -> shared; zero-fills dst when !valid
  // (src-size 0 reads nothing, but src must still be a mapped address)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
static __device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                                  bool valid) {
  // 16-byte asynchronous copy global -> shared (both 16-byte aligned)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One piece of a staging copy: W floats from src to dst, dst's floats
// `stride` apart; zeros where !ok.
struct Piece {
  const float* src;
  float* dst;
  int stride;
  bool ok;
};
template <int V>
struct Int {
  static constexpr int value = V;
};

// n / d for 0 <= n < 2^22 without an integer division: the float quotient,
// corrected by one either way.
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ int operator()(int n) const {
    int q = __float2int_rz(__int2float_rz(n) * inv);
    q -= q * d > n;
    q += (q + 1) * d <= n;
    return q;
  }
};
static __device__ __forceinline__ FastDiv fast_div(int d) { return {d, 1.f / d}; }

static __host__ __device__ inline long long up4(long long n) { return (n + 3) / 4 * 4; }

// A staging copy of n pieces of W floats (W = 4 where the rows of the source
// are multiples of 16 bytes, else 1) by NT threads; piece(e, width) gives
// piece e's source, its destination, the stride between its floats there
// (1: contiguous) and whether it lies inside the operands (else zeros). With
// PIPE the pieces go as cp.async copies (the caller commits and waits);
// without it each thread loads SB pieces into registers before it stores
// them, so their latencies overlap.
template <int NT, int SB, bool PIPE, int W, class PieceFn>
static __device__ __forceinline__ void stage_copy(Int<W> width, int tid, int n,
                                                  PieceFn piece, const float* base) {
  for (int e0 = tid; e0 < n; e0 += NT * SB) {
    float v[SB][W];
    Piece dst[SB];
#pragma unroll
    for (int b = 0; b < SB; ++b) {
      const int e = e0 + b * NT;
      if (e >= n) break;
      dst[b] = piece(e, width);
      const bool ok = dst[b].ok;
      if (PIPE) {
        if (W == 4 && dst[b].stride == 1) {
          cp_async16(dst[b].dst, ok ? dst[b].src : base, ok);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w)
            cp_async4(dst[b].dst + w * dst[b].stride, ok ? dst[b].src + w : base, ok);
        }
      } else if constexpr (W == 4) {
        const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(dst[b].src))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[b][0] = x.x; v[b][1] = x.y; v[b][2] = x.z; v[b][3] = x.w;
      } else {
        v[b][0] = ok ? __ldg(dst[b].src) : 0.f;
      }
    }
    if (!PIPE) {
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        if (e0 + b * NT >= n) break;
        if constexpr (W == 4) {
          if (dst[b].stride == 1) {
            *reinterpret_cast<float4*>(dst[b].dst) =
                make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
            continue;
          }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) dst[b].dst[w * dst[b].stride] = v[b][w];
      }
    }
  }
}

// The operator tile S[i, al, t] = sum_u g[i, al, u] m[i, u, t] for NR k-rows
// i, ac leading indices al and tc columns t (tc = 1 << lt, a power of 2 from
// 4), built by NT threads from the staged slab of the leading core (g at
// gs[(al*R + u)*NR + i]) and the staged chunk of m (at ms[i*m_stride + u*tc
// + t]). A unit is four columns t of one k-row for up to four leading
// indices, so one float4 read of m feeds sixteen FMAs; k-rows across the
// lanes. store(i, al, t, s) writes S[i, al, t .. t+3] = s.
template <int NR, int NT, class Store>
static __device__ __forceinline__ void build_operator_tile(const float* gs, const float* ms,
                                                           int m_stride, int R, int tc,
                                                           int lt, int ac, int tid,
                                                           Store store) {
  const int lq = lt - 2, nal = (ac + 3) / 4;
  for (int e = tid; e < (nal * NR) << lq; e += NT) {
    const int i = e % NR, r = e / NR, q = r & ((1 << lq) - 1), al0 = (r >> lq) * 4;
    const int na = min(4, ac - al0);
    const float* gp = gs + al0 * R * NR + i;
    const float* mp = ms + i * m_stride + q * 4;
    float4 s[4] = {};
    for (int u = 0; u < R; ++u) {
      const float4 mv = *reinterpret_cast<const float4*>(mp + u * tc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < na) {
          const float g = gp[(j * R + u) * NR];
          s[j].x = fmaf(g, mv.x, s[j].x);
          s[j].y = fmaf(g, mv.y, s[j].y);
          s[j].z = fmaf(g, mv.z, s[j].z);
          s[j].w = fmaf(g, mv.w, s[j].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < na) store(i, al0 + j, q * 4, s[j]);
  }
}
