"""K3/K6's CUDA source (`csrc/carry_sweep.cu`) run on the CPU.

The host C++ compiler builds the source against a stand-in for the CUDA
runtime: every CUDA thread of a block is a `std::thread`, `__syncthreads`
a `std::barrier`, a `cp.async` copy a plain copy done at once (16-byte
copies checked for alignment), and the blocks of a grid run one after
another. The kernels' own index arithmetic, staging, register tiles,
exchanges and barriers then run as written, on CPU tensors, and are held
against the plain version (`carry_sweep_project_plain`) at tolerance
max|d| / max|ref| <= 1e-4 (float32 on both sides, summed in other
orders). The card runs the same checks (tests/test_torch_gpu.py,
chip_smoke.py); this one needs only `g++` with C++20.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

from repro_torch.core import (random_cp, random_tt, stack_ragged_cp,
                              stack_ragged_tt)
from repro_torch import rp
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels.struct import carry
from repro_torch.kernels.struct import plan as splan
from repro_torch.kernels.struct.ops import _in_operands, struct_rank

PAIRINGS = [("tt", "tt"), ("tt", "cp"), ("cp", "tt"), ("cp", "cp")]

_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
inline std::barrier<>* g_bar = nullptr;
inline float* g_smem = nullptr;
inline unsigned g_dyn = 0;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
// a grid's blocks one after another, each block's threads together; shared
// memory starts as NaN, so a read of a float no thread wrote shows
template <class F>
inline void emu_launch(F f, dim3 grid, int threads, size_t smem, void*) {
  std::vector<float> buf(smem / 4 + 1, std::nanf(""));
  g_smem = buf.data();
  g_dyn = static_cast<unsigned>(smem);
  blockDim = dim3(threads);
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x) {
      blockIdx = dim3(x, y);
      std::barrier<> bar(threads);
      g_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] { threadIdx = dim3(t); f(); });
      for (auto& t : ts) t.join();
    }
}
"""

_STAGE = r"""
#pragma once
#include <cuda_runtime.h>
#include <stdexcept>
static inline void cp_async4(float* dst, const float* src, bool valid) {
  *dst = valid ? *src : 0.f;
}
static inline void cp_async16(float* dst, const float* src, bool valid) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) ||
      (valid && (reinterpret_cast<uintptr_t>(src) & 15)))
    throw std::runtime_error("a 16-byte copy off 16-byte alignment");
  for (int i = 0; i < 4; ++i) dst[i] = valid ? src[i] : 0.f;
}
static inline void cp_async_commit() {}
static inline void cp_async_wait1() {}
static inline long long up4(long long n) { return (n + 3) / 4 * 4; }
"""


def _host_source(text: str) -> str:
    """carry_sweep.cu with its three device-only constructs replaced:
    the shared-memory size query, the dynamic shared array, and the
    `<<<grid, threads, smem, stream>>>` launches."""
    subs = [(r'asm\("mov\.u32 %0, %%dynamic_smem_size;" : "=r"\(have\)\);',
             "have = g_dyn;"),
            (r"extern __shared__ __align__\(16\) float smem\[\];",
             "float* smem = g_smem;"),
            (r"(carry_k[36]<[^<>;]*>)<<<(.*?)>>>\((.*?)\);",
             r"emu_launch([&] { \1(\3); }, \2);")]
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        assert n >= 1, f"carry_sweep.cu no longer has {pattern!r}"
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the source with")
    d = tmp_path_factory.mktemp("carry_source")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    (d / "sweep_stage.cuh").write_text(_STAGE)
    (d / "carry_sweep.cpp").write_text(_host_source(
        (_sweep.CSRC / "carry_sweep.cu").read_text()))
    out = d / "libcarry.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{d}", str(d / "carry_sweep.cpp"),
                    "-o", str(out), "-lpthread"], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(out))
    for name in ("carry_sweep_project_launch",
                 "carry_sweep_project_pipelined_launch"):
        getattr(so, name).argtypes = carry._ARGTYPES
        getattr(so, name).restype = ctypes.c_int
    return so


def _run(lib, cores, n_op, plan, scale):
    """One launch of the source's C entry on CPU tensors."""
    bonds = carry._check(cores, n_op, plan)
    dims, codes, rin, tiles, scalars = carry._lowered(plan, tuple(bonds))
    y = torch.full((plan.b, plan.k), float("nan"))

    def ptrs(ts):
        return (ctypes.c_void_p * 8)(*[t.data_ptr() for t in ts])

    fn = (lib.carry_sweep_project_pipelined_launch
          if plan.pipeline == "double" else lib.carry_sweep_project_launch)
    err = fn(ptrs(cores[:n_op]), ptrs(cores[n_op:]), y.data_ptr(), dims,
             codes, rin, tiles, *scalars, float(scale), None)
    assert err == 0, f"launch returned {err}"
    return y


def _case(of, inf, dims, k, r_op, ranks, b, seed):
    op = rp.make_projector(rp.ProjectorSpec(of, k, dims, r_op), seed,
                           device="cpu")
    opc = ops.tt_cores_squeezed(op) if of == "tt" else op.factors
    g = torch.Generator().manual_seed(seed)
    mk = random_tt if inf == "tt" else random_cp
    st = stack_ragged_tt if inf == "tt" else stack_ragged_cp
    xb = st([mk(g, dims, ranks[i % len(ranks)]) for i in range(b)])
    cores = [c.contiguous() for c in (*opc, *_in_operands(inf, xb))]
    return cores, len(opc), struct_rank(xb)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _plans(plan):
    """The planner's plan and two that split each pair further: two
    d-parts and half as many tile threads as tiles (a thread owns two
    where the carry has more than one), an interior TT operator core
    staged one tile of bond rows a chunk, ragged 5 x 2 and 3 x 3 blocks,
    2- and 3-value d chunks."""
    out = [plan]
    for tk, tb, dc in ((5, 2, 2), (3, 3, 3)):
        p = dataclasses.replace(plan, tps=max(1, plan.n_tiles // 2), tpd=2,
                                tk=tk, tb=tb, dc=dc, uc=plan.ro)
        out.append(dataclasses.replace(
            p, smem_bytes=splan.carry_smem_bytes(p)))
    return out


@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("dims,r_op,ranks", [
    ((5, 6, 7), 5, (2, 3, 4)), ((4, 6, 5, 7), 9, (10, 7, 3)),
    ((3, 4, 5), 16, (16,)), ((6, 5), 17, (20,)),
    ((3, 4, 3, 4), 13, (19, 24, 17))],
    ids=["r5", "order4-r9", "r16", "order2-r17", "r13-inputs17-24"])
def test_carry_source_matches_plain_version(lib, pipeline, pair, dims, r_op,
                                            ranks):
    """K3 (serial) and K6 (double) at k = 7, B = 5 (ragged against every
    block), the four pairings, orders 2-4, bonds 5-17 and input ranks
    2-24, under the planner's plans and `_plans`' splits."""
    of, inf = pair
    cores, n_op, r_in = _case(of, inf, dims, 7, r_op, ranks, 5, seed=3)
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, inf, len(dims)),
        scale=0.5)
    plan = splan.plan_carry_sweep(of, inf, 7, 5, dims, r_op, r_in,
                                  pipeline=pipeline)
    for p in _plans(plan):
        assert _rel(_run(lib, cores, n_op, p, 0.5), ref) <= 1e-4, p


@pytest.mark.parametrize("pair", PAIRINGS, ids="x".join)
@pytest.mark.parametrize("b", [8, 64])
def test_carry_source_at_serving_bonds(lib, pair, b):
    """The serving bonds (TT(5) / CP(25) operators, rank-4 inputs) at a
    serve tick's B=8 (each pair split over d-parts) and at B=64, dims
    (8, 8, 8), k = 16, K3 and K6 under the planner's plans."""
    of, inf = pair
    r_op = 5 if of == "tt" else 25
    dims = (8, 8, 8)
    cores, n_op, r_in = _case(of, inf, dims, 16, r_op, (4,), b, seed=5)
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, inf, 3),
        scale=0.25)
    for pipeline in ("serial", "double"):
        plan = splan.plan_carry_sweep(of, inf, 16, b, dims, r_op, r_in,
                                      pipeline=pipeline)
        assert _rel(_run(lib, cores, n_op, plan, 0.25), ref) <= 1e-4


def test_carry_source_stages_a_large_tt_core_in_row_chunks(lib):
    """A TT(180) operator whose interior core K3 stages 155 bond rows a
    chunk (one value of d of a k-row does not fit twice in a block)."""
    cores, n_op, r_in = _case("tt", "tt", (3, 3, 3), 2, 180, (2, 3, 4), 3,
                              seed=7)
    plan = splan.plan_carry_sweep("tt", "tt", 2, 3, (3, 3, 3), 180, r_in)
    assert plan.uc < 180
    ref = carry.carry_sweep_project_plain(*cores, n_op=n_op,
                                          program=plan.program, scale=1.0)
    assert _rel(_run(lib, cores, n_op, plan, 1.0), ref) <= 1e-4


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("of,r_op", [("tt", 10), ("cp", 100)],
                         ids=["tt10", "cp100"])
def test_carry_source_at_fig1_small_case_shapes(lib, of, r_op, b):
    """The paper's Fig. 1 small case: modes of 15 (not a multiple of the
    4 floats of a 16-byte copy), TT(10) and CP(100) operators (60 register
    tiles a pair) on unit-norm rank-10 TT inputs, K3 under the planner's
    plan and two splits within a block's CARRY_THREADS: half as many tile
    threads as tiles over 2 d-parts, one bond-row tile a chunk, ragged
    2- and 3-value d chunks, at k = 6."""
    dims = (15, 15, 15)
    cores, n_op, r_in = _case(of, "tt", dims, 6, r_op, (10,), b, seed=11)
    ref = carry.carry_sweep_project_plain(
        *cores, n_op=n_op, program=splan._carry_program(of, "tt", 3),
        scale=0.5)
    plan = splan.plan_carry_sweep(of, "tt", 6, b, dims, r_op, r_in)
    plans = [plan]
    for tk, dc in ((1, 2), (2, 3)):
        p = dataclasses.replace(plan, tps=max(1, plan.n_tiles // 2), tpd=2,
                                tk=tk, tb=1, dc=dc, uc=plan.ro)
        assert p.tk * p.tb * p.tps * p.tpd <= splan.CARRY_THREADS
        plans.append(dataclasses.replace(
            p, smem_bytes=splan.carry_smem_bytes(p)))
    for p in plans:
        assert _rel(_run(lib, cores, n_op, p, 0.5), ref) <= 1e-4, p
