"""K4's CUDA source (`csrc/fused_update.cu`, with K2's device code in
`sweep_reconstruct.cuh`) run on the CPU, its block form beside the
whole-leaf form.

As `tests/test_torch_carry_source.py` does for K3/K6, the host C++
compiler builds the source against a stand-in for the CUDA runtime (each
CUDA thread a `std::thread`, `__syncthreads` a `std::barrier`, the blocks
of a grid one after another, shared memory NaN-filled), with the few
device intrinsics the reconstruct sweep uses written out (`float4`,
`__ldg`, `__ffs`, the round-toward-zero conversions) and the `cp.async`
copies, which K2/K4 do not issue, left empty. Its two C entries then run
on CPU tensors: `fused_update_launch` (the leaf's buckets) and
`fused_update_block_launch` (the whole gradient, a rank's block of w, m,
v). The block form's residual and its w', m', v' are bit-equal to the
whole-leaf form's on the same leaf and the block's elements, for leaves
split on dim 0, 1 and 2 and unsplit, each with a padded last bucket; and
both are within 1e-5 of max|ref| of the plain versions (float32, other
summation order). The card runs the same checks (`chip_smoke.py`).
"""
import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

from repro_torch import rp
from repro_torch.kernels import _sweep, ops
from repro_torch.kernels import fused_update as fused

from test_torch_carry_source import _RUNTIME

HP = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
LR, C1, C2 = 1e-3, 0.1, 0.05

_DEVICE = r"""
#pragma once
#include "cuda_base.h"
#undef __launch_bounds__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float2int_rz(float x) { return static_cast<int>(x); }
inline float __int2float_rz(int n) { return static_cast<float>(n); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F*, int, int) { return 0; }
"""


def _host(text: str, name: str) -> str:
    """A source with its device-only constructs replaced: the inline
    `cp.async` assembly (left empty), the dynamic shared array and the
    `<<<grid, threads, smem, stream>>>` launches."""
    subs = {"sweep_stage.cuh": [
                (r"asm volatile\(.*?\);", ""),
                (r"__cvta_generic_to_shared\(dst\)", "0")],
            "sweep_reconstruct.cuh": [
                (r"extern __shared__ __align__\(16\) float smem\[\];",
                 "float* smem = g_smem;"),
                (r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\((.*?)\);",
                 r"emu_launch([&] { \1(\3); }, \2);")]}
    for pattern, repl in subs.get(name, []):
        text, n = re.subn(pattern, repl, text, flags=re.S)
        assert n >= 1, f"{name} no longer has {pattern!r}"
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the source with")
    d = tmp_path_factory.mktemp("fused_source")
    (d / "cuda_base.h").write_text(_RUNTIME)
    (d / "cuda_runtime.h").write_text(_DEVICE)
    for name in ("sweep_common.cuh", "sweep_fold.cuh", "sweep_stage.cuh",
                 "sweep_reconstruct.cuh"):
        (d / name).write_text(_host((_sweep.CSRC / name).read_text(), name))
    (d / "fused_update.cpp").write_text(
        (_sweep.CSRC / "fused_update.cu").read_text())
    out = d / "libfused.so"
    subprocess.run([gxx, "-std=c++20", "-O0", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{d}",
                    str(d / "fused_update.cpp"), "-o", str(out),
                    "-lpthread"], check=True, capture_output=True)
    so = ctypes.CDLL(str(out))
    for entry in ("fused_update", "fused_update_block"):
        fn = getattr(so, f"{entry}_launch")
        fn.argtypes = _sweep._ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return so


def _launch(lib, entry, op, y, dense, outs, tail):
    """One launch of a C entry of the source on CPU tensors, its
    arguments laid out as `_sweep._launch_reconstruct` lays them out."""
    family, cores = fused._operator(op)
    plan = fused.plan_fused_update(family, op.k, y.shape[0], op.in_dims,
                                   op.rank)
    m = torch.full(plan.m_scratch_shape, float("nan"))
    lead = cores[0].permute(1, 2, 0).contiguous()
    scal = torch.tensor([LR, C1, C2, 0.0])
    err = getattr(lib, f"{entry}_launch")(
        y.data_ptr(), scal.data_ptr(), *(t.data_ptr() for t in dense + outs),
        m.data_ptr(), _sweep._pointers((lead,) + tuple(cores[1:])),
        _sweep._ints(plan.dims), _sweep._ints(ops.program_codes(plan)),
        plan.order, plan.b, plan.k, plan.rank, plan.tb, plan.tk, plan.ba,
        plan.tc, plan.smem_bytes, HP["alpha"] / math.sqrt(op.k), HP["b1"],
        1.0 - HP["b1"], HP["b2"], 1.0 - HP["b2"], HP["eps"],
        HP["weight_decay"], *tail, None)
    assert err == 0, f"{entry} returned {err}"


# (family, bucket dims, k, rank, leaf shape, split dim or None, ranks)
CASES = {"dim0": ("tt", (4, 8, 16), 40, 2, (6, 50, 3), 0, 2),
         "dim1": ("cp", (4, 8, 16), 40, 3, (3, 10, 22), 1, 2),
         "dim2": ("tt", (6, 10, 14), 37, 12, (2, 5, 170), 2, 2),
         "unsplit": ("cp", (12, 20), 37, 3, (500,), None, 1)}


@pytest.mark.parametrize("case", list(CASES))
def test_block_source_is_the_whole_sources_block_bit_for_bit(lib, case):
    family, dims, k, rank, shape, d, ranks = CASES[case]
    op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank), 3,
                           device="cpu")
    g = torch.Generator().manual_seed(5)
    size, bucket = math.prod(shape), math.prod(dims)
    nb = -(-size // bucket)
    assert size % bucket      # a padded last bucket
    y = torch.randn((nb, k), generator=g)
    p, w, m, v = (torch.randn(shape, generator=g) for _ in range(4))
    v = v.abs()

    def buckets(t):
        flat = torch.zeros(nb * bucket)
        flat[:size] = t.reshape(-1)
        return flat.reshape((nb,) + dims)

    dense = tuple(buckets(t) for t in (p, w, m, v))
    whole = tuple(torch.full_like(dense[0], float("nan")) for _ in range(4))
    _launch(lib, "fused_update", op, y, dense, whole, ())
    plain = fused.fused_update_buckets_plain(op, y, *dense, LR, C1, C2, **HP)
    for a, b in zip(whole, plain):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    whole = [t.reshape(-1)[:size].reshape(shape) for t in whole]
    n = shape[d] // ranks if d is not None else 1
    for r in range(ranks):
        layout = (fused.BlockLayout.of(shape) if d is None else
                  fused.BlockLayout.of(shape, d, r * n, (r + 1) * n))
        index = tuple(slice(r * n, (r + 1) * n) if i == d else slice(None)
                      for i in range(len(shape)))
        blk = tuple(t[index].contiguous() for t in (w, m, v))
        outs = (torch.full_like(p, float("nan")),) + tuple(
            torch.full_like(blk[0], float("nan")) for _ in range(3))
        _launch(lib, "fused_update_block", op, y, (p,) + blk, outs,
                (layout.size, layout.n_d, layout.inner, layout.lo,
                 layout.hi))
        assert torch.equal(outs[0], whole[0])
        for a, b in zip(outs[1:], whole[1:]):
            assert torch.equal(a, b[index])
        ref = fused.fused_update_block_plain(op, y, p, *blk, LR, C1, C2,
                                             layout=layout, **HP)
        for a, b in zip(outs, ref):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_block_source_refuses_a_bad_layout(lib):
    op = rp.make_projector(rp.ProjectorSpec("tt", 40, (4, 8, 16), 2), 3,
                           device="cpu")
    y, p = torch.zeros(1, 40), torch.zeros(300)
    blk = tuple(torch.zeros(150) for _ in range(3))
    outs = (torch.zeros(300),) + tuple(torch.zeros(150) for _ in range(3))
    with pytest.raises(AssertionError, match="returned 1"):   # lo >= hi
        _launch(lib, "fused_update_block", op, y, (p,) + blk, outs,
                (300, 300, 1, 150, 150))
    with pytest.raises(AssertionError, match="returned 1"):   # not a block
        _launch(lib, "fused_update_block", op, y, (p,) + blk, outs,
                (300, 7, 1, 0, 3))
