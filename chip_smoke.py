#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. the device: name, count, `nvidia-smi` name and power limit; TF32 off.
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, started together) and print ptxas' register, shared
     memory and spill lines.
  3. hold K1 `sweep_project` and K2 `sweep_reconstruct` against their plain
     PyTorch versions on the card: TT and CP, orders 2-5, ragged small
     shapes, and the serving shapes.
  4. serve 1024 dense TT(5) requests through `SketchServer`
     (k=512, dims 64x64x64, max_batch=64, flush_us=1000) and check every
     tick launched K1 once; query the store.
  5. serve 256 dense CP(25) requests the same way.
  6. reconstruct 64 stored sketches of each through `rp.reconstruct` (K2).
  7. time K1 and K2 at the serving shapes (B=64) beside their bound, their
     plain versions and one `torch.einsum` of the whole contraction. The
     bound counts the flops of the cheaper of two routes to the same
     function: the sweep program, or building the dense (k, prod(dims))
     operator and one product with it; the sweep program's own bound is
     printed beside it as `program_bound_ms`.
Then it prints the `kernels` JSON line, the card's name and power limit,
and as its last line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
TOL = 1e-4            # max|kernel - plain| / max|plain|: fp32, other sum order
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SLICE_DIMS = (64, 64, 64)
SLICE_K = 512
SLICE_RANKS = {"tt": 5, "cp": 25}
SMALL_DIMS = {2: (12, 20), 3: (6, 10, 14), 4: (4, 6, 5, 7), 5: (3, 4, 5, 3, 6)}
SOURCES = {"sweep_project": "src/repro_torch/kernels/csrc/sweep_project.cu",
           "sweep_reconstruct":
               "src/repro_torch/kernels/csrc/sweep_reconstruct.cu"}
REPLACES = {"sweep_project": "src/repro/kernels/_sweep.py:118",
            "sweep_reconstruct": "src/repro/kernels/_sweep.py:236"}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|); raises on non-finite."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output holds non-finite values")
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def check(name: str, got, ref) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    diff, rel = rel_err(got, ref)
    log(f"{name}: max|d|={diff:.3e} max|d|/max|ref|={rel:.3e}")
    if rel > TOL:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {TOL}")
    return diff


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn()` over `reps` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dense_operator_flops(family: str, k: int, dims, rank: int) -> int:
    """Flops to build the dense (k, prod(dims)) operator from its cores,
    left to right: each TT step a product over one bond, each CP step a
    Hadamard product, and the last core's contraction over the bond."""
    total, prefix = 0, dims[0]
    for d in dims[1:-1]:
        prefix *= d
        total += (2 * k * prefix * rank * rank if family == "tt"
                  else k * prefix * rank)
    return total + 2 * k * math.prod(dims) * rank


def kernel_operands(op, family):
    from repro_torch.kernels import ops
    cores = ops.tt_cores_squeezed(op) if family == "tt" else op.factors
    return tuple(c.contiguous() for c in cores)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import rp
    from repro_torch.core import theory
    from repro_torch.kernels import _sweep, ops
    from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                                   replay, synth_trace)

    # -- 1. device --------------------------------------------------------
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _sweep.build()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions ------------------------------------
    errs: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def hold(family, dims, k, rank, b, tag):
        op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank),
                               seed=7, device=dev)
        cores = kernel_operands(op, family)
        scale = 1.0 / math.sqrt(k)
        x = torch.randn((b,) + dims, generator=gen, device=dev)
        pplan = ops.plan_contraction(family, "project", k, b, dims, rank)
        got = _sweep.sweep_project(x, *cores, plan=pplan, scale=scale)
        ref = _sweep.sweep_project_plain(x, *cores, steps=pplan.steps,
                                         scale=scale)
        key = f"sweep_project:{family}"
        errs[key] = max(errs.get(key, 0.0),
                        check(f"K1 {family} {tag} dims={dims} k={k} "
                              f"R={rank} B={b}", got, ref))
        y = torch.randn((b, k), generator=gen, device=dev)
        rplan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
        got = _sweep.sweep_reconstruct(y, *cores, plan=rplan, scale=scale)
        ref = _sweep.sweep_reconstruct_plain(y, *cores, steps=rplan.steps,
                                             scale=scale)
        key = f"sweep_reconstruct:{family}"
        errs[key] = max(errs.get(key, 0.0),
                        check(f"K2 {family} {tag} dims={dims} k={k} "
                              f"R={rank} B={b}", got, ref))
        torch.cuda.synchronize()

    for family in ("tt", "cp"):
        for order, dims in SMALL_DIMS.items():
            hold(family, dims, 37, 3, 3, f"order {order}")
        hold(family, (4, 4, 4, 4, 4, 4), 20, 2, 3, "order 6")
        hold(family, SLICE_DIMS, SLICE_K, SLICE_RANKS[family], 64, "slice")
        torch.cuda.empty_cache()

    # -- 4./5. serve dense traffic ----------------------------------------
    class TimedServer(SketchServer):
        """Records CUDA events around every tick that served requests."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.tick_events = []

        def tick(self, now, *, force=False):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            n = super().tick(now, force=force)
            e.record()
            if n:
                self.tick_events.append((s, e))
            return n

    launches = {"sweep_project": 0, "sweep_reconstruct": 0}
    per_family = {}
    stores = {}

    def serve(family, n_requests):
        spec = rp.ProjectorSpec(family=family, k=SLICE_K, dims=SLICE_DIMS,
                                rank=SLICE_RANKS[family])
        store = SketchStore(spec, device=dev)
        server = TimedServer(ServeConfig(max_batch=64, flush_us=1000.0),
                             store, device=dev)
        trace = synth_trace(n_requests, [(spec, 0)], mix=(1.0, 0.0, 0.0),
                            mean_gap_us=200.0, seed=0)
        torch.cuda.synchronize()
        _sweep.reset_launch_counts()
        with rp.dispatch_stats() as st:
            report = replay(server, trace)
            torch.cuda.synchronize()
        k1 = _sweep.sweep_project.launches
        ticks = report["ticks"]
        if report["requests_done"] != n_requests:
            raise AssertionError(f"{report['requests_done']} of "
                                 f"{n_requests} requests served")
        if k1 != ticks or st.kernel_calls != ticks:
            raise AssertionError(f"{family}: K1 launches {k1}, "
                                 f"kernel_call_count {st.kernel_calls}, "
                                 f"ticks {ticks}")
        launches["sweep_project"] += k1
        per_family[f"sweep_project:{family}"] = k1
        dev_ms = [s.elapsed_time(e) for s, e in server.tick_events]
        log(f"serve {family.upper()}(R={spec.rank}) k={spec.k} dims="
            f"{spec.dims}: {n_requests} requests, {ticks} ticks, K1 "
            f"launches {k1} == kernel_call_count {st.kernel_calls} == "
            f"ticks; p50={report['p50_us']:.1f}us p99="
            f"{report['p99_us']:.1f}us (trace clock) occupancy="
            f"{report['occupancy_mean']:.3f} cache hit rate="
            f"{report['cache']['hit_rate']:.4f} wall={report['wall_s']:.3f}s"
            f" device ms/tick mean={sum(dev_ms) / len(dev_ms):.3f} "
            f"max={max(dev_ms):.3f}")
        # served sketches agree with the operator's einsum route
        op = server.cache.get(spec, 0)
        rows = [r for r in server.done if r.rid < 8]
        xs = torch.stack([rp.dispatch._coerce_dense(
            op, torch.as_tensor(trace[r.rid].payload, device=dev))
            for r in rows])
        check(f"served {family} sketches vs op.project",
              torch.stack([store.get(r.store_id) for r in rows]),
              op.project(xs))
        res = server.query(store.get(0), top_m=5)
        if int(res.ids[0]) != 0 or not math.isfinite(float(res.dist2[-1])):
            raise AssertionError(f"query of sketch 0 returned {res.ids}")
        pw = server.pairwise([0], [int(res.ids[-1])])
        log(f"query top-5 of sketch 0: ids {res.ids.tolist()} d2 "
            f"{[round(float(d), 2) for d in res.dist2]}; pairwise d2="
            f"{pw.dist2[0]:.2f} in [{pw.dist2_lo[0]:.2f}, "
            f"{pw.dist2_hi[0]:.2f}] (eps={pw.eps:.3f} @ delta={pw.delta})")
        stores[family] = (op, store)

    serve("tt", 1024)
    serve("cp", 256)

    # -- 6. reconstruct stored sketches -----------------------------------
    outs = {}
    for family, (op, store) in stores.items():
        y = store.get(range(64))
        torch.cuda.synchronize()
        _sweep.reset_launch_counts()
        with rp.dispatch_stats() as st:
            outs[family] = rp.reconstruct(op, y)
            torch.cuda.synchronize()
        k2 = _sweep.sweep_reconstruct.launches
        if (k2 != 1 or st.kernel_calls != 1
                or _sweep.sweep_project.launches != 0):
            raise AssertionError(
                f"reconstruct {family}: K2 launches {k2}, K1 launches "
                f"{_sweep.sweep_project.launches}, kernel_call_count "
                f"{st.kernel_calls}; expected one K2 launch")
        launches["sweep_reconstruct"] += k2
        per_family[f"sweep_reconstruct:{family}"] = k2
        plan = ops.plan_contraction(family, "reconstruct", op.k, 64,
                                    op.in_dims, op.rank)
        ref = _sweep.sweep_reconstruct_plain(
            y, *kernel_operands(op, family), steps=plan.steps,
            scale=1.0 / math.sqrt(op.k))
        check(f"reconstruct {family} (64, {op.k}) -> "
              f"{tuple(outs[family].shape)}", outs[family], ref)
        log(f"reconstruct {family}: K2 launches {k2} == kernel_call_count "
            f"{st.kernel_calls}")
    del outs
    torch.cuda.empty_cache()

    # -- 7. times at the serving shapes -----------------------------------
    rows = []
    for family in ("tt", "cp"):
        op, store = stores[family]
        cores = kernel_operands(op, family)
        dims, k, rank, b = op.in_dims, op.k, op.rank, 64
        scale = 1.0 / math.sqrt(k)
        x = torch.randn((b,) + dims, generator=gen, device=dev)
        y = store.get(range(b))
        core_bytes = 4 * sum(c.numel() for c in cores)
        x_bytes, y_bytes = 4 * x.numel(), 4 * y.numel()
        trail = math.prod(dims[1:])
        letters = "abcdefgh"[:len(dims)]
        n_modes = len(dims)
        if family == "tt":
            bonds = "pqstuvw"
            terms = ([f"k{letters[0]}{bonds[0]}"]
                     + [f"k{bonds[i - 1]}{letters[i]}{bonds[i]}"
                        for i in range(1, n_modes - 1)]
                     + [f"k{bonds[n_modes - 2]}{letters[-1]}"])
            p_flops = theory.flops_project_dense_tt(k, dims, rank) * b
            fold = 2 * k * rank * rank * trail * (n_modes - 2)
        else:
            terms = [f"k{c}r" for c in letters]
            p_flops = theory.flops_project_dense_cp(k, dims, rank) * b
            fold = k * rank * trail * (n_modes - 2)
        # the (B*d1, k*R) x (k*R, d2..dN) product, the fold, the graft
        r_flops = (2 * b * dims[0] * k * rank * trail + fold
                   + b * dims[0] * k * rank)
        # the cheaper route at small B: the dense (k, prod(dims)) operator,
        # then one (B, D) x (D, k) product either way
        dense = (dense_operator_flops(family, k, dims, rank)
                 + 2 * b * k * math.prod(dims))
        p_spec = f"n{letters}," + ",".join(terms) + "->nk"
        r_spec = "nk," + ",".join(terms) + f"->n{letters}"
        pplan = ops.plan_contraction(family, "project", k, b, dims, rank)
        rplan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
        cases = [
            ("sweep_project", p_flops, x_bytes + core_bytes + y_bytes,
             lambda: _sweep.sweep_project(x, *cores, plan=pplan, scale=scale),
             lambda: _sweep.sweep_project_plain(x, *cores, steps=pplan.steps,
                                                scale=scale),
             lambda: torch.einsum(p_spec, x, *cores)),
            ("sweep_reconstruct", r_flops, y_bytes + core_bytes + x_bytes,
             lambda: _sweep.sweep_reconstruct(y, *cores, plan=rplan,
                                              scale=scale),
             lambda: _sweep.sweep_reconstruct_plain(
                 y, *cores, steps=rplan.steps, scale=scale),
             lambda: torch.einsum(r_spec, y, *cores)),
        ]
        for name, program_flops, nbytes, kern, plain, library in cases:
            ms = cuda_ms(kern, reps=20)
            plain_ms = cuda_ms(plain, reps=5, warmup=1)
            torch.cuda.empty_cache()
            library_ms = cuda_ms(library, reps=5, warmup=1)
            torch.cuda.empty_cache()
            flops = min(program_flops, dense)
            t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
            bound_ms = max(t_ops, t_bytes)
            program_bound_ms = max(program_flops / PEAK_FP32 * 1e3, t_bytes)
            key = f"{name}:{family}"
            row = {"name": key, "route": "cuda", "source": SOURCES[name],
                   "replaces": REPLACES[name],
                   "launches": per_family[key],
                   "max_abs_err": errs[key], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": library_ms,
                   "shape": f"B={b} k={k} dims={'x'.join(map(str, dims))} "
                            f"R={rank}",
                   "flops": flops, "bytes": nbytes,
                   "program_flops": program_flops,
                   "program_bound_ms": program_bound_ms}
            rows.append(row)
            route = ("sweep program" if flops == program_flops
                     else "dense operator")
            log(f"time {key} {row['shape']}: kernel {ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({row['bound_by']}, {flops:.4g} flops "
                f"by the {route} route; {100 * bound_ms / ms:.1f}% of the "
                f"kernel's time), "
                f"sweep program's own bound {program_bound_ms:.3f} ms "
                f"({program_flops:.4g} flops), plain {plain_ms:.3f} ms, "
                f"torch.einsum {library_ms:.3f} ms")

    for name in launches:
        total = sum(r["launches"] for r in rows if r["name"].startswith(name))
        if total != launches[name]:
            raise AssertionError(f"{name}: per-family launches {total} != "
                                 f"counter {launches[name]}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
