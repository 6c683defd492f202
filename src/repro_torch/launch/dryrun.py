"""Dry run: one rank's share of every (arch x shape x mesh) cell, counted
on meta tensors, and the three-term roofline JSON of each.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
cell against ShapeDtypeStruct inputs on 512 fake host devices and reads
XLA's cost and memory analyses. The port runs the eager step once as one
rank of the production mesh, (data 16, model 16) or (pod 2, data 16,
model 16): the process is rank `--rank` (default 0) of a fake process
group standing for the other 255 or 511 ranks
(`launch.mesh.make_production_mesh(backend="fake", device="meta")`), its
state, batch and cache are 'meta' tensors of the rank's share, made from
`Model.param_shapes()` without drawing or allocating, and
`launch/roofline.py::count_step` counts what the step dispatches. As in
the reference:

* costs (flops, bytes, collectives) come from two shallow probes of 1
  and 2 pattern instances (`probe_pair`), with `attn_chunk_q/k` raised
  to max(2048, min(4096, S)) and `unroll_scans` set, extrapolated to
  full depth (`roofline.analyze_extrapolated`);
* memory comes from one full-depth run; `compile_s` holds its host
  seconds (the port compiles nothing: the eager run on meta stands where
  the reference's compile does), `probe_compile_s` the probes'.

Beside the reference's keys a cell holds `full_depth` (the full-depth
run's own flops, bytes and link bytes), `ledger` (its collectives, row
by row), `rank` and `mesh_s` (the seconds the mesh's process groups took
to build: every rank enters every `new_group`).

What the count sees, named in every cell's `notes`: on meta the
projection plan's 'auto' route takes the einsum program (the program the
reference's plan takes off the TPU, which its dry run counts), K4's
wrapper its plain version; no kernel is launched. Under the fake backend
the one-time agreement of the ranks' tree digests is skipped (there is
no peer; gloo and NCCL still refuse a mismatch).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

`--sp-outputs` and `--no-head-constraints` are refused: the settings
they set have nothing to act on in the port (ROADMAP.md, "Differences
kept on purpose").
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build_model, input_specs, settings
from repro_torch.optim import AdamWConfig, adamw

ROUTE_NOTE = ("counted on meta tensors: rp 'auto' takes the einsum route, "
              "K4 its plain version; no kernel launched")
DIGEST_NOTE = ("fake process group: the ranks' tree-digest agreement "
               "skipped")

# the reference's flags whose settings the port has nothing to act on
_REFUSED = {
    "sp_outputs": "--sp-outputs sets sp_block_outputs, where XLA places "
                  "the sequence-parallel constraint on a block's output; "
                  "the port's row-parallel products always leave by one "
                  "reduce-scatter (ROADMAP.md, 'Differences kept on "
                  "purpose')",
    "no_head_constraints": "--no-head-constraints clears "
                           "constrain_attn_heads, a layout constraint for "
                           "XLA's partitioner; the port's attention always "
                           "runs on the rank's heads (ROADMAP.md, "
                           "'Differences kept on purpose')",
}


def _meta(shape, dtype=torch.int32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch(cfg, shape) -> dict:
    """The cell's global batch on meta; qwen2-vl's patch positions on the
    host, where the steps leave them (the model checks them there)."""
    batch = input_specs(cfg, shape)
    if "patch_positions" in batch:
        B, P = batch["patch_positions"].shape
        batch["patch_positions"] = torch.arange(
            P, dtype=torch.int32).expand(B, P).contiguous()
    return batch


def build_cell(cfg, shape, mesh, *, remat: str = "nothing",
               seq_parallel: bool = True, compressor=None,
               fused_update: bool = False):
    """(fn, args, notes): the cell's step as one rank of `mesh` (None:
    one rank alone) and its arguments on meta, the rank's share."""
    model = build_model(cfg)
    pol = steps._policy(cfg)
    params = model.param_shapes(pol["param_dtype"])
    notes: list = []
    if mesh is not None:
        compressed = compressor is not None and shape.kind == "train"
        sharding.param_specs(cfg, model.param_axes(), mesh, params, notes,
                             fsdp_axes=steps.fsdp_axes_for(mesh,
                                                           compressed))
    notes.append(ROUTE_NOTE)
    if mesh is not None and mesh.backend == "fake":
        notes.append(DIGEST_NOTE)
    if shape.kind == "train":
        opt = AdamWConfig(moment_dtype=pol["moment_dtype"],
                          **({"clip_norm": None} if fused_update else {}))
        state = {"params": params, "opt": adamw.init_state(params, opt)}
        if compressor is not None:
            state["ef"] = compressor.init_state(params)
        if mesh is not None and steps._check_mesh(mesh):
            state = steps.shard_state(model, state, mesh)
        fn = steps.build_train_step(model, shape, mesh=mesh, opt=opt,
                                    remat=remat, seq_parallel=seq_parallel,
                                    compressor=compressor,
                                    fused_update=fused_update,
                                    device="meta")
        return fn, (state, _batch(cfg, shape)), notes
    if mesh is not None:
        params = steps.shard_params(model, params, mesh)
    if shape.kind == "prefill":
        fn = steps.build_prefill_step(model, shape, mesh=mesh,
                                      seq_parallel=seq_parallel)
        return fn, (params, _batch(cfg, shape)), notes
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S, device="meta")
    if mesh is not None:
        cache = steps.shard_cache(model, cache, mesh)
    fn = steps.build_serve_step(model, shape, mesh=mesh)
    args = (params, cache, _meta((B,)), _meta((B,)))
    if cfg.mrope_sections is not None:
        args += (_meta((3, B, 1)),)
    return fn, args, notes


def probe_pair(cfg):
    """(cfg_n1, cfg_n2, n1, n2, n_full): small-depth cost probes.

    Costs are linear in depth "instances" (one instance = one repetition of
    the arch's layer pattern): two probes pin slope+intercept, the full cell
    extrapolates. (The reference needs them because XLA counts a lax.scan
    body once; the port's eager count sees every layer, and keeps the
    probes so that both packages count the same way.)
    """
    if cfg.family == "hybrid":
        p = 3
    elif cfg.family == "encdec":
        p = 1
    else:
        p = len(cfg.window_pattern)
    kw1 = {"n_layers": p}
    kw2 = {"n_layers": 2 * p}
    if cfg.family == "encdec":
        kw1["encoder_layers"] = 1
        kw2["encoder_layers"] = 2
    n_full = cfg.n_layers / p
    return (dataclasses.replace(cfg, **kw1), dataclasses.replace(cfg, **kw2),
            1.0, 2.0, n_full)


def measure(cfg, shape, mesh, **kw) -> tuple[rl.StepCount, list]:
    """One counted run of the cell's step: (its `StepCount`, its notes)."""
    fn, args, notes = build_cell(cfg, shape, mesh, **kw)
    _, count = rl.count_step(fn, *args, mesh=mesh)
    return count, notes


def _mesh_name(shape: tuple) -> str:
    return "x".join(str(s) for s in shape) if shape else "1"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str | None, remat: str = "nothing",
             seq_parallel: bool = True, verbose: bool = True,
             tag: str = "", compress: str | None = None,
             compress_sync: str = "local-mean",
             cfg_override=None, opts: dict | None = None,
             rank: int = 0, mesh_shape: tuple | None = None,
             shape_override=None, fused_update: bool = False) -> dict:
    """The cell's JSON (written under `out_dir` when given). Beside the
    reference's arguments: `rank` (this process's rank of the fake
    world), `mesh_shape` (another mesh than the production one: (data,
    model) or (pod, data, model); () for one rank alone),
    `shape_override` (a ShapeSpec in place of the arch's `shape_name`)
    and `fused_update` (the fused K4 step)."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or cfg.shape(shape_name)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_name = _mesh_name(mesh_shape)
    cell = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
            "kind": shape.kind}
    if shape.skip:
        cell["status"] = "skip"
        cell["reason"] = shape.skip
        return _emit(cell, out_dir, verbose, tag)

    t0 = time.perf_counter()
    if mesh_shape in ((2, 16, 16), (16, 16)):
        mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                    device="meta", backend="fake",
                                    rank=rank)
    elif mesh_shape:
        names = ("pod", "data", "model")[-len(mesh_shape):]
        mesh = make_mesh(mesh_shape, names, device="meta", backend="fake",
                         rank=rank)
    else:
        mesh = None
    mesh_s = time.perf_counter() - t0
    compressor = None
    if compress:
        from repro_torch.optim.compress import (SketchCompressor,
                                                parse_compress_flag)
        pod = mesh is not None and "pod" in mesh.axis_names
        compressor = SketchCompressor(parse_compress_flag(compress),
                                      pod_axis="pod" if pod else None,
                                      sync=compress_sync)
    kw = dict(remat=remat, seq_parallel=seq_parallel, compressor=compressor,
              fused_update=fused_update)
    with settings.override(**(opts or {})):
        # 1) full depth: the run's memory, the ledger of one step
        full, notes = measure(cfg, shape, mesh, **kw)
        # 2) two shallow probes: the per-instance costs
        c1, c2, n1, n2, n_full = probe_pair(cfg)
        probe_chunk = max(2048, min(4096, shape.seq_len))
        with settings.override(unroll_scans=True, attn_chunk_q=probe_chunk,
                               attn_chunk_k=probe_chunk):
            p1, _ = measure(c1, shape, mesh, **kw)
            p2, _ = measure(c2, shape, mesh, **kw)
    roof = rl.analyze_extrapolated(
        p1, p2, n1, n2, n_full, arch=arch, shape=shape, mesh_name=mesh_name,
        n_devices=math.prod(mesh_shape), cfg=cfg,
        memory=rl.memory_stats(full))
    cell.update(status="ok", compile_s=round(full.seconds, 1),
                probe_compile_s=[round(p1.seconds, 1), round(p2.seconds, 1)],
                notes=notes, roofline=roof.to_json(),
                full_depth={"flops": full.flops, "bytes": full.bytes,
                            "link_bytes_per_device": full.collective[
                                "link_bytes_per_device"]},
                ledger=full.ledger, rank=rank, mesh_s=mesh_s)
    return _emit(cell, out_dir, verbose, tag)


def _emit(cell: dict, out_dir: str | None, verbose: bool, tag: str) -> dict:
    if out_dir:
        p = pathlib.Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        name = f"{cell['arch']}_{cell['shape']}_{cell['mesh']}{tag}.json"
        (p / name).write_text(json.dumps(cell, indent=1))
    if verbose:
        if cell["status"] == "skip":
            print(f"SKIP {cell['arch']} {cell['shape']}: {cell['reason']}")
        else:
            r = cell["roofline"]
            print(f"OK {cell['arch']} {cell['shape']} {cell['mesh']}: "
                  f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s "
                  f"bottleneck={r['bottleneck']} "
                  f"useful={r['useful_flops_frac']:.2f} "
                  f"(compile {cell['compile_s']:.0f}s)")
    return cell


def list_cells() -> str:
    """What the reference's `--list` prints: every arch's shapes, run or
    skipped."""
    out = []
    for name, cfg in ARCHS.items():
        for s in cfg.shapes:
            flag = f"SKIP({s.skip[:30]}...)" if s.skip else "run"
            out.append(f"{name:20s} {s.name:12s} {flag}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank of the production mesh")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--compress", default=None,
                    help="e.g. tt:k=4096,rank=2 — sketched grad all-reduce")
    ap.add_argument("--compress-sync", default="local-mean",
                    choices=["local-mean", "sketch-mean"],
                    help="compress_collective sync mode on the pod axis")
    ap.add_argument("--cast-once", action="store_true",
                    help="perf: bf16 param cast before the forward")
    ap.add_argument("--flash-bf16", action="store_true",
                    help="perf: bf16 softmax weights in flash PV matmul")
    ap.add_argument("--sp-outputs", action="store_true",
                    help="refused: the port has no sp_block_outputs")
    ap.add_argument("--moe-c-shard", action="store_true",
                    help="perf: capacity-shard expert buffer when E < |model|")
    ap.add_argument("--no-head-constraints", action="store_true",
                    help="refused: the port has no constrain_attn_heads")
    ap.add_argument("--no-gqa-expand", action="store_true",
                    help="perf: keep grouped (Hkv, G) flash layout")
    ap.add_argument("--tag", default="", help="suffix for output json")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        print(list_cells())
        return 0
    for flag, reason in _REFUSED.items():
        if getattr(args, flag):
            ap.error(reason)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --list)")
    opts = {}
    if args.cast_once:
        opts["cast_params_once"] = True
    if args.flash_bf16:
        opts["flash_p_bf16"] = True
    if args.moe_c_shard:
        opts["moe_c_shard"] = True
    if args.no_gqa_expand:
        opts["gqa_expand"] = False
    cell = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                    out_dir=args.out, remat=args.remat,
                    seq_parallel=not args.no_seq_parallel, tag=args.tag,
                    compress=args.compress,
                    compress_sync=args.compress_sync, opts=opts,
                    rank=args.rank)
    return 0 if cell["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
