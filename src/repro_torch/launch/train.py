"""Training launcher.

Port of `repro/launch/train.py`: the CLI builds the UNFUSED step, like the
reference's (`compress` -> `adamw.update` under `--compress`; the fused
K4 step is `build_train_step(..., fused_update=True)`, which
`chip_smoke.py` drives). Runs on the CUDA device unless `--device cpu`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --steps 20 --batch 8 --seq 64 \
        --compress tt:k=1024,rank=8,dims=4x8x16 --device cpu

`--monitor` prints the O(k) sketch telemetry (parameter norm and drift
through a fixed TT sketch) every 10 steps. `--ckpt-dir` checkpoints every
`--ckpt-every` steps and resumes from the newest verified checkpoint;
`--sketch-ef-ckpt` (with `--compress`) writes the error-feedback tree as
a (seed, spec, sketch) record; `--crash-at N` raises once at step N (a
rerun resumes from the last checkpoint). On a pod mesh the checkpoint
holds every pod's EF row in the reference's `(npod, ...)` layout, written
by rank 0, and a rerun on another pod count respecs the rows.

Compressed cross-pod sync over ranks launched by torchrun (`--mesh
PODxDATAxMODEL`, the product the world size; `--compress-sync` picks the
mean of the dense reconstructions or of the sketches):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --mesh 2x1x1 --compress tt:k=1024,rank=8,dims=4x8x16 \
        --compress-sync sketch-mean --steps 20 --device cpu

`--dist-backend` picks the process groups' backend (default NCCL on
CUDA, gloo on the CPU; gloo also runs several ranks on one card). Rank
0 alone prints.

FSDP over a data mesh (`--mesh DATAx1`, the reference's layout: each
rank holds its blocks of params, m and v and takes its rows of the
batch; a checkpoint holds whole leaves, written by rank 0):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --mesh 2x1 --dist-backend gloo --device cpu --steps 20

Pod x data (`--mesh PODxDATAx1`, DATA > 1): with `--compress`, FSDP
over 'data' within each pod and `compress_collective` across pods (the
reference's `fsdp_axes=("data",)`); without it, FSDP over both axes:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --mesh 2x2x1 --compress tt:k=64,dims=4x8x16 \
        --compress-sync sketch-mean --dist-backend gloo --device cpu \
        --steps 6 --batch 4 --seq 16

A (data, model) mesh (`--mesh AxB`, B > 1; every family): each rank
holds its blocks of the leaves split over either axis, and the forward
runs tensor-, sequence- and expert-parallel over 'model'
(`launch/tp.py`; whisper's stream whole on every model rank, as the
reference's); the model ranks of a data index take the same rows; any
model size runs, a part whose dims it does not divide whole on every
model rank (`models.<family>.split_parts`):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --mesh 2x2 --dist-backend gloo --device cpu --steps 6 \
        --batch 4 --seq 16 [--compress tt:k=64,dims=4x8x16]

The same with `--arch mamba2-1.3b`, `recurrentgemma-2b` or
`whisper-medium` (`--nproc-per-node 2 ... --mesh 1x2` as well).

The reference's production layout, (pod, data, model) (`--mesh PxDxM`,
M > 1): the model axis as on (data, model), beside the pod axis as on
pod x data. On every mesh `--ckpt-dir` (with `--crash-at` and
`--sketch-ef-ckpt`) checkpoints whole leaves gathered onto rank 0 and,
on a pod mesh, every pod's EF row in the reference's `(npod, ...)`
layout; a restart reads each rank's blocks and its pod's row:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 8 -m repro_torch.launch.train --arch llama3.2-3b \
        --reduced --mesh 2x2x2 --compress tt:k=64,dims=4x8x16 \
        --compress-sync sketch-mean --dist-backend gloo --device cpu \
        --steps 6 --batch 4 --seq 16 --ckpt-dir d --ckpt-every 2 \
        --sketch-ef-ckpt [--crash-at 3]

An
encoder-decoder's batches carry synthetic audio frames (B, encoder_seq,
D), standard normal, drawn from the seed and the step (`FramesLM`).
"""
from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import (PytreeSketcher, SketchConfig,
                                     SketchMonitor)
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.fsdp import unshard_tree
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import schedule
from repro_torch.optim.compress import SketchCompressor, parse_compress_flag
from repro_torch.runtime import train_loop
from repro_torch.runtime.resilience import FaultInjector


class FramesLM:
    """An encoder-decoder's data: the token batches of `lm` with
    `frames` (B, encoder_seq, D) float32 beside them, standard normal,
    drawn from the seed and the step (the conv front end is a stub)."""

    def __init__(self, lm: SyntheticLM, encoder_seq: int, d_model: int):
        self.lm, self.cfg = lm, lm.cfg
        self.shape = (lm.cfg.global_batch, encoder_seq, d_model)

    def batch(self, step: int, **kw):
        out = self.lm.batch(step, **kw)
        rng = np.random.default_rng(self.cfg.seed * 1_000_003 + step)
        out["frames"] = rng.standard_normal(
            (out["tokens"].shape[0],) + self.shape[1:]).astype(np.float32)
        return out


def parse_mesh(spec: str | None, *, device=None, backend=None):
    """'AxB' -> a (data, model) mesh, 'AxBxC' -> (pod, data, model), over
    the ranks torchrun launched; None -> no mesh for one process, else
    the host mesh (data = world size)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if spec is None:
        return (make_host_mesh(device=device, backend=backend)
                if world > 1 else None)
    dims = tuple(int(x) for x in spec.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if names is None:
        raise ValueError(f"--mesh {spec!r}: expected AxB (data x model) or "
                         "AxBxC (pod x data x model)")
    need = 1
    for d in dims:
        need *= d
    if need != world:
        raise ValueError(
            f"--mesh {spec} holds {need} ranks but the world has {world}; "
            f"launch it with python -m torch.distributed.run "
            f"--nproc-per-node {need} (torchrun)")
    return make_mesh(dims, names, device=device, backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized smoke variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="AxB (data x model) or AxBxC (pod x data x "
                         "model); the product is the world size")
    ap.add_argument("--compress", default=None,
                    help="tt:k=...,rank=...[,dims=AxBxC][,order=N]")
    ap.add_argument("--compress-sync", default="local-mean",
                    choices=["local-mean", "sketch-mean"],
                    help="cross-pod sync of compress_collective: the mean "
                         "of the dense reconstructions (one adjoint pass) "
                         "or of the (buckets, k) sketches (k-sized wire "
                         "bytes)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of the mesh (default: nccl "
                         "on CUDA, gloo on the CPU)")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sketch-ef-ckpt", action="store_true",
                    help="checkpoint the error-feedback tree as a (seed, "
                         "spec, sketch) record instead of its dense bytes "
                         "(requires --compress; the operator is regenerated "
                         "from the saved seed on restore)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault injection (tests): raise at this step once")
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: cuda)")
    ap.add_argument("--monitor", action="store_true",
                    help="O(k) sketch telemetry: param norm/drift per log")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh, device=args.device,
                      backend=args.dist_backend)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    npod = mesh.shape.get("pod", 1) if mesh is not None else 1
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    shape = ShapeSpec("cli_train", args.seq, args.batch, "train")

    compressor = None
    if args.compress:
        compressor = SketchCompressor(parse_compress_flag(args.compress),
                                      sync=args.compress_sync)
        say(f"[compress] {args.compress} sync={args.compress_sync} "
            f"shrinkage={compressor.cfg.shrinkage():.4f}")
    if mesh is not None:
        say(f"[mesh] {mesh.shape} backend={mesh.backend} device={dev}")

    lr_fn = functools.partial(schedule.cosine_with_warmup, peak_lr=args.lr,
                              warmup_steps=args.warmup,
                              total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    if cfg.family == "encdec":
        data = FramesLM(data, cfg.encoder_seq, cfg.d_model)
    step_fn = steps_lib.build_train_step(model, shape, mesh=mesh,
                                         lr_fn=lr_fn, remat=args.remat,
                                         compressor=compressor, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = steps_lib.init_train_state(model, gen, compressor=compressor)
    data_mesh = mesh is not None and (mesh.shape.get("data", 1) > 1
                                      or mesh.shape.get("model", 1) > 1)
    shardings = None
    if data_mesh:   # every rank drew the same state: keep its blocks
        shardings = steps_lib.state_specs(model, mesh, state)
        state = steps_lib.shard_state(model, state, mesh)
    on_metrics = None
    if args.monitor:
        mon_cfg = SketchConfig(family="tt", k=256, rank=2,
                               bucket_elems=4 * 8 * 16, dims=(4, 8, 16),
                               fresh_per_step=False)
        monitor = SketchMonitor(PytreeSketcher(mon_cfg,
                                               model.param_shapes()),
                                seed=17)

        def on_metrics(step, metrics, live_state):
            if step % 10 == 0:
                params = live_state["params"]
                if data_mesh:   # every rank joins the gather
                    params = unshard_tree(params, shardings["params"], mesh)
                m = monitor.update(params)
                say(f"   [monitor] step {step} "
                    f"sketch_norm={float(m['sketch_norm']):.4f} "
                    f"drift={float(m['sketch_drift']):.5f}")
    ef_codec = None
    if args.sketch_ef_ckpt:
        if compressor is None or "ef" not in state:
            raise ValueError(
                "--sketch-ef-ckpt needs error-feedback state: pass "
                "--compress so the train state carries an 'ef' tree")
        from repro_torch.ckpt import SketchedTreeCodec
        from repro_torch.launch.sharding import bucket_specs
        if npod > 1:    # the record of the stacked (npod, ...) rows
            ef_codec = SketchedTreeCodec.for_pod_rows(
                compressor.cfg, state["ef"], npod)
        else:
            ef_codec = SketchedTreeCodec(
                compressor.cfg, state["ef"], mesh=mesh,
                bucket_spec=bucket_specs(mesh) if mesh is not None else None)
        say(f"[ckpt] sketched EF records: "
            f"{ef_codec.dense_bytes()} -> {ef_codec.sketch_bytes()} "
            f"bytes ({ef_codec.compression_ratio():.1f}x)")
    loop_cfg = train_loop.LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, npod=npod)
    injector = (FaultInjector({args.crash_at})
                if args.crash_at is not None else None)
    state, final = train_loop.run(step_fn, state, data, loop_cfg,
                                  injector=injector, log=say,
                                  on_metrics=on_metrics, ef_codec=ef_codec,
                                  mesh=mesh, shardings=shardings)
    n = sum(x.numel() for x in tree_leaves(model.param_shapes()))
    say(f"[train] finished at step {final} (params={n})")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
