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
rerun resumes from the last checkpoint). The
reference's `--mesh` and `--compress-sync` wait for the collective
(ROADMAP.md, queue 1 item 11).
"""
from __future__ import annotations

import argparse
import functools

import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import (PytreeSketcher, SketchConfig,
                                     SketchMonitor)
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import schedule
from repro_torch.optim.compress import SketchCompressor, parse_compress_flag
from repro_torch.runtime import train_loop
from repro_torch.runtime.resilience import FaultInjector


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
    ap.add_argument("--compress", default=None,
                    help="tt:k=...,rank=...[,dims=AxBxC][,order=N]")
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

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    shape = ShapeSpec("cli_train", args.seq, args.batch, "train")

    compressor = None
    if args.compress:
        compressor = SketchCompressor(parse_compress_flag(args.compress))
        print(f"[compress] {args.compress} "
              f"shrinkage={compressor.cfg.shrinkage():.4f}")

    lr_fn = functools.partial(schedule.cosine_with_warmup, peak_lr=args.lr,
                              warmup_steps=args.warmup,
                              total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    step_fn = steps_lib.build_train_step(model, shape, lr_fn=lr_fn,
                                         remat=args.remat,
                                         compressor=compressor, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = steps_lib.init_train_state(model, gen, compressor=compressor)
    on_metrics = None
    if args.monitor:
        mon_cfg = SketchConfig(family="tt", k=256, rank=2,
                               bucket_elems=4 * 8 * 16, dims=(4, 8, 16),
                               fresh_per_step=False)
        monitor = SketchMonitor(PytreeSketcher(mon_cfg, state["params"]),
                                seed=17)

        def on_metrics(step, metrics, live_state):
            if step % 10 == 0:
                m = monitor.update(live_state["params"])
                print(f"   [monitor] step {step} "
                      f"sketch_norm={float(m['sketch_norm']):.4f} "
                      f"drift={float(m['sketch_drift']):.5f}")
    ef_codec = None
    if args.sketch_ef_ckpt:
        if compressor is None or "ef" not in state:
            raise ValueError(
                "--sketch-ef-ckpt needs error-feedback state: pass "
                "--compress so the train state carries an 'ef' tree")
        from repro_torch.ckpt import SketchedTreeCodec
        ef_codec = SketchedTreeCodec(compressor.cfg, state["ef"])
        print(f"[ckpt] sketched EF records: "
              f"{ef_codec.dense_bytes()} -> {ef_codec.sketch_bytes()} "
              f"bytes ({ef_codec.compression_ratio():.1f}x)")
    loop_cfg = train_loop.LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    injector = (FaultInjector({args.crash_at})
                if args.crash_at is not None else None)
    state, final = train_loop.run(step_fn, state, data, loop_cfg,
                                  injector=injector, on_metrics=on_metrics,
                                  ef_codec=ef_codec)
    n = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"[train] finished at step {final} (params={n})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
