"""How far the data-mesh (FSDP) step drifts from one rank's step.

`chip_smoke.py` phase 20a holds two gloo ranks' FSDP steps against one
rank's step at the policy's bf16 compute. This probe runs the same
comparison at `--compute` (default float32), of 20a's uncompressed step,
or with `--fused` of 20d's fused step (`fused_update=True` through phase
9's compressor, clip None, each rank's K4 block form against the one-rank
whole-leaf K4): phase 20's slice
(llama3.2-3b at its published widths cut to 2 layers, phase 20's sequence, global
batch 2: one row a rank; AdamW's clip of 1.0, constant `--lr`, default
phase 20's 3e-4), the parameters drawn once from seed 0. This process runs
`--steps` one-rank steps and writes the params after each, frees the
card, then two ranks sharing it run the `(data=2, model=1)` step from the
same parameters. Per step: both losses and their relative gap, the clip
norms, and the largest gap of the params in units of lr, with the share
of entries more than 0.01 lr apart. Prints one JSON line.

    python3 tools/fsdp_drift_probe.py [--compute float32] [--lr 3e-4] \
        [--fused]

Run from the root of the repository on a card (about 80 GB free, 20 GB
of disk under the temporary directory).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _setting(args):
    """Phase 20's slice at the probe's lr and compute dtype: (model,
    shape, opt, lr_fn, data, compute dtype, step keywords)."""
    import dataclasses
    import functools

    import chip_smoke
    from repro_torch.optim import schedule
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    model, _, shape, opt, _, data = chip_smoke._fsdp_slice()
    lr_fn = functools.partial(schedule.constant, peak_lr=args["lr"])
    kw = {}
    if args["fused"]:
        opt = dataclasses.replace(opt, clip_norm=None)
        kw = dict(fused_update=True, compressor=SketchCompressor(
            parse_compress_flag(chip_smoke.TRAIN_COMPRESS)))
    return (model, shape, opt, lr_fn, data, getattr(torch, args["compute"]),
            kw)


def _zero_ef(model, dev):
    from repro_torch.core.tree import tree_map
    return {"residual": tree_map(lambda t: torch.zeros(t.shape, device=dev),
                                 model.param_shapes())}


def _rank(rank, tmp, args):
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=2, rank=rank)
    try:
        from repro_torch.core.tree import tree_leaves, tree_map
        from repro_torch.launch import fsdp, steps
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim import adamw
        dev = torch.device("cuda")
        mesh = make_mesh((2, 1), ("data", "model"), device=dev,
                         backend="gloo")
        model, shape, opt, lr_fn, data, compute, kw = _setting(args)
        ref = torch.load(Path(tmp) / "ref.pt", mmap=True, weights_only=True)
        pspecs = steps.state_specs(model, mesh)["params"]
        params = tree_map(lambda t: t.to(dev), fsdp.shard_tree(
            ref["params"][0], pspecs, mesh))
        state = {"params": params, "opt": adamw.init_state(params, opt)}
        if kw:
            state["ef"] = _zero_ef(model, dev)
        step_fn = steps.build_train_step(model, shape, mesh=mesh, opt=opt,
                                         lr_fn=lr_fn, compute_dtype=compute,
                                         **kw)
        out = []
        for i in range(args["steps"]):
            state, met = step_fn(state, data.batch(i))
            gap, far = 0.0, 0
            n = 0
            for b, w in zip(tree_leaves(state["params"]), tree_leaves(
                    fsdp.Sharded(mesh, pspecs).blocks(ref["params"][i + 1]))):
                d = (b - w.to(dev)).abs() / args["lr"]
                gap = max(gap, float(d.max()))
                far += int((d > 1e-2).sum())
                n += d.numel()
            out.append({"loss": float(met["loss"]),
                        "grad_norm": float(met.get("grad_norm", 0.0)),
                        "param_gap_lr": gap, "share_over_0.01lr": far / n})
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(
            {"steps": out, "peak_gib": torch.cuda.max_memory_allocated()
             / 2**30}))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compute", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused", action="store_true",
                    help="20d's fused step (clip None) instead of 20a's")
    args = vars(ap.parse_args())
    if not torch.cuda.is_available():
        print("fsdp_drift_probe: needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import steps
    dev = torch.device("cuda")
    model, shape, opt, lr_fn, data, compute, kw = _setting(args)
    tmp = tempfile.mkdtemp(prefix="fsdp_drift_")
    try:
        state = steps.init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), opt=opt)
        if kw:
            state["ef"] = _zero_ef(model, dev)
        host = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
        params = [host(state["params"])]
        step_fn = steps.build_train_step(model, shape, opt=opt, lr_fn=lr_fn,
                                         device=dev, compute_dtype=compute,
                                         **kw)
        one = []
        for i in range(args["steps"]):
            state, met = step_fn(state, data.batch(i))
            one.append({"loss": float(met["loss"]),
                        "grad_norm": float(met.get("grad_norm", 0.0))})
            params.append(host(state["params"]))
        torch.save({"params": params}, Path(tmp) / "ref.pt")
        del state, params, step_fn
        torch.cuda.empty_cache()
        ctx = mp.start_processes(_rank, args=(tmp, args), nprocs=2,
                                 join=True, start_method="spawn")
        del ctx
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = []
    for i, o in enumerate(one):
        got = ranks[0]["steps"][i]
        rows.append({"step": i + 1, "one_rank_loss": o["loss"],
                     "mesh_loss": got["loss"],
                     "loss_rel_gap": abs(got["loss"] - o["loss"])
                     / abs(o["loss"]),
                     "one_rank_norm": o["grad_norm"],
                     "mesh_norm": got["grad_norm"],
                     "param_gap_lr": [r["steps"][i]["param_gap_lr"]
                                      for r in ranks],
                     "share_over_0.01lr": [r["steps"][i]["share_over_0.01lr"]
                                           for r in ranks]})
    print(json.dumps({"fsdp_drift": {
        "compute": args["compute"], "lr": args["lr"],
        "fused": args["fused"], "steps": rows,
        "peak_gib": [r["peak_gib"] for r in ranks],
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
