"""The train-step builder and the train state, on one device.

Port of the single-device part of `repro/launch/steps.py`. The reference
jits a pjit-sharded step and returns it in a bundle with its shardings;
the port runs eagerly on one device, so `build_train_step` returns the
step function itself, `fn(state, batch) -> (state, metrics)`, which
returns a new state (the caller drops the old one; the reference donates
it). Branches:

* no compressor: loss and gradient, then `adamw.update`;
* `compressor=`: `compressor.compress` (sketch: one K1 launch per leaf;
  unsketch: one K2 launch per leaf) -> `adamw.update`;
* `compressor=` and `fused_update=True`: `adamw.update_sketched` — one K1
  and one K4 launch per leaf, the dense gradient estimate never stored.

The mesh, the pod-collective branch and the prefill/serve steps wait for
their slices (ROADMAP.md, queue 1 items 11 and 12).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import Model
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.runtime.spans import span


def _policy(cfg: ArchConfig) -> dict:
    if cfg.policy == "lean":
        return dict(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16)
    return dict(param_dtype=torch.float32, moment_dtype=torch.float32,
                compute_dtype=torch.bfloat16)


def build_train_step(model: Model, shape: ShapeSpec, *,
                     opt: AdamWConfig | None = None,
                     lr_fn: Callable | None = None,
                     remat: str = "nothing",
                     compressor=None,
                     fused_update: bool = False,
                     device=None,
                     compute_dtype=None) -> Callable:
    """`fused_update=True` swaps the compress -> adamw.update chain for
    `adamw.update_sketched` (one fused unsketch+EF+AdamW launch per leaf);
    it needs a compressor and `AdamWConfig(clip_norm=None)`.
    `compute_dtype=None` takes the config's policy (bf16 compute under
    'mixed' and 'lean'); `device=None` means CUDA."""
    cfg = model.cfg
    pol = _policy(cfg)
    dev = resolve_device(device)
    compute_dtype = compute_dtype or pol["compute_dtype"]
    opt = opt or AdamWConfig(moment_dtype=pol["moment_dtype"])
    lr_fn = lr_fn or functools.partial(
        schedule.cosine_with_warmup, peak_lr=3e-4, warmup_steps=2000,
        total_steps=100_000)
    if fused_update:
        if compressor is None:
            raise ValueError(
                "fused_update=True needs a compressor: the fused kernel IS "
                "the unsketch — without sketch compression there is "
                "nothing to fuse; pass compressor= or drop fused_update")
        if opt.clip_norm is not None:
            raise ValueError(
                "fused_update=True fuses AdamW into the unsketch kernel, "
                "which never materializes the dense gradient estimate to "
                "clip; construct AdamWConfig(clip_norm=None)")
    want = (shape.global_batch, shape.seq_len)

    def loss_and_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = model.loss_fn(tree_unflatten(treedef, live), batch,
                                 compute_dtype=compute_dtype, remat=remat)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    def on_device(batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(dev)
            if k in ("tokens", "labels") and tuple(t.shape) != want:
                raise ValueError(f"batch[{k!r}] has shape {tuple(t.shape)}, "
                                 f"the step was built for {want}")
            out[k] = t
        return out

    def train_step(state, batch):
        batch = on_device(batch)
        params = state["params"]
        metrics = {}
        new_state = dict(state)
        with span("train.loss_grad"):
            loss, grads = loss_and_grads(params, batch)
        lr = lr_fn(state["opt"]["count"])
        if fused_update:
            new_p, new_opt, new_state["ef"], cmet = adamw.update_sketched(
                params, grads, state["ef"], state["opt"], lr, opt,
                compressor=compressor)
            metrics.update(cmet)
        else:
            if compressor is not None:
                grads, new_state["ef"], cmet = compressor.compress(
                    grads, state["ef"], step=state["opt"]["count"])
                metrics.update(cmet)
            new_p, new_opt, omet = adamw.update(params, grads, state["opt"],
                                                lr, opt)
            metrics.update(omet)
        metrics["loss"] = loss
        metrics["lr"] = lr
        new_state["params"] = new_p
        new_state["opt"] = new_opt
        return new_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator, *,
                     opt: AdamWConfig | None = None,
                     compressor=None) -> dict:
    """{params, opt: {m, v, count}[, ef: {residual}]} on the generator's
    device, parameters drawn from it."""
    pol = _policy(model.cfg)
    opt = opt or AdamWConfig(moment_dtype=pol["moment_dtype"])
    params = model.init(generator, dtype=pol["param_dtype"])
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    if compressor is not None:
        state["ef"] = compressor.init_state(params)
    return state


def from_numpy_state(model: Model, state: dict, *, device=None) -> dict:
    """The port's train state from the reference's `{params, opt: {m, v,
    count}[, ef: {residual}]}` (numpy arrays under the same names), in the
    policy's dtypes (the residual in float32). `device=None` means CUDA."""
    from repro_torch.models.transformer import from_numpy_params
    dev = resolve_device(device)
    pol = _policy(model.cfg)
    params = from_numpy_params(model.cfg, state["params"], device=dev,
                               dtype=pol["param_dtype"])

    def like(tree, dtype):
        return tree_map(lambda p, a: torch.tensor(
            np.asarray(a, np.float32), dtype=dtype, device=dev).reshape(
                p.shape), params, tree)

    out = {"params": params,
           "opt": {"m": like(state["opt"]["m"], pol["moment_dtype"]),
                   "v": like(state["opt"]["v"], pol["moment_dtype"]),
                   "count": torch.tensor(int(np.asarray(
                       state["opt"]["count"])), dtype=torch.int64)}}
    if "ef" in state:
        out["ef"] = {"residual": like(state["ef"]["residual"],
                                      torch.float32)}
    return out


__all__ = ["build_train_step", "from_numpy_state", "init_train_state"]
