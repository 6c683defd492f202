"""The step builders (train, prefill, serve) and the train state.

Port of `repro/launch/steps.py`. The reference jits pjit-sharded steps
and returns each in a bundle with its shardings; the port runs eagerly,
one process a rank, so each builder returns the step function itself.
`build_train_step` gives `fn(state, batch) -> (state, metrics)`, which
returns a new state (the caller drops the old one; the reference donates
it). Branches:

* no compressor: loss and gradient, then `adamw.update`;
* `compressor=`: `compressor.compress` (sketch: one K1 launch per leaf;
  unsketch: one K2 launch per leaf) -> `adamw.update`;
* `compressor=` and `fused_update=True`: `adamw.update_sketched` — one K1
  and one K4 launch per leaf, the dense gradient estimate never stored;
* a `mesh=` with a 'pod' axis: rank p takes its pod's rows of the global
  batch, and its loss and gradient are synced across pods — with a
  compressor by `compress_collective` (one K1 and two or one K2 launches
  a leaf and the sketch's or the dense leaves' mean), without one by one
  dense all_reduce of the whole gradient — then `adamw.update`. Each rank
  holds its own pod's EF residual, without a pod dim.

`build_prefill_step` gives `fn(params, batch) -> logits` (the last
token's, float32) and `build_serve_step` `fn(params, cache, token, pos,
positions3=None) -> (next_tok int32, cache)`, one greedy decode step
that writes the cache in place; both run under `torch.inference_mode` on
one device, in the policy's compute dtype (bf16; the 'lean' policy's
params are bf16 too, and no step makes an fp32 copy of them). Both run
every family: an encoder-decoder's prefill encodes `batch["frames"]`
and decodes the tokens against it, and its serve step needs a cache
whose cross K/V `whisper.build_cross_cache` has filled. Every step
passes the batch's `positions3`, `patches` and `patch_positions`
(qwen2-vl) through, the last left on the host, where the model checks
them. `data` or `model` axes above 1 (FSDP/TP) wait for the model's
`param_axes` (ROADMAP.md, queue 1 item 12.7), and with them the mesh
arguments of the prefill and serve steps and the reference's MoE
dispatch groups (`moe_groups_for`, one group a data shard): every step
dispatches the MoE FFN in one group.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import Model, from_numpy_params
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
                     mesh=None,
                     opt: AdamWConfig | None = None,
                     lr_fn: Callable | None = None,
                     remat: str = "nothing",
                     compressor=None,
                     fused_update: bool = False,
                     device=None,
                     compute_dtype=None) -> Callable:
    """`fused_update=True` swaps the compress -> adamw.update chain for
    `adamw.update_sketched` (one fused unsketch+EF+AdamW launch per leaf);
    it needs a compressor, no pod axis, and `AdamWConfig(clip_norm=None)`.
    `mesh` (a `launch.mesh.Mesh`) with a 'pod' axis builds the pod branch
    on the mesh's device. `compute_dtype=None` takes the config's policy
    (bf16 compute under 'mixed' and 'lean'); `device=None` means CUDA."""
    cfg = model.cfg
    pol = _policy(cfg)
    npod, group = 1, None
    if mesh is not None:
        wide = {a: n for a, n in mesh.shape.items()
                if a in ("data", "model") and n > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} above 1 shard params and batch within a "
                "pod (FSDP/TP), which needs the model's param_axes "
                "(ROADMAP.md, queue 1 item 12.7); run a (pod, 1, 1) mesh")
        if "pod" in mesh.axis_names:
            group = mesh.group("pod")
            npod = group.size
        device = mesh.device if device is None else device
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
        if group is not None:
            raise ValueError(
                "fused_update=True is wired for the single-pod roundtrip "
                "branch; the pod-collective branch syncs sketches across "
                "pods before the optimizer and keeps the unfused update — "
                "run without a 'pod' mesh axis or drop fused_update")
        if opt.clip_norm is not None:
            raise ValueError(
                "fused_update=True fuses AdamW into the unsketch kernel, "
                "which never materializes the dense gradient estimate to "
                "clip; construct AdamWConfig(clip_norm=None)")
    if compressor is not None and mesh is not None:
        compressor = dataclasses.replace(
            compressor, pod_axis="pod" if group is not None else None,
            mesh=mesh)
    if shape.global_batch % npod:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {npod} pods' rows")
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
            t = torch.as_tensor(v)
            if k != "patch_positions":
                t = t.to(dev)
            if k in ("tokens", "labels") and tuple(t.shape) != want:
                raise ValueError(f"batch[{k!r}] has shape {tuple(t.shape)}, "
                                 f"the step was built for {want}")
            out[k] = t
        return out

    def pod_step(state, batch):
        """The pod branch: this pod's rows, the synced gradient, AdamW."""
        from repro_torch.rp import shard
        params = state["params"]
        metrics = {}
        new_state = dict(state)
        per = shape.global_batch // npod
        # positions3 (3, B, S) holds the batch on its dim 1
        rows = {k: v.narrow(1 if k == "positions3" else 0,
                            group.index * per, per)
                for k, v in batch.items()}
        with span("train.loss_grad"):
            loss, grads = loss_and_grads(params, rows)
            loss = shard.all_reduce(loss.reshape(1), group,
                                    tag="loss")[0] / npod
        count = state["opt"]["count"]
        with span("train.compress"):
            if compressor is not None:
                grads, new_state["ef"], cmet = (
                    compressor.compress_collective(grads, state["ef"],
                                                   step=count))
                metrics.update(cmet)
            else:   # the uncompressed baseline: one dense all_reduce
                leaves, treedef = tree_flatten(grads)
                flat = shard.all_reduce(torch.cat(
                    [g.reshape(-1) for g in leaves]), group,
                    tag="grad") / npod
                grads = tree_unflatten(treedef, [
                    t.view_as(g) for t, g in zip(
                        flat.split([g.numel() for g in leaves]), leaves)])
        lr = lr_fn(count)
        with span("train.update"):
            new_p, new_opt, omet = adamw.update(params, grads,
                                                state["opt"], lr, opt)
        metrics.update(omet)
        metrics["loss"] = loss
        metrics["lr"] = lr
        new_state["params"] = new_p
        new_state["opt"] = new_opt
        return new_state, metrics

    def train_step(state, batch):
        batch = on_device(batch)
        if group is not None:
            return pod_step(state, batch)
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


def build_prefill_step(model: Model, shape: ShapeSpec) -> Callable:
    """`fn(params, batch) -> (B, V) float32` logits of the prompt's last
    token (`batch["tokens"]` of the shape's (global_batch, seq_len), and
    qwen2-vl's `positions3`, `patches` and `patch_positions`; an
    encoder-decoder's `frames` (B, encoder_seq, D)), as the reference's
    prefill step: no final softcap."""
    cfg = model.cfg
    compute_dtype = _policy(cfg)["compute_dtype"]
    want = (shape.global_batch, shape.seq_len)

    @torch.inference_mode()
    def prefill_step(params, batch):
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        if tuple(tokens.shape) != want:
            raise ValueError(f"batch['tokens'] has shape "
                             f"{tuple(tokens.shape)}, the step was built "
                             f"for {want}")
        if cfg.family == "encdec":
            enc = model.mod.encode(cfg, params,
                                   torch.as_tensor(batch["frames"]).to(dev),
                                   compute_dtype=compute_dtype)
            h = model.mod.decode_hidden(cfg, params, tokens, enc,
                                        compute_dtype=compute_dtype)
        else:
            extra = {k: torch.as_tensor(batch[k]).to(dev) for k in (
                "positions3", "patches") if k in batch}
            if "patch_positions" in batch:
                extra["patch_positions"] = torch.as_tensor(
                    batch["patch_positions"])
            h = model.mod.forward_hidden(cfg, params, tokens,
                                         compute_dtype=compute_dtype, **extra)
        unembed = (params["embed"].T if cfg.tie_embeddings
                   else params["unembed"])
        return h[:, -1, :].to(torch.float32) @ unembed.to(torch.float32)

    return prefill_step


def build_serve_step(model: Model, shape: ShapeSpec) -> Callable:
    """`fn(params, cache, token, pos, positions3=None) -> (next_tok (B,)
    int32, cache)`: one decode step of the shape's global_batch sequences
    against a cache of its seq_len (`model.init_cache`), written in
    place, and the greedy next token; an M-RoPE config passes
    `positions3` (3, B, 1). An encoder-decoder's cache must hold its
    cross K/V already (`whisper.build_cross_cache`)."""
    compute_dtype = _policy(model.cfg)["compute_dtype"]

    def serve_step(params, cache, token, pos, positions3=None):
        if token.shape != (shape.global_batch,):
            raise ValueError(f"token has shape {tuple(token.shape)}, the "
                             f"step was built for ({shape.global_batch},)")
        kw = {} if positions3 is None else {"positions3": positions3}
        logits, cache = model.decode_step(params, cache, token, pos,
                                          compute_dtype=compute_dtype, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


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


__all__ = ["build_prefill_step", "build_serve_step", "build_train_step",
           "from_numpy_state", "init_train_state"]
