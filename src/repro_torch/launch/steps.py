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
  holds its own pod's EF residual, without a pod dim;
* a `mesh=` whose 'data' axis is above 1 (model 1): the reference's
  FSDP. Each rank takes its rows of the global batch by
  `sharding.batch_spec` (all of them when the data size does not divide
  it) and holds params, m and v as its blocks of `sharding.param_specs`
  (`shard_state`); the forward reads a layer's leaves through
  `launch.fsdp.Sharded`, whose backward reduce-scatters each gradient to
  the block; the replicated leaves' gradients are averaged, the loss is
  the ranks' mean and the clip norm the whole gradient's. With a
  compressor (the reference's single-pod branch) the backward
  all-reduces instead, `compress` sketches the whole mean gradient with
  each rank's block of a leaf's buckets through K1 and K2
  (`bucket_spec = sharding.bucket_specs(mesh)`), and AdamW updates the
  rank's block of the estimate; the EF residual is whole on every rank
  (the reference's `P()`). With `fused_update=True` the sketch is the
  same split K1, and each leaf then runs K4's block form
  (`adamw.update_sketched(blocks=)`): every rank reconstructs the whole
  leaf from the gathered sketch, writes the whole residual (the same bits
  on every rank) and updates only its blocks of params, m and v, so no
  dense bytes cross ranks and nothing is unsketched apart. The MoE FFN
  dispatches a rank's rows in `moe_groups_for(...)` over the number of
  row blocks groups;
* a `mesh=` whose 'model' axis is above 1 (a (data, model) mesh, every
  family): the same branch, each rank holding its blocks of the
  leaves `sharding.param_specs` splits over 'model' too (two-dim blocks
  where a leaf is split over both axes), the forward tensor-, sequence-
  and expert-parallel over 'model' (`launch/tp.py`; `seq_parallel=True`,
  the reference's default, splits the residual stream's sequence). The
  model ranks of a data index take the same rows. The loss is taken as
  sums and counts over every rank's rows (`loss_mask` included), each
  rank's term summed over 'model' and averaged over the data axes. The
  compressed and fused branches sketch each leaf's whole mean gradient:
  the backward all-reduces it over the data axes and all-gathers a
  model-split leaf over 'model' (`grad_model_gather`); the sketch stays
  split over the data ranks' buckets only, so the model ranks of a data
  index run the same K1 on the same buckets, and the EF residual is
  whole on every rank. The fused branch's K4 writes each rank's two-dim
  blocks (`fused_update_block`'s second range);
* a `mesh=` with a 'pod' axis and a 'data' or 'model' axis above 1
  (pod x data, and the reference's production (pod, data, model)):
  without a compressor, the pod axis is one more data axis: the FSDP
  above over both (`data_axes`), split over 'model' too where the mesh
  has one. With a compressor (the reference's `fsdp_axes=("data",)`):
  params, m and v are FSDP blocks over 'data', the same on every pod,
  and split over 'model'; each rank takes its (pod, data) rows; the
  backward all-reduces each gradient over the data ranks of its pod
  (`fsdp.Sharded(axes=("data",))`) and all-gathers a model-split leaf's
  over 'model' (`grad_model_gather`), so every rank holds its pod's mean
  gradient whole; `compress_collective` over the ranks that share its
  (data, model) coordinate (`mesh.group("pod")`) syncs it across pods,
  the clip norm is the synced gradient's, and AdamW updates the rank's
  blocks. Each rank holds its own pod's EF residual whole, without a pod
  dim (the reference keeps a block of it, `P(pod, *spec)`: ROADMAP.md,
  "Differences kept on purpose"). The loss is every rank's mean; the MoE
  FFN dispatches in the reference's `groups // npod` groups a pod.

`build_prefill_step` gives `fn(params, batch) -> logits` (the last
token's, float32) and `build_serve_step` `fn(params, cache, token, pos,
positions3=None) -> (next_tok int32, cache)`, one greedy decode step
that writes the cache in place; both run under `torch.inference_mode`,
in the policy's compute dtype (bf16; the 'lean' policy's params are bf16
too, and no step makes an fp32 copy of them). Both run every family: an
encoder-decoder's prefill encodes `batch["frames"]` and decodes the
tokens against it, and its serve step needs a cache whose cross K/V
`whisper.build_cross_cache` has filled. Every step passes the batch's
`positions3`, `patches` and `patch_positions` (qwen2-vl) through, the
last left on the host, where the model checks them. With a `mesh=` (a
(data, model) or (pod, data, model) mesh; 'pod' is one more data axis
for the rows and the blocks) the params are the rank's
blocks (`shard_params`), the batch's rows over the data axes are the
rank's, the prefill runs sequence-parallel with `gqa_expand` (as the
reference's), and the serve step's cache is the rank's block by
`sharding.cache_specs` (`shard_cache`); both return every rank's rows
(the logits and tokens alike on the model ranks). The serve step runs
eagerly: a CUDA graph cannot capture a gloo collective. Every family
runs on a (data, model) mesh: the SSM and hybrid families
sequence-parallel as the decoder, whisper's stream whole on every model
rank (`SEQ_PARALLEL`, as the reference's); their caches by
`cache_specs` (mamba2's `ssm` by heads and `conv` by channels, the
RG-LRU's `h` and `conv` by channels and its ring by positions,
whisper's self and cross K/V by heads; `cache_layout`).

Any model size the reference's `spec_for` lays out runs. A part of a
block whose leaves the specs replicate (a dim the model size does not
divide) runs whole on every model rank (`models.<family>.split_parts`,
`launch/tp.py`); a model size that splits a decoder's or the hybrid's
query heads keeps the reference's column blocks of `wq`
(`launch.tp.ModelAxis.head_split`). The gradient's bookkeeping
(`grad_view`) takes the family's partial leaves for the parts that run
split, and runs sequence-parallel only where the model size divides the
sequence, as the forward does. What stays refused: `fused_update` with
a pod axis, as in the reference.
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
from repro_torch.models import settings as model_settings
from repro_torch.models.config import ArchConfig, ShapeSpec
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.runtime.spans import span

from repro_torch.rp import shard

from . import fsdp, sharding
from .mesh import data_axes, model_size


def _policy(cfg: ArchConfig) -> dict:
    if cfg.policy == "lean":
        return dict(param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16)
    return dict(param_dtype=torch.float32, moment_dtype=torch.float32,
                compute_dtype=torch.bfloat16)


def moe_groups_for(cfg: ArchConfig, mesh, global_batch: int) -> int:
    """The MoE dispatch groups of the global batch: the number of data
    shards, halved until it divides the batch (1 without MoE)."""
    if cfg.moe is None:
        return 1
    g = 1
    for a in data_axes(mesh):
        g *= mesh.shape[a]
    while g > 1 and global_batch % g:
        g //= 2
    return max(1, g)


def _replicated(specs):
    if isinstance(specs, dict):
        return {k: _replicated(v) for k, v in specs.items()}
    return (None,) * len(specs)


def fsdp_axes_for(mesh, compressed: bool):
    """The mesh axes the params are sharded over (`param_specs`'
    `fsdp_axes`): ('data',) on a pod mesh whose pods the compressor syncs
    (the params replicate across pods), else None (every data axis), as
    the reference's `build_train_step` sets them."""
    return ("data",) if compressed and "pod" in mesh.axis_names else None


def state_specs(model: Model, mesh, state: dict | None = None, *,
                compressed: bool | None = None) -> dict:
    """The train state's layout on a data mesh: params, m and v by
    `sharding.param_specs` (over `fsdp_axes_for(mesh, compressed)`;
    `compressed=None` reads it off `state`: an EF residual means a
    compressor), the step count and the EF residual (when `state` has
    one) whole on every rank."""
    if compressed is None:
        compressed = state is not None and "ef" in state
    pspecs = sharding.param_specs(model.cfg, model.param_axes(), mesh,
                                  model.param_shapes(),
                                  fsdp_axes=fsdp_axes_for(mesh, compressed))
    out = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                     "count": ()}}
    if state is not None and "ef" in state:
        out["ef"] = {"residual": _replicated(pspecs)}
    return out


def shard_state(model: Model, state: dict, mesh) -> dict:
    """This rank's train state on a data mesh from the whole one (every
    rank passes the same): its blocks of params, m and v, the rest as it
    is (`fsdp.shard_tree`)."""
    return fsdp.shard_tree(state, state_specs(model, mesh, state), mesh)


def unshard_state(model: Model, state: dict, mesh) -> dict:
    """The whole train state on every rank from the ranks' blocks: the
    inverse of `shard_state` (one all_gather a sharded leaf)."""
    return fsdp.unshard_tree(state, state_specs(model, mesh, state), mesh)


def _check_mesh(mesh) -> bool:
    """Whether `mesh` takes the mesh branch: its data or model axis is
    above 1 (a pod axis beside them included). Every model size runs: a
    part whose leaves the specs replicate runs whole on every model rank
    (`models.<family>.split_parts`)."""
    sizes = dict(mesh.shape)
    return sizes.get("model", 1) > 1 or sizes.get("data", 1) > 1


def _seq_parallel(model: Model, seq_parallel: bool) -> bool:
    """Whether the model axis runs sequence-parallel: asked, and the
    family splits its stream (whisper's does not, as the reference's)."""
    return seq_parallel and getattr(model.mod, "SEQ_PARALLEL", True)


def grad_view(model: Model, mesh, pspecs, seq_len: int, *,
              seq_parallel: bool = True, reduce: str = "scatter",
              axes: tuple[str, ...] | None = None) -> fsdp.Sharded:
    """The gradient's bookkeeping (`fsdp.Sharded`) of one step of `model`
    on sequences of `seq_len` over `mesh` (`pspecs`: its params' specs):
    sequence-parallel as the forward runs it (asked, the family splits
    its stream and the model size divides `seq_len`, `ModelAxis.sp`), and
    the leaves the family reads inside its split parts partial over
    'model' (`model_partial`)."""
    ms = model_size(mesh)
    sp = ms > 1 and _seq_parallel(model, seq_parallel) and seq_len % ms == 0
    partial = model.mod.model_partial(model.cfg, mesh) if ms > 1 else ()
    return fsdp.Sharded(mesh, pspecs, reduce=reduce, axes=axes,
                        seq_parallel=sp, partial=partial)


def build_train_step(model: Model, shape: ShapeSpec, *,
                     mesh=None,
                     opt: AdamWConfig | None = None,
                     lr_fn: Callable | None = None,
                     remat: str = "nothing",
                     seq_parallel: bool = True,
                     compressor=None,
                     fused_update: bool = False,
                     device=None,
                     compute_dtype=None) -> Callable:
    """`fused_update=True` swaps the compress -> adamw.update chain for
    `adamw.update_sketched` (one fused unsketch+EF+AdamW launch per leaf;
    K4's block form on a data mesh); it needs a compressor, no pod axis,
    and `AdamWConfig(clip_norm=None)`. `mesh` (a `launch.mesh.Mesh`) whose
    'data' or 'model' axis is above 1 builds the mesh branch (its state
    comes from `shard_state`; with a 'pod' axis too, pod x data), one with
    a 'pod' axis and data 1 the pod branch, on the mesh's device.
    `seq_parallel` splits the residual stream's sequence over 'model'.
    `compute_dtype=None` takes the config's policy (bf16 compute under
    'mixed' and 'lean'); `device=None` means CUDA."""
    # the first remat (torch.utils.checkpoint) imports torch._dynamo, and
    # that import leaves frames in reference cycles: imported here, the
    # step's own frames (and the trees they hold) stay out of them
    import torch._dynamo  # noqa: F401
    cfg = model.cfg
    pol = _policy(cfg)
    npod, group, data_mesh = 1, None, False
    if mesh is not None:
        data_mesh = _check_mesh(mesh)
    has_pod = mesh is not None and "pod" in mesh.axis_names
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
        if has_pod:
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
    if mesh is not None:
        if has_pod:
            group = mesh.group("pod")
            npod = group.size
        device = mesh.device if device is None else device
    dev = resolve_device(device)
    if compressor is not None and mesh is not None:
        compressor = dataclasses.replace(
            compressor, pod_axis="pod" if group is not None else None,
            mesh=mesh, bucket_spec=sharding.bucket_specs(mesh)
            if data_mesh and group is None else None)
    if shape.global_batch % npod:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {npod} pods' rows")
    want = (shape.global_batch, shape.seq_len)

    def loss_and_grads(params, batch, **kw):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        st = model_settings.get()
        # the reference's cast_params_once: the fp32 matrices in the
        # compute dtype before the forward, so its gathers move that
        read = ([p.to(compute_dtype) if p.dtype == torch.float32
                 and p.ndim >= 2 else p for p in live]
                if st.cast_params_once else live)
        with torch.enable_grad(), model_settings.override(mesh=mesh):
            loss = model.loss_fn(tree_unflatten(treedef, read), batch,
                                 compute_dtype=compute_dtype, remat=remat,
                                 **kw)
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

    if data_mesh:
        data_step = _data_step(model, shape, mesh, opt, lr_fn, compressor,
                               loss_and_grads, fused_update, seq_parallel)

    def train_step(state, batch):
        batch = on_device(batch)
        if data_mesh:
            return data_step(state, batch)
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


def _data_step(model: Model, shape: ShapeSpec, mesh, opt: AdamWConfig,
               lr_fn, compressor, loss_and_grads, fused_update: bool,
               seq_parallel: bool) -> Callable:
    """The mesh branch of `build_train_step` (see its module docstring),
    pod x data and (data, model) included: `fn(state, batch)` on this
    rank's blocks."""
    cfg = model.cfg
    pods = compressor is not None and "pod" in mesh.axis_names
    pspecs = sharding.param_specs(
        cfg, model.param_axes(), mesh, model.param_shapes(),
        fsdp_axes=fsdp_axes_for(mesh, compressor is not None))
    # the gradient's mean: over every data rank, or over the data ranks
    # of this rank's pod when the compressor syncs the pods
    grad_axes = ("data",) if pods else None
    dgroup = mesh.group(data_axes(mesh))
    n = dgroup.size
    ms = model_size(mesh)
    # the loss's ranks: the data axes, and 'model' beside them
    lgroup = mesh.group(data_axes(mesh) + ("model",)) if ms > 1 else dgroup
    # the count that divides the loss: the gradient's data ranks' rows
    cgroup = mesh.group(grad_axes) if grad_axes else dgroup
    if ms > 1:
        kw_tp = {"seq_parallel": seq_parallel}
    else:
        kw_tp = {}
    entry = sharding.batch_spec((shape.global_batch,), mesh)[0]
    rows_group = fsdp.mesh_group(mesh, entry) if entry else None
    n_blocks = rows_group.size if rows_group else 1
    per = shape.global_batch // n_blocks
    # the global batch's groups of contiguous tokens over this rank's rows
    kw = ({"moe_groups": max(1, moe_groups_for(cfg, mesh, shape.global_batch)
                             // n_blocks)} if cfg.moe is not None else {})
    view = grad_view(model, mesh, pspecs, shape.seq_len,
                     seq_parallel=seq_parallel, axes=grad_axes)
    want = [tuple(t.shape) for t in tree_flatten(
        view.blocks(model.param_shapes()))[0]]
    ranges = view.ranges(model.param_shapes()) if fused_update else None

    def rows(batch):
        if rows_group is None:
            return batch
        return {k: v.narrow(sharding.batch_dim(k), rows_group.index * per,
                            per) for k, v in batch.items()}

    def data_step(state, batch):
        params = state["params"]
        got = [tuple(t.shape) for t in tree_flatten(params)[0]]
        if got != want:
            raise ValueError(
                "the data-mesh step takes this rank's blocks of the params "
                "(launch.steps.shard_state); a leaf has the shape of the "
                "whole")
        metrics = {}
        new_state = dict(state)
        layout = grad_view(model, mesh, pspecs, shape.seq_len,
                           seq_parallel=seq_parallel, axes=grad_axes,
                           reduce="all" if compressor is not None
                           else "scatter")
        mine = rows(batch)
        extra = dict(kw, **kw_tp)
        if "loss_mask" in mine:     # sums and counts over every rank's rows
            count = shard.all_reduce(mine["loss_mask"].to(
                torch.float32).sum().reshape(1), cgroup, tag="loss_count")[0]
            extra["denom"] = torch.clamp(count, min=1.0) / cgroup.size
        with span("train.loss_grad"):
            loss, grads = loss_and_grads(params, mine, gather=layout,
                                         **extra)
            grads = layout.finish(grads)
            loss = shard.all_reduce(loss.reshape(1), lgroup,
                                    tag="loss")[0] / n
        count = state["opt"]["count"]
        lr = lr_fn(count)
        if fused_update:    # the whole gradient -> K1 split, K4 blocks
            new_p, new_opt, new_state["ef"], cmet = adamw.update_sketched(
                params, grads, state["ef"], state["opt"], lr, opt,
                compressor=compressor, blocks=ranges)
            metrics.update(cmet)
            metrics["loss"] = loss
            metrics["lr"] = lr
            new_state["params"] = new_p
            new_state["opt"] = new_opt
            return new_state, metrics
        norm = None
        if compressor is not None:
            with span("train.compress"):
                sync = (compressor.compress_collective if pods
                        else compressor.compress)
                g_hat, new_state["ef"], cmet = sync(grads, state["ef"],
                                                    step=count)
            metrics.update(cmet)
            if opt.clip_norm is not None:   # g_hat is whole on every rank
                norm = adamw.global_norm(g_hat)
            # copies of this rank's blocks, so that the whole estimate goes
            grads = fsdp.shard_tree(g_hat, pspecs, mesh)
            del g_hat
        elif opt.clip_norm is not None:
            norm = layout.global_norm(grads)
        with span("train.update"):
            new_p, new_opt, omet = adamw.update(params, grads, state["opt"],
                                                lr, opt, norm=norm)
        metrics.update(omet)
        metrics["loss"] = loss
        metrics["lr"] = lr
        new_state["params"] = new_p
        new_state["opt"] = new_opt
        return new_state, metrics

    return data_step


def _serve_mesh(model: Model, mesh):
    """(the params' gather, the data rows' group) of the prefill and serve
    steps on `mesh`, or Nones without one."""
    if mesh is None:
        return None, None
    pspecs = sharding.param_specs(model.cfg, model.param_axes(), mesh,
                                  model.param_shapes())
    return fsdp.Sharded(mesh, pspecs), mesh.group(data_axes(mesh))


def _rows_of(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The data group's rank's rows of `x` along `dim` (all of them when
    the group's size does not divide them, as `sharding.batch_spec`)."""
    if group is None or group.size == 1 or x.shape[dim] % group.size:
        return x
    per = x.shape[dim] // group.size
    return x.narrow(dim, group.index * per, per)


def _all_rows(x: torch.Tensor, group, whole: int) -> torch.Tensor:
    """Every data rank's rows of `x` put back together (`whole` rows)."""
    if group is None or group.size == 1 or x.shape[0] == whole:
        return x
    return shard.all_gather(x, group, tag="serve_rows")


def shard_params(model: Model, params: dict, mesh) -> dict:
    """This rank's blocks of whole params on `mesh` by
    `sharding.param_specs` (every rank passes the same): what the prefill
    and serve steps built with that mesh take."""
    return fsdp.shard_tree(params, sharding.param_specs(
        model.cfg, model.param_axes(), mesh, model.param_shapes()), mesh)


def shard_cache(model: Model, cache: dict, mesh) -> dict:
    """This rank's block of a whole decode cache on `mesh` by
    `sharding.cache_specs`, copied (the serve step writes it in place)."""
    return fsdp.shard_tree(cache, sharding.cache_specs(model.cfg, cache,
                                                       mesh), mesh)


def build_prefill_step(model: Model, shape: ShapeSpec, *, mesh=None,
                       seq_parallel: bool = True,
                       compute_dtype=None) -> Callable:
    """`fn(params, batch) -> (B, V) float32` logits of the prompt's last
    token (`batch["tokens"]` of the shape's (global_batch, seq_len), and
    qwen2-vl's `positions3`, `patches` and `patch_positions`; an
    encoder-decoder's `frames` (B, encoder_seq, D)), as the reference's
    prefill step: no final softcap. With `mesh=` the params are the
    rank's blocks (`shard_params`), the forward runs over the model axis
    (sequence-parallel with `seq_parallel`, `gqa_expand` on, as the
    reference's), each data rank takes its rows of the batch, and every
    rank returns the logits of all of them. `compute_dtype=None` takes the
    policy's."""
    cfg = model.cfg
    compute_dtype = compute_dtype or _policy(cfg)["compute_dtype"]
    want = (shape.global_batch, shape.seq_len)
    gather, dgroup = _serve_mesh(model, mesh)

    @torch.inference_mode()
    def prefill_step(params, batch):
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        if tuple(tokens.shape) != want:
            raise ValueError(f"batch['tokens'] has shape "
                             f"{tuple(tokens.shape)}, the step was built "
                             f"for {want}")
        if mesh is not None:
            return _mesh_prefill(model, params, batch, tokens, dev, gather,
                                 dgroup, compute_dtype, mesh, seq_parallel)
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


def _mesh_prefill(model: Model, params, batch, tokens, dev, gather, dgroup,
                  compute_dtype, mesh, seq_parallel: bool):
    """The prefill step's forward on a mesh: the rank's rows, the model
    axis (an encoder-decoder's `encode` and `decode_hidden`, the other
    families' `forward_hidden`), the last token's logits of every row (no
    final softcap)."""
    from repro_torch.models import transformer
    cfg = model.cfg
    mod = model.mod
    B = tokens.shape[0]
    rows = {"tokens": _rows_of(tokens, dgroup)}
    for k in ("positions3", "patches", "frames"):
        if k in batch:
            t = torch.as_tensor(batch[k]).to(dev)
            rows[k] = _rows_of(t, dgroup, sharding.batch_dim(k))
    if "patch_positions" in batch:
        rows["patch_positions"] = _rows_of(torch.as_tensor(
            batch["patch_positions"]), dgroup)
    sp = _seq_parallel(model, seq_parallel)
    with model_settings.override(mesh=mesh, gqa_expand=True):
        toks = rows.pop("tokens")
        if cfg.family == "encdec":
            enc = mod.encode(cfg, params, rows.pop("frames"),
                             compute_dtype=compute_dtype, gather=gather)
            h = mod.decode_hidden(cfg, params, toks, enc,
                                  compute_dtype=compute_dtype, gather=gather)
        else:
            h = mod.forward_hidden(cfg, params, toks,
                                   compute_dtype=compute_dtype,
                                   gather=gather, seq_parallel=sp, **rows)
        axis = mod.model_axis(cfg, sp)
        if axis is not None and axis.sp(tokens.shape[1]):
            h = axis.all_gather(h[:, -1:], 1, tag="tp_gather")
        last = h[:, -1, :]
        logits = transformer._logits(
            dataclasses.replace(cfg, final_softcap=None), params, last,
            gather, axis)
    return _all_rows(logits, dgroup, B)


def cache_layout(model: Model, batch: int, max_seq: int, mesh) -> str | None:
    """How `sharding.cache_specs` splits the attention cache's K/V over
    the model axis (the decoder's `k`, the hybrid's `attn/k`): 'heads',
    'seq' (its ring's positions) or None (whole on every rank; mamba2's
    cache has no K/V, its states take their layout from the specs)."""
    cspecs = sharding.cache_specs(model.cfg, model.init_cache(
        batch, max_seq, device="meta"), mesh)
    spec = cspecs.get("k") or cspecs.get("attn", {}).get("k")
    if spec is None:
        return None
    model_dim = [i for i, e in enumerate(spec) if e == "model"]
    return {2: "heads", 3: "seq"}.get(model_dim[0]) if model_dim else None


def build_serve_step(model: Model, shape: ShapeSpec, *, mesh=None,
                     logits: bool = False, compute_dtype=None) -> Callable:
    """`fn(params, cache, token, pos, positions3=None) -> (next_tok (B,)
    int32, cache)`: one decode step of the shape's global_batch sequences
    against a cache of its seq_len (`model.init_cache`), written in
    place, and the greedy next token; an M-RoPE config passes
    `positions3` (3, B, 1). An encoder-decoder's cache must hold its
    cross K/V already (`whisper.build_cross_cache`). With `mesh=` the
    params are the rank's blocks (`shard_params`) and the cache its block
    by `sharding.cache_specs` (`shard_cache`); each data rank steps its
    rows, and every rank returns the tokens of all of them. `logits=True`
    returns the step's (B, V) float32 logits third. `compute_dtype=None`
    takes the policy's."""
    compute_dtype = compute_dtype or _policy(model.cfg)["compute_dtype"]
    gather, dgroup = _serve_mesh(model, mesh)
    layout = None
    if mesh is not None:
        layout = cache_layout(model, shape.global_batch, shape.seq_len, mesh)

    def serve_step(params, cache, token, pos, positions3=None):
        if token.shape != (shape.global_batch,):
            raise ValueError(f"token has shape {tuple(token.shape)}, the "
                             f"step was built for ({shape.global_batch},)")
        kw = {} if positions3 is None else {"positions3": positions3}
        if mesh is None:
            out, cache = model.decode_step(params, cache, token, pos,
                                           compute_dtype=compute_dtype, **kw)
            nxt = torch.argmax(out, dim=-1).to(torch.int32)
        else:
            if positions3 is not None:
                kw["positions3"] = _rows_of(positions3, dgroup, 1)
            with model_settings.override(mesh=mesh):
                out, cache = model.decode_step(
                    params, cache, _rows_of(token, dgroup),
                    _rows_of(pos, dgroup), compute_dtype=compute_dtype,
                    gather=gather, cache_layout=layout, **kw)
            out = _all_rows(out, dgroup, shape.global_batch)
            nxt = torch.argmax(out, dim=-1).to(torch.int32)
        return (nxt, cache, out) if logits else (nxt, cache)

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
           "from_numpy_state", "fsdp_axes_for", "grad_view",
           "init_train_state",
           "cache_layout", "moe_groups_for", "shard_cache", "shard_params",
           "shard_state",
           "state_specs", "unshard_state"]
