"""Logical-axis -> mesh-axis layout rules (port of
`repro/launch/sharding.py`).

Parameters carry logical axis names (`models.<family>.param_axes`); this
module maps them to specs for a concrete mesh, with the reference's
per-dimension divisibility fallbacks (whisper's vocab of 51865 does not
split over 16 ranks, so its vocab dim falls back to replicated, recorded
in `notes`). A spec is a tuple with one entry a dim: None, one axis name,
or a tuple of names (the reference's `PartitionSpec` entries).

Strategy (the reference's):
  embed, vocab_fsdp -> (pod, data)  FSDP: the weights' data-axis blocks
  heads/mlp/vocab   -> model        tensor parallel
  experts           -> model        expert parallel (if E divides |model|)
  expert_mlp        -> model        only when experts don't shard
  layers            -> None         (the layer stack)
The batch goes over the data axes (`batch_spec`); the residual stream's
sequence over 'model' between blocks (`seq_spec`, the reference's
`shard_batch_seq`, whose rows a rank holds are `seq_rows`); a decode
cache by `cache_specs`. `model_split` names the leaves whose spec splits
a dim over 'model': a family runs a part split over the model axis where
the specs split its leaves, and whole on every model rank where they do
not (`models.<family>.split_parts`), so any model size `spec_for`
accepts runs. Every function here reads only `mesh.shape` and
`mesh.axis_names` (and `seq_rows` a mesh's `group`), so a stand-in mesh
with no process group will do. The port runs the data axis
(`launch/fsdp.py`) and the model axis (`launch/tp.py`).
"""
from __future__ import annotations

import functools
import types
from typing import Any

from repro_torch.models.config import ArchConfig

from .mesh import data_axes, model_size


def axis_rules(cfg: ArchConfig, mesh, *, fsdp_axes=None) -> dict[str, Any]:
    """Logical axis -> mesh axes. `fsdp_axes` overrides the data axes the
    parameters are sharded over (the reference's compressor on a pod mesh
    sets ('data',): params replicate across pods)."""
    dp = fsdp_axes if fsdp_axes is not None else data_axes(mesh)
    ms = model_size(mesh)
    experts_shardable = (cfg.moe is not None
                         and cfg.moe.num_experts % ms == 0)
    return {
        "embed": dp,
        "vocab_fsdp": dp,
        "embed_tp": "model",
        "heads": "model",
        "mlp": "model",
        "mlp2": None,
        "vocab": "model",
        "experts": "model" if experts_shardable else None,
        "expert_mlp": None if experts_shardable else "model",
        "layers": None,
        None: None,
    }


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def spec_for(shape: tuple[int, ...], axes: tuple, rules: dict, mesh,
             notes: list | None = None) -> tuple:
    """The spec of one leaf: each dim's mesh axes, dropping axes that do
    not divide the dim (a tuple of axes first tries its prefixes); each
    drop to replicated is recorded in `notes`."""
    entries = []
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.get(logical, None)
        if mesh_axis is None:
            entries.append(None)
            continue
        if dim % _axis_size(mesh, mesh_axis) != 0:
            chosen = None
            if isinstance(mesh_axis, (tuple, list)):
                for cut in range(len(mesh_axis) - 1, 0, -1):
                    sub = tuple(mesh_axis[:cut])
                    if dim % _axis_size(mesh, sub) == 0:
                        chosen = sub
                        break
            if chosen is None and notes is not None:
                notes.append(f"dim {dim} !% {mesh_axis} -> replicated")
            entries.append(chosen)
        else:
            entries.append(tuple(mesh_axis) if isinstance(mesh_axis, list)
                           else mesh_axis)
    return tuple(entries)


def _shape(node) -> tuple[int, ...]:
    return tuple(node) if isinstance(node, (tuple, list)) \
        else tuple(node.shape)


def param_specs(cfg: ArchConfig, axes_tree, mesh, shapes_tree,
                notes: list | None = None, *, fsdp_axes=None):
    """The tree of specs matching the params tree (`shapes_tree`: tensors,
    meta tensors or shape tuples; `axes_tree`: `Model.param_axes()`),
    notes in sorted-key order."""
    rules = axis_rules(cfg, mesh, fsdp_axes=fsdp_axes)

    def walk(shapes, axes):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], axes[k]) for k in sorted(shapes)}
        return spec_for(_shape(shapes), axes, rules, mesh, notes)
    return walk(shapes_tree, axes_tree)


def model_split(cfg: ArchConfig, mesh) -> frozenset[str]:
    """The leaves ('/'-joined paths, as `fsdp.Sharded` names them) whose
    spec by `param_specs` splits a dim over 'model' on `mesh`; none
    without a model axis above 1. It reads the specs and adds no rule."""
    if model_size(mesh) <= 1:
        return frozenset()
    names = tuple(mesh.axis_names)
    return _model_split(cfg, names, tuple(mesh.shape[a] for a in names))


@functools.lru_cache(maxsize=64)
def _model_split(cfg: ArchConfig, names: tuple, sizes: tuple
                 ) -> frozenset[str]:
    from repro_torch.models import build_model
    model = build_model(cfg)
    stand = types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                  axis_names=names)
    out = set()

    def walk(specs, prefix):
        for k, spec in specs.items():
            if isinstance(spec, dict):
                walk(spec, f"{prefix}{k}/")
            elif any(e == "model" or (isinstance(e, tuple) and "model" in e)
                     for e in spec):
                out.add(f"{prefix}{k}")
    walk(param_specs(cfg, model.param_axes(), stand, model.param_shapes()),
         "")
    return frozenset(out)


def bucket_specs(mesh, *, exclude: tuple = ()) -> tuple:
    """Spec template for `(n_buckets, ...)` sketch-bucket arrays: the
    bucket dim over the mesh's data axes, minus `exclude` (the pod axis,
    whose ranks hold different trees). The sketcher falls back to the whole
    leaf where the axes do not divide a leaf's bucket count."""
    axes = tuple(a for a in data_axes(mesh) if a not in exclude)
    return (axes,) if axes else (None,)


def batch_spec(shape: tuple[int, ...], mesh) -> tuple:
    """Dim 0 (the global batch) over as many data axes as divide it,
    replicated when none does."""
    dp = data_axes(mesh)
    n = shape[0]
    for cut in range(len(dp), -1, -1):
        sub = dp[:cut]
        if n % _axis_size(mesh, sub) == 0:
            return (sub if sub else None,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def input_batch_specs(batch_tree, mesh):
    """Specs for a batch dict (tokens, labels, frames, ...; tensors, meta
    tensors or shape tuples): positions3 (3, B, S) holds its batch on dim
    1, everything else on dim 0."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        shape = _shape(node)
        if name == "positions3":
            return (None,) + batch_spec(shape[1:], mesh)
        return batch_spec(shape, mesh)
    return walk(batch_tree, None)


def cache_specs(cfg: ArchConfig, cache_tree, mesh):
    """Specs for a decode cache (tensors, meta tensors or shape tuples
    under the families' names), the reference's layouts and fallbacks for
    the parts that run split over 'model' (`models.<family>.split_parts`):
    k/v (and whisper's cross xk/xv) (L, B, H, S, hd) by heads where the
    model size divides H, else by positions where it divides S, else
    whole; `pos` (L, B, S) follows the positions' split; mamba2's `ssm`
    (L, B, H, P, ds) by heads and its `conv` (L, B, W-1, C) by channels
    where the model size divides them, the RG-LRU's `h` (G, B, dr) and
    `conv` by width. The cache of a part that runs whole on every model
    rank (its attention, mixer or recurrent block) stays whole. The batch
    dim goes over the data axes where they divide it."""
    from repro_torch.models import build_model
    ms = model_size(mesh)
    parts = build_model(cfg).mod.split_parts(cfg, mesh) if ms > 1 else {}
    kv = None       # the K/V's split: "heads", "seq" or None

    def spec(name, shape):
        nonlocal kv
        b = shape[1] if len(shape) > 1 else 1
        bax = batch_spec((b,), mesh)[0]
        if name in ("k", "v", "xk", "xv") and len(shape) == 5:
            _, _, H, S, _ = shape
            kv = (None if not parts.get("attn") else "heads" if H % ms == 0
                  else "seq" if S % ms == 0 else None)
            return (None, bax, "model" if kv == "heads" else None,
                    "model" if kv == "seq" else None, None)
        if name == "pos" and len(shape) == 3:
            return (None, bax, "model" if kv == "seq" else None)
        if name == "ssm":
            return (None, bax, "model" if parts.get("mixer") else None,
                    None, None)
        if name == "conv":
            split = parts.get("mixer", parts.get("rec")) and \
                shape[3] % ms == 0
            return (None, bax, None, "model" if split else None)
        if name == "h":
            return (None, bax, "model" if parts.get("rec") else None)
        return (None,) * len(shape)

    def walk(node, name):
        if isinstance(node, dict):     # the K/V before their positions
            out = {k: walk(node[k], k) for k in sorted(
                node, key=lambda k: k == "pos")}
            return {k: out[k] for k in node}
        return spec(name, _shape(node))
    return walk(cache_tree, None)


def seq_spec(shape: tuple[int, ...], mesh, *, seq_axis: int = 1,
             exclude: tuple = ()) -> tuple:
    """The residual stream's layout under sequence parallelism (the
    reference's `shard_batch_seq`): dim 0 over the data axes (minus
    `exclude`) where they divide it, the sequence over 'model' where the
    model size divides it."""
    dp = tuple(a for a in data_axes(mesh) if a not in exclude)
    entries: list = [None] * len(shape)
    entries[0] = dp if shape[0] % _axis_size(mesh, dp) == 0 else None
    if shape[seq_axis] % model_size(mesh) == 0:
        entries[seq_axis] = "model"
    return tuple(entries)


def seq_rows(seq_len: int, mesh) -> tuple[int, int]:
    """This rank's rows [lo, hi) of a sequence of `seq_len` split over
    'model' by `seq_spec` (all of them where the model size does not
    divide it)."""
    ms = model_size(mesh)
    if ms <= 1 or seq_len % ms:
        return 0, seq_len
    per = seq_len // ms
    i = mesh.group("model").index
    return i * per, (i + 1) * per


def batch_dim(name: str) -> int:
    """The dim of a batch entry that holds its rows."""
    return 1 if name == "positions3" else 0


__all__ = ["axis_rules", "batch_dim", "batch_spec", "bucket_specs",
           "cache_specs", "input_batch_specs", "model_split", "param_specs",
           "seq_rows",
           "seq_spec", "spec_for"]
