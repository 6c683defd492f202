"""Elastic resume: restore a training checkpoint onto a DIFFERENT pod count.

Port of `repro/ckpt/elastic.py`. Params and optimizer moments are
pod-replicated, so they restore as they are. The one pod-shaped state is
the error-feedback residual, one row per pod, whose meaning is additive:
`respec_pod_ef` re-buckets the rows and keeps `sum_w e_w`:

  * npod_new divides npod_old — each new row is the SUM of a contiguous
    group of old rows, fp32 additions in a fixed order: bit-exact, no
    division anywhere.
  * otherwise (growing, or a shrink that does not divide) — every new row
    carries total/npod_new: total-preserving and deterministic, but the
    per-pod attribution is lost.

`resume_elastic` reads the manifest of the newest VERIFIED checkpoint,
rebuilds the sketched-EF codec from the saved meta when there is one
(the operator drawn again from the SAVED seed), and respecs the pod dim
to the new count. On a new mesh the codec decodes with that mesh's
bucket layout (`launch/sharding.py::bucket_specs`): each rank
reconstructs its block of every leaf's buckets and the blocks are
gathered, so the state equals what `mesh=None` returns.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.core.tree import tree_map

from . import checkpointer
from .checkpointer import CheckpointError
from .sketched import SketchedTreeCodec, _codec_device


def _fold_sum(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    # explicit left-to-right adds, not torch.sum: a fixed fold makes the
    # bit-exactness claim hold against any reference that adds in order
    acc = x[lo]
    for i in range(lo + 1, hi):
        acc = acc + x[i]
    return acc


def _respec_leaf(x, npod_old: int, npod_new: int) -> torch.Tensor:
    x = torch.as_tensor(x)
    if npod_old == 1:                       # no pod dim on the saved leaf
        if npod_new == 1:
            return x
        return torch.stack([x / npod_new] * npod_new)
    if tuple(x.shape[:1]) != (npod_old,):
        raise CheckpointError(
            f"EF leaf has leading dim {x.shape[0] if x.ndim else None}, "
            f"expected the saved pod count {npod_old}")
    if npod_new == 1:
        return _fold_sum(x, 0, npod_old)    # exact: fixed-order fp32 adds
    if npod_old == npod_new:
        return x
    if npod_old % npod_new == 0:            # exact: contiguous group sums
        g = npod_old // npod_new
        return torch.stack([_fold_sum(x, b * g, (b + 1) * g)
                            for b in range(npod_new)])
    total = _fold_sum(x, 0, npod_old)       # total-preserving redistribution
    return torch.stack([total / npod_new] * npod_new)


def respec_pod_ef(ef_tree: Any, npod_old: int, npod_new: int) -> Any:
    """Re-bucket per-pod EF residual rows onto a new pod count.

    Keeps the pod SUM of every leaf; bit-exact (no division) whenever
    `npod_new` divides `npod_old` (npod_new == 1 included).
    """
    if npod_old < 1 or npod_new < 1:
        raise CheckpointError(
            f"pod counts must be >= 1, got old={npod_old} new={npod_new}")
    return tree_map(lambda x: _respec_leaf(x, npod_old, npod_new), ef_tree)


def _pod_stripped(shape: tuple, npod: int) -> tuple:
    return tuple(shape[1:]) if npod > 1 else tuple(shape)


def resume_elastic(directory: str | os.PathLike, example_state: Any, *,
                   npod_new: int, mesh=None, step: int | None = None,
                   device=None) -> tuple[Any, int]:
    """Restore the newest verified checkpoint onto `npod_new` pods.

    `example_state` describes the NEW job's state tree ({"params", "opt"[,
    "ef"]} with `ef` leaves shaped for `npod_new`: a leading pod dim iff
    npod_new > 1; meta tensors will do). The saved pod count and the
    sketched-EF codec meta come from the manifest (written by
    `runtime/train_loop.py`). Tensors land on `device`, else on each
    example leaf's device (`checkpointer.restore`); a sketched EF decodes
    on `device`, else on the example EF's device, else on CUDA, split
    over `mesh`'s data axes when a mesh is given. Returns (state, step).
    """
    directory = os.fspath(directory)
    if step is None:
        step = checkpointer.newest_verified_step(directory)
        if step is None:
            raise checkpointer.CorruptionError(
                f"no verifiable checkpoint under {directory}")
    manifest = checkpointer.read_manifest(directory, step)
    extra = manifest.get("extra", {})
    npod_old = int(extra.get("npod", 1))
    sk_meta = extra.get("sketched_ef")

    has_ef = isinstance(example_state, dict) and "ef" in example_state
    if not has_ef:
        return checkpointer.restore(directory, example_state, step,
                                    device=device)

    # the SAVED tree's ef is shaped for npod_old (and possibly sketched):
    # rebuild that example from the new job's, pod dim swapped
    new_ef = example_state["ef"]
    old_ef_shapes = tree_map(
        lambda leaf: torch.empty(
            ((npod_old,) if npod_old > 1 else ())
            + _pod_stripped(tuple(leaf.shape), npod_new),
            dtype=leaf.dtype, device="meta"), new_ef)
    codec = None
    if sk_meta is not None:
        bucket_spec = None
        if mesh is not None:
            from repro_torch.launch.sharding import bucket_specs
            bucket_spec = bucket_specs(mesh)
        codec = SketchedTreeCodec.from_meta(
            sk_meta, old_ef_shapes, device=_codec_device(new_ef, device),
            mesh=mesh, bucket_spec=bucket_spec)
    saved_example = dict(example_state)
    saved_example["ef"] = codec.record_shapes() if codec else old_ef_shapes
    restored, step = checkpointer.restore(directory, saved_example, step,
                                          device=device)
    if codec:
        ef_old = codec.decode(restored["ef"])
    else:   # the dense rows go where the new job's EF lives
        ef_old = tree_map(
            lambda got, want: got.to(checkpointer._leaf_device(want, device)),
            restored["ef"], new_ef)
    restored["ef"] = respec_pod_ef(ef_old, npod_old, npod_new)
    return restored, step


__all__ = ["respec_pod_ef", "resume_elastic"]
