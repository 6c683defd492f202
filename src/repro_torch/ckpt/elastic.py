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

`resume_pod_rank` restores onto one rank of a pod mesh, whose EF is its
own pod's row: every rank reads the same directory (the ranks share one
filesystem, and the params and optimizer moments, most of the bytes, are
needed whole on every rank anyway, so nothing needs to cross the pod
link), respecs the saved rows to the mesh's pod count and keeps its row
(`rp.shard.scatter_pod_rows`).
"""
from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.core.tree import tree_leaves, tree_map

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
                   device=None, ef_device=None) -> tuple[Any, int]:
    """Restore the newest verified checkpoint onto `npod_new` pods.

    `example_state` describes the NEW job's state tree ({"params", "opt"[,
    "ef"]} with `ef` leaves shaped for `npod_new`: a leading pod dim iff
    npod_new > 1; meta tensors will do). The saved pod count and the
    sketched-EF codec meta come from the manifest (written by
    `runtime/train_loop.py`). Tensors land on `device`, else on each
    example leaf's device (`checkpointer.restore`); a sketched EF decodes
    on `device`, else on the example EF's device, else on CUDA, split
    over `mesh`'s data axes when a mesh is given; `ef_device` puts the EF
    (dense or decoded) on that device instead. Returns (state, step).
    """
    directory = os.fspath(directory)
    verified = step is None
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
                                    device=device,
                                    verify_integrity=not verified)

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
            sk_meta, old_ef_shapes,
            device=_codec_device(new_ef, ef_device or device),
            mesh=mesh, bucket_spec=bucket_spec)
    saved_example = dict(example_state)
    saved_example["ef"] = codec.record_shapes() if codec else old_ef_shapes
    # a step picked by newest_verified_step was just verified
    restored, step = checkpointer.restore(directory, saved_example, step,
                                          device=device,
                                          verify_integrity=not verified)
    if codec:
        ef_old = codec.decode(restored["ef"])
    else:   # the dense rows go where the new job's EF lives
        ef_old = tree_map(
            lambda got, want: got.to(checkpointer._leaf_device(
                want, ef_device or device)), restored["ef"], new_ef)
    restored["ef"] = respec_pod_ef(ef_old, npod_old, npod_new)
    return restored, step


def resume_pod_rank(directory: str | os.PathLike, example_state: Any,
                    mesh) -> tuple[Any, int]:
    """Restore the newest verified checkpoint onto this rank of `mesh`,
    whose 'pod' axis has `npod` ranks.

    `example_state` is this rank's state ({"params", "opt"[, "ef"]}, its
    EF leaves this pod's row, without a pod dim). Every rank reads the
    directory, respecs the saved EF rows to `npod` (`respec_pod_ef`, as
    `resume_elastic` does; a sketched record decodes whole on every rank,
    the operator drawn from the saved seed) and keeps its own row. The
    tensors land on the example leaves' devices. Returns (state, step).
    """
    from repro_torch.rp.shard import scatter_pod_rows
    npod = mesh.group("pod").size
    if not (isinstance(example_state, dict) and "ef" in example_state):
        return resume_elastic(directory, example_state, npod_new=npod)
    rows = example_state["ef"]
    ef_device = next(leaf.device for leaf in tree_leaves(rows))
    example = dict(example_state)
    example["ef"] = tree_map(lambda leaf: torch.empty(
        ((npod,) if npod > 1 else ()) + tuple(leaf.shape), dtype=leaf.dtype,
        device="meta"), rows)
    restored, step = resume_elastic(directory, example, npod_new=npod,
                                    ef_device=ef_device)
    if npod > 1:
        restored["ef"] = scatter_pod_rows(restored["ef"], mesh)
    return restored, step


__all__ = ["respec_pod_ef", "resume_elastic", "resume_pod_rank"]
