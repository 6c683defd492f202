"""The data axis of a mesh for parameters: each rank holds blocks (FSDP).

The reference leaves this to XLA's partitioner: its train step is jitted
with every parameter, moment and batch laid out by `launch/sharding.py`'s
specs, and XLA inserts the gathers and reduce-scatters. The port runs one
process a rank, so the same layout is written out here:

* `shard_tree(tree, specs, mesh)`: this rank's block of every leaf along
  its spec's data entry (a leaf whose spec shards nothing stays whole:
  the norms, and any dim `spec_for` fell back to replicated on);
  `unshard_tree` and `gather_tree` put the blocks back together (on every
  rank, or on the group's first rank for a checkpoint).
* `Sharded`, the forward's `gather=` (`models.params.take`): it reads one
  layer's slice of a sharded leaf through an all_gather of the blocks
  along the spec's dim, inside the layer, so under remat the backward
  gathers it again (ZeRO-3's behaviour, and XLA's). The backward of the
  gather reduce-scatters the full-leaf gradient to the rank's block and
  divides it by the data size: the step's loss is the mean of the ranks'
  losses. With `reduce="all"` (the compressed step, whose sketcher needs
  each leaf's mean gradient whole) it all-reduces instead, keeps the
  whole mean for `Sharded.finish` and hands autograd the block of it.
* `Sharded.finish`: the replicated leaves' gradients, which every rank
  computed on its own rows, become their mean (one all_reduce of them
  all); `Sharded.global_norm`: the gradient norm over every rank's
  blocks, a replicated leaf counted once; `Sharded.ranges`: each leaf's
  split dim and this rank's range of it (K4's block form).

On a pod x data mesh whose pods each sync through the compressed pod
collective (the reference's `fsdp_axes=("data",)`), `Sharded(axes=
("data",))` averages the gradients over the data ranks of this rank's
pod only: the pod's mean gradient, which `compress_collective` then
syncs across pods.

Every collective goes through `rp.shard`'s ledger under its own tag:
`param_gather`, `grad_reduce`, `grad_replicated`, `grad_norm`.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.rp import shard

from .mesh import data_axes


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def shard_dim(spec: tuple, mesh) -> int | None:
    """The dim of a leaf that `spec` splits over more than one rank, or
    None. Two such dims (data and model) are item 12.7b's."""
    dims = [d for d, e in enumerate(spec) if _size(mesh, _axes(e)) > 1]
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec} splits {len(dims)} dims; a leaf split over a model "
            "axis too is item 12.7b (ROADMAP.md, queue 1)")
    return dims[0] if dims else None


def block(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a view; the leaf itself when the
    spec shards nothing)."""
    if shard_dim(spec, mesh) is None:
        return leaf
    return leaf[block_slices(leaf.shape, spec, mesh)]


def block_slices(shape, spec: tuple, mesh) -> tuple:
    """The index of this rank's block in an array of `shape` (slices)."""
    d = shard_dim(spec, mesh)
    if d is None:
        return tuple(slice(None) for _ in shape)
    grp = mesh_group(mesh, spec[d])
    per = shape[d] // grp.size
    return tuple(slice(grp.index * per, (grp.index + 1) * per) if i == d
                 else slice(None) for i in range(len(shape)))


def _flat_specs(specs, prefix: str = "") -> dict[str, tuple]:
    out: dict[str, tuple] = {}
    for k in sorted(specs):
        if isinstance(specs[k], dict):
            out.update(_flat_specs(specs[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = specs[k]
    return out


def shard_tree(tree, specs, mesh):
    """This rank's blocks of a whole tree: a copy of each sharded leaf's
    block (so the whole leaf can be freed), a replicated leaf as it is."""
    def one(leaf, spec):
        b = block(leaf, spec, mesh)
        return b.clone() if b is not leaf else leaf
    return _map_flat(one, tree, _flat_specs(specs))


def _map_flat(fn, tree, flat: dict):
    leaves, treedef = tree_flatten(tree)
    if len(flat) != len(leaves):
        raise ValueError(f"a tree of {len(leaves)} leaves against "
                         f"{len(flat)} specs")
    return tree_unflatten(treedef, [fn(x, s) for x, s in
                                    zip(leaves, flat.values())])


def unshard_tree(tree, specs, mesh, *, tag: str = "unshard"):
    """The whole tree on every rank from each rank's blocks (one
    all_gather a sharded leaf): the inverse of `shard_tree`."""
    def one(leaf, spec):
        d = shard_dim(spec, mesh)
        if d is None:
            return leaf
        return shard.all_gather_dim(leaf, mesh_group(mesh, spec[d]), d,
                                    tag=tag)
    return _map_flat(one, tree, _flat_specs(specs))


def gather_tree(tree, specs, mesh, *, tag: str = "ckpt_gather"):
    """The whole tree on the data group's first rank (one gather a
    sharded leaf), None on the others: what rank 0 writes to a
    checkpoint."""
    first = mesh.group(data_axes(mesh)).index == 0

    def one(leaf, spec):
        d = shard_dim(spec, mesh)
        if d is None:
            return leaf
        stack = shard.gather(leaf, mesh_group(mesh, spec[d]), tag=tag)
        return None if stack is None else torch.cat(list(stack.unbind(0)),
                                                     dim=d)
    out = _map_flat(one, tree, _flat_specs(specs))
    return out if first else None


class _Gather(torch.autograd.Function):
    """One layer's slice of a sharded leaf: its blocks all-gathered along
    `dim`; the backward reduces the gradient to the rank's block."""

    @staticmethod
    def forward(ctx, blk, layout, path, dim, index, group, full_shape):
        ctx.meta = (layout, path, dim, index, group, full_shape)
        return shard.all_gather_dim(blk, group, dim, tag="param_gather")

    @staticmethod
    def backward(ctx, g):
        layout, path, dim, index, group, full_shape = ctx.meta
        n = layout.size
        rest = layout.rest(group)
        if layout.reduce == "scatter":
            out = shard.reduce_scatter(g, group, dim, tag="grad_reduce")
            if rest is not None:    # the ranks that hold the same block
                out = shard.all_reduce(out, rest, tag="grad_reduce")
            out = out / n
        else:
            mean = shard.all_reduce(g, layout.group, tag="grad_reduce") / n
            sink = layout._full.get(path)
            if sink is None:
                sink = layout._full[path] = mean.new_zeros(full_shape)
            (sink if index is None else sink[index]).add_(mean)
            per = g.shape[dim] // group.size
            out = mean.narrow(dim, group.index * per, per)
        return out, None, None, None, None, None, None


class Sharded:
    """A data mesh's view of a parameter tree laid out by `specs` (the
    tree of `sharding.param_specs`): the forward's `gather=`, and the
    gradient bookkeeping of one step. `reduce` is 'scatter' (each rank's
    block of the mean gradient) or 'all' (the whole mean gradient of
    every sharded leaf, which `finish` returns)."""

    def __init__(self, mesh, specs, *, reduce: str = "scatter",
                 axes: tuple[str, ...] | None = None):
        if reduce not in ("scatter", "all"):
            raise ValueError(f"unknown reduce {reduce!r}; expected "
                             "'scatter' or 'all'")
        self.mesh = mesh
        self.reduce = reduce
        self.specs = _flat_specs(specs)
        self.dims = {p: shard_dim(s, mesh) for p, s in self.specs.items()}
        # the ranks whose gradients are averaged: every data axis, or the
        # data ranks within a pod (`axes=("data",)`)
        self.group = mesh.group(data_axes(mesh) if axes is None else axes)
        self.size = self.group.size
        for p, d in self.dims.items():
            if d is not None and not set(_axes(self.specs[p][d])) <= set(
                    self.group.axes):
                raise ValueError(f"{p} is split over {self.specs[p][d]}, "
                                 f"outside the gradient's axes "
                                 f"{self.group.axes}")
        self._full: dict[str, torch.Tensor] = {}

    def rest(self, group):
        """The group of the gradient's axes that a leaf's `group` leaves
        out (the ranks holding the same block of a leaf split over fewer
        axes, as ('pod',) where ('pod', 'data') does not divide its dim),
        or None."""
        axes = tuple(a for a in self.group.axes if a not in group.axes)
        return self.mesh.group(axes) if axes else None

    def __call__(self, path: str, leaf: torch.Tensor,
                 index: int | None = None) -> torch.Tensor:
        d = self.dims[path]
        x = leaf if index is None else leaf[index]
        if d is None:
            return x
        if index is not None and d == 0:
            raise ValueError(f"{path}: a stacked leaf split along its "
                             "layer dim cannot be read a layer at a time")
        group = mesh_group(self.mesh, self.specs[path][d])
        full = list(leaf.shape)
        full[d] *= group.size
        dim = d if index is None else d - 1
        return _Gather.apply(x, self, path, dim, index, group, tuple(full))

    def finish(self, grads):
        """The step's gradient tree from autograd's (blocks of the
        sharded leaves, each rank's own gradient of the replicated ones):
        the replicated leaves' mean over the data ranks (one all_reduce of
        them all, tag `grad_replicated`). With reduce='all' the sharded
        leaves come back whole: the mean the backward kept."""
        flat, treedef = tree_flatten(grads)
        paths = list(self.specs)
        rep = [i for i, p in enumerate(paths) if self.dims[p] is None]
        if rep:
            cat = torch.cat([flat[i].reshape(-1) for i in rep])
            cat = shard.all_reduce(cat, self.group,
                                   tag="grad_replicated") / self.size
            for i, t in zip(rep, cat.split([flat[i].numel() for i in rep])):
                flat[i] = t.view_as(flat[i])
        if self.reduce == "all":
            for i, p in enumerate(paths):
                if self.dims[p] is not None:
                    flat[i] = self._full.pop(p)
        return tree_unflatten(treedef, flat)

    def blocks(self, tree):
        """This rank's block (a view) of every leaf of a whole tree."""
        return _map_flat(lambda x, s: block(x, s, self.mesh), tree,
                         self.specs)

    def ranges(self, shapes) -> list:
        """For each leaf of a tree of whole leaves (tensors or meta
        tensors), in `tree_flatten` order: `(dim, lo, hi)`, this rank's
        range of the leaf's split dim, or None for a leaf it holds whole
        (`adamw.update_sketched(blocks=)`)."""
        out = []
        for (p, spec), leaf in zip(self.specs.items(),
                                   tree_flatten(shapes)[0]):
            d = self.dims[p]
            if d is None:
                out.append(None)
                continue
            sl = block_slices(tuple(leaf.shape), spec, self.mesh)[d]
            out.append((d, sl.start, sl.stop))
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The l2 norm of the whole gradient from the ranks' blocks: the
        sharded leaves' squares summed over the data ranks (one all_reduce
        of a scalar, tag `grad_norm`), each replicated leaf once."""
        flat, _ = tree_flatten(grads)
        zero = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        sharded, rep = zero, zero
        for g, p in zip(flat, self.specs):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            d = self.dims[p]
            if d is None:
                rep = rep + sq
            else:   # a block that several ranks hold is counted once
                sharded = sharded + sq / (self.size // mesh_group(
                    self.mesh, self.specs[p][d]).size)
        total = shard.all_reduce(sharded.reshape(1), self.group,
                                 tag="grad_norm")[0]
        return torch.sqrt(total + rep)


def mesh_group(mesh, entry):
    """The `AxisGroup` of a spec entry's axes."""
    return mesh.group(_axes(entry))


__all__ = ["Sharded", "block", "block_slices", "gather_tree", "mesh_group",
           "shard_dim", "shard_tree", "unshard_tree"]
