"""The data and model axes of a mesh for parameters: each rank holds blocks.

The reference leaves this to XLA's partitioner: its train step is jitted
with every parameter, moment and batch laid out by `launch/sharding.py`'s
specs, and XLA inserts the gathers and reduce-scatters. The port runs one
process a rank, so the same layout is written out here (the model axis's
activation collectives are `launch/tp.py`'s):

* `shard_tree(tree, specs, mesh)`: this rank's block of every leaf along
  its spec's entries: a dim over the data axes (FSDP) and, on a (data,
  model) mesh, a dim over 'model' (tensor or expert parallelism), so a
  block may be split on two dims (`wq` (L, D, Hq*hd): dim 1 over 'data',
  dim 2 over 'model'). A leaf whose spec splits nothing stays whole (the
  norms, and any dim `spec_for` fell back to replicated on);
  `unshard_tree` and `gather_tree` put the blocks back together (on every
  rank, or on the mesh's first rank for a checkpoint).
* `Sharded`, the forward's `gather=` (`models.params.take`): it reads one
  layer's slice of a sharded leaf through an all_gather of the blocks
  along its data dim, inside the layer, so under remat the backward
  gathers it again (ZeRO-3's behaviour, and XLA's). It returns the rank's
  model block (a column-parallel `wq`'s heads, a row-parallel `wo`'s);
  `whole=True` gathers the model dim too (KV weights whose heads the
  model axis does not divide, the tied embedding's unembedding, the
  leaves the specs split of a part that runs whole, `launch/tp.py`). The
  backward of the gather reduce-scatters the gradient to the rank's block:
  over 'model' a sum of the ranks' partial gradients (`partial=True`), or,
  where every model rank computed the same whole gradient (a whole part
  on a stream alike on every rank, `partial=False`, tag `model_whole`),
  the rank's block of it; over the data axes a mean (each data rank's
  loss term is scaled so that their mean is the step's loss,
  `loss_scale`). With `reduce="all"` (the compressed step,
  whose sketcher needs each leaf's mean gradient whole) it all-reduces
  instead, keeps the reduced gradient for `Sharded.finish` and hands
  autograd the block of it.
* `Sharded.finish`: the gradients of the leaves the data axes do not
  split, which every rank computed on its own rows, become their mean
  (one all_reduce of them all); under sequence parallelism
  (`seq_parallel=True`) the leaves the model axis does not split (the
  norms, the router) hold each model rank's partial sum over its own
  sequence rows, which become their sum (one all_reduce); without it
  only those a family reads inside a parallel region do (`partial=`, the
  family's `model_partial`: the MoE router of split experts, mamba2's
  `a_log`, `d_skip` and `dt_bias` of a split mixer, read on the rank's
  heads). The leaves of a part that runs whole are alike without it.
  With
  reduce='all' every sharded leaf comes back whole (a model-split leaf
  all-gathered over 'model', tag `grad_model_gather`).
  `Sharded.global_norm`: the gradient norm over every rank's blocks, a
  block several ranks hold counted once; `Sharded.ranges`: each leaf's
  split dims and this rank's ranges of them (K4's block form).

On a pod x data mesh whose pods each sync through the compressed pod
collective (the reference's `fsdp_axes=("data",)`), `Sharded(axes=
("data",))` averages the gradients over the data ranks of this rank's
pod only: the pod's mean gradient, which `compress_collective` then
syncs across pods.

Every collective goes through `rp.shard`'s ledger under its own tag:
`param_gather` (the data dim), `model_gather` / `model_whole` (the model
dim of a whole read, partial or alike), `grad_reduce`, `model_grad` (a whole read's backward over
'model'), `grad_replicated`, `grad_model`, `grad_model_gather`,
`grad_norm`.
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


def _is_model(entry) -> bool:
    return _axes(entry) == ("model",)


def shard_dims(spec: tuple, mesh) -> tuple[int, ...]:
    """The dims of a leaf that `spec` splits over more than one rank, in
    order: none, one (over the data axes or 'model') or two (one over
    each)."""
    return tuple(d for d, e in enumerate(spec) if _size(mesh, _axes(e)) > 1)


def shard_dim(spec: tuple, mesh) -> int | None:
    """The dim of a leaf that `spec` splits over more than one rank, or
    None; a leaf split on two dims (a (data, model) mesh) raises: its
    callers take `shard_dims`."""
    dims = shard_dims(spec, mesh)
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits {len(dims)} dims; take "
                         "fsdp.shard_dims for a leaf of a (data, model) mesh")
    return dims[0] if dims else None


def block(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a view; the leaf itself when the
    spec shards nothing)."""
    if not shard_dims(spec, mesh):
        return leaf
    return leaf[block_slices(leaf.shape, spec, mesh)]


def block_slices(shape, spec: tuple, mesh) -> tuple:
    """The index of this rank's block in an array of `shape` (slices)."""
    out = [slice(None) for _ in shape]
    for d in shard_dims(spec, mesh):
        grp = mesh_group(mesh, spec[d])
        per = shape[d] // grp.size
        out[d] = slice(grp.index * per, (grp.index + 1) * per)
    return tuple(out)


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
    all_gather a split dim of a leaf): the inverse of `shard_tree`."""
    def one(leaf, spec):
        for d in shard_dims(spec, mesh):
            leaf = shard.all_gather_dim(leaf, mesh_group(mesh, spec[d]), d,
                                        tag=tag)
        return leaf
    return _map_flat(one, tree, _flat_specs(specs))


def gather_tree(tree, specs, mesh, *, tag: str = "ckpt_gather"):
    """The whole tree on the mesh's first rank (a leaf split on two dims
    all-gathers its model dim first, then one gather of its data dim),
    None on the others: what rank 0 writes to a checkpoint."""
    axes = data_axes(mesh) + (("model",) if "model" in mesh.axis_names
                              else ())
    first = mesh.group(axes).index == 0

    def one(leaf, spec):
        dims = shard_dims(spec, mesh)
        for d in dims[1:]:
            leaf = shard.all_gather_dim(leaf, mesh_group(mesh, spec[d]), d,
                                        tag=tag)
        if not dims:
            return leaf
        d = dims[0]
        stack = shard.gather(leaf, mesh_group(mesh, spec[d]), tag=tag)
        return None if stack is None else torch.cat(list(stack.unbind(0)),
                                                     dim=d)
    out = _map_flat(one, tree, _flat_specs(specs))
    return out if first else None


class _Gather(torch.autograd.Function):
    """One layer's slice of a sharded leaf: its blocks all-gathered along
    each of `steps` ((group, dim, tag): the data dim, then the model dim
    of a whole read); the backward reduces the gradient to the rank's
    block (see the module docstring)."""

    @staticmethod
    def forward(ctx, blk, layout, path, steps, index, full_shape):
        ctx.meta = (layout, path, steps, index, full_shape)
        for group, dim, tag in steps:
            blk = shard.all_gather_dim(blk, group, dim, tag=tag)
        return blk if steps else blk.view_as(blk)

    @staticmethod
    def backward(ctx, g):
        layout, path, steps, index, full_shape = ctx.meta
        for group, dim, tag in steps:   # the model ranks' partial sums
            if tag == "model_gather":
                g = shard.reduce_scatter(g, group, dim, tag="model_grad")
            elif tag == "model_whole":  # alike on every model rank
                per = g.shape[dim] // group.size
                g = g.narrow(dim, group.index * per, per)
        for group, dim, tag in steps:
            if tag != "param_gather":
                continue
            if layout.reduce == "scatter":
                g = shard.reduce_scatter(g, group, dim, tag="grad_reduce")
                rest = layout.rest(group)
                if rest is not None:    # the ranks that hold the same block
                    g = shard.all_reduce(g, rest, tag="grad_reduce")
            else:
                g = shard.all_reduce(g, layout.group, tag="grad_reduce")
            g = g / layout.size
        if layout.reduce == "all":  # whole over the data axes: kept
            sink = layout._sum.get(path)
            if sink is None:
                sink = layout._sum[path] = g.new_zeros(full_shape)
            (sink if index is None else sink[index]).add_(g)
            for group, dim, tag in steps:
                if tag == "param_gather":
                    per = g.shape[dim] // group.size
                    g = g.narrow(dim, group.index * per, per)
        return g, None, None, None, None, None


class Sharded:
    """A mesh's view of a parameter tree laid out by `specs` (the tree of
    `sharding.param_specs`): the forward's `gather=`, and the gradient
    bookkeeping of one step. `reduce` is 'scatter' (each rank's block of
    the mean gradient) or 'all' (the whole mean gradient of every sharded
    leaf, which `finish` returns). `seq_parallel` says the forward runs
    the model axis sequence-parallel (`launch.tp.ModelAxis`): the leaves
    the model axis does not split then hold partial gradients, which
    `finish` sums over 'model'; without it only the leaves in `partial`
    do (those the forward reads inside a parallel region, as the MoE
    router, whose gates weight each rank's partial expert outputs, or
    mamba2's per-head leaves, each rank reading its heads' entries)."""

    def __init__(self, mesh, specs, *, reduce: str = "scatter",
                 axes: tuple[str, ...] | None = None,
                 seq_parallel: bool = False, partial: tuple[str, ...] = ()):
        if reduce not in ("scatter", "all"):
            raise ValueError(f"unknown reduce {reduce!r}; expected "
                             "'scatter' or 'all'")
        self.mesh = mesh
        self.reduce = reduce
        self.specs = _flat_specs(specs)
        self.dims = {p: shard_dims(s, mesh) for p, s in self.specs.items()}
        self.model_dim = {p: next((d for d in ds if _is_model(
            self.specs[p][d])), None) for p, ds in self.dims.items()}
        self.data_dim = {p: next((d for d in ds if not _is_model(
            self.specs[p][d])), None) for p, ds in self.dims.items()}
        # the ranks whose gradients are averaged: every data axis, or the
        # data ranks within a pod (`axes=("data",)`)
        self.group = mesh.group(data_axes(mesh) if axes is None else axes)
        self.size = self.group.size
        self.model = (mesh.group("model") if "model" in mesh.axis_names
                      and mesh.shape["model"] > 1 else None)
        self.sum_model = {p: self.model is not None and self.model_dim[p]
                          is None and (seq_parallel or p in partial)
                          for p in self.specs}
        for p, d in self.data_dim.items():
            if d is not None and not set(_axes(self.specs[p][d])) <= set(
                    self.group.axes):
                raise ValueError(f"{p} is split over {self.specs[p][d]}, "
                                 f"outside the gradient's axes "
                                 f"{self.group.axes}")
        # reduce='all': each leaf's gradient reduced over the data axes,
        # the rank's model block of it
        self._sum: dict[str, torch.Tensor] = {}

    def rest(self, group):
        """The group of the gradient's axes that a leaf's `group` leaves
        out (the ranks holding the same block of a leaf split over fewer
        axes, as ('pod',) where ('pod', 'data') does not divide its dim),
        or None."""
        axes = tuple(a for a in self.group.axes if a not in group.axes)
        return self.mesh.group(axes) if axes else None

    def __call__(self, path: str, leaf: torch.Tensor,
                 index: int | None = None, *, whole: bool = False,
                 partial: bool = True) -> torch.Tensor:
        """Layer `index` of the leaf at `path` (the leaf itself when None)
        gathered over its data dim: the rank's model block. `whole=True`
        gathers its model dim too; `partial` says whether the model
        ranks' gradients of it are partial sums (else alike)."""
        x = leaf if index is None else leaf[index]
        steps = []
        full = list(leaf.shape)     # the sink's: whole over the data axes
        for d, tag in ((self.data_dim[path], "param_gather"),
                       (self.model_dim[path] if whole else None,
                        "model_gather" if partial else "model_whole")):
            if d is None:
                continue
            if index is not None and d == 0:
                raise ValueError(f"{path}: a stacked leaf split along its "
                                 "layer dim cannot be read a layer at a "
                                 "time")
            group = mesh_group(self.mesh, self.specs[path][d])
            if tag == "param_gather":
                full[d] *= group.size
            steps.append((group, d if index is None else d - 1, tag))
        if not steps and (self.reduce == "scatter" or not self.dims[path]):
            return x
        # reduce='all': every read of a split leaf keeps its gradient
        return _Gather.apply(x, self, path, tuple(steps), index, tuple(full))

    def _reduce(self, flat, idx, group, tag, divide: bool):
        """All-reduce the leaves `idx` of `flat` over `group` in one call
        (divided by the data size when `divide`)."""
        if not idx:
            return
        cat = torch.cat([flat[i].reshape(-1) for i in idx])
        cat = shard.all_reduce(cat, group, tag=tag)
        if divide:
            cat = cat / self.size
        for i, t in zip(idx, cat.split([flat[i].numel() for i in idx])):
            flat[i] = t.view_as(flat[i])

    def finish(self, grads):
        """The step's gradient tree from autograd's (blocks of the
        sharded leaves, each rank's own gradient of the replicated ones):
        the data-replicated leaves' mean over the data ranks (tag
        `grad_replicated`), under sequence parallelism the model-replicated
        leaves' sum over 'model' (tag `grad_model`; one all_reduce over
        both for a leaf neither splits). With reduce='all' the sharded
        leaves come back whole: the mean the backward kept, a model block
        of it all-gathered over 'model'."""
        flat, treedef = tree_flatten(grads)
        paths = list(self.specs)
        blocks = []     # reduce='all': the model-split leaves, still blocks
        if self.reduce == "all":
            for i, p in enumerate(paths):
                if p in self._sum:
                    flat[i] = self._sum.pop(p)
                if self.model_dim[p] is not None:
                    blocks.append(i)
        rep_data = [i for i, p in enumerate(paths)
                    if self.data_dim[p] is None and self.size > 1]
        rep_model = [i for i, p in enumerate(paths) if self.sum_model[p]]
        both = sorted(set(rep_data) & set(rep_model))
        if both:
            self._reduce(flat, both, self.mesh.group(
                self.group.axes + ("model",)), "grad_replicated", True)
        self._reduce(flat, [i for i in rep_data if i not in both],
                     self.group, "grad_replicated", True)
        self._reduce(flat, [i for i in rep_model if i not in both],
                     self.model, "grad_model", False)
        for i in blocks:
            flat[i] = self._gather_model(paths[i], flat[i])
        return tree_unflatten(treedef, flat)

    def _gather_model(self, path, g):
        return shard.all_gather_dim(g, self.model, self.model_dim[path],
                                    tag="grad_model_gather")

    def blocks(self, tree):
        """This rank's block (a view) of every leaf of a whole tree."""
        return _map_flat(lambda x, s: block(x, s, self.mesh), tree,
                         self.specs)

    def ranges(self, shapes) -> list:
        """For each leaf of a tree of whole leaves (tensors or meta
        tensors), in `tree_flatten` order: `(dim, lo, hi)`, this rank's
        range of the leaf's split dim, `(dim, lo, hi, dim_b, lo_b, hi_b)`
        for a leaf split on two dims, or None for a leaf it holds whole
        (`adamw.update_sketched(blocks=)`)."""
        out = []
        for (p, spec), leaf in zip(self.specs.items(),
                                   tree_flatten(shapes)[0]):
            sl = block_slices(tuple(leaf.shape), spec, self.mesh)
            rng = ()
            for d in self.dims[p]:
                rng += (d, sl[d].start, sl[d].stop)
            out.append(rng or None)
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The l2 norm of the whole gradient from the ranks' blocks: the
        sharded leaves' squares summed over the gradient's ranks (one
        all_reduce of a scalar, tag `grad_norm`), a block that several
        ranks hold counted once, each replicated leaf once."""
        flat, _ = tree_flatten(grads)
        zero = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        sharded, rep = zero, zero
        group = (self.mesh.group(self.group.axes + ("model",))
                 if self.model is not None else self.group)
        for g, p in zip(flat, self.specs):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            if not self.dims[p]:
                rep = rep + sq
                continue
            split = 1
            for d in self.dims[p]:
                split *= mesh_group(self.mesh, self.specs[p][d]).size
            # a block that several ranks hold is counted once
            sharded = sharded + sq / (group.size // split)
        total = shard.all_reduce(sharded.reshape(1), group,
                                 tag="grad_norm")[0]
        return torch.sqrt(total + rep)


def mesh_group(mesh, entry):
    """The `AxisGroup` of a spec entry's axes."""
    return mesh.group(_axes(entry))


__all__ = ["Sharded", "block", "block_slices", "gather_tree", "mesh_group",
           "shard_dim", "shard_dims", "shard_tree", "unshard_tree"]
