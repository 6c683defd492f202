"""Mesh-aware sketching over the bucket axis, and the port's collectives.

Port of `repro/rp/shard.py`. The paper's systems claim is that the TT/CP
operator is O(kNdR^2) floats, so every rank draws it again from a seed
and only sketches cross the network. Here a rank of a `launch.mesh.Mesh`
owns one contiguous block of a `(n_buckets, ...)` bucket array along the
spec's axes, the block layout of the reference's `shard_map`: rank i (row
major over the axes, in mesh order) owns buckets `[i*nb/size,
(i+1)*nb/size)`, and makes ONE `rp.project` / `rp.reconstruct` dispatch
on it. The reference returns a global array sharded over the mesh; the
port returns the rank's block (`gather_blocks` puts the blocks back
together where a caller needs the whole array).

A bucket spec is a tuple whose entry 0 is None, an axis name or a tuple
of names (`bucket_pspec`, `shard_entry`). A spec that shards over nothing
(or a bucket count the axes do not divide, in the whole-tree entry point)
takes the plain dispatch.

Each rank of a pod mesh holds its own pod's error-feedback row, without
a pod dim. A checkpoint holds the reference's `(npod, ...)` layout:
`gather_pod_rows` stacks the rows on the pod group's first rank, and
`scatter_pod_rows` hands each rank its row of a restored stack.

Every collective of the port goes through the wrappers at the end of
this module (`all_reduce`, `all_gather`, `all_gather_dim`,
`reduce_scatter`, `gather`). Each records its call, op,
dtype, axes, a tag naming its purpose and its payload bytes (the
tensor this rank contributes) in the process's `CollectiveLedger`, which
tests and `chip_smoke.py` read: the port's counterpart of the reference's
HLO inspection. Gloo has no AVG, so a mean is a SUM, then a division by
the group's size, on every backend alike.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten

from .dispatch import project, reconstruct


def _axes_tuple(entry) -> tuple[str, ...]:
    """Normalize a spec entry to a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def shard_entry(mesh, spec) -> tuple:
    """(dim-0 spec entry, axes tuple, total shard size) for a bucket spec:
    the one place the `(n_buckets, ...)` spec convention is decoded."""
    entry = spec[0] if len(spec) else None
    axes = _axes_tuple(entry)
    return entry, axes, _axes_size(mesh, axes)


def bucket_pspec(mesh, n_buckets: int, *, axes=None, exclude=()) -> tuple:
    """Spec for a `(n_buckets, ...)` bucket array on `mesh`: the largest
    prefix of `axes` (default: every mesh axis not in `exclude`) whose
    total size divides `n_buckets`, as `(prefix,)`; `(None,)` when nothing
    divides."""
    cand = tuple(a for a in (axes if axes is not None else mesh.axis_names)
                 if a not in exclude)
    for cut in range(len(cand), 0, -1):
        sub = cand[:cut]
        if n_buckets % _axes_size(mesh, sub) == 0:
            return (sub,)
    return (None,)


def _block(mesh, spec, n: int, what: str):
    """(AxisGroup, lo, hi) of this rank's block of n buckets, or None
    when the spec shards over nothing."""
    _, axes, size = shard_entry(mesh, spec)
    if size <= 1:
        return None
    if n % size:
        raise ValueError(
            f"{what} count {n} is not divisible by mesh axes {axes} (size "
            f"{size}); pass a spec that divides it (bucket_pspec picks the "
            "largest valid prefix)")
    grp = mesh.group(axes)
    per = n // size
    return grp, grp.index * per, (grp.index + 1) * per


def project_sharded(op, x, *, mesh, spec=None, backend: str = "auto"):
    """`rp.project` on this rank's block of the bucket axis.

    x: `(n_buckets, *op.in_dims)` (or `(n_buckets, D)` for flat families),
    the same on every rank. Returns this rank's `(n_buckets / size, k)`
    block of the sketch, from ONE dispatch; the whole `(n_buckets, k)`
    sketch when the spec shards over nothing.
    """
    x = torch.as_tensor(x)
    if spec is None:
        spec = bucket_pspec(mesh, x.shape[0])
    blk = _block(mesh, spec, x.shape[0], "bucket")
    if blk is None:
        return project(op, x, backend=backend)
    _, lo, hi = blk
    return project(op, x[lo:hi], backend=backend)


def reconstruct_sharded(op, y, *, mesh, spec=None, backend: str = "auto"):
    """Adjoint of `project_sharded`: this rank's block of `(n_buckets, k)`
    -> its `(n_buckets / size, *dims)` block, one `rp.reconstruct`."""
    y = torch.as_tensor(y)
    if spec is None:
        spec = bucket_pspec(mesh, y.shape[0])
    blk = _block(mesh, spec, y.shape[0], "bucket")
    if blk is None:
        return reconstruct(op, y, backend=backend)
    _, lo, hi = blk
    return reconstruct(op, y[lo:hi], backend=backend)


def gather_blocks(block, mesh, spec, *, tag: str = "gather"):
    """Every rank's block along the spec's axes, concatenated in block
    order (one all_gather): the inverse of taking this rank's block."""
    _, axes, size = shard_entry(mesh, spec)
    if size <= 1:
        return block
    return all_gather(block, mesh.group(axes), tag=tag)


def sketch_tree_sharded(cfg, tree, seed, *, mesh, spec=None, sketcher=None):
    """Whole-tree sketch with each leaf's bucket axis split over `mesh`.

    Buckets are built per leaf as `PytreeSketcher` builds them (by
    `sketcher`, a sketcher of the tree's structure, when given), each
    rank projects its block of every leaf whose bucket count the spec's
    axes divide (the others whole), and each leaf's blocks are gathered
    back: returns the canonical `(n_buckets, k)` sketch on every rank,
    what `PytreeSketcher.sketch` returns under the same seed.
    """
    from repro_torch.core.sketch import PytreeSketcher
    sk = sketcher if sketcher is not None else PytreeSketcher(
        cfg, tree, mesh=mesh, bucket_spec=spec)

    def project_fn(op, buckets):
        nb = buckets.shape[0]
        leaf_spec = spec if spec is not None else bucket_pspec(mesh, nb)
        _, _, size = shard_entry(mesh, leaf_spec)
        if size > 1 and nb % size == 0:
            return gather_blocks(project_sharded(
                op, buckets, mesh=mesh, spec=leaf_spec,
                backend=sk.cfg.backend), mesh, leaf_spec, tag="sketch")
        return project(op, buckets, backend=sk.cfg.backend)

    return sk.sketch(tree, seed, project_fn=project_fn)


# ---------------------------------------------------------------------------
# pod rows: the (npod, ...) checkpoint layout of per-pod state
# ---------------------------------------------------------------------------

# (pod group axes, structure digest) pairs the pod group already agreed on
_AGREED: set = set()


def _agree_one_tree(tree, group, what: str) -> None:
    """On the first call with a tree structure, all-gather a digest of its
    (shape, dtype)s over `group` and refuse a mismatch: gloo hangs on a
    collective over tensors of different sizes. A fake process group (the
    dry run) has no peer to agree with: the check is skipped there."""
    if group.mesh.backend == "fake":
        return
    desc = repr([(tuple(x.shape), str(x.dtype))
                 for x in tree_leaves(tree)]).encode()
    digest = int.from_bytes(hashlib.blake2b(desc, digest_size=7).digest(),
                            "little")
    if (group.axes, digest) in _AGREED:
        return
    mine = torch.tensor([digest], dtype=torch.int64,
                        device=tree_leaves(tree)[0].device)
    every = all_gather(mine, group, tag="digest").tolist()
    if len(set(every)) != 1:
        raise ValueError(
            f"{what} needs one tree per pod, the same leaf shapes and dtypes "
            f"on every rank of {group.axes}; the ranks' digests differ: "
            f"{every} (this rank's tree: {desc.decode()[:300]})")
    _AGREED.add((group.axes, digest))


def gather_pod_rows(tree, mesh):
    """Every rank's tree (its pod's row, no pod dim) stacked into the
    reference's `(npod, ...)` layout, in mesh order over the 'pod' axis,
    on the pod group's first rank (one gather a leaf). Returns the
    stacked tree there and None on the other ranks."""
    group = mesh.group("pod")
    _agree_one_tree(tree, group, "gather_pod_rows")
    leaves, treedef = tree_flatten(tree)
    out = [gather(leaf, group, tag="pod_rows") for leaf in leaves]
    return tree_unflatten(treedef, out) if group.index == 0 else None


def scatter_pod_rows(tree, mesh):
    """This rank's row of a stacked `(npod, ...)` tree, for each leaf a
    copy of row `mesh.group('pod').index` (so the stack can be freed).
    Every rank holds the stack: each restores it from the same
    checkpoint directory (`ckpt.elastic.resume_pod_rank`), so no bytes
    cross ranks here."""
    group = mesh.group("pod")
    _agree_one_tree(tree, group, "scatter_pod_rows")
    leaves, treedef = tree_flatten(tree)
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != group.size:
            raise ValueError(
                f"scatter_pod_rows: a leaf of shape {tuple(leaf.shape)} has "
                f"no leading pod dim of the mesh's {group.size} pods")
    return tree_unflatten(treedef, [leaf[group.index].clone()
                                    for leaf in leaves])


# ---------------------------------------------------------------------------
# int8 wire quantization for collective sketch syncs
# ---------------------------------------------------------------------------

def quantize_for_psum(y, group, npod: int, *, per_row: bool = True,
                      tag: str = "scale"):
    """Scaled-int8 quantization safe to SUM over `group` (an `AxisGroup`).

    Returns `(q, s)`, q int8 and s a float32 scale, with q = round(y / s)
    clipped to [-qmax, qmax], qmax = 127 // npod: the sum of npod such
    values stays within 127, so the int8 reduction cannot wrap in any
    order. The scale is shared over the group (a MAX all_reduce of the
    local absmax), so every rank quantizes onto one grid and
    `dequantize_psum(sum(q), s, npod)` is the mean of the quantized
    values, the same bits on every rank. `per_row=True` scales each
    leading-axis row by its own absmax (one per bucket row of a sketch);
    `per_row=False` one scalar for the array. `torch.round` is
    half-to-even, like `jnp.round`.
    """
    if npod > 127:
        raise ValueError(
            f"int8 wire quantization supports at most 127 pods (qmax = "
            f"127 // npod would be 0), got npod={npod}")
    qmax = 127 // npod
    if per_row:
        a = y.abs().amax(dim=tuple(range(1, y.ndim)), keepdim=True)
    else:
        a = y.abs().max().reshape(1)
    a = all_reduce(a.to(torch.float32), group, op="max", tag=tag)
    if not per_row:
        a = a.reshape(())
    s = torch.clamp_min(a, torch.finfo(torch.float32).tiny) / qmax
    q = torch.clamp(torch.round(y / s), -qmax, qmax).to(torch.int8)
    return q, s


def dequantize_psum(q_sum, s, npod: int):
    """Mean-dequantize an int8 SUM: q_sum * s / npod."""
    return q_sum.to(torch.float32) * s / npod


# ---------------------------------------------------------------------------
# the collectives, and the ledger they record in
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveLedger:
    """Per-process record of the port's collectives.

    rows: (tag, op, reduce op, dtype, axes) -> [calls, payload bytes,
    host seconds], the bytes being the tensor this rank contributes to
    each call and the seconds the host spent inside the call (under gloo
    a CUDA tensor is first waited for, so this includes the device work
    queued before the call).
    """

    rows: dict = dataclasses.field(default_factory=dict)

    def record(self, tag, op, reduce, dtype, axes, nbytes,
               seconds: float = 0.0) -> None:
        key = (tag, op, reduce, str(dtype).removeprefix("torch."),
               tuple(axes))
        row = self.rows.setdefault(key, [0, 0, 0.0])
        row[0] += 1
        row[1] += int(nbytes)
        row[2] += seconds

    def _match(self, tag, op, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        for key, row in self.rows.items():
            if ((tag is None or key[0] == tag) and (op is None or key[1] == op)
                    and (axes is None or key[4] == tuple(axes))):
                yield row

    def calls(self, *, tag=None, op=None, axes=None) -> int:
        return sum(r[0] for r in self._match(tag, op, axes))

    def bytes(self, *, tag=None, op=None, axes=None) -> int:
        return sum(r[1] for r in self._match(tag, op, axes))

    def seconds(self, *, tag=None, op=None, axes=None) -> float:
        return sum(r[2] for r in self._match(tag, op, axes))

    def table(self) -> list[dict]:
        """The rows as sorted JSON-able dicts."""
        return [{"tag": t, "op": o, "reduce": r or "", "dtype": d,
                 "axes": list(a), "calls": c, "bytes": b, "host_s": h}
                for (t, o, r, d, a), (c, b, h) in sorted(
                    self.rows.items(), key=lambda kv: str(kv[0]))]

    def reset(self) -> None:
        self.rows.clear()


_LEDGER = CollectiveLedger()


def collective_ledger() -> CollectiveLedger:
    """This process's `CollectiveLedger`."""
    return _LEDGER


_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x, group, *, op: str = "sum", tag: str = "collective"):
    """A new tensor: `x` reduced over `group` (an `AxisGroup`) by `op`
    ('sum' | 'max'). `x` is left as it is. Gloo takes CUDA tensors for
    every collective here (torch 2.11 on the H100), so nothing is staged
    through host memory by hand."""
    if op not in _REDUCE:
        raise ValueError(f"unknown reduce op {op!r}; expected 'sum' or "
                         "'max' (a mean is a sum over the group's size)")
    out = x.detach().clone(memory_format=torch.contiguous_format)
    t0 = time.perf_counter()
    dist.all_reduce(out, op=_REDUCE[op], group=group.pg)
    _LEDGER.record(tag, "all_reduce", op, x.dtype, group.axes,
                   x.numel() * x.element_size(), time.perf_counter() - t0)
    return out


def all_gather(x, group, *, tag: str = "collective"):
    """Every rank's `x` (one shape on all), concatenated along dim 0 in
    the group's rank order (a 0-d `x` stacks)."""
    src = x.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(group.size)]
    t0 = time.perf_counter()
    dist.all_gather(out, src, group=group.pg)
    _LEDGER.record(tag, "all_gather", None, x.dtype, group.axes,
                   x.numel() * x.element_size(), time.perf_counter() - t0)
    return torch.cat(out, dim=0) if src.ndim else torch.stack(out)


def all_gather_dim(x, group, dim: int, *, tag: str = "collective"):
    """Every rank's `x` (one shape on all), concatenated along `dim` in
    the group's rank order: a data mesh's blocks put back together."""
    src = x.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(group.size)]
    t0 = time.perf_counter()
    dist.all_gather(out, src, group=group.pg)
    _LEDGER.record(tag, "all_gather", None, x.dtype, group.axes,
                   x.numel() * x.element_size(), time.perf_counter() - t0)
    return torch.cat(out, dim=dim)


def reduce_scatter(x, group, dim: int, *, tag: str = "collective"):
    """This rank's block along `dim` of `x` summed over `group`: the
    group's i-th rank gets the i-th of `group.size` equal blocks. One
    reduce_scatter, which gloo takes on CPU and CUDA tensors alike (torch
    2.11 on the H100) and NCCL on CUDA; the payload recorded is the whole
    `x`, which this rank contributes."""
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {n} blocks over {group.axes}")
    parts = [c.contiguous() for c in x.detach().chunk(n, dim)]
    out = torch.empty_like(parts[0])
    t0 = time.perf_counter()
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group.pg)
    _LEDGER.record(tag, "reduce_scatter", "sum", x.dtype, group.axes,
                   x.numel() * x.element_size(), time.perf_counter() - t0)
    return out


def gather(x, group, *, tag: str = "collective"):
    """Every rank's `x` (one shape on all) stacked along a new dim 0 in
    the group's rank order on the group's first rank, which gets the
    stack; the other ranks get None."""
    src = x.detach().contiguous()
    first = dist.get_process_group_ranks(group.pg)[0]
    out = (torch.empty((group.size,) + tuple(src.shape), dtype=src.dtype,
                       device=src.device) if group.index == 0 else None)
    t0 = time.perf_counter()
    dist.gather(src, list(out.unbind(0)) if out is not None else None,
                dst=first, group=group.pg)
    _LEDGER.record(tag, "gather", None, x.dtype, group.axes,
                   x.numel() * x.element_size(), time.perf_counter() - t0)
    return out


__all__ = ["CollectiveLedger", "all_gather", "all_gather_dim",
           "all_reduce", "bucket_pspec", "collective_ledger",
           "dequantize_psum", "gather", "gather_blocks", "gather_pod_rows",
           "project_sharded", "quantize_for_psum", "reconstruct_sharded",
           "reduce_scatter", "scatter_pod_rows", "shard_entry",
           "sketch_tree_sharded"]
