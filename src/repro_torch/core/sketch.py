"""Pytree sketching: tensorized RP over flat parameter/gradient buckets.

Port of `repro/core/sketch.py`. Big flat vectors (gradients, parameter
deltas) are bucketed, each bucket is tensorized into an order-N tensor
(`dims`, any length; the mode-sweep kernels cover orders 2..8) and
projected with a registered `repro_torch.rp` family. The operator is
sampled from a seed, so every process regenerates it locally and it never
crosses a wire.

Trees are nested dicts of tensors, flattened in sorted-key order
(`core.tree`), so each leaf's bucket offsets in the `(n_buckets, k)`
sketch agree with the reference leaf for leaf.

Used by:
  * optim/compress.py — error-feedback gradient compression, and the
                        cross-pod compressed all-reduce,
  * optim/adamw.py    — the fused unsketch+EF+AdamW step (K4),
  * SketchMonitor     — O(k) per-step parameter-drift telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .formats import STRUCT_TYPES, BatchedCPTensor, BatchedTTTensor, _prod
from .tree import tree_flatten, tree_leaves, tree_unflatten


def _is_struct_leaf(x) -> bool:
    """Leaves the sketcher treats as already-compressed inputs: they are
    projected in the compressed domain (the carry-sweep route) rather than
    bucketized — their dims must equal SketchConfig.dims."""
    return isinstance(x, STRUCT_TYPES)


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    family: str = "tt"         # any registered repro_torch.rp family
    k: int = 1024              # sketch size per bucket
    rank: int = 2              # R of the tensorized map
    bucket_elems: int = 128 * 128 * 64  # elements per bucket (1,048,576)
    dims: tuple[int, ...] = (128, 128, 64)
    fresh_per_step: bool = True  # re-draw operator each step (EF-friendly)
    backend: str = "auto"      # repro_torch.rp backend policy

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if _prod(self.dims) != self.bucket_elems:
            raise ValueError(
                f"prod(dims) = {_prod(self.dims)} for dims={self.dims} does "
                f"not equal bucket_elems={self.bucket_elems}; pass "
                f"bucket_elems={_prod(self.dims)} or retensorize dims to "
                "cover the bucket")
        from repro_torch import rp  # function-level: core <-> rp cycle
        rp.get_family(self.family)  # fail fast on unknown families

    def spec(self):
        from repro_torch import rp
        return rp.ProjectorSpec(family=self.family, k=self.k, dims=self.dims,
                                rank=self.rank, backend=self.backend)

    def shrinkage(self) -> float:
        """MMSE damping for the adjoint roundtrip x_hat = alpha * A^T A x.

        E||A^T A x||^2 ~= ||x||^2 (1 + c*D/k) with c the paper's Thm-1
        variance factor, so alpha* = 1/(1 + c*D/k). Without it the
        roundtrip is an EXPANSION for D > k/c and error feedback diverges.
        """
        from . import theory
        c = theory.variance_factor(self.family, N=len(self.dims),
                                   R=self.rank, D=self.bucket_elems)
        return 1.0 / (1.0 + c * self.bucket_elems / self.k)

    def operator(self, seed: int, device=None):
        """The operator drawn from `seed` on `device` (None: CUDA)."""
        from repro_torch import rp
        return rp.make_projector(self.spec(), seed, device=device)

    def operator_params(self) -> int:
        from . import theory
        try:
            return theory.params_rp(self.family, self.k, self.dims,
                                    self.rank)
        except KeyError:
            # externally registered family: count a sampled instance
            return self.operator(0, device="cpu").num_params()


def _device(tree) -> torch.device:
    for leaf in tree_leaves(tree):
        dev = getattr(leaf, "device", None)
        if dev is not None:
            return torch.device(dev)
    raise ValueError("a tree to sketch needs at least one tensor leaf")


class PytreeSketcher:
    """Sketches a fixed-structure tree bucket-wise, PER LEAF.

    Leaves may be dense tensors (bucketized and tensorized to `cfg.dims`)
    OR `TTTensor` / `CPTensor` / `BatchedTTTensor` / `BatchedCPTensor`
    containers with dims == `cfg.dims`: structured leaves are sketched in
    the compressed domain (the carry-sweep kernel) and reconstruct to
    dense unbiased estimates.

    The same operator is shared across buckets and leaves (disjoint
    coordinates keep per-bucket estimates unbiased; sharing keeps operator
    memory O(kNdR^2) regardless of model size).

    Mesh: with `mesh` (a `launch.mesh.Mesh`) and optionally `bucket_spec`
    (entry 0 names the axes of the bucket dim; default `bucket_pspec` a
    leaf), each rank projects and unsketches its block of a leaf's
    buckets and one all_gather a leaf puts the blocks back together, so
    `sketch` and `unsketch` return what they return without a mesh. A
    leaf whose bucket count the axes do not divide runs whole on every
    rank. `constrain=False` splits nothing, mesh or not (the reference's
    switch for a `shard_map` body: the pod collective, whose ranks hold
    different pods' trees).
    """

    def __init__(self, cfg: SketchConfig, example_tree: Any, *,
                 mesh=None, bucket_spec=None, constrain: bool = True):
        self.cfg = cfg
        self.mesh = mesh
        self.bucket_spec = bucket_spec
        self.constrain = constrain
        leaves, treedef = tree_flatten(example_tree)
        self._treedef = treedef
        self._struct = [_is_struct_leaf(x) for x in leaves]
        self._shapes, self._sizes, self._dtypes, self._nb = [], [], [], []
        for leaf, is_struct in zip(leaves, self._struct):
            if is_struct:
                if tuple(leaf.dims) != tuple(cfg.dims):
                    raise ValueError(
                        f"structured leaf dims {tuple(leaf.dims)} != "
                        f"SketchConfig.dims {tuple(cfg.dims)}; tensorize "
                        "structured leaves to the sketch dims up front")
                nb = leaf.batch if isinstance(
                    leaf, (BatchedTTTensor, BatchedCPTensor)) else 1
                self._shapes.append(((nb,) if nb > 1 else ()) + tuple(cfg.dims))
                self._sizes.append(nb * cfg.bucket_elems)
                self._dtypes.append(leaf.dtype)
                self._nb.append(nb)
            else:
                self._shapes.append(tuple(leaf.shape))
                self._sizes.append(int(_prod(leaf.shape)))
                self._dtypes.append(leaf.dtype)
                self._nb.append(
                    max(1, -(-self._sizes[-1] // cfg.bucket_elems)))
        self.n = sum(self._sizes)
        self.n_buckets = sum(self._nb)

    # -- bucket-axis split over the mesh -----------------------------------
    def _leaf_spec(self, nb: int):
        """The spec that splits a batch of `nb` buckets over the mesh, or
        None: no mesh, `constrain=False`, or axes that do not divide nb."""
        if self.mesh is None or not self.constrain:
            return None
        from repro_torch.rp.shard import bucket_pspec, shard_entry
        spec = (self.bucket_spec if self.bucket_spec is not None
                else bucket_pspec(self.mesh, nb))
        _, _, size = shard_entry(self.mesh, spec)
        return spec if size > 1 and nb % size == 0 else None

    def _project(self, op, buckets):
        from repro_torch import rp
        from repro_torch.rp import shard
        spec = self._leaf_spec(buckets.shape[0])
        if spec is None:
            return rp.project(op, buckets, backend=self.cfg.backend)
        block = shard.project_sharded(op, buckets, mesh=self.mesh, spec=spec,
                                      backend=self.cfg.backend)
        return shard.gather_blocks(block, self.mesh, spec, tag="sketch")

    def _reconstruct(self, op, y):
        from repro_torch import rp
        from repro_torch.rp import shard
        spec = self._leaf_spec(y.shape[0])
        if spec is None:
            return rp.reconstruct(op, y, backend=self.cfg.backend)
        block = shard.reconstruct_sharded(op, y, mesh=self.mesh, spec=spec,
                                          backend=self.cfg.backend)
        return shard.gather_blocks(block, self.mesh, spec, tag="unsketch")

    # -- per-leaf shaping -------------------------------------------------
    def _leaf_to_buckets(self, leaf, nb: int, rows: int = 1) -> torch.Tensor:
        """`(rows * nb, *dims)` float32 buckets of `leaf`, read as `rows`
        rows, each bucketized on its own and zero-padded at its end. A
        contiguous float32 leaf that fills its buckets exactly comes back
        as a view, without a copy."""
        flat = leaf.reshape(rows, -1).to(torch.float32)
        pad = nb * self.cfg.bucket_elems - flat.shape[1]
        if pad:
            flat = torch.cat([flat, flat.new_zeros(rows, pad)], dim=1)
        return flat.reshape((rows * nb,) + self.cfg.dims)

    @staticmethod
    def _leaf_from_buckets(buckets, size: int, shape, dtype, npod=None):
        lead = () if npod is None else (npod,)
        out = buckets.reshape(npod or 1, -1)[:, :size]
        return out.reshape(lead + tuple(shape)).to(dtype)

    # -- sketch / unsketch -----------------------------------------------
    def sketch(self, tree: Any, seed: int, *, npod: int | None = None,
               project_fn=None) -> torch.Tensor:
        """tree -> (n_buckets, k) sketch (buckets concatenated over leaves).

        All buckets of a leaf go through ONE batched `rp.project` call (one
        K1 launch on the card; on a mesh, one a rank on its block, then
        one all_gather); a structured leaf is projected in the compressed
        domain, a batched container counting one bucket per item — still
        one dispatch per leaf. With `npod`, every leaf is dense and
        carries a leading pod dim of that size (`compress_per_pod`): each
        pod's row is bucketized on its own, the pods are folded into the
        leaf's bucket batch (still one dispatch a leaf), and the result is
        `(npod, n_buckets, k)`. `project_fn(op, buckets) -> (nb, k)`
        overrides the dense buckets' projection (`rp.sketch_tree_sharded`
        passes its split one); structured leaves keep theirs.
        """
        from repro_torch import rp
        if npod is not None and any(self._struct):
            raise ValueError("a sketch with a pod dim takes dense leaves "
                             "only")
        op = self.cfg.operator(seed, _device(tree))
        rows = 1 if npod is None else npod
        flat_op = len(op.in_dims) == 1  # gaussian/sparse contract flat
        ys = []
        for leaf, nb, is_struct in zip(tree_leaves(tree), self._nb,
                                       self._struct):
            if is_struct:
                y = rp.project(op, leaf, backend=self.cfg.backend)
            else:
                x = self._leaf_to_buckets(leaf, nb, rows)
                if flat_op:
                    x = x.reshape(rows * nb, -1)
                y = (self._project if project_fn is None else project_fn)(
                    op, x)
            ys.append(y.reshape(rows, nb, self.cfg.k))
        y = torch.cat(ys, dim=1)
        return y[0] if npod is None else y

    def unsketch(self, y: torch.Tensor, seed: int) -> Any:
        """(n_buckets, k) -> unbiased tree estimate (same seed as sketch).

        One batched `rp.reconstruct` per leaf (one K2 launch on the card;
        on a mesh, one a rank on its block, then one all_gather of the
        dense blocks). Structured leaves come back as DENSE estimates
        (`(*dims)`, or `(B, *dims)` for a batched container). A
        `(npod, n_buckets, k)` sketch (`sketch(npod=)`) comes back as
        leaves `(npod, *shape)`, every pod in the leaf's one dispatch.
        """
        return tree_unflatten(self._treedef,
                              list(self.iter_unsketch(y, seed)))

    def iter_unsketch(self, y: torch.Tensor, seed: int):
        """`unsketch` a leaf at a time: a generator of the leaves'
        estimates in `tree_flatten` order, so a caller can use each and
        let it go before the next is made."""
        op = self.cfg.operator(seed, y.device)
        npod = int(y.shape[0]) if y.ndim == 3 else None
        rows = npod or 1
        y = y.reshape(rows, self.n_buckets, self.cfg.k)
        off = 0
        for nb, size, shape, dtype in zip(self._nb, self._sizes,
                                          self._shapes, self._dtypes):
            buckets = self._reconstruct(
                op, y[:, off:off + nb].reshape(rows * nb, self.cfg.k))
            yield self._leaf_from_buckets(buckets, size, shape, dtype, npod)
            off += nb

    def roundtrip(self, tree: Any, seed: int) -> tuple[Any, torch.Tensor]:
        """Returns (reconstruction, sketch)."""
        y = self.sketch(tree, seed)
        return self.unsketch(y, seed), y

    # -- accounting -------------------------------------------------------
    def sketch_bytes(self) -> int:
        return self.n_buckets * self.cfg.k * 4

    def dense_bytes(self) -> int:
        return self.n * 4

    def compression_ratio(self) -> float:
        return self.dense_bytes() / max(1, self.sketch_bytes())


# ---------------------------------------------------------------------------
# Sketch-based telemetry: parameter drift / norms at O(k) cost.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SketchMonitor:
    """Tracks ||theta_t - theta_{t-1}|| and ||theta_t|| through a fixed
    sketch (`seed`); by the JL property the sketch-space norms are
    (1±eps)-faithful, and the state is n_buckets*k floats."""

    sketcher: PytreeSketcher
    seed: int
    prev: torch.Tensor | None = None

    def update(self, tree: Any) -> dict[str, torch.Tensor]:
        y = self.sketcher.sketch(tree, self.seed)
        norm = torch.sqrt(torch.sum(y * y))
        if self.prev is None:
            drift = torch.zeros((), dtype=y.dtype, device=y.device)
        else:
            d = y - self.prev
            drift = torch.sqrt(torch.sum(d * d))
        self.prev = y
        return {"sketch_norm": norm, "sketch_drift": drift}


__all__ = ["PytreeSketcher", "SketchConfig", "SketchMonitor"]
