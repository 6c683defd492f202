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
  * optim/compress.py — error-feedback gradient compression,
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
    memory O(kNdR^2) regardless of model size). The mesh and bucket-layout
    options of the reference wait for the collective (ROADMAP queue 1
    item 11).
    """

    def __init__(self, cfg: SketchConfig, example_tree: Any):
        self.cfg = cfg
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

    # -- per-leaf shaping -------------------------------------------------
    def _leaf_to_buckets(self, leaf, nb: int) -> torch.Tensor:
        """(nb, *dims) float32 buckets of `leaf`, zero-padded at the end.
        A contiguous float32 leaf that fills its buckets exactly comes
        back as a view, without a copy."""
        flat = leaf.reshape(-1).to(torch.float32)
        pad = nb * self.cfg.bucket_elems - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.reshape((nb,) + self.cfg.dims)

    def _leaf_from_buckets(self, buckets, size: int, shape, dtype):
        return buckets.reshape(-1)[:size].reshape(shape).to(dtype)

    # -- sketch / unsketch -----------------------------------------------
    def sketch(self, tree: Any, seed: int) -> torch.Tensor:
        """tree -> (n_buckets, k) sketch (buckets concatenated over leaves).

        All buckets of a leaf go through ONE batched `rp.project` call (one
        K1 launch on the card); a structured leaf is projected in the
        compressed domain, a batched container counting one bucket per
        item — still one dispatch per leaf.
        """
        from repro_torch import rp
        op = self.cfg.operator(seed, _device(tree))
        flat_op = len(op.in_dims) == 1  # gaussian/sparse contract flat
        ys = []
        for leaf, nb, is_struct in zip(tree_leaves(tree), self._nb,
                                       self._struct):
            if is_struct:
                x = leaf
            else:
                x = self._leaf_to_buckets(leaf, nb)
                if flat_op:
                    x = x.reshape(nb, -1)
            y = rp.project(op, x, backend=self.cfg.backend)
            ys.append(y.reshape(nb, self.cfg.k))
        return torch.cat(ys, dim=0)

    def unsketch(self, y: torch.Tensor, seed: int) -> Any:
        """(n_buckets, k) -> unbiased tree estimate (same seed as sketch).

        One batched `rp.reconstruct` per leaf (one K2 launch on the card).
        Structured leaves come back as DENSE estimates (`(*dims)`, or
        `(B, *dims)` for a batched container).
        """
        from repro_torch import rp
        op = self.cfg.operator(seed, y.device)
        out = []
        off = 0
        for nb, size, shape, dtype in zip(self._nb, self._sizes,
                                          self._shapes, self._dtypes):
            buckets = rp.reconstruct(op, y[off:off + nb],
                                     backend=self.cfg.backend)
            out.append(self._leaf_from_buckets(buckets, size, shape, dtype))
            off += nb
        return tree_unflatten(self._treedef, out)

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
