"""Tensorized-RP gradient compression with error feedback.

Port of the single-process parts of `repro/optim/compress.py`. The
paper's maps f_TT(R) / f_CP(R) give an oblivious linear sketch whose
adjoint is an unbiased reconstruction, so they make a gradient
compressor:

  p     = g + e                 (error feedback)
  y     = Sketch_t(p)           (k floats per bucket)
  g_hat = alpha * Unsketch_t(y)
  e'    = p - g_hat             (local residual)

The operator of step t is regenerated from a seed (`_key(t)`), so it
never crosses the network. `compress` is the single-worker roundtrip
estimator; the cross-pod formulations (`compress_per_pod`,
`compress_collective`, the int8 wire) wait for the collective (ROADMAP
queue 1 item 11). `wire_bytes` reports the payload this estimator implies
per step: the float32 sketch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.formats import BatchedCPTensor, BatchedTTTensor
from repro_torch.core.sketch import (PytreeSketcher, SketchConfig,
                                     _is_struct_leaf)
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map


def _balanced_pow2_dims(elems: int, order: int) -> tuple[int, ...]:
    """Tensorize a power-of-two bucket into `order` balanced pow2 modes.

    Spreads the exponent as evenly as possible, larger modes first —
    order=3 over the default 2^20 bucket gives (128, 128, 64); order=4
    gives (32, 32, 32, 32).
    """
    if order < 1:
        raise ValueError(f"order must be a positive integer, got {order}")
    e = elems.bit_length() - 1
    if elems <= 0 or (1 << e) != elems:
        raise ValueError(
            f"order= without dims= needs a power-of-two bucket, got {elems}")
    base, extra = divmod(e, order)
    if base == 0:
        raise ValueError(f"order={order} is too high for a {elems}-element "
                         "bucket (a mode would collapse to 1)")
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(order))


_FLAG_KEYS = ("dims", "k", "rank", "order")


def parse_compress_flag(flag: str) -> SketchConfig:
    """'<family>:k=4096,rank=2[,dims=128x128x64][,order=4]' -> SketchConfig.

    `family` is a registered repro_torch.rp family ('tt', 'cp');
    SketchConfig validates it against the registry. `order=N` without
    `dims=` tensorizes the default bucket into N balanced power-of-two
    modes; with `dims=` it cross-checks len(dims) == N.

    Unknown or malformed keys raise `ValueError` naming the bad key and
    the accepted set.
    """
    family, _, rest = flag.partition(":")
    kw: dict[str, Any] = {"family": family}
    order: int | None = None
    if rest:
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            if not eq:
                raise ValueError(
                    f"malformed part {part!r} in compress flag {flag!r}: "
                    f"expected key=value with key in {_FLAG_KEYS}")
            if key not in _FLAG_KEYS:
                raise ValueError(
                    f"unknown key {key!r} in compress flag {flag!r}; "
                    f"accepted keys: {', '.join(_FLAG_KEYS)}")
            if key == "dims":
                dims = tuple(int(x) for x in val.split("x"))
                kw["dims"] = dims
                kw["bucket_elems"] = 1
                for d in dims:
                    kw["bucket_elems"] *= d
            elif key in ("k", "rank"):
                kw[key] = int(val)
            else:  # "order"
                order = int(val)
    if order is not None:
        if "dims" in kw:
            if len(kw["dims"]) != order:
                raise ValueError(
                    f"order={order} contradicts dims="
                    f"{'x'.join(map(str, kw['dims']))} (order "
                    f"{len(kw['dims'])})")
        else:
            elems = SketchConfig.__dataclass_fields__["bucket_elems"].default
            kw["dims"] = _balanced_pow2_dims(elems, order)
            kw["bucket_elems"] = elems
    return SketchConfig(**kw)


@dataclasses.dataclass
class SketchCompressor:
    cfg: SketchConfig
    base_key: int = 0x5EED
    # (structure-key, sketcher) memo: the tree structure is fixed across
    # steps, so the flatten and registry checks run once.
    _sk_cache: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @staticmethod
    def _leaf_memo_key(leaf):
        if _is_struct_leaf(leaf):
            nb = leaf.batch if isinstance(
                leaf, (BatchedTTTensor, BatchedCPTensor)) else 1
            return (type(leaf).__name__, tuple(leaf.dims), nb,
                    str(leaf.dtype))
        return (tuple(leaf.shape), str(leaf.dtype))

    def _sketcher(self, tree) -> PytreeSketcher:
        """Memoized PytreeSketcher for `tree`."""
        leaves, treedef = tree_flatten(tree)
        key = (treedef, tuple(self._leaf_memo_key(x) for x in leaves))
        if self._sk_cache is not None and self._sk_cache[0] == key:
            return self._sk_cache[1]
        sk = PytreeSketcher(self.cfg, tree)
        self._sk_cache = (key, sk)
        return sk

    def init_state(self, params) -> dict:
        return {"residual": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    def _key(self, step) -> int:
        """The operator seed of `step`: the same function of (base_key,
        step) on every call and every process. (The reference folds the
        step into a JAX PRNG key; torch cannot replay that stream, so the
        tests carry the reference's operators across.)"""
        if not self.cfg.fresh_per_step:
            return int(self.base_key)
        return int(self.base_key) * 1_000_003 + int(step)

    def compress(self, grads, state, *, step) -> tuple[Any, dict, dict]:
        """Single-worker roundtrip estimator (no comm): sketch -> unsketch
        with error feedback."""
        sk = self._sketcher(grads)
        seed = self._key(step)
        p = tree_map(lambda g, e: g.to(torch.float32) + e,
                     grads, state["residual"])
        alpha = self.cfg.shrinkage()
        y = sk.sketch(p, seed)                          # (buckets, k)
        g_hat = tree_map(lambda x: alpha * x, sk.unsketch(y, seed))
        new_residual = tree_map(lambda pp, gh: pp - gh.to(torch.float32),
                                p, g_hat)
        g_out = tree_map(lambda gh, g: gh.to(g.dtype), g_hat, grads)
        return g_out, {"residual": new_residual}, self._metrics(
            sk, new_residual)

    def wire_bytes(self, sk: PytreeSketcher) -> int:
        """Per-step payload a worker would send: the float32 (n_buckets, k)
        sketch (the operator is regenerated from its seed, never sent)."""
        return sk.sketch_bytes()

    def _metrics(self, sk: PytreeSketcher, residual) -> dict:
        return {
            "sketch_bytes": torch.tensor(float(sk.sketch_bytes())),
            "dense_bytes": torch.tensor(float(sk.dense_bytes())),
            "residual_norm": torch.sqrt(sum(
                torch.sum(torch.square(r)) for r in tree_leaves(residual))),
        }

    def compression_ratio(self, params) -> float:
        return self._sketcher(params).compression_ratio()


__all__ = ["SketchCompressor", "parse_compress_flag"]
