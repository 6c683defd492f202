"""Tensorized-RP gradient compression with error feedback.

Port of `repro/optim/compress.py`. The paper's maps f_TT(R) / f_CP(R)
give an oblivious linear sketch whose adjoint is an unbiased
reconstruction, so they make a gradient compressor for the slow
cross-pod axis:

  pod w:  p_w = g_w + e_w             (error feedback)
          y_w = Sketch_t(p_w)         (k floats per bucket)
          h_w = alpha Unsketch_t(y_w) (one adjoint pass a pod)
  wire:   g_hat = mean_w h_w          (== alpha Unsketch_t(mean_w y_w))
  pod w:  e_w' = p_w - h_w            (local residual)

The operator of step t is regenerated on every rank from a seed
(`_key(t)`), so it never crosses the network. `sync='local-mean'` syncs
the dense reconstructions (one adjoint pass); `sync='sketch-mean'` syncs
the `(n_buckets, k)` sketches, D/k times fewer bytes, and every pod
unsketches the mean a second time. `wire='int8'` sends scaled int8
payloads with float32 scales (`rp.shard.quantize_for_psum`).

  * `compress` — the single-worker roundtrip estimator (no comm); with a
    `bucket_spec` (a data mesh) each rank projects and reconstructs its
    block of every leaf's buckets and the blocks are all-gathered;
  * `compress_per_pod` — the whole pod axis in one process: leaves carry
    a leading npod dim, folded into the bucket batch (one K1 launch a
    leaf for every pod); the reference the collective is held against;
  * `compress_collective` — the collective over a mesh's pod axis
    (`torch.distributed`): each rank passes its own pod's tree, the view
    the reference's shard_map body has, and the only cross-pod traffic is
    one mean (of the sketch, or of each dense leaf).

`wire_bytes` is the per-step pod-link payload of the active (sync, wire)
mode (`rp.plan.collective_wire_bytes`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import torch

from repro_torch import obs
from repro_torch.core.formats import BatchedCPTensor, BatchedTTTensor
from repro_torch.core.sketch import (PytreeSketcher, SketchConfig,
                                     _is_struct_leaf)
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.rp import shard


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
    pod_axis: str | None = None     # the mesh axis compress_collective syncs
    base_key: int = 0x5EED
    # Cross-pod sync (equal by linearity of the adjoint):
    #   'local-mean'  — one adjoint pass a pod; the dense reconstructions
    #                   cross the pod link;
    #   'sketch-mean' — the (buckets, k) sketches cross it, and every pod
    #                   unsketches their mean a second time.
    sync: str = "local-mean"
    # Wire dtype of compress_collective: 'fp32', or 'int8' (scaled int8
    # payloads plus float32 scales: per bucket row under 'sketch-mean',
    # per leaf under 'local-mean'; the next step's error feedback absorbs
    # the quantization error, at most s/2 an element).
    wire: str = "fp32"
    # The default mesh of compress_collective (launch/steps.py sets it).
    mesh: Any = dataclasses.field(default=None, compare=False)
    # The bucket-axis layout of `compress` on a data mesh (a spec whose
    # entry 0 names the axes of the (n_buckets, ...) dim;
    # launch/steps.py fills it with `sharding.bucket_specs(mesh)`): each
    # rank projects and reconstructs its block of a leaf's buckets, one
    # all_gather a leaf each way. None sketches every leaf whole.
    bucket_spec: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.sync not in ("local-mean", "sketch-mean"):
            raise ValueError(f"unknown sync mode {self.sync!r}; expected "
                             "'local-mean' or 'sketch-mean'")
        if self.wire not in ("fp32", "int8"):
            raise ValueError(f"unknown wire dtype {self.wire!r}; expected "
                             "'fp32' or 'int8'")

    # (structure-key, sketcher) memo: the tree structure is fixed across
    # steps, so the flatten and registry checks run once.
    _sk_cache: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # the structure key whose digest the pod group agreed on
    _agreed: Any = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @staticmethod
    def _leaf_memo_key(leaf):
        if _is_struct_leaf(leaf):
            nb = leaf.batch if isinstance(
                leaf, (BatchedTTTensor, BatchedCPTensor)) else 1
            return (type(leaf).__name__, tuple(leaf.dims), nb,
                    str(leaf.dtype))
        return (tuple(leaf.shape), str(leaf.dtype))

    def _memo_key(self, tree):
        leaves, treedef = tree_flatten(tree)
        return (treedef, tuple(self._leaf_memo_key(x) for x in leaves))

    def _sketcher(self, tree, *, plain: bool = False) -> PytreeSketcher:
        """Memoized PytreeSketcher for `tree`: with a `bucket_spec`, one
        that splits each leaf's buckets over the mesh, unless `plain`
        (`compress_collective`, whose ranks hold different pods' trees)."""
        key = (self._memo_key(tree), plain)
        if self._sk_cache is not None and self._sk_cache[0] == key:
            return self._sk_cache[1]
        sk = PytreeSketcher(self.cfg, tree, mesh=self.mesh,
                            bucket_spec=self.bucket_spec,
                            constrain=self.bucket_spec is not None
                            and not plain)
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

    def compress_per_pod(self, grads_pp, state, *, step):
        """The cross-pod compressed mean with the whole pod axis in one
        process: every leaf of `grads_pp` and `state['residual']` carries
        a leading npod dim. Each leaf's pods go through ONE K1 launch
        (the pod dim folded into the bucket batch) and one K2 launch.
        Returns (synced grads WITHOUT the pod dim, new_state, metrics)."""
        if self.wire != "fp32":
            raise ValueError(
                f"compress_per_pod is the single-process reference and has "
                f"no collective to quantize; wire={self.wire!r} is a "
                "compress_collective feature — use wire='fp32' here")
        example = tree_map(lambda g: torch.empty(
            tuple(g.shape[1:]), dtype=g.dtype, device="meta"), grads_pp)
        sk = self._sketcher(example)
        seed = self._key(step)
        npod = int(tree_leaves(grads_pp)[0].shape[0])
        p = tree_map(lambda g, e: g.to(torch.float32) + e,
                     grads_pp, state["residual"])
        alpha = self.cfg.shrinkage()
        y_pp = sk.sketch(p, seed, npod=npod)           # (npod, buckets, k)
        h_local = tree_map(lambda x: alpha * x, sk.unsketch(y_pp, seed))
        if self.sync == "local-mean":
            g_hat = tree_map(lambda h: h.sum(0) / npod, h_local)
        else:  # 'sketch-mean'
            g_hat = tree_map(lambda x: alpha * x,
                             sk.unsketch(y_pp.sum(0) / npod, seed))
        new_residual = tree_map(lambda pp, h: pp - h.to(torch.float32),
                                p, h_local)
        g_out = tree_map(lambda gh, g: gh.to(g.dtype), g_hat, grads_pp)
        return g_out, {"residual": new_residual}, self._pod_metrics(
            sk, new_residual)

    def _agree_on(self, tree, group) -> None:
        """On the first call with a tree structure, all-gather a digest of
        its (shape, dtype)s over the pod group and refuse a mismatch (a
        collective over trees of different sizes would hang or mix). A
        fake process group (the dry run) has no peer to agree with: the
        check is skipped there."""
        key = self._memo_key(tree)
        if self._agreed == key or group.mesh.backend == "fake":
            return
        desc = repr([(tuple(x.shape), str(x.dtype))
                     for x in tree_leaves(tree)]).encode()
        digest = int.from_bytes(hashlib.blake2b(desc, digest_size=7).digest(),
                                "little")
        mine = torch.tensor([digest], dtype=torch.int64,
                            device=tree_leaves(tree)[0].device)
        every = shard.all_gather(mine, group, tag="digest").tolist()
        if len(set(every)) != 1:
            raise ValueError(
                f"compress_collective needs one tree per pod, the same "
                f"leaf shapes and dtypes on every rank of {group.axes}; the "
                f"ranks' digests differ: {every} (this rank's tree: "
                f"{desc.decode()[:300]})")
        self._agreed = key

    def compress_collective(self, grads, state, *, step, mesh=None):
        """The cross-pod compressed mean over the mesh's pod axis.

        Each rank passes its own pod's gradient tree and residual (no pod
        dim: the reference's shard_map body's view). Per rank: the error
        feedback, one K1 launch a leaf, one local K2 launch a leaf (the
        residual needs it); then under 'sketch-mean' one all_reduce of
        the (n_buckets, k) sketch and a second K2 pass, under 'local-mean'
        one all_reduce a dense leaf; with wire='int8' each all_reduce is
        a MAX of the scales, an int8 SUM and `dequantize_psum`. The
        operator is drawn on every rank from `_key(step)` and never sent.
        Equal to `compress_per_pod` to fp32 tolerance (int8 adds its
        bounded quantization error), the same bits on every rank.
        Returns (synced grads, new_state, metrics).
        """
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("compress_collective needs a mesh (pass mesh= "
                             "or construct SketchCompressor(mesh=...))")
        axis = self.pod_axis or "pod"
        if axis not in mesh.axis_names:
            raise ValueError(f"pod axis {axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
        group = mesh.group(axis)
        npod = group.size
        if self.wire == "int8" and npod > 127:
            raise ValueError(
                f"wire='int8' supports at most 127 pods (the overflow-proof "
                f"clip qmax = 127 // npod would be 0), got npod={npod}")
        self._agree_on(grads, group)
        sk = self._sketcher(grads, plain=True)
        seed = self._key(step)
        alpha = self.cfg.shrinkage()

        def mean_over_pods(x, *, per_row):
            if self.wire == "fp32":
                return shard.all_reduce(x, group, tag="compress") / npod
            q, s = shard.quantize_for_psum(x, group, npod, per_row=per_row,
                                           tag="compress")
            return shard.dequantize_psum(
                shard.all_reduce(q, group, tag="compress"), s, npod)

        p = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                     state["residual"])
        y = sk.sketch(p, seed)                          # (n_buckets, k)
        if self.sync == "sketch-mean":
            # each leaf's residual as soon as its local reconstruction is
            # made, into p's leaf: a whole reconstruction of the tree is
            # never held. The reconstructions and p are this call's own,
            # so they are scaled and subtracted in place (the same bits as
            # p - alpha * x)
            p_leaves, treedef = tree_flatten(p)
            del p
            resid = []
            for i, x in enumerate(sk.iter_unsketch(y, seed)):
                resid.append(p_leaves[i].sub_(x.mul_(alpha).to(
                    torch.float32)))
                p_leaves[i] = None
            new_residual = tree_unflatten(treedef, resid)
            g_hat = tree_unflatten(treedef, [x.mul_(alpha) for x in (
                sk.iter_unsketch(mean_over_pods(y, per_row=True), seed))])
        else:  # 'local-mean'
            h_local = tree_map(lambda x: alpha * x, sk.unsketch(y, seed))
            g_hat = tree_map(lambda h: mean_over_pods(h, per_row=False),
                             h_local)
            new_residual = tree_map(lambda pp, h: pp - h.to(torch.float32),
                                    p, h_local)
        g_out = tree_map(lambda gh, g: gh.to(g.dtype), g_hat, grads)
        return g_out, {"residual": new_residual}, self._pod_metrics(
            sk, new_residual)

    def _pod_metrics(self, sk: PytreeSketcher, residual) -> dict:
        """The base metrics plus the per-step pod-link bytes of the active
        (sync, wire) mode; the gauge `rp/wire_bytes_per_step` holds them
        and the counter `rp/collective_traces` counts the calls (each
        eager call: the reference's counts jit traces)."""
        metrics = self._metrics(sk, residual)
        wire = self.wire_bytes(sk)
        metrics["wire_bytes"] = torch.tensor(float(wire))
        obs.gauge("rp/wire_bytes_per_step").set(float(wire))
        obs.counter("rp/collective_traces").inc()
        return metrics

    def wire_bytes(self, sk: PytreeSketcher) -> int:
        """Per-step pod-link payload of `compress_collective` in the
        active (sync, wire) mode, from the plan layer's wire ledger."""
        from repro_torch.rp.plan import collective_wire_bytes
        return collective_wire_bytes(
            sync=self.sync, wire=self.wire,
            sketch_bytes=sk.sketch_bytes(), dense_bytes=sk.dense_bytes(),
            n_buckets=sk.n_buckets, n_leaves=len(sk._shapes))

    def _metrics(self, sk: PytreeSketcher, residual) -> dict:
        return {
            "sketch_bytes": torch.tensor(float(sk.sketch_bytes())),
            "dense_bytes": torch.tensor(float(sk.dense_bytes())),
            # a dot product a leaf: no squared copy of the residual
            "residual_norm": torch.sqrt(sum(
                torch.dot(r.reshape(-1), r.reshape(-1))
                for r in tree_leaves(residual))),
        }

    def compression_ratio(self, params) -> float:
        return self._sketcher(params).compression_ratio()


__all__ = ["SketchCompressor", "parse_compress_flag"]
