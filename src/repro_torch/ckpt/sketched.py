"""Sketched-state checkpoint codec: persist trees as (seed, spec, sketch).

Port of `repro/ckpt/sketched.py`. A tensorized random projection is fully
determined by a seed and a declarative spec, so a checkpointed
error-feedback tree never needs its dense bytes on disk: only the
`(n_buckets, k)` sketch and the seed that regenerates the operator. On
restore the operator is drawn again from the saved seed (the port's
`rp.make_projector` is deterministic in (spec, seed, device)) and the
dense estimate comes back through one adjoint pass. The round trip is an
unbiased Thm-1-bounded ESTIMATE, the error class error-feedback state
tolerates, and it is deterministic: two decodes of one record give the
same bits, so a crash-restart stays reproducible.

On the card `encode` is one K1 launch a leaf (`PytreeSketcher.sketch`)
and `decode` one K2 launch a leaf (`PytreeSketcher.unsketch`); a CPU
tree takes the plain route.

On-disk record: {"y": (n_buckets, k) float32 sketch, "seed": int64
tagged base key, "step": int64 step}. `meta()` goes into the checkpoint
manifest's `extra`, so a restarted job rebuilds the codec with
`from_meta`. The operator seed of a step is `base_key * 1_000_003 + step`
(the compressor's rule, `optim/compress.py`), while the reference draws
its operators with JAX's `fold_in`, which torch cannot replay: a record
decodes only in the package that wrote it. So the record's seed carries
this package's tag above the base key (the reference's `seed !=
base_key` check refuses it), `meta()` names the generator, and `decode`
/ `from_meta` refuse a record or meta without the tag, naming the
package that wrote it. Dense checkpoints cross packages as before.

With a mesh (`mesh=`, `bucket_spec=`) the sketcher splits each leaf's
buckets over the spec's axes (`core/sketch.py`); the record is the same
canonical `(n_buckets, k)` sketch on every layout.

On a pod mesh each rank holds its own pod's EF row, and the record is
the one the reference writes for the stacked `(npod, ...)` tree:
`for_pod_rows` builds the codec over that stacked example (its
`n_buckets` and `meta()` are the stacked tree's), the train loop gathers
the rows onto rank 0, which encodes them (one K1 launch a leaf over npod
times the buckets), and every rank decodes the whole record on restore
and keeps its row (the same bits on every rank: the operator comes from
the record's seed).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import PytreeSketcher, SketchConfig
from repro_torch.core.tree import tree_leaves, tree_map

from .checkpointer import CheckpointError

#: default base key for checkpoint sketches — distinct from
#: SketchCompressor's 0x5EED, so the checkpoint operator and the
#: gradient-compression operator of one step are independent draws.
CKPT_KEY = 0xCC11

#: the generator a record's operators come from, in `meta()`
GENERATOR = "repro_torch"
#: a port record's seed is `_SEED_TAG | base_key`: the tag sits above the
#: 48 bits a base key may use
_SEED_TAG = 0x7254 << 48
_KEY_BITS = (1 << 48) - 1


def _foreign(what: str, writer: str) -> CheckpointError:
    return CheckpointError(
        f"sketched {what} was written by the package {writer!r}, whose "
        f"operators come from another generator than {GENERATOR}'s "
        "(base_key * 1_000_003 + step): decoding it here would give noise "
        f"of the right size; restore it with {writer!r}, or checkpoint the "
        "error feedback dense to cross packages")


def _codec_device(example_tree, device) -> torch.device:
    """`device` if given, else the first example leaf's real device, else
    CUDA (`resolve_device(None)`)."""
    if device is not None:
        return resolve_device(device)
    for leaf in tree_leaves(example_tree):
        dev = getattr(leaf, "device", None)
        if isinstance(dev, torch.device) and dev.type != "meta":
            return dev
    return resolve_device(None)


class SketchedTreeCodec:
    """Encode/decode a fixed-structure tree through one shared sketch.

    encode(tree, step) -> {"y", "seed", "step"} record (tensors only, ready
    for the checkpointer); decode(record) -> dense unbiased estimate on
    `device` (default: the example tree's device), the operator drawn
    again from the record's own seed and step. `example_tree` may hold
    meta tensors. decode(encode(x, s)) is a pure function of (x, s, cfg,
    base_key, device).
    """

    def __init__(self, cfg: SketchConfig, example_tree: Any, *,
                 base_key: int = CKPT_KEY, device=None, mesh=None,
                 bucket_spec=None):
        if not 0 <= int(base_key) <= _KEY_BITS:
            raise ValueError(f"base_key {int(base_key):#x} must fit in 48 "
                             "bits (the record's seed tags the bits above)")
        self.cfg = cfg
        self.base_key = int(base_key)
        self.device = _codec_device(example_tree, device)
        self._sk = PytreeSketcher(cfg, example_tree, mesh=mesh,
                                  bucket_spec=bucket_spec)

    def key_for(self, step) -> int:
        """The operator seed of `step` (the compressor's rule)."""
        if not self.cfg.fresh_per_step:
            return self.base_key
        return self.base_key * 1_000_003 + int(step)

    # -- codec ------------------------------------------------------------
    def encode(self, tree: Any, *, step: int) -> dict:
        """tree -> self-describing record (never the dense tree); the
        seed and step are host int64 scalars."""
        y = self._sk.sketch(tree, self.key_for(step))
        return {"y": y, "seed": torch.tensor(_SEED_TAG | self.base_key,
                                             dtype=torch.int64),
                "step": torch.tensor(int(step), dtype=torch.int64)}

    def decode(self, record: dict) -> Any:
        """record -> dense unbiased estimate; operator regenerated from the
        record's saved seed (no operator bytes were ever on disk)."""
        seed = int(record["seed"])
        if seed & ~_KEY_BITS != _SEED_TAG:
            raise _foreign(f"record (seed {seed:#x}, no {GENERATOR} tag)",
                           "repro")
        seed &= _KEY_BITS
        if seed != self.base_key:
            raise CheckpointError(
                f"sketched record was written with base key {seed:#x} but "
                f"this codec regenerates from {self.base_key:#x}; the "
                "reconstructed operator would not match the sketch")
        y = torch.as_tensor(record["y"])
        if tuple(y.shape) != (self._sk.n_buckets, self.cfg.k):
            raise CheckpointError(
                f"sketched record shape {tuple(y.shape)} != expected "
                f"({self._sk.n_buckets}, {self.cfg.k}); the encoded tree "
                "structure or SketchConfig changed between save and restore")
        return self._sk.unsketch(y.to(self.device),
                                 self.key_for(int(record["step"])))

    # -- checkpoint integration -------------------------------------------
    def record_shapes(self) -> dict:
        """Meta tensors shaped like encode()'s record: the example tree a
        checkpointer restores a sketched record into (onto the CPU unless
        the restore names a device)."""
        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        return {"y": meta((self._sk.n_buckets, self.cfg.k), torch.float32),
                "seed": meta((), torch.int64),
                "step": meta((), torch.int64)}

    def meta(self) -> dict:
        """JSON-able codec description for the checkpoint manifest `extra`."""
        return {"family": self.cfg.family, "k": self.cfg.k,
                "rank": self.cfg.rank, "dims": list(self.cfg.dims),
                "bucket_elems": self.cfg.bucket_elems,
                "fresh_per_step": self.cfg.fresh_per_step,
                "base_key": self.base_key,
                "n_buckets": self._sk.n_buckets,
                "generator": GENERATOR}

    @classmethod
    def from_meta(cls, meta: dict, example_tree: Any, *, device=None,
                  mesh=None, bucket_spec=None) -> "SketchedTreeCodec":
        """Rebuild the codec a checkpoint was written with (on a new mesh
        too: the sketch values are layout-free). A meta without this
        package's generator tag is refused."""
        writer = meta.get("generator", "repro")
        if writer != GENERATOR:
            raise _foreign("meta", writer)
        cfg = SketchConfig(family=meta["family"], k=int(meta["k"]),
                           rank=int(meta["rank"]),
                           dims=tuple(int(d) for d in meta["dims"]),
                           bucket_elems=int(meta["bucket_elems"]),
                           fresh_per_step=bool(meta["fresh_per_step"]))
        return cls(cfg, example_tree, base_key=int(meta["base_key"]),
                   device=device, mesh=mesh, bucket_spec=bucket_spec)

    @classmethod
    def for_pod_rows(cls, cfg: SketchConfig, row_tree: Any, npod: int
                     ) -> "SketchedTreeCodec":
        """The codec of a pod mesh's EF: over the stacked `(npod, ...)`
        example of `row_tree` (one rank's row), on `row_tree`'s device."""
        def stacked(leaf):
            return torch.empty((npod,) + tuple(leaf.shape), dtype=leaf.dtype,
                               device="meta")
        return cls(cfg, tree_map(stacked, row_tree),
                   device=_codec_device(row_tree, None))

    # -- accounting (the checkpoint-size story) ---------------------------
    def sketch_bytes(self) -> int:
        return self._sk.sketch_bytes() + 16  # + seed/step scalars

    def dense_bytes(self) -> int:
        return self._sk.dense_bytes()

    def compression_ratio(self) -> float:
        return self.dense_bytes() / max(1, self.sketch_bytes())


__all__ = ["CKPT_KEY", "GENERATOR", "SketchedTreeCodec"]
