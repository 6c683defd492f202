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

On-disk record: {"y": (n_buckets, k) float32 sketch, "seed": int64 base
key, "step": int64 step}. `meta()` goes into the checkpoint manifest's
`extra`, so a restarted job rebuilds the codec with `from_meta`. The
operator seed of a step is `base_key * 1_000_003 + step` (the
compressor's rule, `optim/compress.py`): torch cannot replay JAX's
`fold_in`, so a record is read back by the package that wrote it. The
mesh and bucket-layout options wait for the collective (ROADMAP.md,
queue 1 item 11).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.sketch import PytreeSketcher, SketchConfig
from repro_torch.core.tree import tree_leaves

from .checkpointer import CheckpointError

#: default base key for checkpoint sketches — distinct from
#: SketchCompressor's 0x5EED, so the checkpoint operator and the
#: gradient-compression operator of one step are independent draws.
CKPT_KEY = 0xCC11


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
                 base_key: int = CKPT_KEY, device=None):
        self.cfg = cfg
        self.base_key = int(base_key)
        self.device = _codec_device(example_tree, device)
        self._sk = PytreeSketcher(cfg, example_tree)

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
        return {"y": y, "seed": torch.tensor(self.base_key, dtype=torch.int64),
                "step": torch.tensor(int(step), dtype=torch.int64)}

    def decode(self, record: dict) -> Any:
        """record -> dense unbiased estimate; operator regenerated from the
        record's saved seed (no operator bytes were ever on disk)."""
        seed = int(record["seed"])
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
                "n_buckets": self._sk.n_buckets}

    @classmethod
    def from_meta(cls, meta: dict, example_tree: Any, *,
                  device=None) -> "SketchedTreeCodec":
        """Rebuild the codec a checkpoint was written with."""
        cfg = SketchConfig(family=meta["family"], k=int(meta["k"]),
                           rank=int(meta["rank"]),
                           dims=tuple(int(d) for d in meta["dims"]),
                           bucket_elems=int(meta["bucket_elems"]),
                           fresh_per_step=bool(meta["fresh_per_step"]))
        return cls(cfg, example_tree, base_key=int(meta["base_key"]),
                   device=device)

    # -- accounting (the checkpoint-size story) ---------------------------
    def sketch_bytes(self) -> int:
        return self._sk.sketch_bytes() + 16  # + seed/step scalars

    def dense_bytes(self) -> int:
        return self._sk.dense_bytes()

    def compression_ratio(self) -> float:
        return self.dense_bytes() / max(1, self.sketch_bytes())


__all__ = ["CKPT_KEY", "SketchedTreeCodec"]
