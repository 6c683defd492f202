"""repro_torch.ckpt — verified, sketch-native, elastic checkpoints.

Port of `repro/ckpt`:

  * `checkpointer` — atomic saves with per-array crc32 + manifest sha256,
    corruption-detecting restore with fallback to the newest VERIFIED
    checkpoint, retry-with-backoff on transient I/O, async saves whose
    device-to-host copies run on a side stream into pinned buffers.
  * `SketchedTreeCodec` — persist EF/optimizer trees as (seed, spec,
    (n_buckets, k) sketch) records; the operator is drawn again from the
    saved seed on restore, never stored (one K1 launch a leaf to encode,
    one K2 launch a leaf to decode, on the card).
  * `respec_pod_ef` / `resume_elastic` — restore onto a different pod
    count: exact contiguous-group sums where the pod count divides,
    total-preserving redistribution otherwise; `resume_pod_rank` restores
    onto one rank of a pod mesh, which keeps its own pod's EF row.
"""
from . import checkpointer
from .checkpointer import (AsyncCheckpointer, CheckpointError,
                           CorruptionError, sweep_tmp, verify)
from .elastic import respec_pod_ef, resume_elastic, resume_pod_rank
from .sketched import CKPT_KEY, SketchedTreeCodec

__all__ = [
    "AsyncCheckpointer", "CKPT_KEY", "CheckpointError", "CorruptionError",
    "SketchedTreeCodec", "checkpointer", "respec_pod_ef", "resume_elastic",
    "resume_pod_rank", "sweep_tmp", "verify",
]
