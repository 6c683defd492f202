"""Model settings the forward reads (attention and loss chunking, and the
model axis of a mesh).

Port of `repro/models/settings.py`: a contextvar consulted while the
forward runs, changed for a dynamic scope with `override(**kw)`. The
forward reads it once, at its entry (`forward_hidden`, `decode_step`),
and passes what it read down, so a block recomputed in the backward pass
(remat) takes what its forward took. What each field does in the port:

* `mesh`: the `launch.mesh.Mesh` whose model axis the forward runs over
  (tensor, sequence and expert parallelism, `launch/tp.py`); the steps
  set it. None, or a model axis of 1, runs on one device's whole heads.
* `cast_params_once`: the train step casts the fp32 matrices (every
  leaf of two dims or more) to the compute dtype before the forward, so
  the data axis's gathers (`param_gather`) and their reduce-scatters
  move bf16; the vectors (norms, biases) stay fp32.
* `gqa_expand`: where the model axis does not divide the KV heads, K and
  V are expanded to the query heads before the rank takes its heads
  (the reference's prefill step sets it); off, the rank takes the
  grouped KV heads its query heads read.
* `moe_c_shard`: where the experts do not divide the model axis and the
  expert buffer's capacity does, the expert output's partial sums are
  reduce-scattered over the capacity dim (tag `moe_c`) before the
  combine; off, they go through the combine and are reduced with the
  block's output.
* `flash_p_bf16`: the flash attention's PV product takes the softmax
  weights in bf16 and keeps its sums in fp32 (the scores stay fp32), as
  the reference's; `launch/dryrun.py --flash-bf16` sets it.
* `unroll_scans`: accepted, and changes nothing. The reference's cost
  probes set it so that XLA's cost analysis sees every iteration of a
  `lax.scan`; the port's loops are eager Python, every iteration of
  which runs and is counted (`scan_unroll()` returns what the
  reference's does, for a caller that reads it).

The reference's `manual_axes` (the axes a `shard_map` body holds in
manual control) and `constrain_attn_heads` (the heads' layout
constraint inside flash attention) have nothing to act on here: the port has no partitioner, and its attention always runs
on the rank's heads. Its `sp_block_outputs` chooses where XLA places the
sequence-parallel constraint on a block's output; the port's collectives
are written by hand, and a row-parallel product always leaves by one
reduce-scatter onto the rank's rows (`launch/tp.py`, ROADMAP.md,
"Differences kept on purpose").
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    dense_below: int = 2048 * 2048   # use dense scores for Sq*Sk <= this
    ce_chunk: int = 512
    mesh: object = None
    cast_params_once: bool = False
    gqa_expand: bool = False
    moe_c_shard: bool = False
    flash_p_bf16: bool = False
    unroll_scans: bool = False


_settings: contextvars.ContextVar[ModelSettings] = contextvars.ContextVar(
    "repro_torch_model_settings", default=ModelSettings())


def get() -> ModelSettings:
    return _settings.get()


def scan_unroll():
    """The reference's `lax.scan(..., unroll=...)` value; the port has no
    scan to unroll."""
    return True if _settings.get().unroll_scans else 1


@contextlib.contextmanager
def override(**kw):
    cur = _settings.get()
    token = _settings.set(dataclasses.replace(cur, **kw))
    try:
        yield _settings.get()
    finally:
        _settings.reset(token)


__all__ = ["ModelSettings", "get", "override", "scan_unroll"]
