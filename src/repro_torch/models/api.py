"""Family dispatch: one surface (init / loss / decode / cache / input
specs) over the model families. Port of `repro/models/api.py`; the
decoder family (dense, MoE, qwen2-vl's M-RoPE and patches) is ported, the
other families raise until their slice lands (ROADMAP.md, queue 1 item
12.6).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import transformer
from .config import ArchConfig, ShapeSpec

_FAMILIES = {"decoder": transformer}
_WAITING = ("encdec", "hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    mod: Any

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return self.mod.init_params(self.cfg, generator, dtype)

    def module(self, params: dict) -> torch.nn.Module:
        """The `nn.Module` view of a parameter dict (no copy)."""
        return self.mod.Decoder(self.cfg, params)

    # -- steps -------------------------------------------------------------
    def loss_fn(self, params, batch, **kw):
        return self.mod.loss_fn(self.cfg, params, batch, **kw)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16, *,
                   device=None) -> dict:
        return self.mod.init_cache(self.cfg, batch, max_seq, dtype,
                                   device=device)

    def decode_step(self, params, cache, token, pos, **kw):
        """(logits (B, V) float32, cache), the cache written in place."""
        return self.mod.decode_step(self.cfg, params, cache, token, pos, **kw)

    def prefill(self, params, tokens, max_seq, **kw):
        if self.cfg.family == "decoder":
            return transformer.prefill(self.cfg, params, tokens, max_seq,
                                       **kw)
        raise NotImplementedError(f"prefill helper for {self.cfg.family}")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"the {cfg.family!r} model family is not ported yet (ROADMAP.md, "
            "queue 1 item 12.6)")
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return Model(cfg, _FAMILIES[cfg.family])


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Stand-ins for every model input of this cell: tensors on the
    'meta' device (shape and dtype, no storage). A decode cell is one new
    token a sequence against a `seq_len` cache."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        raise NotImplementedError("audio-frame inputs are not ported yet "
                                  "(ROADMAP.md, queue 1 item 12.6)")

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        batch = {"token": meta(B), "pos": meta(B),
                 "cache": build_model(cfg).init_cache(B, S, device="meta")}
        if cfg.mrope_sections is not None:
            batch["positions3"] = meta(3, B, 1)
        return batch
    batch = {"tokens": meta(B, S)}
    if shape.kind == "train":
        batch["labels"] = meta(B, S)
    if cfg.mrope_sections is not None:
        batch["positions3"] = meta(3, B, S)
        batch["patches"] = meta(B, cfg.num_patches, cfg.d_model,
                                dtype=torch.float32)
        batch["patch_positions"] = meta(B, cfg.num_patches)
    return batch


__all__ = ["Model", "build_model", "input_specs"]
