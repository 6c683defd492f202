"""Family dispatch: one surface (init / loss / input specs) over the model
families. Port of `repro/models/api.py`; the dense decoder is ported, the
other families raise until their slice lands (ROADMAP.md, queue 1 item
12).
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


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"the {cfg.family!r} model family is not ported yet (ROADMAP.md, "
            "queue 1 item 12)")
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return Model(cfg, _FAMILIES[cfg.family])


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Stand-ins for every model input of this cell: tensors on the
    'meta' device (shape and dtype, no storage)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill"):
        raise NotImplementedError(
            f"{shape.kind!r} inputs need the KV cache of the LM server, not "
            "ported yet (ROADMAP.md, queue 1 item 12)")
    if cfg.mrope_sections is not None or cfg.family == "encdec":
        raise NotImplementedError("multimodal inputs are not ported yet "
                                  "(ROADMAP.md, queue 1 item 12)")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32,
                                      device="meta")
    return batch


__all__ = ["Model", "build_model", "input_specs"]
