"""Family dispatch: one surface (init / loss / decode / cache / input
specs / carrying the reference's parameters across) over the four model
families: the decoder (dense, MoE, qwen2-vl's M-RoPE and patches), the
SSM (mamba2), the RG-LRU hybrid (recurrentgemma) and the
encoder-decoder (whisper). Port of `repro/models/api.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import mamba2, rglru, transformer, whisper
from .config import ArchConfig, ShapeSpec

_FAMILIES = {
    "decoder": transformer,
    "encdec": whisper,
    "hybrid": rglru,
    "ssm": mamba2,
}
# each family's nn.Module view of a parameter dict
_VIEWS = {
    "decoder": transformer.Decoder,
    "encdec": whisper.Whisper,
    "hybrid": rglru.Griffin,
    "ssm": mamba2.Mamba2,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    mod: Any

    # -- parameters ------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32) -> dict:
        return self.mod.init_params(self.cfg, generator, dtype)

    def param_axes(self) -> dict:
        """The parameter tree's logical sharding axes (the reference's)."""
        return self.mod.param_axes(self.cfg)

    def param_shapes(self, dtype=torch.float32) -> dict:
        """The parameter tree as meta tensors: every leaf's shape and
        dtype, nothing drawn or allocated (the reference's `eval_shape`
        of `init`)."""
        from .params import shapes
        return shapes(self.mod._spec(self.cfg), dtype)

    def module(self, params: dict) -> torch.nn.Module:
        """The family's `nn.Module` view of a parameter dict (no copy)."""
        return _VIEWS[self.cfg.family](self.cfg, params)

    # -- steps -------------------------------------------------------------
    def loss_fn(self, params, batch, **kw):
        return self.mod.loss_fn(self.cfg, params, batch, **kw)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16, *,
                   device=None) -> dict:
        return self.mod.init_cache(self.cfg, batch, max_seq, dtype,
                                   device=device)

    @property
    def recurrent_state(self) -> tuple[str, ...]:
        """The cache's top-level keys that hold recurrent state (every
        leaf under them advances at every decode step, whatever the
        position), which a slot server keeps apart between slots."""
        return self.mod.RECURRENT_STATE

    def decode_step(self, params, cache, token, pos, **kw):
        """(logits (B, V) float32, cache), the cache written in place."""
        return self.mod.decode_step(self.cfg, params, cache, token, pos, **kw)

    def prefill(self, params, tokens, max_seq, **kw):
        if self.cfg.family == "decoder":
            return transformer.prefill(self.cfg, params, tokens, max_seq,
                                       **kw)
        raise NotImplementedError(f"prefill helper for {self.cfg.family}")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return Model(cfg, _FAMILIES[cfg.family])


def from_numpy_params(cfg: ArchConfig, tree: dict, *, device=None,
                      dtype=torch.float32) -> dict:
    """The port's parameter dict of any family from the reference's
    (numpy arrays under the same nested names), every shape checked.
    `device=None` means CUDA."""
    return build_model(cfg).mod.from_numpy_params(cfg, tree, device=device,
                                                  dtype=dtype)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Stand-ins for every model input of this cell: tensors on the
    'meta' device (shape and dtype, no storage). A decode cell is one new
    token a sequence against a `seq_len` cache; an encoder-decoder's
    train and prefill cells also take the audio frames (B, encoder_seq,
    D) float32."""
    B, S = shape.global_batch, shape.seq_len

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
    if cfg.family == "encdec":
        batch["frames"] = meta(B, cfg.encoder_seq, cfg.d_model,
                               dtype=torch.float32)
    return batch


__all__ = ["Model", "build_model", "from_numpy_params", "input_specs"]
