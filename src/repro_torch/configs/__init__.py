"""Architecture registry (port of `repro/configs`).

`get_config(name)` -> full ArchConfig;  `reduced(cfg)` -> CPU-smoke variant
of the same family (small widths/layers/experts, tiny vocab). All ten of
the reference's architectures are registered: the dense decoders
llama3.2-3b, deepseek-67b, qwen1.5-110b and gemma2-9b, the MoE decoders
mixtral-8x22b and arctic-480b, qwen2-vl-2b (M-RoPE, patch embeddings),
the SSM mamba2-1.3b, the RG-LRU hybrid recurrentgemma-2b and the
encoder-decoder whisper-medium.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, ShapeSpec

from . import (arctic_480b, deepseek_67b, gemma2_9b, llama32_3b,
               mamba2_13b, mixtral_8x22b, qwen2_vl_2b, qwen15_110b,
               recurrentgemma_2b, whisper_medium)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        deepseek_67b, qwen15_110b, gemma2_9b, llama32_3b, arctic_480b,
        mixtral_8x22b, whisper_medium, recurrentgemma_2b, qwen2_vl_2b,
        mamba2_13b,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


SMOKE_SHAPES = (
    ShapeSpec("smoke_train", 32, 2, "train"),
    ShapeSpec("smoke_decode", 64, 2, "decode"),
)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=4, top_k=2, d_ff_expert=64,
            dense_residual_ff=64 if moe.dense_residual_ff else None,
            capacity_factor=4.0)
    n_layers = 3 if cfg.family == "hybrid" else 2
    if cfg.family == "hybrid":
        n_layers = 4  # one scanned (rec,rec,attn) group + 1 tail rec layer
    window = tuple((8 if w is not None else None) for w in cfg.window_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else None,
        d_ff=96 if cfg.d_ff else 0,
        vocab=256,
        moe=moe,
        window_pattern=window,
        rnn_width=64 if cfg.rnn_width else None,
        ssm_state=16 if cfg.ssm_state else None,
        ssm_head_dim=16,
        ssm_chunk=8,
        encoder_layers=2 if cfg.encoder_layers else None,
        encoder_seq=12 if cfg.encoder_seq else None,
        num_patches=4,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        shapes=SMOKE_SHAPES,
    )
