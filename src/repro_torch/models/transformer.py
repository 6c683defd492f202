"""Decoder-only transformer, the dense family: llama, deepseek and qwen
(GQA, RoPE, RMSNorm, SwiGLU, optional QKV bias, tied or separate
unembedding) and gemma2 (local/global windows, softcaps, post-block
norms, GeGLU, the (1+w) norm offset, sqrt(D) embed scaling).

Port of the dense path of `repro/models/transformer.py`, with its KV-cache
decode (`cache_len`, `init_cache`, `decode_step`, `prefill`). Parameters
are a nested dict under the reference's names, with per-layer tensors
stacked on a leading L axis, so the leaves and their shapes are the
reference's and a parameter tree carries across (`from_numpy_params`).
`Decoder` is the `nn.Module` view of such a dict. MoE (item 12.4), M-RoPE
and patch embeddings (12.5) raise NotImplementedError until their slice
lands (ROADMAP.md, queue 1 item 12).

`decode_step` writes the new keys, values and positions into the cache
in place (under `torch.inference_mode`) and returns the same dict: a
functional copy would move the whole cache every token.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from . import layers as nn
from .config import ArchConfig

_ROADMAP = "not ported yet (ROADMAP.md, queue 1 item 12)"

#: the position of an empty cache slot: causally masked for every query
EMPTY_POS = 1 << 30


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(f"the {cfg.family!r} family is {_ROADMAP}")
    for what, on in (("MoE", cfg.moe is not None),
                     ("M-RoPE", cfg.mrope_sections is not None),
                     (f"the {cfg.mlp!r} MLP",
                      cfg.mlp not in ("swiglu", "geglu")),
                     (f"the {cfg.norm!r} norm", cfg.norm != "rms")):
        if on:
            raise NotImplementedError(f"{what} in the decoder is {_ROADMAP}")


# ---------------------------------------------------------------------------
# Parameter specification
# ---------------------------------------------------------------------------

def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """path -> (shape, init_kind). (The reference's logical sharding axes
    wait for the mesh, ROADMAP.md queue 1 item 11.)"""
    _check_dense(cfg)
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv, F, V, L = (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
                        cfg.n_layers)
    s: dict[str, tuple] = {}
    s["embed"] = ((V, D), "embed")
    lyr = {
        "norm1": ((L, D), "norm"),
        "norm2": ((L, D), "norm"),
        "wq": ((L, D, Hq * hd), "fanin"),
        "wk": ((L, D, Hkv * hd), "fanin"),
        "wv": ((L, D, Hkv * hd), "fanin"),
        "wo": ((L, Hq * hd, D), "fanin"),
    }
    if cfg.qkv_bias:
        lyr["bq"] = ((L, Hq * hd), "zeros")
        lyr["bk"] = ((L, Hkv * hd), "zeros")
        lyr["bv"] = ((L, Hkv * hd), "zeros")
    if cfg.post_norm:
        lyr["norm1_post"] = ((L, D), "norm")
        lyr["norm2_post"] = ((L, D), "norm")
    lyr["w_gate"] = ((L, D, F), "fanin")
    lyr["w_up"] = ((L, D, F), "fanin")
    lyr["w_down"] = ((L, F, D), "fanin")
    s.update({f"layers/{k}": v for k, v in lyr.items()})
    s["final_norm"] = ((D,), "norm")
    if not cfg.tie_embeddings:
        s["unembed"] = ((D, V), "fanin")
    return s


def _assign(tree: dict, path: str, leaf) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn from it in the
    reference's sorted path order (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    dev = generator.device
    for path, (shape, kind) in sorted(_spec(cfg).items()):
        if kind == "norm":
            leaf = (torch.zeros if cfg.norm_offset else torch.ones)(
                shape, dtype=dtype, device=dev)
        elif kind == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            std = 0.02 if kind == "embed" else 1.0 / (shape[-2] ** 0.5)
            leaf = torch.randn(shape, generator=generator, dtype=dtype,
                               device=dev) * std
        _assign(params, path, leaf)
    return params


def from_numpy_params(cfg: ArchConfig, tree: dict, *, device=None,
                      dtype=torch.float32) -> dict:
    """The port's parameter dict from the reference's (numpy arrays under
    the same nested names); every leaf's shape is checked against the
    spec. `device=None` means CUDA."""
    dev = resolve_device(device)
    out: dict[str, Any] = {}
    for path, (shape, _) in sorted(_spec(cfg).items()):
        node = tree
        for p in path.split("/"):
            node = node[p]
        a = np.asarray(node, dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, the spec of "
                             f"{cfg.name} has {tuple(shape)}")
        _assign(out, path, torch.tensor(a, dtype=dtype, device=dev))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, lp: dict, x: torch.Tensor):
    B, S, _ = x.shape
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (q.reshape(B, S, Hq, hd), k.reshape(B, S, Hkv, hd),
            v.reshape(B, S, Hkv, hd))


def _ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    mlp = nn.geglu if cfg.mlp == "geglu" else nn.swiglu
    return mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _block(cfg: ArchConfig, h, lp_raw: dict, positions, compute_dtype,
           attend):
    """One block on the residual stream h (B, S, D): the parameters cast
    to the compute dtype, q and k rotated at `positions` (B, S), and
    `attend(q, k, v)` -> (B, S, Hq, hd) for the attention itself."""
    B, S, _ = h.shape
    lp = {name: t.to(compute_dtype) for name, t in lp_raw.items()}
    hn = nn.rms_norm(h, lp_raw["norm1"], offset=cfg.norm_offset)
    q, k, v = _qkv(cfg, lp, hn)
    q = nn.apply_rope(q, positions, theta=cfg.rope_theta)
    k = nn.apply_rope(k, positions, theta=cfg.rope_theta)
    attn = attend(q, k, v).reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"]
    if cfg.post_norm:
        attn = nn.rms_norm(attn, lp_raw["norm1_post"], offset=cfg.norm_offset)
    h = h + attn
    hn2 = nn.rms_norm(h, lp_raw["norm2"], offset=cfg.norm_offset)
    ff = _ffn(cfg, lp, hn2)
    if cfg.post_norm:
        ff = nn.rms_norm(ff, lp_raw["norm2_post"], offset=cfg.norm_offset)
    return h + ff


def _layer(cfg: ArchConfig, h, stacked: dict, i: int, window: int,
           positions, compute_dtype):
    """Block i of the stack on the full sequence h (B, S, D)."""
    def attend(q, k, v):
        return nn.attention(q, k, v, positions, positions, causal=True,
                            window=window, softcap=cfg.attn_softcap)
    return _block(cfg, h, {name: t[i] for name, t in stacked.items()},
                  positions, compute_dtype, attend)


def _embed(cfg: ArchConfig, params: dict, tokens, compute_dtype):
    h = params["embed"][tokens.to(torch.int64)].to(compute_dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    return h


def _logits(cfg: ArchConfig, params: dict, h) -> torch.Tensor:
    """float32 logits of final hidden states h (B, D), soft-capped."""
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = h.to(torch.float32) @ unembed.to(torch.float32)
    return nn.soft_cap(logits, cfg.final_softcap)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   positions: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing") -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D).

    remat='nothing' recomputes each block in the backward pass (the
    reference's `jax.checkpoint(nothing_saveable)` around its layer scan);
    any other value but 'dots' stores the activations.
    """
    _check_dense(cfg)
    if patches is not None:
        raise NotImplementedError(f"patch embeddings are {_ROADMAP}")
    if remat == "dots":
        raise NotImplementedError(f"remat='dots' is {_ROADMAP}")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, compute_dtype)
    for i, window in enumerate(cfg.window_array()):
        args = (cfg, h, params["layers"], i, window, positions,
                compute_dtype)
        h = nn.remat(_layer, *args) if remat == "nothing" else _layer(*args)
    return nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16,
            remat: str = "nothing") -> torch.Tensor:
    h = forward_hidden(cfg, params, batch["tokens"],
                       patches=batch.get("patches"),
                       compute_dtype=compute_dtype, remat=remat)
    unembed = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return nn.chunked_ce_loss(h, unembed, batch["labels"],
                              softcap=cfg.final_softcap,
                              mask=batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# Decode (single-token serve step with a KV cache)
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, max_seq: int) -> int:
    """Ring-buffer length: bounded by the largest attention window when
    every layer is windowed."""
    widest = max(cfg.window_for_layer(i) for i in range(cfg.n_layers))
    return min(max_seq, widest)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """{"k", "v": (L, B, Hkv, C, hd), "pos": (L, B, C) int32}, every slot
    empty (position `EMPTY_POS`). `device=None` means CUDA; 'meta' gives
    shapes only."""
    dev = resolve_device(device)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    C = cache_len(cfg, max_seq)
    return {"k": torch.zeros((L, batch, Hkv, C, hd), dtype=dtype, device=dev),
            "v": torch.zeros((L, batch, Hkv, C, hd), dtype=dtype, device=dev),
            "pos": torch.full((L, batch, C), EMPTY_POS, dtype=torch.int32,
                              device=dev)}


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """token: (B,) int; pos: (B,) int (each sequence's position).

    Writes each layer's new key, value and position into the cache at
    ring slot `pos % C`, in place, and attends over the whole ring.
    Returns (logits (B, V) float32, cache) -- the same cache dict.
    """
    _check_dense(cfg)
    B = token.shape[0]
    C = cache["k"].shape[3]
    pos = pos.to(device=token.device, dtype=torch.int32)
    pos_q = pos[:, None]                                  # (B, 1)
    slot = (pos % C).to(torch.int64)
    rows = torch.arange(B, device=token.device)
    h = _embed(cfg, params, token, compute_dtype)[:, None, :]  # (B, 1, D)
    for i, window in enumerate(cfg.window_array()):
        kc, vc, pc = cache["k"][i], cache["v"][i], cache["pos"][i]

        def attend(q, k, v, kc=kc, vc=vc, pc=pc, window=window):
            kc[rows, :, slot] = k[:, 0].to(kc.dtype)
            vc[rows, :, slot] = v[:, 0].to(vc.dtype)
            pc[rows, slot] = pos
            return nn.attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                pos_q, pc, causal=True, window=window,
                                softcap=cfg.attn_softcap,
                                dense_below=1 << 62)
        h = _block(cfg, h, {name: t[i] for name, t in
                            params["layers"].items()},
                   pos_q, compute_dtype, attend)
    h = nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)
    return _logits(cfg, params, h[:, 0, :]), cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            max_seq: int, *, compute_dtype=torch.bfloat16):
    """Run the prompt (B, S) in one forward; return (the last token's
    logits (B, V) float32, a cache holding its keys and values at slots
    0..S-1, in the compute dtype)."""
    _check_dense(cfg)
    B, S = tokens.shape
    C = cache_len(cfg, max_seq)
    if S > C:
        raise ValueError(f"prefill prompt of {S} tokens is longer than the "
                         f"cache ({C} slots)")
    dev = tokens.device
    positions = torch.arange(S, device=dev).expand(B, S)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, C, cfg.hd)
    kc = torch.zeros(shape, dtype=compute_dtype, device=dev)
    vc = torch.zeros(shape, dtype=compute_dtype, device=dev)
    h = _embed(cfg, params, tokens, compute_dtype)
    for i, window in enumerate(cfg.window_array()):
        def attend(q, k, v, i=i, window=window):
            kc[i, :, :, :S] = k.transpose(1, 2).to(compute_dtype)
            vc[i, :, :, :S] = v.transpose(1, 2).to(compute_dtype)
            return nn.attention(q, k, v, positions, positions, causal=True,
                                window=window, softcap=cfg.attn_softcap)
        h = _block(cfg, h, {name: t[i] for name, t in
                            params["layers"].items()},
                   positions, compute_dtype, attend)
    h = nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)
    ar = torch.arange(C, device=dev)
    pos = torch.where(ar < S, ar, EMPTY_POS).to(torch.int32)
    return _logits(cfg, params, h[:, -1, :]), {
        "k": kc, "v": vc,
        "pos": pos.expand(cfg.n_layers, B, C).contiguous()}


class Decoder(torch.nn.Module):
    """The `nn.Module` view of a parameter dict: the tensors are
    registered as parameters (sharing storage, no copy), `param_tree()`
    returns the nested dict under the reference's names, and `forward`
    is `loss_fn`."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, node in params.items():
            if isinstance(node, dict):
                self.add_module(name, torch.nn.ParameterDict(
                    {k: torch.nn.Parameter(v) for k, v in node.items()}))
            else:
                self.register_parameter(name, torch.nn.Parameter(node))

    def param_tree(self) -> dict:
        tree: dict[str, Any] = dict(self._parameters)
        for name, mod in self._modules.items():
            tree[name] = dict(mod.items())
        return tree

    def forward(self, batch: dict, **kw) -> torch.Tensor:
        return loss_fn(self.cfg, self.param_tree(), batch, **kw)


__all__ = ["Decoder", "EMPTY_POS", "cache_len", "decode_step", "forward_hidden",
           "from_numpy_params", "init_cache", "init_params", "loss_fn",
           "prefill"]
