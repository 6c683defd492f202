"""Decoder-only transformer, the dense family (llama-style: GQA, RoPE,
RMSNorm, SwiGLU, optional QKV bias, tied or separate unembedding).

Port of the dense path of `repro/models/transformer.py`. Parameters are a
nested dict under the reference's names, with per-layer tensors stacked
on a leading L axis, so the leaves and their shapes are the reference's
and a parameter tree carries across (`from_numpy_params`). `Decoder` is
the `nn.Module` view of such a dict. MoE, M-RoPE, patch embeddings and
post-block norms raise NotImplementedError until their slice lands
(ROADMAP.md, queue 1 item 12).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device

from . import layers as nn
from .config import ArchConfig

_ROADMAP = "not ported yet (ROADMAP.md, queue 1 item 12)"


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(f"the {cfg.family!r} family is {_ROADMAP}")
    for what, on in (("MoE", cfg.moe is not None),
                     ("M-RoPE", cfg.mrope_sections is not None),
                     ("post-block norms", cfg.post_norm),
                     (f"the {cfg.mlp!r} MLP", cfg.mlp != "swiglu"),
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


def _layer(cfg: ArchConfig, h, stacked: dict, i: int, window: int,
           positions, compute_dtype):
    """Block i of the stack on the residual stream h (B, S, D)."""
    B, S, _ = h.shape
    lp_raw = {name: t[i] for name, t in stacked.items()}
    lp = {name: t.to(compute_dtype) for name, t in lp_raw.items()}
    hn = nn.rms_norm(h, lp_raw["norm1"], offset=cfg.norm_offset)
    q, k, v = _qkv(cfg, lp, hn)
    q = nn.apply_rope(q, positions, theta=cfg.rope_theta)
    k = nn.apply_rope(k, positions, theta=cfg.rope_theta)
    attn = nn.attention(q, k, v, positions, positions, causal=True,
                        window=window, softcap=cfg.attn_softcap)
    h = h + attn.reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"]
    hn2 = nn.rms_norm(h, lp_raw["norm2"], offset=cfg.norm_offset)
    return h + nn.swiglu(hn2, lp["w_gate"], lp["w_up"], lp["w_down"])


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
    h = params["embed"][tokens.to(torch.int64)].to(compute_dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
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


__all__ = ["Decoder", "forward_hidden", "from_numpy_params", "init_params",
           "loss_fn"]
