"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local MQA
attention in a (rec, rec, attn) pattern.

Port of `repro/models/rglru.py`. RG-LRU (Real-Gated Linear Recurrent
Unit, De et al. 2024):

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          input gate
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The forward runs the linear recurrence as a log-depth doubling scan over
the sequence (about log2 S elementwise passes; the reference's
`associative_scan`); decode is one step on the O(1) state. Layer stack:
L = 3*G + T layers, the (rec, rec, attn) triple repeated over G groups
(parameters stacked on a leading G axis under `groups/`), then T
recurrent tail layers (`tail_{t}/`). `decode_step` writes the recurrent
states and the attention ring buffer into the cache in place (under
`torch.inference_mode`) and returns the same dict. `Griffin` is the
`nn.Module` view of a parameter dict.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from .config import ArchConfig
from .transformer import EMPTY_POS

RGLRU_C = 8.0

#: the cache's recurrent state, which `launch.serve.SlotServer` keeps
#: apart between slots (the attention ring buffer under "attn" is not)
RECURRENT_STATE: tuple[str, ...] = ("rec_a", "rec_b", "tail")


# ---------------------------------------------------------------------------
# Parameter spec
# ---------------------------------------------------------------------------

def _rec_spec(cfg: ArchConfig, lead: tuple[int, ...]):
    D, dr, W = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {
        "norm1": (lead + (D,), "ones"),
        "norm2": (lead + (D,), "ones"),
        "w_x": (lead + (D, dr), "fanin"),
        "w_y": (lead + (D, dr), "fanin"),
        "conv_w": (lead + (W, dr), "fanin"),
        "conv_b": (lead + (dr,), "zeros"),
        "w_a": (lead + (dr, dr), "fanin"),
        "b_a": (lead + (dr,), "zeros"),
        "w_i": (lead + (dr, dr), "fanin"),
        "b_i": (lead + (dr,), "zeros"),
        "lam": (lead + (dr,), "lambda"),
        "w_out": (lead + (dr, D), "fanin"),
        # MLP half of the residual block
        "w_gate": (lead + (D, cfg.d_ff), "fanin"),
        "w_up": (lead + (D, cfg.d_ff), "fanin"),
        "w_down": (lead + (cfg.d_ff, D), "fanin"),
    }


def _attn_spec(cfg: ArchConfig, lead: tuple[int, ...]):
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "norm1": (lead + (D,), "ones"),
        "norm2": (lead + (D,), "ones"),
        "wq": (lead + (D, Hq * hd), "fanin"),
        "wk": (lead + (D, Hkv * hd), "fanin"),
        "wv": (lead + (D, Hkv * hd), "fanin"),
        "wo": (lead + (Hq * hd, D), "fanin"),
        "w_gate": (lead + (D, cfg.d_ff), "fanin"),
        "w_up": (lead + (D, cfg.d_ff), "fanin"),
        "w_down": (lead + (cfg.d_ff, D), "fanin"),
    }


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    """(G groups of (rec, rec, attn), T tail rec layers)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    if pat != ("rec", "rec", "attn"):
        raise ValueError(f"block pattern {pat}: the hybrid family runs "
                         "('rec', 'rec', 'attn')")
    groups = cfg.n_layers // 3
    return groups, cfg.n_layers - 3 * groups


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """path -> (shape, init_kind), the reference's leaves."""
    G, T = _layout(cfg)
    D, V = cfg.d_model, cfg.vocab
    s: dict[str, tuple] = {"embed": ((V, D), "embed")}
    for name, sub in (("rec_a", _rec_spec(cfg, (G,))),
                      ("rec_b", _rec_spec(cfg, (G,))),
                      ("attn", _attn_spec(cfg, (G,)))):
        s.update({f"groups/{name}/{k}": v for k, v in sub.items()})
    for t in range(T):
        s.update({f"tail_{t}/{k}": v for k, v in _rec_spec(cfg, ()).items()})
    s["final_norm"] = ((D,), "ones")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order; Lambda such that a = exp(-c
    softplus(Lambda)) ~ U[0.9, 0.999) (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, kind) in sorted(_spec(cfg).items()):
        if kind == "lambda":
            u = ptree.uniform(shape, generator, 0.9, 0.999, dtype)
            leaf = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
        else:
            leaf = ptree.draw(kind, shape, generator, dtype)
        ptree.assign(params, path, leaf)
    return params


def from_numpy_params(cfg: ArchConfig, tree: dict, *, device=None,
                      dtype=torch.float32) -> dict:
    """The port's parameter dict from the reference's numpy tree, every
    shape checked against the spec. `device=None` means CUDA."""
    return ptree.from_numpy(_spec(cfg), tree, cfg.name, device=device,
                            dtype=dtype)


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _gates(r, lam):
    """(a, sqrt(1 - a^2)) for recurrence gate r, float32."""
    a = torch.exp(-RGLRU_C * F.softplus(lam.to(torch.float32))
                  * r.to(torch.float32))
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, h0: torch.Tensor | None = None):
    """x, r, i: (B, S, dr). Returns (y (B, S, dr), h_last (B, dr)),
    float32. h_t = a_t h_{t-1} + b_t by doubling: after the pass with
    shift s, (A_t, B_t) compose the steps t-2s+1..t, so ceil(log2 S)
    passes give h_t = B_t. An initial state h0 (B, dr) enters as a
    virtual step 0 with a = 0."""
    a, norm = _gates(r, lam)
    b = norm * (i.to(torch.float32) * x.to(torch.float32))
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.to(torch.float32)[:, None, :], b], dim=1)
    S = a.shape[1]
    s = 1
    while s < S:
        # (A, B)_t <- (A_{t-s} A_t, A_t B_{t-s} + B_t); t < s unchanged
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    y = b if h0 is None else b[:, 1:]
    return y, y[:, -1, :]


def rglru_step(x_t, r_t, i_t, lam, h):
    """One decode step; all (B, dr); h (B, dr) float32. Returns (y,
    h_new), the same tensor."""
    a, norm = _gates(r_t, lam)
    h_new = a * h + norm * (i_t.to(torch.float32) * x_t.to(torch.float32))
    return h_new, h_new


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _cast(lp_raw: dict, compute_dtype) -> dict:
    return {k: t.to(compute_dtype) for k, t in lp_raw.items()
            if k not in ("norm1", "norm2", "lam")}


def _mlp(lp_raw, lp, h):
    """The GeGLU half of a residual block."""
    hn2 = nn.rms_norm(h, lp_raw["norm2"])
    return h + nn.geglu(hn2, lp["w_gate"], lp["w_up"], lp["w_down"])


def _rec_block_seq(cfg, lp_raw, lp, h):
    """Recurrent temporal block + MLP residual, full sequence."""
    hn = nn.rms_norm(h, lp_raw["norm1"])
    gx = hn @ lp["w_x"]                                   # (B, S, dr)
    gy = F.gelu(hn @ lp["w_y"], approximate="tanh")
    gx = nn.causal_depthwise_conv1d(gx, lp["conv_w"]) + lp["conv_b"]
    r = torch.sigmoid(gx @ lp["w_a"] + lp["b_a"])
    i = torch.sigmoid(gx @ lp["w_i"] + lp["b_i"])
    y, _ = rglru_scan(gx, r, i, lp_raw["lam"])
    h = h + (y.to(h.dtype) * gy) @ lp["w_out"]
    return _mlp(lp_raw, lp, h)


def _qkv(cfg, lp, hn):
    B, S, _ = hn.shape
    return ((hn @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.hd),
            (hn @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd),
            (hn @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd))


def _window(cfg: ArchConfig) -> int:
    return int(cfg.window_pattern[-1] or EMPTY_POS)


def _attn_block_seq(cfg, lp_raw, lp, h, positions):
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, lp, nn.rms_norm(h, lp_raw["norm1"]))
    q = nn.apply_rope(q, positions, theta=cfg.rope_theta)
    k = nn.apply_rope(k, positions, theta=cfg.rope_theta)
    attn = nn.attention(q, k, v, positions, positions, causal=True,
                        window=_window(cfg))
    h = h + attn.reshape(B, S, -1) @ lp["wo"]
    return _mlp(lp_raw, lp, h)


def _group_params(params: dict, g: int) -> dict:
    return {name: {k: t[g] for k, t in sub.items()}
            for name, sub in params["groups"].items()}


def _embed(cfg: ArchConfig, params: dict, tokens, compute_dtype):
    """Embedding rows times sqrt(D), the scale rounded to the compute
    dtype first (as the reference)."""
    h = params["embed"][tokens.to(torch.int64)].to(compute_dtype)
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing") -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D). Any remat
    but 'none' recomputes each (rec, rec, attn) group in the backward
    pass (the reference's `jax.checkpoint(nothing_saveable)` around its
    group scan); the tail layers store theirs, as the reference's."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, compute_dtype)

    def group(h, g):
        gp_raw = _group_params(params, g)
        gp = {name: _cast(sub, compute_dtype) for name, sub in gp_raw.items()}
        h = _rec_block_seq(cfg, gp_raw["rec_a"], gp["rec_a"], h)
        h = _rec_block_seq(cfg, gp_raw["rec_b"], gp["rec_b"], h)
        return _attn_block_seq(cfg, gp_raw["attn"], gp["attn"], h, positions)

    G, T = _layout(cfg)
    for g in range(G):
        h = group(h, g) if remat == "none" else nn.remat(group, h, g)
    for t in range(T):
        lp_raw = params[f"tail_{t}"]
        h = _rec_block_seq(cfg, lp_raw, _cast(lp_raw, compute_dtype), h)
    return nn.rms_norm(h, params["final_norm"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16,
            remat: str = "nothing") -> torch.Tensor:
    h = forward_hidden(cfg, params, batch["tokens"],
                       compute_dtype=compute_dtype, remat=remat)
    return nn.chunked_ce_loss(h, params["embed"].T, batch["labels"])


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent state + ring-buffer local-attention cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """{"rec_a", "rec_b": {"h": (G, B, dr) float32, "conv": (G, B, W-1,
    dr)}, "tail": the same with T rows, "attn": {"k", "v": (G, B, Hkv,
    C, hd), "pos": (G, B, C) int32}}: zero states and an empty ring
    buffer of C = min(max_seq, window) slots (position `EMPTY_POS`).
    `device=None` means CUDA; 'meta' gives shapes only."""
    dev = resolve_device(device)
    G, T = _layout(cfg)
    dr, W = cfg.rnn_width, cfg.conv_width
    win = min(max_seq, int(cfg.window_pattern[-1] or max_seq))

    def rec_state(n):
        return {"h": torch.zeros((n, batch, dr), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((n, batch, W - 1, dr), dtype=dtype,
                                    device=dev)}
    kv = (G, batch, cfg.n_kv_heads, win, cfg.hd)
    return {
        "rec_a": rec_state(G), "rec_b": rec_state(G),
        "attn": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                 "v": torch.zeros(kv, dtype=dtype, device=dev),
                 "pos": torch.full((G, batch, win), EMPTY_POS,
                                   dtype=torch.int32, device=dev)},
        "tail": rec_state(T),
    }


def _rec_block_step(cfg, lp_raw, lp, h, h_st, conv_st):
    """h: (B, D) one token; h_st (B, dr) and conv_st (B, W-1, dr) are
    the layer's state, advanced in place."""
    hn = nn.rms_norm(h, lp_raw["norm1"])
    gx = hn @ lp["w_x"]
    gy = F.gelu(hn @ lp["w_y"], approximate="tanh")
    gx, conv_new = nn.conv1d_update(gx, conv_st, lp["conv_w"])
    conv_st.copy_(conv_new)
    gx = gx + lp["conv_b"]
    r = torch.sigmoid(gx @ lp["w_a"] + lp["b_a"])
    i = torch.sigmoid(gx @ lp["w_i"] + lp["b_i"])
    y, h_new = rglru_step(gx, r, i, lp_raw["lam"], h_st)
    h_st.copy_(h_new)
    h = h + (y.to(h.dtype) * gy) @ lp["w_out"]
    return _mlp(lp_raw, lp, h)


def _attn_block_step(cfg, lp_raw, lp, h, kc, vc, pc, pos, rows, slot):
    """h: (B, D) one token at positions pos (B,); writes its key, value
    and position into the ring buffer (kc, vc (B, Hkv, C, hd), pc (B,
    C)) at `slot` = pos % C, in place, and attends over the ring."""
    B = h.shape[0]
    q, k, v = _qkv(cfg, lp, nn.rms_norm(h, lp_raw["norm1"])[:, None, :])
    pos_q = pos[:, None]
    q = nn.apply_rope(q, pos_q, theta=cfg.rope_theta)
    k = nn.apply_rope(k, pos_q, theta=cfg.rope_theta)
    kc[rows, :, slot] = k[:, 0].to(kc.dtype)
    vc[rows, :, slot] = v[:, 0].to(vc.dtype)
    pc[rows, slot] = pos
    attn = nn.attention(q, kc.transpose(1, 2), vc.transpose(1, 2), pos_q,
                        pc, causal=True, window=_window(cfg),
                        dense_below=1 << 62)
    h = h + attn.reshape(B, -1) @ lp["wo"]
    return _mlp(lp_raw, lp, h)


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """token: (B,) int; pos: (B,) int (each sequence's position).
    Advances every row's recurrent states one token and writes the
    attention layers' key, value and position at ring slot pos % C, all
    in place. Returns (logits (B, V) float32, cache), the same dict."""
    B = token.shape[0]
    pos = pos.to(device=token.device, dtype=torch.int32)
    C = cache["attn"]["k"].shape[3]
    slot = (pos % C).to(torch.int64)
    rows = torch.arange(B, device=token.device)
    h = _embed(cfg, params, token, compute_dtype)
    G, T = _layout(cfg)
    for g in range(G):
        gp_raw = _group_params(params, g)
        gp = {name: _cast(sub, compute_dtype) for name, sub in gp_raw.items()}
        for name in ("rec_a", "rec_b"):
            h = _rec_block_step(cfg, gp_raw[name], gp[name], h,
                                cache[name]["h"][g], cache[name]["conv"][g])
        at = cache["attn"]
        h = _attn_block_step(cfg, gp_raw["attn"], gp["attn"], h, at["k"][g],
                             at["v"][g], at["pos"][g], pos, rows, slot)
    for t in range(T):
        lp_raw = params[f"tail_{t}"]
        h = _rec_block_step(cfg, lp_raw, _cast(lp_raw, compute_dtype), h,
                            cache["tail"]["h"][t], cache["tail"]["conv"][t])
    h = nn.rms_norm(h, params["final_norm"])
    logits = h.to(torch.float32) @ params["embed"].T.to(torch.float32)
    return logits, cache


class Griffin(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["Griffin", "RECURRENT_STATE", "RGLRU_C", "decode_step",
           "forward_hidden", "from_numpy_params", "init_cache", "init_params",
           "loss_fn", "rglru_scan", "rglru_step"]
