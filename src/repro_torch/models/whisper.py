"""Whisper-style encoder-decoder (the audio backbone; the conv/mel front
end is a stub: the encoder takes precomputed frame embeddings (B,
encoder_seq, D), which `input_specs` names `frames`).

Port of `repro/models/whisper.py`. LayerNorm, biased projections, GELU
MLPs, MHA (n_kv_heads == n_heads; the key projection has no bias),
sinusoidal positions, the embedding tied with the LM head. The decoder's
cache holds its self-attention keys and values at their positions and
the cross-attention keys and values of the encoder output
(`build_cross_cache`); `decode_step` writes the new key and value in
place (under `torch.inference_mode`) and returns the same dict.
`Whisper` is the `nn.Module` view of a parameter dict.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from .config import ArchConfig

#: the cache's recurrent state (none: self- and cross-attention K/V)
RECURRENT_STATE: tuple[str, ...] = ()


def _attn_spec(D, Hq, hd, lead, prefix=""):
    return {
        f"{prefix}ln_w": (lead + (D,), "ones"),
        f"{prefix}ln_b": (lead + (D,), "zeros"),
        f"{prefix}wq": (lead + (D, Hq * hd), "fanin"),
        f"{prefix}bq": (lead + (Hq * hd,), "zeros"),
        f"{prefix}wk": (lead + (D, Hq * hd), "fanin"),
        f"{prefix}wv": (lead + (D, Hq * hd), "fanin"),
        f"{prefix}bv": (lead + (Hq * hd,), "zeros"),
        f"{prefix}wo": (lead + (Hq * hd, D), "fanin"),
        f"{prefix}bo": (lead + (D,), "zeros"),
    }


def _mlp_spec(D, F, lead):
    return {
        "ln2_w": (lead + (D,), "ones"),
        "ln2_b": (lead + (D,), "zeros"),
        "w_in": (lead + (D, F), "fanin"),
        "b_in": (lead + (F,), "zeros"),
        "w_out": (lead + (F, D), "fanin"),
        "b_out": (lead + (D,), "zeros"),
    }


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """path -> (shape, init_kind), the reference's leaves."""
    D, hd, Hq, F, V = cfg.d_model, cfg.hd, cfg.n_heads, cfg.d_ff, cfg.vocab
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    s: dict[str, tuple] = {"embed": ((V, D), "embed")}
    enc = {**_attn_spec(D, Hq, hd, (Le,)), **_mlp_spec(D, F, (Le,))}
    s.update({f"enc/{k}": v for k, v in enc.items()})
    s["enc_ln_w"] = ((D,), "ones")
    s["enc_ln_b"] = ((D,), "zeros")
    dec = {**_attn_spec(D, Hq, hd, (Ld,)),
           **_attn_spec(D, Hq, hd, (Ld,), prefix="x_"),
           **_mlp_spec(D, F, (Ld,))}
    s.update({f"dec/{k}": v for k, v in dec.items()})
    s["dec_ln_w"] = ((D,), "ones")
    s["dec_ln_b"] = ((D,), "zeros")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, kind) in sorted(_spec(cfg).items()):
        ptree.assign(params, path, ptree.draw(kind, shape, generator, dtype))
    return params


def from_numpy_params(cfg: ArchConfig, tree: dict, *, device=None,
                      dtype=torch.float32) -> dict:
    """The port's parameter dict from the reference's numpy tree, every
    shape checked against the spec. `device=None` means CUDA."""
    return ptree.from_numpy(_spec(cfg), tree, cfg.name, device=device,
                            dtype=dtype)


# ---------------------------------------------------------------------------

def sinusoidal(S: int, D: int, dtype=torch.float32, *,
               device=None) -> torch.Tensor:
    """(S, D): sin of position / 10000^(2j/D) in the first half, cos in
    the second."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def _layer(stacked: dict, i: int, compute_dtype):
    """Layer i's raw leaves, and all of them in the compute dtype."""
    raw = {k: t[i] for k, t in stacked.items()}
    return raw, {k: t.to(compute_dtype) for k, t in raw.items()}


def _project_q(cfg, lp, x, prefix=""):
    B, S, _ = x.shape
    return (x @ lp[f"{prefix}wq"] + lp[f"{prefix}bq"]).reshape(
        B, S, cfg.n_heads, cfg.hd)


def _project_kv(cfg, lp, x, prefix=""):
    """Keys (no bias) and values of x (B, S, D): (B, S, H, hd) each."""
    B, S, _ = x.shape
    k = (x @ lp[f"{prefix}wk"]).reshape(B, S, cfg.n_heads, cfg.hd)
    v = (x @ lp[f"{prefix}wv"] + lp[f"{prefix}bv"]).reshape(
        B, S, cfg.n_heads, cfg.hd)
    return k, v


def _mha(cfg, lp, x_q, x_kv, pos_q, pos_k, *, causal, prefix=""):
    B, Sq, _ = x_q.shape
    q = _project_q(cfg, lp, x_q, prefix)
    k, v = _project_kv(cfg, lp, x_kv, prefix)
    out = nn.attention(q, k, v, pos_q, pos_k, causal=causal)
    return (out.reshape(B, Sq, cfg.n_heads * cfg.hd) @ lp[f"{prefix}wo"]
            + lp[f"{prefix}bo"])


def _mlp(lp_raw, lp, h):
    hn2 = nn.layer_norm(h, lp_raw["ln2_w"], lp_raw["ln2_b"])
    return h + nn.gelu_mlp(hn2, lp["w_in"], lp["b_in"], lp["w_out"],
                           lp["b_out"])


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
           compute_dtype=torch.bfloat16,
           remat: str = "nothing") -> torch.Tensor:
    """frames: (B, Se, D) precomputed frame embeddings (the conv front
    end's stub) -> the encoder output (B, Se, D) in the compute dtype.
    Any remat but 'none' recomputes each layer in the backward pass."""
    B, Se, D = frames.shape
    h = (frames.to(compute_dtype)
         + sinusoidal(Se, D, compute_dtype, device=frames.device)[None])
    pos = _positions(B, Se, frames.device)

    def layer(h, i):
        lp_raw, lp = _layer(params["enc"], i, compute_dtype)
        hn = nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"])
        h = h + _mha(cfg, lp, hn, hn, pos, pos, causal=False)
        return _mlp(lp_raw, lp, h)

    for i in range(cfg.encoder_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
    return nn.layer_norm(h, params["enc_ln_w"], params["enc_ln_b"])


def decode_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  enc_out: torch.Tensor, *, compute_dtype=torch.bfloat16,
                  remat: str = "nothing") -> torch.Tensor:
    """The decoder over a whole sequence (B, S), attending to enc_out (B,
    Se, D): final hidden states (B, S, D)."""
    B, S = tokens.shape
    dev = tokens.device
    h = (params["embed"][tokens.to(torch.int64)].to(compute_dtype)
         + sinusoidal(S, cfg.d_model, compute_dtype, device=dev)[None])
    pos = _positions(B, S, dev)
    pos_e = _positions(B, enc_out.shape[1], dev)
    enc_out = enc_out.to(compute_dtype)

    def layer(h, i):
        lp_raw, lp = _layer(params["dec"], i, compute_dtype)
        hn = nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"])
        h = h + _mha(cfg, lp, hn, hn, pos, pos, causal=True)
        hx = nn.layer_norm(h, lp_raw["x_ln_w"], lp_raw["x_ln_b"])
        h = h + _mha(cfg, lp, hx, enc_out, pos, pos_e, causal=False,
                     prefix="x_")
        return _mlp(lp_raw, lp, h)

    for i in range(cfg.n_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
    return nn.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16,
            remat: str = "nothing") -> torch.Tensor:
    """batch: frames (B, Se, D), tokens and labels (B, S)."""
    enc_out = encode(cfg, params, batch["frames"],
                     compute_dtype=compute_dtype, remat=remat)
    h = decode_hidden(cfg, params, batch["tokens"], enc_out,
                      compute_dtype=compute_dtype, remat=remat)
    return nn.chunked_ce_loss(h, params["embed"].T, batch["labels"])


# ---------------------------------------------------------------------------
# Decode: self-attention KV cache + precomputed cross-attention K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """{"k", "v": (Ld, B, H, max_seq, hd), "xk", "xv": (Ld, B, H, Se,
    hd)}, zeros; `build_cross_cache` fills xk and xv. `device=None`
    means CUDA; 'meta' gives shapes only."""
    dev = resolve_device(device)
    Ld, H, hd, Se = cfg.n_layers, cfg.n_heads, cfg.hd, cfg.encoder_seq
    return {name: torch.zeros((Ld, batch, H, n, hd), dtype=dtype,
                              device=dev)
            for name, n in (("k", max_seq), ("v", max_seq), ("xk", Se),
                            ("xv", Se))}


@torch.inference_mode()
def build_cross_cache(cfg: ArchConfig, params: dict, enc_out: torch.Tensor,
                      cache: dict, *, compute_dtype=torch.bfloat16) -> dict:
    """Every decoder layer's cross-attention keys and values of enc_out
    (B, Se, D), computed in the compute dtype and written into the
    cache's xk and xv in place. Returns the same cache dict."""
    e = enc_out.to(compute_dtype)
    for i in range(cfg.n_layers):
        lp = {k: params["dec"][k][i].to(compute_dtype)
              for k in ("x_wk", "x_wv", "x_bv")}
        xk, xv = _project_kv(cfg, lp, e, prefix="x_")
        cache["xk"][i].copy_(xk.transpose(1, 2))
        cache["xv"][i].copy_(xv.transpose(1, 2))
    return cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """token: (B,) int; pos: (B,) int (each sequence's position). Writes
    each layer's new key and value at `pos`, in place, attends causally
    over the self-attention cache and fully over the cross K/V. Returns
    (logits (B, V) float32, cache), the same dict."""
    B = token.shape[0]
    dev = token.device
    max_seq, Se = cache["k"].shape[3], cache["xk"].shape[3]
    pos = pos.to(device=dev, dtype=torch.int64)
    rows = torch.arange(B, device=dev)
    h = params["embed"][token.to(torch.int64)].to(compute_dtype)[:, None, :]
    # each sequence's own position embedding
    h = h + sinusoidal(max_seq, cfg.d_model, compute_dtype,
                       device=dev)[pos][:, None, :]
    pos_q = pos[:, None]
    pos_k = _positions(B, max_seq, dev)
    pos_e = _positions(B, Se, dev)
    for i in range(cfg.n_layers):
        lp_raw, lp = _layer(params["dec"], i, compute_dtype)
        kc, vc = cache["k"][i], cache["v"][i]
        hn = nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"])
        q = _project_q(cfg, lp, hn)
        k, v = _project_kv(cfg, lp, hn)
        kc[rows, :, pos] = k[:, 0].to(kc.dtype)
        vc[rows, :, pos] = v[:, 0].to(vc.dtype)
        attn = nn.attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                            pos_q, pos_k, causal=True, dense_below=1 << 62)
        # (h + a @ wo) + bo, the reference's order of the bf16 sums
        h = h + attn.reshape(B, 1, -1) @ lp["wo"] + lp["bo"]
        hx = nn.layer_norm(h, lp_raw["x_ln_w"], lp_raw["x_ln_b"])
        qx = _project_q(cfg, lp, hx, prefix="x_")
        attn_x = nn.attention(
            qx, cache["xk"][i].transpose(1, 2).to(compute_dtype),
            cache["xv"][i].transpose(1, 2).to(compute_dtype), pos_q, pos_e,
            causal=False, dense_below=1 << 62)
        h = h + attn_x.reshape(B, 1, -1) @ lp["x_wo"] + lp["x_bo"]
        h = _mlp(lp_raw, lp, h)
    h = nn.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"])
    logits = h[:, 0].to(torch.float32) @ params["embed"].T.to(torch.float32)
    return logits, cache


class Whisper(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["RECURRENT_STATE", "Whisper", "build_cross_cache", "decode_hidden",
           "decode_step", "encode", "from_numpy_params", "init_cache",
           "init_params", "loss_fn", "sinusoidal"]
