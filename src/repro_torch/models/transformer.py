"""Decoder-only transformer family: llama, deepseek and qwen (GQA, RoPE,
RMSNorm, SwiGLU, optional QKV bias, tied or separate unembedding), gemma2
(local/global windows, softcaps, post-block norms, GeGLU, the (1+w) norm
offset, sqrt(D) embed scaling), mixtral and arctic (MoE, arctic's
dense-residual hybrid) and qwen2-vl (M-RoPE and the patch-embedding
stub).

Port of `repro/models/transformer.py`, with its KV-cache decode
(`cache_len`, `init_cache`, `decode_step`, `prefill`). Parameters are a
nested dict under the reference's names, with per-layer tensors stacked
on a leading L axis, so the leaves and their shapes are the reference's
and a parameter tree carries across (`from_numpy_params`). `Decoder` is
the `nn.Module` view of such a dict. A config with the GELU MLP or
LayerNorm raises NotImplementedError here: they belong to the
encoder-decoder family (`models/whisper.py`), and the reference's decoder
would silently run SwiGLU and RMSNorm in their place. remat='dots' raises
until item 12.7 (ROADMAP.md, queue 1).

The MoE FFN dispatches the model's tokens in one group: the reference's
`moe_groups=` (one group a data shard) comes back with the data axes of
item 12.7; `moe.moe_ffn(groups=)` already takes it.

`decode_step` writes the new keys, values and positions into the cache
in place (under `torch.inference_mode`) and returns the same dict: a
functional copy would move the whole cache every token.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from .config import ArchConfig
from .moe import moe_ffn

_ROADMAP = "not ported yet (ROADMAP.md, queue 1 item 12.7)"

#: the position of an empty cache slot: causally masked for every query
EMPTY_POS = 1 << 30

#: the cache's recurrent state (none: a KV cache only), which
#: `launch.serve.SlotServer` keeps apart between slots
RECURRENT_STATE: tuple[str, ...] = ()


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not the decoder's; build it "
            "with models.build_model")
    for what, on in ((f"the {cfg.mlp!r} MLP",
                      cfg.mlp not in ("swiglu", "geglu")),
                     (f"the {cfg.norm!r} norm", cfg.norm != "rms")):
        if on:
            raise NotImplementedError(
                f"{what} is not the decoder's (SwiGLU or GeGLU, RMSNorm): "
                "the reference's decoder would silently run SwiGLU and "
                "RMSNorm in its place; it belongs to the encoder-decoder "
                "family (models/whisper.py)")


def _check_positions3(cfg: ArchConfig, positions3) -> None:
    if cfg.mrope_sections is not None and positions3 is None:
        raise ValueError(f"{cfg.name} rotates by M-RoPE: pass positions3, "
                         "the (3, B, S) temporal/height/width positions")


# ---------------------------------------------------------------------------
# Parameter specification
# ---------------------------------------------------------------------------

def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """path -> (shape, init_kind). (The reference's logical sharding axes
    wait for the mesh, ROADMAP.md queue 1 item 11.)"""
    _check_ported(cfg)
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
    if cfg.moe is not None:
        e = cfg.moe
        E, Fe = e.num_experts, e.d_ff_expert
        lyr["router"] = ((L, D, E), "fanin")
        lyr["we_gate"] = ((L, E, D, Fe), "fanin")
        lyr["we_up"] = ((L, E, D, Fe), "fanin")
        lyr["we_down"] = ((L, E, Fe, D), "fanin")
        F = e.dense_residual_ff       # arctic's dense FFN beside the MoE
    if F:
        lyr["w_gate"] = ((L, D, F), "fanin")
        lyr["w_up"] = ((L, D, F), "fanin")
        lyr["w_down"] = ((L, F, D), "fanin")
    s.update({f"layers/{k}": v for k, v in lyr.items()})
    s["final_norm"] = ((D,), "norm")
    if not cfg.tie_embeddings:
        s["unembed"] = ((D, V), "fanin")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn from it in the
    reference's sorted path order (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, kind) in sorted(_spec(cfg).items()):
        if kind == "norm":
            kind = "zeros" if cfg.norm_offset else "ones"
        ptree.assign(params, path, ptree.draw(kind, shape, generator, dtype))
    return params


def from_numpy_params(cfg: ArchConfig, tree: dict, *, device=None,
                      dtype=torch.float32) -> dict:
    """The port's parameter dict from the reference's (numpy arrays under
    the same nested names); every leaf's shape is checked against the
    spec. `device=None` means CUDA."""
    return ptree.from_numpy(_spec(cfg), tree, cfg.name, device=device,
                            dtype=dtype)


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


def _ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor, *,
         full_capacity: bool = False) -> torch.Tensor:
    """FFN (dense / MoE / arctic hybrid) on (B, S, D). `full_capacity`
    disables token dropping (decode: a dropped token would corrupt the
    stream; T is tiny there so the buffer cost is negligible)."""
    mlp = nn.geglu if cfg.mlp == "geglu" else nn.swiglu
    if cfg.moe is None:
        return mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    B, S, D = x.shape
    out = moe_ffn(x.reshape(B * S, D), lp["router"], lp["we_gate"],
                  lp["we_up"], lp["we_down"], cfg.moe,
                  capacity=B * S if full_capacity else None).reshape(B, S, D)
    if cfg.moe.dense_residual_ff:
        out = out + nn.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return out


def _rope(cfg: ArchConfig, x, positions, positions3):
    if cfg.mrope_sections is not None:
        return nn.apply_mrope(x, positions3, sections=cfg.mrope_sections,
                              theta=cfg.rope_theta)
    return nn.apply_rope(x, positions, theta=cfg.rope_theta)


def _block(cfg: ArchConfig, h, lp_raw: dict, positions, compute_dtype,
           attend, *, positions3=None, full_capacity: bool = False):
    """One block on the residual stream h (B, S, D): the parameters cast
    to the compute dtype, q and k rotated at `positions` (B, S) (under
    M-RoPE at `positions3` (3, B, S)), and `attend(q, k, v)` -> (B, S,
    Hq, hd) for the attention itself."""
    B, S, _ = h.shape
    lp = {name: t.to(compute_dtype) for name, t in lp_raw.items()}
    hn = nn.rms_norm(h, lp_raw["norm1"], offset=cfg.norm_offset)
    q, k, v = _qkv(cfg, lp, hn)
    q = _rope(cfg, q, positions, positions3)
    k = _rope(cfg, k, positions, positions3)
    attn = attend(q, k, v).reshape(B, S, cfg.n_heads * cfg.hd) @ lp["wo"]
    if cfg.post_norm:
        attn = nn.rms_norm(attn, lp_raw["norm1_post"], offset=cfg.norm_offset)
    h = h + attn
    hn2 = nn.rms_norm(h, lp_raw["norm2"], offset=cfg.norm_offset)
    ff = _ffn(cfg, lp, hn2, full_capacity=full_capacity)
    if cfg.post_norm:
        ff = nn.rms_norm(ff, lp_raw["norm2_post"], offset=cfg.norm_offset)
    return h + ff


def _layer(cfg: ArchConfig, h, stacked: dict, i: int, window: int,
           positions, compute_dtype, positions3):
    """Block i of the stack on the full sequence h (B, S, D)."""
    def attend(q, k, v):
        return nn.attention(q, k, v, positions, positions, causal=True,
                            window=window, softcap=cfg.attn_softcap)
    return _block(cfg, h, {name: t[i] for name, t in stacked.items()},
                  positions, compute_dtype, attend, positions3=positions3)


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
                   positions3: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None,
                   patch_positions: torch.Tensor | None = None,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing") -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D).

    `patches` (B, P, D) replace the embedded rows at `patch_positions`
    (B, P) (the VLM stub's precomputed patch embeddings); an M-RoPE
    config needs `positions3` (3, B, S). remat='nothing' recomputes each
    block in the backward pass (the reference's
    `jax.checkpoint(nothing_saveable)` around its layer scan); any other
    value but 'dots' stores the activations.
    """
    _check_ported(cfg)
    _check_positions3(cfg, positions3)
    if remat == "dots":
        raise NotImplementedError(f"remat='dots' is {_ROADMAP}")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, compute_dtype)
    if patches is not None:
        h = _put_patches(h, patches, patch_positions)
    for i, window in enumerate(cfg.window_array()):
        args = (cfg, h, params["layers"], i, window, positions,
                compute_dtype, positions3)
        h = nn.remat(_layer, *args) if remat == "nothing" else _layer(*args)
    return nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)


def _put_patches(h, patches, patch_positions):
    """h (B, S, D) with row patch_positions[b, p] of sequence b replaced
    by patches[b, p], in h's dtype. The positions are checked where they
    lie, in one read (the reference's scatter would drop one out of
    range); the steps leave them on the host, so the check reads no
    device."""
    B, S, _ = h.shape
    if patch_positions is None or patch_positions.shape != patches.shape[:2]:
        raise ValueError("patches (B, P, D) need patch_positions (B, P)")
    if patch_positions.numel():
        lo, hi = torch.stack(torch.aminmax(patch_positions)).tolist()
        if not 0 <= lo <= hi < S:
            raise ValueError(f"patch_positions lie outside the sequence's "
                             f"{S} rows")
    idx = patch_positions.to(device=h.device, dtype=torch.int64)
    rows = torch.arange(B, device=h.device)[:, None]
    return h.index_put((rows, idx), patches.to(device=h.device,
                                               dtype=h.dtype))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16,
            remat: str = "nothing") -> torch.Tensor:
    h = forward_hidden(cfg, params, batch["tokens"],
                       positions3=batch.get("positions3"),
                       patches=batch.get("patches"),
                       patch_positions=batch.get("patch_positions"),
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
                positions3: torch.Tensor | None = None,
                compute_dtype=torch.bfloat16):
    """token: (B,) int; pos: (B,) int (each sequence's position);
    positions3: (3, B, 1), an M-RoPE config's rotary positions.

    Writes each layer's new key, value and position into the cache at
    ring slot `pos % C`, in place, and attends over the whole ring. The
    MoE FFN runs at full capacity (no token drops). Returns (logits (B,
    V) float32, cache) -- the same cache dict.
    """
    _check_ported(cfg)
    _check_positions3(cfg, positions3)
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
                   pos_q, compute_dtype, attend, positions3=positions3,
                   full_capacity=True)
    h = nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)
    return _logits(cfg, params, h[:, 0, :]), cache


@torch.inference_mode()
def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            max_seq: int, *, positions3: torch.Tensor | None = None,
            compute_dtype=torch.bfloat16):
    """Run the prompt (B, S) in one forward; return (the last token's
    logits (B, V) float32, a cache holding its keys and values at slots
    0..S-1, in the compute dtype). `positions3` (3, B, S) as in
    `forward_hidden`; like the reference's, it takes no patches."""
    _check_ported(cfg)
    _check_positions3(cfg, positions3)
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
                   positions, compute_dtype, attend, positions3=positions3)
    h = nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)
    ar = torch.arange(C, device=dev)
    pos = torch.where(ar < S, ar, EMPTY_POS).to(torch.int32)
    return _logits(cfg, params, h[:, -1, :]), {
        "k": kc, "v": vc,
        "pos": pos.expand(cfg.n_layers, B, C).contiguous()}


class Decoder(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (the tensors registered
    as parameters, no copy); `param_tree()` returns the nested dict and
    `forward` is `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["Decoder", "EMPTY_POS", "cache_len", "decode_step", "forward_hidden",
           "from_numpy_params", "init_cache", "init_params", "loss_fn",
           "prefill"]
