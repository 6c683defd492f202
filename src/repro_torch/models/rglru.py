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

The model axis (`settings.mesh` with 'model' above 1; `launch/tp.py`),
in the reference's layout (`launch.sharding.param_specs`). The recurrent
block: `w_x` and `w_y` are column-parallel over the RG-LRU width, their
blocks the rank's channels; `conv_w`, `conv_b`, `b_a`, `b_i` and `lam`
are split on the same channels; `w_a` and `w_i` (axes ('mlp', 'mlp2'))
hold the rank's rows with whole columns, so each gate product is a
partial sum over every channel, reduce-scattered in float32 onto the
rank's channels (`ModelAxis.scatter`, tag `tp_gate`) before the bias and
the sigmoid; the scan runs on the rank's channels; `w_out` is
row-parallel. The attention block is the decoder's MQA case (one KV
head: `wk`/`wv` read whole, `transformer._heads`), the GeGLU MLP the
decoder's. Under sequence parallelism the residual stream is the rank's
rows between the parallel regions. `decode_step` on the axis holds the
rank's channels of the recurrent states and the rank's positions of the
attention ring (`cache_specs` splits the window's slots: one KV head),
whose partial softmaxes merge over the axis (`transformer._ring_attend`).
Where the specs replicate a part's leaves (a model size that does not
divide the RG-LRU width, the MLP's, or the attention's Hq*hd columns),
that part runs whole on every model rank (`split_parts`;
`ModelAxis.whole_in` / `whole_out` under sequence parallelism), and
`decode_step` holds its state or ring whole.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from . import transformer
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
        "norm1": (lead + (D,), ("layers", None), "ones"),
        "norm2": (lead + (D,), ("layers", None), "ones"),
        "w_x": (lead + (D, dr), ("layers", "embed", "mlp"), "fanin"),
        "w_y": (lead + (D, dr), ("layers", "embed", "mlp"), "fanin"),
        "conv_w": (lead + (W, dr), ("layers", None, "mlp"), "fanin"),
        "conv_b": (lead + (dr,), ("layers", "mlp"), "zeros"),
        "w_a": (lead + (dr, dr), ("layers", "mlp", "mlp2"), "fanin"),
        "b_a": (lead + (dr,), ("layers", "mlp"), "zeros"),
        "w_i": (lead + (dr, dr), ("layers", "mlp", "mlp2"), "fanin"),
        "b_i": (lead + (dr,), ("layers", "mlp"), "zeros"),
        "lam": (lead + (dr,), ("layers", "mlp"), "lambda"),
        "w_out": (lead + (dr, D), ("layers", "mlp", "embed"), "fanin"),
        # MLP half of the residual block
        "w_gate": (lead + (D, cfg.d_ff), ("layers", "embed", "mlp"),
                   "fanin"),
        "w_up": (lead + (D, cfg.d_ff), ("layers", "embed", "mlp"), "fanin"),
        "w_down": (lead + (cfg.d_ff, D), ("layers", "mlp", "embed"),
                   "fanin"),
    }


def _attn_spec(cfg: ArchConfig, lead: tuple[int, ...]):
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "norm1": (lead + (D,), ("layers", None), "ones"),
        "norm2": (lead + (D,), ("layers", None), "ones"),
        "wq": (lead + (D, Hq * hd), ("layers", "embed", "heads"), "fanin"),
        "wk": (lead + (D, Hkv * hd), ("layers", "embed", "heads"), "fanin"),
        "wv": (lead + (D, Hkv * hd), ("layers", "embed", "heads"), "fanin"),
        "wo": (lead + (Hq * hd, D), ("layers", "heads", "embed"), "fanin"),
        "w_gate": (lead + (D, cfg.d_ff), ("layers", "embed", "mlp"),
                   "fanin"),
        "w_up": (lead + (D, cfg.d_ff), ("layers", "embed", "mlp"), "fanin"),
        "w_down": (lead + (cfg.d_ff, D), ("layers", "mlp", "embed"),
                   "fanin"),
    }


def _layout(cfg: ArchConfig) -> tuple[int, int]:
    """(G groups of (rec, rec, attn), T tail rec layers)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    if pat != ("rec", "rec", "attn"):
        raise ValueError(f"block pattern {pat}: the hybrid family runs "
                         "('rec', 'rec', 'attn')")
    groups = cfg.n_layers // 3
    return groups, cfg.n_layers - 3 * groups


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], tuple, str]]:
    """path -> (shape, logical axes, init_kind), the reference's leaves
    and axes (a tail layer's have no "layers" axis)."""
    G, T = _layout(cfg)
    D, V = cfg.d_model, cfg.vocab
    s: dict[str, tuple] = {
        "embed": ((V, D), ("vocab_fsdp", "embed_tp"), "embed")}
    for name, sub in (("rec_a", _rec_spec(cfg, (G,))),
                      ("rec_b", _rec_spec(cfg, (G,))),
                      ("attn", _attn_spec(cfg, (G,)))):
        s.update({f"groups/{name}/{k}": v for k, v in sub.items()})
    for t in range(T):
        s.update({f"tail_{t}/{k}": (shape, ax[1:], kind)
                  for k, (shape, ax, kind) in _rec_spec(cfg, ()).items()})
    s["final_norm"] = ((D,), (None,), "ones")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order; Lambda such that a = exp(-c
    softplus(Lambda)) ~ U[0.9, 0.999) (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, _, kind) in sorted(_spec(cfg).items()):
        if kind == "lambda":
            u = ptree.uniform(shape, generator, 0.9, 0.999, dtype)
            leaf = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
        else:
            leaf = ptree.draw(kind, shape, generator, dtype)
        ptree.assign(params, path, leaf)
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The parameter tree's logical sharding axes, leaf for leaf."""
    return ptree.axes(_spec(cfg))


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

def split_parts(cfg: ArchConfig, mesh) -> dict[str, bool]:
    """Which parts run split over the model axis of `mesh` (the rest
    whole on every model rank), as the specs lay out their leaves: the
    recurrent block where they split the RG-LRU width, the MLP where they
    split d_ff, the attention where they split its Hq*hd columns (inside
    a head, `ModelAxis.head_split`, where the axis does not divide the
    heads), the embedding's lookup where they split its columns."""
    from repro_torch.launch.sharding import model_split
    split = model_split(cfg, mesh)
    return {"rec": "groups/rec_a/w_x" in split,
            "mlp": "groups/rec_a/w_gate" in split,
            "attn": "groups/attn/wq" in split, "embed": "embed" in split}


def model_partial(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """The model-replicated leaves read inside a parallel region of the
    model axis: where the attention runs split, its KV weights if the
    specs replicate them (each rank's query heads take their share; the
    norms are read before a parallel region, a split part's other leaves
    are split too)."""
    from repro_torch.launch.sharding import model_split
    if not split_parts(cfg, mesh)["attn"]:
        return ()
    split = model_split(cfg, mesh)
    return tuple(p for p in ("groups/attn/wk", "groups/attn/wv")
                 if p not in split)


def model_axis(cfg: ArchConfig, seq_parallel: bool = False):
    """The forward's model axis (`launch.tp.ModelAxis`), or None, with the
    parts that run split on it (`split_parts`)."""
    return transformer._model_axis(cfg, seq_parallel, parts=split_parts)



def _cast(lp_raw: dict, compute_dtype) -> dict:
    return {k: t.to(compute_dtype) for k, t in lp_raw.items()
            if k not in ("norm1", "norm2", "lam")}


def _leave(h, x, w, axis, sp: bool):
    """h + x @ w for a row-parallel w: on a model axis the partial sums in
    float32, reduced (`ModelAxis.leave`) and rounded once."""
    if axis is None:
        return h + x @ w
    return h + axis.leave(nn.product_in(x, w, torch.float32), sp).to(h.dtype)


def _mlp(lp_raw, lp, h, axis=None, sp: bool = False):
    """The GeGLU half of a residual block (whole on the rank's rows where
    the MLP runs whole)."""
    hn2 = nn.rms_norm(h, lp_raw["norm2"])
    if transformer._part_axis(axis, "mlp") is None:
        return h + nn.geglu(hn2, lp["w_gate"], lp["w_up"], lp["w_down"])
    ff = nn.geglu(axis.enter(hn2, sp), lp["w_gate"], lp["w_up"],
                  lp["w_down"], acc=torch.float32)
    return h + axis.leave(ff, sp).to(h.dtype)


def _gate(gx, w, axis):
    """gx @ w; on a model axis gx is the rank's channels and w its rows
    (whole columns): the partial sums reduce-scattered in float32 onto
    the rank's channels, rounded once."""
    if axis is None:
        return gx @ w
    return axis.scatter(nn.product_in(gx, w, torch.float32), -1,
                        tag="tp_gate").to(gx.dtype)


def _rec_block_seq(cfg, lp_raw, lp, h, axis=None, sp: bool = False):
    """Recurrent temporal block + MLP residual, full sequence (h the
    rank's rows under sequence parallelism; the gates and the scan on
    the rank's channels of a model axis, or the whole block on the whole
    sequence where it runs whole)."""
    if axis is not None and transformer._part_axis(axis, "rec") is None:
        h = axis.whole_out(_rec_temporal(cfg, lp_raw, lp,
                                         axis.whole_in(h, sp)), sp)
    else:
        h = _rec_temporal(cfg, lp_raw, lp, h, axis, sp)
    return _mlp(lp_raw, lp, h, axis, sp)


def _rec_temporal(cfg, lp_raw, lp, h, axis=None, sp: bool = False):
    """The recurrent temporal block added to h (see `_rec_block_seq`)."""
    hn = nn.rms_norm(h, lp_raw["norm1"])
    if axis is not None:
        hn = axis.enter(hn, sp)
    gx = hn @ lp["w_x"]                                   # (B, S, dr)
    gy = F.gelu(hn @ lp["w_y"], approximate="tanh")
    gx = nn.causal_depthwise_conv1d(gx, lp["conv_w"]) + lp["conv_b"]
    r = torch.sigmoid(_gate(gx, lp["w_a"], axis) + lp["b_a"])
    i = torch.sigmoid(_gate(gx, lp["w_i"], axis) + lp["b_i"])
    y, _ = rglru_scan(gx, r, i, lp_raw["lam"])
    return _leave(h, y.to(h.dtype) * gy, lp["w_out"], axis, sp)


def _qkv(cfg, lp, hn, axis=None):
    """q, k, v (B, S, H, hd) of the heads the leaves hold (every query
    head where the model axis splits inside one, `transformer._qkv`)."""
    B, S, _ = hn.shape
    return (transformer._whole_q(hn @ lp["wq"], axis).reshape(
                B, S, -1, cfg.hd),
            (hn @ lp["wk"]).reshape(B, S, -1, cfg.hd),
            (hn @ lp["wv"]).reshape(B, S, -1, cfg.hd))


def _head_cols(attn, axis):
    """The rank's columns of the attention output for its rows of `wo`
    (`ModelAxis.head_cols`)."""
    return attn if axis is None else axis.head_cols(attn)


def _window(cfg: ArchConfig) -> int:
    return int(cfg.window_pattern[-1] or EMPTY_POS)


def _attn_block_seq(cfg, lp_raw, lp, h, positions, axis=None,
                    sp: bool = False):
    """Local attention + MLP residual, full sequence (the attention on
    the whole sequence where it runs whole)."""
    aax = transformer._part_axis(axis, "attn")
    hn = nn.rms_norm(h, lp_raw["norm1"])
    if aax is not None:
        hn = axis.enter(hn, sp)
    elif axis is not None:
        hn = axis.whole_in(hn, sp)
    B, S, _ = hn.shape
    q, k, v = _qkv(cfg, lp, hn, aax)
    q = nn.apply_rope(q, positions, theta=cfg.rope_theta)
    k = nn.apply_rope(k, positions, theta=cfg.rope_theta)
    q, k, v = transformer._heads(cfg, aax, q, k, v)
    attn = nn.attention(q, k, v, positions, positions, causal=True,
                        window=_window(cfg)).reshape(B, S, -1)
    if aax is None and axis is not None:
        attn = axis.whole_out(attn, sp)
    h = _leave(h, _head_cols(attn, aax), lp["wo"], aax, sp)
    return _mlp(lp_raw, lp, h, axis, sp)


def _group_params(cfg: ArchConfig, params: dict, g: int, gather=None,
                  axis=None) -> dict:
    """Group g's leaves, read through `gather` (`params.take`); on a
    model axis that does not divide the KV heads the attention's `wk` and
    `wv` whole (`Sharded(whole=True)`)."""
    whole = ("wk", "wv") if transformer._kv_whole(cfg, axis) else ()
    if whole and gather is None:
        raise ValueError("a model axis reads its leaves through gather= "
                         "(launch.fsdp.Sharded)")
    out = {}
    for name, sub in params["groups"].items():
        pre = f"groups/{name}/"
        out[name] = {k: gather(pre + k, t, g, whole=True)
                     if name == "attn" and k in whole
                     else ptree.take(gather, pre + k, t, g)
                     for k, t in sub.items()}
    return out


def _embed(cfg: ArchConfig, params: dict, tokens, compute_dtype,
           gather=None, axis=None):
    """Embedding rows times sqrt(D), the scale rounded to the compute
    dtype first (as the reference); on a model axis the lookup of the
    rank's columns gathered to whole rows."""
    h = transformer._lookup(cfg, params, tokens, compute_dtype, gather,
                            axis)
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing", gather=None,
                   seq_parallel: bool = False) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D). Any remat
    but 'none' recomputes each (rec, rec, attn) group in the backward
    pass (the reference's `jax.checkpoint(nothing_saveable)` around its
    group scan); the tail layers store theirs, as the reference's. On a
    mesh the leaves are read through `gather` (`params.take`); on a model
    axis with `seq_parallel` (a sequence the axis divides) the hidden
    states are the rank's rows (B, S/ms, D), else every row."""
    B, S = tokens.shape
    axis = model_axis(cfg, seq_parallel)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, compute_dtype, gather, axis)
    sp = axis is not None and axis.sp(S)
    if sp:
        h = transformer._own_rows(axis, h)

    def group(h, g):
        gp_raw = _group_params(cfg, params, g, gather, axis)
        gp = {name: _cast(sub, compute_dtype) for name, sub in gp_raw.items()}
        h = _rec_block_seq(cfg, gp_raw["rec_a"], gp["rec_a"], h, axis, sp)
        h = _rec_block_seq(cfg, gp_raw["rec_b"], gp["rec_b"], h, axis, sp)
        return _attn_block_seq(cfg, gp_raw["attn"], gp["attn"], h, positions,
                               axis, sp)

    G, T = _layout(cfg)
    for g in range(G):
        h = group(h, g) if remat == "none" else nn.remat(group, h, g)
    for t in range(T):
        lp_raw = ptree.take_all(gather, f"tail_{t}/", params[f"tail_{t}"])
        h = _rec_block_seq(cfg, lp_raw, _cast(lp_raw, compute_dtype), h,
                           axis, sp)
    return nn.rms_norm(h, params["final_norm"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16, remat: str = "nothing",
            gather=None, seq_parallel: bool = False,
            denom: torch.Tensor | None = None) -> torch.Tensor:
    """The mean cross-entropy of the batch's rows (the reference's: no
    loss mask); with `denom` (a mesh's step) their sum over `denom`. On a
    model axis this rank's term of it (`transformer._axis_loss`)."""
    h = forward_hidden(cfg, params, batch["tokens"],
                       compute_dtype=compute_dtype, remat=remat,
                       gather=gather, seq_parallel=seq_parallel)
    axis = model_axis(cfg, seq_parallel)
    if axis is not None:
        return transformer._axis_loss(cfg, params, h, batch["labels"], None,
                                      axis, gather, denom)
    return nn.chunked_ce_loss(h, ptree.take(gather, "embed",
                                            params["embed"]).T,
                              batch["labels"], denom=denom)


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


def _rec_block_step(cfg, lp_raw, lp, h, h_st, conv_st, axis=None):
    """h: (B, D) one token; h_st (B, dr) and conv_st (B, W-1, dr) are
    the layer's state (the rank's channels on a model axis), advanced in
    place. A recurrent block that runs whole holds its state whole."""
    rax = transformer._part_axis(axis, "rec")
    hn = nn.rms_norm(h, lp_raw["norm1"])
    gx = hn @ lp["w_x"]
    gy = F.gelu(hn @ lp["w_y"], approximate="tanh")
    gx, conv_new = nn.conv1d_update(gx, conv_st, lp["conv_w"])
    conv_st.copy_(conv_new)
    gx = gx + lp["conv_b"]
    r = torch.sigmoid(_gate(gx, lp["w_a"], rax) + lp["b_a"])
    i = torch.sigmoid(_gate(gx, lp["w_i"], rax) + lp["b_i"])
    y, h_new = rglru_step(gx, r, i, lp_raw["lam"], h_st)
    h_st.copy_(h_new)
    h = _leave(h, y.to(h.dtype) * gy, lp["w_out"], rax, False)
    return _mlp(lp_raw, lp, h, axis)


def _attn_block_step(cfg, lp_raw, lp, h, kc, vc, pc, ring, axis=None):
    """h: (B, D) one token at the ring's positions; writes its key, value
    and position into the ring buffer (kc, vc (B, Hkv, C, hd), pc (B,
    C); a model axis's block by `cache_specs`) at its slot pos % C, in
    place, and attends over the ring (`transformer._ring_attend`; the
    whole ring where the attention runs whole)."""
    B = h.shape[0]
    aax = transformer._part_axis(axis, "attn")
    q, k, v = _qkv(cfg, lp, nn.rms_norm(h, lp_raw["norm1"])[:, None, :],
                   aax)
    q = nn.apply_rope(q, ring["pos_q"], theta=cfg.rope_theta)
    k = nn.apply_rope(k, ring["pos_q"], theta=cfg.rope_theta)
    attn = transformer._ring_attend(cfg, aax, ring, q, k, v, kc, vc, pc,
                                    _window(cfg))
    h = _leave(h, _head_cols(attn.reshape(B, -1), aax), lp["wo"], aax,
               False)
    return _mlp(lp_raw, lp, h, axis)


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, gather=None,
                cache_layout: str | None = None):
    """token: (B,) int; pos: (B,) int (each sequence's position).
    Advances every row's recurrent states one token and writes the
    attention layers' key, value and position at ring slot pos % C, all
    in place. Returns (logits (B, V) float32, cache), the same dict. On
    a model axis (`settings.mesh`; the leaves read through `gather`) the
    cache is the rank's block by `launch.sharding.cache_specs`: the
    recurrent states' channels, and the ring's slots under
    `cache_layout` 'seq' (else the whole ring)."""
    axis = model_axis(cfg)
    ring = transformer._ring(axis, cache["attn"]["k"].shape[3], token, pos,
                             cache_layout)
    h = _embed(cfg, params, token, compute_dtype, gather, axis)
    G, T = _layout(cfg)
    for g in range(G):
        gp_raw = _group_params(cfg, params, g, gather, axis)
        gp = {name: _cast(sub, compute_dtype) for name, sub in gp_raw.items()}
        for name in ("rec_a", "rec_b"):
            h = _rec_block_step(cfg, gp_raw[name], gp[name], h,
                                cache[name]["h"][g], cache[name]["conv"][g],
                                axis)
        at = cache["attn"]
        h = _attn_block_step(cfg, gp_raw["attn"], gp["attn"], h, at["k"][g],
                             at["v"][g], at["pos"][g], ring, axis)
    for t in range(T):
        lp_raw = ptree.take_all(gather, f"tail_{t}/", params[f"tail_{t}"])
        h = _rec_block_step(cfg, lp_raw, _cast(lp_raw, compute_dtype), h,
                            cache["tail"]["h"][t], cache["tail"]["conv"][t],
                            axis)
    h = nn.rms_norm(h, params["final_norm"])
    return transformer._logits(cfg, params, h, gather, axis), cache


class Griffin(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["Griffin", "RECURRENT_STATE", "RGLRU_C", "decode_step",
           "forward_hidden", "from_numpy_params", "init_cache", "init_params",
           "loss_fn", "model_axis", "model_partial", "rglru_scan",
           "rglru_step", "split_parts"]
