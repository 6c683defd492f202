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
would silently run SwiGLU and RMSNorm in their place.

The training forward takes the reference's `moe_groups=` (the MoE FFN
dispatches its tokens in that many contiguous groups; on a data mesh one
group a data shard, `launch.steps.moe_groups_for`) and `gather=`: on a
mesh a layer's leaves are read through the mesh's gather
(`launch.fsdp.Sharded`), which puts their data blocks back together for
that layer alone and reduces the gradient back to the blocks.

The model axis (`settings.mesh` with 'model' above 1, read once at the
forward's entry; `launch/tp.py`): every leaf is the rank's model block.
`wq`/`wk`/`wv` (and their biases) are column-parallel over heads, `wo`
row-parallel, `w_gate`/`w_up` column-parallel over the MLP's hidden dim
and `w_down` row-parallel; the MoE's experts (or, where E does not
divide the axis, each expert's hidden dim) are split over it
(`models/moe.py`). A part whose leaves the specs replicate runs whole
on every model rank (`split_parts`): the attention where the axis does
not divide Hq*hd, the dense FFN where it does not divide d_ff, the MoE
where it divides neither E nor the experts' F, the untied unembedding
where it does not divide the vocabulary (`ModelAxis.whole_in` /
`whole_out`; nothing of it is reduced over the axis). The residual
stream is the rank's sequence rows between the parallel regions
(`seq_parallel=True`, the reference's default; the norms run on those
rows), gathered before each column-parallel product and reduced onto
them after each row-parallel one. Split attention runs on the rank's
query heads over the whole sequence, rotated at the gathered sequence's
own positions. Where the axis does not divide the KV heads, the layer
reads `wk`/`wv`/`bk`/`bv` whole (`Sharded(whole=True)`, or as the
replicated leaves they are where the specs do not split them, their
gradients partial: `model_partial`) and takes the KV heads its query
heads read (`layers.local_kv`; `settings.gqa_expand` expands them
first). The
embedding's lookup on the rank's columns is gathered to whole rows and
the patches are scattered before the stream is split. The loss: an
untied unembedding's cross-entropy over its vocabulary blocks
(`layers.vocab_parallel_ce_loss`), else over the whole vocabulary of the
rank's own rows (a tied embedding gathered whole), or of every row on
every rank counted once where the rows do not split (`_axis_loss`);
`denom=` divides by the step's count over every rank's rows.
`decode_step` on a model axis (no sequence parallelism) holds the rank's
KV heads of the cache, or, where the axis does not divide them, the
rank's positions of every head (`cache_layout="seq"`,
`launch.sharding.cache_specs`), whose partial softmaxes merge over the
axis (`layers.attention_over_ranks`), or the whole cache where the
attention runs whole.

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
from . import settings
from .config import ArchConfig
from .moe import moe_capacity, moe_ffn

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

def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], tuple, str]]:
    """path -> (shape, logical axes, init_kind), the reference's leaves and
    axes (`launch.sharding.axis_rules` maps the axes onto a mesh)."""
    _check_ported(cfg)
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv, F, V, L = (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
                        cfg.n_layers)
    s: dict[str, tuple] = {}
    s["embed"] = ((V, D), ("vocab_fsdp", "embed_tp"), "embed")
    lyr = {
        "norm1": ((L, D), ("layers", None), "norm"),
        "norm2": ((L, D), ("layers", None), "norm"),
        "wq": ((L, D, Hq * hd), ("layers", "embed", "heads"), "fanin"),
        "wk": ((L, D, Hkv * hd), ("layers", "embed", "heads"), "fanin"),
        "wv": ((L, D, Hkv * hd), ("layers", "embed", "heads"), "fanin"),
        "wo": ((L, Hq * hd, D), ("layers", "heads", "embed"), "fanin"),
    }
    if cfg.qkv_bias:
        lyr["bq"] = ((L, Hq * hd), ("layers", "heads"), "zeros")
        lyr["bk"] = ((L, Hkv * hd), ("layers", "heads"), "zeros")
        lyr["bv"] = ((L, Hkv * hd), ("layers", "heads"), "zeros")
    if cfg.post_norm:
        lyr["norm1_post"] = ((L, D), ("layers", None), "norm")
        lyr["norm2_post"] = ((L, D), ("layers", None), "norm")
    if cfg.moe is not None:
        e = cfg.moe
        E, Fe = e.num_experts, e.d_ff_expert
        lyr["router"] = ((L, D, E), ("layers", "embed", None), "fanin")
        lyr["we_gate"] = ((L, E, D, Fe),
                          ("layers", "experts", "embed", "expert_mlp"),
                          "fanin")
        lyr["we_up"] = ((L, E, D, Fe),
                        ("layers", "experts", "embed", "expert_mlp"), "fanin")
        lyr["we_down"] = ((L, E, Fe, D),
                          ("layers", "experts", "expert_mlp", "embed"),
                          "fanin")
        F = e.dense_residual_ff       # arctic's dense FFN beside the MoE
    if F:
        lyr["w_gate"] = ((L, D, F), ("layers", "embed", "mlp"), "fanin")
        lyr["w_up"] = ((L, D, F), ("layers", "embed", "mlp"), "fanin")
        lyr["w_down"] = ((L, F, D), ("layers", "mlp", "embed"), "fanin")
    s.update({f"layers/{k}": v for k, v in lyr.items()})
    s["final_norm"] = ((D,), (None,), "norm")
    if not cfg.tie_embeddings:
        s["unembed"] = ((D, V), ("embed", "vocab"), "fanin")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn from it in the
    reference's sorted path order (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, _, kind) in sorted(_spec(cfg).items()):
        if kind == "norm":
            kind = "zeros" if cfg.norm_offset else "ones"
        ptree.assign(params, path, ptree.draw(kind, shape, generator, dtype))
    return params


def param_axes(cfg: ArchConfig) -> dict:
    """The parameter tree's logical sharding axes, leaf for leaf."""
    return ptree.axes(_spec(cfg))


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

def split_parts(cfg: ArchConfig, mesh) -> dict[str, bool]:
    """Which parts of a block run split over the model axis of `mesh`
    (the rest whole on every model rank), as the specs lay their leaves
    out (`launch.sharding.model_split`): the attention where they split
    `wq` (and `wo`, on the same Hq*hd), the dense FFN where they split
    d_ff, the MoE where they split the experts or their F columns, the
    unembedding where they split the vocabulary, the embedding's lookup
    where they split its columns."""
    from repro_torch.launch.sharding import model_split
    split = model_split(cfg, mesh)
    return {"attn": "layers/wq" in split, "ffn": "layers/w_gate" in split,
            "moe": "layers/we_gate" in split, "unembed": "unembed" in split,
            "embed": "embed" in split}


def model_partial(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """The model-replicated leaves the forward reads inside a parallel
    region of the model axis, whose gradients are partial over it with or
    without sequence parallelism (`launch.fsdp.Sharded(partial=)`): the
    MoE router where the experts run split, and where the attention runs
    split the KV leaves the specs replicate (read on every rank, each
    rank's query heads taking their share)."""
    from repro_torch.launch.sharding import model_split
    parts, split = split_parts(cfg, mesh), model_split(cfg, mesh)
    out = ("layers/router",) if cfg.moe is not None and parts["moe"] else ()
    if parts["attn"]:
        out += tuple(p for p in (f"layers/{k}" for k in ("wk", "wv", "bk",
                                                          "bv"))
                     if p in _spec(cfg) and p not in split)
    return out


def _model_axis(cfg: ArchConfig, seq_parallel: bool = False, *,
                parts=split_parts):
    """The forward's model axis (`launch.tp.ModelAxis`) from the settings'
    mesh, or None, with the parts of the family that run split on it
    (`parts(cfg, mesh)`, its `split_parts`). Split attention whose heads
    the axis does not divide splits inside a head, in the reference's
    column blocks of `wq` (`ModelAxis.head_split`). Every family reads its
    axis here."""
    mesh = settings.get().mesh
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return None
    from repro_torch.launch.tp import ModelAxis
    axis = ModelAxis.from_settings(seq_parallel=seq_parallel)
    axis.parts = parts(cfg, mesh)
    if axis.runs_split("attn") and cfg.n_heads % axis.size:
        axis.split_heads(cfg.n_heads, cfg.hd)
    return axis


def model_axis(cfg: ArchConfig, seq_parallel: bool = False):
    """The forward's model axis (`launch.tp.ModelAxis`), or None; each
    family has one (`models.<family>.model_axis`)."""
    return _model_axis(cfg, seq_parallel)


def _part_axis(axis, part: str):
    """The model axis as a family's `part` sees it (`split_parts`): None
    where the part runs whole, or off a model axis. Every family reads
    its parts' axes here."""
    return axis if axis is not None and axis.runs_split(part) else None


def _kv_whole(cfg: ArchConfig, axis) -> bool:
    """Whether the layer reads the KV weights whole: split attention on a
    model axis that does not divide the KV heads."""
    axis = _part_axis(axis, "attn")
    return axis is not None and cfg.n_kv_heads % axis.size != 0


def _layer_params(cfg: ArchConfig, gather, stacked: dict, i: int, axis
                  ) -> dict:
    """Layer i's leaves (see `params.take`); on a model axis that does not
    divide the KV heads, `wk`/`wv`/`bk`/`bv` whole."""
    whole = ("wk", "wv", "bk", "bv") if _kv_whole(cfg, axis) else ()
    if whole and gather is None:
        raise ValueError("a model axis reads its leaves through gather= "
                         "(launch.fsdp.Sharded)")
    return {k: gather(f"layers/{k}", t, i, whole=True) if k in whole
            else ptree.take(gather, f"layers/{k}", t, i)
            for k, t in stacked.items()}


def _qkv(cfg: ArchConfig, lp: dict, x: torch.Tensor, axis=None):
    """q, k, v (B, S, H, hd) of the heads the leaves hold (a model axis:
    the rank's query heads, and its KV heads or every one; one that
    splits inside a head: every query head, the rank's block of q's
    columns all-gathered)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (_whole_q(q, axis).reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def _whole_q(q: torch.Tensor, axis) -> torch.Tensor:
    """q's columns of every head from the rank's block where the model
    axis splits inside a head (tag `tp_heads`; the backward
    reduce-scatters the ranks' partial gradients onto the blocks)."""
    if axis is None or axis.head_split is None:
        return q
    return axis.cols(q, tag="tp_heads")


def _ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor, *, moe_groups: int = 1,
         full_capacity: bool = False, axis=None, sp: bool = False
         ) -> torch.Tensor:
    """FFN (dense / MoE / arctic hybrid) on (B, S, D); the MoE dispatches
    the B*S tokens in `moe_groups` contiguous groups. `full_capacity`
    disables token dropping (decode: a dropped token would corrupt the
    stream; T is tiny there so the buffer cost is negligible). On a
    model axis x is the rank's rows under sequence parallelism (`sp`):
    the parts that run split enter the axis and their partial sums, in
    float32, leave it reduced and rounded once (see `_block`); a part that
    runs whole takes x as it is (the dense FFN, row by row) or the whole
    sequence (the MoE, whose capacity counts every row), and nothing of
    it is reduced."""
    if axis is None:
        return _ffn_parts(cfg, lp, x, moe_groups, full_capacity)
    moe = cfg.moe is not None
    dense = not moe or bool(cfg.moe.dense_residual_ff)
    split = [p for p, on in (("moe", moe), ("ffn", dense))
             if on and axis.runs_split(p)]
    out = None
    if split:
        out = axis.leave(_ffn_parts(
            cfg, lp, axis.enter(x, sp), moe_groups, full_capacity, axis,
            parts=split), sp).to(x.dtype)
    if moe and "moe" not in split:
        w = axis.whole_out(_ffn_parts(cfg, lp, axis.whole_in(x, sp),
                                      moe_groups, full_capacity,
                                      parts=("moe",)), sp)
        out = w if out is None else out + w
    if dense and "ffn" not in split:
        w = _ffn_parts(cfg, lp, x, moe_groups, full_capacity,
                       parts=("ffn",))
        out = w if out is None else out + w
    return out


def _ffn_parts(cfg: ArchConfig, lp: dict, x: torch.Tensor, moe_groups: int,
               full_capacity: bool, axis=None, parts=("moe", "ffn")
               ) -> torch.Tensor:
    """The sum of the FFN's `parts` ('moe', 'ffn': arctic's dense FFN
    beside the MoE, or a dense model's) on x; on a model `axis` (the
    parts that run split) the rank's partial sum, in float32."""
    mlp = nn.geglu if cfg.mlp == "geglu" else nn.swiglu
    acc = torch.float32 if axis is not None else None
    if cfg.moe is None:
        return mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"], acc=acc)
    if "moe" not in parts:
        return nn.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"], acc=acc)
    B, S, D = x.shape
    G = max(moe_groups, 1)
    cap = B * S // G if full_capacity else None
    E = cfg.moe.num_experts
    experts = c_axis = None
    if axis is not None and lp["we_gate"].shape[0] != E:    # experts split
        per = lp["we_gate"].shape[0]
        experts = (axis.index * per, (axis.index + 1) * per)
    elif axis is not None and axis.moe_c_shard:
        C = cap if cap is not None else moe_capacity(cfg.moe, B * S // G)
        c_axis = axis if C % axis.size == 0 else None
    out = moe_ffn(x.reshape(B * S, D), lp["router"], lp["we_gate"],
                  lp["we_up"], lp["we_down"], cfg.moe, groups=G,
                  capacity=cap, experts=experts, c_axis=c_axis, acc=acc
                  ).reshape(B, S, D)
    if cfg.moe.dense_residual_ff and "ffn" in parts:
        out = out + nn.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"],
                              acc=acc)
    return out


def _rope(cfg: ArchConfig, x, positions, positions3):
    if cfg.mrope_sections is not None:
        return nn.apply_mrope(x, positions3, sections=cfg.mrope_sections,
                              theta=cfg.rope_theta)
    return nn.apply_rope(x, positions, theta=cfg.rope_theta)


def _block(cfg: ArchConfig, h, lp_raw: dict, positions, compute_dtype,
           attend, *, positions3=None, moe_groups: int = 1,
           full_capacity: bool = False, axis=None, sp: bool = False):
    """One block on the residual stream h (B, S, D): the parameters cast
    to the compute dtype, q and k rotated at `positions` (B, S) (under
    M-RoPE at `positions3` (3, B, S)), and `attend(q, k, v)` -> (B, S,
    Hq, hd) for the attention itself. On a model `axis` h is the rank's
    rows under sequence parallelism (`sp`), positions the whole
    sequence's, and `attend` gets the rank's query heads (every head where
    the attention runs whole). There the row-parallel products (`wo`, the
    FFN's down product) keep their sums in float32 on the compute dtype's
    operands (`nn.product_in`), their partial sums are reduced in float32
    and rounded once, as one device's product rounds its sum."""
    lp = {name: t.to(compute_dtype) for name, t in lp_raw.items()}
    hn = nn.rms_norm(h, lp_raw["norm1"], offset=cfg.norm_offset)
    split = _part_axis(axis, "attn") is not None
    if axis is not None:
        hn = axis.enter(hn, sp) if split else axis.whole_in(hn, sp)
    B, S, _ = hn.shape
    q, k, v = _qkv(cfg, lp, hn, _part_axis(axis, "attn"))
    q = _rope(cfg, q, positions, positions3)
    k = _rope(cfg, k, positions, positions3)
    attn = attend(q, k, v)
    attn = attn.reshape(B, S, attn.shape[2] * cfg.hd)
    if split:
        attn = axis.leave(nn.product_in(axis.head_cols(attn), lp["wo"],
                                        torch.float32), sp).to(attn.dtype)
    else:
        if axis is not None:
            attn = axis.whole_out(attn, sp)
        attn = attn @ lp["wo"]
    if cfg.post_norm:
        attn = nn.rms_norm(attn, lp_raw["norm1_post"], offset=cfg.norm_offset)
    h = h + attn
    hn2 = nn.rms_norm(h, lp_raw["norm2"], offset=cfg.norm_offset)
    ff = _ffn(cfg, lp, hn2, moe_groups=moe_groups,
              full_capacity=full_capacity, axis=axis, sp=sp)
    if cfg.post_norm:
        ff = nn.rms_norm(ff, lp_raw["norm2_post"], offset=cfg.norm_offset)
    return h + ff


def _heads(cfg: ArchConfig, axis, q, k, v):
    """The query heads the rank attends with (`ModelAxis.rank_heads`) and
    the KV heads they read, from q, k, v as `_qkv` gave them (a model
    axis that does not divide the KV heads: every one)."""
    if not _kv_whole(cfg, axis):
        return q, k, v
    span = axis.head_split[:2] if axis.head_split is not None else None
    return (axis.rank_heads(q),) + nn.local_kv(
        k, v, cfg.n_heads, axis.size, axis.index, expand=axis.gqa_expand,
        span=span)


def _layer(cfg: ArchConfig, h, stacked: dict, i: int, window: int,
           positions, compute_dtype, positions3, moe_groups: int = 1,
           gather=None, axis=None, sp: bool = False):
    """Block i of the stack on the sequence h (B, S, D) (the rank's rows
    under sequence parallelism), its leaves read through `gather` (see
    `params.take`)."""
    def attend(q, k, v):
        q, k, v = _heads(cfg, axis, q, k, v)
        return nn.attention(q, k, v, positions, positions, causal=True,
                            window=window, softcap=cfg.attn_softcap)
    return _block(cfg, h, _layer_params(cfg, gather, stacked, i, axis),
                  positions, compute_dtype, attend, positions3=positions3,
                  moe_groups=moe_groups, axis=axis, sp=sp)


def _unembed(cfg: ArchConfig, params: dict, gather=None) -> torch.Tensor:
    if cfg.tie_embeddings:
        return ptree.take(gather, "embed", params["embed"]).T
    return ptree.take(gather, "unembed", params["unembed"])


def _lookup(cfg: ArchConfig, params: dict, tokens, compute_dtype,
            gather=None, axis=None):
    """The embedding's rows of the tokens (..., D) in the compute dtype;
    on a model axis the lookup of the rank's columns of the table,
    gathered to whole rows. Every family embeds its tokens here."""
    table = ptree.take(gather, "embed", params["embed"])
    h = table[tokens.to(torch.int64)].to(compute_dtype)
    if axis is not None and table.shape[1] != cfg.d_model:
        h = axis.gather_cols(h)
    return h


def _own_rows(axis, h):
    """The rank's rows of the embedded stream (B, S, D) under sequence
    parallelism: `ModelAxis.split` where the lookup's columns were
    gathered (the gradient of h alike on every rank), a slice where the
    embedding is replicated (its gradient then each rank's own rows'
    share, summed over 'model' with the other replicated leaves'). Every
    family splits its stream here."""
    return axis.split(h) if axis.runs_split("embed") else axis.own_rows(h)


def _embed(cfg: ArchConfig, params: dict, tokens, compute_dtype,
           gather=None, axis=None):
    """The embedded tokens (..., D) (`_lookup`), times sqrt(D) where the
    config scales them."""
    h = _lookup(cfg, params, tokens, compute_dtype, gather, axis)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    return h


def _logits(cfg: ArchConfig, params: dict, h, gather=None, axis=None
            ) -> torch.Tensor:
    """float32 logits of final hidden states h (B, D), soft-capped; on a
    model axis h is every rank's alike, and the logits are put together
    from the rank's vocabulary block (untied) or summed from its columns
    of the embedding (tied)."""
    h = h.to(torch.float32)
    if axis is None:
        logits = h @ _unembed(cfg, params, gather).to(torch.float32)
    elif cfg.tie_embeddings:
        table = ptree.take(gather, "embed", params["embed"])
        lo = axis.index * table.shape[1] if table.shape[1] != cfg.d_model \
            else None
        if lo is None:
            logits = h @ table.to(torch.float32).T
        else:
            logits = axis.all_reduce(h[:, lo:lo + table.shape[1]]
                                     @ table.to(torch.float32).T)
    else:
        w = ptree.take(gather, "unembed", params["unembed"])
        logits = h @ w.to(torch.float32)
        if w.shape[1] != cfg.vocab:
            logits = axis.all_gather(logits, 1, tag="tp_logits")
    return nn.soft_cap(logits, cfg.final_softcap)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   positions: torch.Tensor | None = None,
                   positions3: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None,
                   patch_positions: torch.Tensor | None = None,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing", moe_groups: int = 1,
                   gather=None, seq_parallel: bool = False) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D).

    `patches` (B, P, D) replace the embedded rows at `patch_positions`
    (B, P) (the VLM stub's precomputed patch embeddings); an M-RoPE
    config needs `positions3` (3, B, S). remat='nothing' recomputes each
    block in the backward pass (the reference's
    `jax.checkpoint(nothing_saveable)` around its layer scan), 'dots'
    keeps the weight products' outputs and recomputes the rest
    (`checkpoint_dots_with_no_batch_dims`), any other value stores the
    activations. `moe_groups` and `gather` as in the module docstring.
    On a model axis with `seq_parallel` (a sequence the axis divides) the
    hidden states are the rank's rows (B, S/ms, D), else every row.
    """
    _check_ported(cfg)
    _check_positions3(cfg, positions3)
    axis = _model_axis(cfg, seq_parallel)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = _embed(cfg, params, tokens, compute_dtype, gather, axis)
    if patches is not None:
        h = _put_patches(h, patches, patch_positions)
    sp = axis is not None and axis.sp(S)
    if sp:
        h = _own_rows(axis, h)
    wrap = {"nothing": nn.remat, "dots": nn.remat_dots}.get(remat)
    for i, window in enumerate(cfg.window_array()):
        args = (cfg, h, params["layers"], i, window, positions,
                compute_dtype, positions3, moe_groups, gather, axis, sp)
        h = wrap(_layer, *args) if wrap is not None else _layer(*args)
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
            compute_dtype=torch.bfloat16, remat: str = "nothing",
            moe_groups: int = 1, gather=None, seq_parallel: bool = False,
            denom: torch.Tensor | None = None) -> torch.Tensor:
    """The mean cross-entropy of the batch's rows; with `denom` (a mesh's
    step) their masked sum over `denom`, the step's count over every
    rank's rows. On a model axis this rank's term of it: the terms'
    sum over the axis is the rows' loss (see the module docstring)."""
    h = forward_hidden(cfg, params, batch["tokens"],
                       positions3=batch.get("positions3"),
                       patches=batch.get("patches"),
                       patch_positions=batch.get("patch_positions"),
                       compute_dtype=compute_dtype, remat=remat,
                       moe_groups=moe_groups, gather=gather,
                       seq_parallel=seq_parallel)
    labels, mask = batch["labels"], batch.get("loss_mask")
    axis = _model_axis(cfg, seq_parallel)
    if axis is None:
        return nn.chunked_ce_loss(h, _unembed(cfg, params, gather), labels,
                                  softcap=cfg.final_softcap, mask=mask,
                                  denom=denom)
    return _axis_loss(cfg, params, h, labels, mask, axis, gather, denom)


def _axis_loss(cfg: ArchConfig, params: dict, h, labels, mask, axis,
               gather, denom):
    """The loss's term on a model axis from the final hidden states h
    (the rank's rows under sequence parallelism, else every row; see
    `loss_fn`): an untied unembedding's cross-entropy over its vocabulary
    blocks where the specs split the vocabulary; else over the whole
    vocabulary (a tied embedding gathered whole): of the rank's own rows
    (under sequence parallelism, or the tied embedding's split rows where
    the axis divides B*S), or of every row on every rank, counted once.
    Every family's loss on a model axis is taken here."""
    if gather is None:
        raise ValueError("a model axis reads its leaves through gather= "
                         "(launch.fsdp.Sharded)")
    B, S = labels.shape
    if denom is None:
        denom = torch.clamp(mask.to(torch.float32).sum() if mask is not None
                            else torch.tensor(float(B * S)), min=1.0)
    sp = axis.sp(S)
    if not cfg.tie_embeddings and axis.runs_split("unembed"):
        return nn.vocab_parallel_ce_loss(
            axis.enter(h, sp), gather("unembed", params["unembed"]), labels,
            axis, softcap=cfg.final_softcap, mask=mask, denom=denom)
    name = "embed" if cfg.tie_embeddings else "unembed"
    rows = cfg.tie_embeddings and axis.runs_split("embed") and \
        (B * S) % axis.size == 0
    if sp:      # the rank's own rows
        from repro_torch.launch.sharding import seq_rows
        lo, hi = seq_rows(S, axis.mesh)
        labels = labels[:, lo:hi]
        mask = mask[:, lo:hi] if mask is not None else None
    elif rows:  # the rank's block of the B*S rows
        h = axis.split(h.reshape(1, B * S, -1))
        per = B * S // axis.size
        mine = slice(axis.index * per, (axis.index + 1) * per)
        labels = labels.reshape(1, B * S)[:, mine]
        mask = mask.reshape(1, B * S)[:, mine] if mask is not None else None
    own = sp or rows    # else every row, alike on every rank
    w = gather(name, params[name], whole=True, partial=own)
    loss = nn.chunked_ce_loss(h, w.T if cfg.tie_embeddings else w, labels,
                              softcap=cfg.final_softcap, mask=mask,
                              denom=denom)
    return loss if own else axis.once(loss)


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


def _ring(axis, cl: int, token, pos, cache_layout):
    """One decode step's ring-buffer bookkeeping over a cache of `cl`
    slots (the rank's, under `cache_layout` 'seq'): the positions, each
    row's slot `pos % C` and whether this rank holds it."""
    if cache_layout not in (None, "heads", "seq"):
        raise ValueError(f"unknown cache_layout {cache_layout!r}")
    seq = axis is not None and cache_layout == "seq"
    C = cl * axis.size if seq else cl
    c0 = axis.index * cl if seq else 0
    pos = pos.to(device=token.device, dtype=torch.int32)
    slot = (pos % C).to(torch.int64)
    mine = (slot >= c0) & (slot < c0 + cl)                # this rank's slot
    return {"seq": seq, "pos": pos, "pos_q": pos[:, None],
            "slot": torch.where(mine, slot - c0, 0), "mine": mine,
            "rows": torch.arange(token.shape[0], device=token.device)}


def _ring_attend(cfg: ArchConfig, axis, ring: dict, q, k, v, kc, vc, pc,
                 window):
    """Write one token's key, value and position (k, v (B, 1, Hkv, hd))
    into a layer's ring (kc, vc (B, Hkv, C, hd), pc (B, C)) at its slot,
    in place, and attend the rank's query heads q over the ring. Under
    the 'seq' layout only the rank whose slots hold the position writes,
    and the ranks' partial softmaxes merge (`nn.attention_over_ranks`)."""
    rows, slot, mine, pos = ring["rows"], ring["slot"], ring["mine"], \
        ring["pos"]
    if ring["seq"]:     # only the rank whose slots hold pos % C writes
        # (the other rows write slot 0's own values back: no write depends
        # on the data's shape, so a dry run on meta tensors takes it too)
        m = mine[:, None, None]
        kc[rows, :, slot] = torch.where(m, k[:, 0].to(kc.dtype),
                                        kc[rows, :, slot])
        vc[rows, :, slot] = torch.where(m, v[:, 0].to(vc.dtype),
                                        vc[rows, :, slot])
        pc[rows, slot] = torch.where(mine, pos, pc[rows, slot])
        hq = q.shape[2]
        split = axis.head_split is not None     # q holds every head
        out = nn.attention_over_ranks(
            q if split else axis.all_gather(q, 2), kc.transpose(1, 2),
            vc.transpose(1, 2), ring["pos_q"], pc, axis, causal=True,
            window=window, softcap=cfg.attn_softcap)
        if split:
            return axis.rank_heads(out)
        return out[:, :, axis.index * hq:(axis.index + 1) * hq]
    kc[rows, :, slot] = k[:, 0].to(kc.dtype)
    vc[rows, :, slot] = v[:, 0].to(vc.dtype)
    pc[rows, slot] = pos
    q, kk, vv = _heads(cfg, axis, q, kc.transpose(1, 2), vc.transpose(1, 2))
    return nn.attention(q, kk, vv, ring["pos_q"], pc, causal=True,
                        window=window, softcap=cfg.attn_softcap,
                        dense_below=1 << 62)


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                positions3: torch.Tensor | None = None,
                compute_dtype=torch.bfloat16, gather=None,
                cache_layout: str | None = None):
    """token: (B,) int; pos: (B,) int (each sequence's position);
    positions3: (3, B, 1), an M-RoPE config's rotary positions.

    Writes each layer's new key, value and position into the cache at
    ring slot `pos % C`, in place, and attends over the whole ring. The
    MoE FFN runs at full capacity (no token drops). Returns (logits (B,
    V) float32, cache) -- the same cache dict.

    On a model axis (`settings.mesh`; the leaves read through `gather`)
    the cache is the rank's block by `launch.sharding.cache_specs`:
    `cache_layout` 'heads' (its KV heads), 'seq' (its C/ms ring slots of
    every head: the step's new key and value go to the rank whose slots
    hold `pos % C`, and the ranks' partial softmaxes merge) or None (the
    whole cache on every rank).
    """
    _check_ported(cfg)
    _check_positions3(cfg, positions3)
    axis = _model_axis(cfg)
    ring = _ring(axis, cache["k"].shape[3], token, pos, cache_layout)
    h = _embed(cfg, params, token, compute_dtype, gather, axis)[:, None, :]
    for i, window in enumerate(cfg.window_array()):
        kc, vc, pc = cache["k"][i], cache["v"][i], cache["pos"][i]

        def attend(q, k, v, kc=kc, vc=vc, pc=pc, window=window):
            return _ring_attend(cfg, axis, ring, q, k, v, kc, vc, pc, window)
        h = _block(cfg, h, _layer_params(cfg, gather, params["layers"], i,
                                         axis),
                   ring["pos_q"], compute_dtype, attend,
                   positions3=positions3, full_capacity=True, axis=axis)
    h = nn.rms_norm(h, params["final_norm"], offset=cfg.norm_offset)
    return _logits(cfg, params, h[:, 0, :], gather, axis), cache


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
           "model_axis", "model_partial", "prefill", "split_parts"]
