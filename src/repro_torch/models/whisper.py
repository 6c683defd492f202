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

The model axis (`settings.mesh` with 'model' above 1; `launch/tp.py`),
in the reference's layout (`launch.sharding.param_specs`): self- and
cross-attention are split over heads (`wq`, `wk`, `wv` and their biases
column-parallel, `wo` row-parallel), the GELU MLP over its hidden dim
(`w_in`, `b_in` column-parallel, `w_out` row-parallel); `bo` and `b_out`
are added once, after the row-parallel partial sums are reduced (in
float32, rounded once); the cross-attention's `x_wk` and `x_wv` read the
whole encoder output. There is no sequence parallelism: the reference
passes no `constrain` to `encode` and `decode_hidden`, so the stream is
whole on every model rank (`SEQ_PARALLEL`). `decode_step` on the axis
holds the rank's heads of the self-attention cache and of the cross
K/V, which `build_cross_cache` fills from the rank's blocks. Where the
axis does not divide the heads (whisper-medium's 16 on 3 or 32 ranks) the
attention runs whole on every model rank, its leaves read whole where
the specs split them, and its caches are whole; where it does not divide
d_ff (4096 on 3 ranks) the MLP runs whole (`split_parts`). The stream is
alike on every rank, so nothing of a whole part is reduced and its
weights' gradients are whole already.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from . import transformer
from .config import ArchConfig

#: the cache's recurrent state (none: self- and cross-attention K/V)
RECURRENT_STATE: tuple[str, ...] = ()

#: whether the forward splits the stream's sequence over the model axis
#: (no: the reference constrains neither `encode` nor `decode_hidden`)
SEQ_PARALLEL = False


def _attn_spec(D, Hq, hd, lead, prefix=""):
    return {
        f"{prefix}ln_w": (lead + (D,), ("layers", None), "ones"),
        f"{prefix}ln_b": (lead + (D,), ("layers", None), "zeros"),
        f"{prefix}wq": (lead + (D, Hq * hd), ("layers", "embed", "heads"),
                        "fanin"),
        f"{prefix}bq": (lead + (Hq * hd,), ("layers", "heads"), "zeros"),
        f"{prefix}wk": (lead + (D, Hq * hd), ("layers", "embed", "heads"),
                        "fanin"),
        f"{prefix}wv": (lead + (D, Hq * hd), ("layers", "embed", "heads"),
                        "fanin"),
        f"{prefix}bv": (lead + (Hq * hd,), ("layers", "heads"), "zeros"),
        f"{prefix}wo": (lead + (Hq * hd, D), ("layers", "heads", "embed"),
                        "fanin"),
        f"{prefix}bo": (lead + (D,), ("layers", None), "zeros"),
    }


def _mlp_spec(D, F, lead):
    return {
        "ln2_w": (lead + (D,), ("layers", None), "ones"),
        "ln2_b": (lead + (D,), ("layers", None), "zeros"),
        "w_in": (lead + (D, F), ("layers", "embed", "mlp"), "fanin"),
        "b_in": (lead + (F,), ("layers", "mlp"), "zeros"),
        "w_out": (lead + (F, D), ("layers", "mlp", "embed"), "fanin"),
        "b_out": (lead + (D,), ("layers", None), "zeros"),
    }


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], tuple, str]]:
    """path -> (shape, logical axes, init_kind), the reference's leaves
    and axes."""
    D, hd, Hq, F, V = cfg.d_model, cfg.hd, cfg.n_heads, cfg.d_ff, cfg.vocab
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    s: dict[str, tuple] = {
        "embed": ((V, D), ("vocab_fsdp", "embed_tp"), "embed")}
    enc = {**_attn_spec(D, Hq, hd, (Le,)), **_mlp_spec(D, F, (Le,))}
    s.update({f"enc/{k}": v for k, v in enc.items()})
    s["enc_ln_w"] = ((D,), (None,), "ones")
    s["enc_ln_b"] = ((D,), (None,), "zeros")
    dec = {**_attn_spec(D, Hq, hd, (Ld,)),
           **_attn_spec(D, Hq, hd, (Ld,), prefix="x_"),
           **_mlp_spec(D, F, (Ld,))}
    s.update({f"dec/{k}": v for k, v in dec.items()})
    s["dec_ln_w"] = ((D,), (None,), "ones")
    s["dec_ln_b"] = ((D,), (None,), "zeros")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, _, kind) in sorted(_spec(cfg).items()):
        ptree.assign(params, path, ptree.draw(kind, shape, generator, dtype))
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

def sinusoidal(S: int, D: int, dtype=torch.float32, *,
               device=None) -> torch.Tensor:
    """(S, D): sin of position / 10000^(2j/D) in the first half, cos in
    the second."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def split_parts(cfg: ArchConfig, mesh) -> dict[str, bool]:
    """Which parts run split over the model axis of `mesh` (the rest
    whole on every model rank): the attention (self and cross, encoder
    and decoder) where the specs split its Hq*hd columns and the axis
    divides the heads, the MLP where the specs split d_ff, the
    embedding's lookup where they split its columns."""
    from repro_torch.launch.mesh import model_size
    from repro_torch.launch.sharding import model_split
    split = model_split(cfg, mesh)
    return {"attn": "enc/wq" in split and cfg.n_heads % model_size(mesh)
            == 0, "mlp": "enc/w_in" in split, "embed": "embed" in split}


def model_partial(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """The model-replicated leaves read inside a parallel region of the
    model axis (none: the norms are read before it, the biases after
    it)."""
    return ()


def model_axis(cfg: ArchConfig, seq_parallel: bool = False):
    """The forward's model axis (`launch.tp.ModelAxis`, never
    sequence-parallel: `SEQ_PARALLEL`), or None, with the parts that run
    split on it (`split_parts`)."""
    del seq_parallel
    return transformer._model_axis(cfg, False, parts=split_parts)


_ATTN = ("wq", "bq", "wk", "wv", "bv", "wo")



def _layer(stacked: dict, i: int, compute_dtype, gather=None,
           prefix: str = "", axis=None):
    """Layer i's raw leaves (read through `gather` under `prefix`,
    `params.take`), and all of them in the compute dtype. On a model axis
    where the attention runs whole its leaves are read whole (alike on
    every rank: the stream is)."""
    whole = axis is not None and transformer._part_axis(axis, "attn") is None
    raw = {k: gather(f"{prefix}{k}", t, i, whole=True, partial=False)
           if whole and k.removeprefix("x_") in _ATTN
           else ptree.take(gather, f"{prefix}{k}", t, i)
           for k, t in stacked.items()}
    return raw, {k: t.to(compute_dtype) for k, t in raw.items()}


def _project_q(cfg, lp, x, prefix=""):
    B, S, _ = x.shape
    return (x @ lp[f"{prefix}wq"] + lp[f"{prefix}bq"]).reshape(
        B, S, -1, cfg.hd)


def _project_kv(cfg, lp, x, prefix=""):
    """Keys (no bias) and values of x (B, S, D): (B, S, H, hd) each (the
    rank's heads on a model axis)."""
    B, S, _ = x.shape
    k = (x @ lp[f"{prefix}wk"]).reshape(B, S, -1, cfg.hd)
    v = (x @ lp[f"{prefix}wv"] + lp[f"{prefix}bv"]).reshape(
        B, S, -1, cfg.hd)
    return k, v


def _out(h, x, w, b, axis):
    """h + (x @ w + b) for a row-parallel w: on a model axis the partial
    sums in float32, all-reduced and rounded once, the bias added after."""
    if axis is None:
        return h + (x @ w + b)
    return h + (axis.leave(nn.product_in(x, w, torch.float32), False)
                .to(h.dtype) + b)


def _mha(cfg, lp, h, x_q, x_kv, pos_q, pos_k, *, causal, prefix="",
         axis=None):
    """h + the attention block's output of queries x_q over x_kv (on a
    model axis both already entered: `axis.enter`)."""
    B, Sq, _ = x_q.shape
    q = _project_q(cfg, lp, x_q, prefix)
    k, v = _project_kv(cfg, lp, x_kv, prefix)
    out = nn.attention(q, k, v, pos_q, pos_k, causal=causal)
    return _out(h, out.reshape(B, Sq, -1), lp[f"{prefix}wo"],
                lp[f"{prefix}bo"], axis)


def _enter(x, axis):
    return x if axis is None else axis.enter(x, False)


def _mlp(lp_raw, lp, h, axis=None):
    """The GELU MLP's residual block (whole where it runs whole)."""
    if axis is not None and not axis.runs_split("mlp"):
        axis = None
    hn2 = _enter(nn.layer_norm(h, lp_raw["ln2_w"], lp_raw["ln2_b"]), axis)
    if axis is None:
        return h + nn.gelu_mlp(hn2, lp["w_in"], lp["b_in"], lp["w_out"],
                               lp["b_out"])
    ff = nn.gelu_mlp(hn2, lp["w_in"], lp["b_in"], lp["w_out"], lp["b_out"],
                     acc=torch.float32)
    return h + (axis.leave(ff, False).to(h.dtype) + lp["b_out"])


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
           compute_dtype=torch.bfloat16,
           remat: str = "nothing", gather=None) -> torch.Tensor:
    """frames: (B, Se, D) precomputed frame embeddings (the conv front
    end's stub) -> the encoder output (B, Se, D) in the compute dtype.
    Any remat but 'none' recomputes each layer in the backward pass. On a
    mesh the leaves are read through `gather` (`params.take`); on a model
    axis every rank returns the whole output."""
    B, Se, D = frames.shape
    axis = model_axis(cfg)
    h = (frames.to(compute_dtype)
         + sinusoidal(Se, D, compute_dtype, device=frames.device)[None])
    pos = _positions(B, Se, frames.device)

    aax = transformer._part_axis(axis, "attn")

    def layer(h, i):
        lp_raw, lp = _layer(params["enc"], i, compute_dtype, gather, "enc/",
                            axis)
        hn = _enter(nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"]), aax)
        h = _mha(cfg, lp, h, hn, hn, pos, pos, causal=False, axis=aax)
        return _mlp(lp_raw, lp, h, axis)

    for i in range(cfg.encoder_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
    return nn.layer_norm(h, params["enc_ln_w"], params["enc_ln_b"])


def decode_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  enc_out: torch.Tensor, *, compute_dtype=torch.bfloat16,
                  remat: str = "nothing", gather=None) -> torch.Tensor:
    """The decoder over a whole sequence (B, S), attending to enc_out (B,
    Se, D): final hidden states (B, S, D) (every row on every rank of a
    model axis)."""
    B, S = tokens.shape
    dev = tokens.device
    axis = model_axis(cfg)
    h = (transformer._lookup(cfg, params, tokens, compute_dtype, gather,
                             axis)
         + sinusoidal(S, cfg.d_model, compute_dtype, device=dev)[None])
    pos = _positions(B, S, dev)
    pos_e = _positions(B, enc_out.shape[1], dev)
    aax = transformer._part_axis(axis, "attn")
    # one entry for every layer's cross K/V: one all_reduce of its gradient
    enc_out = _enter(enc_out.to(compute_dtype), aax)

    def layer(h, i):
        lp_raw, lp = _layer(params["dec"], i, compute_dtype, gather, "dec/",
                            axis)
        hn = _enter(nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"]), aax)
        h = _mha(cfg, lp, h, hn, hn, pos, pos, causal=True, axis=aax)
        hx = _enter(nn.layer_norm(h, lp_raw["x_ln_w"], lp_raw["x_ln_b"]),
                    aax)
        h = _mha(cfg, lp, h, hx, enc_out, pos, pos_e, causal=False,
                 prefix="x_", axis=aax)
        return _mlp(lp_raw, lp, h, axis)

    for i in range(cfg.n_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
    return nn.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16, remat: str = "nothing",
            gather=None, seq_parallel: bool = False,
            denom: torch.Tensor | None = None) -> torch.Tensor:
    """batch: frames (B, Se, D), tokens and labels (B, S). The mean
    cross-entropy of the rows (the reference's: no loss mask); with
    `denom` (a mesh's step) their sum over `denom`. On a model axis this
    rank's term of it (`transformer._axis_loss`; `seq_parallel` is
    ignored: `SEQ_PARALLEL`)."""
    enc_out = encode(cfg, params, batch["frames"],
                     compute_dtype=compute_dtype, remat=remat,
                     gather=gather)
    h = decode_hidden(cfg, params, batch["tokens"], enc_out,
                      compute_dtype=compute_dtype, remat=remat,
                      gather=gather)
    axis = model_axis(cfg, seq_parallel)
    if axis is not None:
        return transformer._axis_loss(cfg, params, h, batch["labels"], None,
                                      axis, gather, denom)
    return nn.chunked_ce_loss(h, ptree.take(gather, "embed",
                                            params["embed"]).T,
                              batch["labels"], denom=denom)


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
                      cache: dict, *, compute_dtype=torch.bfloat16,
                      gather=None) -> dict:
    """Every decoder layer's cross-attention keys and values of enc_out
    (B, Se, D), computed in the compute dtype and written into the
    cache's xk and xv in place (on a model axis the rank's heads, from
    its blocks of the leaves read through `gather`; every head where the
    attention runs whole). Returns the same cache dict."""
    e = enc_out.to(compute_dtype)
    axis = model_axis(cfg)
    for i in range(cfg.n_layers):
        lp = {k: (gather(f"dec/{k}", params["dec"][k], i, whole=True)
                  if axis is not None and transformer._part_axis(axis, "attn") is None
                  else ptree.take(gather, f"dec/{k}", params["dec"][k], i)
                  ).to(compute_dtype) for k in ("x_wk", "x_wv", "x_bv")}
        xk, xv = _project_kv(cfg, lp, e, prefix="x_")
        cache["xk"][i].copy_(xk.transpose(1, 2))
        cache["xv"][i].copy_(xv.transpose(1, 2))
    return cache


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, gather=None,
                cache_layout: str | None = None):
    """token: (B,) int; pos: (B,) int (each sequence's position). Writes
    each layer's new key and value at `pos`, in place, attends causally
    over the self-attention cache and fully over the cross K/V. Returns
    (logits (B, V) float32, cache), the same dict. On a model axis
    (`settings.mesh`; the leaves read through `gather`) the cache holds
    the rank's heads (`cache_layout` 'heads'), or every head where the
    attention runs whole (None)."""
    axis = model_axis(cfg)
    if axis is not None and cache_layout == "seq":
        raise ValueError(
            f"{cfg.name}: the cache is split by heads or whole "
            "(launch.sharding.cache_specs), never by positions")
    aax = transformer._part_axis(axis, "attn")
    B = token.shape[0]
    dev = token.device
    max_seq, Se = cache["k"].shape[3], cache["xk"].shape[3]
    pos = pos.to(device=dev, dtype=torch.int64)
    rows = torch.arange(B, device=dev)
    h = transformer._lookup(cfg, params, token, compute_dtype, gather,
                            axis)[:, None, :]
    # each sequence's own position embedding
    h = h + sinusoidal(max_seq, cfg.d_model, compute_dtype,
                       device=dev)[pos][:, None, :]
    pos_q = pos[:, None]
    pos_k = _positions(B, max_seq, dev)
    pos_e = _positions(B, Se, dev)
    for i in range(cfg.n_layers):
        lp_raw, lp = _layer(params["dec"], i, compute_dtype, gather, "dec/",
                            axis)
        kc, vc = cache["k"][i], cache["v"][i]
        hn = nn.layer_norm(h, lp_raw["ln_w"], lp_raw["ln_b"])
        q = _project_q(cfg, lp, hn)
        k, v = _project_kv(cfg, lp, hn)
        kc[rows, :, pos] = k[:, 0].to(kc.dtype)
        vc[rows, :, pos] = v[:, 0].to(vc.dtype)
        attn = nn.attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                            pos_q, pos_k, causal=True, dense_below=1 << 62)
        # (h + a @ wo) + bo, the reference's order of the bf16 sums
        h = _out_step(h, attn.reshape(B, 1, -1), lp["wo"], lp["bo"], aax)
        hx = nn.layer_norm(h, lp_raw["x_ln_w"], lp_raw["x_ln_b"])
        qx = _project_q(cfg, lp, hx, prefix="x_")
        attn_x = nn.attention(
            qx, cache["xk"][i].transpose(1, 2).to(compute_dtype),
            cache["xv"][i].transpose(1, 2).to(compute_dtype), pos_q, pos_e,
            causal=False, dense_below=1 << 62)
        h = _out_step(h, attn_x.reshape(B, 1, -1), lp["x_wo"], lp["x_bo"],
                      aax)
        h = _mlp(lp_raw, lp, h, axis)
    h = nn.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"])
    return transformer._logits(cfg, params, h[:, 0], gather, axis), cache


def _out_step(h, x, w, b, axis):
    """(h + x @ w) + b, the reference's order of a decode step's sums; on
    a model axis x @ w's partial sums in float32, all-reduced and rounded
    once."""
    if axis is None:
        return h + x @ w + b
    return h + axis.leave(nn.product_in(x, w, torch.float32),
                          False).to(h.dtype) + b


class Whisper(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["RECURRENT_STATE", "SEQ_PARALLEL", "Whisper",
           "build_cross_cache", "decode_hidden", "decode_step", "encode",
           "from_numpy_params", "init_cache", "init_params", "loss_fn",
           "model_axis", "model_partial", "sinusoidal", "split_parts"]
