"""Mamba-2 (SSD, state-space duality; Dao & Gu 2024), attention-free.

Port of `repro/models/mamba2.py`. Block: in_proj -> (z, xBC, dt); causal
depthwise conv on xBC; SSD over heads with a scalar decay a per head; D
skip; gated RMSNorm; out_proj.

The forward runs the chunked dual form: quadratic attention-like math
inside chunks of length Q, and the linear recurrence across chunks as a
loop over them (the reference's `lax.scan`). Decode is one recurrence
step on the (B, H, P, N) state, O(1) a token. `decode_step` writes each
layer's SSM and conv state into the cache in place (under
`torch.inference_mode`) and returns the same dict, as the decoder's KV
cache is written. `Mamba2` is the `nn.Module` view of a parameter dict.

The model axis (`settings.mesh` with 'model' above 1; `launch/tp.py`),
in the reference's layout (`launch.sharding.param_specs`): each rank
holds its contiguous blocks of `in_proj`'s columns, `conv_w`/`conv_b`'s
channels, `norm_gate` and `out_proj`'s rows. `in_proj`'s columns are laid
out z | x | B | C | dt, so a block is not the rank's heads (at
mamba2-1.3b on two ranks, rank 0's half is all of z and 160 channels of
x): the rank multiplies by its block, and the columns are all-gathered
(`ModelAxis.cols`, tag `tp_cols`), after which the rank takes its heads'
z, x and dt and the whole B and C. The training forward reads the conv's
leaves whole (`Sharded(whole=True)`) and runs it on the channels it
needs; SSD runs on the rank's H/ms heads (`a_log`, `d_skip`, `dt_bias`
replicated, sliced to them: `model_partial`); the gated RMSNorm's
statistic spans the whole `d_in` (`layers.rms_norm_split`, tag
`tp_stat`); `out_proj` is row-parallel. Under sequence parallelism the
residual stream is the rank's rows between layers, as the reference's
`constrain`. `decode_step` on the axis holds the rank's heads of the
SSM state and its channel block of the conv state (`cache_specs`): it
shifts its block, convolves it with its blocks of the conv's leaves and
all-gathers the conv's output (tag `tp_conv`). Where the specs do not
split both `in_proj`'s columns and `out_proj`'s rows, or the axis does
not divide the SSD heads (mamba2-1.3b's 8512 columns on 3 ranks), the
mixer runs whole on every model rank (`split_parts`; the leaves the
specs do split read whole), on the whole sequence under sequence
parallelism (`ModelAxis.whole_in` / `whole_out`), and `decode_step`
advances a whole SSM and conv state.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
from . import transformer
from .config import ArchConfig

#: the cache's recurrent state, which `launch.serve.SlotServer` keeps
#: apart between slots (every leaf of this family's cache)
RECURRENT_STATE: tuple[str, ...] = ("conv", "ssm")

# the leaves a block reads in the compute dtype (the rest in float32)
_CAST = ("in_proj", "conv_w", "conv_b", "out_proj")


def _dims(cfg: ArchConfig):
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    H = d_in // cfg.ssm_head_dim
    ds = cfg.ssm_state
    G = cfg.ssm_groups
    conv_ch = d_in + 2 * G * ds
    return D, d_in, H, ds, G, conv_ch


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], tuple, str]]:
    """path -> (shape, logical axes, init_kind), the reference's leaves
    and axes."""
    D, d_in, H, ds, G, conv_ch = _dims(cfg)
    L, V, W = cfg.n_layers, cfg.vocab, cfg.conv_width
    proj_out = 2 * d_in + 2 * G * ds + H
    s: dict[str, tuple] = {
        "embed": ((V, D), ("vocab_fsdp", "embed_tp"), "embed")}
    lyr = {
        "norm": ((L, D), ("layers", None), "ones"),
        "in_proj": ((L, D, proj_out), ("layers", "embed", "mlp"), "fanin"),
        "conv_w": ((L, W, conv_ch), ("layers", None, "mlp"), "fanin"),
        "conv_b": ((L, conv_ch), ("layers", "mlp"), "zeros"),
        "a_log": ((L, H), ("layers", None), "a_log"),
        "d_skip": ((L, H), ("layers", None), "ones"),
        "dt_bias": ((L, H), ("layers", None), "dt_bias"),
        "norm_gate": ((L, d_in), ("layers", "mlp"), "ones"),
        "out_proj": ((L, d_in, D), ("layers", "mlp", "embed"), "fanin"),
    }
    s.update({f"layers/{k}": v for k, v in lyr.items()})
    s["final_norm"] = ((D,), (None,), "ones")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order: a = -exp(a_log) with exp(a_log) ~
    U[1, 16); dt_bias the softplus inverse of dt, log-uniform in [1e-3,
    0.1) (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, _, kind) in sorted(_spec(cfg).items()):
        if kind == "a_log":
            leaf = torch.log(ptree.uniform(shape, generator, 1.0, 16.0,
                                           dtype))
        elif kind == "dt_bias":
            dt = torch.exp(ptree.uniform(shape, generator, math.log(1e-3),
                                         math.log(0.1), dtype))
            leaf = dt + torch.log(-torch.expm1(-dt))
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
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) with out[i, j] = sum_{j < t <= i} x[t]
    for i >= j, -inf otherwise."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
                h0: torch.Tensor | None = None):
    """Chunked SSD.

    x: (B, S, H, P); dt: (B, S, H); a: (H,) negative decay rates;
    bmat/cmat: (B, S, G, N) with heads split evenly across G groups (head
    h reads group h // (H // G)). Returns (y (B, S, H, P) f32, h_last
    (B, H, P, N) f32).
    """
    Bsz, S, H, P = x.shape
    G, N = bmat.shape[2], bmat.shape[3]
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence {S}")
    nc = S // chunk
    rep = H // G
    x = x.to(torch.float32)
    dt = dt.to(torch.float32)
    bh = bmat.to(torch.float32).repeat_interleave(rep, dim=2)  # (B, S, H, N)
    ch = cmat.to(torch.float32).repeat_interleave(rep, dim=2)
    da = dt * a.to(torch.float32)                              # (B, S, H)

    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    dac = da.reshape(Bsz, nc, chunk, H)
    bc = bh.reshape(Bsz, nc, chunk, H, N)
    cc = ch.reshape(Bsz, nc, chunk, H, N)

    cum = torch.cumsum(dac, dim=2)                             # (B, nc, Q, H)
    # intra-chunk (dual quadratic form)
    ldecay = torch.exp(_segsum(dac.movedim(3, 2)))             # (B, nc, H, Q, Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    m = scores * ldecay * dtc.movedim(3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, xc)

    # end-of-chunk states
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)             # (B, nc, Q, H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          (decay_out * dtc)[..., None] * bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B, nc, H)

    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    prev = []
    for c in range(nc):                  # the state entering each chunk
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                            # (B, nc, H, P, N)

    y_inter = (torch.einsum("bcqhn,bchpn->bcqhp", cc, prev)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def ssd_step(x_t, dt_t, a, b_t, c_t, h):
    """One-token SSD update. x_t: (B, H, P); dt_t: (B, H); b_t/c_t: (B, G,
    N); h: (B, H, P, N). Returns (y (B, H, P), h_new), float32."""
    H, G = x_t.shape[1], b_t.shape[1]
    rep = H // G
    bh = b_t.to(torch.float32).repeat_interleave(rep, dim=1)   # (B, H, N)
    chh = c_t.to(torch.float32).repeat_interleave(rep, dim=1)
    dtf = dt_t.to(torch.float32)
    da = torch.exp(dtf * a.to(torch.float32))                  # (B, H)
    h_new = (h * da[:, :, None, None]
             + (dtf[:, :, None] * x_t.to(torch.float32))[..., None]
             * bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", chh, h_new)
    return y, h_new


# ---------------------------------------------------------------------------
# Blocks / model
# ---------------------------------------------------------------------------

def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    _, d_in, H, _, _, conv_ch = _dims(cfg)
    return torch.split(zxbcdt, [d_in, conv_ch, H], dim=-1)


def split_parts(cfg: ArchConfig, mesh) -> dict[str, bool]:
    """Which parts run split over the model axis of `mesh` (the rest
    whole on every model rank): the mixer where the specs split both
    `in_proj`'s columns and `out_proj`'s rows and the axis divides the
    SSD heads; the embedding's lookup where they split its columns."""
    from repro_torch.launch.mesh import model_size
    from repro_torch.launch.sharding import model_split
    split = model_split(cfg, mesh)
    return {"mixer": {"layers/in_proj", "layers/out_proj"} <= split
            and _dims(cfg)[2] % model_size(mesh) == 0,
            "embed": "embed" in split}


def model_partial(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """The model-replicated leaves a split mixer reads on the rank's heads
    or channels, whose gradients are partial over the axis with or
    without sequence parallelism (`launch.fsdp.Sharded(partial=)`):
    `a_log`, `d_skip`, `dt_bias`, and the conv's leaves where the specs
    replicate them. None where the mixer runs whole."""
    if not split_parts(cfg, mesh)["mixer"]:
        return ()
    from repro_torch.launch.sharding import model_split
    split = model_split(cfg, mesh)
    return ("layers/a_log", "layers/d_skip", "layers/dt_bias") + tuple(
        p for p in ("layers/conv_w", "layers/conv_b") if p not in split)


def model_axis(cfg: ArchConfig, seq_parallel: bool = False):
    """The forward's model axis (`launch.tp.ModelAxis`), or None, with the
    parts that run split on it (`split_parts`)."""
    return transformer._model_axis(cfg, seq_parallel, parts=split_parts)



def _heads(cfg: ArchConfig, axis):
    """(h0, hr): the first of the heads the rank's SSD runs, and their
    count (every head off a model axis)."""
    H = _dims(cfg)[2]
    if axis is None:
        return 0, H
    hr = H // axis.size
    return axis.index * hr, hr


def _head_groups(t: torch.Tensor, h0: int, hr: int, H: int) -> torch.Tensor:
    """The B or C groups (..., G, N) that heads [h0, h0 + hr) read, as
    groups of those heads alone (head h reads group h // (H / G))."""
    rep = H // t.shape[-2]
    if hr % rep == 0 or rep % hr == 0:
        lo = h0 // rep
        return t[..., lo:lo + max(hr // rep, 1), :]
    return t.repeat_interleave(rep, dim=-2)[..., h0:h0 + hr, :]


def _mine(cfg: ArchConfig, zxbcdt: torch.Tensor, axis):
    """z, the conv's input channels, dt of the rank's heads from the
    whole in_proj output (..., proj_out): its heads' z, x and dt, and the
    whole B and C; and the slices of the conv's channels they are (x's,
    then B's and C's)."""
    _, d_in, H, ds, G, conv_ch = _dims(cfg)
    P = cfg.ssm_head_dim
    h0, hr = _heads(cfg, axis)
    if axis is None:
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        return z, xbc, dt, None
    x0, x1 = h0 * P, (h0 + hr) * P
    z = zxbcdt[..., x0:x1]
    xbc = torch.cat([zxbcdt[..., d_in + x0:d_in + x1],
                     zxbcdt[..., 2 * d_in:d_in + conv_ch]], dim=-1)
    dt = zxbcdt[..., d_in + conv_ch + h0:d_in + conv_ch + h0 + hr]
    return z, xbc, dt, (slice(x0, x1), slice(d_in, conv_ch))


def _channels(t: torch.Tensor, picks) -> torch.Tensor:
    """The conv leaf's channels (last dim) that `_mine` picked."""
    if picks is None:
        return t
    return torch.cat([t[..., sl] for sl in picks], dim=-1)


def _layer_params(params: dict, i: int, compute_dtype, gather=None,
                  axis=None, sp: bool = False):
    """Layer i's raw leaves (read through `gather`, `params.take`; on a
    model axis the conv's leaves whole, and every leaf whole where the
    mixer runs whole: partial gradients under sequence parallelism `sp`,
    else alike) and the ones read in the compute dtype."""
    whole = (() if axis is None else ("conv_w", "conv_b")
             if axis.runs_split("mixer") else tuple(params["layers"]))
    if whole and gather is None:
        raise ValueError("a model axis reads its leaves through gather= "
                         "(launch.fsdp.Sharded)")
    partial = sp or transformer._part_axis(axis, "mixer") is not None
    lp_raw = {k: gather(f"layers/{k}", t, i, whole=True, partial=partial)
              if k in whole else ptree.take(gather, f"layers/{k}", t, i)
              for k, t in params["layers"].items()}
    return lp_raw, {k: lp_raw[k].to(compute_dtype) for k in _CAST}


def _ssm_leaves(cfg: ArchConfig, lp_raw, axis):
    """(a (float32), dt_bias, d_skip) of the rank's heads."""
    h0, hr = _heads(cfg, axis)
    return (-torch.exp(lp_raw["a_log"][h0:h0 + hr].to(torch.float32)),
            lp_raw["dt_bias"][h0:h0 + hr], lp_raw["d_skip"][h0:h0 + hr])


def _gate_out(cfg: ArchConfig, lp_raw, lp, h, y, xs, z, d_skip, axis=None,
              sp: bool = False):
    """D skip, the gated RMSNorm and out_proj, added to the residual h.
    y, xs: (..., H, P) (the rank's heads on a model axis); z: (..., d_in)
    (its channels). On the axis the norm's statistic spans every rank's
    channels and out_proj's partial sums leave through `axis.leave`."""
    y = (y + d_skip.to(torch.float32)[:, None]
         * xs.to(torch.float32)).reshape(z.shape)
    g = (y * F.silu(z.to(torch.float32))).to(h.dtype)
    if axis is None:
        return h + nn.rms_norm(g, lp_raw["norm_gate"]) @ lp["out_proj"]
    g = nn.rms_norm_split(g, lp_raw["norm_gate"], axis, _dims(cfg)[1])
    out = axis.leave(nn.product_in(g, lp["out_proj"], torch.float32), sp)
    return h + out.to(h.dtype)


def _block_seq(cfg: ArchConfig, lp_raw, lp, h, *, chunk: int, axis=None,
               sp: bool = False):
    """One layer on the residual stream h (B, S, D) (the rank's rows under
    sequence parallelism; a mixer that runs whole on the whole
    sequence)."""
    if axis is not None and transformer._part_axis(axis, "mixer") is None:
        out = _block_seq(cfg, lp_raw, lp, axis.whole_in(h, sp), chunk=chunk)
        return axis.whole_out(out, sp)
    _, d_in, H, ds, G, _ = _dims(cfg)
    P = cfg.ssm_head_dim
    h0, hr = _heads(cfg, axis)
    hn = nn.rms_norm(h, lp_raw["norm"])
    if axis is not None:
        hn = axis.enter(hn, sp)
    Bsz, S, _ = hn.shape
    zxbcdt = hn @ lp["in_proj"]
    if axis is not None:
        zxbcdt = axis.cols(zxbcdt)
    z, xbc, dt_raw, picks = _mine(cfg, zxbcdt, axis)
    xbc = F.silu(nn.causal_depthwise_conv1d(xbc, _channels(lp["conv_w"],
                                                           picks))
                 + _channels(lp["conv_b"], picks))
    xs, bmat, cmat = torch.split(xbc, [hr * P, G * ds, G * ds], dim=-1)
    xs = xs.reshape(Bsz, S, hr, P)
    a, dt_bias, d_skip = _ssm_leaves(cfg, lp_raw, axis)
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias)
    y, _ = ssd_chunked(xs, dt, a,
                       _head_groups(bmat.reshape(Bsz, S, G, ds), h0, hr, H),
                       _head_groups(cmat.reshape(Bsz, S, G, ds), h0, hr, H),
                       chunk=chunk)
    return _gate_out(cfg, lp_raw, lp, h, y, xs, z, d_skip, axis, sp)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing", gather=None,
                   seq_parallel: bool = False) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D). The SSD
    chunk is cfg.ssm_chunk, halved until it divides S. Any remat but
    'none' recomputes each layer in the backward pass (the reference's
    `jax.checkpoint(nothing_saveable)` around its layer scan). On a mesh
    the leaves are read through `gather` (`params.take`); on a model axis
    with `seq_parallel` (a sequence the axis divides) the hidden states
    are the rank's rows (B, S/ms, D), else every row."""
    S = tokens.shape[1]
    axis = model_axis(cfg, seq_parallel)
    h = transformer._lookup(cfg, params, tokens, compute_dtype, gather, axis)
    chunk = min(cfg.ssm_chunk, S)
    while S % chunk:
        chunk //= 2
    sp = axis is not None and axis.sp(S)
    if sp:
        h = transformer._own_rows(axis, h)

    def layer(h, i):
        lp_raw, lp = _layer_params(params, i, compute_dtype, gather, axis,
                                   sp)
        return _block_seq(cfg, lp_raw, lp, h, chunk=chunk, axis=axis, sp=sp)

    for i in range(cfg.n_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
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
# Decode (one token against the recurrent state)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    """{"ssm": (L, B, H, P, N) float32, "conv": (L, B, W-1, conv_ch) in
    `dtype`}, zeros (the state before any token; `max_seq` does not
    bound it). `device=None` means CUDA; 'meta' gives shapes only."""
    dev = resolve_device(device)
    _, _, H, ds, _, conv_ch = _dims(cfg)
    L, W, P = cfg.n_layers, cfg.conv_width, cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((L, batch, H, P, ds), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((L, batch, W - 1, conv_ch), dtype=dtype,
                            device=dev),
    }


@torch.inference_mode()
def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, gather=None,
                cache_layout: str | None = None):
    """token: (B,) int; pos: (B,) int, unused (the state carries every
    position). Advances every row's SSM and conv state one token, in
    place. Returns (logits (B, V) float32, cache), the same cache dict.
    On a model axis (`settings.mesh`; the leaves read through `gather`)
    the cache is the rank's block by `launch.sharding.cache_specs`: its
    heads of `ssm`, its channel block of `conv` (see the module
    docstring), both whole where the mixer runs whole; `cache_layout` is
    the attention caches' and unused."""
    del pos, cache_layout
    Bsz = token.shape[0]
    _, d_in, H, ds, G, conv_ch = _dims(cfg)
    P = cfg.ssm_head_dim
    whole_axis = model_axis(cfg)
    axis = transformer._part_axis(whole_axis, "mixer")      # the mixer's: None where whole
    h0, hr = _heads(cfg, axis)
    h = transformer._lookup(cfg, params, token, compute_dtype, gather,
                            whole_axis)                        # (B, D)
    for i in range(cfg.n_layers):
        if axis is None and whole_axis is not None:
            lp_raw, lp = _layer_params(params, i, compute_dtype, gather,
                                       whole_axis)
        else:
            lp_raw = ptree.take_all(gather, "layers/", params["layers"], i)
            lp = {k: lp_raw[k].to(compute_dtype) for k in _CAST}
        ssm_st, conv_st = cache["ssm"][i], cache["conv"][i]
        hn = nn.rms_norm(h, lp_raw["norm"])
        zxbcdt = hn @ lp["in_proj"]
        if axis is not None:
            zxbcdt = axis.all_gather(zxbcdt, -1, tag="tp_cols")
        z, xbc, dt_raw, picks = _mine(cfg, zxbcdt, axis)
        if axis is None:
            xbc, conv_new = nn.conv1d_update(xbc, conv_st, lp["conv_w"])
            conv_st.copy_(conv_new)
            xbc = F.silu(xbc + lp["conv_b"])
        else:   # the rank's channel block of the conv (or every channel
            # where the specs replicate it), then every channel
            n = conv_st.shape[-1]
            c0 = d_in + (0 if n == conv_ch else axis.index * n)
            out, conv_new = nn.conv1d_update(zxbcdt[..., c0:c0 + n], conv_st,
                                             lp["conv_w"])
            conv_st.copy_(conv_new)
            out = F.silu(out + lp["conv_b"])
            xbc = _channels(out if n == conv_ch else axis.all_gather(
                out, -1, tag="tp_conv"), picks)
        xs, b_t, c_t = torch.split(xbc, [hr * P, G * ds, G * ds], dim=-1)
        xs = xs.reshape(Bsz, hr, P)
        a, dt_bias, d_skip = _ssm_leaves(cfg, lp_raw, axis)
        dt = F.softplus(dt_raw.to(torch.float32) + dt_bias)
        y, ssm_new = ssd_step(
            xs, dt, a, _head_groups(b_t.reshape(Bsz, G, ds), h0, hr, H),
            _head_groups(c_t.reshape(Bsz, G, ds), h0, hr, H), ssm_st)
        ssm_st.copy_(ssm_new)
        h = _gate_out(cfg, lp_raw, lp, h, y, xs, z, d_skip, axis)
    h = nn.rms_norm(h, params["final_norm"])
    return transformer._logits(cfg, params, h, gather, whole_axis), cache


class Mamba2(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["Mamba2", "RECURRENT_STATE", "decode_step", "forward_hidden",
           "from_numpy_params", "init_cache", "init_params", "loss_fn",
           "model_axis", "model_partial", "split_parts", "ssd_chunked",
           "ssd_step"]
