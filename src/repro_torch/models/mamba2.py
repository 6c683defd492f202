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
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

from . import layers as nn
from . import params as ptree
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


def _spec(cfg: ArchConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """path -> (shape, init_kind), the reference's leaves."""
    D, d_in, H, ds, G, conv_ch = _dims(cfg)
    L, V, W = cfg.n_layers, cfg.vocab, cfg.conv_width
    proj_out = 2 * d_in + 2 * G * ds + H
    s: dict[str, tuple] = {"embed": ((V, D), "embed")}
    lyr = {
        "norm": ((L, D), "ones"),
        "in_proj": ((L, D, proj_out), "fanin"),
        "conv_w": ((L, W, conv_ch), "fanin"),
        "conv_b": ((L, conv_ch), "zeros"),
        "a_log": ((L, H), "a_log"),
        "d_skip": ((L, H), "ones"),
        "dt_bias": ((L, H), "dt_bias"),
        "norm_gate": ((L, d_in), "ones"),
        "out_proj": ((L, d_in, D), "fanin"),
    }
    s.update({f"layers/{k}": v for k, v in lyr.items()})
    s["final_norm"] = ((D,), "ones")
    return s


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random parameters on the generator's device, drawn in the
    reference's sorted path order: a = -exp(a_log) with exp(a_log) ~
    U[1, 16); dt_bias the softplus inverse of dt, log-uniform in [1e-3,
    0.1) (the numbers differ from JAX's)."""
    params: dict[str, Any] = {}
    for path, (shape, kind) in sorted(_spec(cfg).items()):
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


def _layer_params(params: dict, i: int, compute_dtype):
    """Layer i's raw leaves and the ones read in the compute dtype."""
    lp_raw = {k: t[i] for k, t in params["layers"].items()}
    return lp_raw, {k: lp_raw[k].to(compute_dtype) for k in _CAST}


def _gate_out(cfg: ArchConfig, lp_raw, lp, h, y, xs, z):
    """D skip, the gated RMSNorm and out_proj, added to the residual h.
    y, xs: (..., H, P); z: (..., d_in)."""
    y = (y + lp_raw["d_skip"].to(torch.float32)[:, None]
         * xs.to(torch.float32)).reshape(z.shape)
    y = nn.rms_norm((y * F.silu(z.to(torch.float32))).to(h.dtype),
                    lp_raw["norm_gate"])
    return h + y @ lp["out_proj"]


def _block_seq(cfg: ArchConfig, lp_raw, lp, h, *, chunk: int):
    Bsz, S, _ = h.shape
    _, d_in, H, ds, G, _ = _dims(cfg)
    P = cfg.ssm_head_dim
    hn = nn.rms_norm(h, lp_raw["norm"])
    z, xbc, dt_raw = _split_proj(cfg, hn @ lp["in_proj"])
    xbc = F.silu(nn.causal_depthwise_conv1d(xbc, lp["conv_w"])
                 + lp["conv_b"])
    xs, bmat, cmat = torch.split(xbc, [d_in, G * ds, G * ds], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    dt = F.softplus(dt_raw.to(torch.float32) + lp_raw["dt_bias"])
    a = -torch.exp(lp_raw["a_log"].to(torch.float32))
    y, _ = ssd_chunked(xs, dt, a, bmat.reshape(Bsz, S, G, ds),
                       cmat.reshape(Bsz, S, G, ds), chunk=chunk)
    return _gate_out(cfg, lp_raw, lp, h, y, xs, z)


def forward_hidden(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
                   compute_dtype=torch.bfloat16,
                   remat: str = "nothing") -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D). The SSD
    chunk is cfg.ssm_chunk, halved until it divides S. Any remat but
    'none' recomputes each layer in the backward pass (the reference's
    `jax.checkpoint(nothing_saveable)` around its layer scan)."""
    S = tokens.shape[1]
    h = params["embed"][tokens.to(torch.int64)].to(compute_dtype)
    chunk = min(cfg.ssm_chunk, S)
    while S % chunk:
        chunk //= 2

    def layer(h, i):
        lp_raw, lp = _layer_params(params, i, compute_dtype)
        return _block_seq(cfg, lp_raw, lp, h, chunk=chunk)

    for i in range(cfg.n_layers):
        h = layer(h, i) if remat == "none" else nn.remat(layer, h, i)
    return nn.rms_norm(h, params["final_norm"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            compute_dtype=torch.bfloat16,
            remat: str = "nothing") -> torch.Tensor:
    h = forward_hidden(cfg, params, batch["tokens"],
                       compute_dtype=compute_dtype, remat=remat)
    return nn.chunked_ce_loss(h, params["embed"].T, batch["labels"])


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
                compute_dtype=torch.bfloat16):
    """token: (B,) int; pos: (B,) int, unused (the state carries every
    position). Advances every row's SSM and conv state one token, in
    place. Returns (logits (B, V) float32, cache), the same cache dict."""
    del pos
    Bsz = token.shape[0]
    _, d_in, H, ds, G, _ = _dims(cfg)
    P = cfg.ssm_head_dim
    h = params["embed"][token.to(torch.int64)].to(compute_dtype)  # (B, D)
    for i in range(cfg.n_layers):
        lp_raw, lp = _layer_params(params, i, compute_dtype)
        ssm_st, conv_st = cache["ssm"][i], cache["conv"][i]
        hn = nn.rms_norm(h, lp_raw["norm"])
        z, xbc, dt_raw = _split_proj(cfg, hn @ lp["in_proj"])
        xbc, conv_new = nn.conv1d_update(xbc, conv_st, lp["conv_w"])
        conv_st.copy_(conv_new)
        xbc = F.silu(xbc + lp["conv_b"])
        xs, b_t, c_t = torch.split(xbc, [d_in, G * ds, G * ds], dim=-1)
        xs = xs.reshape(Bsz, H, P)
        dt = F.softplus(dt_raw.to(torch.float32) + lp_raw["dt_bias"])
        a = -torch.exp(lp_raw["a_log"].to(torch.float32))
        y, ssm_new = ssd_step(xs, dt, a, b_t.reshape(Bsz, G, ds),
                              c_t.reshape(Bsz, G, ds), ssm_st)
        ssm_st.copy_(ssm_new)
        h = _gate_out(cfg, lp_raw, lp, h, y, xs, z)
    h = nn.rms_norm(h, params["final_norm"])
    logits = h.to(torch.float32) @ params["embed"].T.to(torch.float32)
    return logits, cache


class Mamba2(ptree.FamilyModule):
    """The `nn.Module` view of a parameter dict (no copy); `forward` is
    `loss_fn`."""

    loss = staticmethod(loss_fn)


__all__ = ["Mamba2", "RECURRENT_STATE", "decode_step", "forward_hidden",
           "from_numpy_params", "init_cache", "init_params", "loss_fn",
           "ssd_chunked", "ssd_step"]
