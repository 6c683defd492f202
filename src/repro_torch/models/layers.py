"""Shared model layers: RMSNorm, LayerNorm, softcap, RoPE and Qwen2-VL's
M-RoPE, GQA attention (dense, or chunked with an online softmax),
SwiGLU, GeGLU, the GELU MLP, the causal depthwise conv (whole sequence
and one token) and the chunked cross-entropy.

Port of `repro/models/layers.py`, as plain
torch ops that follow the reference's math and layouts: activations are
(B, S, H, dh), attention scores and logits are float32, norms and RoPE
compute in float32 and cast back to the input dtype. Every function takes
explicit parameter tensors, so the model stays a function of its
parameter dict.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import settings

NEG_INF = -1e30


def remat(fn, *args):
    """`fn(*args)` whose activations are recomputed in the backward pass
    instead of stored: the reference's `jax.checkpoint(nothing_saveable)`."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the weight products (2-D `mm`/`addmm`: no batch dims), recompute
    everything else, attention's batched `bmm` included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_dots(fn, *args):
    """`fn(*args)` under a selective checkpoint that keeps the outputs of
    the weight products and recomputes the rest in the backward pass: the
    reference's `jax.checkpoint(checkpoint_dots_with_no_batch_dims)`. A
    3-D activation times a weight reaches `aten.mm` through `aten.matmul`
    when the activation is contiguous, which the blocks' are."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_dots_contexts)


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm; gemma-style uses offset=1.0 (weight stored as w-1)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (weight.to(torch.float32) + offset)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def soft_cap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions.to(torch.float32)[..., None] * freqs  # (..., half)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh) rotated by angles (B, S, dh // 2), rotate-half."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S). Rotate-half (llama) convention."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *,
                sections=(16, 24, 24), theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, dh); positions3: (3, B, S) temporal/height/width ids.
    Frequency slots are partitioned into `sections` (sum == dh//2); slot j in
    section c rotates by positions3[c].
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim, {half}")
    angles = _rope_angles(positions3, x.shape[-1], theta)  # (3, B, S, half)
    j = torch.arange(half, device=x.device)
    # slot j's section, from the section ends (no host read: graph-safe)
    sec = sum(((j >= end).to(torch.int64)
               for end in itertools.accumulate(sections[:-1])),
              torch.zeros_like(j))
    return _rotate(x, angles[sec, :, :, j].movedim(0, -1))


# ---------------------------------------------------------------------------
# Attention — GQA + causal/window masking + optional logit softcap.
# Dense scores for short sequences; for long ones an online softmax over KV
# chunks inside each Q chunk, every Q chunk recomputed in the backward pass:
# peak score memory O(Cq*Ck) per head.
# ---------------------------------------------------------------------------

def _mask(pq: torch.Tensor, pk: torch.Tensor, *, causal: bool,
          window) -> torch.Tensor:
    """pq: (..., Sq), pk: (..., Sk) -> bool (..., Sq, Sk)."""
    diff = pq[..., :, None] - pk[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        m &= diff >= 0
    if window is not None:
        m &= diff < window
    return m


def _attend_dense(q, k, v, pq, pk, *, causal, window, softcap, scale):
    """q: (B,Sq,Hkv,G,dh); k,v: (B,Sk,Hkv,dh); pq/pk: (B,S*)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = soft_cap(s, softcap)
    m = _mask(pq, pk, causal=causal, window=window)  # (B, Sq, Sk)
    s = s.masked_fill(~m[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))


def _attend_flash(q, k, v, pq, pk, *, causal, window, softcap, scale,
                  chunk_q: int, chunk_k: int):
    """Same contract as _attend_dense; O(chunk_q*chunk_k) score memory.
    Keeps the grouped (Hkv, G) head layout (the reference's default)."""
    B, Sq, Hkv, G, dh = q.shape
    Sk = k.shape[1]
    if Sq % chunk_q or Sk % chunk_k:
        raise ValueError(f"chunks ({chunk_q}, {chunk_k}) do not divide the "
                         f"sequences ({Sq}, {Sk})")
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def q_block(qi, pqi):
        cq = qi.shape[1]
        qf = qi.to(torch.float32)
        m_run = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, Hkv, G, cq), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(0, Sk, chunk_k):
            ki, vi = kf[:, j:j + chunk_k], vf[:, j:j + chunk_k]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ki) * scale
            s = soft_cap(s, softcap)
            msk = _mask(pqi, pk[:, j:j + chunk_k], causal=causal,
                        window=window)[:, None, None, :, :]
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vi)
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,Hkv,G,Cq,dh)
        return out.movedim(3, 1)                              # (B,Cq,Hkv,G,dh)

    return torch.cat([remat(q_block, q[:, i:i + chunk_q], pq[:, i:i + chunk_q])
                      for i in range(0, Sq, chunk_q)], dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positions_q: torch.Tensor, positions_k: torch.Tensor, *,
              causal: bool = True, window=None, softcap: float | None = None,
              chunk_q: int | None = None, chunk_k: int | None = None,
              dense_below: int | None = None) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh).

    Returns (B, Sq, Hq, dh) in q.dtype. Chunking defaults come from
    `models.settings`; Sq*Sk <= dense_below takes dense scores.
    """
    cfg = settings.get()
    chunk_q = chunk_q if chunk_q is not None else cfg.attn_chunk_q
    chunk_k = chunk_k if chunk_k is not None else cfg.attn_chunk_k
    dense_below = dense_below if dense_below is not None else cfg.dense_below
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, dh)
    scale = 1.0 / math.sqrt(dh)
    Sk = k.shape[1]
    if Sq * Sk <= dense_below or Sq % min(chunk_q, Sq) != 0:
        out = _attend_dense(qg, k, v, positions_q, positions_k, causal=causal,
                            window=window, softcap=softcap, scale=scale)
    else:
        cq = min(chunk_q, Sq)
        ck = min(chunk_k, Sk)
        while Sk % ck:
            ck //= 2
        out = _attend_flash(qg, k, v, positions_q, positions_k, causal=causal,
                            window=window, softcap=softcap, scale=scale,
                            chunk_q=cq, chunk_k=ck)
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def geglu(x, w_gate, w_up, w_down):
    """Gemma's gated MLP: tanh-approximate GELU, as `jax.nn.gelu`'s
    default."""
    return (F.gelu(x @ w_gate, approximate="tanh") * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """Whisper's MLP: tanh-approximate GELU between two biased products."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba2's and RG-LRU's short conv)
# ---------------------------------------------------------------------------

def causal_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C). Left-pads W-1 zeros, so out[t] sees
    x[t-W+1..t]: W shifted multiply-adds, summed in float32 and rounded
    once to x's dtype."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0)).to(torch.float32)
    wf = w.to(torch.float32)
    out = xp[:, :S] * wf[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * wf[i]
    return out.to(torch.result_type(x, w))


def conv1d_update(x_t: torch.Tensor, conv_state: torch.Tensor,
                  w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv at one new token. x_t: (B, C); conv_state: (B, W-1, C),
    the previous W-1 inputs. Returns (out (B, C), the new state (B, W-1,
    C)); the caller copies the state into its cache."""
    W = w.shape[0]
    dtype = torch.result_type(conv_state, x_t)
    window = torch.cat([conv_state.to(dtype), x_t[:, None, :].to(dtype)],
                       dim=1)
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1)
    return (out.to(torch.result_type(window, w)),
            window[:, 1:] if W > 1 else conv_state)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_ce_loss(h: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int | None = None,
                    softcap: float | None = None,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits: float32
    logits per sequence chunk, each chunk recomputed in the backward pass.

    h: (B, S, D) final hidden states; unembed: (D, V); labels: (B, S).
    """
    B, S, D = h.shape
    chunk = min(chunk if chunk is not None else settings.get().ce_chunk, S)
    while S % chunk:
        chunk //= 2
    labels = labels.to(torch.int64)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)

    def body(hi, li, mi):
        logits = hi.to(torch.float32) @ unembed.to(torch.float32)
        logits = soft_cap(logits, softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None])[..., 0]
        nll = (lse - gold) * mi
        return nll.sum(), mi.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        t, c = remat(body, h[:, i:i + chunk], labels[:, i:i + chunk],
                     mask[:, i:i + chunk])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


__all__ = ["NEG_INF", "apply_mrope", "apply_rope", "attention",
           "causal_depthwise_conv1d", "chunked_ce_loss", "conv1d_update",
           "geglu", "gelu_mlp", "layer_norm", "remat", "remat_dots",
           "rms_norm", "soft_cap", "swiglu"]
