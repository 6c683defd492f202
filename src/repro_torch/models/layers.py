"""Shared model layers: RMSNorm, LayerNorm, softcap, RoPE and Qwen2-VL's
M-RoPE, GQA attention (dense, or chunked with an online softmax; on a
model axis a rank's heads, `local_kv`, and one token's attention over a
sequence-split cache, `attention_over_ranks`), SwiGLU, GeGLU, the GELU
MLP, the causal depthwise conv (whole sequence and one token) and the
chunked cross-entropy (on a model axis over a vocabulary split over it,
`vocab_parallel_ce_loss`).

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


def rms_norm_split(x: torch.Tensor, weight: torch.Tensor, axis, width: int,
                   *, eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm` of a vector whose `width` channels are split over a
    model axis: x (..., width/ms) and weight are the rank's channels. The
    sum of squares is taken over the rank's channels in float32, summed
    over the axis (`ModelAxis.stat`, whose backward all-reduces) and
    divided by the whole width."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = axis.stat(torch.sum(x * x, dim=-1, keepdim=True)) / width
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


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


def _pv_bf16(p, v):
    """The flash PV product under `flash_p_bf16`: p (B, Hkv, G, cq, ck)
    rounded to bf16, v (B, ck, Hkv, dh) in its own dtype, the sums in
    fp32 (`product_in`; the reference's `preferred_element_type`)."""
    B, Hkv, G, cq, ck = p.shape
    dh = v.shape[-1]
    a = p.to(torch.bfloat16).reshape(B * Hkv, G * cq, ck)
    b = v.permute(0, 2, 1, 3).reshape(B * Hkv, ck, dh)
    return product_in(a, b, torch.float32).reshape(B, Hkv, G, cq, dh)


def _attend_flash(q, k, v, pq, pk, *, causal, window, softcap, scale,
                  chunk_q: int, chunk_k: int, p_bf16: bool = False):
    """Same contract as _attend_dense; O(chunk_q*chunk_k) score memory.
    Keeps the grouped (Hkv, G) head layout (the reference's default).
    `p_bf16` (the settings' `flash_p_bf16`) takes the PV product on bf16
    softmax weights with fp32 sums."""
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
            pv = (_pv_bf16(p, v[:, j:j + chunk_k]) if p_bf16 else
                  torch.einsum("bhgqk,bkhd->bhgqd", p, vi))
            acc = acc * corr[..., None] + pv
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
                            chunk_q=cq, chunk_k=ck, p_bf16=cfg.flash_p_bf16)
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def local_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, size: int,
             index: int, *, expand: bool, span: tuple | None = None):
    """The KV heads the query heads of rank `index` of a model axis of
    `size` read, from k, v (B, S, Hkv, dh) of every KV head: the rank's
    query heads are [index * Hq/size, (index + 1) * Hq/size), or `span`
    (a, b) where the axis splits inside a head (`ModelAxis.head_split`).
    `expand` (the settings' `gqa_expand`) repeats each KV head over its G
    = Hq/Hkv query heads first and takes the rank's query heads' of them;
    otherwise the rank takes the grouped KV heads its query heads read
    (expanded all the same where the rank's heads neither hold whole
    groups nor lie in one)."""
    Hkv = k.shape[2]
    G = n_heads // Hkv
    if span is None:
        hq = n_heads // size
        span = (index * hq, (index + 1) * hq)
    a, b = span
    grouped = (a % G == 0 and b % G == 0) or a // G == (b - 1) // G
    if expand or not grouped:
        return tuple(t.repeat_interleave(G, dim=2)[:, :, a:b]
                     for t in (k, v))
    lo, hi = a // G, (b - 1) // G + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def attention_over_ranks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         positions_q: torch.Tensor, positions_k: torch.Tensor,
                         axis, *, causal: bool = True, window=None,
                         softcap: float | None = None) -> torch.Tensor:
    """One decode step's GQA attention over a cache whose positions are
    split over a model axis: q (B, Sq, Hq, dh) every query head, k, v (B,
    Sk, Hkv, dh) this rank's positions of every KV head. Each rank takes
    its partial softmax (the row max, the sum of exponentials and the
    weighted values), and three all_reduces over the axis (tag
    `tp_attn`) merge them; a rank whose positions are all masked adds
    nothing. Returns (B, Sq, Hq, dh) in q's dtype, alike on every rank."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, dh).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) \
        / math.sqrt(dh)
    s = soft_cap(s, softcap)
    msk = _mask(positions_q, positions_k, causal=causal,
                window=window)[:, None, None]
    s = s.masked_fill(~msk, NEG_INF)
    m = axis.all_reduce(s.amax(dim=-1), op="max", tag="tp_attn")
    p = torch.where(msk, torch.exp(s - m[..., None]), 0.0)
    l_sum = axis.all_reduce(p.sum(dim=-1), tag="tp_attn")
    acc = axis.all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", p,
                                       v.to(torch.float32)), tag="tp_attn")
    out = acc / torch.clamp(l_sum, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class _ProductIn(torch.autograd.Function):
    """a @ b on the operands as given, its sums kept in `acc`: on the card
    one cuBLAS product of the (bf16) operands with an `acc` output, so the
    tensor cores run it; on the CPU the operands upcast (the same sums).
    The backward runs in the operands' dtype, as one device's product's
    does. b is (K, N) or batched as a."""

    @staticmethod
    def forward(ctx, a, b, acc):
        ctx.save_for_backward(a, b)
        if not a.is_cuda:
            return a.to(acc) @ b.to(acc)
        if b.dim() == 2:
            return torch.mm(a.reshape(-1, a.shape[-1]), b,
                            out_dtype=acc).reshape(*a.shape[:-1], -1)
        return torch.bmm(a, b, out_dtype=acc)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g @ b.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            gb = (a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
                  if b.dim() == 2 else a.transpose(-1, -2) @ g)
        return ga, gb, None


def product_in(a, b, acc=None):
    """a @ b, its sums kept in `acc` (a dtype) when given: a model axis's
    row-parallel partial sums, reduced before they are rounded."""
    if acc is None or (a.dtype == acc and b.dtype == acc):
        return a @ b
    if a.dtype != b.dtype:
        return a.to(acc) @ b.to(acc)
    return _ProductIn.apply(a, b, acc)


def _down(h, w_down, acc):
    """The down product, in `acc` (a dtype) when given."""
    return product_in(h, w_down, acc)


def swiglu(x, w_gate, w_up, w_down, *, acc=None):
    """SwiGLU; `acc` runs the down product in that dtype (a model axis's
    partial sum, reduced before it is rounded)."""
    return _down(F.silu(x @ w_gate) * (x @ w_up), w_down, acc)


def geglu(x, w_gate, w_up, w_down, *, acc=None):
    """Gemma's gated MLP: tanh-approximate GELU, as `jax.nn.gelu`'s
    default; `acc` as `swiglu`'s."""
    return _down(F.gelu(x @ w_gate, approximate="tanh") * (x @ w_up), w_down,
                 acc)


def gelu_mlp(x, w_in, b_in, w_out, b_out, *, acc=None):
    """Whisper's MLP: tanh-approximate GELU between two biased products.
    With `acc` (a model axis) the down product's partial sum in that
    dtype and no output bias: the caller adds `b_out` once, after the
    partial sums are reduced."""
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    if acc is not None:
        return _down(h, w_out, acc)
    return h @ w_out + b_out


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
                    mask: torch.Tensor | None = None,
                    denom: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits: float32
    logits per sequence chunk, each chunk recomputed in the backward pass.

    h: (B, S, D) final hidden states; unembed: (D, V); labels: (B, S).
    `denom` (a mesh's step) divides the masked sum of the rows' losses in
    place of their own count: the loss is then a term of the step's, its
    sums and counts taken over every rank's rows.
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
    return tot / (torch.clamp(cnt, min=1.0) if denom is None else denom)


def vocab_parallel_ce_loss(h: torch.Tensor, unembed: torch.Tensor,
                           labels: torch.Tensor, axis, *,
                           chunk: int | None = None,
                           softcap: float | None = None,
                           mask: torch.Tensor | None = None,
                           denom: torch.Tensor) -> torch.Tensor:
    """`chunked_ce_loss` over a vocabulary split over a model axis: h (B,
    S, D) every row, unembed (D, V/ms) this rank's block of the
    vocabulary (`launch.tp.vocab_parallel_nll` merges the blocks a chunk
    at a time). Every rank computes the same masked sum, divided by
    `denom` and counted once over the axis (`ModelAxis.once`)."""
    from repro_torch.launch.tp import vocab_parallel_nll
    B, S, D = h.shape
    chunk = min(chunk if chunk is not None else settings.get().ce_chunk, S)
    while S % chunk:
        chunk //= 2
    labels = labels.to(torch.int64)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    lo = axis.index * unembed.shape[1]

    def body(hi, li, mi):
        logits = soft_cap(hi.to(torch.float32) @ unembed.to(torch.float32),
                          softcap)
        nll = vocab_parallel_nll(logits.reshape(-1, logits.shape[-1]),
                                 li.reshape(-1), lo, axis)
        return (nll * mi.reshape(-1)).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        tot = tot + remat(body, h[:, i:i + chunk], labels[:, i:i + chunk],
                          mask[:, i:i + chunk])
    return axis.once(tot / denom)


__all__ = ["NEG_INF", "apply_mrope", "apply_rope", "attention",
           "attention_over_ranks", "causal_depthwise_conv1d",
           "chunked_ce_loss", "conv1d_update", "geglu", "gelu_mlp",
           "layer_norm", "local_kv", "product_in", "remat", "remat_dots",
           "rms_norm", "rms_norm_split",
           "soft_cap", "swiglu", "vocab_parallel_ce_loss"]
