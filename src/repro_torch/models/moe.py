"""Mixture-of-Experts FFN with static-shaped dispatch.

Port of `repro/models/moe.py`, the same design: top-k routing -> a rank
within each expert from a cumulative sum over the flattened (token, k)
order -> one scatter into a (G, E, C, D) buffer -> batched expert SwiGLU
-> one gather weighted by the gates. Every shape is fixed by (T, G, C),
and nothing reads a tensor's value on the host, so the decode step that
runs it can be captured as a CUDA graph.

Out-of-range slots. The reference scatters with `mode="drop"` and lets
its gather clamp: a token over its expert's capacity C writes nowhere and
reads zero. Torch's indexing has no drop mode (an index past the end is
a device-side assert on CUDA), so the scatter's buffer carries one
trash row, `E * C`: every dropped (token, k) pair writes there and the
experts never see it. The gather clamps as the reference's does and
zeroes the dropped pairs, as the reference's `where(keep, ...)`.

The reference's `_constrain` (the mesh's sharding constraints on the
buffer) waits for the port's FSDP/TP axes (ROADMAP.md, queue 1 item
12.7); the groups G are the data shards' token groups all the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import MoESpec


def moe_capacity(spec: MoESpec, n_tokens: int) -> int:
    c = int(spec.top_k * n_tokens / spec.num_experts * spec.capacity_factor)
    return max(c, spec.top_k)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, spec: MoESpec, *,
            capacity: int | None = None, groups: int = 1) -> torch.Tensor:
    """x: (T, D) flattened tokens. router_w: (D, E). w_*: (E, D, F)/(E, F, D).

    Returns (T, D) in x's dtype. Over-capacity tokens drop per group (the
    residual stream carries them unchanged, standard Switch behaviour).
    The router runs in float32 on `router_w` as given (the caller's
    compute-dtype cast included, as the reference's).
    """
    T, D = x.shape
    E, K = spec.num_experts, spec.top_k
    G = max(1, groups)
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity if capacity is not None else moe_capacity(spec, Tg)

    xg = x.reshape(G, Tg, D)
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          router_w.to(torch.float32))
    if spec.router_softcap:
        logits = spec.router_softcap * torch.tanh(logits / spec.router_softcap)
    top_vals, top_ids = torch.topk(logits, K, dim=-1, sorted=True)
    gates = torch.softmax(top_vals, dim=-1)               # (G, Tg, K)

    eid = top_ids.reshape(G, Tg * K)                      # (G, Tg*K)
    gate = gates.reshape(G, Tg * K)
    # a comparison, not F.one_hot: its range check reads the ids on the host
    onehot = (eid[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)                                      # (G, Tg*K, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot       # rank within expert
    slot = torch.sum(pos_in_e * onehot, dim=-1)           # (G, Tg*K)
    trash = E * C
    ec_idx = torch.where(slot < C, eid * C + slot, trash)  # (G, Tg*K)

    rows = torch.arange(G, device=x.device)[:, None]
    upd = xg[:, :, None, :].expand(G, Tg, K, D).reshape(G, Tg * K, D)
    buf = x.new_zeros((G, trash + 1, D)).index_put((rows, ec_idx), upd)

    # batched expert SwiGLU, one bmm a weight on its own (E, D, F) layout:
    # (E, G*C, D) x (E, D, F) -> (E, G*C, F)
    xe = buf[:, :trash].reshape(G, E, C, D).transpose(0, 1).reshape(
        E, G * C, D)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    out_buf = torch.bmm(h, w_down).reshape(E, G, C, D).transpose(
        0, 1).reshape(G, trash, D)

    keep = (slot < C)[..., None]
    pulled = torch.where(keep, out_buf[rows, ec_idx.clamp(max=trash - 1)],
                         0) * gate[..., None].to(x.dtype)
    # a token's K pairs lie next to each other: sum them in k order
    return pulled.reshape(G, Tg, K, D).sum(dim=2).reshape(T, D)


def moe_aux_loss(x: torch.Tensor, router_w: torch.Tensor,
                 spec: MoESpec) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fraction * prob per
    expert)."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                 # (T, E)
    top1 = torch.argmax(logits, dim=-1)
    frac = torch.mean((top1[:, None] == torch.arange(
        spec.num_experts, device=x.device)).to(torch.float32), dim=0)
    prob = torch.mean(probs, dim=0)
    return spec.num_experts * torch.sum(frac * prob)


__all__ = ["moe_aux_loss", "moe_capacity", "moe_ffn"]
