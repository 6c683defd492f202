"""AdamW: decoupled weight decay, bias correction, f32 moment math whatever
the storage dtype, global-norm clipping. Moments are stored in
`moment_dtype` (the 'mixed' policy's float32, the 'lean' policy's bf16).

Port of `repro/optim/adamw.py`. Trees are nested dicts of tensors
(`core.tree`); the step counter `count` is a 0-d int64 tensor on the
host, because it also seeds the sketch operator.

`update_sketched` is the FUSED sketch-compressed step: instead of
`compressor.compress` (reconstruct kernel -> dense g_hat in device memory
-> EF residual pass) followed by `update` (three more dense read/write
passes), each dense leaf runs ONE `repro_torch.kernels.
fused_update_buckets` launch (K4) that reconstructs the gradient tile by
tile from the sketch and applies error feedback and the AdamW math in the
kernel's epilogue — the dense reconstruction is never stored.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.runtime.spans import span


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: Any = torch.float32


def init_state(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int64)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def _corrections(count: torch.Tensor, cfg: AdamWConfig):
    c = count.to(torch.float32)
    return 1.0 - cfg.b1 ** c, 1.0 - cfg.b2 ** c


def update(params, grads, state, lr, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics)."""
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gnorm
    count = state["count"] + 1
    c1, c2 = _corrections(count, cfg)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (step + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    flat_p, treedef = tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p = tree_unflatten(treedef, [o[0] for o in out])
    new_m = tree_unflatten(treedef, [o[1] for o in out])
    new_v = tree_unflatten(treedef, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


def update_sketched(params, grads, ef_state, opt_state, lr,
                    cfg: AdamWConfig, *, compressor):
    """Fused sketch-compressed AdamW step: one K4 launch per leaf.

    Equal (to fp32 kernel tolerance) to the unfused chain

        g_hat, ef', _ = compressor.compress(grads, ef_state,
                                            step=opt_state['count'])
        p', opt', _   = update(params, g_hat, opt_state, lr, cfg)

    but the dense reconstruction g_hat is never stored: after the sketch
    (one K1 launch per leaf), each dense leaf's buckets run ONE
    `fused_update_buckets` launch whose epilogue applies error feedback
    and the AdamW moment/param math while the tile is in registers. The
    gradient estimate stays float32 end to end.

    Requires `cfg.clip_norm is None` and a dense-leaf tree — both enforced
    with typed errors. Returns (new_params, new_opt_state, new_ef_state,
    metrics).
    """
    if cfg.clip_norm is not None:
        raise ValueError(
            "update_sketched fuses the optimizer into the unsketch kernel "
            "and never materializes the dense gradient estimate, so a "
            "global-norm clip over it is unavailable; construct "
            "AdamWConfig(clip_norm=None) for the fused path")
    # function-level imports: optim does not depend on rp/kernels at module
    # scope (core <-> rp import cycle)
    from repro_torch import rp
    from repro_torch.core.sketch import _is_struct_leaf
    from repro_torch.kernels import fused_update_buckets

    if any(_is_struct_leaf(leaf) for leaf in tree_leaves(grads)):
        raise ValueError(
            "update_sketched supports dense gradient leaves only: "
            "structured (TT/CP-format) leaves reconstruct through the "
            "carry-sweep route and do not map onto the fused bucket "
            "kernel; use compressor.compress + update for such trees")
    sk = compressor._sketcher(grads)
    seed = compressor._key(opt_state["count"])
    p_fed = tree_map(lambda g, e: g.to(torch.float32) + e,
                     grads, ef_state["residual"])
    op = compressor.cfg.operator(seed, tree_leaves(p_fed)[0].device)
    alpha = compressor.cfg.shrinkage()
    with span("train.sketch"):
        y = sk.sketch(p_fed, seed)                  # (n_buckets, k)
    count = opt_state["count"] + 1
    c1, c2 = _corrections(count, cfg)
    flat_w, treedef = tree_flatten(params)
    new_w, new_m, new_v, new_r = [], [], [], []
    off = 0
    fused_hbm = 0
    with span("train.fused_update"):
        for pe, w, m, v, nb, size, shape in zip(
                tree_leaves(p_fed), flat_w, tree_leaves(opt_state["m"]),
                tree_leaves(opt_state["v"]), sk._nb, sk._sizes, sk._shapes):
            rp.count_kernel_dispatch(family=compressor.cfg.family,
                                     structure="fused-update",
                                     order=len(compressor.cfg.dims))
            fused_hbm += rp.plan_update(op, nb, fused=True).cost.hbm_bytes
            r_b, w_b, m_b, v_b = fused_update_buckets(
                op, y[off:off + nb],
                sk._leaf_to_buckets(pe, nb), sk._leaf_to_buckets(w, nb),
                sk._leaf_to_buckets(m, nb), sk._leaf_to_buckets(v, nb),
                lr, c1, c2, alpha=alpha, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                weight_decay=cfg.weight_decay)
            off += nb
            new_r.append(sk._leaf_from_buckets(r_b, size, shape,
                                               torch.float32))
            new_w.append(sk._leaf_from_buckets(w_b, size, shape, w.dtype))
            new_m.append(sk._leaf_from_buckets(m_b, size, shape, m.dtype))
            new_v.append(sk._leaf_from_buckets(v_b, size, shape, v.dtype))
    new_ef = {"residual": tree_unflatten(treedef, new_r)}
    metrics = compressor._metrics(sk, new_ef["residual"])
    # the plan layer's analytic device-memory ledger for the fused
    # launches this step issued (sum over leaves)
    metrics["fused_hbm_bytes"] = torch.tensor(float(fused_hbm))
    return (tree_unflatten(treedef, new_w),
            {"m": tree_unflatten(treedef, new_m),
             "v": tree_unflatten(treedef, new_v), "count": count},
            new_ef, metrics)


__all__ = ["AdamWConfig", "clip_by_global_norm", "global_norm",
           "init_state", "update", "update_sketched"]
