"""`remat='dots'` of the port's decoder against repro's.

The reference wraps its layer in `jax.checkpoint(checkpoint_dots_with_no_
batch_dims)`: the weight products are kept for the backward pass and the
rest is recomputed. The port's counterpart is `torch.utils.checkpoint`
with a selective-checkpoint policy that saves the outputs of `aten.mm` /
`aten.addmm` (a contiguous 3-D activation times a weight reaches `mm`
through `matmul`) and recomputes everything else, attention's batched
`bmm` included. On the reduced llama3.2-3b and mixtral-8x22b at fp32 the
loss and gradients under 'dots' equal the reference's under 'dots' (loss
1e-5 relative, each leaf 1e-4 of its largest entry, the bounds of
`tests/test_torch_models.py`) and the port's own under 'nothing' (the
same bits: nothing is computed differently, only stored or recomputed).
The policy is watched while it runs: it saves `mm` and recomputes `bmm`.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import build_model, from_numpy_params
from repro_torch.models import layers

ARCHS = ("llama3.2-3b", "mixtral-8x22b")


def _setup(arch):
    jmodel = jbuild_model(jreduced(jget_config(arch)))
    model = build_model(reduced(get_config(arch)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = from_numpy_params(model.cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jb = JSyntheticLM(JDataConfig(vocab=256, seq_len=32,
                                  global_batch=2)).batch(1)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    return jmodel, model, jparams, params, jb, b


def _grads(model, params, batch, remat):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss = model.loss_fn(live, batch, compute_dtype=torch.float32,
                         remat=remat)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_matches_the_reference_and_nothing(arch):
    jmodel, model, jparams, params, jb, b = _setup(arch)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, jb, compute_dtype=jnp.float32, remat="dots"))(jparams)
    loss, grads = _grads(model, params, b, "dots")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        assert np.abs(g.numpy() - jg).max() / np.abs(jg).max() <= 1e-4
    loss0, grads0 = _grads(model, params, b, "nothing")
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)


class _Count(TorchDispatchMode):
    """Counts the aten ops that run while it is on."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, params, batch, remat):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss = model.loss_fn(live, batch, compute_dtype=torch.float32,
                         remat=remat)
    with _Count() as count:
        torch.autograd.grad(loss, tree_leaves(live))
    return count.n


def test_the_policy_saves_mm_and_recomputes_bmm(monkeypatch):
    """The policy's decisions in the forward, and what the backward runs:
    under 'dots' as many `mm` as without remat (no weight product
    recomputed) and as many `bmm` as under 'nothing' (attention
    recomputed)."""
    _, model, _, params, _, b = _setup("llama3.2-3b")
    seen = []
    policy = layers._dots_policy

    def watched(ctx, op, *args, **kw):
        out = policy(ctx, op, *args, **kw)
        seen.append((str(op), out.name))
        return out
    monkeypatch.setattr(layers, "_dots_policy", watched)
    ops = {remat: _backward_ops(model, params, b, remat)
           for remat in ("dots", "none", "nothing")}
    decided = set(seen)
    assert ("aten.mm.default", "MUST_SAVE") in decided
    assert ("aten.bmm.default", "PREFER_RECOMPUTE") in decided
    assert ("aten.bmm.default", "MUST_SAVE") not in decided
    # q, k, v, o, gate, up, down: the layer's weight products
    assert sum(1 for op, _ in seen if op == "aten.mm.default") \
        >= 7 * model.cfg.n_layers
    mm, bmm = "aten.mm.default", "aten.bmm.default"
    assert ops["dots"][mm] == ops["none"][mm] < ops["nothing"][mm]
    assert ops["dots"][bmm] == ops["nothing"][bmm] > ops["none"][bmm]
