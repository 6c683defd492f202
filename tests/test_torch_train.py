"""The whole training slice on the CPU: repro_torch's fused train step
against the reference's mesh-free composition, and the port's CLI.

The reference's `build_train_step` does not run under this JAX (its
`with_sharding_constraint` rejects the Explicit axes `jax.make_mesh` now
makes; ROADMAP.md "Reference caveats"), so the port is held against the
composition that step runs: `jax.value_and_grad(model.loss_fn)` ->
`adamw.update_sketched` with K4 in interpret mode. Reduced llama3.2-3b,
the reference test's compressor (TT(8), k=1024, dims 4x8x16), constant
lr 3e-3, weights and optimizer state carried across with
`from_numpy_state`, operators with `from_numpy_operator` (the port's
operator factory is monkeypatched here only). Per step the losses,
params, m, v and the EF residual are compared.

Tolerances, per leaf as max|d| / max|ref|: at compute_dtype=float32 the
loss 1e-5 relative and every tensor 1e-4 (float32 on both sides, K4's own
3e-5 compounded over three steps); at bfloat16 (the 'mixed' policy) the
two frameworks round the bf16 matmuls differently, which flips the sign
of AdamW's normalized step (about +-1 in the first steps) wherever the
gradient estimate is near zero, so the loss is held to 1e-3 relative and
each param to 2.5 lr per step taken, m' and v' (float32 under 'mixed')
to 0.15 of their largest entry, and each param's update w' - w to the
reference's sign on at least 95% of its elements, so that a step that
left w, m or v as they were fails (measured: loss 2.1e-4; params 2.0,
3.5 and 3.6 lr after steps 1-3; m' and v' at most 0.080 of their largest
entry; signs agreeing on 97.7-100% of each leaf; at float32 4.9e-5 of
the largest entry).
"""
import functools
import itertools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import sketch as jsketch
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import rp
from repro_torch.configs import get_config, reduced
from repro_torch.core import from_numpy_operator
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import SketchCompressor

REPO = Path(__file__).resolve().parents[1]
LR = 3e-3
SKETCH = dict(family="tt", k=1024, rank=8, bucket_elems=4 * 8 * 16,
              dims=(4, 8, 16))


@pytest.fixture
def carried_ops(monkeypatch):
    cache = {}

    def make(spec, seed=0, *, device=None):
        step = seed - 0x5EED * 1_000_003
        if (spec, step) not in cache:
            key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), step)
            jop = jrp.make_projector(jrp.ProjectorSpec(
                family=spec.family, k=spec.k, dims=spec.dims,
                rank=spec.rank), key)
            arrays = jop.cores if spec.family == "tt" else jop.factors
            cache[spec, step] = from_numpy_operator(
                spec.family, [np.asarray(a) for a in arrays], "cpu")
        return cache[spec, step]

    monkeypatch.setattr(rp, "make_projector", make)
    return cache


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_steps_match_reference_composition(dtype, carried_ops):
    jmodel = jbuild_model(jreduced(jget_config("llama3.2-3b")))
    model = build_model(reduced(get_config("llama3.2-3b")))
    jcomp = jcompress.SketchCompressor(jsketch.SketchConfig(**SKETCH))
    comp = SketchCompressor(SketchConfig(**SKETCH))
    jopt_cfg = jadamw.AdamWConfig(clip_norm=None)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = jadamw.init_state(jparams, jopt_cfg)
    jef = jcomp.init_state(jparams)
    state = steps.from_numpy_state(model, jax.tree.map(np.asarray, {
        "params": jparams, "opt": jopt, "ef": jef}), device="cpu")
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", 32, 4, "train"), compressor=comp,
        opt=AdamWConfig(clip_norm=None),
        lr_fn=functools.partial(schedule.constant, peak_lr=LR),
        fused_update=True, device="cpu",
        compute_dtype=getattr(torch, dtype))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=4))
    jdtype = getattr(jnp, dtype)
    prev = [a.numpy().copy() for a in tree_leaves(state["params"])]
    jprev = [np.asarray(b).copy() for b in jax.tree.leaves(jparams)]
    for i in range(3):
        batch = data.batch(i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss_fn(
            p, jb, compute_dtype=jdtype))(jparams)
        jparams, jopt, jef, _ = jadamw.update_sketched(
            jparams, jgrads, jef, jopt, jnp.float32(LR), jopt_cfg,
            compressor=jcomp)
        state, met = step_fn(state, batch)
        assert int(state["opt"]["count"]) == int(jopt["count"]) == i + 1
        if dtype == "float32":
            assert float(met["loss"]) == pytest.approx(float(jloss),
                                                       rel=1e-5)
            for tree, jtree in ((state["params"], jparams),
                                (state["opt"]["m"], jopt["m"]),
                                (state["opt"]["v"], jopt["v"]),
                                (state["ef"]["residual"], jef["residual"])):
                for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
                    assert _rel(a, b) <= 1e-4
        else:
            assert float(met["loss"]) == pytest.approx(float(jloss),
                                                       rel=1e-3)
            for a, b in zip(tree_leaves(state["params"]),
                            jax.tree.leaves(jparams)):
                d = np.abs(a.numpy() - np.asarray(b)).max()
                assert d <= 2.5 * LR * (i + 1)
            for tree, jtree in ((state["opt"]["m"], jopt["m"]),
                                (state["opt"]["v"], jopt["v"])):
                for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
                    assert _rel(a, b) <= 0.15
            for a, a0, b, b0 in zip(tree_leaves(state["params"]), prev,
                                    jax.tree.leaves(jparams), jprev):
                same = np.sign(a.numpy() - a0) == np.sign(np.asarray(b) - b0)
                assert same.mean() >= 0.95
        prev = [a.numpy().copy() for a in tree_leaves(state["params"])]
        jprev = [np.asarray(b).copy() for b in jax.tree.leaves(jparams)]
    assert set(met) >= {"loss", "lr", "sketch_bytes", "dense_bytes",
                        "residual_norm", "fused_hbm_bytes"}


def test_unfused_step_and_build_errors(carried_ops):
    """The compressed unfused branch equals compress -> update by hand;
    the build-time typed errors fire before any step."""
    model = build_model(reduced(get_config("llama3.2-3b")))
    comp = SketchCompressor(SketchConfig(**SKETCH))
    shape = ShapeSpec("t", 32, 4, "train")
    opt = AdamWConfig(clip_norm=None)
    with pytest.raises(ValueError, match="needs a compressor"):
        steps.build_train_step(model, shape, opt=opt, fused_update=True,
                               device="cpu")
    with pytest.raises(ValueError, match="clip_norm=None"):
        steps.build_train_step(model, shape, compressor=comp,
                               opt=AdamWConfig(), fused_update=True,
                               device="cpu")
    kw = dict(compressor=comp, opt=opt, device="cpu",
              lr_fn=functools.partial(schedule.constant, peak_lr=LR))
    unfused = steps.build_train_step(model, shape, **kw)
    fused = steps.build_train_step(model, shape, fused_update=True, **kw)
    state = steps.init_train_state(model, torch.Generator().manual_seed(0),
                                   opt=opt, compressor=comp)
    batch = SyntheticLM(DataConfig(vocab=256, seq_len=32,
                                   global_batch=4)).batch(0)
    s_u, m_u = unfused(state, batch)
    s_f, m_f = fused(state, batch)
    assert float(m_u["loss"]) == float(m_f["loss"])
    for tree in (("params",), ("opt", "m"), ("opt", "v"),
                 ("ef", "residual")):
        a, b = s_u, s_f
        for k in tree:
            a, b = a[k], b[k]
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(x, y, rtol=3e-5, atol=3e-5)
    with pytest.raises(ValueError, match="built for"):
        unfused(state, SyntheticLM(DataConfig(
            vocab=256, seq_len=16, global_batch=4)).batch(0))


class _Mark:
    """A stand-in for a CUDA event: `record()` takes the next tick."""
    ticks = itertools.count()

    def record(self):
        self.tick = next(self.ticks)


def test_step_spans_bracket_the_fused_parts():
    """Inside `spans.record`, each fused step brackets loss+grad, the
    sketch and the fused update, in that order and without overlap; the
    unfused step brackets loss+grad only; outside it nothing is recorded."""
    from repro_torch.runtime import spans
    model = build_model(reduced(get_config("llama3.2-3b")))
    comp = SketchCompressor(SketchConfig(**SKETCH))
    opt = AdamWConfig(clip_norm=None)
    kw = dict(compressor=comp, opt=opt, device="cpu",
              lr_fn=functools.partial(schedule.constant, peak_lr=LR))
    shape = ShapeSpec("t", 16, 2, "train")
    fused = steps.build_train_step(model, shape, fused_update=True, **kw)
    unfused = steps.build_train_step(model, shape, **kw)
    state = steps.init_train_state(model, torch.Generator().manual_seed(0),
                                   opt=opt, compressor=comp)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=2))
    with spans.record(_Mark) as marks:
        for i in range(2):
            state, _ = fused(state, data.batch(i))
        n_fused = len(marks)
        state, _ = unfused(state, data.batch(2))
    state, _ = fused(state, data.batch(3))
    assert [name for name, _, _ in marks] == (
        ["train.loss_grad", "train.sketch", "train.fused_update"] * 2
        + ["train.loss_grad"])
    assert n_fused == 6 and spans._marks is None
    ticks = [t for _, s, e in marks for t in (s.tick, e.tick)]
    assert ticks == sorted(ticks)


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "llama3.2-3b", "--reduced", "--steps", "2",
         "--compress", "tt:k=256,dims=4x8x16"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[compress] tt:k=256,dims=4x8x16" in out.stdout
    assert "step      1 " in out.stdout and "residual_norm=" in out.stdout
    assert "[train] finished at step 2 (params=78144)" in out.stdout


def test_train_loop_logs_and_refuses_checkpoints(tmp_path):
    from repro_torch.runtime import train_loop
    model = build_model(reduced(get_config("llama3.2-3b")))
    data = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=2))
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", 16, 2, "train"), device="cpu",
        lr_fn=functools.partial(schedule.constant, peak_lr=LR))
    state = steps.init_train_state(model, torch.Generator().manual_seed(0))
    lines = []
    state, final = train_loop.run(
        step_fn, state, data, train_loop.LoopConfig(total_steps=3,
                                                      log_every=2),
        log=lines.append)
    assert final == 3
    assert int(state["opt"]["count"]) == 3
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "2"]
    assert "grad_norm=" in lines[0] and "loss=" in lines[0]
    assert lines[-1].startswith("[done] steps 0..2")
    # a checkpoint of another tree is refused with the typed error
    from repro_torch.ckpt import CheckpointError
    ck = str(tmp_path / "ck")
    train_loop.run(lambda s, b: (s, {"loss": torch.zeros(())}),
                   {"w": torch.zeros(3)}, data, train_loop.LoopConfig(
                       total_steps=1, ckpt_dir=ck), log=lines.append)
    with pytest.raises(CheckpointError, match="tree structure"):
        train_loop.run(step_fn, state, data, train_loop.LoopConfig(
            total_steps=4, ckpt_dir=ck), log=lines.append)
