"""The layout half of `repro_torch.launch.sharding` and the model's logical
axes against repro's.

For all ten registered architectures at full size: `Model.param_axes()`
equals the reference's leaf for leaf, and `Model.param_shapes()` (meta
tensors, nothing allocated) equals the reference's `jax.eval_shape` of
`init`. Then `axis_rules`, `param_specs` with their divisibility notes,
`batch_spec` and `input_batch_specs` (every shape of every arch) against
the reference's on stand-in meshes (16, 16), (2, 16, 16), (2, 1),
(1, 2, 1) and (4, 1): objects with `shape` and `axis_names` only, which
both packages' functions read. The reference's `PartitionSpec` stores a
one-axis entry as the bare name, so every entry is normalized to a tuple
of names (or None) on both sides, as `tests/test_torch_shard.py` does.
The mesh train step builds for any model size (the parts whose leaves
the specs replicate run whole) and refuses `fused_update` beside a pod
axis (with or without a model axis), as the reference does; the train
CLI builds a (pod, data, model) mesh.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro_torch.configs import get_config
from repro_torch.launch import sharding, steps
from repro_torch.models import build_model, input_specs
from repro_torch.models.config import ShapeSpec

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2x1": ((1, 2, 1), ("pod", "data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


def _stand_in(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec(spec) -> tuple:
    return tuple(_norm(e) for e in spec)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict, stopping at anything else."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree, is_leaf=None):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's model, axes and `eval_shape` of `init`."""
    jm = jbuild_model(jget_config(arch))
    return jm, jm.param_axes(), jm.param_shapes()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_equal_the_reference(arch):
    m = build_model(get_config(arch))
    jm, jaxes, jshapes = _reference(arch)
    want_axes = _jflat(jaxes, is_leaf=lambda x: isinstance(x, tuple))
    assert {k: tuple(v) for k, v in _flat(m.param_axes()).items()} \
        == {k: tuple(v) for k, v in want_axes.items()}
    shapes = _flat(m.param_shapes())
    want = _jflat(jshapes)
    assert list(shapes) == list(want)
    for path, sds in want.items():
        t = shapes[path]
        assert t.device.type == "meta"        # nothing allocated
        assert tuple(t.shape) == tuple(sds.shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(
            sds.dtype).name, path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_axis_rules_equal_the_reference(mesh):
    stand = _stand_in(mesh)
    for arch in ARCHS:
        got = sharding.axis_rules(get_config(arch), stand)
        want = jsharding.axis_rules(jget_config(arch), stand)
        assert {k: _norm(v) for k, v in got.items()} \
            == {k: _norm(v) for k, v in want.items()}, arch
    got = sharding.axis_rules(get_config("llama3.2-3b"), stand,
                              fsdp_axes=("data",))
    assert got["embed"] == ("data",) and got["vocab_fsdp"] == ("data",)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_notes_equal_the_reference(arch, mesh):
    stand = _stand_in(mesh)
    m = build_model(get_config(arch))
    jm, jaxes, jshapes = _reference(arch)
    jnotes, notes = [], []
    want = _jflat(jsharding.param_specs(jm.cfg, jaxes, stand, jshapes,
                                        jnotes),
                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = _flat(sharding.param_specs(m.cfg, m.param_axes(), stand,
                                     m.param_shapes(), notes))
    assert list(got) == list(want)
    for path in want:
        assert _spec(got[path]) == _spec(want[path]), path
    assert notes == jnotes


def test_whisper_vocab_falls_back_to_replicated():
    m = build_model(get_config("whisper-medium"))
    notes = []
    specs = sharding.param_specs(m.cfg, m.param_axes(), _stand_in("16x16"),
                                 m.param_shapes(), notes)
    assert specs["embed"] == (None, "model")       # 51865 rows !% 16
    assert "dim 51865 !% ('data',) -> replicated" in notes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_prefix_fallback_equals_the_reference(mesh):
    stand = _stand_in(mesh)
    cfg, jcfg = get_config("llama3.2-3b"), jget_config("llama3.2-3b")
    rules = sharding.axis_rules(cfg, stand)
    jrules = jsharding.axis_rules(jcfg, stand)
    for shape in ((3, 7), (2, 32), (32, 2), (6, 16), (1, 1)):
        for axes in (("embed", "heads"), ("vocab_fsdp", "embed_tp"),
                     ("layers", None), ("mlp", "embed")):
            notes, jnotes = [], []
            got = sharding.spec_for(shape, axes, rules, stand, notes)
            want = jsharding.spec_for(shape, axes, jrules, stand, jnotes)
            assert _spec(got) == _spec(want), (shape, axes)
            assert notes == jnotes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_the_reference(mesh):
    stand = _stand_in(mesh)
    for n in (1, 2, 3, 4, 6, 8, 32, 256):
        assert _spec(sharding.batch_spec((n, 7), stand)) == _spec(
            jsharding.batch_spec((n, 7), stand)), n
        assert sharding.bucket_specs(stand) == tuple(
            _norm(e) if e is not None else None
            for e in jsharding.bucket_specs(stand))
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in cfg.shapes:
            want = _jflat(jsharding.input_batch_specs(
                jinput_specs(jcfg, shape), stand), is_leaf=lambda x:
                isinstance(x, jax.sharding.PartitionSpec))
            got = _flat(sharding.input_batch_specs(input_specs(cfg, shape),
                                                   stand))
            assert list(got) == list(want), (arch, shape.name)
            for path in want:
                assert _spec(got[path]) == _spec(want[path]), (
                    arch, shape.name, path)


def test_positions3_keeps_its_batch_on_dim_1():
    stand = _stand_in("2x1")
    specs = sharding.input_batch_specs(
        {"tokens": (4, 8), "positions3": (3, 4, 8)}, stand)
    assert specs == {"tokens": (("data",), None),
                     "positions3": (None, ("data",), None)}
    assert sharding.batch_dim("positions3") == 1
    assert sharding.batch_dim("tokens") == 0


def test_moe_groups_for_equals_the_reference():
    from repro.launch.steps import moe_groups_for as jgroups
    for mesh in MESHES:
        stand = _stand_in(mesh)
        for arch in ("mixtral-8x22b", "llama3.2-3b"):
            for b in (1, 2, 3, 6, 8, 12, 256):
                assert steps.moe_groups_for(get_config(arch), stand, b) \
                    == jgroups(jget_config(arch), stand, b), (mesh, arch, b)


class _Mesh(types.SimpleNamespace):
    """A stand-in mesh whose groups are stand-ins (rank 0 of each): enough
    to build a step, not to run one."""
    device = torch.device("cpu")

    def group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return types.SimpleNamespace(
            axes=axes, index=0, size=int(np.prod([self.shape[a]
                                                  for a in axes])))


@pytest.mark.parametrize("what,shape,names,kw", [
    ("pod beside model", (2, 1, 2), ("pod", "data", "model"),
     {"fused_update": True}),
    ("pod beside model, split head", (2, 1, 3), ("pod", "data", "model"),
     {}),
    ("hybrid on model", (1, 3), ("data", "model"),
     {"arch": "recurrentgemma-2b"}),
    ("pod x data", (2, 2, 1), ("pod", "data", "model"),
     {"fused_update": True}),
    ("ssm on model, fused", (2, 3), ("data", "model"),
     {"fused_update": True, "arch": "mamba2-1.3b"}),
])
def test_what_item_12_7b_brings_is_refused(what, shape, names, kw):
    """What stays refused on the meshes of item 12.7b, each with its
    label: `fused_update` beside a pod axis, with or without a model axis,
    as the reference refuses it (the pod collective keeps the unfused
    update). The model sizes that were refused too (the reduced llama's 4
    query heads over 3 model ranks beside a pod axis, the reduced
    recurrentgemma's 4, mamba2's 8 SSD heads over 3 ranks, fused) now
    build their steps, the parts the specs replicate whole
    (`split_parts`; `tests/test_torch_model_sizes.py` runs them)."""
    from repro_torch.configs import reduced
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.compress import SketchCompressor
    mesh = _Mesh(shape=dict(zip(names, shape)), axis_names=names)
    kw = dict(kw)
    cfg = reduced(get_config(kw.pop("arch", "llama3.2-3b")))
    model = build_model(cfg)
    comp = SketchCompressor(SketchConfig(family="tt", k=16, rank=2,
                                         dims=(4, 8), bucket_elems=32))

    def build():
        return steps.build_train_step(
            model, ShapeSpec("t", 8, 4, "train"), mesh=mesh,
            compressor=comp, device="cpu", opt=AdamWConfig(clip_norm=None),
            **kw)
    whole = {"pod beside model, split head": {"attn", "moe", "unembed",
                                              "embed"},
             "hybrid on model": {"rec", "attn", "embed"},
             "ssm on model, fused": {"mixer", "embed"}}.get(what)
    if whole is not None:
        assert callable(build())
        parts = model.mod.split_parts(cfg, mesh)
        assert {p for p, split in parts.items() if not split} == whole
        return
    with pytest.raises(ValueError, match="run without a 'pod' mesh axis"
                       ) as err:
        build()
    assert "pod" in str(err.value)


def test_train_cli_refuses_a_model_axis(monkeypatch):
    """`--mesh PxDxM` with M > 1 builds a (pod, data, model) mesh over the
    ranks torchrun launched (tests/test_torch_pod_model.py runs it on
    eight); a mesh whose ranks are not the world's is refused."""
    from repro_torch.launch import train
    made = []
    monkeypatch.setattr(train, "make_mesh",
                        lambda *a, **kw: made.append((a, kw)) or "mesh")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert train.parse_mesh("2x1x2", device="cpu") == "mesh"
    assert made == [(((2, 1, 2), ("pod", "data", "model")),
                     {"device": "cpu", "backend": None})]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="holds 4 ranks but the world has 2"):
        train.parse_mesh("2x1x2")
    assert len(made) == 1
