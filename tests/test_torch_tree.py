"""The port's pytree helpers leave no reference cycles.

`core/tree.py`'s recursions once were nested functions that called
themselves: each call left a cycle (the function and its closure cell)
that held the leaves, so the whole trees of a train step (old params and
moments, gradients, the EF residual) stayed alive until Python's cyclic
collector ran, and four ranks sharing one card ran out of memory in
`chip_smoke.py` phase 21. With the collector off, a tree's leaves must go
when the tree does, and two reduced train steps must leave no tensor in
cyclic garbage.
"""
import functools
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import schedule
from repro_torch.optim.compress import SketchCompressor


@pytest.fixture
def no_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def test_tree_functions_leave_no_reference_cycle(no_collector):
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    tree = {"a": leaf, "b": [torch.ones(2), (torch.ones(1),)]}
    leaves, treedef = tree_flatten(tree)
    again = tree_unflatten(treedef, leaves)
    mapped = tree_map(lambda x, y: x, tree, again)
    assert tree_leaves(mapped)[0] is leaf
    del leaf, tree, leaves, again, mapped
    assert ref() is None


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_train_steps_leave_no_tensor_in_a_cycle(no_collector, compress):
    model = build_model(reduced(get_config("llama3.2-3b")))
    comp = (SketchCompressor(SketchConfig(family="tt", k=64, rank=2,
                                          dims=(4, 8, 16), bucket_elems=512))
            if compress else None)
    step = steps.build_train_step(
        model, ShapeSpec("t", 16, 2, "train"), compressor=comp,
        device="cpu", compute_dtype=torch.float32,
        lr_fn=functools.partial(schedule.constant, peak_lr=1e-2))
    state = steps.init_train_state(model, torch.Generator().manual_seed(0),
                                   compressor=comp)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=2))
    gc.collect()
    for i in range(2):
        state, _ = step(state, data.batch(i))
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert held == []
