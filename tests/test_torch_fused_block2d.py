"""K4's block form split on two dims (`kernels/fused_update.py::
fused_update_block` with a second range, `csrc/fused_update.cu`'s
`fused_update_block2_launch`) on the CPU.

On a (data, model) mesh a rank's block of a leaf can be split on two
dims: `wq` (L, D, Hq*hd) on dim 1 over 'data' and dim 2 over 'model',
`wo` (L, Hq*hd, D) on dim 1 over 'model' and dim 2 over 'data', the
embedding (V, D) on dims 0 and 1, an expert leaf (L, E, D, F) on dims 1
(experts, 'model') and 2 (embed, 'data'), or dims 2 and 3 under the
`expert_mlp` fallback. Every rank of a 2 x 2 grid (and a 2 x 4 one) of
each: its block of the plain two-dim form bit for bit against the
rank's block of the whole-leaf plain K4 (`fused_update_buckets_plain`
on the bucketized leaf), the residual bit for bit too; the tiled
emulation (K2's tile schedule with the block epilogue, the kernel's
index arithmetic) bit for bit against the whole-leaf epilogue on the
same tiles at ragged edges, every element written; the CUDA source,
built by `g++` against `tests/test_torch_fused_source.py`'s stand-in
runtime, its two-dim entry bit for bit against its whole-leaf entry;
`update_sketched(blocks=)` with two-dim ranges, the four ranks' blocks
put together the whole update. Each leaf ends in a padded last bucket.
"""
import math

import pytest
import torch

from repro_torch import rp
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.kernels import _sweep
from repro_torch.kernels import fused_update as fused
from repro_torch.optim import adamw
from repro_torch.optim.compress import SketchCompressor

from test_torch_fused_source import _launch, lib  # noqa: F401 (a fixture)

HP = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
LR, C1, C2 = 1e-3, 0.1, 0.05
# name: (leaf shape, (dim a, ranks of a), (dim b, ranks of b))
LAYOUTS = {"wq": ((2, 12, 40), (1, 2), (2, 2)),
           "wo": ((2, 40, 12), (1, 2), (2, 2)),
           "embed": ((60, 24), (0, 2), (1, 4)),
           "experts": ((2, 4, 12, 10), (1, 2), (2, 2)),
           "expert_mlp": ((2, 3, 12, 10), (2, 2), (3, 2))}
DIMS, K = (4, 8, 16), 40


def _grid(shape, a, b):
    """Every rank's (layout, index) of a leaf split on dims a and b."""
    (da, na), (db, nb) = a, b
    pa, pb = shape[da] // na, shape[db] // nb
    out = []
    for i in range(na):
        for j in range(nb):
            index = [slice(None)] * len(shape)
            index[da] = slice(i * pa, (i + 1) * pa)
            index[db] = slice(j * pb, (j + 1) * pb)
            out.append((fused.BlockLayout.of(shape, da, i * pa, (i + 1) * pa,
                                             db, j * pb, (j + 1) * pb),
                        tuple(index)))
    return out


def _case(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    size, bucket = math.prod(shape), math.prod(DIMS)
    nb = -(-size // bucket)
    assert size % bucket       # a padded last bucket
    y = torch.randn((nb, K), generator=gen)
    p, w, m, v = (torch.randn(shape, generator=gen) for _ in range(4))
    return y, p, w, m, v.abs()


def _buckets(t, nb):
    flat = torch.zeros(nb * math.prod(DIMS))
    flat[:t.numel()] = t.reshape(-1)
    return flat.reshape((nb,) + DIMS)


def _whole(op, y, p, w, m, v):
    nb = y.shape[0]
    outs = fused.fused_update_buckets_plain(
        op, y, *(_buckets(t, nb) for t in (p, w, m, v)), LR, C1, C2, **HP)
    return [t.reshape(-1)[:p.numel()].reshape(p.shape) for t in outs]


def test_layout_of_two_dims():
    layout = fused.BlockLayout.of((2, 12, 40), 1, 6, 12, 2, 0, 20)
    assert layout.two_dim and layout.mid == 1 and layout.inner_b == 1
    assert layout.shape == (2, 6, 1, 20, 1) and layout.numel == 240
    assert layout.tail() == (960, 12, 40, 6, 12, 40, 1, 0, 20)
    one = fused.BlockLayout.of((2, 12, 40), 1, 6, 12)
    assert not one.two_dim and one.tail() == (960, 12, 40, 6, 12)
    assert one.shape == (2, 6, 40)
    with pytest.raises(ValueError, match="must follow"):
        fused.BlockLayout.of((2, 12, 40), 2, 0, 20, 1, 0, 6)
    with pytest.raises(ValueError, match="not a block"):
        fused.BlockLayout.of((2, 12, 40), 1, 0, 6, 2, 20, 20)


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("family", ["tt", "cp"])
def test_two_dim_plain_is_the_whole_leafs_block_bit_for_bit(family, name):
    shape, a, b = LAYOUTS[name]
    op = rp.make_projector(rp.ProjectorSpec(family, K, DIMS, 2), 3,
                           device="cpu")
    y, p, w, m, v = _case(shape, 11)
    whole = _whole(op, y, p, w, m, v)
    for layout, index in _grid(shape, a, b):
        blk = [t[index].contiguous() for t in (w, m, v)]
        got = fused.fused_update_block(op, y, p, *blk, LR, C1, C2,
                                       layout=layout, **HP)
        assert fused.fused_update_block.launches_2d == 0    # CPU: plain
        assert torch.equal(got[0], whole[0])
        for g, want in zip(got[1:], whole[1:]):
            assert tuple(g.shape) == tuple(blk[0].shape)
            assert torch.equal(g, want[index])


# (leaf shape, dim a and its ranks, dim b and its ranks, bucket dims, k,
# rank): ragged as the one-dim TILED cases of test_torch_fused_block.py
TILED = {"wq-tt-order3": ((3, 10, 44), (1, 2), (2, 2), (6, 10, 14), 21, 3),
         "expert-cp-order4": ((2, 4, 14, 27), (1, 2), (2, 2), (7, 6, 5, 7),
                              21, 3),
         "embed-tt-order2": ((90, 28), (0, 2), (1, 4), (12, 20), 21, 3)}


@pytest.mark.parametrize("case", list(TILED))
def test_two_dim_tiled_schedule_is_the_whole_epilogue_bit_for_bit(case):
    shape, a, b, dims, k, rank = TILED[case]
    family = "cp" if "cp" in case else "tt"
    op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank), 7,
                           device="cpu")
    gen = torch.Generator().manual_seed(17)
    size, bucket = math.prod(shape), math.prod(dims)
    nb = -(-size // bucket)
    assert size % bucket
    y = torch.randn((nb, k), generator=gen)
    p, w, m, v = (torch.randn(shape, generator=gen) for _ in range(4))
    v = v.abs()
    plan = fused.plan_fused_update(family, k, nb, dims, rank)

    def buckets(t):
        flat = torch.zeros(nb * bucket)
        flat[:size] = t.reshape(-1)
        return flat.reshape((nb,) + dims)

    epi, outs = fused.block_epilogue(
        fused.BlockLayout.of((nb,) + dims), plan,
        *(buckets(t) for t in (p, w, m, v)), LR, C1, C2,
        **{key: HP[key] for key in ("b1", "b2", "eps", "weight_decay")})
    cores = [c.contiguous() for c in (
        op.factors if family == "cp" else fused.tt_cores_squeezed(op))]
    _sweep.sweep_reconstruct_tiled_plain(
        y, *cores, plan=plan, scale=HP["alpha"] / math.sqrt(k), epilogue=epi)
    whole = [t[:size].reshape(shape) for t in outs]
    for layout, index in _grid(shape, a, b):
        blk = [t[index].contiguous() for t in (w, m, v)]
        args = (op, y, p, *blk, LR, C1, C2)
        tiled = fused.fused_update_block_tiled_plain(*args, layout=layout,
                                                     **HP)
        plain = fused.fused_update_block_plain(*args, layout=layout, **HP)
        for i, (got, ref) in enumerate(zip(tiled, plain)):
            assert not torch.isnan(got).any()     # every element written
            assert torch.equal(got, whole[i] if i == 0 else whole[i][index])
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_two_dim_source_is_the_whole_sources_block_bit_for_bit(lib, name):
    import ctypes
    fn = lib.fused_update_block2_launch
    fn.argtypes = _sweep._ARGTYPES["fused_update_block2"]
    fn.restype = ctypes.c_int
    shape, a, b = LAYOUTS[name]
    op = rp.make_projector(rp.ProjectorSpec("tt", K, DIMS, 2), 3,
                           device="cpu")
    y, p, w, m, v = _case(shape, 5)
    nb = y.shape[0]
    dense = tuple(_buckets(t, nb) for t in (p, w, m, v))
    whole = tuple(torch.full_like(dense[0], float("nan")) for _ in range(4))
    _launch(lib, "fused_update", op, y, dense, whole, ())
    whole = [t.reshape(-1)[:p.numel()].reshape(shape) for t in whole]
    for layout, index in _grid(shape, a, b):
        blk = tuple(t[index].contiguous() for t in (w, m, v))
        outs = (torch.full_like(p, float("nan")),) + tuple(
            torch.full_like(blk[0], float("nan")) for _ in range(3))
        _launch(lib, "fused_update_block2", op, y, (p,) + blk, outs,
                layout.tail())
        assert torch.equal(outs[0], whole[0])
        for got, want in zip(outs[1:], whole[1:]):
            assert torch.equal(got, want[index])
    with pytest.raises(AssertionError, match="returned 1"):  # lo_b >= hi_b
        _launch(lib, "fused_update_block2", op, y, (p,) + blk, outs,
                layout.tail()[:-2] + (3, 3))


def test_update_sketched_two_dim_blocks_put_together():
    """Four ranks of a 2 x 2 grid (`blocks=` two-dim ranges, as
    `fsdp.Sharded.ranges` gives them) against the whole-leaf update:
    params, m and v bit for bit put back together, the residual the same
    bits on every rank."""
    cfg = SketchConfig(family="tt", k=32, rank=2, dims=(4, 8, 16),
                       bucket_elems=512)
    comp = SketchCompressor(cfg)
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (2, 12, 40), "b": (64, 24), "n": (24,)}
    splits = {"a": ((1, 2), (2, 2)), "b": ((0, 2), (1, 2)), "n": None}
    rand = lambda: {k: torch.randn(s, generator=gen)  # noqa: E731
                    for k, s in shapes.items()}
    params, grads, resid = rand(), rand(), rand()
    opt_cfg = adamw.AdamWConfig(clip_norm=None)
    state = {"m": rand(), "v": {k: t.abs() for k, t in rand().items()},
             "count": torch.tensor(4)}
    want = adamw.update_sketched(params, grads, {"residual": resid}, state,
                                 LR, opt_cfg, compressor=comp)
    grids = {k: _grid(shapes[k], *splits[k]) if splits[k] else
             [(None, (slice(None),))] * 4 for k in shapes}
    got = []
    for r in range(4):
        def block(tree):
            return {k: t[grids[k][r][1]].contiguous() for k, t in
                    tree.items()}
        ranges = []
        for key in sorted(shapes):
            lay = grids[key][r][0]
            if lay is None:
                ranges.append(None)
                continue
            (da, _), (db, _) = splits[key]
            idx = grids[key][r][1]
            ranges.append((da, idx[da].start, idx[da].stop,
                           db, idx[db].start, idx[db].stop))
        got.append(adamw.update_sketched(
            block(params), grads, {"residual": resid},
            {"m": block(state["m"]), "v": block(state["v"]),
             "count": state["count"]}, LR, opt_cfg, compressor=comp,
            blocks=ranges))
    for r in range(4):
        for a, b in zip(tree_leaves(got[r][2]), tree_leaves(want[2])):
            assert torch.equal(a, b)
    for pick in (lambda o: o[0], lambda o: o[1]["m"], lambda o: o[1]["v"]):
        flat, _ = tree_flatten(pick(want))
        for i, key in enumerate(sorted(shapes)):
            for r in range(4):
                part = tree_flatten(pick(got[r]))[0][i]
                assert torch.equal(part, flat[i][grids[key][r][1]]), key
