"""K4's block form (`kernels/fused_update.py::fused_update_block`) and
`adamw.update_sketched(blocks=)` on the CPU, and `adamw.update` in chunks.

A rank of a data mesh holds its FSDP block of each leaf's params, m and
v, but the whole gradient, EF residual and sketch. K4's block form
reconstructs the whole leaf, writes the whole residual and updates only
the block, at the block's own offsets. Here its plain version is held bit
for bit against the rank's block of the whole-leaf plain K4
(`fused_update_buckets_plain` on the bucketized leaf): the same
reconstruction, the same elementwise epilogue on a subset of it. Leaves
split on dim 0, 1 and 2 (the FSDP specs of `embed`, `wq`/`w_gate`/...,
and `wo`/`w_down`) and unsplit (the norms), with a padded last bucket;
every rank's block. Against the reference's interpret-mode
`fused_update_buckets` on the same arrays at `tests/test_torch_optim.py`'s
3e-5. The tiled emulation (`fused_update_block_tiled_plain`: K2's tile
schedule with the block epilogue, the kernel's index arithmetic) against
the plain version at 1e-5 of max|ref| at ragged tile edges, and bit for
bit against the whole-leaf epilogue on the same tiles, every output
element written. `update_sketched(blocks=)` in
one process: the blocks of two ranks put together are the whole update
bit for bit, and the residual the same bits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.kernels import fused_update as jfused
from repro_torch import rp
from repro_torch.core import from_numpy_operator
from repro_torch.core.sketch import SketchConfig
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.kernels import fused_update as fused
from repro_torch.optim import adamw
from repro_torch.optim.compress import SketchCompressor

HP = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
LR, C1, C2 = 1e-3, 0.1, 0.05
# (leaf shape, split dim or None, ranks): a padded last bucket in each
# (their sizes are not multiples of the bucket's elements)
SPLITS = {"dim0": ((6, 50, 3), 0, 2), "dim1": ((3, 10, 22), 1, 2),
          "dim2": ((2, 5, 36), 2, 4), "unsplit": ((700,), None, 1)}


def _operator(family, k, dims, rank, seed):
    jop = jrp.make_projector(jrp.ProjectorSpec(
        family=family, k=k, dims=dims, rank=rank), jax.random.PRNGKey(seed))
    arrays = jop.cores if family == "tt" else jop.factors
    return jop, from_numpy_operator(family, [np.asarray(a) for a in arrays],
                                    "cpu")


def _port_operator(family, k, dims, rank, seed):
    """An operator of the port's own sampler (the tests that compare the
    port's forms with each other need no reference operator)."""
    return rp.make_projector(rp.ProjectorSpec(family, k, dims, rank), seed,
                             device="cpu")


def _leaf_case(shape, dims, k, seed):
    """A leaf's sketch rows and its whole p, w, m, v (numpy)."""
    size, bucket = math.prod(shape), math.prod(dims)
    nb = -(-size // bucket)
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((nb, k)).astype(np.float32)
    p, w, m, v = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    return y, p, w, m, np.abs(v)


def _buckets(a, nb, dims):
    flat = np.zeros(nb * math.prod(dims), np.float32)
    flat[:a.size] = a.reshape(-1)
    return flat.reshape((nb,) + tuple(dims))


def _blocks(shape, d, ranks):
    """Each rank's (layout, index) of the leaf."""
    if d is None:
        return [(fused.BlockLayout.of(shape), (slice(None),) * len(shape))]
    per = shape[d] // ranks
    out = []
    for r in range(ranks):
        lo, hi = r * per, (r + 1) * per
        out.append((fused.BlockLayout.of(shape, d, lo, hi), tuple(
            slice(lo, hi) if i == d else slice(None)
            for i in range(len(shape)))))
    return out


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("family", ["tt", "cp"])
def test_block_plain_is_the_whole_leafs_block_bit_for_bit(family, split):
    shape, d, ranks = SPLITS[split]
    dims, k = (4, 8, 16), 40
    op = _port_operator(family, k, dims, 2, 3)
    y, p, w, m, v = _leaf_case(shape, dims, k, 11)
    nb, size = y.shape[0], p.size
    whole = fused.fused_update_buckets_plain(
        op, torch.tensor(y), *(torch.tensor(_buckets(a, nb, dims))
                               for a in (p, w, m, v)), LR, C1, C2, **HP)
    whole = [t.reshape(-1)[:size].reshape(shape) for t in whole]
    for layout, index in _blocks(shape, d, ranks):
        blk = [torch.tensor(a)[index].contiguous() for a in (w, m, v)]
        got = fused.fused_update_block(op, torch.tensor(y), torch.tensor(p),
                                       *blk, LR, C1, C2, layout=layout, **HP)
        assert fused.fused_update_block.launches == 0      # CPU: plain
        assert tuple(got[0].shape) == shape
        assert torch.equal(got[0], whole[0])
        for a, b in zip(got[1:], whole[1:]):
            assert tuple(a.shape) == tuple(blk[0].shape)
            assert torch.equal(a, b[index])


@pytest.mark.parametrize("split", list(SPLITS))
def test_block_matches_the_reference_kernel(split):
    """Against the reference's interpret-mode K4 on the bucketized leaf,
    at tests/test_torch_optim.py's 3e-5."""
    shape, d, ranks = SPLITS[split]
    dims, k = (8, 6, 4, 10), 48
    jop, op = _operator("tt", k, dims, 2, 5)
    y, p, w, m, v = _leaf_case(shape, dims, k, 13)
    nb, size = y.shape[0], p.size
    want = jfused.fused_update_buckets(
        jop, jnp.asarray(y), *(jnp.asarray(_buckets(a, nb, dims))
                               for a in (p, w, m, v)),
        jnp.float32(LR), jnp.float32(C1), jnp.float32(C2), **HP,
        interpret=True)
    want = [np.asarray(t).reshape(-1)[:size].reshape(shape) for t in want]
    for layout, index in _blocks(shape, d, ranks):
        got = fused.fused_update_block(
            op, torch.tensor(y), torch.tensor(p),
            *(torch.tensor(a)[index].contiguous() for a in (w, m, v)),
            torch.tensor(LR), torch.tensor(C1), torch.tensor(C2),
            layout=layout, **HP)
        refs = [want[0]] + [t[index] for t in want[1:]]
        for g, r in zip(got, refs):
            np.testing.assert_allclose(g.numpy(), r, rtol=3e-5, atol=3e-5)


# (family, leaf shape, split dim, ranks, bucket dims, k, rank): ragged as
# test_torch_optim.py's FUSED_TILED_CASES (d1 against the slabs, T against
# the chunks, the buckets against the batch tiles, k against the depth
# chunks), each leaf ending in a padded bucket; the last rank's block
TILED = {"tt-order3-dim1": ("tt", (5, 86, 20), 1, 2, (6, 10, 14), 21, 3),
         "cp-order2-dim0": ("cp", (40, 31), 0, 4, (12, 20), 21, 3),
         "tt-order4-dim2": ("tt", (3, 2, 300), 2, 3, (7, 6, 5, 7), 21, 3),
         "cp-order3-unsplit": ("cp", (900,), None, 1, (6, 10, 14), 21, 12)}


@pytest.mark.parametrize("case", list(TILED))
def test_block_tiled_schedule_matches_the_plain_version(case):
    """The tiled emulation against the plain block form (itself held
    against the reference's kernel above) at 1e-5 of max|ref|, and bit
    for bit against the whole-leaf epilogue on the same tiles."""
    family, shape, d, ranks, dims, k, rank = TILED[case]
    op = _port_operator(family, k, dims, rank, 7)
    y, p, w, m, v = _leaf_case(shape, dims, k, 17)
    nb, size = y.shape[0], p.size
    assert size % math.prod(dims)      # a padded last bucket
    plan = fused.plan_fused_update(family, k, nb, dims, rank)
    whole = fused.block_epilogue(fused.BlockLayout.of((nb,) + dims), plan,
                                 *(torch.tensor(_buckets(a, nb, dims))
                                   for a in (p, w, m, v)), LR, C1, C2,
                                 **{key: HP[key] for key in (
                                     "b1", "b2", "eps", "weight_decay")})
    cores = [c.contiguous() for c in (
        op.factors if family == "cp" else fused.tt_cores_squeezed(op))]
    from repro_torch.kernels import _sweep
    _sweep.sweep_reconstruct_tiled_plain(
        torch.tensor(y), *cores, plan=plan,
        scale=HP["alpha"] / math.sqrt(k), epilogue=whole[0])
    whole = [t[:size].reshape(shape) for t in whole[1]]
    for layout, index in _blocks(shape, d, ranks)[-1:]:   # lo > 0 if split
        blk = [torch.tensor(a)[index].contiguous() for a in (w, m, v)]
        args = (op, torch.tensor(y), torch.tensor(p), *blk, LR, C1, C2)
        tiled = fused.fused_update_block_tiled_plain(*args, layout=layout,
                                                     **HP)
        plain = fused.fused_update_block_plain(*args, layout=layout, **HP)
        for i, (got, ref) in enumerate(zip(tiled, plain)):
            assert not torch.isnan(got).any()     # every element written
            assert torch.equal(got, whole[i] if i == 0 else whole[i][index])
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_block_wrapper_refuses_what_the_kernel_does_not_take():
    dims, k = (4, 8, 16), 40
    op = _port_operator("tt", k, dims, 2, 3)
    shape = (3, 10, 22)
    y, p, w, m, v = (torch.tensor(a) for a in _leaf_case(shape, dims, k, 1))
    layout = fused.BlockLayout.of(shape, 1, 0, 5)
    blk = [t[:, :5].contiguous() for t in (w, m, v)]
    with pytest.raises(ValueError, match="not a block"):
        fused.BlockLayout.of(shape, 1, 5, 11)
    with pytest.raises(ValueError, match="not a block"):
        fused.BlockLayout(660, 7, 22, 0, 3)
    with pytest.raises(ValueError, match="elements, the leaf"):
        fused.fused_update_block(op, y, p[:, :5].contiguous(), *blk, LR, C1,
                                 C2, layout=layout, **HP)
    with pytest.raises(ValueError, match="block operands"):
        fused.fused_update_block(op, y, p, w, m, v, LR, C1, C2,
                                 layout=layout, **HP)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_update_block(op, y, p, w[:, :5], *blk[1:], LR, C1, C2,
                                 layout=layout, **HP)
    with pytest.raises(TypeError, match="float32"):
        fused.fused_update_block(op, y, p, blk[0].double(), *blk[1:], LR,
                                 C1, C2, layout=layout, **HP)
    with pytest.raises(ValueError, match="does not fill"):
        fused.fused_update_block(op, y[:1], p, *blk, LR, C1, C2,
                                 layout=layout, **HP)
    # meta tensors (the dry run's) take the plain version and launch
    # nothing; the launch itself refuses a tensor that is not on CUDA
    meta = [t.to("meta") for t in (y, p, *blk)]
    mop = rp.make_projector(rp.ProjectorSpec("tt", k, dims, 2), 3,
                            device="meta")
    before = (fused.fused_update_block.launches,
              fused.fused_update_block.launches_2d)
    outs = fused.fused_update_block(mop, *meta, LR, C1, C2, layout=layout,
                                    **HP)
    assert [(t.device.type, tuple(t.shape)) for t in outs] == \
        [("meta", tuple(p.shape))] + [("meta", tuple(blk[0].shape))] * 3
    assert (fused.fused_update_block.launches,
            fused.fused_update_block.launches_2d) == before
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        fused._launch("fused_update_block", op, (), None, y, (), (), LR, C1,
                      C2, {})
    fused.fused_update_block.launches = 4
    fused.reset_launch_counts()
    assert fused.fused_update_block.launches == 0


def test_update_sketched_blocks_put_together_are_the_whole_update():
    """Two ranks' blocks (`blocks=` of each) of a three-leaf tree against
    the whole-leaf update on the same state: params, m and v bit for bit
    when the blocks are put back together, the residual the same bits."""
    cfg = SketchConfig(family="tt", k=32, rank=2, dims=(4, 8, 16),
                       bucket_elems=512)
    comp = SketchCompressor(cfg)
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (2, 12, 40), "b": (64, 24), "n": (24,)}
    dims = {"a": 1, "b": 0, "n": None}
    rand = lambda: {k: torch.randn(s, generator=gen)  # noqa: E731
                    for k, s in shapes.items()}
    params, grads, resid = rand(), rand(), rand()
    opt_cfg = adamw.AdamWConfig(clip_norm=None)
    state = {"m": rand(), "v": {k: t.abs() for k, t in rand().items()},
             "count": torch.tensor(4)}
    want = adamw.update_sketched(params, grads, {"residual": resid}, state,
                                 LR, opt_cfg, compressor=comp)

    def block(tree, r):
        out = {}
        for key, t in tree.items():
            d = dims[key]
            out[key] = t if d is None else t.chunk(2, d)[r].contiguous()
        return out

    got = []
    for r in range(2):
        ranges = []
        for key in sorted(shapes):
            d = dims[key]
            n = shapes[key][d] // 2 if d is not None else 0
            ranges.append(None if d is None else (d, r * n, (r + 1) * n))
        got.append(adamw.update_sketched(
            block(params, r), grads, {"residual": resid},
            {"m": block(state["m"], r), "v": block(state["v"], r),
             "count": state["count"]}, LR, opt_cfg, compressor=comp,
            blocks=ranges))
    for r in range(2):
        for a, b in zip(tree_leaves(got[r][2]), tree_leaves(want[2])):
            assert torch.equal(a, b)
        assert float(got[r][3]["fused_hbm_bytes"]) == float(
            want[3]["fused_hbm_bytes"])
    for part, pick in (("params", lambda o: o[0]),
                       ("m", lambda o: o[1]["m"]),
                       ("v", lambda o: o[1]["v"])):
        flat, _ = tree_flatten(pick(want))
        for i, key in enumerate(sorted(shapes)):
            d = dims[key]
            halves = [tree_flatten(pick(got[r]))[0][i] for r in range(2)]
            whole = halves[0] if d is None else torch.cat(halves, d)
            assert torch.equal(whole, flat[i]), (part, key)
    with pytest.raises(ValueError, match="block ranges"):
        adamw.update_sketched(params, grads, {"residual": resid}, state, LR,
                              opt_cfg, compressor=comp, blocks=[None])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_in_chunks_gives_the_same_bits(monkeypatch, dtype):
    """`adamw.update` takes a leaf above `UPDATE_CHUNK` elements in chunks
    (the data-mesh steps' memory at full width): elementwise math, so the
    same bits as one pass, in the moments' and params' dtypes."""
    gen = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    rand = lambda: {"a": torch.randn(7, 33, generator=gen).to(dt),  # noqa: E731
                    "n": torch.randn(5, generator=gen).to(dt)}
    params, grads = rand(), rand()
    cfg = adamw.AdamWConfig(moment_dtype=dt)
    state = {"m": rand(), "v": {k: t.abs() for k, t in rand().items()},
             "count": torch.tensor(2)}
    whole = adamw.update(params, grads, state, LR, cfg)
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 10)
    chunked = adamw.update(params, grads, state, LR, cfg)
    for part in (lambda o: o[0], lambda o: o[1]["m"], lambda o: o[1]["v"]):
        for a, b in zip(tree_leaves(part(chunked)), tree_leaves(part(whole))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(chunked[2]["grad_norm"]) == float(whole[2]["grad_norm"])
