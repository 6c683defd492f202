"""repro_torch.rp.shard, launch.mesh and launch.sharding against repro's.

The reference's `shard_map` entry points do not run under this JAX
(ROADMAP.md "Reference caveats"), so the port is held against the
reference's mesh-free parts: its `bucket_pspec` / `bucket_specs` on a
stand-in mesh (an object with `.shape` and `.axis_names`; JAX stores a
one-axis entry as the bare name, normalized here), its
`collective_wire_bytes`, its unsharded `rp.project` / `rp.reconstruct`
and `PytreeSketcher.sketch`, and its int8 quantizer under
`jax.vmap(axis_name="pod")`. The port's side runs on 2 and 4 gloo ranks
(`tests/torch_dist_workers.py`), once a world size for the whole file;
the reference's operators are carried across as numpy. Sketches and
reconstructions are held to 1e-5 of their largest entry (fp32, other
summation orders); int8 payloads must be equal, and the dequantized mean
the same bits on every rank and in every run.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro.core.sketch import PytreeSketcher as JSketcher
from repro.core.sketch import SketchConfig as JSketchConfig
from repro.launch import sharding as jsharding
from repro.rp import plan as jplan
from repro.rp import shard as jshard
from repro_torch import rp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.launch.train import parse_mesh
from repro_torch.rp import shard

from torch_dist_workers import run_ranks

TOL = 1e-5
CFG = dict(family="tt", k=64, rank=2, dims=(4, 8, 16), bucket_elems=512)
WORLDS = {2: ((2,), ("data",), ("data",)),
          4: ((2, 2), ("pod", "data"), ("pod", "data"))}


def _norm(entry):
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _stand_in(shape: dict):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# specs, wire bytes and meshes: no ranks needed
# ---------------------------------------------------------------------------

PSPEC_CASES = [  # test_shard.py::test_bucket_pspec_divisibility
    (8, {}), (2, {}), (3, {}), (8, {"exclude": ("pod",)}),
    (8, {"axes": ("data",)})]


@pytest.mark.parametrize("n, kw", PSPEC_CASES)
def test_bucket_pspec_matches_reference(n, kw):
    mesh = _stand_in({"pod": 2, "data": 4})
    got = shard.bucket_pspec(mesh, n, **kw)
    want = jshard.bucket_pspec(mesh, n, **kw)
    assert len(got) == 1 and got[0] == _norm(want[0])
    assert shard.shard_entry(mesh, got)[1:] == jshard.shard_entry(
        mesh, want)[1:]


@pytest.mark.parametrize("shape, exclude", [
    ({"pod": 2, "data": 4, "model": 2}, ()),
    ({"pod": 2, "data": 4, "model": 2}, ("pod",)),
    ({"data": 4, "model": 2}, ()),
    ({"data": 4, "model": 2}, ("data",)),
    ({"pod": 2, "data": 1, "model": 1}, ("pod",))])
def test_bucket_specs_matches_reference(shape, exclude):
    mesh = _stand_in(shape)
    got = sharding.bucket_specs(mesh, exclude=exclude)
    want = jsharding.bucket_specs(mesh, exclude=exclude)
    assert len(got) == 1 and _norm(got[0]) == _norm(want[0])


@pytest.mark.parametrize("wire", ["fp32", "int8"])
@pytest.mark.parametrize("sync", ["sketch-mean", "local-mean"])
@pytest.mark.parametrize("nb, k, n, leaves", [
    (571, 1024, 595_344_384, 11), (5, 64, 2561, 2), (1, 128, 100, 1)])
def test_collective_wire_bytes_matches_reference(sync, wire, nb, k, n,
                                                 leaves):
    kw = dict(sync=sync, wire=wire, sketch_bytes=nb * k * 4,
              dense_bytes=n * 4, n_buckets=nb, n_leaves=leaves)
    assert rp.collective_wire_bytes(**kw) == jplan.collective_wire_bytes(
        **kw)


def test_cost_ledger_carries_wire_bytes():
    op = rp.make_projector(rp.ProjectorSpec("tt", 16, (4, 4), 2), seed=0,
                           device="cpu")
    plan = rp.explain(op, torch.zeros(3, 4, 4))
    assert plan.cost.wire_bytes == 0
    assert "wire_bytes=0" in plan.describe()


def test_mesh_errors_before_any_process_group():
    with pytest.raises(RuntimeError, match="needs a world of 512"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="positive divisor"):
        tmesh.make_host_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="pair up"):
        tmesh.make_mesh((2, 2), ("pod",), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tmesh.make_mesh((1,), ("pod",), device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.make_mesh((1,), ("pod",), device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nproc-per-node 4"):
        parse_mesh("2x2x1", device="cpu")
    with pytest.raises(ValueError, match="AxB"):
        parse_mesh("2x2x1x1", device="cpu")
    assert parse_mesh(None, device="cpu") is None
    assert not torch.distributed.is_initialized()
    assert tmesh.data_axes(_stand_in({"pod": 2, "data": 2, "model": 2})) == (
        "pod", "data")
    assert tmesh.model_size(_stand_in({"data": 2})) == 1


def test_quantize_refuses_more_than_127_pods():
    with pytest.raises(ValueError, match="at most 127 pods"):
        shard.quantize_for_psum(torch.ones(2, 4), None, 128)
    with pytest.raises(ValueError, match="at most 127 pods"):
        jshard.quantize_for_psum(jnp.ones((2, 4)), "pod", 128)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _payload(world):
    r = np.random.default_rng(world)
    jcfg = JSketchConfig(**CFG)
    key = jax.random.PRNGKey(42)
    jop = jrp.make_projector(jcfg.spec(), key)
    nb = 8
    x = r.standard_normal((nb,) + CFG["dims"]).astype(np.float32)
    y = r.standard_normal((nb, CFG["k"])).astype(np.float32)
    tree = {"a": r.standard_normal((16, 256)).astype(np.float32),
            "b": r.standard_normal((1500,)).astype(np.float32)}
    ys = r.standard_normal((world, nb, CFG["k"])).astype(np.float32)
    ys[:, 0] *= 40.0                        # rows of other scales
    shape, names, axes = WORLDS[world]
    return {"ops": {42: ("tt", [np.asarray(c) for c in jop.cores])},
            "seed": 42, "axes": axes, "x": x, "y": y, "odd": 3, "tree": tree,
            "cfg": CFG, "ys": ys}, jop, key


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda w: f"{w}r")
def ranks(request, tmp_path_factory):
    world = request.param
    pl, jop, key = _payload(world)
    shape, names, _ = WORLDS[world]
    out = run_ranks("shard", world, tmp_path_factory.mktemp(f"shard{world}"),
                    pl, shape=shape, names=names)
    return world, pl, jop, key, out


def test_project_sharded_blocks_equal_the_unsharded_projection(ranks):
    world, pl, jop, _, out = ranks
    want = np.asarray(jrp.project(jop, jnp.asarray(pl["x"])))
    got = torch.cat([o["block"] for o in out])
    assert [tuple(o["block"].shape) for o in out] == [(8 // world, 64)] * world
    assert _rel(got, want) <= TOL
    assert all(o["project_calls"] == 1 for o in out)   # one dispatch a rank
    for o in out:
        assert torch.equal(o["default_spec_block"], o["block"])


def test_reconstruct_sharded_blocks_equal_the_unsharded_adjoint(ranks):
    world, pl, jop, _, out = ranks
    want = np.asarray(jrp.reconstruct(jop, jnp.asarray(pl["y"])))
    got = torch.cat([o["recon"] for o in out])
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL
    assert all(o["reconstruct_calls"] == 1 for o in out)


def test_indivisible_bucket_count_is_a_typed_error(ranks):
    _, _, _, _, out = ranks
    assert all("not divisible" in o["odd_error"] for o in out)


def test_sketch_tree_sharded_equals_the_reference_sketcher(ranks):
    world, pl, _, key, out = ranks
    jcfg = JSketchConfig(**CFG)
    tree = {k: jnp.asarray(v) for k, v in pl["tree"].items()}
    want = np.asarray(JSketcher(jcfg, tree).sketch(tree, key))
    assert want.shape == (8 + 3, 64)
    for o in out:
        assert _rel(o["tree_sketch"], want) <= TOL
        assert torch.equal(o["tree_sketch"], out[0]["tree_sketch"])
        assert o["tree_calls"] == 2                 # one dispatch a leaf
        # leaf "a" (8 buckets) splits and is gathered; "b" (3) runs whole
        assert [(r["tag"], r["op"], r["calls"], r["bytes"])
                for r in o["tree_ledger"]] == [
            ("sketch", "all_gather", 1, 8 // world * 64 * 4)]


def test_mesh_groups_follow_mesh_order(ranks):
    world, _, _, _, out = ranks
    for r, o in enumerate(out):
        assert o["index"] == r
        if world == 4:
            assert o["coordinate"] == {"pod": r // 2, "data": r % 2}


@pytest.mark.parametrize("per_row", [True, False])
def test_int8_quantizer_equals_the_reference_and_repeats(ranks, per_row):
    world, pl, _, _, out = ranks

    def ref(y):
        q, s = jshard.quantize_for_psum(y, "pod", world, per_row=per_row)
        return q, s, jshard.dequantize_psum(jax.lax.psum(q, "pod"), s, world)

    jq, js, jdeq = jax.vmap(ref, axis_name="pod")(jnp.asarray(pl["ys"]))
    for r, o in enumerate(out):
        (q, s, deq), (q2, s2, deq2) = o[f"int8_{per_row}"]
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq[r]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js[r]))
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq[r]))
        assert torch.equal(q, q2) and torch.equal(deq, deq2)
        assert torch.equal(deq, out[0][f"int8_{per_row}"][0][2])
    # within half a step of the fp32 mean
    mean = pl["ys"].mean(0)
    deq = out[0][f"int8_{per_row}"][0][2].numpy()
    step = np.abs(pl["ys"]).max(axis=(0, 2) if per_row else None) / (
        127 // world)
    bound = step[:, None] if per_row else step
    assert (np.abs(deq - mean) <= bound / 2 + 1e-6).all()
