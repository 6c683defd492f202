"""The port's roofline and report (`launch/roofline.py`,
`launch/report.py`) and the dry run's settings against repro.

* the ring model: a ledger row (the bytes one rank contributes) of each
  collective over groups of 2, 4 and 16 gives the traffic and output
  bytes `repro.launch.roofline.parse_collectives` reads off the
  equivalent HLO line;
* `analyze_extrapolated` on the numbers of
  `tests/test_optim_runtime.py::test_roofline_extrapolation_linear`, and
  `analyze` on one count;
* `model_flops_for` of every arch and shape;
* `roofline_table`, `dryrun_table` and `collective_detail` string-equal
  to the reference's on the same cells (ok, skip and missing ones);
* `count_step`: a product's flops and bytes, the same counts with a
  composite op whole (under `inference_mode`) and decomposed, the
  memory of a run;
* `flash_p_bf16`: the port's attention against the reference's with the
  flag set (1e-5 of the largest output; both take bf16 softmax weights
  into an fp32 sum), and apart from the fp32 product by more than 1e-4;
  `unroll_scans` accepted and `scan_unroll()` the reference's values.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro.models import layers as jlayers
from repro.models import settings as jsettings
from repro_torch.configs import ARCHS
from repro_torch.launch import report, roofline
from repro_torch.models import layers, settings

NBYTES = 4 * 64 * 16     # one rank's payload: divisible by every group size
# the ledger op, its HLO op, and the output bytes of `NBYTES` contributed
OPS = {"all_reduce": ("all-reduce", lambda b, n: b),
       "all_gather": ("all-gather", lambda b, n: b * n),
       "reduce_scatter": ("reduce-scatter", lambda b, n: b // n)}


def _mesh(**shape):
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _row(op, nbytes, axes=("model",), calls=1, tag="t", dtype="float32"):
    return {"tag": tag, "op": op, "reduce": "sum", "dtype": dtype,
            "axes": list(axes), "calls": calls, "bytes": nbytes}


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("op", list(OPS))
def test_ring_model_matches_parse_collectives(op, n):
    hlo_op, out_of = OPS[op]
    out = out_of(NBYTES, n)
    line = (f"  %c = f32[{out // 4}]{{0}} {hlo_op}(%x), "
            f"replica_groups=[{32 // n},{n}]<=[32], dimensions={{0}}\n")
    want = jroofline.parse_collectives(line)
    got = roofline.collectives_from_ledger([_row(op, NBYTES)],
                                           _mesh(data=32 // n, model=n))
    assert got["per_type"] == want["per_type"]
    assert got["link_bytes_per_device"] == want["link_bytes_per_device"]
    assert got["per_tag"]["t"] == want["per_type"][hlo_op]


def test_a_group_of_one_moves_nothing():
    got = roofline.collectives_from_ledger(
        [_row("all_reduce", NBYTES, axes=("data",))], _mesh(data=1, model=2))
    assert got["per_type"] == {} and got["link_bytes_per_device"] == 0.0


def _count(flops, nbytes, rows, mesh):
    return roofline.StepCount(flops, nbytes, rows,
                              roofline.collectives_from_ledger(rows, mesh),
                              {}, 0.0)


def test_analyze_extrapolated_matches_the_reference():
    """The reference test's numbers: cost(n) = a + b n from two probes."""
    class Fake:
        def __init__(self, flops, byts, hlo):
            self._f, self._b, self._h = flops, byts, hlo

        def cost_analysis(self):
            return {"flops": self._f, "bytes accessed": self._b}

        def as_text(self):
            return self._h

    hlo1 = ('  %ar = f32[256]{0} all-reduce(%x), '
            'replica_groups=[16,16]<=[256], to_apply=%a\n')
    jcfg = JARCHS["llama3.2-3b"]
    want = jroofline.analyze_extrapolated(
        Fake(100.0, 1000.0, hlo1), Fake(150.0, 1600.0, hlo1 * 2), 1.0, 2.0,
        10.0, arch="x", shape=jcfg.shape("train_4k"), mesh_name="m",
        n_devices=256, cfg=jcfg, memory={})
    mesh = _mesh(data=16, model=16)
    cfg = ARCHS["llama3.2-3b"]
    got = roofline.analyze_extrapolated(
        _count(100.0, 1000.0, [_row("all_reduce", 1024)], mesh),
        _count(150.0, 1600.0, [_row("all_reduce", 2048, calls=2)], mesh),
        1.0, 2.0, 10.0, arch="x", shape=cfg.shape("train_4k"),
        mesh_name="m", n_devices=256, cfg=cfg, memory={})
    assert abs(got.hlo_flops_per_device - (50 + 50 * 10)) < 1e-6
    assert abs(got.hlo_bytes_per_device - (400 + 600 * 10)) < 1e-6
    assert got.hlo_flops_per_device == want.hlo_flops_per_device
    assert got.hlo_bytes_per_device == want.hlo_bytes_per_device
    assert got.collective["per_type"] == want.collective["per_type"]
    assert got.collective["link_bytes_per_device"] == \
        want.collective["link_bytes_per_device"]
    assert got.collective["per_type"]["all-reduce"]["count"] == 10.0
    assert got.model_flops == want.model_flops
    # the H100's constants in the reference's arithmetic
    assert got.compute_s == got.hlo_flops_per_device / 989e12
    assert got.memory_s == got.hlo_bytes_per_device / 3.35e12
    assert got.collective_s == \
        got.collective["link_bytes_per_device"] / 450e9
    assert got.bottleneck == "collective"   # 19200 link bytes, 6400 HBM


def test_analyze_is_the_references_arithmetic_on_one_count():
    class Fake:
        def cost_analysis(self):
            return {"flops": 3e12, "bytes accessed": 2e11}

        def as_text(self):
            return ('  %ag = bf16[4096]{0} all-gather(%x), '
                    'replica_groups=[16,16]<=[256], dimensions={0}\n')

    jcfg, cfg = JARCHS["mamba2-1.3b"], ARCHS["mamba2-1.3b"]
    want = jroofline.analyze(Fake(), arch="a", shape=jcfg.shape("train_4k"),
                             mesh_name="m", n_devices=256, cfg=jcfg)
    rows = [_row("all_gather", 512, dtype="bfloat16")]
    got = roofline.analyze(_count(3e12, 2e11, rows, _mesh(data=16, model=16)),
                           arch="a", shape=cfg.shape("train_4k"),
                           mesh_name="m", n_devices=256, cfg=cfg)
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device",
                "model_flops", "useful_flops_frac"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.collective["per_type"] == want.collective["per_type"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_for_equals_the_reference(arch, shape):
    assert roofline.model_flops_for(ARCHS[arch], ARCHS[arch].shape(shape)) \
        == jroofline.model_flops_for(JARCHS[arch], JARCHS[arch].shape(shape))


def _cells():
    """Cells as both dry runs write them: ok on both meshes, a skip, and
    (by their absence) missing ones."""
    def ok(arch, shape, mesh, k):
        return {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train",
                "status": "ok", "compile_s": 12.3 * k, "roofline": {
                    "compute_s": 0.125 * k, "memory_s": 0.5 / k,
                    "collective_s": 0.0625 * k, "bottleneck": "memory",
                    "useful_flops_frac": 0.4 * k,
                    "memory_per_device": {
                        "peak_bytes_per_device": 3.5 * 2**30 * k},
                    "collective": {"per_type": {
                        "all-gather": {"count": 7.0 * k, "bytes": 1.0,
                                       "traffic": 2.5 * 2**30},
                        "all-reduce": {"count": 3.0, "bytes": 1.0,
                                       "traffic": 0.25 * 2**30 * k}}}}}
    return [ok("llama3.2-3b", "train_4k", "16x16", 1),
            ok("llama3.2-3b", "train_4k", "2x16x16", 2),
            ok("mamba2-1.3b", "decode_32k", "16x16", 3),
            {"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "16x16",
             "kind": "decode", "status": "skip", "reason": "too long"}]


@pytest.mark.parametrize("table", ["roofline-16x16", "roofline-2x16x16",
                                   "dryrun", "detail", "detail-missing"])
def test_report_tables_equal_the_references(table):
    cells = json.loads(json.dumps(_cells()))
    if table.startswith("roofline"):
        mesh = table.split("-")[1]
        got = report.roofline_table(cells, mesh)
        want = jreport.roofline_table(cells, mesh)
    elif table == "dryrun":
        got, want = report.dryrun_table(cells), jreport.dryrun_table(cells)
    else:
        key = (("mamba2-1.3b", "decode_32k", "16x16") if table == "detail"
               else ("llama3.2-3b", "prefill_32k", "2x16x16"))
        got = report.collective_detail(cells, *key, tag_note="(n)")
        want = jreport.collective_detail(cells, *key, tag_note="(n)")
    assert got == want


def test_count_step_counts_a_product_and_its_memory():
    a = torch.empty(8, 64, device="meta")
    b = torch.empty(64, 32, device="meta")

    def fn(a, b):
        t = (a @ b).relu()
        return t.sum()

    out, c = roofline.count_step(fn, a, b)
    assert out.device.type == "meta"
    assert c.flops == 2 * 8 * 64 * 32
    # mm: a, b in, t out; relu: t in, t' out; sum: t' in, a scalar out
    assert c.bytes == 4 * (8 * 64 + 64 * 32 + 8 * 32) + 4 * 2 * 8 * 32 \
        + 4 * (8 * 32 + 1)
    assert c.memory["argument_size_in_bytes"] == 4 * (8 * 64 + 64 * 32)
    assert c.memory["output_size_in_bytes"] == 4
    # the product's output and the relu's live together at the peak
    assert c.memory["peak_bytes_per_device"] == \
        c.memory["argument_size_in_bytes"] + 4 * 2 * 8 * 32
    assert c.ledger == [] and c.collective["link_bytes_per_device"] == 0.0


def test_a_composite_op_counts_alike_with_and_without_autograd():
    x = torch.empty(4, 1, 64, device="meta")
    w = torch.empty(64, 32, device="meta")

    def whole(x, w):
        with torch.inference_mode():
            return x @ w

    _, inf = roofline.count_step(whole, x, w)
    _, grad = roofline.count_step(lambda x, w: x @ w, x, w)
    assert inf.flops == grad.flops == 2 * 4 * 64 * 32
    assert inf.bytes == grad.bytes


def _attention_inputs():
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, dh = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return q, k, v, pos


def _port_attention(q, k, v, pos, p_bf16):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, pos)]
    with settings.override(flash_p_bf16=p_bf16, attn_chunk_q=16,
                           attn_chunk_k=32, dense_below=0):
        return layers.attention(t[0], t[1], t[2], t[3], t[3], causal=True,
                                window=48).numpy()


def test_flash_p_bf16_matches_the_reference():
    q, k, v, pos = _attention_inputs()
    with jsettings.override(flash_p_bf16=True, attn_chunk_q=16,
                            attn_chunk_k=32, dense_below=0):
        want = np.asarray(jax.jit(lambda *a: jlayers.attention(
            a[0], a[1], a[2], a[3], a[3], causal=True, window=48))(
                *(jnp.asarray(x) for x in (q, k, v, pos))))
    got = _port_attention(q, k, v, pos, True)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # the bf16 softmax weights move the output off the fp32 product's
    fp32 = _port_attention(q, k, v, pos, False)
    assert np.abs(got - fp32).max() > 1e-4 * scale


def test_unroll_scans_is_accepted_and_scan_unroll_is_the_references():
    for on in (False, True):
        with settings.override(unroll_scans=on), \
                jsettings.override(unroll_scans=on):
            assert settings.get().unroll_scans is on
            assert settings.scan_unroll() == jsettings.scan_unroll()
