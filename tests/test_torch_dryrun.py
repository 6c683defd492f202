"""The port's dry run (`launch/dryrun.py`) against repro and against real
ranks.

A fake process group is the process's default group, so every dry run
here runs in a child process of its own (started together in the module
fixture, a time limit each):

* the six families of the reference's mini dry run
  (`tests/test_sharding_dryrun.py`: `reduced` configs at d_model 64 and
  vocab 256) on a fake (2, 2, 2) mesh, a train cell (seq 32, batch 8) and
  a decode cell (seq 64, batch 8): status ok, flops above 0;
* the full-depth counts equal the probes' extrapolation exactly (flops,
  and the ledger's link bytes) for reduced llama, mixtral and mamba2 at
  4 layers on (1, 2) and (2, 2, 2);
* the ledger of a reduced llama train step on a fake (1, 2) mesh, and of
  one whose 6 query heads a model axis of 4 splits on (1, 4), equal row
  for row (tag, op, dtype, axes: calls and bytes) to rank 0's on the same
  meshes of gloo ranks (`tests/torch_dist_workers.py`'s `dry_ledger`);
* the CLI on a production decode cell, each mesh (the multi-pod one as
  rank 300): a cell file with the reference's keys; `--list` prints what
  the reference's prints;
* gloo still refuses ranks whose tree digests differ (the fake backend
  skips that agreement);
* the fake backend takes only meta tensors, and meta tensors only the
  fake backend; `--sp-outputs` and `--no-head-constraints` are refused.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun, mesh as tmesh

from torch_dist_workers import start_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           OMP_NUM_THREADS="1")
LIMIT = 240.0
FAMILIES = ["llama3.2-3b", "mixtral-8x22b", "mamba2-1.3b",
            "recurrentgemma-2b", "whisper-medium", "qwen2-vl-2b"]
EXACT = ["llama3.2-3b", "mixtral-8x22b", "mamba2-1.3b"]
LEDGER = {"llama": ((1, 2), {}), "llama-h6": ((1, 4), {"n_heads": 6})}
B, S = 8, 32
CELL_KEYS = {"arch", "shape", "mesh", "kind", "status", "compile_s",
             "probe_compile_s", "notes", "roofline"}
ROOF_KEYS = {"arch", "shape", "mesh", "n_devices", "hlo_flops_per_device",
             "hlo_bytes_per_device", "collective", "model_flops",
             "memory_per_device", "compute_s", "memory_s", "collective_s",
             "bottleneck", "useful_flops_frac"}


def _python(code, cwd=REPO):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            cwd=cwd, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _cells(cells: str) -> str:
    """A child's program: the cells (name, cfg, ShapeSpec, mesh) run and
    printed as one JSON line."""
    return f"""
        import dataclasses, json
        from repro_torch.configs import get_config, reduced
        from repro_torch.launch import dryrun
        from repro_torch.models.config import ShapeSpec
        out = {{}}
        for name, arch, kw, shape, mesh in {cells}:
            cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
            out[name] = dryrun.run_cell(arch, shape[0], multi_pod=False,
                out_dir=None, verbose=False, cfg_override=cfg,
                shape_override=ShapeSpec(*shape), mesh_shape=mesh)
        print(json.dumps(out))
    """


def _wait(proc):
    out, err = proc.communicate(timeout=LIMIT)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child and every gloo run, started together; their outputs."""
    mini = {a: _python(_cells(repr([
        ("train", a, {"d_model": 64, "vocab": 256}, ("t", S, B, "train"),
         (2, 2, 2)),
        ("decode", a, {"d_model": 64, "vocab": 256}, ("d", 64, B, "decode"),
         (2, 2, 2))]))) for a in FAMILIES}
    exact = _python(_cells(repr([
        (f"{a}-{'x'.join(map(str, m))}", a, {"n_layers": 4},
         ("t", S, B, "train"), m) for a in EXACT for m in ((1, 2),
                                                           (2, 2, 2))])))
    tokens = np.random.default_rng(0).integers(0, 256, (B, S)).astype(
        np.int32)
    fake = _python(_cells(repr([
        (name, "llama3.2-3b", kw, ("t", S, B, "train"), m)
        for name, (m, kw) in LEDGER.items()])))
    gloo = {name: start_ranks(
        "dry_ledger", m[0] * m[1], tmp_path_factory.mktemp(name),
        {"arch": "llama3.2-3b", "cfg": kw, "tokens": tokens}, shape=m,
        names=("data", "model")) for name, (m, kw) in LEDGER.items()}
    refusal = start_ranks("digest_refusal", 2,
                          tmp_path_factory.mktemp("digest"), {}, shape=(2,),
                          names=("pod",))
    out_dir = tmp_path_factory.mktemp("cells")
    cli = {mp: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--out", str(out_dir)]
        + (["--multi-pod", "--rank", "300"] if mp else []), cwd=REPO,
        env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mp in (False, True)}
    lists = {pkg: subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launch.dryrun", "--list"], cwd=REPO,
        env=dict(ENV, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for pkg in ("repro", "repro_torch")}
    return {"mini": {a: json.loads(_wait(p)) for a, p in mini.items()},
            "exact": json.loads(_wait(exact)),
            "fake": json.loads(_wait(fake)),
            "gloo": {name: fin()[0] for name, fin in gloo.items()},
            "refusal": refusal(),
            "cli": {mp: (_wait(p), out_dir) for mp, p in cli.items()},
            "list": {pkg: _wait(p) for pkg, p in lists.items()}}


@pytest.mark.parametrize("arch", FAMILIES)
def test_mini_dry_run_counts_every_family(runs, arch):
    for kind in ("train", "decode"):
        cell = runs["mini"][arch][kind]
        assert cell["status"] == "ok", cell
        assert cell["mesh"] == "2x2x2" and cell["kind"] == kind
        r = cell["roofline"]
        assert r["hlo_flops_per_device"] > 0
        assert r["collective"]["link_bytes_per_device"] > 0
        assert r["memory_per_device"]["peak_bytes_per_device"] >= \
            r["memory_per_device"]["argument_size_in_bytes"] > 0
        assert dryrun.ROUTE_NOTE in cell["notes"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2x2"])
@pytest.mark.parametrize("arch", EXACT)
def test_full_depth_counts_equal_the_probes_extrapolation(runs, arch, mesh):
    cell = runs["exact"][f"{arch}-{mesh}"]
    r = cell["roofline"]
    assert r["collective"]["probe_instances"] == [1.0, 2.0, 4.0]
    assert cell["full_depth"]["flops"] == r["hlo_flops_per_device"] > 0
    assert cell["full_depth"]["link_bytes_per_device"] == \
        r["collective"]["link_bytes_per_device"] > 0


@pytest.mark.parametrize("name", list(LEDGER))
def test_fake_ledger_equals_the_gloo_ranks(runs, name):
    def rows(table):
        return {(r["tag"], r["op"], r["reduce"], r["dtype"],
                 tuple(r["axes"])): (r["calls"], r["bytes"]) for r in table}
    got = rows(runs["fake"][name]["ledger"])
    assert got == rows(runs["gloo"][name])
    if name == "llama-h6":     # the rank's block of q gathered to every head
        assert any(k[0] == "tp_heads" for k in got)


def test_gloo_still_refuses_a_digest_mismatch(runs):
    for rank in runs["refusal"]:
        for name in ("compress", "pod_rows"):
            assert rank[name] is not None and "digests differ" in rank[name]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cli_writes_a_production_cell(runs, multi_pod):
    text, out_dir = runs["cli"][multi_pod]
    mesh = "2x16x16" if multi_pod else "16x16"
    assert text.startswith(f"OK llama3.2-3b decode_32k {mesh}:")
    cell = json.loads((out_dir / f"llama3.2-3b_decode_32k_{mesh}.json")
                      .read_text())
    assert CELL_KEYS <= set(cell) and ROOF_KEYS <= set(cell["roofline"])
    assert cell["roofline"]["n_devices"] == (512 if multi_pod else 256)
    assert cell["rank"] == (300 if multi_pod else 0)
    assert cell["status"] == "ok"
    assert set(cell["roofline"]["collective"]["per_type"]) <= {
        "all-reduce", "all-gather", "reduce-scatter"}


def test_list_equals_the_references(runs):
    got = runs["list"]["repro_torch"]
    assert got == runs["list"]["repro"] and got.strip()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_fake_backend_takes_only_meta_tensors(device, monkeypatch):
    monkeypatch.setattr(tmesh, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="fake backend"):
        tmesh.make_mesh((1, 2), ("data", "model"), device=device,
                        backend="fake")


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_meta_tensors_take_only_the_fake_backend(backend):
    with pytest.raises(ValueError, match="fake backend"):
        tmesh.make_mesh((1, 2), ("data", "model"), device="meta",
                        backend=backend)


def test_the_production_mesh_names_the_dry_run():
    with pytest.raises(RuntimeError, match="backend='fake'"):
        tmesh.make_production_mesh(device="cpu")


@pytest.mark.parametrize("flag", ["--sp-outputs", "--no-head-constraints"])
def test_flags_the_port_leaves_out_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-3b", "--shape", "train_4k", flag])
    assert e.value.code != 0
    assert "Differences kept on purpose" in capsys.readouterr().err
