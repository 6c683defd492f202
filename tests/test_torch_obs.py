"""repro_torch.obs against repro.obs: tracer spans (nesting, threads,
Chrome export), metrics (histogram math vs numpy, merges, JSONL, typed
errors under python -O), the Thm-1 distortion monitor, the disabled fast
path, the hooks in dispatch, the serve tick and the train loop, and the
CLIs (`serve_rp --trace-out/--metrics-out/--distortion`, `obs_report`,
`train --monitor`).

The same span and observation sequence through both packages gives the
same Chrome events and JSONL rows, timestamps, durations and thread ids
aside (the schema test). Distortion streams come from the reference's own
operator carried across (`from_numpy_operator`), projected by both
packages on the same numpy inputs. The watchdog's straggler events and
the checkpointer's `ckpt.*` spans with the resume/fallback events are
compared with the reference's for the same sequence (a fake monotonic
clock for the step times).
"""
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import rp as jrp
from repro_torch import obs, rp
from repro_torch.core import from_numpy_operator
from repro_torch.obs import (DistortionMonitor, Histogram, MetricsRegistry,
                             Tracer, required_k)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _obs_disabled():
    """Every test starts and ends with both packages' sessions torn down:
    the layer is process-global by design."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_span_nesting_depths_and_attrs():
    tr = Tracer()
    with tr.span("outer", family="tt") as sp:
        with tr.span("inner"):
            pass
        sp.set(backend="kernel")
    tr.instant("marker", step=3)
    evs = tr.events()
    by_name = {e["name"]: e for e in evs}
    assert by_name["inner"]["args"]["depth"] == 1
    assert "depth" not in by_name["outer"]["args"]
    assert by_name["outer"]["args"] == {"family": "tt", "backend": "kernel"}
    assert by_name["marker"]["ph"] == "i"
    assert [e["name"] for e in evs] == ["inner", "outer", "marker"]
    assert by_name["outer"]["dur"] >= by_name["inner"]["dur"] >= 0.0


def test_span_nesting_is_isolated_across_threads():
    tr = Tracer()
    start = threading.Barrier(2)

    def worker(name):
        start.wait()
        for _ in range(25):
            with tr.span(f"{name}.outer"):
                with tr.span(f"{name}.inner"):
                    time.sleep(0)
    ts = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    evs = tr.events()
    assert len(evs) == 100 and tr.open_spans() == 0
    for e in evs:
        want_depth = 1 if e["name"].endswith(".inner") else 0
        assert e["args"].get("depth", 0) == want_depth, e
    assert len({e["tid"] for e in evs}) == 2
    for name in ("a", "b"):
        assert len({e["tid"] for e in evs
                    if e["name"].startswith(name)}) == 1


def test_chrome_export_schema(tmp_path):
    tr = Tracer()
    with tr.span("s", k=128, dims=(4, 8)):
        tr.instant("i")
    path = tmp_path / "trace.json"
    n = tr.export(path)
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert n == len(doc["traceEvents"]) == 2
    for e in doc["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid", "args"} <= set(e)
        assert e["ph"] in ("X", "i")
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    span = next(e for e in doc["traceEvents"] if e["ph"] == "X")
    assert span["args"]["dims"] == [4, 8]


def test_export_with_open_span_is_typed_error():
    tr = Tracer()
    cm = tr.span("open")
    cm.__enter__()
    with pytest.raises(ValueError, match="unclosed span"):
        tr.to_chrome()
    with pytest.raises(ValueError, match="unclosed span"):
        tr.clear()
    cm.__exit__(None, None, None)
    assert tr.to_chrome()["traceEvents"][0]["name"] == "open"


def test_spans_enter_torch_profiler_record_function():
    """A span's body runs under `torch.profiler.record_function(name)`, so
    a torch.profiler capture shows the span by name."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("obs.probe"):
            torch.ones(4).sum()
    assert any(ev.key == "obs.probe" for ev in prof.key_averages())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy_within_bucket_width():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=4.0, sigma=1.0, size=4000)
    bounds = tuple(float(b) for b in np.geomspace(1.0, 1e4, 40))
    h = Histogram("h", bounds)
    for s in samples:
        h.observe(float(s))
    for p in (10.0, 50.0, 90.0, 99.0):
        ref = float(np.percentile(samples, p))
        got = h.percentile(p)
        i = int(np.searchsorted(bounds, ref))
        lo = 0.0 if i == 0 else bounds[i - 1]
        hi = bounds[min(i, len(bounds) - 1)]
        assert lo - 1e-9 <= got <= hi + 1e-9, (p, got, ref, lo, hi)
    assert h.mean == pytest.approx(float(np.mean(samples)))
    first = next(i for i, c in enumerate(h.counts) if c)
    assert h.percentile(0.0) == (0.0 if first == 0 else bounds[first - 1])
    assert Histogram("e", (1.0,)).percentile(50.0) == 0.0
    h2 = Histogram("h2", (10.0,))
    h2.observe(1e9)
    assert h2.percentile(99.0) == 10.0


def test_histogram_merge_matches_single_stream():
    bounds = (10.0, 100.0, 1000.0)
    a, b, ref = (Histogram("m", bounds) for _ in range(3))
    rng = np.random.default_rng(1)
    for i, s in enumerate(rng.uniform(1.0, 2000.0, size=500)):
        (a if i % 2 else b).observe(float(s))
        ref.observe(float(s))
    a.merge(b)
    assert a.counts == ref.counts and a.count == ref.count
    assert a.percentile(99.0) == ref.percentile(99.0)
    with pytest.raises(ValueError, match="bounds differ"):
        a.merge(Histogram("m", (5.0, 50.0)))


def test_metrics_registry_typed_errors_and_merge():
    reg = MetricsRegistry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(7.5)
    reg.histogram("h", (10.0, 100.0)).observe(42.0)
    reg.event("ev", step=1)
    with pytest.raises(ValueError, match="monotonic"):
        reg.counter("c").inc(-1)
    with pytest.raises(ValueError, match="already registered as"):
        reg.gauge("c")
    with pytest.raises(ValueError, match="different bounds"):
        reg.histogram("h", (1.0, 2.0))
    with pytest.raises(ValueError, match="positive"):
        reg.histogram("neg", (-1.0, 2.0))
    with pytest.raises(ValueError, match="ascending"):
        reg.histogram("asc", (2.0, 1.0))
    other = MetricsRegistry()
    other.counter("c").inc(2)
    other.gauge("g").set(9.0)
    other.histogram("h", (10.0, 100.0)).observe(7.0)
    other.event("ev", step=2)
    reg.merge(other)
    assert reg.counter("c").value == 5
    assert reg.gauge("g").value == 9.0
    assert reg.histogram("h", (10.0, 100.0)).count == 2
    assert [e["step"] for e in reg.events] == [1, 2]


def test_metrics_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.histogram("h", (10.0,)).observe(3.0)
    reg.event("boom", why="test")
    path = tmp_path / "m.jsonl"
    assert reg.write_jsonl(path) == 3
    rows = obs.read_jsonl(path)
    assert {r["type"] for r in rows} == {"counter", "histogram", "event"}
    hist = next(r for r in rows if r["type"] == "histogram")
    assert {"bounds", "counts", "sum", "count", "p50", "p99"} <= set(hist)


def _script(pkg):
    """One span and observation sequence, run by `pkg`'s obs module."""
    def run(tmp):
        ctx = pkg.enable()
        try:
            with pkg.span("serve.tick", batch=3, family="tt", dims=(4, 8)):
                with pkg.span("rp.project", family="tt", order=3) as sp:
                    sp.set(backend="kernel", plan="abc")
                pkg.instant("marker", step=1)
            h = pkg.histogram("serve/queue_delay_us")
            for v in (5.0, 50.0, 500.0, 5e3, 5e7):
                h.observe(v)
            pkg.counter("serve/requests_done").inc(5)
            pkg.gauge("g").set(2.5)
            pkg.event("distortion.alert", family="tt", k=8, out_rate=0.5)
        finally:
            pkg.disable()
        ctx.tracer.export(tmp / "t.json")
        ctx.metrics.write_jsonl(tmp / "m.jsonl")
        return (json.loads((tmp / "t.json").read_text()),
                pkg.read_jsonl(tmp / "m.jsonl"))
    return run


def test_trace_and_metrics_files_match_the_reference(tmp_path):
    """The same sequence through both packages: the same Chrome document
    and JSONL rows, timestamps, durations, pids, tids and event times
    aside."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jdoc, jrows = _script(jobs)(tmp_path / "j")
    tdoc, trows = _script(obs)(tmp_path / "t")

    def strip_trace(doc):
        return ({k: v for k, v in doc.items() if k != "traceEvents"},
                sorted(({k: v for k, v in e.items()
                         if k not in ("ts", "dur", "pid", "tid")}
                        for e in doc["traceEvents"]),
                       key=lambda e: json.dumps(e, sort_keys=True)))

    def strip_rows(rows):
        return sorted(({k: v for k, v in r.items() if k != "time"}
                       for r in rows), key=lambda r: json.dumps(
                           r, sort_keys=True))
    assert strip_trace(tdoc) == strip_trace(jdoc)
    assert strip_rows(trows) == strip_rows(jrows)
    assert [set(e) for e in tdoc["traceEvents"]] == [
        set(e) for e in jdoc["traceEvents"]]
    assert [set(r) for r in trows] == [set(r) for r in jrows]


def test_obs_typed_errors_survive_python_O():
    code = """
from repro_torch.obs import DistortionMonitor, Histogram, Tracer
tr = Tracer()
cm = tr.span("open")
cm.__enter__()
try:
    tr.to_chrome()
except ValueError as e:
    assert "unclosed span" in str(e), e
else:
    raise SystemExit("open-span export not caught under -O")
cm.__exit__(None, None, None)
for bounds, word in (((-1.0, 2.0), "positive"), ((2.0, 1.0), "ascending")):
    try:
        Histogram("h", bounds)
    except ValueError as e:
        assert word in str(e), e
    else:
        raise SystemExit("bad bounds not caught under -O")
try:
    DistortionMonitor(eps=0.0, delta=0.1)
except ValueError as e:
    assert "eps" in str(e), e
else:
    raise SystemExit("bad eps not caught under -O")
print("O_SAFE_OK")
"""
    res = subprocess.run([sys.executable, "-O", "-c", code],
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "O_SAFE_OK" in res.stdout, (
        res.stdout, res.stderr)


# ---------------------------------------------------------------------------
# the module-global session and its disabled fast path
# ---------------------------------------------------------------------------

def test_disabled_fast_path_returns_shared_noops():
    assert not obs.enabled()
    assert obs.span("x", a=1) is obs.span("y")
    assert obs.counter("c") is obs.histogram("h") is obs.gauge("g")
    with obs.span("x") as sp:
        assert sp.set(a=1) is sp
    obs.instant("i")
    obs.event("e")
    obs.counter("c").inc()
    obs.histogram("h").observe(1.0)
    assert obs.get_distortion() is None and obs.get_tracer() is None
    ctx = obs.enable()
    try:
        assert obs.enabled() and obs.get_tracer() is ctx.tracer
        assert obs.span("x") is not obs.span("x")
        obs.counter("c").inc(2)
        assert ctx.metrics.counter("c").value == 2
    finally:
        assert obs.disable() is ctx
    assert obs.get_context() is None


def test_capture_exports_on_exit(tmp_path):
    tp, mp = tmp_path / "t.json", tmp_path / "m.jsonl"
    with obs.capture(trace_path=tp, metrics_path=mp):
        with obs.span("region", tag="x"):
            obs.counter("n").inc()
    assert not obs.enabled()
    assert json.loads(tp.read_text())["traceEvents"][0]["name"] == "region"
    assert obs.read_jsonl(mp)[0]["name"] == "n"


# ---------------------------------------------------------------------------
# distortion monitor vs Thm 1
# ---------------------------------------------------------------------------

def _norms(k, n_samples=256):
    """Squared norms of the reference's TT(2) operator (carried across)
    on the same numpy inputs, projected by both packages."""
    dims, rank = (4, 8, 8), 2
    jop = jrp.make_projector(
        jrp.ProjectorSpec(family="tt", k=k, dims=dims, rank=rank),
        jax.random.PRNGKey(7))
    op = from_numpy_operator("tt", [np.asarray(c) for c in jop.cores], "cpu")
    xs = np.random.default_rng(8).standard_normal(
        (n_samples, int(np.prod(dims))), dtype=np.float32)
    ys = rp.project(op, torch.from_numpy(xs)).numpy()
    jys = np.asarray(jrp.project(jop, xs, backend="xla"))
    np.testing.assert_allclose(ys, jys, rtol=1e-5, atol=1e-5)
    return [(float(x @ x), float(y @ y)) for x, y in zip(xs, ys)]


def _feed(mon, k):
    for x2, y2 in _norms(k):
        mon.observe_norms("tt", 3, k, x2, y2, rank=2)


def test_required_k_matches_chebyshev_and_the_reference():
    assert required_k("tt", 3, rank=2, eps=0.5, delta=0.1) == \
        math.ceil(11 / (0.1 * 0.25)) == 440
    for family, order, rank in (("tt", 3, 5), ("cp", 3, 25), ("tt", 12, 10),
                                ("gaussian", 1, 1), ("sparse", 2, 1)):
        assert required_k(family, order, rank=rank, eps=0.3, delta=0.05) \
            == jobs.required_k(family, order, rank=rank, eps=0.3,
                               delta=0.05)
    with pytest.raises(ValueError, match="eps"):
        required_k("tt", 3, rank=2, eps=0.0, delta=0.1)


def test_distortion_monitor_flags_undersized_k_only():
    """k=8 (<< the 440 Thm 1 prescribes for eps=0.5, delta=0.1) alerts
    once; k=512 stays silent on the same stream; both packages' monitors
    agree on the same observations."""
    alerts, jalerts = [], []
    mon = DistortionMonitor(eps=0.5, delta=0.1, min_samples=64,
                            on_alert=alerts.append)
    jmon = jobs.DistortionMonitor(eps=0.5, delta=0.1, min_samples=64,
                                  on_alert=jalerts.append)
    for x2, y2 in _norms(8):
        mon.observe_norms("tt", 3, 8, x2, y2, rank=2)
        jmon.observe_norms("tt", 3, 8, x2, y2, rank=2)
    assert len(alerts) == 1, "undersized k must alert exactly once"
    al = alerts[0]
    assert (al.family, al.order, al.k) == ("tt", 3, 8)
    assert al.out_rate > al.delta and al.k_required == 440
    assert al.as_event() == jalerts[0].as_event()
    assert mon.summary() == jmon.summary()
    mon2 = DistortionMonitor(eps=0.5, delta=0.1, min_samples=64,
                             on_alert=alerts.append)
    _feed(mon2, 512)
    assert len(alerts) == 1, "paper-prescribed k must not alert"
    rows = mon2.summary()
    assert len(rows) == 1 and not rows[0]["alerted"]
    assert rows[0]["out_rate"] <= 0.1


def test_distortion_alert_routes_to_metrics_and_trace():
    ctx = obs.enable(distortion=DistortionMonitor(eps=0.5, delta=0.1,
                                                  min_samples=64))
    try:
        _feed(ctx.distortion, 8)
    finally:
        obs.disable()
    evs = [e for e in ctx.metrics.events if e["name"] == "distortion.alert"]
    assert len(evs) == 1 and evs[0]["k_required"] == 440
    instants = [e for e in ctx.tracer.events()
                if e["ph"] == "i" and e["name"] == "distortion.alert"]
    assert len(instants) == 1


def test_distortion_monitor_typed_errors():
    with pytest.raises(ValueError, match="eps"):
        DistortionMonitor(eps=-1.0, delta=0.1)
    with pytest.raises(ValueError, match="delta"):
        DistortionMonitor(eps=0.5, delta=1.0)
    with pytest.raises(ValueError, match="min_samples"):
        DistortionMonitor(eps=0.5, delta=0.1, min_samples=0)
    mon = DistortionMonitor(eps=0.5, delta=0.1)
    with pytest.raises(ValueError, match="k"):
        mon.observe("tt", 3, 0, 1.0)
    assert mon.observe_norms("tt", 3, 8, 0.0, 1.0) is None


# ---------------------------------------------------------------------------
# the hooks
# ---------------------------------------------------------------------------

def test_dispatch_spans_carry_the_resolved_route():
    op = rp.make_projector(rp.ProjectorSpec("tt", 16, (4, 4, 4), 2), 0,
                           device="cpu")
    x = torch.randn(3, 4, 4, 4)
    with obs.capture() as ctx:
        y = rp.project(op, x)
        rp.reconstruct(op, y)
        with rp.force_kernel():
            rp.project(op, x)
    evs = ctx.tracer.events()
    assert [e["name"] for e in evs] == ["rp.project", "rp.reconstruct",
                                        "rp.project"]
    assert [e["args"]["backend"] for e in evs] == ["torch", "torch",
                                                   "kernel"]
    plan = rp.explain(op, x)
    assert evs[0]["args"] == {"family": "tt", "structure": "dense",
                              "order": 3, "backend": "torch",
                              "pipeline": "serial", "plan": plan.plan_id}


def test_shared_timeline_serve_plus_train(tmp_path):
    """One session spanning a serve replay and an 8-step sketch-compressed
    train run with async checkpoints exports one trace where rp dispatch
    spans, serve tick spans, train steps and ckpt saves share the timeline
    (ckpt saves on the writer thread's own lane), plus parseable JSONL
    metrics (the reference's case)."""
    from repro_torch.core.sketch import SketchConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.optim.compress import SketchCompressor
    from repro_torch.runtime import train_loop
    from repro_torch.serve import (ServeConfig, SketchServer, replay,
                                   synth_trace)

    tp, mp = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    with obs.capture(trace_path=tp, metrics_path=mp) as ctx:
        spec = rp.ProjectorSpec(family="tt", k=128, dims=(4, 8, 8), rank=2)
        srv = SketchServer(ServeConfig(max_batch=4, backend="torch",
                                       ingest=False), device="cpu")
        replay(srv, synth_trace(16, [(spec, 0)], seed=2))
        comp = SketchCompressor(SketchConfig(family="tt", k=64, rank=2,
                                             bucket_elems=256,
                                             dims=(4, 8, 8)))
        ocfg = AdamWConfig(clip_norm=1.0)
        params = {"w": torch.ones(256)}
        state = {"params": params, "opt": adamw.init_state(params, ocfg),
                 "ef": comp.init_state(params)}

        def step_fn(state, batch):
            g = {"w": torch.ones(256) * 0.01}
            g_hat, new_ef, m = comp.compress(g, state["ef"],
                                             step=state["opt"]["count"])
            p, new_opt, _ = adamw.update(state["params"], g_hat,
                                         state["opt"], 1e-3, ocfg)
            return ({"params": p, "opt": new_opt, "ef": new_ef},
                    {"loss": torch.sum(p["w"] * p["w"]), **m})

        train_loop.run(step_fn, state,
                       SyntheticLM(DataConfig(vocab=16, seq_len=8,
                                              global_batch=2)),
                       train_loop.LoopConfig(total_steps=8,
                                             ckpt_dir=str(tmp_path / "ck"),
                                             ckpt_every=4),
                       log=lambda s: None)
    evs = json.loads(tp.read_text())["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"rp.project", "rp.reconstruct", "serve.tick",
            "train.step", "ckpt.save"} <= names
    assert len({e["pid"] for e in evs}) == 1
    saves = [e for e in evs if e["name"] == "ckpt.save"]
    assert [e["args"]["step"] for e in saves] == [4, 8]
    assert all(e["args"]["n_arrays"] == 5 for e in saves)  # w, m, v, count, ef
    step_tids = {e["tid"] for e in evs if e["name"] == "train.step"}
    assert step_tids.isdisjoint(e["tid"] for e in saves)
    steps = [e for e in evs if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == list(range(8))
    tick = next(e for e in evs if e["name"] == "serve.tick")
    assert {"batch", "family", "k", "structure", "plan",
            "route"} <= set(tick["args"])
    proj = next(e for e in evs if e["name"] == "rp.project")
    assert {"family", "structure", "backend", "pipeline"} <= set(proj["args"])
    # every step's dispatches nest inside it (the port dispatches eagerly)
    for s in steps:
        inside = [e for e in evs if e["name"].startswith("rp.")
                  and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert inside and all(e["args"]["depth"] >= 1 for e in inside)
    rows = obs.read_jsonl(mp)
    assert any(r["type"] == "histogram" and r["name"] == "serve/queue_delay_us"
               and r["count"] == 16 for r in rows)
    assert ctx.metrics.counter("serve/requests_done").value == 16


def test_train_step_parts_are_obs_spans():
    """`runtime.spans.span` opens an obs span of the same name, nested in
    `train.step`, whether or not the CUDA-event split is recording."""
    from repro_torch.runtime import spans, train_loop
    from repro_torch.data import DataConfig, SyntheticLM

    def step_fn(state, batch):
        with spans.span("train.loss_grad"):
            pass
        with spans.span("train.sketch"):
            pass
        return state + 1, {"loss": torch.zeros(())}

    with obs.capture() as ctx:
        train_loop.run(step_fn, 0, SyntheticLM(DataConfig(
            vocab=16, seq_len=8, global_batch=2)),
            train_loop.LoopConfig(total_steps=2), log=lambda s: None)
    names = [(e["name"], e["args"].get("depth", 0))
             for e in ctx.tracer.events()]
    assert names == [("train.loss_grad", 1), ("train.sketch", 1),
                     ("train.step", 0)] * 2


def test_serve_distortion_feed_matches_the_reference_monitor():
    """The tick's device-side float64 norms feed the monitor the same
    distortions as a host computation on the payloads; structured lanes
    are not graded."""
    from repro_torch.serve import (ServeConfig, SketchServer, replay,
                                   synth_trace)
    spec = rp.ProjectorSpec(family="tt", k=16, dims=(4, 8, 8), rank=2)
    srv = SketchServer(ServeConfig(max_batch=8, ingest=False), device="cpu")
    trace = synth_trace(96, [(spec, 0)], mix=(1.0, 1.0, 0.0), seed=3)
    mon = DistortionMonitor(eps=0.5, delta=0.05, min_samples=8)
    with obs.capture(distortion=mon):
        replay(srv, trace)
    op = srv.cache.get(spec, 0)
    want = jobs.DistortionMonitor(eps=0.5, delta=0.05, min_samples=8)
    dense = [r for r in srv.done
             if rp.structure_tag(trace[r.rid].payload) == "dense"]
    for r in sorted(dense, key=lambda r: r.t_done):
        x = np.asarray(trace[r.rid].payload, np.float64).reshape(-1)
        y = np.asarray(r.sketch, np.float64)
        want.observe_norms("tt", 3, 16, float(x @ x), float(y @ y), rank=2)
    got, ref = mon.summary()[0], want.summary()[0]
    assert got["n"] == ref["n"] == len(dense) < len(trace)
    assert got["mean_distortion"] == pytest.approx(ref["mean_distortion"],
                                                   rel=1e-9)
    assert (got["out_rate"], got["alerted"]) == (ref["out_rate"],
                                                 ref["alerted"])
    del op


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_rp_cli_writes_trace_metrics_and_distortion(tmp_path, capsys):
    from repro_torch.launch import obs_report, serve_rp
    tp, mp = tmp_path / "t.json", tmp_path / "m.jsonl"
    assert serve_rp.main(["--device", "cpu", "--requests", "64", "--k",
                          "16", "--mix", "1", "0", "0", "--max-batch", "8",
                          "--trace-out", str(tp), "--metrics-out", str(mp),
                          "--distortion", "0.5", "0.05"]) == 0
    out = capsys.readouterr().out
    assert "wrote Perfetto trace" in out and "distortion tt/N=3/k=16" in out
    evs = obs_report.load_trace(tp)
    ticks = [e for e in evs if e["name"] == "serve.tick"]
    projs = [e for e in evs if e["name"] == "rp.project"]
    assert len(ticks) == len(projs) > 0
    rows = obs.read_jsonl(mp)
    hist = next(r for r in rows if r["name"] == "serve/queue_delay_us")
    assert hist["count"] == 64
    assert [r["name"] for r in rows if r["type"] == "event"] == [
        "distortion.alert"]          # k=16 << required_k = 391
    assert obs_report.main(["--trace", str(tp), "--metrics", str(mp)]) == 0
    report = capsys.readouterr().out
    assert "| serve.tick |" in report and "| rp.project |" in report
    assert "WARNING: 1 distortion alert" in report


def test_obs_report_explain_matches_reference_plans(capsys):
    """`--explain` renders the port's plan; route, kernel, flops and the
    parameter count agree with the reference's `--explain` on the same
    spec where both route to the einsum (the CPU)."""
    from repro.launch import obs_report as jreport
    from repro_torch.launch import obs_report
    for spec in ("family=tt,k=128,dims=8x16x16,rank=2,batch=8",
                 "family=cp,k=64,dims=4x4x8,rank=3,structure=tt,in_rank=2",
                 "family=gaussian,k=64,dims=8x16x16"):
        got = obs_report.explain_plan(spec + ",backend=torch")
        want = jreport.explain_plan(spec + ",backend=xla")
        for field in ("flops=", "params=", "N=", "rank=", "batch="):
            line_g = next(l for l in got.splitlines() if field in l)
            line_w = next(l for l in want.splitlines() if field in l)
            pick = [w for w in line_g.split() if w.startswith(field)]
            assert pick and pick == [w for w in line_w.split()
                                     if w.startswith(field)], (spec, field)
    assert obs_report.main(["--explain",
                            "family=tt,k=128,dims=8x16x16,rank=2"]) == 0
    out = capsys.readouterr().out
    assert "route: **kernel**" in out and "rejected alternatives" in out
    with pytest.raises(ValueError, match="missing required"):
        obs_report.explain_plan("family=tt,k=8")


def test_train_cli_monitor_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "llama3.2-3b", "--reduced", "--steps", "2", "--monitor"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[monitor] step 0 sketch_norm=" in out.stdout
    assert "drift=0.00000" in out.stdout


def test_straggler_events_match_the_reference(monkeypatch):
    """The same step times (a fake monotonic clock) through both loops:
    the same `train.straggler` events, the same `[straggler]` log lines,
    one trace instant each, one `train.step` span a step."""
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.runtime import train_loop as jloop
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime import train_loop

    dts = [0.02, 0.021, 0.019, 0.022, 0.02, 0.018, 0.021, 0.02, 0.25,
           0.021, 0.019, 0.02]
    clock = {"t": 0.0, "i": 0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])

    def tick():
        clock["t"] += dts[clock["i"]]
        clock["i"] += 1

    def port_step(state, batch):
        tick()
        return state + 1, {"loss": torch.zeros(())}

    def ref_step(state, batch):
        tick()
        return state + 1, {"loss": jax.numpy.zeros(())}

    got = {}
    for name, pkg, loop, step, data in (
            ("port", obs, train_loop, port_step,
             SyntheticLM(DataConfig(vocab=16, seq_len=8, global_batch=2))),
            ("ref", jobs, jloop, ref_step,
             JSyntheticLM(JDataConfig(vocab=16, seq_len=8, global_batch=2)))):
        clock.update(t=100.0, i=0)
        logs = []
        ctx = pkg.enable()
        try:
            loop.run(step, 0, data, loop.LoopConfig(total_steps=12),
                     log=logs.append)
        finally:
            pkg.disable()
        evs = [{k: v for k, v in e.items() if k != "time"}
               for e in ctx.metrics.events]
        instants = [e for e in ctx.tracer.events() if e["ph"] == "i"]
        spans = [e["args"]["step"] for e in ctx.tracer.events()
                 if e["name"] == "train.step"]
        got[name] = (evs, [ln for ln in logs if ln.startswith("[straggler]")],
                     [(e["name"], e["args"]) for e in instants], spans)
    assert got["port"] == got["ref"]
    evs, lines = got["port"][:2]
    assert any(e["step"] == 8 and e["zscore"] > 4.0 for e in evs)
    assert len(evs) == len(lines) and got["port"][3] == list(range(12))


def test_resume_and_fallback_events_and_ckpt_spans_match_the_reference(
        tmp_path):
    """[resume]/[fallback] keep their log strings and land as events; the
    restore span carries the fallback; the ckpt.save/verify/restore spans
    and the events have the reference's names and attributes."""
    from repro.ckpt import checkpointer as jck
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.runtime import train_loop as jloop
    from repro.runtime.resilience import flip_byte
    from repro_torch.ckpt import checkpointer
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime import train_loop

    runs = {}
    for name, pkg, loop, ck, w0, add, data in (
            ("port", obs, train_loop, checkpointer, torch.zeros(()),
             lambda w: w + 1.0,
             SyntheticLM(DataConfig(vocab=16, seq_len=8, global_batch=2))),
            ("ref", jobs, jloop, jck, jax.numpy.zeros(()),
             lambda w: w + 1.0,
             JSyntheticLM(JDataConfig(vocab=16, seq_len=8,
                                      global_batch=2)))):
        d = tmp_path / name

        def step_fn(state, batch, add=add):
            return {"w": add(state["w"])}, {"loss": state["w"] * 0}

        loop.run(step_fn, {"w": w0}, data, loop.LoopConfig(
            total_steps=8, ckpt_dir=str(d), ckpt_every=2, async_ckpt=False),
            log=lambda s: None)
        flip_byte(d / f"step_{8:010d}" / "arr_0.npy")   # corrupt newest
        logs = []
        ctx = pkg.enable()
        try:
            state, _ = loop.run(step_fn, {"w": w0}, data, loop.LoopConfig(
                total_steps=10, ckpt_dir=str(d), ckpt_every=5,
                async_ckpt=False), log=logs.append)
        finally:
            pkg.disable()
        evs = [{k: v for k, v in e.items() if k not in ("time", "dir")}
               for e in ctx.metrics.events]
        spans = [(e["name"], {k: v for k, v in e["args"].items()
                              if k not in ("path", "depth", "dir")})
                 for e in ctx.tracer.events()
                 if e["name"].startswith("ckpt.")]
        runs[name] = (evs, spans, [ln.replace(str(d), "D") for ln in logs
                                   if ln.startswith("[resume]")],
                      float(state["w"]), ck.latest_step(d))
    assert runs["port"] == runs["ref"]
    evs, spans, lines, w, latest = runs["port"]
    assert [e["name"] for e in evs] == ["ckpt.fallback", "ckpt.resume"]
    assert evs[0]["step_requested"] == 8 and evs[0]["step_restored"] == 6
    restore = next(a for n, a in spans if n == "ckpt.restore")
    assert restore == {"step": 6, "fallback_from": 8}
    assert [n for n, _ in spans].count("ckpt.verify") == 2
    assert [a["step"] for n, a in spans if n == "ckpt.save"] == [10]
    assert len(lines) == 2 and w == 10.0 and latest == 10
