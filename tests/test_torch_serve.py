"""The whole slice on the CPU: repro_torch.serve against repro.serve.

Traces are built with `repro.serve.synth_trace` — dense only
(`mix=(1, 0, 0)`) and the reference's default mixed dense/TT/CP traffic
(`mix=(1, 1, 1)`, input ranks (2, 3, 4)); their payloads go across as numpy
arrays (TT/CP payloads through `from_numpy_tt` / `from_numpy_cp`) through
both servers. The port's
`OperatorCache` is made to hand out the reference's operator, carried
across with `from_numpy_operator` (monkeypatched in these tests only), so
both servers compute the same map. Tick counts, occupancy and latency
percentiles must be equal; stored sketches agree to rtol=1e-5,
atol=1e-5 (float32 on both sides, different summation order); query ids
and the JL bounds must be equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import rp as jrp
from repro import serve as jserve
from repro.core import formats as jformats
from repro_torch import rp
from repro_torch import serve
from repro_torch.core import (from_numpy_cp, from_numpy_operator,
                              from_numpy_tt)
from repro_torch.launch import serve_rp

RTOL = ATOL = 1e-5


def _specs(family):
    kw = dict(family=family, k=24, dims=(4, 8, 8), rank=3)
    return jrp.ProjectorSpec(**kw), rp.ProjectorSpec(**kw)


def _carry(jspec, seed):
    jop = jrp.make_projector(jspec, jax.random.PRNGKey(seed))
    arrays = jop.cores if jspec.family == "tt" else jop.factors
    return from_numpy_operator(jspec.family, [np.asarray(a) for a in arrays],
                               "cpu")


def _port_payload(payload):
    if isinstance(payload, jformats.TTTensor):
        return from_numpy_tt([np.asarray(c) for c in payload.cores], "cpu")
    if isinstance(payload, jformats.CPTensor):
        w = None if payload.weights is None else np.asarray(payload.weights)
        return from_numpy_cp([np.asarray(f) for f in payload.factors], w,
                             "cpu")
    return np.asarray(payload)


def _port_trace(jtrace, spec):
    return [serve.TraceEvent(t_us=ev.t_us, payload=_port_payload(ev.payload),
                             spec=spec, seed=ev.seed) for ev in jtrace]


@pytest.fixture
def carried_ops(monkeypatch):
    """Make the port's OperatorCache sample the reference's operators."""
    made = []

    def make(spec, seed=0, *, device=None):
        jspec = jrp.ProjectorSpec(family=spec.family, k=spec.k,
                                  dims=spec.dims, rank=spec.rank)
        made.append((spec, seed))
        return _carry(jspec, seed)

    monkeypatch.setattr(serve.cache.rp, "make_projector", make)
    return made


@pytest.mark.parametrize("mix", [(1.0, 0.0, 0.0), (1.0, 1.0, 1.0)],
                         ids=["dense", "mixed"])
@pytest.mark.parametrize("family", ["tt", "cp"])
@pytest.mark.parametrize("backend", ["auto", "kernel"])
@pytest.mark.parametrize("pool", [1, 3])
def test_server_reproduces_reference_server(family, backend, pool, mix,
                                            carried_ops):
    jspec, spec = _specs(family)
    jtrace = jserve.synth_trace(60, [(jspec, s) for s in range(pool)],
                                mix=mix, seed=4)
    cfg = dict(max_batch=8, flush_us=1000.0, cache_capacity=2)
    jstore = jserve.SketchStore(jspec)
    jserver = jserve.SketchServer(jserve.ServeConfig(**cfg), jstore)
    jrep = jserve.replay(jserver, jtrace)

    store = serve.SketchStore(spec, device="cpu")
    server = serve.SketchServer(serve.ServeConfig(backend=backend, **cfg),
                                store, device="cpu")
    with rp.dispatch_stats() as st:
        rep = serve.replay(server, _port_trace(jtrace, spec))

    for key in ("requests_done", "ticks", "occupancy_mean", "p50_us",
                "p99_us", "store_size", "store_bytes"):
        assert rep[key] == jrep[key], key
    for key in ("hits", "misses", "evictions"):
        assert rep["cache"][key] == jrep["cache"][key], key
    assert st.kernel_calls == (rep["ticks"] if backend == "kernel" else 0)
    # one dispatch per tick, each of one structure
    assert sum(st.breakdown.values()) == rep["ticks"]
    structures = {key[1] for key in st.breakdown}
    assert structures == ({"dense"} if mix[1] == 0 else
                          {"dense", "tt", "cp"})
    n = len(jstore)
    # sketches of the first seed only: the store holds every seed's rows
    # (same spec), and both servers ingest them in the same order
    np.testing.assert_allclose(store.get(np.arange(n)).numpy(),
                               np.asarray(jstore.get(np.arange(n))),
                               rtol=RTOL, atol=ATOL)
    q = store.get(np.arange(3))
    res = server.query(q, top_m=5)
    jres = jserver.query(np.asarray(jstore.get(np.arange(3))), top_m=5)
    np.testing.assert_array_equal(res.ids, jres.ids)
    assert res.ids[0][0] == 0
    np.testing.assert_allclose(res.dist2, jres.dist2, rtol=1e-4, atol=1e-3)
    assert res.eps == jres.eps and res.delta == jres.delta
    pw = server.pairwise([0, 1], [int(res.ids[0][-1]), 2])
    jpw = jserver.pairwise([0, 1], [int(jres.ids[0][-1]), 2])
    np.testing.assert_allclose(pw.dist2, jpw.dist2, rtol=1e-4)
    assert pw.eps == jpw.eps == store.eps_bound() == jstore.eps_bound()
    np.testing.assert_allclose(pw.dist2_lo, jpw.dist2_lo, rtol=1e-4)


def test_trace_arrivals_match_reference_generator():
    jspec, spec = _specs("tt")
    jtrace = jserve.synth_trace(50, [(jspec, 0), (jspec, 1)],
                                mix=(1.0, 0.0, 0.0), seed=11)
    trace = serve.synth_trace(50, [(spec, 0), (spec, 1)],
                              mix=(1.0, 0.0, 0.0), seed=11)
    assert [e.t_us for e in trace] == [e.t_us for e in jtrace]
    assert [e.seed for e in trace] == [e.seed for e in jtrace]
    assert all(e.payload.dtype == np.float32 for e in trace)
    # the mixed default draws the same structure kinds and ranks
    jmixed = jserve.synth_trace(30, [(jspec, 0)], seed=3)
    mixed = serve.synth_trace(30, [(spec, 0)], seed=3)
    assert [e.t_us for e in mixed] == [e.t_us for e in jmixed]
    assert ([(type(e.payload).__name__, getattr(e.payload, "order", None))
             for e in mixed]
            == [(type(e.payload).__name__ if type(e.payload).__name__ in
                 ("TTTensor", "CPTensor") else "ndarray",
                 getattr(e.payload, "order", None)) for e in jmixed])


def test_evicted_operator_regenerates_bitwise():
    _, spec = _specs("tt")
    cache = serve.OperatorCache(capacity=1, device="cpu")
    first = cache.get(spec, 3)
    cache.get(spec, 4)                  # evicts seed 3
    assert (spec, 3) not in cache and cache.stats.evictions == 1
    again = cache.get(spec, 3)
    assert again is not first
    assert all(torch.equal(a, b) for a, b in zip(first.cores, again.cores))
    assert cache.stats.as_dict()["misses"] == 3


def _no_cuda_calls():
    _, spec = _specs("cp")
    return {
        "SketchServer": lambda: serve.SketchServer(),
        "OperatorCache": lambda: serve.OperatorCache(),
        "SketchStore": lambda: serve.SketchStore(spec),
        "make_projector": lambda: rp.make_projector(spec, 0),
        "serve_rp": lambda: serve_rp.main(["--requests", "2"]),
    }


@pytest.mark.parametrize("entry", sorted(_no_cuda_calls()))
def test_default_device_is_cuda_and_raises_without_it(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _no_cuda_calls()[entry]()


def test_serve_rp_cli_runs_on_cpu(capsys, monkeypatch):
    assert serve_rp.main(["--device", "cpu", "--requests", "24",
                          "--max-batch", "4", "--family", "cp"]) == 0
    out = capsys.readouterr().out
    assert "24/24 requests" in out and "top-5 of sketch 0: ids [0," in out
    assert "einsum-routed" in out          # 'auto' on the CPU
    # --mean-gap-us, --cache-capacity and --backend reach the trace and the
    # server: the arrival gaps, the cache's capacity (a pool of 3 seeds
    # through one slot evicts) and the route ('kernel' runs the kernels'
    # plain versions on the CPU, one dispatch per tick)
    seen = {}
    make_trace, make_server = serve_rp.synth_trace, serve_rp.SketchServer

    def trace(*a, **kw):
        seen["trace"] = make_trace(*a, **kw)
        return seen["trace"]

    def server(*a, **kw):
        seen["server"] = make_server(*a, **kw)
        return seen["server"]

    monkeypatch.setattr(serve_rp, "synth_trace", trace)
    monkeypatch.setattr(serve_rp, "SketchServer", server)
    assert serve_rp.main(["--device", "cpu", "--requests", "24",
                          "--max-batch", "4", "--pool", "3",
                          "--mean-gap-us", "5000", "--cache-capacity", "1",
                          "--backend", "kernel"]) == 0
    out = capsys.readouterr().out
    t = np.array([ev.t_us for ev in seen["trace"]])
    assert np.mean(np.diff(t)) > 1000.0    # the default gap is 200 us
    srv = seen["server"]
    assert srv.cache.capacity == 1 and srv.cache.stats.evictions > 0
    assert srv.cfg.backend == "kernel"
    assert "kernel dispatches — one per tick" in out


def test_server_refuses_structured_payloads_and_foreign_stores():
    """Structured payloads whose dims differ from the spec's are refused at
    submit time (matching ones are served, see the mixed replay)."""
    from repro_torch.core import CPTensor
    _, spec = _specs("cp")
    server = serve.SketchServer(device="cpu")
    cp = CPTensor(tuple(torch.zeros(d, 2) for d in spec.dims[::-1]))
    with pytest.raises(rp.FormatMismatchError, match="spec dims"):
        server.submit(cp, spec)
    with pytest.raises(ValueError, match="store on"):
        serve.SketchServer(store=serve.SketchStore(spec, device="meta"),
                           device="cpu")


def test_batcher_flush_policy():
    _, spec = _specs("tt")
    b = serve.DynamicBatcher(serve.ServeConfig(max_batch=2, flush_us=100.0))
    for i, t in enumerate([0.0, 10.0, 20.0]):
        b.submit(serve.SketchRequest(rid=i, payload=np.zeros(3), spec=spec,
                                     t_submit=t))
    assert b.ready(20.0)
    key, batch = b.next_batch(20.0)
    assert [r.rid for r in batch] == [0, 1]
    assert not b.ready(50.0) and b.next_deadline() == 120.0
    assert [r.rid for r in b.next_batch(120.0)[1]] == [2]
    assert b.next_batch(500.0, force=True) is None


def test_store_typed_errors_and_query_tiling():
    _, spec = _specs("tt")
    store = serve.SketchStore(spec, query_tile=3, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        store.query(torch.zeros(24), 1)
    rows = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (10, 24)).astype(np.float32))
    assert store.add(rows).tolist() == list(range(10))
    with pytest.raises(ValueError, match="top_m"):
        store.query(rows[0], 11)
    with pytest.raises(ValueError, match="mixed-dtype"):
        store.add(rows.double())
    res = store.query(rows[:2], 4)
    d2 = ((rows[:2, None] - rows[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(res.ids, torch.argsort(d2, dim=1)[:, :4])
    with pytest.raises(ValueError, match="out of range"):
        store.pairwise([0], [10])
    with pytest.raises(ValueError):
        serve.ServeConfig(flush_us=0)
    with pytest.raises(ValueError, match="backend"):
        serve.ServeConfig(backend="xla")


# ---------------------------------------------------------------------------
# the cache manifest (restart warm-up from a spec registry)
# ---------------------------------------------------------------------------

def _manifest_specs():
    kw_a = dict(family="tt", k=64, dims=(4, 8, 8), rank=2)
    kw_b = dict(family="cp", k=32, dims=(8, 8), rank=2)
    return ((jrp.ProjectorSpec(**kw_a), rp.ProjectorSpec(**kw_a)),
            (jrp.ProjectorSpec(**kw_b), rp.ProjectorSpec(**kw_b)))


def test_cache_manifest_prewarm_matches_the_reference():
    """The reference's test_cache_manifest_prewarm_bitwise_and_stats
    through both caches: the same manifest JSON for the same gets, the
    same prewarm counts, LRU order and evictions, and operators
    regenerated bit for bit on the cache's device."""
    (ja, a), (jb, b) = _manifest_specs()
    gets = [(0, 3), (1, 9), (0, 3), (0, 5)]
    caches = {"ref": jserve.OperatorCache(capacity=4),
              "port": serve.OperatorCache(capacity=4, device="cpu")}
    specs = {"ref": (ja, jb), "port": (a, b)}
    for name, cache in caches.items():
        for i, seed in gets:
            cache.get(specs[name][i], seed=seed)
    man = caches["port"].manifest()
    assert json.dumps(man) == json.dumps(caches["ref"].manifest())
    assert [e["seed"] for e in man] == [9, 3, 5]       # LRU-first
    for name, fresh in (("ref", lambda c: jserve.OperatorCache(capacity=c)),
                        ("port", lambda c: serve.OperatorCache(
                            capacity=c, device="cpu"))):
        warm = fresh(4)
        assert warm.prewarm(man) == 3
        st = warm.stats
        assert (st.prewarmed, st.misses, st.hits) == (3, 0, 0)
        assert set(st.as_dict()) == set(caches["ref"].stats.as_dict())
        assert json.dumps(warm.manifest()) == json.dumps(man)
        warm.get(specs[name][0], seed=3)
        assert (warm.stats.hits, warm.stats.misses) == (1, 0)
        # idempotent: a second prewarm samples nothing, refreshes recency
        assert warm.prewarm(man) == 0 and warm.stats.prewarmed == 3
        assert [e["seed"] for e in warm.manifest()] == [9, 3, 5]
        tiny = fresh(1)
        assert tiny.prewarm(man) == 3
        assert tiny.stats.evictions == 2 and len(tiny) == 1
        assert tiny.manifest()[0]["seed"] == 5
    again = serve.OperatorCache(capacity=4, device="cpu")
    again.prewarm(man)
    for spec, seed in caches["port"].keys():
        got, want = again.get(spec, seed), caches["port"].get(spec, seed)
        arrays = "cores" if spec.family == "tt" else "factors"
        assert all(torch.equal(x, y) for x, y in zip(
            getattr(got, arrays), getattr(want, arrays)))


def test_server_prewarms_from_the_reference_manifest_file(tmp_path):
    """A manifest the reference's `save_manifest` wrote warms the port's
    server: the first request of the lane hits; the port writes the same
    file; a file without 'entries' raises the reference's ValueError."""
    (ja, a), _ = _manifest_specs()
    x = np.zeros((4 * 8 * 8,), np.float32)
    jsrv = jserve.SketchServer(jserve.ServeConfig())
    jsrv.submit(x, ja, seed=1, now=0.0)
    jsrv.tick(1.0, force=True)
    path = tmp_path / "ops.json"
    assert jsrv.save_manifest(path) == 1
    srv = serve.SketchServer(serve.ServeConfig(), device="cpu")
    assert srv.prewarm(path) == 1
    srv.submit(x, a, seed=1, now=0.0)
    srv.tick(1.0, force=True)
    assert (srv.cache.stats.hits, srv.cache.stats.misses) == (1, 0)
    ours = tmp_path / "ours.json"
    assert srv.save_manifest(ours) == 1
    assert json.loads(ours.read_text()) == json.loads(path.read_text())
    assert b"cores" not in ours.read_bytes()      # specs only, no weights
    srv2 = serve.SketchServer(serve.ServeConfig(), device="cpu")
    assert srv2.prewarm(json.loads(ours.read_text())["entries"]) == 1
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1}')
    for server in (srv2, jsrv):
        with pytest.raises(ValueError, match="entries"):
            server.prewarm(bad)


def test_serve_rp_cli_save_manifest_and_prewarm(tmp_path, capsys):
    path = tmp_path / "m.json"
    argv = ["--device", "cpu", "--requests", "24", "--max-batch", "4",
            "--pool", "2"]
    assert serve_rp.main(argv + ["--save-manifest", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"wrote 2-entry cache manifest to {path}" in out
    assert serve_rp.main(argv + ["--prewarm", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"prewarmed 2 operators from {path}" in out
    assert " / 0 misses" in out
