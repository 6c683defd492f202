"""Sketch-serving CLI: replay a synthetic trace through the serving engine.

Port of `repro/launch/serve_rp.py`. Drives `repro_torch.serve.SketchServer`
with the offline load generator on the CUDA device (or `--device cpu`) and
prints the serving report — p50/p99 queueing latency, batch occupancy,
operator-cache hit rate, one kernel dispatch per tick (asserted against
`rp.dispatch_stats()`) — then queries the freshly ingested sketches.

    PYTHONPATH=src python -m repro_torch.launch.serve_rp --family tt \
        --k 512 --dims 64 64 64 --rank 5 --requests 256 --max-batch 64

`--backend` takes the port's names for the reference's routes: 'kernel'
for 'pallas', 'torch' for 'xla'. With `--trace-out trace.json
--metrics-out metrics.jsonl` the replay runs under an enabled
`repro_torch.obs` session: the trace opens in ui.perfetto.dev (per-tick
serve spans over the rp dispatch spans they contain), the JSONL carries
the queue-delay histogram and request counters, and
`python -m repro_torch.launch.obs_report` renders both. `--distortion EPS
DELTA` streams each dense request's distortion through a
`DistortionMonitor`. `--save-manifest PATH` writes the operator cache's
registry after the replay, and `--prewarm MANIFEST` regenerates a prior
run's operators before it, so the restarted server's first requests hit.
"""
from __future__ import annotations

import argparse
import contextlib

from repro_torch import obs, rp
from repro_torch.rp.plan import BACKENDS
from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                               replay, synth_trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="tt", choices=("tt", "cp"))
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--dims", type=int, nargs="+", default=[8, 16, 16])
    ap.add_argument("--rank", type=int, default=2)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--pool", type=int, default=1,
                    help="operator pool size (distinct seeds of the spec); "
                         ">1 exercises LRU cache eviction")
    ap.add_argument("--mix", type=float, nargs=3, default=[1.0, 1.0, 1.0],
                    metavar=("DENSE", "TT", "CP"),
                    help="relative payload-structure weights")
    ap.add_argument("--mean-gap-us", type=float, default=200.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--flush-us", type=float, default=1_000.0)
    ap.add_argument("--cache-capacity", type=int, default=8)
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    ap.add_argument("--top-m", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (fails without it)")
    ap.add_argument("--prewarm", default=None, metavar="MANIFEST",
                    help="warm the operator cache from a prior run's "
                         "--save-manifest file before replay (operators "
                         "regenerate bitwise from (spec, seed))")
    ap.add_argument("--save-manifest", default=None, metavar="PATH",
                    help="after replay, write the cache registry (spec "
                         "dicts + seeds, no operator bytes) for --prewarm")
    ap.add_argument("--trace-out", default=None, metavar="JSON",
                    help="record the replay under repro_torch.obs and "
                         "export the Chrome/Perfetto trace here")
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="write the obs metrics snapshot (counters, queue-"
                         "delay histogram, events) here as JSONL")
    ap.add_argument("--distortion", type=float, nargs=2, default=None,
                    metavar=("EPS", "DELTA"),
                    help="stream dense-request distortion through a "
                         "DistortionMonitor at this (eps, delta) target")
    args = ap.parse_args(argv)

    spec = rp.ProjectorSpec(family=args.family, k=args.k,
                            dims=tuple(args.dims), rank=args.rank)
    cfg = ServeConfig(max_batch=args.max_batch, flush_us=args.flush_us,
                      cache_capacity=args.cache_capacity,
                      backend=args.backend)
    store = SketchStore(spec, device=args.device)
    server = SketchServer(cfg, store, device=args.device)
    pool = [(spec, s) for s in range(args.pool)]
    trace = synth_trace(args.requests, pool, mix=tuple(args.mix),
                        mean_gap_us=args.mean_gap_us, seed=args.seed)
    if args.prewarm:
        n = server.prewarm(args.prewarm)
        print(f"[serve_rp] prewarmed {n} operators from {args.prewarm}")
    mon = (obs.DistortionMonitor(eps=args.distortion[0],
                                 delta=args.distortion[1])
           if args.distortion else None)
    cap = (obs.capture(trace_path=args.trace_out,
                       metrics_path=args.metrics_out, distortion=mon)
           if (args.trace_out or args.metrics_out or mon)
           else contextlib.nullcontext())
    with cap, rp.dispatch_stats() as st:
        report = replay(server, trace)
    if st.kernel_calls not in (0, report["ticks"]):
        raise RuntimeError(f"{st.kernel_calls} kernel dispatches for "
                           f"{report['ticks']} ticks")
    disp = (f"{st.kernel_calls} kernel dispatches — one per tick"
            if st.kernel_calls else "einsum-routed, one dispatch per tick")
    print(f"[serve_rp] device {server.device}: {report['requests_done']}/"
          f"{report['n_trace']} requests in {report['ticks']} ticks ({disp})")
    print(f"[serve_rp] latency p50={report['p50_us']:.0f}us "
          f"p99={report['p99_us']:.0f}us  "
          f"occupancy={report['occupancy_mean']:.2f}  "
          f"wall={report['wall_s']:.2f}s")
    c = report["cache"]
    print(f"[serve_rp] operator cache: {c['hits']} hits / {c['misses']} "
          f"misses (hit rate {c['hit_rate']:.1%}), "
          f"{c['evictions']} evictions, regen {c['regen_s']:.2f}s")
    print(f"[serve_rp] store: {report['store_size']} sketches "
          f"({report['store_bytes'] / 1024:.1f} KiB)")
    if args.save_manifest:
        n = server.save_manifest(args.save_manifest)
        print(f"[serve_rp] wrote {n}-entry cache manifest to "
              f"{args.save_manifest}")
    if args.trace_out:
        print(f"[serve_rp] wrote Perfetto trace to {args.trace_out} "
              "(open in ui.perfetto.dev)")
    if args.metrics_out:
        print(f"[serve_rp] wrote obs metrics to {args.metrics_out}")
    if mon is not None:
        for row in mon.summary():
            print(f"[serve_rp] distortion {row['family']}/N={row['order']}"
                  f"/k={row['k']}: mean {row['mean_distortion']:.3f}, "
                  f"out-rate {row['out_rate']:.3f} @ eps={row['eps']} "
                  f"(alerted={row['alerted']})")
    # nearest stored neighbours of the first sketch: its own id comes back
    # first, at distance ~0
    if len(store) > 1:
        top_m = min(args.top_m, len(store))
        res = server.query(store.get(0), top_m)
        ids = ", ".join(str(int(i)) for i in res.ids)
        print(f"[serve_rp] top-{top_m} of sketch 0: ids [{ids}]  "
              f"d2 {res.dist2.round(2).tolist()}")
        pw = server.pairwise([0], [int(res.ids[-1])])
        print(f"[serve_rp] JL bound: d2={pw.dist2[0]:.2f} in "
              f"[{pw.dist2_lo[0]:.2f}, {pw.dist2_hi[0]:.2f}] "
              f"(eps={pw.eps:.2f} @ delta={pw.delta})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
