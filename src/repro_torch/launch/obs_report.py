"""Render a markdown report from a `repro_torch.obs` capture.

Port of `repro/launch/obs_report.py`.

Takes the two artifacts a capture writes — the Chrome/Perfetto trace JSON
(`--trace`) and the metrics JSONL (`--metrics`) — and prints the markdown
tables a PR or dashboard wants: span durations aggregated by name, queue
histogram percentiles, counters/gauges, and the event log (stragglers,
resume/fallback, distortion alerts). Either input may be omitted.

`--explain SPEC` additionally (or instead) renders the `ExecutionPlan` the
dispatch layer would resolve for a projection described by SPEC — the
chosen route/kernel/tiles, the unified cost ledger, and every rejected
alternative with its reason (see `repro_torch/rp/plan.py`'s module
docstring for the dispatch matrix; `rp.explain(op, x)` is the in-process
form).
SPEC is comma-separated key=value pairs:

    family=tt,k=256,dims=8x16x16,rank=2,structure=dense,batch=8,\
backend=auto,pipeline=serial,kind=project

`family` (tt/cp/gaussian/sparse), `k` and `dims` (x-separated) are
required; `rank` (default 2), `structure` (dense/tt/cp/sketch),
`batch`, `in_rank`, `chunk`, `backend` (auto/kernel/torch), `pipeline`
and `kind` (project/reconstruct) are optional; the plan is for the CUDA
device. Span rows in the trace carry the
matching `plan` id attribute, so a hot span can be looked up here.

Usage:
PYTHONPATH=src python -m repro_torch.launch.obs_report \
    --trace trace.json --metrics metrics.jsonl
PYTHONPATH=src python -m repro_torch.launch.obs_report \
    --explain family=tt,k=128,dims=8x16x16,rank=2,batch=8
"""
from __future__ import annotations

import argparse
import json
import pathlib


def load_trace(path) -> list[dict]:
    """The `traceEvents` list of a Chrome trace file, schema-checked."""
    doc = json.loads(pathlib.Path(path).read_text())
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        raise ValueError(
            f"{path} is not a Chrome trace: expected a JSON object with a "
            "'traceEvents' list (did you pass the metrics JSONL here?)")
    for e in events:
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            raise ValueError(
                f"{path}: malformed trace event {e!r} (every event needs "
                "'name' and 'ph')")
    return events


def span_table(events: list[dict]) -> str:
    """Durations of complete ("ph": "X") spans aggregated by name."""
    agg: dict[str, list[float]] = {}
    for e in events:
        if e.get("ph") == "X":
            agg.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
    out = ["| span | count | total ms | mean us | max us |",
           "|---|---|---|---|---|"]
    for name in sorted(agg):
        durs = agg[name]
        out.append(f"| {name} | {len(durs)} | {sum(durs) / 1e3:.2f} "
                   f"| {sum(durs) / len(durs):.0f} | {max(durs):.0f} |")
    return "\n".join(out)


def instant_table(events: list[dict]) -> str:
    """Instant markers ("ph": "i") grouped by name."""
    agg: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "i":
            agg[e["name"]] = agg.get(e["name"], 0) + 1
    out = ["| instant | count |", "|---|---|"]
    for name in sorted(agg):
        out.append(f"| {name} | {agg[name]} |")
    return "\n".join(out)


def metrics_tables(lines: list[dict]) -> str:
    """Counters/gauges, histogram percentiles and events from the JSONL."""
    counters = [l for l in lines if l.get("type") in ("counter", "gauge")]
    hists = [l for l in lines if l.get("type") == "histogram"]
    events = [l for l in lines if l.get("type") == "event"]
    blocks = []
    if counters:
        rows = ["| instrument | kind | value |", "|---|---|---|"]
        for l in sorted(counters, key=lambda l: l["name"]):
            rows.append(f"| {l['name']} | {l['type']} | {l['value']:g} |")
        blocks.append("\n".join(rows))
    if hists:
        rows = ["| histogram | n | mean | p50 | p99 |", "|---|---|---|---|---|"]
        for l in sorted(hists, key=lambda l: l["name"]):
            mean = l["sum"] / l["count"] if l["count"] else 0.0
            rows.append(f"| {l['name']} | {l['count']} | {mean:.0f} "
                        f"| {l['p50']:.0f} | {l['p99']:.0f} |")
        blocks.append("\n".join(rows))
    if events:
        rows = ["| event | details |", "|---|---|"]
        for l in events:
            detail = ", ".join(f"{k}={v}" for k, v in sorted(l.items())
                               if k not in ("type", "name", "time"))
            rows.append(f"| {l['name']} | {detail} |")
        blocks.append("\n".join(rows))
    return "\n\n".join(blocks) if blocks else "(no metrics recorded)"


def explain_plan(spec: str) -> str:
    """Resolve SPEC (see module docstring) to its plan's describe() block."""
    kv = {}
    for part in spec.split(","):
        key, eq, val = part.partition("=")
        if not eq or not key:
            raise ValueError(
                f"--explain spec entry {part!r} is not key=value; expected "
                "e.g. family=tt,k=128,dims=8x16x16,rank=2,batch=8")
        kv[key.strip()] = val.strip()
    missing = [k for k in ("family", "k", "dims") if k not in kv]
    if missing:
        raise ValueError(f"--explain spec is missing required key(s) "
                         f"{missing}; got {sorted(kv)}")
    from repro_torch import rp
    pspec = rp.ProjectorSpec(
        family=kv["family"], k=int(kv["k"]),
        dims=tuple(int(d) for d in kv["dims"].split("x")),
        rank=int(kv.get("rank", 2)))
    sig = rp.StructureSig(
        structure=kv.get("structure",
                         "sketch" if kv.get("kind") == "reconstruct"
                         else "dense"),
        batch=int(kv.get("batch", 1)),
        in_rank=int(kv.get("in_rank", 0)),
        chunk=int(kv["chunk"]) if kv.get("chunk") else None)
    plan = rp.plan_execution(pspec, sig, kind=kv.get("kind", "project"),
                             backend=kv.get("backend", "auto"),
                             pipeline=kv.get("pipeline", "serial"))
    return plan.describe()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="Chrome trace JSON from obs.Tracer.export / "
                         "--trace-out")
    ap.add_argument("--metrics", default=None,
                    help="metrics JSONL from obs.MetricsRegistry.write_jsonl"
                         " / --metrics-out")
    ap.add_argument("--explain", default=None, metavar="SPEC",
                    help="render the ExecutionPlan for a projection spec, "
                         "e.g. family=tt,k=128,dims=8x16x16,rank=2,batch=8,"
                         "backend=auto,pipeline=serial,kind=project")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics and not args.explain:
        ap.error("pass --trace, --metrics and/or --explain")
    if args.explain:
        print(explain_plan(args.explain))
    if args.trace:
        events = load_trace(args.trace)
        print(f"### Spans ({args.trace})\n")
        print(span_table(events))
        if any(e.get("ph") == "i" for e in events):
            print("\n### Trace instants\n")
            print(instant_table(events))
    if args.metrics:
        from repro_torch.obs import read_jsonl
        lines = read_jsonl(args.metrics)
        print(f"\n### Metrics ({args.metrics})\n")
        print(metrics_tables(lines))
        alerts = [l for l in lines if l.get("name") == "distortion.alert"]
        if alerts:
            print(f"\nWARNING: {len(alerts)} distortion alert(s) — sketch "
                  "width k is undersized for the configured (eps, delta).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
