"""Render the dry run's tables from its cell JSONs.

Port of `repro/launch/report.py` (its own copy: the port imports nothing
of the reference): the same tables, the same strings, over the cells
`launch/dryrun.py` writes.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments]
"""
from __future__ import annotations

import argparse
import json
import pathlib


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.1f}"


def load_cells(d: pathlib.Path) -> list[dict]:
    return [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]


def roofline_table(cells: list[dict], mesh: str) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | bottleneck "
           "| roofline frac | useful | peak GiB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh:
            continue
        if c["status"] == "skip":
            out.append(f"| {c['arch']} | {c['shape']} | — | — | — | SKIP | — "
                       f"| — | — |")
            continue
        r = c["roofline"]
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom if dom else 0.0
        peak = r["memory_per_device"].get("peak_bytes_per_device", 0.0)
        out.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.3f} "
            f"| {r['memory_s']:.3f} | {r['collective_s']:.3f} "
            f"| {r['bottleneck']} | {frac:.3f} "
            f"| {r['useful_flops_frac']:.2f} | {_fmt_bytes(peak)} |")
    return "\n".join(out)


def dryrun_table(cells: list[dict]) -> str:
    """§Dry-run: compile status + memory per cell per mesh."""
    by_key: dict[tuple, dict] = {}
    for c in cells:
        by_key[(c["arch"], c["shape"], c["mesh"])] = c
    archs = sorted({c["arch"] for c in cells})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    out = ["| arch | shape | 16x16 | GiB/dev | 2x16x16 | GiB/dev |",
           "|---|---|---|---|---|---|"]
    for a in archs:
        for s in shapes:
            row = [a, s]
            for mesh in ("16x16", "2x16x16"):
                c = by_key.get((a, s, mesh))
                if c is None:
                    row += ["(pending)", "—"]
                elif c["status"] == "skip":
                    row += ["SKIP", "—"]
                else:
                    peak = c["roofline"]["memory_per_device"].get(
                        "peak_bytes_per_device", 0.0)
                    row += [f"ok ({c['compile_s']:.0f}s)", _fmt_bytes(peak)]
            out.append("| " + " | ".join(row) + " |")
    return "\n".join(out)


def collective_detail(cells: list[dict], arch: str, shape: str,
                      mesh: str = "16x16", tag_note: str = "") -> str:
    for c in cells:
        if (c["arch"], c["shape"], c["mesh"]) == (arch, shape, mesh):
            r = c["roofline"]
            lines = [f"{arch} {shape} {mesh} {tag_note}"]
            for op, d in sorted(r["collective"]["per_type"].items()):
                lines.append(f"  {op:20s} n={d['count']:7.0f} "
                             f"traffic={d['traffic']/2**30:9.2f} GiB/dev")
            return "\n".join(lines)
    return f"{arch} {shape} {mesh}: missing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments")
    args = ap.parse_args(argv)
    base = pathlib.Path(args.dir)
    cells = load_cells(base / "dryrun") if (base / "dryrun").exists() else []
    print("### Dry-run matrix (paper-faithful baseline)\n")
    print(dryrun_table(cells))
    print("\n### Roofline, single-pod 16x16 (paper-faithful baseline)\n")
    print(roofline_table(cells, "16x16"))
    opt = (load_cells(base / "dryrun_opt")
           if (base / "dryrun_opt").exists() else [])
    if opt:
        print("\n### Roofline, single-pod 16x16 (beyond-paper optimized: "
              "grouped-GQA flash + batch-pinned constraints + "
              "shard-aware MoE dispatch)\n")
        print(roofline_table(opt, "16x16"))
    hc = (load_cells(base / "hillclimb")
          if (base / "hillclimb").exists() else [])
    if hc:
        print("\n### Hillclimb iteration cells (experiments/hillclimb)\n")
        print(roofline_table(hc, "16x16"))
        print()
        print(roofline_table(hc, "2x16x16"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
