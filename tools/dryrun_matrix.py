#!/usr/bin/env python3
"""Run the port's dry run over every (arch x shape x mesh) cell.

    PYTHONPATH=src python3 tools/dryrun_matrix.py [--out experiments/dryrun]
        [--jobs 6] [--timeout 3600] [--arch A ...] [--shape S ...] [--no-run]

Each cell is one `python -m repro_torch.launch.dryrun` process (the
production meshes (16, 16) and (2, 16, 16) as rank 0 of a fake world, on
meta tensors: host work, no card), `--jobs` at a time. A cell that exits
non-zero or outlives `--timeout` seconds is written as a cell of status
"failed" with the last line of its error. Then the script prints each
cell's wall seconds, `report.dryrun_table` of the cells in `--out` and
one row an (arch, shape) (`--no-run`: the tables alone): status, the
per-device flops, bytes and link bytes, the peak GiB, and the three
roofline terms in seconds, which come from NVIDIA's published H100 SXM
peaks (`launch/roofline.py`), not from a measurement.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def _cell(arch: str, shape: str, multi_pod: bool, out: pathlib.Path,
          timeout: float) -> tuple[str, float]:
    """Run one cell; its name and wall seconds (a failure's cell file
    written here)."""
    mesh = "2x16x16" if multi_pod else "16x16"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out)] + (
               ["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
        err = None if p.returncode == 0 else (
            [ln for ln in p.stderr.splitlines() if ln.strip()] or ["?"])[-1]
    except subprocess.TimeoutExpired:
        err = f"timed out after {timeout:.0f} s"
    if err is not None:
        cell = {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "failed", "error": err.removeprefix("[rank0]: ")}
        (out / f"{arch}_{shape}_{mesh}.json").write_text(
            json.dumps(cell, indent=1))
    return f"{arch} {shape} {mesh}", time.perf_counter() - t0


# the compact table's columns: (header, a cell's value as text)
COLUMNS = (
    ("flops/dev", lambda r: f"{r['hlo_flops_per_device']:.3g}"),
    ("bytes/dev", lambda r: f"{r['hlo_bytes_per_device']:.3g}"),
    ("link bytes/dev",
     lambda r: f"{r['collective']['link_bytes_per_device']:.3g}"),
    ("peak GiB/dev", lambda r: "%.2f" % (
        r["memory_per_device"]["peak_bytes_per_device"] / 2**30)),
    ("compute s", lambda r: f"{r['compute_s']:.3g}"),
    ("memory s", lambda r: f"{r['memory_s']:.3g}"),
    ("collective s", lambda r: f"{r['collective_s']:.3g}"),
)


def compact_table(cells: list[dict]) -> str:
    """One row an (arch, shape), each column 'the value on (16, 16) / on
    (2, 16, 16)'; a row none of whose cells ran gives its reason, and the
    archs a shape is skipped for on both meshes share one row."""
    by: dict = {}
    for c in cells:
        by.setdefault((c["arch"], c["shape"]), {})[c["mesh"]] = c
    out = ["| arch | shape | status | "
           + " | ".join(h for h, _ in COLUMNS) + " |",
           "|---" * (3 + len(COLUMNS)) + "|"]
    skipped: dict = {}
    for (arch, shape), m in sorted(by.items()):
        pair = [m.get(k, {"status": "missing"}) for k in ("16x16", "2x16x16")]
        status = " / ".join(c["status"] for c in pair)
        if status == "skip / skip":
            skipped.setdefault(shape, []).append(arch)
            continue
        if all(c["status"] != "ok" for c in pair):
            why = pair[0].get("reason") or pair[0].get("error", "")
            out.append(f"| {arch} | {shape} | {status}: {why} |"
                       + " |" * len(COLUMNS))
            continue
        vals = [" / ".join(f(c["roofline"]) if c["status"] == "ok" else "-"
                           for c in pair) for _, f in COLUMNS]
        out.append(f"| {arch} | {shape} | {status} | " + " | ".join(vals)
                   + " |")
    for shape, archs in sorted(skipped.items()):
        out.append(f"| {', '.join(archs)} | {shape} | skip / skip (the "
                   "reference's) |" + " |" * len(COLUMNS))
    return "\n".join(out)


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import ARCHS
    from repro_torch.launch import report
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--no-run", action="store_true",
                    help="only print the tables of the cells in --out")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    todo = [(a, s.name, mp) for a, cfg in ARCHS.items()
            if not args.arch or a in args.arch
            for s in cfg.shapes if not args.shape or s.name in args.shape
            for mp in (False, True)]
    # the longest cells first: prefill, then train, then decode
    order = {"prefill_32k": 0, "train_4k": 1}
    todo.sort(key=lambda c: (order.get(c[1], 2), -ARCHS[c[0]].n_layers))
    t0 = time.perf_counter()
    if not args.no_run:
        with cf.ThreadPoolExecutor(args.jobs) as pool:
            walls = dict(pool.map(lambda c: _cell(*c, out, args.timeout),
                                  todo))
        print(f"ran {len(todo)} cells in {time.perf_counter() - t0:.0f} s: "
              + ", ".join(f"{k} {v:.0f} s" for k, v in sorted(walls.items())))
    cells = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    print(report.dryrun_table([c for c in cells if c["status"] != "failed"]))
    print()
    print(compact_table(cells))
    n = {s: sum(c["status"] == s for c in cells)
         for s in ("ok", "skip", "failed")}
    print(f"\n{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
