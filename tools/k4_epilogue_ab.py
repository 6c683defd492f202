"""K4 at the training leaf, this tree's `fused_update.cu` against another
version of it, in one process on the card.

K4's whole-leaf entry (`fused_update_launch`) keeps its C signature, so
the other source is built with the same `nvcc` flags against this tree's
headers and swapped in as the wrapper's launcher. Both time
`fused_update_buckets` at phase 9's w_gate leaf (48 buckets of 32^4,
TT(8), k=1024; random inputs from seed 0) with CUDA events, 10 launches
a round, in rounds ordered other, this, this, other, ... (`--pairs`
pairs). Prints the name and power limit of the card and one JSON line:
each side's round means and their median, and whether both sides give
the same bits.

    python3 tools/k4_epilogue_ab.py OTHER_FUSED_UPDATE_CU [--pairs 10]

Run from the root of the repository on a card.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _build_other(source: Path):
    """The other source as a shared library next to this tree's builds
    (its includes resolved in this tree's csrc), its launch entry."""
    from repro_torch.kernels import _sweep
    out = _sweep.BUILD_DIR / "k4_other.so"
    _sweep.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_sweep._nvcc(), *_sweep.NVCC_FLAGS, "-I",
                    str(_sweep.CSRC), "-o", str(out), str(source)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).fused_update_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _sweep._ARGTYPES["fused_update"]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_epilogue_ab: needs a card", file=sys.stderr)
        return 2
    from repro_torch import rp
    from repro_torch.kernels import _sweep
    from repro_torch.kernels import fused_update as kfused
    dev = torch.device("cuda")
    this = _sweep._launcher("fused_update")
    other = _build_other(args.other)
    dims, k, nb = (32, 32, 32, 32), 1024, 48
    op = rp.make_projector(rp.ProjectorSpec("tt", k, dims, 8), 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((nb, k), generator=g, device=dev)
    dense = [torch.randn((nb,) + dims, generator=g, device=dev)
             for _ in range(4)]
    dense[3] = dense[3].abs()
    hp = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

    def run():
        return kfused.fused_update_buckets(op, y, *dense, 3e-4, 0.1, 0.05,
                                           **hp)

    def timed(fn, reps=10):
        _sweep._FNS["fused_update"] = fn
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    _sweep._FNS["fused_update"] = other
    a = run()
    _sweep._FNS["fused_update"] = this
    b = run()
    same = all(torch.equal(x, z) for x, z in zip(a, b))
    times = {"other": [], "this": []}
    for _ in range(args.pairs):
        times["other"].append(timed(other))
        times["this"].append(timed(this))
        times["this"].append(timed(this))
        times["other"].append(timed(other))
    _sweep._FNS["fused_update"] = this
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"k4_epilogue_ab": {
        "shape": "w_gate B=48 k=1024 dims=32^4 TT(8)",
        "other": str(args.other), "same_bits": same,
        "ms": times, "median_ms": {key: statistics.median(v)
                                   for key, v in times.items()}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
