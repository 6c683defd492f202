"""How often does a torch.profiler window lose its kernel records?

`chip_smoke.py`'s `device_split` reads each kernel's device time from a
torch.profiler window of a few calls (CUDA activity only). This probe
takes such windows over and over, for two functions: K6 through
`rp.project` (a TT operator on a TT input, `pipeline="double"`) and a
one-element-per-thread torch kernel (`mul_` of 1,024 floats), each with no
host margin and with a 2 ms host sleep at both ends of the window. It
counts the windows whose key averages hold no device time and prints one
JSON line: per case, windows taken and windows empty, and what the
profiler did record in the first few empty windows.

    python3 tools/profiler_window_probe.py [SECONDS]   # on a CUDA card

Run from the root of the repository; SECONDS (default 200) bounds the
loop after the build.
"""
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch import rp  # noqa: E402
from repro_torch.core.formats import random_tt  # noqa: E402
from repro_torch.kernels import _sweep  # noqa: E402


def window(fn, reps: int, margin: float):
    """(kernels with device time, every event the profiler recorded) of
    one window of `reps` calls, after one call outside it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    names = [ev.key for ev in prof.key_averages()
             if (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))]
    raw = [(e.name(), str(e.device_type()), e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return names, raw


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_window_probe: CUDA is not available", file=sys.stderr)
        return 2
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 200.0
    _sweep.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    op = rp.make_projector(rp.ProjectorSpec("tt", 512, (64, 64, 64), 5),
                           seed=7, device=dev)
    x = random_tt(gen, (64, 64, 64), 4)
    buf = torch.ones(1 << 10, device=dev)
    fns = {"k6": lambda: rp.project(op, x, pipeline="double"),
           "mul": lambda: buf.mul_(1.0)}
    stats, empties = {}, []
    t_end = time.time() + seconds
    i = 0
    while time.time() < t_end:
        for name, fn in fns.items():
            for margin in (0.0, 0.002):
                key = f"{name}:margin{margin}"
                names, raw = window(fn, 3, margin)
                s = stats.setdefault(key, [0, 0])
                s[0] += 1
                if not names:
                    s[1] += 1
                    if len(empties) < 8:
                        empties.append({"key": key, "i": i, "raw": raw[:12]})
        i += 1
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "windows_and_empty": stats, "empties": empties}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
