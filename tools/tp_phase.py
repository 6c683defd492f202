"""Phase 22 of chip_smoke.py (the model axis) alone on the card, the
kernels' build timed first (`fused_update.cu` alone, then the other
sources). Prints the card's name and power limit, the build times, the
phase's `tp` JSON line and its seconds.

    python3 tools/tp_phase.py

Run from the root of the repository on a card.
"""
import json
import os
import sys
import time
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.kernels import _sweep  # noqa: E402
import chip_smoke  # noqa: E402

if __name__ == "__main__":
    print(chip_smoke.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _sweep.build(["fused_update"])
    t1 = time.perf_counter()
    _sweep.build()
    print(f"build: fused_update.cu {t1 - t0:.1f} s alone, the rest "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    out = chip_smoke.tp_phase(torch.device("cuda"))
    print(json.dumps({"tp": out}), flush=True)
    print("phase 22 seconds", out["seconds"], flush=True)
