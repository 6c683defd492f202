"""Phase 23c of chip_smoke.py (model sizes the model axis does not
divide: llama3.2-3b, mamba2-1.3b and whisper-medium on a (data=1,
model=3) mesh) alone on the card: the kernels' build (K1 and K4 run in
mamba2's fused steps), then `sizes_phase`, which starts its three gloo
ranks. Prints the card's name and power limit, the build time, the
phase's `tp_sizes` JSON line and its seconds.

    python3 tools/sizes_phase.py

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
    _sweep.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    out = chip_smoke.sizes_phase(torch.device("cuda"))
    print(json.dumps({"tp_sizes": out}), flush=True)
    print(f"phase 23c seconds {out['seconds']:.1f}", flush=True)
