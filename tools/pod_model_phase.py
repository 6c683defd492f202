"""Phase 24 of chip_smoke.py (the (pod, data, model) mesh and its
checkpoints) alone on the card: the kernels' build (K1 and K2 run in the
compressed steps and the sketched record), phase 21's one-rank
compositions, then its four gloo ranks running phase 24 alone (phase
21's own steps skipped). Prints the card's name and power limit, the
build time, the phase's `pod_model` JSON line and its seconds.

    python3 tools/pod_model_phase.py

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
    t0 = time.perf_counter()
    out = chip_smoke.pod_data_phase(torch.device("cuda"), modes=())
    print(json.dumps({"pod_model": out["24"]}), flush=True)
    print(f"phase 24 seconds {out['24']['seconds']:.1f} (with phase 21's "
          f"one-rank compositions and the ranks' start "
          f"{time.perf_counter() - t0:.1f})", flush=True)
