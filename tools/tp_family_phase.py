"""Phase 23 of chip_smoke.py (the model axis for the SSM, hybrid and
encoder-decoder families) alone on the card: the kernels' build (K1 and
K4 run in mamba2's fused steps), then two gloo ranks of a (data=1,
model=2) mesh running `_tp_family_rank` as 22a's ranks do after 22c, and
`_tp_family_check`. Prints the card's name and power limit, the build
time, the phase's `tp_families` JSON line and its seconds.

    python3 tools/tp_family_phase.py

Run from the root of the repository on a card.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path
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
    root = Path(tempfile.mkdtemp(prefix="tp_family_"))
    torch.save({}, root / "ref.pt")     # 22a's steps: none here
    t0 = time.perf_counter()
    ranks = chip_smoke._pod_ranks(
        "tp_train", None, {"device": "cuda", "root": str(root),
                           "mesh": [1, 2], "batch": chip_smoke.TP_BATCH,
                           "modes": [], "families": {"cases": [
                               [a, c] for a, c in chip_smoke.FAM_CASES]}})
    out = chip_smoke._tp_family_check([r["families"] for r in ranks])
    print(json.dumps({"tp_families": out}), flush=True)
    print(f"phase 23 seconds {out['seconds']:.1f} (ranks with their start "
          f"{time.perf_counter() - t0:.1f})", flush=True)
