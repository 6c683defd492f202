"""Where a full-width decode step spends its device time.

One `decode_step` of a dense decoder at its published widths and full
depth (random fp32 weights, bf16 compute, `slots` sequences against a
`max_seq` cache), run eagerly under torch.profiler (CPU and CUDA
activity) for a few steps: the device time a step split by the aten op
that launched it (the per-layer casts of the fp32 weights to bf16, the
matrix products, the rest), the kernel records and the host's launch
calls a step, and the wall ms a step; then the same step captured as a
CUDA graph by the LM server (`launch.serve._GraphedStep`), its wall ms a
step and whether its logits equal the eager
step's bit for bit. Prints one JSON line.

    python3 tools/decode_step_probe.py [ARCH] [SLOTS]   # on a CUDA card

Run from the root of the repository; ARCH defaults to llama3.2-3b and
SLOTS to 8 (`max_seq` 512).
"""
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import _GraphedStep  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CAST = ("aten::copy_",)
PRODUCT = ("aten::mm", "aten::bmm", "aten::addmm")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
STEPS = 5


def main() -> int:
    arch = sys.argv[1] if len(sys.argv) > 1 else "llama3.2-3b"
    slots = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_model(get_config(arch))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cache = model.init_cache(slots, 512, device=dev)
    tok = torch.randint(1, model.cfg.vocab, (slots,), device=dev,
                        dtype=torch.int32)
    pos = torch.arange(slots, device=dev, dtype=torch.int32) + 64

    def step():
        return model.decode_step(params, cache, tok, pos)[0]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    split = {"cast": 0.0, "product": 0.0, "other": 0.0}
    for e in ka:
        if e.device_type.name != "CPU" or not e.self_device_time_total:
            continue
        part = ("cast" if e.key in CAST else
                "product" if e.key in PRODUCT else "other")
        split[part] += e.self_device_time_total / 1e3 / STEPS
    kernels = sum(e.count for e in ka if e.device_type.name == "CUDA")
    launches = sum(e.count for e in ka if e.key in LAUNCH)
    graphed = _GraphedStep(model, params, cache, slots, dev)  # the server's
    out = graphed(params, cache, tok, pos)[0].clone()
    same = bool(torch.equal(out, step()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * STEPS):
        graphed(params, cache, tok, pos)
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t0) / (4 * STEPS)
    print(json.dumps({
        "arch": arch, "slots": slots, "device": torch.cuda.get_device_name(0),
        "eager_ms": eager_ms, "graph_ms": graph_ms, "graph_equals_eager": same,
        "device_ms_by_op": split, "device_ms": sum(split.values()),
        "kernel_records_a_step": kernels / STEPS,
        "launch_calls_a_step": launches / STEPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
