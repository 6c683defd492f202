"""Where a full-width decode step spends its device time.

One `decode_step` of a model at its published widths (random weights at
the policy's dtype: fp32, or bf16 under 'lean'; bf16 compute, `slots`
sequences against a `max_seq` cache), at full depth or cut to `LAYERS`
(an MoE model's default is `chip_smoke.py` phase 18's cut: 4 layers of
mixtral-8x22b, 2 of arctic-480b), run eagerly under torch.profiler (CPU
and CUDA activity) for a few steps: the device time a step split by the
aten op that launched it -- the per-layer casts of the weights to the
compute dtype (a `copy_` under `_to_copy`), the other copies (a
recurrent state written back into the cache, layout copies), the
matrix products, and for an MoE model the expert products (the batched
SwiGLU's three `bmm`s) and the dispatch (the router, top-k, the slot
ranks, the scatter into the expert buffer, the gather and the
gate-weighted sum: every other op inside `moe_ffn`) -- and the rest;
the kernel records and the host's launch calls a step, and the wall ms
a step; then the same step captured as a CUDA graph by the LM server
(`launch.serve._GraphedStep`), its wall ms a step and whether its logits
equal the eager step's bit for bit from the same cache. Any family
runs (whisper's cross K/V stay zeros). Prints one JSON line.

    python3 tools/decode_step_probe.py [ARCH] [SLOTS] [LAYERS]  # on a card

Run from the root of the repository; ARCH defaults to llama3.2-3b and
SLOTS to 8 (`max_seq` 512).
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import _GraphedStep  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402

CAST = ("aten::copy_",)
PRODUCT = ("aten::mm", "aten::bmm", "aten::addmm")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")
DEPTH = {"mixtral-8x22b": 4, "arctic-480b": 2}   # chip_smoke.py phase 18
STEPS = 5


def _in_moe(event) -> bool:
    while event is not None:
        if event.name == "moe_ffn":
            return True
        event = event.cpu_parent
    return False


def _part(event, n_experts) -> str:
    if _in_moe(event):
        shapes = event.input_shapes or [[]]
        expert = (event.name == "aten::bmm" and shapes[0]
                  and shapes[0][0] == n_experts)
        return "expert_product" if expert else "dispatch"
    if event.name in CAST:
        parent = event.cpu_parent
        return ("cast" if parent is not None
                and parent.name == "aten::_to_copy" else "copy")
    return "product" if event.name in PRODUCT else "other"


def main() -> int:
    arch = sys.argv[1] if len(sys.argv) > 1 else "llama3.2-3b"
    slots = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    cfg = get_config(arch)
    layers = int(sys.argv[3]) if len(sys.argv) > 3 else DEPTH.get(
        arch, cfg.n_layers)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=steps._policy(cfg)["param_dtype"])
    cache = model.init_cache(slots, 512, device=dev)
    tok = torch.randint(1, cfg.vocab, (slots,), device=dev,
                        dtype=torch.int32)
    pos = torch.arange(slots, device=dev, dtype=torch.int32) + 64
    n_experts = cfg.moe.num_experts if cfg.moe is not None else 0

    moe_ffn = transformer.moe_ffn

    def marked_moe_ffn(*args, **kw):
        with record_function("moe_ffn"):
            return moe_ffn(*args, **kw)

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
    transformer.moe_ffn = marked_moe_ffn
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()
    finally:
        transformer.moe_ffn = moe_ffn
    split = {"cast": 0.0, "copy": 0.0, "product": 0.0, "other": 0.0}
    if n_experts:
        split.update(expert_product=0.0, dispatch=0.0)
    for e in prof.events():
        t = (e.self_device_time_total if hasattr(e, "self_device_time_total")
             else e.self_cuda_time_total)
        if e.device_type.name != "CPU" or not t:
            continue
        split[_part(e, n_experts)] += t / 1e3 / STEPS
    ka = prof.key_averages()
    kernels = sum(e.count for e in ka if e.device_type.name == "CUDA")
    launches = sum(e.count for e in ka if e.key in LAUNCH)
    leaves = tree_leaves(cache)
    snap = [t.clone() for t in leaves]

    def restore():
        for t, s in zip(leaves, snap):
            t.copy_(s)
    graphed = _GraphedStep(model, params, cache, slots, dev,
                           restore)                     # the server's
    out = graphed(params, cache, tok, pos)[0].clone()
    restore()
    same = bool(torch.equal(out, step()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * STEPS):
        graphed(params, cache, tok, pos)
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t0) / (4 * STEPS)
    print(json.dumps({
        "arch": arch, "layers": layers, "slots": slots,
        "param_dtype": str(steps._policy(cfg)["param_dtype"]),
        "device": torch.cuda.get_device_name(0),
        "eager_ms": eager_ms, "graph_ms": graph_ms, "graph_equals_eager": same,
        "device_ms_by_op": split, "device_ms": sum(split.values()),
        "kernel_records_a_step": kernels / STEPS,
        "launch_calls_a_step": launches / STEPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
