#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
  1. the device: name, count, `nvidia-smi` name and power limit; TF32 off.
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, started together) and print ptxas' register, shared
     memory and spill lines.
  3. hold K1 `sweep_project` and K2 `sweep_reconstruct` against their plain
     PyTorch versions on the card: TT and CP, orders 2-5, ragged small
     shapes, and the serving shapes; K1 and K2 twice on the same inputs
     must give the same bits (K1 sums its T groups in a fixed order, K2
     each element in one thread).
  3b. hold K3 `carry_sweep_project` and K6 `carry_sweep_project_pipelined`
     against their plain versions (four pairings x orders 2-8, k=37, B=3,
     ragged TT ranks, CP inputs with and without weights; the serving
     shapes at B=8 and B=64, each twice for the same bits; bond 16 and
     input ranks 17-24; K3 alone at two shapes whose operator core rows
     K6's planner refuses, one of them staged in chunks of bond rows) and K5
     `sweep_project_pipelined` (TT/CP x orders 2-5, and the serving
     shapes); K6 against K3 and K5 against K1 on the same inputs. Then K1,
     K2 and K5 on ragged shapes: orders 2 and 8, B in {1, 3, 64}, k=37,
     ranks above 8.
  4. serve 1024 dense TT(5) requests through `SketchServer`
     (k=512, dims 64x64x64, max_batch=64, flush_us=1000) and check every
     tick launched K1 once; query the store.
  5. serve 256 dense CP(25) requests the same way.
  5b. serve the reference's mixed dense/TT/CP traffic (`mix=(1, 1, 1)`,
     input ranks 2, 3, 4): 1024 requests under TT(5), 256 under CP(25);
     K1 launches must equal the dense ticks, K3 launches the TT and CP
     ticks, `kernel_call_count` all ticks; each K3 launch's batch bucket
     is read off its tick's size (the B=8 rows of phase 7 take the B=8
     launches); served
     sketches are checked against the plain versions on the same operator.
  6. reconstruct 64 stored sketches of each through `rp.reconstruct` (K2).
  6b. `rp.project(op, x, pipeline="double")` on a B=64 dense batch (K5) and
     on B=64 batched TT and CP inputs (K6), for both operators; launch
     counts and equality with `pipeline="serial"`.
  7. time K1 and K2 at the serving shapes (B=64) beside their bound, their
     plain versions and one `torch.einsum` of the whole contraction. The
     bound counts the flops of the cheaper of two routes to the same
     function: the kernel's own program, or building the dense (k,
     prod(dims)) operator left to right and one product with it; the
     kernel's own program's bound is printed beside it as
     `program_bound_ms`. For K1, K5 and K2 that program is the fold, the
     operator tiles built once per batch tile, and the product
     (`route_flops`; the reference's program as `sweep_program_flops`);
     their rows also carry the bytes of the scratch buffers (m, and K1's
     and K5's partials) and the device time of each of their kernels from
     torch.profiler (`device_split_ms`). Then K5 at the same shapes,
     K3 and K6 at the four pairings (input rank 4, B=64), K3 at a serve
     tick's B=8 bucket (rows `...:b8`, with each bound of its own and the
     share of a mixed serve's structured tick), and K3 in the paper's
     regime (TT(5), k=512, dims 8^8, unit-norm rank-10 TT inputs; twice for
     the same bits), whose cheaper route is the carry program (each einsum
     step counted with the operands' true bonds) against densifying the
     input and the cheapest dense product; every K3/K6 row also carries
     the kernel's device time from torch.profiler (`device_split_ms`), the
     wrapper's host microseconds per call (`host_us`) and the plan's tiles.
  8. hold K4 `fused_update_buckets` against its plain version: TT/CP at
     orders 2-5 (ragged k and B), at orders 2 and 8 with ranks 9-25, B=130
     (two batch tiles) and d1 and T ragged against K4's tiles, and the
     reference test's TT(2), k=128, dims (16, 16, 8); each twice, for the
     same bits.
  9. train llama3.2-3b at its published widths, cut to 2 layers, sequence
     4096, batch 2, with sketch-compressed gradients (`tt:k=1024,rank=8,
     order=4`: 571 buckets of 32^4) through `build_train_step(...,
     fused_update=True)` and `init_train_state`: one warm-up step, then N
     counted steps, each one K1 and one K4 launch per leaf (11 leaves);
     every loss finite; the device time per step, and its split into
     loss+grad, sketch and fused update from the CUDA events the counted
     steps record inside themselves (`runtime.spans`).
  10. from that mid-trajectory state and one gradient: on every leaf, K4,
     K1 and K5 (each launched on the whole leaf, as the step launches K1
     and K4) against their plain versions in chunks of buckets, K1 against
     the sketch rows and K5 against K1; the fused update against the unfused chain
     (`compress` -> `adamw.update`: K1 + K2 + torch AdamW): residual, m'
     and v' within 1e-4 of their largest entry, w' within W_TOL_LR
     learning rates; then K4, K1 and K5 timed at the layers/w_gate leaf,
     each with its fold / product split (K5's numbers go into its TT row
     as `train_*`), and K4 twice there for the same bits; then K2 at the
     same leaf (the row `sweep_reconstruct:train`, the launch the
     sketched checkpoint codec makes a leaf on restore): against its plain
     version in chunks of 4 buckets, twice for the same bits, timed
     beside the same bound as K1's (the same flops and bytes reversed),
     its plain version and one `torch.einsum` of the adjoint, with its
     fold / product split; its launches are phase 14's.
  11. the reference test's learning run on the card: reduced llama3.2-3b,
     `tt:k=1024,rank=8,dims=4x8x16`, constant lr 3e-3, 8 fused steps; the
     last loss must be below the first.
  12. the paper's Fig. 1 (`benchmarks/distortion.py`'s three cases: d=15,
     N=3; d=3, N=12; d=3, N=25; a unit-norm rank-10 TT input each; k in
     {16, 64, 256, 1024}; TT(2/5/10), CP(4/25/100), Gaussian at the small
     case, very-sparse at the medium case for k <= 256; 20 operators a
     row, seeds 1000+t) through `rp.make_projector` and `rp.project` with
     the default backend: the mean and std distortion table with each
     operator's parameter count; K3 launches and `kernel_call_count` equal
     the small case's TT/CP projections, the order-12 and order-25 rows
     take the torch route, the baselines densify the TT input; every
     row's mean below 3 sqrt(c/k) (c the Thm-1 variance factor, 2 for
     Gaussian, very-sparse's worst case and its exact value on this
     input); every one of the 24 shapes K3 ran at (6 operators x 4 ks,
     B=1) held against its plain version on the same 20 operators; K3 at
     TT(10) and CP(100), k=1024, B=1 and B=64, twice each for the same
     bits; the streamed Gaussian against its materialized matrix (project
     and reconstruct, D=3375); a B=64 batch of small-case inputs timed
     through `rp.project` a map at k=1024; one `kernels` row a K3 shape,
     timed at B=1 with its launches queued behind a sleep kernel (at
     k=1024 TT(10) and CP(100) also the profiler's device time, the host
     time and the B=64 batch, as `b64_*`).
  13. telemetry (`repro_torch.obs`): the dense TT(5) replay (1024
     requests, k=512, 64^3) through `launch/serve_rp.main` with
     `--trace-out`, `--metrics-out` and `--distortion 0.5 0.05`
     (`required_k` 391 <= 512): one `serve.tick` span per tick, each
     holding one kernel-route `rp.project` span, a queue-delay histogram
     of 1024 requests, no alert; the same at k=16 raises one
     `distortion.alert`; `obs_report` over both captures; the k=512
     replay writes `--save-manifest`, and a second `serve_rp` on the same
     trace with `--prewarm` reports every manifest entry prewarmed and no
     cache miss, its operators' cores equal to the first server's bit for
     bit, each tick still one K1 launch; the mixed
     replay under `obs.capture`: dispatch spans == K1 + K3 launches; two
     full-width train steps through `runtime.train_loop.run` under capture
     (two `train.step` spans, each holding the sketcher's `rp.project`
     spans and the three `train.*` part spans); the host us of a B=8 K3
     dispatch with obs disabled and enabled beside K3's wrapper, and the
     disabled bundle (span + counter + histogram) within 5% of the
     wrapper's host time.
  14. checkpointing on phase 9's slice: `runtime.train_loop.run` under
     `run_with_restarts` with `LoopConfig(total_steps=4, ckpt_every=2,
     keep_ckpts=1, async_ckpt=True)`, a `SketchedTreeCodec` over the EF
     tree and `FaultInjector({3})`, under `obs.capture`, writing under
     `tempfile.mkdtemp()` (the free space is checked first: about 15 GB,
     the old checkpoint and the next one's tmp directory): one restart,
     final step 4, one `ckpt.resume` at step 2, a `ckpt.save` span for
     each save on the writer thread, `ckpt.restore` and `ckpt.verify`
     spans, 11 K1 launches a save (encode) and 11 K2 launches a restore
     (decode), read around each; the step-4 checkpoint restored onto the
     card: params, m, v and count equal to the live state bit for bit,
     the record's y equal to K1's sketch of the live EF under
     `key_for(4)`, decode within TOL of K2's plain version on every leaf;
     the bytes on disk against the dense-equivalent, the host-blocking ms
     of each `AsyncCheckpointer.save`, the writer's seconds, verify and
     restore seconds and GB/s, the device ms of each step (one with a save
     in flight); then the reference test's crash-restart on the reduced
     model (30 steps, crash at 17, `ckpt_every=5`, the step run twice from
     one state first for the same bits) within rtol = atol = 1e-6 of the
     uninterrupted run, and a flipped byte in its newest checkpoint: one
     `ckpt.fallback` to the previous verified step.
  15. the cross-pod sketch collective on phase 9's 11 leaf shapes (571
     buckets of `tt:k=1024,rank=8,order=4`), the operator drawn on every
     rank from the compressor's seed. 15a: NCCL at world size 1 (a
     `("pod",)` mesh of one): `compress_collective` under both syncs equal
     to `compress` bit for bit, one all_reduce of 2,338,816 B under
     sketch-mean. 15b: two spawned ranks on the card joined by gloo (CUDA
     tensors; the kernels were built in phase 2): each takes its row of a
     seeded (2, ...) tree, rank 0 runs `compress_per_pod` on the whole
     tree; `compress_collective` under both syncs and both wires: fp32
     within rtol = atol = 2e-5 of `compress_per_pod`, int8 within 0.12
     (relative) of fp32 and the same bits twice, both ranks the same
     bits, the collective ledger's bytes equal to `wire_bytes` (2,338,816
     / 586,988 / 2,381,377,536 / 595,344,428); `project_sharded` and
     `reconstruct_sharded` at w_gate over a `("data",)` mesh of 2 against
     the whole K1/K2 within TOL; the collectives alone (host ms). 15c: the
     pod train step (`build_train_step(mesh=(pod=2))`, one row of the
     global batch 2 a pod, seq 4096): sketch-mean fp32 (a warm-up, 3
     counted), sketch-mean int8 (3), local-mean fp32 (1); every loss
     finite, the params' digest all-gathered and equal after every step;
     device ms a step and its parts (`train.loss_grad`,
     `train.compress`, `train.update`), the collective's host ms, the
     peak memory (two layers when about 64 GB are free, else one). 15d:
     `torch.distributed.run --standalone --nproc-per-node 2 -m
     repro_torch.launch.train --reduced --mesh 2x1x1 --dist-backend gloo
     ... --compress-sync sketch-mean --steps 20`: the last logged loss
     below the first. K1's and K2's launches in these runs go into their
     training rows.
  16. pod-mesh checkpoints at phase 9's widths on two gloo ranks sharing
     the card (the free disk checked first: a dense-EF checkpoint is
     about 11.9 GB). 16a: the pod train loop (`runtime.train_loop.run`
     with `mesh=`, sketch-mean fp32, global batch 2, seq 4096) for 4
     steps uninterrupted, then with dense-EF checkpoints every 2 steps
     (async, rank 0 writes the EF rows gathered into the `(2, ...)`
     layout) and a crash at step 3 on both ranks under
     `run_with_restarts`: params, m, v and both EF rows after the restart
     bit-equal to the uninterrupted run; the gather's host ms and bytes,
     rank 0's save host-blocking ms, the bytes on disk. 16b: one more
     step whose save writes a sketched record of the stacked rows
     (`SketchedTreeCodec.for_pod_rows`, K1 on rank 0); the record
     restored through K2 twice on each rank (the stacked decode: the same
     bits twice and on both ranks) and through `resume_pod_rank`. 16c:
     the 2-pod dense checkpoint restored onto one pod of an NCCL mesh of
     world size 1: the EF equals the fixed-order sum of the two rows bit
     for bit. K1's and K2's launches go into their training rows.
  17. LM serving at full width: llama3.2-3b (28 layers, slots 8, 16
     requests) and then gemma2-9b (42 layers, slots 4, 8 requests; llama
     freed first), random fp32 weights from a seeded generator, prompts
     of 64-128 tokens from a seeded numpy generator, 32 generated tokens
     each, `max_seq` 512: `SlotServer.run` timed (decode ms a step at
     B = slots by CUDA events, the server's prefill ms a prompt token,
     generated tokens/s, peak memory), the model's one-forward prefill
     of the longest prompt; the batched prefill's greedy tokens against a
     token-by-token loop bit for bit (the first `slots` requests cut to
     16 prompt tokens, 8 generated); `decode_step` logits against the
     forward's at fp32 on one 32-token sequence (rtol = atol = 2e-3),
     and the server's own bf16 step's logits on that sequence against
     the same forward (within 3e-2 of the largest |logit|, the greedy
     tokens equal wherever the forward's top two are further apart); the
     server's cache starts empty, and its graphed step equals the eager
     `decode_step` bit for bit.
  18. MoE and M-RoPE serving at their published widths (each model freed
     before the next; random weights from seed 0 at the policy's dtype;
     prompts of 32-64 tokens, shorter than phase 17's because the server
     feeds a prompt one token a step; 32 generated tokens; `max_seq`
     512): mixtral-8x22b cut from 56 layers to 4 (56 are 141e9
     parameters, which one card cannot hold; 4 are 10,418,903,040, 41.7
     GB fp32), 4 slots, 8 requests; arctic-480b cut from 35 layers to 2
     under its 'lean' policy (27,681,131,520 parameters drawn in bf16,
     55.4 GB), 4 slots, 4 requests. Each through phase 17's checks: the
     timed graphed server, graph = eager and batched prefill = token loop
     bit for bit, decode against the forward at fp32 (mixtral; arctic's
     fp32 forward would need a 54 GB fp32 copy of a layer), the server's
     bf16 step against the bf16 forward within 3e-2 of the largest
     |logit|; the checks against the forward on a copy of the config
     whose capacity factor is num_experts / top_k (at the published 1.25
     the forward drops over-capacity tokens and decode never does).
     Then qwen2-vl-2b at full width and depth (28 layers, 1,543,714,304
     fp32 parameters; not through `SlotServer`, which, as the
     reference's, feeds no positions3): `apply_mrope` at (t, t, t) equal
     to `apply_rope`; `build_prefill_step` on 4 sequences of 1024 tokens,
     each with one image of 256 seeded patch embeddings (a 16 x 16 grid
     at token 16; positions3 (t, t, t) for text, (16, 16 + row, 16 +
     col) for the image, text after it from 32 on), finite logits that
     the patches move, ms and tokens/s; `prefill` of 4 text prompts of
     64 tokens and 32 eager `build_serve_step`s with positions3 (ms a
     step, tokens/s, device time and idle share); decode against the
     forward at fp32 over 32 tokens whose positions3 differ across the
     sections (a 4 x 4 image's at token 8). The numbers join the
     `lm_serve` line, one entry an arch.
  19. The SSM, hybrid and encoder-decoder families at full width and
     depth (random fp32 weights, seed 0; bf16 compute): mamba2-1.3b (48
     layers) and recurrentgemma-2b (26) through the graphed `SlotServer`,
     8 slots, 16 requests of 32-64 prompt tokens, 32 greedy tokens each,
     `max_seq` 512: the server's cache right after the capture equals
     `init_cache`; the timed serve (phase 17's numbers); the first and the
     last request (the last in a slot an earlier one used) served alone in
     fresh servers give the full run's tokens at every position whose top
     two logits are further apart than 3e-2 of the largest (the
     comparison stops at a near tie); graph = eager bit for bit; decode
     against the fp32 forward on 2 x 32 tokens (rtol = atol = 2e-3);
     `build_prefill_step` on 4 x 1024 tokens (mamba2 through the chunked
     SSD, chunk 256). Then whisper-medium (24 + 24 layers): `encode` of 4
     x 1500 seeded frame embeddings, `build_cross_cache`, 32 greedy eager
     `build_serve_step`s (ms a step, device time and idle share); decode
     against `decode_hidden` at fp32 on 2 x 32 tokens; `build_prefill_step`
     with frames on 4 x 448 tokens. The numbers join the `lm_serve` line.
Then it prints the `collective` JSON line (phase 15's numbers), the
`pod_ckpt` and `lm_serve` lines (phases 16 to 19), the `kernels`
JSON line, the card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
TOL = 1e-4            # max|kernel - plain| / max|plain|: fp32, other sum order
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SLICE_DIMS = (64, 64, 64)
SLICE_K = 512
SLICE_RANKS = {"tt": 5, "cp": 25}
SMALL_DIMS = {2: (12, 20), 3: (6, 10, 14), 4: (4, 6, 5, 7), 5: (3, 4, 5, 3, 6)}
# the training slice: llama3.2-3b cut to 2 layers, its train_4k sequence,
# batch 2, and README's compressor flag
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_STEPS = 2, 2, 5
TRAIN_COMPRESS = "tt:k=1024,rank=8,order=4"
TRAIN_LR = 3e-4
W_TOL_LR = 1e-3  # max|w'_fused - w'_unfused| in learning rates
SOURCES = {"sweep_project": "src/repro_torch/kernels/csrc/sweep_project.cu",
           "sweep_project_pipelined":
               "src/repro_torch/kernels/csrc/sweep_project.cu",
           "sweep_reconstruct":
               "src/repro_torch/kernels/csrc/sweep_reconstruct.cu",
           "carry_sweep_project":
               "src/repro_torch/kernels/csrc/carry_sweep.cu",
           "carry_sweep_project_pipelined":
               "src/repro_torch/kernels/csrc/carry_sweep.cu",
           "fused_update": "src/repro_torch/kernels/csrc/fused_update.cu"}
REPLACES = {"sweep_project": "src/repro/kernels/_sweep.py:118",
            "sweep_project_pipelined": "src/repro/kernels/_sweep.py:204",
            "sweep_reconstruct": "src/repro/kernels/_sweep.py:236",
            "carry_sweep_project": "src/repro/kernels/struct/carry.py:99",
            "carry_sweep_project_pipelined":
                "src/repro/kernels/struct/carry.py:182",
            "fused_update": "src/repro/kernels/fused_update.py:169"}
SMALL_CARRY_DIMS = {2: (12, 20), 3: (6, 10, 14), 4: (4, 6, 5, 7),
                    5: (3, 4, 5, 3, 6), 6: (3, 2, 4, 3, 2, 3),
                    7: (2, 3, 2, 3, 2, 2, 3), 8: (2,) * 8}
PAIRINGS = (("tt", "tt"), ("tt", "cp"), ("cp", "tt"), ("cp", "cp"))
RAGGED_PROJECT = (((12, 20), 11), ((2, 3, 3, 3, 3, 3, 3, 3), 9),
                  ((5, 7), 25))


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|); raises on non-finite."""
    import torch
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output holds non-finite values")
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def check(name: str, got, ref) -> float:
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    diff, rel = rel_err(got, ref)
    log(f"{name}: max|d|={diff:.3e} max|d|/max|ref|={rel:.3e}")
    if rel > TOL:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {TOL}")
    return diff


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn()` over `reps` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_queued(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn()` over `reps` calls queued behind a
    sleep kernel (CUDA events): the card runs the calls back to back, so a
    small launch is timed without the host's time between launches. The
    sleep grows until it outlasts the host's queueing."""
    import torch
    for _ in range(warmup):
        fn()
    cycles = 10_000_000
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.2 * host_ms:
            return ev[1].elapsed_time(ev[2]) / reps
        if cycles > 1_000_000_000:
            raise AssertionError(f"the host took {host_ms:.1f} ms to queue "
                                 f"{reps} calls, longer than the sleep")
        cycles *= 4


def cuda_ms_each(fn, reps: int) -> list[float]:
    """Device milliseconds of each of `reps` back-to-back calls of `fn()`,
    an event pair around each (after one warm-up call)."""
    import torch
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


SWEEP_KERNELS = (("fold_m_kernel", "fold"), ("project_gemm_kernel", "product"),
                 ("recon_gemm_kernel", "product"),
                 ("reduce_partials_kernel", "reduce"))
CARRY_KERNELS = (("carry_k3", "carry"), ("carry_k6", "carry"))


def device_split(row: dict, fn, reps: int = 3, names=SWEEP_KERNELS,
                 need=("fold", "product")) -> dict[str, float]:
    """Device milliseconds per call of each kernel `fn()` launches, from
    torch.profiler's CUDA activity over `reps` calls, keyed by `names`
    (kernel name part -> key): the fold and the product of K1, K5, K2 and
    K4, K1's and K5's reduce; K3's and K6's one kernel ('carry'); and the
    wrapper's other kernels ('layout': the layout copy of the leading
    core, and K4's array of lr, c1 and c2). `names=None` sums every
    kernel under 'all' (pass `need=("all",)`). Stored in `row` as
    `device_split_ms`, beside `profile_windows`, the windows it took.

    A window whose kernel records the profiler lost is taken again, at
    most twice: one that recorded the calls' `cudaLaunchKernel` but not
    one kernel. On the H100 with torch 2.11 the profiler does that to
    about 0.2% of windows of 3 short calls, to torch's own kernels as to
    the port's, and to fewer with 2 ms of host time at both ends of the
    window, which it therefore has (`tools/profiler_window_probe.py`). A
    window that recorded no launch, or kernels but not the named ones,
    fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for windows in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
        out = {key: 0.0 for key in need}
        for ev in prof.key_averages():
            t = (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))
            if t:
                key = ("all" if names is None else
                       next((k for n, k in names if n in ev.key), "layout"))
                out[key] = out.get(key, 0.0) + t / reps / 1e3
        if any(out.values()):
            break
        launched = {e.name() for e in prof.profiler.kineto_results.events()}
        if "cudaLaunchKernel" not in launched:
            raise AssertionError(f"the profiler recorded no launch in a "
                                 f"window of {reps} calls: {launched}")
        log(f"the profiler lost the kernel records of a window of {reps} "
            f"calls (it recorded their launches); window {windows + 1}")
    if not all(out[key] for key in need):
        raise AssertionError(f"the profiler saw no {need}: {out}")
    row["device_split_ms"] = out
    row["profile_windows"] = windows
    return out


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of `fn()` (the wrapper's checks, plan
    lookups and launch, not waiting for the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def dense_operator_flops(family: str, k: int, dims, rank: int) -> int:
    """Flops to build the dense (k, prod(dims)) operator from its cores,
    left to right: each TT step a product over one bond, each CP step a
    Hadamard product, and the last core's contraction over the bond."""
    total, prefix = 0, dims[0]
    for d in dims[1:-1]:
        prefix *= d
        total += (2 * k * prefix * rank * rank if family == "tt"
                  else k * prefix * rank)
    return total + 2 * k * math.prod(dims) * rank


def route_flops(plan) -> int:
    """Flops of the dense-operator route that K1, K5, K2 and K4 run: the
    fold of the trailing cores (the kernel refolds each column of m, N-2
    steps of R*R multiply-adds for TT, R products for CP), the operator
    tiles S = sum_u g1 m built once per batch tile (grid axis 1 of the
    plan, both kinds), and the (B, D) x (D, k) product or its adjoint."""
    k, b, dims, r = plan.k, plan.b, plan.dims, plan.rank
    d_all, trail = math.prod(dims), math.prod(dims[1:])
    step = 2 * r * r if plan.family == "tt" else r
    fold = k * trail * step * (len(dims) - 2)
    return fold + 2 * k * d_all * r * plan.grid[1] + 2 * b * k * d_all


def graft_flops(plan) -> int:
    """Flops of the reference's reconstruct program: the fold, the graft
    h = y g1 and the (B*d1, k*R) x (k*R, d2..dN) product."""
    k, b, dims, r = plan.k, plan.b, plan.dims, plan.rank
    trail = math.prod(dims[1:])
    step = 2 * r * r if plan.family == "tt" else r
    fold = k * trail * step * (len(dims) - 2)
    return 2 * b * dims[0] * k * r * trail + fold + b * dims[0] * k * r


def scratch_bytes(plan) -> int:
    """Bytes of the kernels' scratch buffers: m, and for K1 and K5 the
    partials."""
    n = math.prod(plan.m_scratch_shape)
    if plan.kind == "project":
        n += math.prod(plan.partial_shape)
    return 4 * n


def kernel_operands(op, family):
    from repro_torch.kernels import ops
    cores = ops.tt_cores_squeezed(op) if family == "tt" else op.factors
    return tuple(c.contiguous() for c in cores)


def struct_operands(op, op_family, xb, in_family):
    """(operator cores, then the batched input's cores) in the carry
    kernels' layouts, and the count of operator cores."""
    from repro_torch.kernels.struct.ops import _in_operands
    opc = kernel_operands(op, op_family)
    inc = tuple(c.contiguous() for c in _in_operands(in_family, xb))
    return opc + inc, len(opc)


def densify_flops(in_family: str, dims, r_in: int) -> int:
    """Flops to densify one TT/CP input, left to right (TT: each step a
    product over one bond; CP: each step a Hadamard product, then the sum
    over the rank)."""
    total, prefix = 0, dims[0]
    for n, d in enumerate(dims[1:], start=1):
        last = n == len(dims) - 1
        if in_family == "tt":
            total += 2 * prefix * r_in * d * (1 if last else r_in)
        else:
            total += prefix * d * r_in
        prefix *= d
    return total + (prefix * r_in if in_family == "cp" else 0)


def carry_flops(op_family: str, in_family: str, cores, n_op: int) -> int:
    """Flops of the carry program on these operands, step by step with
    their true bonds (the TT boundary bonds are 1)."""
    from repro_torch.kernels.struct import plan as splan
    program = splan._carry_program(op_family, in_family, n_op)
    return splan.carry_program_flops(program,
                                     [c.shape for c in cores[:n_op]],
                                     [c.shape for c in cores[n_op:]])


def struct_einsum_spec(op_family: str, in_family: str, order: int) -> str:
    """One einsum over all operands of a structured projection, operator
    core n then input core n for each mode (so a left-to-right contraction
    is the carry program, not the dense operator)."""
    modes, op_bonds, in_bonds = "abcdefgh", "ijlmopq", "ABCDEFG"

    def terms(family, lead, bonds, rank):
        if family == "cp":
            return [f"{lead}{m}{rank}" for m in modes[:order]]
        return ([f"{lead}{modes[0]}{bonds[0]}"]
                + [f"{lead}{bonds[n - 1]}{modes[n]}{bonds[n]}"
                   for n in range(1, order - 1)]
                + [f"{lead}{bonds[order - 2]}{modes[order - 1]}"])

    ops_ = terms(op_family, "k", op_bonds, "r")
    ins = terms(in_family, "n", in_bonds, "s")
    return ",".join(t for pair in zip(ops_, ins) for t in pair) + "->nk"


def fused_flops(plan):
    """(program, cheaper) flops of K4 under its plan: the kernel's route
    (`route_flops`: the fold, the operator tiles once per batch tile, the
    product) or the dense (k, prod(dims)) operator built left to right and
    one product, each plus the epilogue's 18 operations an element."""
    d_all = math.prod(plan.dims)
    cheaper = (dense_operator_flops(plan.family, plan.k, plan.dims,
                                    plan.rank) + 2 * plan.b * plan.k * d_all)
    epilogue = 18 * plan.b * d_all
    return route_flops(plan) + epilogue, cheaper + epilogue


def train_slice(dev):
    """Phase 9's training slice: llama3.2-3b at its published widths cut
    to TRAIN_LAYERS layers, its train_4k sequence, TRAIN_BATCH, the
    TRAIN_COMPRESS compressor, the fused step and a fresh train state.
    Returns (model, cfg, shape, comp, opt, step_fn, state, data)."""
    import dataclasses
    import functools

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, schedule
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)

    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=TRAIN_LAYERS)
    model = build_model(cfg)
    shape = ShapeSpec("train_4k", cfg.shape("train_4k").seq_len,
                      TRAIN_BATCH, "train")
    comp = SketchCompressor(parse_compress_flag(TRAIN_COMPRESS))
    opt = adamw.AdamWConfig(clip_norm=None)
    lr_fn = functools.partial(schedule.constant, peak_lr=TRAIN_LR)
    step_fn = steps.build_train_step(model, shape, compressor=comp,
                                     opt=opt, lr_fn=lr_fn, fused_update=True,
                                     device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), opt=opt,
        compressor=comp)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                  global_batch=shape.global_batch, seed=0))
    return model, cfg, shape, comp, opt, step_fn, state, data


def train_phases(dev, gen, errs, per_family, launches, time_row):
    """Phases 8-11: K4 against its plain version, the sketch-compressed
    training slice at full width, the fused update against the unfused
    chain, and the reduced learning run. Returns the K4 and K1 (training
    shape) rows of the `kernels` line, and K5's numbers at the training
    shape as `train_*` keys for its TT row."""
    import dataclasses
    import functools

    import torch
    from repro_torch import kernels, rp
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import theory
    from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                       tree_unflatten)
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _sweep, ops
    from repro_torch.kernels import fused_update as kfused
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, schedule
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.runtime import spans

    hp = dict(alpha=0.9, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

    # -- 8. K4 vs its plain version ---------------------------------------
    def hold_k4(family, dims, k, rank, nb, tag):
        op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank),
                               seed=5, device=dev)
        y = torch.randn((nb, k), generator=gen, device=dev)
        p, w, m, v = (torch.randn((nb,) + dims, generator=gen, device=dev)
                      for _ in range(4))
        v = v.abs()
        scal = (1e-3, 0.1, 0.05)
        got = kfused.fused_update_buckets(op, y, p, w, m, v, *scal, **hp)
        ref = kfused.fused_update_buckets_plain(op, y, p, w, m, v, *scal,
                                                **hp)
        again = kfused.fused_update_buckets(op, y, p, w, m, v, *scal, **hp)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K4 {family} {tag}: a second call on the "
                                 "same inputs gave other bits")
        worst = 0.0
        for name, a, b in zip(("resid", "w'", "m'", "v'"), got, ref):
            worst = max(worst, check(f"K4 {family} {tag} dims={dims} k={k} "
                                     f"R={rank} B={nb} {name}", a, b))
        if family == "tt":
            errs["fused_update:tt"] = max(errs.get("fused_update:tt", 0.0),
                                          worst)
        torch.cuda.synchronize()

    for family in ("tt", "cp"):
        for order, dims in SMALL_DIMS.items():
            hold_k4(family, dims, 37, 3, 3, f"order {order}")
        # ragged against every tile: d1 against the slab, T against the
        # chunk (and not a multiple of 4), k against the depth chunk, B
        # across two batch tiles, ranks above 8
        for dims, rank in RAGGED_PROJECT:
            hold_k4(family, dims, 37, rank, 130, "ragged")
    hold_k4("tt", (16, 16, 8), 128, 2, 3, "reference test shape")
    log("K4 gave the same bits on every second call")

    # -- 9. the training slice at full width, 2 layers --------------------
    t0 = time.perf_counter()
    model, cfg, shape, comp, opt, step_fn, state, data = train_slice(dev)
    batches = [data.batch(i) for i in range(TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    sk = comp._sketcher(state["params"])
    log(f"train llama3.2-3b x{TRAIN_LAYERS} layers: {n_params} params, "
        f"seq {shape.seq_len}, batch {shape.global_batch}, "
        f"{TRAIN_COMPRESS} (dims {comp.cfg.dims}, shrinkage "
        f"{comp.cfg.shrinkage():.4g}): {sk.n_buckets} buckets in "
        f"{len(sk._nb)} leaves {sk._nb}; set-up "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    state, met = step_fn(state, batches[0])          # warm-up step
    torch.cuda.synchronize()
    log(f"train warm-up step: loss {float(met['loss']):.4f}, "
        f"{time.perf_counter() - t0:.2f}s host")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    with spans.record(lambda: torch.cuda.Event(enable_timing=True)) as marks:
        for i in range(1, TRAIN_STEPS + 1):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            state, met = step_fn(state, batches[i])
            e_ev.record()
            losses.append(met["loss"])
            events.append((s_ev, e_ev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (kfused.fused_update_buckets.launches,
              _sweep.sweep_project.launches,
              _sweep.sweep_reconstruct.launches)
    losses = [float(x) for x in losses]
    n_leaves = len(sk._nb)
    if counts != (n_leaves * TRAIN_STEPS, n_leaves * TRAIN_STEPS, 0):
        raise AssertionError(
            f"train: (K4, K1, K2) launches {counts} over {TRAIN_STEPS} "
            f"steps, expected {n_leaves} K4 and {n_leaves} K1 launches a "
            "step and no K2")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss in {losses}")
    step_ms = [s_ev.elapsed_time(e_ev) for s_ev, e_ev in events]
    per_family["fused_update:tt"] = counts[0]
    per_family["sweep_project:train"] = counts[1]
    launches["fused_update"] += counts[0]
    launches["sweep_project"] += counts[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {TRAIN_STEPS} fused steps: losses "
        f"{[round(x, 4) for x in losses]}, device ms/step "
        f"{[round(x, 1) for x in step_ms]}, wall {wall:.2f}s, K4 launches "
        f"{counts[0]} = K1 launches {counts[1]} = {n_leaves} leaves x "
        f"{TRAIN_STEPS} steps, K2 launches {counts[2]}; peak memory "
        f"{peak:.1f} GiB")
    # the split of each counted step, from the spans it recorded
    parts = ("train.loss_grad", "train.sketch", "train.fused_update")
    recorded = [name for name, _, _ in marks]
    if recorded != list(parts) * TRAIN_STEPS:
        raise AssertionError(f"train: spans {recorded}, expected {parts} a "
                             "step")
    split = {name: [] for name in parts}
    for name, s_ev, e_ev in marks:
        split[name].append(s_ev.elapsed_time(e_ev))
    split["rest"] = [t - sum(split[name][i] for name in parts)
                     for i, t in enumerate(step_ms)]
    median = {name: statistics.median(v) for name, v in split.items()}
    log("train step split, device ms inside the counted steps (median; "
        "per step): " + "; ".join(
            f"{name} {median[name]:.1f} ({', '.join(f'{x:.1f}' for x in v)})"
            for name, v in split.items())
        + f"; the step {statistics.median(step_ms):.1f}. loss_grad: forward "
        f"and backward; sketch: {n_leaves} K1 launches with the bucket "
        f"copies of padded leaves; fused_update: {n_leaves} K4 launches "
        "with the bucket copies in and out; rest: p = g + e, operator "
        "sampling, glue")
    train_log = {"losses": losses, "step_ms": step_ms, "split_ms": split,
                 "split_median_ms": median, "peak_gib": peak}

    # -- 10. one gradient at the mid-trajectory state ---------------------
    params, ef, ostate = state["params"], state["ef"], state["opt"]
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in batches[TRAIN_STEPS + 1].items()}
    leaves, treedef = tree_flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss = model.loss_fn(tree_unflatten(treedef, live), batch)
    grads = tree_unflatten(treedef, list(torch.autograd.grad(loss, live)))
    del live, loss
    seed = comp._key(ostate["count"])
    p_fed = tree_map(lambda g, e: g.float() + e, grads, ef["residual"])
    y = sk.sketch(p_fed, seed)
    op = comp.cfg.operator(seed, dev)
    count = ostate["count"] + 1
    c1 = 1.0 - opt.b1 ** count.to(torch.float32)
    c2 = 1.0 - opt.b2 ** count.to(torch.float32)
    alpha = comp.cfg.shrinkage()
    khp = dict(alpha=alpha, b1=opt.b1, b2=opt.b2, eps=opt.eps,
               weight_decay=opt.weight_decay)
    leaves_in = [tree_leaves(t) for t in (p_fed, params, ostate["m"],
                                          ostate["v"])]
    buckets = [[sk._leaf_to_buckets(t[j], nb) for t in leaves_in]
               for j, nb in enumerate(sk._nb)]
    offs = [sum(sk._nb[:j]) for j in range(n_leaves)]
    cores = kernel_operands(op, "tt")
    scale = 1.0 / math.sqrt(op.k)

    def hold_chunked(what, got, plain, nb, chunk):
        """Hold the kernel's outputs `got` over nb buckets, named `what`,
        against the plain version's over chunks of them (`plain(i, j)`:
        buckets i:j), each output by its max|d| over its max|ref|; returns
        the worst max|d|."""
        diff, top = [0.0] * len(got), [0.0] * len(got)
        for i in range(0, nb, chunk):
            for q, (a, b) in enumerate(zip(got, plain(i, i + chunk))):
                diff[q] = max(diff[q], rel_err(a[i:i + chunk], b)[0])
                top[q] = max(top[q], float(b.abs().max()))
        for name, d, t in zip(what, diff, top):
            log(f"{name}: max|d|={d:.3e} max|d|/max|ref|="
                f"{d / max(t, 1e-30):.3e}")
            if d / max(t, 1e-30) > TOL:
                raise AssertionError(f"{name}: relative error "
                                     f"{d / max(t, 1e-30):.3e} > {TOL}")
        return max(diff)

    # K4 and K1 against their plain versions on every leaf, each kernel
    # launched on the whole leaf as the step launches it
    names = ["/".join(key) for key in _leaf_names(params)]
    errs["sweep_project:train"] = 0.0
    for j, nb in enumerate(sk._nb):
        o, bj = offs[j], buckets[j]
        yj = y[o:o + nb]
        tag = f"{names[j]} B={nb} mid-trajectory"
        got = kfused.fused_update_buckets(op, yj, *bj, TRAIN_LR, c1, c2,
                                          **khp)
        errs["fused_update:tt"] = max(errs["fused_update:tt"], hold_chunked(
            [f"K4 {tag} {n}" for n in ("resid", "w'", "m'", "v'")],
            got, lambda i, e: kfused.fused_update_buckets_plain(
                op, yj[i:e], *(b[i:e] for b in bj), TRAIN_LR, c1, c2,
                **khp), nb, 48))
        del got
        pplan = ops.plan_contraction("tt", "project", op.k, nb, op.in_dims,
                                     op.rank)
        got = _sweep.sweep_project(bj[0], *cores, plan=pplan, scale=scale)
        errs["sweep_project:train"] = max(
            errs["sweep_project:train"], hold_chunked(
                [f"K1 {tag} (plain in chunks of 4)"], (got,),
                lambda i, e: (_sweep.sweep_project_plain(
                    bj[0][i:e], *cores, steps=pplan.steps, scale=scale),),
                nb, 4))
        check(f"K1 {tag} == the sketch rows of the step", got, yj)
        p5 = ops.plan_contraction("tt", "project", op.k, nb, op.in_dims,
                                  op.rank, pipeline="double")
        got5 = _sweep.sweep_project_pipelined(bj[0], *cores, plan=p5,
                                              scale=scale)
        errs["sweep_project_pipelined:train"] = max(
            errs.get("sweep_project_pipelined:train", 0.0), hold_chunked(
                [f"K5 {tag} (plain in chunks of 4)"], (got5,),
                lambda i, e: (_sweep.sweep_project_pipelined_plain(
                    bj[0][i:e], *cores, steps=p5.steps, ba=p5.ba,
                    scale=scale),), nb, 4))
        check(f"K5 vs K1 {tag}", got5, got)
        del got, got5
        torch.cuda.empty_cache()

    # the fused update against the unfused chain, same state and gradient
    new_p, new_o, new_ef, _ = adamw.update_sketched(
        params, grads, ef, ostate, TRAIN_LR, opt, compressor=comp)
    g_hat, ef_u, _ = comp.compress(grads, ef, step=ostate["count"])
    p_u, o_u, _ = adamw.update(params, g_hat, ostate, TRAIN_LR, opt)
    del g_hat
    worst = {"resid": 0.0, "m'": 0.0, "v'": 0.0}
    for key, a_t, b_t in (("resid", new_ef["residual"], ef_u["residual"]),
                          ("m'", new_o["m"], o_u["m"]),
                          ("v'", new_o["v"], o_u["v"])):
        for a, b in zip(tree_leaves(a_t), tree_leaves(b_t)):
            worst[key] = max(worst[key], rel_err(a, b)[1])
    w_lr = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(new_p), tree_leaves(p_u))) / TRAIN_LR
    log(f"fused vs unfused update at step {int(ostate['count'])}: "
        "max|d|/max|ref| per leaf: " + ", ".join(
            f"{key} {val:.3e}" for key, val in worst.items())
        + f"; max|w'_f - w'_u| = {w_lr:.3e} lr")
    if max(worst.values()) > TOL or w_lr > W_TOL_LR:
        raise AssertionError(f"fused update differs from the unfused "
                             f"chain: {worst}, w' {w_lr:.3e} lr")
    del new_p, new_o, new_ef, ef_u, p_u, o_u, p_fed, state
    torch.cuda.empty_cache()

    # times at layers/w_gate: K4 beside its bound, its plain version and
    # the unfused library chain; K1 beside its own
    j = names.index("layers/w_gate")
    nb, bj = sk._nb[j], buckets[j]
    yj, x = y[offs[j]:offs[j] + nb], bj[0]
    pplan = ops.plan_contraction("tt", "project", op.k, nb, op.in_dims,
                                 op.rank)
    chunk = 4

    def k1_plain():
        return torch.cat([_sweep.sweep_project_plain(
            x[i:i + chunk], *cores, steps=pplan.steps, scale=scale)
            for i in range(0, nb, chunk)])

    dims, k, rank = op.in_dims, op.k, op.rank
    d_all = math.prod(dims)
    core_bytes = 4 * sum(c.numel() for c in cores)
    letters = "abcd"
    lib_cores = "kau,kubv,kvcw,kwd"
    shape_s = (f"layers/w_gate B={nb} k={k} dims={'x'.join(map(str, dims))} "
               f"TT(R={rank})")
    fplan = kfused.plan_fused_update("tt", k, nb, dims, rank)
    program, cheaper = fused_flops(fplan)
    scale_a = alpha / math.sqrt(k)

    def dense_route(spec, *operands):
        """One torch.einsum contracted left to right: the cores first (the
        dense (k, prod(dims)) operator), then the batch; opt_einsum's
        reordering could pick a 51 GB intermediate at this shape."""
        with torch.backends.opt_einsum.flags(enabled=False):
            return torch.einsum(spec, *operands)

    def unfused_chain():
        g = dense_route(f"{lib_cores},nk->n{letters}", *cores, yj) * scale_a
        m32 = opt.b1 * bj[2] + (1.0 - opt.b1) * g
        v32 = opt.b2 * bj[3] + (1.0 - opt.b2) * g * g
        stp = (m32 / c1) / (torch.sqrt(v32 / c2) + opt.eps)
        return (bj[0] - g, bj[1] - TRAIN_LR * (stp + opt.weight_decay
                                               * bj[1]), m32, v32)

    rows = []
    row = time_row(
        "fused_update:tt", program, cheaper,
        4 * (nb * k + 8 * nb * d_all) + core_bytes,
        lambda: kfused.fused_update_buckets(op, yj, *bj, TRAIN_LR, c1, c2,
                                            **khp),
        lambda: kfused.fused_update_buckets_plain(op, yj, *bj, TRAIN_LR, c1,
                                                  c2, **khp),
        unfused_chain, shape_s, reps=10)
    row["library_call"] = ("unfused chain: one torch.einsum of the whole "
                           "reconstruct, then the epilogue in torch ops")
    row["train"] = train_log
    row["scratch_bytes"] = scratch_bytes(fplan)
    row["sweep_program_flops"] = graft_flops(fplan) + 18 * nb * d_all

    def k4():
        return kfused.fused_update_buckets(op, yj, *bj, TRAIN_LR, c1, c2,
                                           **khp)

    device_split(row, k4)
    log("fused_update:tt device ms per call by kernel: " + ", ".join(
        f"{key} {v:.3f}" for key, v in row["device_split_ms"].items()))
    if not all(torch.equal(a, b) for a, b in zip(k4(), k4())):
        raise AssertionError("K4 at layers/w_gate: a second call on the "
                             "same inputs gave other bits")
    rows.append(row)
    p5plan = ops.plan_contraction("tt", "project", op.k, nb, op.in_dims,
                                  op.rank, pipeline="double")

    def k5_plain():
        return torch.cat([_sweep.sweep_project_pipelined_plain(
            x[i:i + chunk], *cores, steps=p5plan.steps, ba=p5plan.ba,
            scale=scale) for i in range(0, nb, chunk)])

    dense = dense_operator_flops("tt", k, dims, rank) + 2 * nb * k * d_all
    nbytes = 4 * (nb * d_all + nb * k) + core_bytes
    lib = lambda: dense_route(f"{lib_cores},n{letters}->nk", *cores, x)  # noqa: E731
    row = time_row(
        "sweep_project:train", route_flops(pplan), dense, nbytes,
        lambda: _sweep.sweep_project(x, *cores, plan=pplan, scale=scale),
        k1_plain, lib, shape_s + f" (plain in chunks of {chunk} buckets)",
        reps=10)
    row["scratch_bytes"] = scratch_bytes(pplan)
    row["sweep_program_flops"] = (theory.flops_project_dense_tt(k, dims, rank)
                                  * nb)
    device_split(
        row, lambda: _sweep.sweep_project(x, *cores, plan=pplan, scale=scale))
    log("sweep_project:train device ms per call by kernel: " + ", ".join(
        f"{key} {v:.3f}" for key, v in row["device_split_ms"].items()))
    rows.append(row)
    # K5 at the same leaf: its numbers go into its TT row as train_*
    k5 = time_row(
        "sweep_project_pipelined:train", route_flops(p5plan), dense,
        nbytes, lambda: _sweep.sweep_project_pipelined(
            x, *cores, plan=p5plan, scale=scale),
        k5_plain, lib, shape_s + f" (plain in chunks of {chunk} buckets)",
        reps=10)
    k5["scratch_bytes"] = scratch_bytes(p5plan)
    device_split(k5, lambda: _sweep.sweep_project_pipelined(
        x, *cores, plan=p5plan, scale=scale))
    k5_row = {f"train_{key}": k5[key] for key in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "program_bound_ms", "flops", "program_flops", "max_abs_err",
        "scratch_bytes", "device_split_ms", "profile_windows")}
    # K2 at the same leaf (K1's adjoint, the same flops and bytes): what
    # the sketched checkpoint codec launches a leaf on restore (phase 14)
    rplan = ops.plan_contraction("tt", "reconstruct", op.k, nb, op.in_dims,
                                 op.rank)

    def k2():
        return _sweep.sweep_reconstruct(yj, *cores, plan=rplan, scale=scale)

    def k2_chunk(i, e):
        return _sweep.sweep_reconstruct_plain(yj[i:e], *cores,
                                              steps=rplan.steps, scale=scale)

    got = k2()
    errs["sweep_reconstruct:train"] = hold_chunked(
        [f"K2 {shape_s} (plain in chunks of {chunk})"], (got,),
        lambda i, e: (k2_chunk(i, e),), nb, chunk)
    if not torch.equal(got, k2()):
        raise AssertionError("K2 at layers/w_gate: a second call on the "
                             "same inputs gave other bits")
    del got
    row = time_row(
        "sweep_reconstruct:train", route_flops(rplan), dense, nbytes, k2,
        lambda: torch.cat([k2_chunk(i, i + chunk)
                           for i in range(0, nb, chunk)]),
        lambda: dense_route(f"{lib_cores},nk->n{letters}", *cores, yj),
        shape_s + f" (plain in chunks of {chunk} buckets)", reps=10)
    row["scratch_bytes"] = scratch_bytes(rplan)
    row["sweep_program_flops"] = graft_flops(rplan)
    device_split(row, k2)
    row["same_bits_twice"] = True
    log("sweep_reconstruct:train device ms per call by kernel: " + ", ".join(
        f"{key} {v:.3f}" for key, v in row["device_split_ms"].items())
        + "; the same bits twice")
    rows.append(row)
    del buckets, bj, x, y, yj, params, grads, ef, ostate
    torch.cuda.empty_cache()

    # -- 11. the reference test's learning run ----------------------------
    rcfg = reduced(get_config("llama3.2-3b"))
    rmodel = build_model(rcfg)
    rcomp = SketchCompressor(parse_compress_flag(
        "tt:k=1024,rank=8,dims=4x8x16"))
    rstep = steps.build_train_step(
        rmodel, ShapeSpec("t", 32, 4, "train"), compressor=rcomp, opt=opt,
        lr_fn=functools.partial(schedule.constant, peak_lr=3e-3),
        fused_update=True, device=dev)
    rstate = steps.init_train_state(
        rmodel, torch.Generator(device=dev).manual_seed(0), opt=opt,
        compressor=rcomp)
    rdata = SyntheticLM(DataConfig(vocab=rcfg.vocab, seq_len=32,
                                   global_batch=4))
    rlosses = []
    for i in range(8):
        rstate, rmet = rstep(rstate, rdata.batch(i))
        rlosses.append(float(rmet["loss"]))
    log(f"reduced llama3.2-3b, {rcomp.cfg.family}:k={rcomp.cfg.k},rank="
        f"{rcomp.cfg.rank},dims=4x8x16, lr 3e-3, 8 fused steps: losses "
        f"{[round(x, 3) for x in rlosses]}")
    if not rlosses[-1] < rlosses[0]:
        raise AssertionError(f"reduced run did not learn: {rlosses}")
    return rows, k5_row


# the paper's Fig. 1 (benchmarks/distortion.py): three cases of unit-norm
# rank-10 TT inputs, k in FIG1_KS, TT/CP ranks, Gaussian at the small case
# and very-sparse at the medium case (k <= 256), operator seeds 1000+t
FIG1_CASES = {"small": (15, 3), "medium": (3, 12), "high": (3, 25)}
FIG1_KS = (16, 64, 256, 1024)
FIG1_TT_RANKS = (2, 5, 10)
FIG1_CP_RANKS = (4, 25, 100)
FIG1_TRIALS = 20
FIG1_BATCH = 64
# phase 13's distortion target: required_k("tt", 3, rank=5) = 391 <= 512
OBS_EPS, OBS_DELTA = 0.5, 0.05


def fig1_maps(case: str, k: int) -> list[tuple[str, int]]:
    """(family, rank) of every map Fig. 1 runs in `case` at `k`."""
    out = ([("tt", r) for r in FIG1_TT_RANKS]
           + [("cp", r) for r in FIG1_CP_RANKS])
    if case == "small":
        out.append(("gaussian", 1))
    if case == "medium" and k <= 256:
        out.append(("sparse", 1))
    return out


def fig1_key(family: str, rank: int, k: int) -> str:
    """The `kernels` row of K3 at one of Fig. 1's small-case shapes."""
    return f"carry_sweep_project:fig1:{family}{rank}xtt:k{k}"


def map_name(family: str, rank: int) -> str:
    return {"gaussian": "Gaussian", "sparse": "VerySparse"}.get(
        family, f"{family.upper()}({rank})")


def fig1_phase(dev, errs, per_family, launches, time_row):
    """Phase 12: the paper's Fig. 1 on the card through `rp.project` with
    the default backend; its checks, K3 at every small-case shape against
    its plain version, the streamed Gaussian against its matrix, and a
    B=64 batch timed per map. Returns the K3 rows of the `kernels` line,
    one a shape K3 ran at (B=1, rank-10 TT input)."""
    import torch
    from repro_torch import kernels, rp
    from repro_torch.core import BatchedTTTensor, random_tt, theory
    from repro_torch.kernels import _sweep
    from repro_torch.kernels.struct import carry
    from repro_torch.kernels.struct import plan as splan

    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {case: random_tt(gen, (d,) * n, 10, norm="unit")
              for case, (d, n) in FIG1_CASES.items()}
    single = BatchedTTTensor.stack([inputs["small"]])

    def k3_plain(op, family):
        """K3's plain version on the small case's input, as `rp.project`
        launches K3 on it (B=1, input rank 10)."""
        cores, n_op = struct_operands(op, family, single, "tt")
        plan = splan.plan_carry_sweep(family, "tt", op.k, 1, op.in_dims,
                                      op.rank, 10)
        return carry.carry_sweep_project_plain(
            *cores, n_op=n_op, program=plan.program,
            scale=1.0 / math.sqrt(op.k))[0]

    table, held = [], {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with rp.dispatch_stats() as st:
        for case, (d, n) in FIG1_CASES.items():
            dims, x = (d,) * n, inputs[case]
            for k in FIG1_KS:
                for family, rank in fig1_maps(case, k):
                    spec = rp.ProjectorSpec(family, k, dims, rank)
                    ys, refs = [], []
                    for t in range(FIG1_TRIALS):
                        op = rp.make_projector(spec, 1000 + t, device=dev)
                        ys.append(rp.project(op, x))
                        if case == "small" and family in ("tt", "cp"):
                            refs.append(k3_plain(op, family))
                    ys = torch.stack(ys)
                    if refs:
                        held[(family, rank, k)] = (ys, torch.stack(refs))
                    dist = (ys.double().square().sum(-1) - 1.0).abs().cpu()
                    table.append(dict(
                        case=case, map=map_name(family, rank),
                        family=family, rank=rank, k=k,
                        mean=float(dist.mean()),
                        std=float(dist.std(correction=0)),
                        params=theory.params_rp(family, k, dims, rank)))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = _sweep.sweep_project.launches
    k3 = carry.carry_sweep_project.launches
    n_small = len(FIG1_KS) * (len(FIG1_TT_RANKS) + len(FIG1_CP_RANKS)) \
        * FIG1_TRIALS
    if k3 != n_small or st.kernel_calls != n_small or k1 != 0:
        raise AssertionError(
            f"fig1: K3 launches {k3}, K1 launches {k1}, kernel_call_count "
            f"{st.kernel_calls}; expected {n_small} K3 launches, the small "
            "case's TT/CP projections")
    bd = st.breakdown_table()
    calls = {(r["family"], r["structure"], r["route"], r["order"]):
             r["calls"] for r in bd}
    per_op = len(FIG1_KS) * len(FIG1_TT_RANKS) * FIG1_TRIALS
    want = {}
    for family in ("tt", "cp"):
        for case, (_, n) in FIG1_CASES.items():
            route = "kernel" if case == "small" else "torch"
            want[(family, "tt", route, n)] = per_op
    want[("gaussian", "dense", "torch", 1)] = len(FIG1_KS) * FIG1_TRIALS
    want[("sparse", "dense", "torch", 1)] = FIG1_TRIALS * sum(
        k <= 256 for k in FIG1_KS)
    if calls != want:
        raise AssertionError(f"fig1: dispatch breakdown {bd}, expected "
                             f"{want}")
    log(f"fig1: {len(table)} rows, {sum(want.values())} projections in "
        f"{wall:.1f}s (K3's plain versions included); K3 launches {k3} == "
        f"kernel_call_count {st.kernel_calls} == the small case's TT/CP "
        f"projections; breakdown {bd}")
    # every shape K3 ran at: its 20 sketches against its plain version's
    small_d, small_n = FIG1_CASES["small"]
    for (family, rank, k), (ys, refs) in held.items():
        key = fig1_key(family, rank, k)
        errs[key] = check(
            f"K3 fig1 {map_name(family, rank)} x TT rank 10 dims="
            f"{small_d}^{small_n} k={k} B=1, {FIG1_TRIALS} operators", ys,
            refs)
        per_family[key] = FIG1_TRIALS
    # every row's mean distortion against 3 sqrt(c / k): E|Z| <= sqrt(Var)
    # (Jensen) and Var <= c / k (Thm 1; 2/k for Gaussian; very-sparse's
    # worst case, and its exact value on this input)
    x4 = float(inputs["medium"].full().double().pow(4).sum())
    for row in table:
        d, n = FIG1_CASES[row["case"]]
        big_d = d ** n
        c = theory.variance_factor(row["family"], N=n, R=row["rank"],
                                   D=big_d)
        limit = 3.0 * math.sqrt(c / row["k"])
        row["limit"] = limit
        extra = ""
        if row["family"] == "sparse":
            s = math.sqrt(big_d)
            c_x = 2.0 + (s - 3.0) * x4
            row["limit_exact"] = 3.0 * math.sqrt(c_x / row["k"])
            limit = min(limit, row["limit_exact"])
            extra = (f", exact on this input {row['limit_exact']:.4f} "
                     f"(c = 2 + (s-3) sum x^4 = {c_x:.3f})")
        log(f"fig1 {row['case']} {row['map']} k={row['k']}: mean "
            f"{row['mean']:.4f} std {row['std']:.4f}, params "
            f"{row['params']}; limit 3 sqrt(c/k) = {row['limit']:.4f} "
            f"(c = {c:.4g}){extra}")
        if not row["mean"] <= limit:
            raise AssertionError(f"fig1: {row} above its limit {limit}")
    launches["carry_sweep_project"] += k3

    # K3 at the small case's k=1024: the Fig. 1 input (B=1, as the
    # projections above launch it) and a B=64 batch of unit-norm rank-10
    # TT inputs, TT(10) and CP(100), twice each for the same bits
    dims, k = (small_d,) * small_n, FIG1_KS[-1]
    scale = 1.0 / math.sqrt(k)
    batch = BatchedTTTensor.stack([random_tt(gen, dims, 10, norm="unit")
                                   for _ in range(FIG1_BATCH)])
    ops_ = {family: rp.make_projector(rp.ProjectorSpec(family, k, dims, r),
                                      1000, device=dev)
            for family, r in (("tt", FIG1_TT_RANKS[-1]),
                              ("cp", FIG1_CP_RANKS[-1]))}
    for of, op in ops_.items():
        key = fig1_key(of, op.rank, k)
        for xb in (single, batch):
            cores, n_op = struct_operands(op, of, xb, "tt")
            plan = splan.plan_carry_sweep(of, "tt", k, xb.batch, dims,
                                          op.rank, 10)
            got = carry.carry_sweep_project(*cores, n_op=n_op, plan=plan,
                                            scale=scale)
            ref = carry.carry_sweep_project_plain(
                *cores, n_op=n_op, program=plan.program, scale=scale)
            errs[key] = max(errs[key], check(
                f"K3 fig1 {of.upper()}({op.rank}) x TT rank 10 dims={dims} "
                f"k={k} B={xb.batch}", got, ref))
            if not torch.equal(got, carry.carry_sweep_project(
                    *cores, n_op=n_op, plan=plan, scale=scale)):
                raise AssertionError(f"K3 fig1 {of} B={xb.batch}: a second "
                                     "call on the same inputs gave other "
                                     "bits")
    # the streamed Gaussian against its materialized matrix at D = 3375
    gop = rp.make_projector(rp.ProjectorSpec("gaussian", k, dims), 1000,
                            device=dev)
    a = gop.materialize()
    xd = batch.full().reshape(FIG1_BATCH, -1)
    y = rp.project(gop, xd)
    check(f"Gaussian streamed project vs materialize() @ x, D={xd.shape[1]}"
          f" k={k} B={FIG1_BATCH}", y, xd @ a.T)
    check(f"Gaussian streamed reconstruct vs materialize().T @ y, "
          f"D={xd.shape[1]} k={k}", rp.reconstruct(gop, y), y @ a)
    del a, xd, y

    # a B=64 batch of small-case inputs a map at k=1024 through rp.project
    fig1_ms = {}
    for family, rank in fig1_maps("small", k):
        op = (ops_[family] if family in ops_ and rank == ops_[family].rank
              else rp.make_projector(rp.ProjectorSpec(family, k, dims, rank),
                                     1000, device=dev))
        fig1_ms[map_name(family, rank)] = cuda_ms(
            lambda: rp.project(op, batch), reps=10)
    log(f"fig1 small case, B={FIG1_BATCH} k={k}, device ms per rp.project "
        "call (CUDA events): " + ", ".join(f"{name} {ms:.4f}"
                                           for name, ms in fig1_ms.items()))

    def k3_row(of, op, xb, key, timer, shape):
        """`time_row` of K3 for operator `op` on the rank-10 TT batch `xb`;
        also the plan's tiles, and the call timed."""
        b, kk = xb.batch, op.k
        cores, n_op = struct_operands(op, of, xb, "tt")
        plan = splan.plan_carry_sweep(of, "tt", kk, b, dims, op.rank, 10)
        inter = [t for pair in zip(cores[:n_op], cores[n_op:])
                 for t in pair]
        spec = struct_einsum_spec(of, "tt", small_n)
        dense_flops = (theory.flops_project_dense_tt(kk, dims, op.rank)
                       if of == "tt"
                       else theory.flops_project_dense_cp(kk, dims, op.rank))
        cheaper = (b * densify_flops("tt", dims, 10)
                   + min(b * dense_flops,
                         dense_operator_flops(of, kk, dims, op.rank)
                         + 2 * b * kk * math.prod(dims)))
        sc = 1.0 / math.sqrt(kk)
        run = lambda: carry.carry_sweep_project(  # noqa: E731
            *cores, n_op=n_op, plan=plan, scale=sc)
        row = time_row(
            key, carry_flops(of, "tt", cores, n_op), cheaper,
            4 * (sum(c.numel() for c in cores) + b * kk), run,
            lambda: carry.carry_sweep_project_plain(
                *cores, n_op=n_op, program=plan.program, scale=sc),
            lambda: torch.einsum(spec, *inter), shape, timer=timer)
        row["tiles"] = {f: getattr(plan, f) for f in (
            "tk", "tb", "tps", "tpd", "dc", "uc", "ro", "ri", "smem_bytes")}
        return row, run

    # one row a shape the path launched K3 at (B=1, each shape's 20
    # launches), timed with the launches queued behind a sleep kernel so
    # that the host's launch time drops out; at k=1024 also the profiler's
    # device time, the wrapper's host time and the B=64 batch
    rows = []
    for family, rank, kk in held:
        key = fig1_key(family, rank, kk)
        op = rp.make_projector(rp.ProjectorSpec(family, kk, dims, rank),
                               1000, device=dev)
        row, run = k3_row(
            family, op, single, key, cuda_ms_queued,
            f"B=1 k={kk} dims=15^3 {map_name(family, rank)} input TT rank "
            "10 (unit norm), as rp.project launches it in Fig. 1; ms, "
            "plain_ms and library_ms are device times of calls queued "
            "behind a sleep kernel (CUDA events)")
        if kk == k and rank == ops_[family].rank:
            device_split(row, run, reps=10, names=CARRY_KERNELS,
                         need=("carry",))
            row["host_us"] = host_us(run)
            b64, run64 = k3_row(
                family, ops_[family], batch, key, cuda_ms,
                f"B={FIG1_BATCH} k={k} dims=15^3 {map_name(family, rank)} "
                "input TT rank 10 (unit norm); not a shape the path "
                "launches: the batch timed beside the Gaussian")
            device_split(b64, run64, reps=10, names=CARRY_KERNELS,
                         need=("carry",))
            b64["host_us"] = host_us(run64)
            b64["ms_each"] = cuda_ms_each(run64, reps=20)
            row.update({f"b64_{f}": b64[f] for f in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "program_bound_ms", "flops", "program_flops",
                "device_split_ms", "profile_windows", "host_us",
                "ms_each", "tiles")})
            row["b64_rp_project_ms"] = fig1_ms[map_name(family, rank)]
            row["fig1_rp_project_ms"] = fig1_ms
            log(f"{key}: B=1 device {row['device_split_ms']['carry']:.4f} "
                f"ms (profiler), host {row['host_us']:.1f} us a call; B="
                f"{FIG1_BATCH} device {b64['device_split_ms']['carry']:.4f} "
                f"ms (profiler), per call (CUDA events) min "
                f"{min(b64['ms_each']):.4f} median "
                f"{statistics.median(b64['ms_each']):.4f} max "
                f"{max(b64['ms_each']):.4f}, tiles {b64['tiles']}; "
                f"Gaussian streamed at the same batch "
                f"{fig1_ms['Gaussian']:.4f} ms")
        rows.append(row)
    log("fig1 K3 at B=1, device ms (queued) / plain ms / bound ms a shape: "
        + "; ".join(f"{r['name'].split(':', 2)[2]} {r['ms']:.4f} / "
                    f"{r['plain_ms']:.4f} / {r['bound_ms']:.5f}"
                    for r in rows))
    print(json.dumps({"fig1": table}))
    torch.cuda.empty_cache()
    return rows


def _inside(outer: dict, inner: dict) -> bool:
    """Whether trace event `inner` lies within span `outer` on its lane."""
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner.get("dur", 0.0)
            <= outer["ts"] + outer["dur"] + 1e-3)


def obs_phase(dev):
    """Phase 13: the telemetry layer at the serving shapes and on the
    full-width train loop, and the disabled path's host cost."""
    import torch
    from repro_torch import kernels, obs, rp
    from repro_torch.core import BatchedTTTensor, random_tt
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import _sweep
    from repro_torch.kernels import fused_update as kfused
    from repro_torch.kernels.struct import carry
    from repro_torch.kernels.struct import plan as splan
    from repro_torch.launch import obs_report, serve_rp
    from repro_torch.runtime import train_loop
    from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                                   replay, synth_trace)

    out = REPO / "build" / "chip_smoke_obs"
    out.mkdir(parents=True, exist_ok=True)
    k_req = obs.required_k("tt", 3, rank=SLICE_RANKS["tt"], eps=OBS_EPS,
                           delta=OBS_DELTA)
    if k_req > SLICE_K:
        raise AssertionError(f"required_k {k_req} > k={SLICE_K}")

    servers = []
    make_server = serve_rp.SketchServer

    def recording_server(*a, **kw):
        servers.append(make_server(*a, **kw))
        return servers[-1]

    def serve_cli(k, tag, extra=()):
        trace_p, metrics_p = out / f"{tag}.trace.json", out / f"{tag}.jsonl"
        args = ["--family", "tt", "--k", str(k), "--dims",
                *map(str, SLICE_DIMS), "--rank", str(SLICE_RANKS["tt"]),
                "--requests", "1024", "--mix", "1", "0", "0", "--max-batch",
                "64", "--flush-us", "1000", "--device", str(dev),
                "--trace-out", str(trace_p), "--metrics-out", str(metrics_p),
                "--distortion", str(OBS_EPS), str(OBS_DELTA), *extra]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        serve_rp.SketchServer = recording_server
        try:
            if serve_rp.main(args) != 0:
                raise AssertionError(f"serve_rp {tag} failed")
        finally:
            serve_rp.SketchServer = make_server
        torch.cuda.synchronize()
        k1 = _sweep.sweep_project.launches
        events = obs_report.load_trace(trace_p)
        ticks = [e for e in events
                 if e["ph"] == "X" and e["name"] == "serve.tick"]
        projs = [e for e in events
                 if e["ph"] == "X" and e["name"] == "rp.project"]
        inside = [[p for p in projs if _inside(t, p)] for t in ticks]
        if (k1 != len(ticks) or len(projs) != len(ticks)
                or any(len(ps) != 1 for ps in inside)
                or any(p["args"]["backend"] != "kernel" for p in projs)):
            raise AssertionError(
                f"serve_rp {tag}: {len(ticks)} serve.tick spans, "
                f"{len(projs)} rp.project spans, K1 launches {k1}; expected "
                "one kernel-route rp.project span inside each tick")
        rows = obs.read_jsonl(metrics_p)
        hist = next(r for r in rows if r["name"] == "serve/queue_delay_us")
        done = next(r for r in rows if r["name"] == "serve/requests_done")
        alerts = [r for r in rows if r["name"] == "distortion.alert"]
        if hist["count"] != 1024 or done["value"] != 1024:
            raise AssertionError(f"serve_rp {tag}: histogram count "
                                 f"{hist['count']}, requests_done "
                                 f"{done['value']}; expected 1024")
        log(f"serve_rp {tag} k={k}: {len(ticks)} serve.tick spans, each "
            f"with one kernel-route rp.project span; K1 launches {k1}; "
            f"queue-delay histogram n={hist['count']} p50={hist['p50']:.0f} "
            f"p99={hist['p99']:.0f} us; {len(alerts)} distortion alert(s)")
        obs_report.main(["--trace", str(trace_p), "--metrics",
                         str(metrics_p)])
        return alerts

    manifest_p = out / "tt5_k512.manifest.json"
    if serve_cli(SLICE_K, "tt5_k512", ["--save-manifest", str(manifest_p)]):
        raise AssertionError(f"a distortion alert fired at k={SLICE_K} >= "
                             f"required_k {k_req}")
    # a restarted server warmed from the manifest: the same trace, every
    # operator prewarmed, no cache miss, the same cores bit for bit
    first = servers[-1]
    entries = json.loads(manifest_p.read_text())["entries"]
    serve_cli(SLICE_K, "tt5_k512_prewarm", ["--prewarm", str(manifest_p)])
    second = servers[-1]
    st = second.cache.stats.as_dict()
    keys = first.cache.keys()
    if (st["prewarmed"] != len(entries) or st["misses"] != 0 or not entries
            or second.cache.keys() != keys):
        raise AssertionError(
            f"prewarmed server: {st}, keys "
            f"{second.cache.keys()}; expected {len(entries)} prewarmed "
            f"operators {keys} and no miss")
    for key in keys:
        a, b = first.cache.get(*key), second.cache.get(*key)
        if not all(torch.equal(x, y) for x, y in zip(a.cores, b.cores)):
            raise AssertionError(f"prewarmed operator {key} differs from "
                                 "the first server's")
    log(f"serve_rp --save-manifest / --prewarm: {len(entries)} manifest "
        f"entries, {st['prewarmed']} prewarmed, {st['hits']} hits / "
        f"{st['misses']} misses, regen {st['regen_s'] * 1e3:.2f} ms, the "
        "cores equal the "
        "first server's bit for bit")
    del first, second, servers[:]
    alerts = serve_cli(16, "tt5_k16")
    if len(alerts) != 1 or alerts[0]["k"] != 16:
        raise AssertionError(f"k=16: alerts {alerts}; expected one")
    log(f"distortion target eps={OBS_EPS} delta={OBS_DELTA}: required_k "
        f"{k_req}; silent at k={SLICE_K}, one alert at k=16 (out-rate "
        f"{alerts[0]['out_rate']:.3f}, k_required "
        f"{alerts[0]['k_required']})")

    # the mixed replay under capture: a dispatch span per K1/K3 launch
    spec = rp.ProjectorSpec("tt", SLICE_K, SLICE_DIMS, SLICE_RANKS["tt"])
    server = SketchServer(ServeConfig(max_batch=64, flush_us=1000.0),
                          SketchStore(spec, device=dev), device=dev)
    trace = synth_trace(1024, [(spec, 0)], mix=(1.0, 1.0, 1.0),
                        ranks=(2, 3, 4), mean_gap_us=200.0, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with obs.capture() as ctx, rp.dispatch_stats() as st:
        report = replay(server, trace)
        torch.cuda.synchronize()
    k1 = _sweep.sweep_project.launches
    k3 = carry.carry_sweep_project.launches
    events = ctx.tracer.events()
    projs = [e for e in events if e["name"] == "rp.project"]
    ticks = [e for e in events if e["name"] == "serve.tick"]
    if not (len(projs) == k1 + k3 == len(ticks) == report["ticks"]
            == st.kernel_calls) or k1 == 0 or k3 == 0:
        raise AssertionError(
            f"mixed replay: {len(projs)} rp.project spans, {len(ticks)} "
            f"ticks spans, K1 {k1} + K3 {k3} launches, {report['ticks']} "
            "ticks")
    log(f"mixed replay under capture: {len(projs)} rp.project spans == K1 "
        f"{k1} + K3 {k3} launches == {report['ticks']} ticks")
    del server, trace, ctx

    # two full-width train steps through the train loop under capture
    model, _, _, _, _, step_fn, state, data = train_slice(dev)
    n_leaves = len(tree_leaves(state["params"]))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with obs.capture() as ctx:
        state, final = train_loop.run(
            step_fn, state, data,
            train_loop.LoopConfig(total_steps=2, log_every=1), log=log)
        torch.cuda.synchronize()
    counts = (_sweep.sweep_project.launches,
              kfused.fused_update_buckets.launches)
    events = ctx.tracer.events()
    steps_ = [e for e in events if e["name"] == "train.step"]
    per_step = [{name: sum(1 for e in events
                           if e["name"] == name and _inside(s, e))
                 for name in ("rp.project", "train.loss_grad",
                              "train.sketch", "train.fused_update")}
                for s in steps_]
    want = {"rp.project": n_leaves, "train.loss_grad": 1,
            "train.sketch": 1, "train.fused_update": 1}
    if (len(steps_) != 2 or any(p != want for p in per_step)
            or counts != (2 * n_leaves, 2 * n_leaves)):
        raise AssertionError(f"train loop: {len(steps_)} train.step spans "
                             f"holding {per_step}, (K1, K4) launches "
                             f"{counts}; expected 2 steps of {want}")
    log(f"train loop under capture: 2 train.step spans "
        f"({[round(s['dur'] / 1e3, 1) for s in steps_]} host ms), each "
        f"holding {want}; (K1, K4) launches {counts}")
    del model, state, step_fn, ctx, events
    torch.cuda.empty_cache()

    # the disabled path's host cost beside K3's wrapper at a mixed tick's
    # B=8 call (TT(5), k=512, 64^3, rank-4 TT inputs)
    gen = torch.Generator(device=dev).manual_seed(3)
    op = rp.make_projector(spec, 0, device=dev)
    xb = BatchedTTTensor.stack([random_tt(gen, SLICE_DIMS, 4)
                                for _ in range(8)])
    cores, n_op = struct_operands(op, "tt", xb, "tt")
    plan = splan.plan_carry_sweep("tt", "tt", SLICE_K, 8, SLICE_DIMS,
                                  SLICE_RANKS["tt"], 4)
    scale = 1.0 / math.sqrt(SLICE_K)
    wrapper_us = host_us(lambda: carry.carry_sweep_project(
        *cores, n_op=n_op, plan=plan, scale=scale), reps=200)
    off_us = host_us(lambda: rp.project(op, xb), reps=200)
    with obs.capture():
        on_us = host_us(lambda: rp.project(op, xb), reps=200)
    loops = 20000
    t0 = time.perf_counter()
    for _ in range(loops):
        with obs.span("obs/bench", family="tt", structure="dense"):
            pass
        obs.counter("obs/bench_c").inc(0)
        obs.histogram("obs/bench_h").observe(1.0)
    bundle_us = (time.perf_counter() - t0) / loops * 1e6
    frac = bundle_us / wrapper_us
    log(f"host us a call at a mixed tick's B=8 K3 dispatch: rp.project "
        f"with obs disabled {off_us:.1f}, enabled {on_us:.1f}; K3's wrapper "
        f"{wrapper_us:.1f}; the disabled bundle (span + counter + "
        f"histogram) {bundle_us:.3f} us = {100 * frac:.2f}% of the "
        "wrapper's (limit 5%)")
    if frac > 0.05:
        raise AssertionError(f"disabled obs costs {100 * frac:.2f}% of "
                             "K3's wrapper host time, over 5%")


def ckpt_phase(dev):
    """Phase 14: checkpointing on the full-width train loop (async saves
    with sketched EF records through K1, a crash, a restore through K2),
    the restored state against the live one, a crash-restart of the
    reduced model against an uninterrupted run, and a corrupted newest
    checkpoint's fallback. Returns the (K1, K2, K4) launches of the
    checkpointed run."""
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels, obs
    from repro_torch.ckpt import SketchedTreeCodec, checkpointer
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import _sweep, ops
    from repro_torch.kernels import fused_update as kfused
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import FaultInjector, run_with_restarts

    t_phase = time.perf_counter()
    model, _, _, comp, _, step_fn, state0, data = train_slice(dev)
    codec = SketchedTreeCodec(comp.cfg, state0["ef"])
    n_leaves = len(tree_leaves(state0["ef"]))
    p_bytes = 4 * sum(t.numel() for t in tree_leaves(state0["params"]))
    ckpt_bytes = 3 * p_bytes + codec.sketch_bytes()
    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    need = 2.1 * ckpt_bytes     # the old checkpoint and the next one's tmp
    log(f"phase 14: {free / 1e9:.2f} GB free under {root} before the "
        f"phase; a checkpoint takes about {ckpt_bytes / 1e9:.2f} GB, the "
        f"phase needs {need / 1e9:.2f} GB")
    if free < need:
        raise AssertionError(f"phase 14 needs {need / 1e9:.2f} GB free "
                             f"under {root}, {free / 1e9:.2f} GB there")
    ckdir = tempfile.mkdtemp()
    try:
        # -- 14a. the checkpointed run: saves at 2 and 4, a crash at 3 ----
        k1_save, k2_restore, save_ms, steps_ = [], [], [], []
        encode, decode = codec.encode, codec.decode

        def counted_encode(tree, *, step):
            k1 = _sweep.sweep_project.launches
            rec = encode(tree, step=step)
            k1_save.append(_sweep.sweep_project.launches - k1)
            return rec

        def counted_decode(record):
            k2 = _sweep.sweep_reconstruct.launches
            out = decode(record)
            k2_restore.append(_sweep.sweep_reconstruct.launches - k2)
            return out

        codec.encode, codec.decode = counted_encode, counted_decode
        async_save = checkpointer.AsyncCheckpointer.save
        writers = []

        def timed_save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            async_save(self, step, tree, extra)
            save_ms.append((step, (time.perf_counter() - t0) * 1e3))
            writers.append(self._thread)

        def timed_step(state, batch):
            busy = any(w is not None and w.is_alive() for w in writers)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step_fn(state, batch)
            ev[1].record()
            steps_.append((int(state["opt"]["count"]), busy, ev))
            return out

        final = {}

        def attempt(injector):
            final["state"], step = train_loop.run(
                timed_step, state0, data, train_loop.LoopConfig(
                    total_steps=4, ckpt_dir=ckdir, ckpt_every=2,
                    keep_ckpts=1, async_ckpt=True, log_every=1),
                injector=injector, log=log, ef_codec=codec)
            return step

        checkpointer.AsyncCheckpointer.save = timed_save
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        try:
            with obs.capture() as ctx:
                report = run_with_restarts(attempt, max_restarts=1,
                                           injector=FaultInjector({3}))
                torch.cuda.synchronize()
        finally:
            checkpointer.AsyncCheckpointer.save = async_save
            codec.encode, codec.decode = encode, decode
        counts = (_sweep.sweep_project.launches,
                  _sweep.sweep_reconstruct.launches,
                  kfused.fused_update_buckets.launches)
        events = ctx.tracer.events()
        names = [e["name"] for e in ctx.metrics.events]
        resumes = [e for e in ctx.metrics.events if e["name"] == "ckpt.resume"]
        spans = {n: [e for e in events if e["name"] == n and e["ph"] == "X"]
                 for n in ("ckpt.save", "ckpt.verify", "ckpt.restore",
                           "train.step")}
        step_tids = {e["tid"] for e in spans["train.step"]}
        n_steps = len(spans["train.step"])
        want = (n_steps * n_leaves + 2 * n_leaves, n_leaves,
                n_steps * n_leaves)
        problems = []
        if not (report.completed and report.restarts == 1
                and report.final_step == 4):
            problems.append(f"report {report}")
        if [e["step"] for e in resumes] != [2] or "ckpt.fallback" in names:
            problems.append(f"events {names}, resumes {resumes}")
        if (len(spans["ckpt.save"]) != 2 or not spans["ckpt.restore"]
                or not spans["ckpt.verify"] or step_tids & {
                    e["tid"] for e in spans["ckpt.save"]}):
            problems.append(f"spans { {n: len(v) for n, v in spans.items()} }")
        if k1_save != [n_leaves, n_leaves] or k2_restore != [n_leaves]:
            problems.append(f"K1 launches per save {k1_save}, K2 launches "
                            f"per restore {k2_restore}")
        if n_steps != 5 or counts != want:
            problems.append(f"{n_steps} steps, (K1, K2, K4) launches "
                            f"{counts}, expected {want}")
        if problems:
            raise AssertionError("checkpointed run: " + "; ".join(problems))
        log(f"checkpointed run (crash at step 3, saves at 2 and 4, "
            f"keep_ckpts=1): {report.restarts} restart ({report.history}), "
            f"final step {report.final_step}; one ckpt.resume at step 2; "
            f"{len(spans['ckpt.save'])} ckpt.save spans on the writer "
            f"thread, {len(spans['ckpt.verify'])} ckpt.verify, "
            f"{len(spans['ckpt.restore'])} ckpt.restore; K1 launches per "
            f"save {k1_save}, K2 per restore {k2_restore}; (K1, K2, K4) "
            f"launches {counts} over {n_steps} steps")

        # -- 14b. the step-4 checkpoint against the live state -------------
        live = final.pop("state")
        path = Path(ckdir) / f"step_{4:010d}"
        disk = sum(f.stat().st_size for f in path.iterdir())
        example = dict(live)
        example["ef"] = codec.record_shapes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpointer.verify(path)
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, step = checkpointer.restore(ckdir, example)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for part in ("params", "opt"):
            for a, b in zip(tree_leaves(got[part]), tree_leaves(live[part])):
                if a.device != b.device or not torch.equal(a, b):
                    raise AssertionError(f"restored {part} differ from the "
                                         "live state")
        rec = codec.encode(live["ef"], step=4)
        if not torch.equal(got["ef"]["y"].to(dev), rec["y"]):
            raise AssertionError("the record's y differs from K1's sketch "
                                 "of the live EF under key_for(4)")
        dec = tree_leaves(codec.decode(got["ef"]))
        op = comp.cfg.operator(codec.key_for(4), dev)
        cores = kernel_operands(op, "tt")
        scale = 1.0 / math.sqrt(op.k)
        sk, y, off, worst = codec._sk, rec["y"], 0, 0.0
        for leaf, nb, size in zip(dec, sk._nb, sk._sizes):
            plan = ops.plan_contraction("tt", "reconstruct", op.k, nb,
                                        op.in_dims, op.rank)
            diff = top = 0.0
            for i in range(0, nb, 4):
                ref = _sweep.sweep_reconstruct_plain(
                    y[off + i:off + min(i + 4, nb)], *cores,
                    steps=plan.steps, scale=scale).reshape(-1)
                lo = i * comp.cfg.bucket_elems
                got_ = leaf.reshape(-1)[lo:lo + ref.numel()]
                ref = ref[:got_.numel()]
                diff = max(diff, rel_err(got_, ref)[0])
                top = max(top, float(ref.abs().max()))
            worst = max(worst, diff / max(top, 1e-30))
            off += nb
        if worst > TOL:
            raise AssertionError(f"decode vs K2's plain version: "
                                 f"{worst:.3e} > {TOL}")
        del got, dec, rec, y
        dense_eq = 4 * p_bytes
        log(f"step-4 checkpoint: params, m, v and count equal the live "
            f"state bit for bit; the record's y equals K1's sketch under "
            f"key_for(4); decode vs K2's plain version on {n_leaves} "
            f"leaves: max|d|/max|ref| {worst:.3e}")
        log(f"bytes on disk per checkpoint {disk} (dense-equivalent "
            f"{dense_eq} = 4 x {p_bytes} for params, m, v and ef); EF "
            f"{p_bytes} -> {codec.sketch_bytes()} B "
            f"({codec.compression_ratio():.1f}x)")
        saves = spans["ckpt.save"]
        log("AsyncCheckpointer.save host-blocking ms: " + ", ".join(
            f"step {s_} {ms:.1f}" for s_, ms in save_ms)
            + "; the writer thread's ckpt.save span s: " + ", ".join(
                f"{e['dur'] / 1e6:.2f}" for e in saves))
        log(f"verify {verify_s:.2f}s ({disk / verify_s / 1e9:.2f} GB/s), "
            f"restore (verify included) {restore_s:.2f}s "
            f"({disk / restore_s / 1e9:.2f} GB/s)")
        timed = [(c, busy, ev[0].elapsed_time(ev[1]))
                 for c, busy, ev in steps_]
        log("train step device ms (count at the step's start, a save in "
            "flight): " + ", ".join(f"{c}{' (saving)' if busy else ''} "
                                    f"{ms:.1f}" for c, busy, ms in timed))
        if not any(busy for _, busy, _ in timed):
            raise AssertionError("no train step ran with a save in flight")
        numbers = {"disk_bytes": disk, "dense_equivalent_bytes": dense_eq,
                   "save_host_ms": save_ms,
                   "writer_s": [e["dur"] / 1e6 for e in saves],
                   "verify_s": verify_s, "restore_s": restore_s,
                   "step_ms": timed, "free_bytes": free}
        del live, example, state0, step_fn, model, codec
        torch.cuda.empty_cache()

        # -- 14c. crash-restart of the reduced model, and the fallback ----
        numbers["reduced"] = _reduced_crash_restart(dev, ckdir)
        log(f"phase 14 numbers: {json.dumps(numbers)}")
        return counts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        log(f"phase 14 took {time.perf_counter() - t_phase:.1f}s")


def _reduced_crash_restart(dev, ckdir):
    """The reference test's crash-restart on the card: reduced llama3.2-3b,
    no compressor, 30 steps, a crash at 17, ckpt_every=5; the restart
    lands on the uninterrupted run's params within rtol = atol = 1e-6.
    Then one byte of the newest checkpoint flipped: the next run falls
    back to the previous verified step with one `ckpt.fallback`."""
    import functools
    import os

    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import schedule
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import (FaultInjector, flip_byte,
                                                run_with_restarts)

    cfg = reduced(get_config("llama3.2-3b"))
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    step_fn = steps.build_train_step(
        model, ShapeSpec("t", 32, 4, "train"), device=dev,
        lr_fn=functools.partial(schedule.constant, peak_lr=1e-3))

    def init():
        return steps.init_train_state(
            model, torch.Generator(device=dev).manual_seed(0))

    # the same state through the step twice: the same bits?
    s0 = init()
    a, _ = step_fn(s0, data.batch(0))
    b, _ = step_fn(s0, data.batch(0))
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    log(f"reduced step twice from one state: the same bits: {same}")
    deterministic = torch.are_deterministic_algorithms_enabled()
    if not same:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
    try:
        def train(d, injector=None):
            return train_loop.run(step_fn, init(), data,
                                  train_loop.LoopConfig(
                                      total_steps=30, ckpt_dir=d,
                                      ckpt_every=5, log_every=1000,
                                      async_ckpt=False),
                                  injector=injector, log=lambda *_: None)

        ref, _ = train(os.path.join(ckdir, "ref"))
        held = {}

        def attempt(injector):
            held["state"], final = train(os.path.join(ckdir, "crash"),
                                         injector)
            return final

        report = run_with_restarts(attempt, max_restarts=2,
                                   injector=FaultInjector({17}))
        if not (report.completed and report.restarts == 1):
            raise AssertionError(f"reduced crash-restart: {report}")
        worst = 0.0
        for x, y in zip(tree_leaves(held["state"]["params"]),
                        tree_leaves(ref["params"])):
            worst = max(worst, float(((x - y).abs() - 1e-6
                                      * y.abs()).max()))
        if worst > 1e-6:
            raise AssertionError(f"reduced crash-restart: params differ "
                                 f"beyond rtol = atol = 1e-6 ({worst:.3e})")
        exact = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(held["state"]["params"]), tree_leaves(ref["params"])))
        log(f"reduced crash-restart (30 steps, crash at 17, ckpt_every=5): "
            f"1 restart, params within rtol = atol = 1e-6 of the "
            f"uninterrupted run (equal bit for bit: {exact})")
        crash = os.path.join(ckdir, "crash")
        flip_byte(os.path.join(crash, f"step_{30:010d}", "arr_0.npy"))
        with obs.capture() as ctx:
            _, final = train_loop.run(step_fn, init(), data,
                                      train_loop.LoopConfig(
                                          total_steps=30, ckpt_dir=crash,
                                          ckpt_every=5, async_ckpt=False),
                                      log=log)
        fb = [e for e in ctx.metrics.events if e["name"] == "ckpt.fallback"]
        if (len(fb) != 1 or fb[0]["step_requested"] != 30
                or fb[0]["step_restored"] != 25 or final != 30):
            raise AssertionError(f"fallback: events {fb}, final {final}")
        log("flipped byte in step 30's arr_0.npy: one ckpt.fallback "
            "(30 -> 25), resumed and finished at step 30")
        return {"same_bits_twice": same, "exact": exact,
                "max_excess": worst}
    finally:
        torch.use_deterministic_algorithms(deterministic)


# ---------------------------------------------------------------------------
# phase 15: the cross-pod sketch collective
# ---------------------------------------------------------------------------

POD_STEP = 7          # the compressor step (operator seed) of 15a and 15b
POD_TOL = 2e-5        # collective vs compress_per_pod at fp32, rtol = atol
                      # (the reference's tests/test_shard.py:147-148)
INT8_BUDGET = 0.12    # int8 vs fp32, relative (tests/test_compress.py:272)
POD_SYNCS = ("sketch-mean", "local-mean")
WIRE_BYTES = {("sketch-mean", "fp32"): 2_338_816,
              ("sketch-mean", "int8"): 586_988,
              ("local-mean", "fp32"): 2_381_377_536,
              ("local-mean", "int8"): 595_344_428}
POD_GB_A_RANK = 32.0  # 15c's rough peak a rank: params, m, v, EF, the
                      # unfused transients, a batch-1 activation peak
POD_TIMEOUT = 420.0   # seconds a spawned pair of ranks may take


def seeded_tree(shapes, rows, dev, salt: int, *, stack: bool):
    """A float32 tree shaped like `shapes` (a nested dict of shapes), row p
    of `rows` drawn leaf by leaf (sorted keys) from a generator seeded by
    (salt, p), so a rank draws its own row alone, bit for bit the row of
    the stack. `stack=False` takes one row and gives no leading dim."""
    import torch
    gens = [torch.Generator(device=dev).manual_seed(1_000_003 * salt + p)
            for p in rows]

    def fill(node):
        out = {}
        for key in sorted(node):
            if isinstance(node[key], dict):
                out[key] = fill(node[key])
                continue
            parts = [torch.randn(node[key], generator=g, device=dev)
                     for g in gens]
            out[key] = torch.stack(parts) if stack else parts[0]
            del parts
        return out
    return fill(shapes)


class _HostMark:
    """A host-clock stand-in for a CUDA event (a CPU rehearsal)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _mark(dev):
    import torch
    return (torch.cuda.Event(enable_timing=True) if dev.type == "cuda"
            else _HostMark())


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _empty_tree(shapes, dev):
    import torch
    return {k: _empty_tree(v, dev) if isinstance(v, dict)
            else torch.empty(v, device=dev) for k, v in shapes.items()}


def bits_digest(tree) -> list[int]:
    """A digest of a float32 tree's bits: per leaf, the sum of its int32
    words and their sum weighted by position (mod 65521), wrapping in
    int64. Equal trees give equal digests; ranks compare digests."""
    import torch
    from repro_torch.core.tree import tree_leaves
    out = []
    for leaf in tree_leaves(tree):
        words = leaf.contiguous().view(-1).view(torch.int32)
        s1 = s2 = 0
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].to(torch.int64)
            idx = torch.arange(lo, lo + w.numel(), device=w.device) % 65521
            s1 = (s1 + int(w.sum())) % (1 << 62)
            s2 = (s2 + int((w * (idx + 1)).sum())) % (1 << 62)
        out += [s1, s2]
    return out


def _worst_close(got, want) -> float:
    """max over elements of |got - want| / (POD_TOL + POD_TOL |want|): at
    most 1 when assert_allclose(rtol=atol=POD_TOL) holds."""
    return float(((got - want).abs() / (POD_TOL + POD_TOL * want.abs())
                  ).max())


def _rel_norm(a, b) -> float:
    import torch
    return float(torch.linalg.norm((a - b).reshape(-1))
                 / max(float(torch.linalg.norm(a.reshape(-1))), 1e-30))


def _pod_ranks(task: str, shapes, extra: dict) -> list[dict]:
    """Run `task` on two gloo ranks that share the card; each rank's
    result dict comes back as JSON. A rank that fails fails the phase."""
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{task}_")
    ctx = mp.start_processes(_pod_rank, args=(2, tmp, task, shapes, extra),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + POD_TIMEOUT
    while not ctx.join(timeout=2.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the ranks of {task!r} did not end "
                                 f"within {POD_TIMEOUT:.0f} s")
    return [json.loads(Path(tmp, f"{task}_{r}.json").read_text())
            for r in range(2)]


def _pod_rank(rank, world, tmp, task, shapes, extra):
    """One spawned rank: join the gloo group through a file store, run
    `task`, write its numbers."""
    import os
    # two ranks share one card: expandable segments keep each rank's
    # cache from fragmenting into blocks the other cannot use
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        res = {"collective": _pod_collective, "train": _pod_train,
               "ckpt": _pod_ckpt}[task](rank, shapes, extra)
        Path(tmp, f"{task}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _pod_collective(rank, shapes, extra):
    """15b on one rank: compress_collective under both syncs and wires on
    this rank's row, against compress_per_pod (rank 0 runs it on the
    whole tree and hands rank 1 its residual row), the ledger against
    wire_bytes, the same bits on both ranks and twice under int8; then
    project_sharded / reconstruct_sharded at w_gate over ("data",) and the
    standalone collectives' host ms."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels, rp
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import _sweep
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.rp import shard

    dev = torch.device(extra["device"])
    mesh = make_mesh((2,), ("pod",), device=dev, backend="gloo")
    group = mesh.group("pod")
    cfg = parse_compress_flag(TRAIN_COMPRESS)
    res = {"rank": rank, "device": str(mesh.device)}
    # -- the oracle: compress_per_pod on the whole (2, ...) tree ----------
    per_pod, resid_row = {}, None
    if rank == 0:
        g_all = seeded_tree(shapes, [0, 1], dev, 1, stack=True)
        e_all = tree_map(lambda t: 0.1 * t,
                         seeded_tree(shapes, [0, 1], dev, 2, stack=True))
        for sync in POD_SYNCS:
            out, st, _ = SketchCompressor(cfg, sync=sync).compress_per_pod(
                g_all, {"residual": e_all}, step=POD_STEP)
            per_pod[sync] = out
            resid_pp = st["residual"]
        del g_all, e_all
        resid_row = tree_map(lambda t: t[0].clone(), resid_pp)
        for leaf in tree_leaves(resid_pp):
            dist.broadcast(leaf[1].contiguous(), 0, group=group.pg)
        del resid_pp
        _free(dev)  # the oracle's peak stays cached otherwise
    else:
        resid_row = _empty_tree(shapes, dev)
        for leaf in tree_leaves(resid_row):
            dist.broadcast(leaf, 0, group=group.pg)
    g = seeded_tree(shapes, [rank], dev, 1, stack=False)
    e = tree_map(lambda t: 0.1 * t,
                 seeded_tree(shapes, [rank], dev, 2, stack=False))
    # -- the collective, every (sync, wire) ------------------------------
    # (kept between runs: the fp32 run's g and residual, for int8; digests
    # stand in for the other runs' bits, to keep two ranks on one card)
    launches = {"sweep_project": 0, "sweep_reconstruct": 0}
    runs = {}
    for sync in POD_SYNCS:
        fp32 = None
        for wire in ("fp32", "int8"):
            comp = SketchCompressor(cfg, sync=sync, wire=wire)
            digests = []
            for rep in range(2 if wire == "int8" else 1):
                shard.collective_ledger().reset()
                kernels.reset_launch_counts()
                _sync(dev)
                t0 = time.perf_counter()
                out, st, met = comp.compress_collective(
                    g, {"residual": e}, step=POD_STEP, mesh=mesh)
                _sync(dev)
                wall = time.perf_counter() - t0
                launches["sweep_project"] += _sweep.sweep_project.launches
                launches["sweep_reconstruct"] += (
                    _sweep.sweep_reconstruct.launches)
                resid = st["residual"]
                digests.append(bits_digest(out))
                if rep == 0 and wire == "int8":
                    rel_g = max(_rel_norm(a, b) for a, b in zip(
                        tree_leaves(fp32[0]), tree_leaves(out)))
                    rel_resid = max(_rel_norm(a, b) for a, b in zip(
                        tree_leaves(fp32[1]), tree_leaves(resid)))
                if rep == 0 and wire == "fp32":
                    fp32 = (out, resid)
                del out, st
            led = shard.collective_ledger()
            sk = comp._sketcher(g)
            run = {"wire_bytes": comp.wire_bytes(sk),
                   "metric": float(met["wire_bytes"]),
                   "ledger_bytes": led.bytes(tag="compress", axes="pod"),
                   "ledger": led.table(),
                   "host_s_call": wall,
                   "collective_host_s": led.seconds(tag="compress"),
                   "launches_k1": _sweep.sweep_project.launches,
                   "launches_k2": _sweep.sweep_reconstruct.launches,
                   "leaves": len(sk._nb), "buckets": sk.n_buckets,
                   "digest": digests[-1]}
            if wire == "int8":
                run.update(same_bits_twice=digests[0] == digests[1],
                           rel_g=rel_g, rel_resid=rel_resid)
            else:
                run["worst_resid"] = max(_worst_close(a, b) for a, b in zip(
                    tree_leaves(fp32[1]), tree_leaves(resid_row)))
                if rank == 0:
                    run["worst_g"] = max(_worst_close(a, b) for a, b in zip(
                        tree_leaves(fp32[0]), tree_leaves(per_pod[sync])))
                    del per_pod[sync]
            if dev.type == "cuda":
                run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                torch.cuda.reset_peak_memory_stats()
            runs[f"{sync}/{wire}"] = run
            del resid
            _free(dev)
        del fp32
    res["runs"] = runs
    res["launches"] = launches
    del per_pod, resid_row
    # -- project_sharded / reconstruct_sharded at w_gate ------------------
    dmesh = make_mesh((2,), ("data",), device=dev, backend="gloo")
    sk = SketchCompressor(cfg)._sketcher(g)
    names = ["/".join(k) for k in _leaf_names(g)]
    j = names.index("layers/w_gate")
    leaf = tree_leaves(g)[j]
    x = sk._leaf_to_buckets(leaf, sk._nb[j])
    op = cfg.operator(SketchCompressor(cfg)._key(POD_STEP), dev)
    whole = rp.project(op, x)
    kernels.reset_launch_counts()
    block = shard.project_sharded(op, x, mesh=dmesh, spec=(("data",),))
    back = shard.reconstruct_sharded(op, whole, mesh=dmesh,
                                     spec=(("data",),))
    _sync(dev)
    sharded_launches = (_sweep.sweep_project.launches,
                        _sweep.sweep_reconstruct.launches)
    n = x.shape[0] // 2
    lo, hi = rank * n, (rank + 1) * n
    recon_whole = rp.reconstruct(op, whole[lo:hi])
    res["sharded"] = {
        "buckets": int(x.shape[0]), "block": list(block.shape),
        "launches": list(sharded_launches),
        "project_rel": rel_err(block, whole[lo:hi])[1],
        "reconstruct_rel": rel_err(back, recon_whole)[1]}
    launches["sweep_project"] += sharded_launches[0]
    launches["sweep_reconstruct"] += sharded_launches[1]
    del x, whole, block, back, recon_whole
    # -- the collectives alone, host ms (synchronized around) -------------
    y = torch.randn((sum(sk._nb), cfg.k), device=dev)
    dense = tree_leaves(g)[max(range(len(sk._nb)),
                               key=lambda i: sk._nb[i])]
    timing = {}
    for name, fn in (
            ("sketch fp32 all_reduce", lambda: shard.all_reduce(y, group)),
            ("sketch int8 scale max + all_reduce", lambda: shard.all_reduce(
                shard.quantize_for_psum(y, group, 2)[0], group)),
            (f"dense leaf {list(dense.shape)} fp32 all_reduce",
             lambda: shard.all_reduce(dense, group))):
        times = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        timing[name] = times
    res["collective_ms"] = timing
    return res


def _pod_train(rank, shapes, extra):
    """15c on one rank: the pod train step at phase 9's widths (pod=2,
    one row a pod): sketch-mean fp32 (a warm-up and 3 counted steps),
    sketch-mean int8 (3), local-mean fp32 (1); each step's loss, device
    ms and parts, the collective's host ms, the params' digest (ranks
    compare), the K1/K2 launches; then the peak memory."""
    import dataclasses
    import functools

    import torch
    from repro_torch import kernels
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _sweep
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, schedule
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.rp import shard
    from repro_torch.runtime import spans

    dev = torch.device(extra["device"])
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device=dev,
                     backend="gloo")
    cfg = dataclasses.replace(extra["cfg"], n_layers=extra["layers"])
    model = build_model(cfg)
    shape = ShapeSpec("train_4k", extra["seq"], 2, "train")
    opt = adamw.AdamWConfig(clip_norm=None)
    lr_fn = functools.partial(schedule.constant, peak_lr=TRAIN_LR)
    scfg = parse_compress_flag(TRAIN_COMPRESS)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), opt=opt,
        compressor=SketchCompressor(scfg))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                  global_batch=2, seed=0))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    plan = [("sketch-mean", "fp32", 1, 3), ("sketch-mean", "int8", 0, 3),
            ("local-mean", "fp32", 0, 1)]
    out, i = [], 0
    for sync, wire, warm, counted in plan:
        step_fn = steps.build_train_step(
            model, shape, mesh=mesh, opt=opt, lr_fn=lr_fn,
            compressor=SketchCompressor(scfg, sync=sync, wire=wire))
        for n in range(warm + counted):
            batch = data.batch(i)
            i += 1
            shard.collective_ledger().reset()
            kernels.reset_launch_counts()
            s_ev, e_ev = _mark(dev), _mark(dev)
            with spans.record(lambda: _mark(dev)) as marks:
                s_ev.record()
                state, met = step_fn(state, batch)
                e_ev.record()
            _sync(dev)
            led = shard.collective_ledger()
            row = {"sync": sync, "wire": wire, "warm_up": n < warm,
                   "loss": float(met["loss"]),
                   "step_ms": s_ev.elapsed_time(e_ev),
                   "parts_ms": {name: s.elapsed_time(e)
                                for name, s, e in marks},
                   "collective_host_ms": 1e3 * led.seconds(tag="compress"),
                   "loss_host_ms": 1e3 * led.seconds(tag="loss"),
                   "wire_bytes": float(met["wire_bytes"]),
                   "ledger_bytes": led.bytes(tag="compress"),
                   "launches_k1": _sweep.sweep_project.launches,
                   "launches_k2": _sweep.sweep_reconstruct.launches,
                   "param_digest": bits_digest(state["params"])}
            # the params' digest, all-gathered: the same bits on both pods
            mine = torch.tensor(row["param_digest"], device=dev)
            both = shard.all_gather(mine[None], mesh.group("pod"),
                                    tag="check")
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"15c step {i}: the pods' params "
                                     "differ after the step")
            out.append(row)
    return {"rank": rank, "layers": extra["layers"], "steps": out,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None)}


def _cli_losses(text: str) -> list[float]:
    return [float(line.split("loss=")[1].split()[0])
            for line in text.splitlines()
            if line.startswith("step ") and "loss=" in line]


def _free(dev) -> None:
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def pod_phase(dev) -> dict:
    """Phase 15: the cross-pod sketch collective on the card. 15a: NCCL at
    world size 1; 15b: compress_collective on two gloo ranks sharing the
    card; 15c: the pod train step at full width; 15d: the train CLI under
    torch.distributed.run. Returns the numbers of the `collective` line,
    with the K1/K2 launches of the phase under `launches`."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import _sweep
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.rp import shard
    from repro_torch.rp.plan import collective_wire_bytes

    t_phase = time.perf_counter()
    model, arch, shape, comp, _, _, state, _ = train_slice(dev)
    shapes = tree_map(lambda t: tuple(t.shape), state["params"])
    sk = comp._sketcher(state["params"])
    del model, state
    _free(dev)
    cfg = parse_compress_flag(TRAIN_COMPRESS)
    launches = {"sweep_project": 0, "sweep_reconstruct": 0}
    expect = {(sync, wire): collective_wire_bytes(
        sync=sync, wire=wire, sketch_bytes=sk.sketch_bytes(),
        dense_bytes=sk.dense_bytes(), n_buckets=sk.n_buckets,
        n_leaves=len(sk._nb)) for sync in POD_SYNCS
        for wire in ("fp32", "int8")}
    if expect != WIRE_BYTES:
        raise AssertionError(f"phase 15: the slice's wire bytes {expect} "
                             f"are not the expected {WIRE_BYTES}")
    numbers = {"leaves": len(sk._nb), "buckets": sk.n_buckets,
               "params": sk.n, "wire_bytes_expected": {
                   f"{s}/{w}": b for (s, w), b in WIRE_BYTES.items()}}

    # -- 15a: NCCL, world size 1 ------------------------------------------
    mesh = make_mesh((1,), ("pod",), device=dev)
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise AssertionError(f"15a: the mesh runs {mesh.backend!r}, not NCCL")
    g = seeded_tree(shapes, [0], dev, 1, stack=False)
    e = tree_map(lambda t: 0.1 * t, seeded_tree(shapes, [0], dev, 2,
                                                stack=False))
    a = {}
    for sync in POD_SYNCS:
        c = SketchCompressor(cfg, sync=sync)
        want, wst, _ = c.compress(g, {"residual": e}, step=POD_STEP)
        c.compress_collective(g, {"residual": e}, step=POD_STEP, mesh=mesh)
        shard.collective_ledger().reset()
        kernels.reset_launch_counts()
        got, gst, met = c.compress_collective(g, {"residual": e},
                                              step=POD_STEP, mesh=mesh)
        _sync(dev)
        k1, k2 = (_sweep.sweep_project.launches,
                  _sweep.sweep_reconstruct.launches)
        launches["sweep_project"] += k1
        launches["sweep_reconstruct"] += k2
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves((got, gst)), tree_leaves((want, wst))))
        led = shard.collective_ledger()
        rows = [r for r in led.table() if r["tag"] == "compress"]
        a[sync] = {"equal_to_compress": same, "ledger": led.table(),
                   "wire_bytes": float(met["wire_bytes"]),
                   "launches_k1": k1, "launches_k2": k2}
        log(f"15a NCCL world 1 {sync}: compress_collective == compress bit "
            f"for bit: {same}; ledger {rows}; K1 {k1}, K2 {k2} launches")
        if not same:
            raise AssertionError(f"15a {sync}: compress_collective on one "
                                 "pod is not compress bit for bit")
        if sync == "sketch-mean" and [(r["op"], r["calls"], r["bytes"])
                                      for r in rows] != [
                ("all_reduce", 1, WIRE_BYTES["sketch-mean", "fp32"])]:
            raise AssertionError(f"15a: ledger {rows}, expected one "
                                 "all_reduce of 2,338,816 B")
        n_leaves = len(sk._nb)
        if (k1, k2) != (n_leaves, n_leaves * (2 if sync == "sketch-mean"
                                              else 1)):
            raise AssertionError(f"15a {sync}: K1/K2 launches {(k1, k2)}")
        del want, wst, got, gst
    numbers["15a"] = a
    dist.destroy_process_group()
    del g, e, mesh
    _free(dev)

    # -- 15b: gloo, two ranks on the card ---------------------------------
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info()
        log(f"15b: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; this "
            f"process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    ranks = _pod_ranks("collective", shapes, {"device": str(dev)})
    b = {"seconds": time.perf_counter() - t0, "ranks": ranks}
    for r in ranks:
        for name in launches:
            launches[name] += r["launches"][name]
        for key, run in r["runs"].items():
            sync, wire = key.split("/")
            want = WIRE_BYTES[sync, wire]
            log(f"15b rank {r['rank']} {key}: ledger {run['ledger_bytes']} "
                f"B, wire_bytes {run['wire_bytes']} (expected {want}); "
                f"peak {run.get('peak_gib', 0.0):.1f} GiB; "
                f"call {1e3 * run['host_s_call']:.1f} ms host, of which "
                f"collectives {1e3 * run['collective_host_s']:.1f} ms; K1 "
                f"{run['launches_k1']}, K2 {run['launches_k2']}; "
                + (f"int8/fp32 rel g {run['rel_g']:.4f} resid "
                   f"{run['rel_resid']:.4f}, same bits twice "
                   f"{run['same_bits_twice']}" if wire == "int8" else
                   f"vs compress_per_pod worst |d|/(atol+rtol|ref|): resid "
                   f"{run['worst_resid']:.3g}" + (
                       f", g {run['worst_g']:.3g}" if "worst_g" in run
                       else "")))
            if not run["ledger_bytes"] == run["wire_bytes"] == want:
                raise AssertionError(f"15b {key}: ledger bytes "
                                     f"{run['ledger_bytes']} != wire_bytes "
                                     f"{run['wire_bytes']} / {want}")
            if wire == "fp32" and (run["worst_resid"] > 1 or run.get(
                    "worst_g", 0.0) > 1):
                raise AssertionError(f"15b {key}: collective off "
                                     "compress_per_pod beyond 2e-5")
            if wire == "int8" and not (
                    run["rel_g"] < INT8_BUDGET and run["rel_resid"]
                    < INT8_BUDGET and run["same_bits_twice"]):
                raise AssertionError(f"15b {key}: int8 off budget or bits")
            if run["digest"] != ranks[0]["runs"][key]["digest"]:
                raise AssertionError(f"15b {key}: the ranks' bits differ")
        sh = r["sharded"]
        log(f"15b rank {r['rank']} sharded w_gate ({sh['buckets']} buckets "
            f"over data=2, block {sh['block']}): project rel "
            f"{sh['project_rel']:.3e}, reconstruct rel "
            f"{sh['reconstruct_rel']:.3e}, (K1, K2) {sh['launches']}; "
            f"collectives alone (host ms): {r['collective_ms']}")
        if max(sh["project_rel"], sh["reconstruct_rel"]) > TOL or sh[
                "launches"] != [1, 1]:
            raise AssertionError(f"15b sharded: {sh}")
    numbers["15b"] = b

    # -- 15c: the pod train step at full width ----------------------------
    _free(dev)
    free, total = (torch.cuda.mem_get_info() if dev.type == "cuda"
                   else (float("inf"), float("inf")))
    layers = arch.n_layers
    if free / 1e9 < 2 * POD_GB_A_RANK:
        layers = 1
    log(f"15c: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; two ranks "
        f"need about {2 * POD_GB_A_RANK:.0f} GB at {arch.n_layers} layers: "
        f"running {layers} layer(s)")
    t0 = time.perf_counter()
    ranks = _pod_ranks("train", shapes, {"layers": layers,
                                         "device": str(dev), "cfg": arch,
                                         "seq": shape.seq_len})
    c = {"seconds": time.perf_counter() - t0, "layers": layers,
         "free_gb_before": free / 1e9, "ranks": ranks}
    for r in ranks:
        for row in r["steps"]:
            launches["sweep_project"] += row["launches_k1"]
            launches["sweep_reconstruct"] += row["launches_k2"]
        log(f"15c rank {r['rank']}: peak {r['peak_gib']} GiB; steps "
            + "; ".join(
                f"{s['sync']}/{s['wire']}{' (warm-up)' if s['warm_up'] else ''}"
                f" loss {s['loss']:.4f} {s['step_ms']:.1f} ms ("
                + ", ".join(f"{k} {v:.1f}" for k, v in s["parts_ms"].items())
                + f"), collective host {s['collective_host_ms']:.1f} ms, "
                f"K1 {s['launches_k1']} K2 {s['launches_k2']}"
                for s in r["steps"]))
    for i, (s0, s1) in enumerate(zip(ranks[0]["steps"], ranks[1]["steps"])):
        if s0["param_digest"] != s1["param_digest"]:
            raise AssertionError(f"15c step {i}: the ranks' params differ")
        if not all(math.isfinite(s["loss"]) for s in (s0, s1)):
            raise AssertionError(f"15c step {i}: a loss is not finite")
        if s0["wire_bytes"] != s0["ledger_bytes"]:
            raise AssertionError(f"15c step {i}: ledger {s0['ledger_bytes']}"
                                 f" != wire_bytes {s0['wire_bytes']}")
    numbers["15c"] = c

    # -- 15d: the CLI on two ranks ----------------------------------------
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "llama3.2-3b", "--reduced", "--mesh", "2x1x1",
           "--dist-backend", "gloo", "--compress",
           "tt:k=1024,rank=8,dims=4x8x16", "--compress-sync", "sketch-mean",
           "--steps", "20"] + (["--device", "cpu"] if dev.type == "cpu"
                               else [])
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=POD_TIMEOUT)
    losses = _cli_losses(done.stdout)
    log(f"15d: {' '.join(cmd[2:])}: exit {done.returncode} in "
        f"{time.perf_counter() - t0:.1f}s; logged losses {losses}")
    if done.returncode != 0:
        raise AssertionError(f"15d: the CLI failed:\n{done.stdout[-3000:]}"
                             f"\n{done.stderr[-3000:]}")
    if len(losses) < 2 or not losses[-1] < losses[0]:
        raise AssertionError(f"15d: the loss did not fall: {losses}")
    numbers["15d"] = {"losses": losses,
                      "seconds": time.perf_counter() - t0}
    numbers["launches"] = launches
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 took {numbers['seconds']:.1f}s; K1/K2 launches "
        f"{launches}")
    return numbers


# ---------------------------------------------------------------------------
# phase 16: pod-mesh checkpoints
# ---------------------------------------------------------------------------

POD_CKPT_STEPS = 4    # 16a: steps of a run; saves every 2, a crash at 3


def _pod_ckpt(rank, shapes, extra):
    """16a-b on one rank of the (pod=2) mesh at phase 9's widths: the pod
    train loop uninterrupted, then with dense-EF checkpoints every 2 steps
    and a crash at step 3 on both ranks, restarted from the directory;
    the digests of params, m, v and this rank's EF row after both. Then
    one more step whose save writes a sketched record of the stacked rows
    (K1 on rank 0), the record restored through K2 twice (the stacked
    decode's digest) and through `resume_pod_rank` (this rank's row)."""
    import dataclasses
    import functools

    import torch
    from repro_torch import kernels
    from repro_torch.ckpt import (SketchedTreeCodec, checkpointer,
                                  resume_elastic, resume_pod_rank)
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _sweep
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adamw, schedule
    from repro_torch.optim.compress import (SketchCompressor,
                                            parse_compress_flag)
    from repro_torch.rp import shard
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.resilience import FaultInjector, run_with_restarts

    dev = torch.device(extra["device"])
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), device=dev,
                     backend="gloo")
    cfg = dataclasses.replace(extra["cfg"], n_layers=extra["layers"])
    model = build_model(cfg)
    shape = ShapeSpec("train_4k", extra["seq"], 2, "train")
    opt = adamw.AdamWConfig(clip_norm=None)
    comp = SketchCompressor(parse_compress_flag(TRAIN_COMPRESS),
                            sync="sketch-mean")
    step_fn = steps.build_train_step(
        model, shape, mesh=mesh, opt=opt, compressor=comp,
        lr_fn=functools.partial(schedule.constant, peak_lr=TRAIN_LR))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                  global_batch=2, seed=0))

    def fresh():
        return steps.init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), opt=opt,
            compressor=comp)

    def digests(state):
        return {"params": bits_digest(state["params"]),
                "m": bits_digest(state["opt"]["m"]),
                "v": bits_digest(state["opt"]["v"]),
                "ef": bits_digest(state["ef"])}

    quiet = lambda *_: None  # noqa: E731
    res = {"rank": rank, "layers": extra["layers"]}
    kernels.reset_launch_counts()
    plain, _ = train_loop.run(step_fn, fresh(), data, train_loop.LoopConfig(
        total_steps=POD_CKPT_STEPS, npod=2, log_every=100), mesh=mesh,
        log=quiet)
    res["plain"] = digests(plain)
    del plain
    _free(dev)

    # -- 16a: dense EF, a crash at step 3 on both ranks, the restart -----
    save_ms, final = [], {}
    async_save = checkpointer.AsyncCheckpointer.save

    def timed_save(self, step, tree, extra=None):
        t0 = time.perf_counter()
        async_save(self, step, tree, extra)
        save_ms.append((step, (time.perf_counter() - t0) * 1e3))

    def attempt(injector):
        final["state"], step = train_loop.run(
            step_fn, fresh(), data, train_loop.LoopConfig(
                total_steps=POD_CKPT_STEPS, ckpt_dir=extra["dense_dir"],
                ckpt_every=2, keep_ckpts=1, npod=2, log_every=100),
            injector=injector, mesh=mesh, log=quiet)
        return step

    shard.collective_ledger().reset()
    checkpointer.AsyncCheckpointer.save = timed_save
    t0 = time.perf_counter()
    try:
        report = run_with_restarts(attempt, max_restarts=1,
                                   injector=FaultInjector({3}))
    finally:
        checkpointer.AsyncCheckpointer.save = async_save
    if not report.completed:
        raise AssertionError(f"16a: the checkpointed run did not complete: "
                             f"{report}")
    _sync(dev)
    led = shard.collective_ledger()
    res.update(
        restart_s=time.perf_counter() - t0, restarts=report.restarts,
        final_step=report.final_step, resumed=digests(final["state"]),
        save_host_ms=save_ms,
        gather_host_ms=1e3 * led.seconds(tag="pod_rows"),
        gather_calls=led.calls(tag="pod_rows"),
        gather_bytes=led.bytes(tag="pod_rows"))
    # 16c's expected EF on one pod: the fixed-order sum of the two rows
    rows = shard.gather_pod_rows(final["state"]["ef"], mesh)
    if rank == 0:
        path = Path(extra["dense_dir"]) / f"step_{POD_CKPT_STEPS:010d}"
        res["disk_bytes"] = sum(f.stat().st_size for f in path.iterdir())
        res["ef_sum"] = bits_digest(tree_map(lambda t: t[0] + t[1], rows))
    del rows

    # -- 16b: a sketched record of the stacked rows, restored through K2 --
    codec = SketchedTreeCodec.for_pod_rows(comp.cfg, final["state"]["ef"], 2)
    state, _ = train_loop.run(step_fn, final.pop("state"), data,
                              train_loop.LoopConfig(
                                  total_steps=1, ckpt_dir=extra["sk_dir"],
                                  ckpt_every=1, npod=2, async_ckpt=False,
                                  log_every=100),
                              ef_codec=codec, mesh=mesh, log=quiet)
    # params and moments restore onto the host (meta examples), the EF
    # decodes on the card
    example = tree_map(lambda t: torch.empty(
        tuple(t.shape), dtype=t.dtype, device="meta"), state)
    example["ef"] = tree_map(lambda t: torch.empty(
        (2,) + tuple(t.shape), device="meta"), state["ef"])
    del state
    _free(dev)
    k2 = _sweep.sweep_reconstruct.launches
    whole = []
    for _ in range(2):
        got, _ = resume_elastic(extra["sk_dir"], example, npod_new=2,
                                ef_device=dev)
        whole.append(bits_digest(got["ef"]))
        mine = bits_digest(tree_map(lambda t: t[rank], got["ef"]))
        del got
        _free(dev)
    example["ef"] = tree_map(lambda t: torch.empty(t.shape[1:], device=dev),
                             example["ef"])
    row, _ = resume_pod_rank(extra["sk_dir"], example, mesh)
    res.update(sk_decodes=whole,
               sk_row_is_the_decodes=bits_digest(row["ef"]) == mine,
               sk_k2_a_restore=(_sweep.sweep_reconstruct.launches - k2) // 3,
               launches={"sweep_project": _sweep.sweep_project.launches,
                         "sweep_reconstruct":
                             _sweep.sweep_reconstruct.launches},
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None))
    return res


def pod_ckpt_phase(dev) -> dict:
    """Phase 16: pod-mesh checkpoints. 16a-b on two gloo ranks sharing
    the card (`_pod_ckpt`); 16c in this process: the 2-pod checkpoint
    restored onto one pod of an NCCL mesh, its EF's digest that of the
    fixed-order sum of the two rows (computed by rank 0 from the rows it
    gathered). Returns the numbers of the `pod_ckpt` line, with the
    K1/K2 launches of the phase under `launches`."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import resume_pod_rank
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    model, arch, shape, comp, _, _, state, _ = train_slice(dev)
    shapes = tree_map(lambda t: tuple(t.shape), state["params"])
    p_bytes = 4 * sum(t.numel() for t in tree_leaves(state["params"]))
    del model, state
    _free(dev)
    ckpt_bytes = 5 * p_bytes    # params, m, v and two EF rows
    root = tempfile.gettempdir()
    free_disk = shutil.disk_usage(root).free
    need = 2.1 * ckpt_bytes + 3 * p_bytes
    log(f"phase 16: {free_disk / 1e9:.2f} GB free under {root}; a dense-EF "
        f"pod checkpoint takes about {ckpt_bytes / 1e9:.2f} GB, the phase "
        f"needs {need / 1e9:.2f} GB")
    if free_disk < need:
        raise AssertionError(f"phase 16 needs {need / 1e9:.2f} GB free "
                             f"under {root}, {free_disk / 1e9:.2f} GB there")
    free, total = (torch.cuda.mem_get_info() if dev.type == "cuda"
                   else (float("inf"), float("inf")))
    layers = arch.n_layers if free / 1e9 >= 2 * POD_GB_A_RANK + 10 else 1
    log(f"16a: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB: running "
        f"{layers} layer(s)")
    dense_dir, sk_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        ranks = _pod_ranks("ckpt", shapes, {
            "layers": layers, "device": str(dev), "cfg": arch,
            "seq": shape.seq_len, "dense_dir": dense_dir, "sk_dir": sk_dir})
        numbers = {"layers": layers, "ranks_s": time.perf_counter() - t0,
                   "ranks": ranks}
        launches = {"sweep_project": 0, "sweep_reconstruct": 0}
        for r in ranks:
            for name in launches:
                launches[name] += r["launches"][name]
            log(f"16a rank {r['rank']}: restarts {r['restarts']}, final "
                f"step {r['final_step']}, crash-restart digests equal to "
                f"the uninterrupted run: "
                f"{ {k: r['resumed'][k] == r['plain'][k] for k in r['plain']} }"
                f"; gather {r['gather_calls']} calls, {r['gather_bytes']} "
                f"B, {r['gather_host_ms']:.1f} ms host; save host-blocking "
                f"ms {r['save_host_ms']}; run {r['restart_s']:.1f} s; peak "
                f"{r['peak_gib']} GiB")
            if (r["restarts"], r["final_step"]) != (1, POD_CKPT_STEPS) or \
                    r["resumed"] != r["plain"]:
                raise AssertionError(f"16a rank {r['rank']}: the crash-"
                                     "restart is not the uninterrupted run")
            log(f"16b rank {r['rank']}: the stacked record decoded twice "
                f"the same bits {r['sk_decodes'][0] == r['sk_decodes'][1]}"
                f"; resume_pod_rank's row is the decode's row "
                f"{r['sk_row_is_the_decodes']}; K2 launches a restore "
                f"{r['sk_k2_a_restore']}")
            if r["sk_decodes"][0] != r["sk_decodes"][1] or not r[
                    "sk_row_is_the_decodes"]:
                raise AssertionError("16b: two decodes of the record gave "
                                     "other bits, or the rank's row is not "
                                     "its row of the decode")
        if ranks[0]["sk_decodes"][0] != ranks[1]["sk_decodes"][0]:
            raise AssertionError("16b: the ranks decoded the record to "
                                 "other bits")
        if ranks[0]["plain"]["params"] != ranks[1]["plain"]["params"]:
            raise AssertionError("16a: the pods' params differ")
        if not all(r["launches"][n] > 0 for r in ranks for n in launches):
            raise AssertionError(f"16: a rank launched no K1 or K2: "
                                 f"{[r['launches'] for r in ranks]}")
        numbers["disk_bytes"] = ranks[0]["disk_bytes"]
        log(f"16a: the step-{POD_CKPT_STEPS} checkpoint holds "
            f"{ranks[0]['disk_bytes']} B")

        # -- 16c: the 2-pod checkpoint onto one pod (NCCL, world 1) -------
        t0 = time.perf_counter()
        mesh = make_mesh((1,), ("pod",), device=dev)
        if dev.type == "cuda" and dist.get_backend() != "nccl":
            raise AssertionError(f"16c: the mesh runs {mesh.backend!r}")
        rows = _empty_tree(shapes, "meta")
        example = {"params": rows, "opt": {
            "m": rows, "v": rows,
            "count": torch.empty((), dtype=torch.int64, device="meta")},
            "ef": {"residual": _empty_tree(shapes, dev)}}
        got, step = resume_pod_rank(dense_dir, example, mesh)
        exact = bits_digest(got["ef"]) == ranks[0]["ef_sum"]
        numbers["16c"] = {"step": step, "exact": exact,
                          "seconds": time.perf_counter() - t0}
        log(f"16c: the 2-pod checkpoint on one NCCL pod: step {step}, EF "
            f"equal to the fixed-order sum of the two rows bit for bit: "
            f"{exact} ({numbers['16c']['seconds']:.1f} s)")
        dist.destroy_process_group()
        if not exact or step != POD_CKPT_STEPS:
            raise AssertionError("16c: the elastic restore is not the sum "
                                 "of the rows")
        del got, example
        _free(dev)
    finally:
        shutil.rmtree(dense_dir, ignore_errors=True)
        shutil.rmtree(sk_dir, ignore_errors=True)
    numbers["launches"] = launches
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 took {numbers['seconds']:.1f}s; K1/K2 launches "
        f"{launches}")
    return numbers


# ---------------------------------------------------------------------------
# phase 17: LM serving at full width
# ---------------------------------------------------------------------------

# (arch, slots, requests) at full depth and width
LM_CASES = (("llama3.2-3b", 8, 16), ("gemma2-9b", 4, 8))
LM_MAX_SEQ = 512
LM_PROMPT = (64, 128)  # prompt lengths, drawn from a seeded generator
LM_GEN = 32
LM_CHECK_SEQ = 32      # decode against forward at fp32 on one sequence
LM_LOOP_PROMPT = 16    # the batched-prefill check's prompt length
LM_DEC_TOL = 2e-3      # decode against forward (the reference's tolerance)
LM_BF16_TOL = 3e-2     # the server's bf16 decode against the fp32 forward,
                       # of the largest |logit| (the CPU tests' bf16 bound)


def _lm_case(dev, arch: str, slots: int, n_req: int, *,
             layers: int | None = None, prompt=LM_PROMPT,
             phase: str = "17") -> dict:
    """One model of phase 17 (see `lm_phase`) or of phase 18's MoE part
    (`layers` cuts the depth; `moe_phase`); every tensor it makes is
    freed when it returns. The parameters are drawn at the policy's
    dtype (fp32, 'lean' bf16). Under 'lean' the decode-against-forward
    check runs at bf16 (the served step against the bf16 forward): an
    fp32 forward would cast a layer's weights to fp32. An MoE model's
    checks against the forward run on a copy of its config whose
    capacity factor is num_experts / top_k: at the published factor the
    forward drops tokens over an expert's capacity, and decode never
    does (the two legitimately differ). An MoE model's served bf16 step
    is held against the bf16 forward: against the fp32 forward every
    router logit differs by about 2^-9 of its size, enough to swap a
    near-tied second and third expert at some (token, layer), which
    moves that token's hidden state by a whole expert's output; at bf16
    the two programs differ only where two product shapes round
    differently. An fp32 MoE model's served step is also read against
    the fp32 forward (max |d| and greedy agreement where the top two
    logits are clearly apart, as for a dense model), which shows how
    large that effect is; the reading is recorded, not held to a
    bound."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import build_model, transformer

    t_case = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    pol = steps._policy(cfg)
    lean = pol["param_dtype"] != torch.float32
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dtype=pol["param_dtype"])
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in
               rng.integers(prompt[0], prompt[1] + 1, n_req)]

    # -- the timed serve ----------------------------------------------
    srv = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                     max_gen=LM_GEN, device=dev, params=params)
    feed, steps_ms = [], []
    feed_prompt, step = srv._feed_prompt, srv.step

    def timed_feed(slot, req):
        t0 = time.perf_counter()
        feed_prompt(slot, req)          # ends in a host sync
        feed.append((len(req.prompt), time.perf_counter() - t0))

    def timed_step():
        s, e = _mark(dev), _mark(dev)
        s.record()
        step()                          # ends in a host sync
        e.record()
        _sync(dev)
        steps_ms.append(s.elapsed_time(e))

    srv._feed_prompt, srv.step = timed_feed, timed_step
    _sync(dev)
    t0 = time.perf_counter()
    done = srv.run([Request(i, p) for i, p in enumerate(prompts)])
    _sync(dev)
    wall = time.perf_counter() - t0
    gen = sum(len(r.generated) for r in done)
    prompt_tokens = sum(n for n, _ in feed)
    if len(done) != n_req or gen != n_req * LM_GEN:
        raise AssertionError(f"{phase} {arch}: {len(done)} of {n_req} requests, "
                             f"{gen} tokens generated")
    row = {"layers": cfg.n_layers,
           "layers_published": get_config(arch).n_layers, "params": n_params,
           "param_dtype": str(pol["param_dtype"]).removeprefix("torch."),
           "slots": slots,
           "requests": n_req, "max_seq": LM_MAX_SEQ,
           "prompt_tokens": prompt_tokens, "generated_tokens": gen,
           "wall_s": wall, "tokens_per_s": gen / wall,
           "all_tokens_per_s": (gen + prompt_tokens) / wall,
           "decode_steps": len(steps_ms),
           "decode_ms_median": statistics.median(steps_ms),
           "decode_ms_min": min(steps_ms),
           "prefill_ms_a_token": 1e3 * sum(s for _, s in feed)
           / prompt_tokens}
    del srv, feed_prompt, step, timed_feed, timed_step
    _free(dev)

    # -- one decode step at B = slots: eager against the captured graph --
    graphed = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                         max_gen=1, device=dev, params=params)
    cache = model.init_cache(slots, LM_MAX_SEQ, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(1, cfg.vocab, (slots,), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(slots, dtype=torch.int32, device=dev) + prompt[0]
    if not all(torch.equal(graphed.cache[key], cache[key]) for key in cache):
        raise AssertionError(f"{phase} {arch}: the server's cache does not start "
                             "empty")
    run_e = lambda: model.decode_step(params, cache, tok, pos)[0]  # noqa: E731
    run_g = lambda: graphed._step(params, graphed.cache, tok, pos)[0]  # noqa: E731
    row["graph_equals_eager"] = bool(torch.equal(run_e(), run_g()))
    if not row["graph_equals_eager"]:
        raise AssertionError(f"{phase} {arch}: the server's decode step's logits "
                             "differ from the eager step's")
    if dev.type == "cuda":
        row["eager_decode_ms"] = cuda_ms(run_e, 10)
        row["graph_decode_ms"] = cuda_ms(run_g, 10)
        row["device_busy_ms"] = device_split(row, run_e, reps=5, names=None,
                                             need=("all",))["all"]
        row["eager_idle_share"] = 1 - row["device_busy_ms"] / row[
            "eager_decode_ms"]
        log(f"{phase} {arch}: one decode step at B={slots}: eager "
            f"{row['eager_decode_ms']:.2f} ms, CUDA graph "
            f"{row['graph_decode_ms']:.2f} ms (the same bits), the kernels' "
            f"device time {row['device_busy_ms']:.2f} ms (profiler): the "
            f"eager step leaves the card idle "
            f"{100 * row['eager_idle_share']:.1f}% of its time")
    del graphed, cache, run_e, run_g
    _free(dev)

    # -- the model's one-forward prefill of the longest prompt ----------
    toks = torch.tensor(max(prompts, key=len)[None], device=dev)
    model.prefill(params, toks, LM_MAX_SEQ)
    s, e = _mark(dev), _mark(dev)
    s.record()
    model.prefill(params, toks, LM_MAX_SEQ)
    e.record()
    _sync(dev)
    row["one_forward_prefill_ms_a_token"] = s.elapsed_time(e) / toks.shape[1]

    # -- the batched prefill against a token-by-token loop --------------
    def serve_check(feed_loop):
        srv = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                         max_gen=8, device=dev, params=params)
        if feed_loop:
            def loop_feed(slot, req):
                logits = None
                for t in req.prompt:
                    tok = srv.cur_tok.copy()
                    tok[slot] = t
                    logits, srv.cache = srv._step(
                        srv.params, srv.cache, torch.tensor(tok, device=dev),
                        torch.tensor(srv.pos, device=dev))
                    srv.pos[slot] += 1
                srv.cur_tok[slot] = int(torch.argmax(logits[slot]))
            srv._feed_prompt = loop_feed
        got = srv.run([Request(i, p[:LM_LOOP_PROMPT])
                       for i, p in enumerate(prompts[:slots])])
        return {r.rid: r.generated for r in got}

    fast, loop = serve_check(False), serve_check(True)
    row["batched_prefill_equals_loop"] = fast == loop
    log(f"{phase} {arch}: batched prefill vs token loop on {slots} requests of "
        f"{LM_LOOP_PROMPT} prompt tokens, 8 generated: "
        f"{'equal' if fast == loop else 'DIFFERENT'}")
    if fast != loop:
        raise AssertionError(f"{phase} {arch}: the batched prefill's greedy "
                             f"tokens differ from the loop's: {fast} vs "
                             f"{loop}")
    _free(dev)

    # -- decode against the forward at fp32 ('lean': the forward at bf16)
    ccfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    row["check_capacity_factor"] = (None if cfg.moe is None
                                    else ccfg.moe.capacity_factor)
    seq = torch.tensor(prompts[0][None, :LM_CHECK_SEQ], device=dev)

    def forward(dtype):
        with torch.inference_mode():
            h = transformer.forward_hidden(ccfg, params, seq,
                                           compute_dtype=dtype, remat="none")
            return transformer._logits(ccfg, params, h)
    row["decode_vs_forward_worst"] = None
    if not lean:
        full = forward(torch.float32)
        cache = model.init_cache(1, LM_CHECK_SEQ, dtype=torch.float32,
                                 device=dev)
        dec = []
        for t in range(LM_CHECK_SEQ):
            lg, cache = model.decode_step(
                params, cache, seq[:, t],
                torch.full((1,), t, dtype=torch.int32, device=dev),
                compute_dtype=torch.float32)
            dec.append(lg)
        dec = torch.stack(dec, 1)
        worst = float(((dec - full).abs() / (LM_DEC_TOL + LM_DEC_TOL
                                             * full.abs())).max())
        row["decode_vs_forward_worst"] = worst
        log(f"{phase} {arch}: decode vs forward at fp32 over "
            f"{LM_CHECK_SEQ} tokens: worst |d|/(atol+rtol|ref|) "
            f"{worst:.3g} (rtol = atol = {LM_DEC_TOL})")
        if not worst <= 1.0:
            raise AssertionError(f"{phase} {arch}: decode off the forward")
        del cache, dec
    fwd_dtype = (torch.float32 if not lean and cfg.moe is None
                 else torch.bfloat16)
    full32 = full if not lean and cfg.moe is not None else None
    if fwd_dtype != torch.float32:
        full = forward(fwd_dtype)
    row["forward_dtype"] = str(fwd_dtype).removeprefix("torch.")
    row["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else None)
    row["seconds"] = time.perf_counter() - t_case

    # -- the server's bf16 decode (the timed path) against that forward --
    # (the server's step runs at full capacity whatever the factor)
    one = SlotServer(model, slots=1, max_seq=LM_MAX_SEQ, eos=None,
                     max_gen=1, device=dev, params=params)
    served = []
    for t in range(LM_CHECK_SEQ):
        lg, one.cache = one._step(
            one.params, one.cache, seq[:, t].to(torch.int32),
            torch.full((1,), t, dtype=torch.int32, device=dev))
        served.append(lg.clone())
    served = torch.stack(served, 1)

    def against(ref):
        """(max |d| over the largest |logit|, positions whose top two
        logits are further apart than the bound, greedy agreement there,
        the largest |logit|)"""
        top = float(ref.abs().max())
        top2 = torch.topk(ref, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > LM_BF16_TOL * top
        return (float((served - ref).abs().max()) / top, int(clear.sum()),
                int((served.argmax(-1) == ref.argmax(-1))[clear].sum()), top)
    (row["served_bf16_vs_forward"], row["served_greedy_clear"],
     row["served_greedy_agree"], top) = against(full)
    if full32 is not None:
        (row["served_bf16_vs_fp32_forward"], row["served_greedy_clear_fp32"],
         row["served_greedy_agree_fp32"], top32) = against(full32)
        log(f"{phase} {arch}: the server's bf16 decode vs the float32 "
            f"forward (a reading, no bound): max |d| "
            f"{row['served_bf16_vs_fp32_forward']:.3g} of the largest "
            f"|logit| {top32:.3g}; greedy tokens equal at "
            f"{row['served_greedy_agree_fp32']} of the "
            f"{row['served_greedy_clear_fp32']} positions whose top two are "
            f"further apart than {LM_BF16_TOL}")
        del full32
    log(f"{phase} {arch}: the server's bf16 decode vs the "
        f"{row['forward_dtype']} forward over "
        f"{LM_CHECK_SEQ} tokens: max |d| {row['served_bf16_vs_forward']:.3g} "
        f"of the largest |logit| {top:.3g} (bound {LM_BF16_TOL}); greedy "
        f"tokens equal at {row['served_greedy_agree']} of the "
        f"{row['served_greedy_clear']} positions whose top two are further "
        f"apart than the bound")
    if not (row["served_bf16_vs_forward"] <= LM_BF16_TOL
            and row["served_greedy_agree"] == row["served_greedy_clear"]):
        raise AssertionError(f"{phase} {arch}: the server's bf16 decode is off "
                             "the forward")
    del one, served
    if cfg.moe is not None:
        row["moe_ffn_vs_dense"] = _moe_vs_dense(dev, cfg, params, slots,
                                                f"{phase} {arch}")
    log(f"{phase} {arch} ({cfg.n_layers} layers, {n_params} params): {n_req} "
        f"requests, {prompt_tokens} prompt + {gen} generated tokens in "
        f"{wall:.2f} s ({row['tokens_per_s']:.1f} generated tokens/s); "
        f"decode {row['decode_ms_median']:.2f} ms a step at B={slots} "
        f"(median of {len(steps_ms)}, min {row['decode_ms_min']:.2f}); the "
        f"server's prefill {row['prefill_ms_a_token']:.2f} ms a prompt "
        f"token, one forward {row['one_forward_prefill_ms_a_token']:.3f} "
        f"ms a token; peak {row['peak_gib']} GiB; {row['seconds']:.1f} s")
    return row


def _moe_vs_dense(dev, cfg, params, slots: int, tag: str) -> float:
    """Layer 0's FFN as the served step runs it (`transformer._ffn` on
    the weights cast to bf16, at full capacity, on `slots` tokens)
    against each token's own top-k experts evaluated one by one at fp32
    from the same bf16 weights (and arctic's dense residual): the
    dispatch's index arithmetic at the published expert count, held
    within LM_BF16_TOL of the largest |output|. The routing is the
    reference's (fp32 logits from the bf16 router). Returns max |d| over
    the largest |output|."""
    import torch
    from repro_torch.models import transformer
    lp = {k: t[0].to(torch.bfloat16) for k, t in params["layers"].items()
          if k in ("router", "we_gate", "we_up", "we_down", "w_gate",
                   "w_up", "w_down")}
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((slots, 1, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        got = transformer._ffn(cfg, lp, x, full_capacity=True)[:, 0]
        xf = x[:, 0].float()
        vals, ids = torch.topk(xf @ lp["router"].float(), cfg.moe.top_k,
                               dim=-1, sorted=True)
        gates = torch.softmax(vals, dim=-1)
        want = torch.zeros_like(xf)
        for t in range(slots):
            for j in range(cfg.moe.top_k):
                e = int(ids[t, j])
                h = (torch.nn.functional.silu(xf[t] @ lp["we_gate"][e].float())
                     * (xf[t] @ lp["we_up"][e].float()))
                want[t] += gates[t, j] * (h @ lp["we_down"][e].float())
        if cfg.moe.dense_residual_ff:
            want += (torch.nn.functional.silu(xf @ lp["w_gate"].float())
                     * (xf @ lp["w_up"].float())) @ lp["w_down"].float()
    top = float(want.abs().max())
    err = float((got.float() - want).abs().max()) / top
    log(f"{tag}: layer 0's MoE FFN (bf16, full capacity, {slots} tokens, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}) vs each "
        f"token's experts one by one at fp32: max |d| {err:.3g} of the "
        f"largest |output| {top:.3g} (bound {LM_BF16_TOL})")
    if not err <= LM_BF16_TOL:
        raise AssertionError(f"{tag}: the MoE dispatch is off the per-token "
                             "experts")
    return err


def lm_phase(dev) -> dict:
    """Phase 17: `SlotServer` at full width, llama3.2-3b (28 layers) then
    gemma2-9b (42 layers; llama's tensors freed first): the timed serve,
    the batched prefill against a token-by-token loop (bit for bit),
    decode against the forward at fp32, the server's bf16 decode against
    the same forward; the numbers of the `lm_serve` line."""
    t_phase = time.perf_counter()
    out = {}
    for arch, slots, n_req in LM_CASES:
        out[arch] = _lm_case(dev, arch, slots, n_req)
        _free(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 took {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 18: MoE and M-RoPE serving at full width
# ---------------------------------------------------------------------------

# (arch, layers, slots, requests) at the published widths, depth cut:
# mixtral's 56 layers are 141e9 parameters and arctic's 35 are 482e9,
# which one 80 GB card cannot hold; 4 layers of mixtral are 10.4e9 (41.7
# GB fp32), 2 of arctic 27.7e9 (55.4 GB bf16, its 'lean' policy)
MOE_CASES = (("mixtral-8x22b", 4, 4, 8), ("arctic-480b", 2, 4, 4))
MOE_PROMPT = (32, 64)  # shorter than phase 17's: the server feeds a prompt
                       # one token a step
VLM_ARCH = "qwen2-vl-2b"   # full width and full depth (28 layers)
VLM_BATCH = 4
VLM_SEQ = 1024
VLM_IMAGE = (16, 16, 16)   # one image a sequence: offset, rows, cols
VLM_PROMPT = 64            # the text prompt of prefill + the serve steps


def _mrope_positions(batch: int, seq: int, image=None):
    """Qwen2-VL's positions3 (3, batch, seq) int32: text at (t, t, t); an
    image of rows x cols patches at token offset o at (t0, t0 + row,
    t0 + col), t0 the position it starts at; the text after it resumes
    at t0 + max(rows, cols)."""
    import numpy as np
    out = np.zeros((3, batch, seq), np.int32)
    t = i = 0
    while i < seq:
        if image is not None and i == image[0]:
            _, rows, cols = image
            r, c = np.divmod(np.arange(rows * cols), cols)
            out[:, :, i:i + rows * cols] = np.stack(
                [np.full_like(r, t), t + r, t + c])[:, None, :]
            i += rows * cols
            t += max(rows, cols)
            continue
        out[:, :, i] = t
        t, i = t + 1, i + 1
    return out


def _vlm_case(dev) -> dict:
    """qwen2-vl-2b at full width and depth (random fp32 weights, seed 0):
    `build_prefill_step` on VLM_BATCH sequences of VLM_SEQ tokens, each
    holding one image of 256 seeded patch embeddings (a 16 x 16 grid at
    token 16; Qwen2-VL's positions3: text at (t, t, t), the image at (16,
    16 + row, 16 + col), the text after it from 32 on); `prefill` of a
    text prompt and LM_GEN greedy `build_serve_step`s with positions3;
    decode against the forward at fp32 over LM_CHECK_SEQ tokens whose
    positions3 differ across the three sections; `apply_mrope` at (t, t,
    t) equal to `apply_rope` on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import build_model, layers, transformer
    from repro_torch.models.config import ShapeSpec

    t_case = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    row = {"layers": cfg.n_layers, "params": n_params,
           "param_dtype": "float32", "batch": VLM_BATCH, "seq": VLM_SEQ,
           "image": {"offset": VLM_IMAGE[0], "rows": VLM_IMAGE[1],
                     "cols": VLM_IMAGE[2]}}

    # -- M-RoPE at (t, t, t) is RoPE, on the card -----------------------
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 64, cfg.n_heads, cfg.hd), generator=g, device=dev)
    t = torch.randint(0, 4096, (2, 64), generator=g, device=dev)
    row["mrope_equals_rope"] = bool(torch.equal(
        layers.apply_mrope(x, t.expand(3, 2, 64),
                           sections=cfg.mrope_sections, theta=cfg.rope_theta),
        layers.apply_rope(x, t, theta=cfg.rope_theta)))
    log(f"18 {VLM_ARCH}: apply_mrope at (t, t, t) vs apply_rope: "
        f"{'equal' if row['mrope_equals_rope'] else 'DIFFERENT'}")
    if not row["mrope_equals_rope"]:
        raise AssertionError("18: M-RoPE at equal sections is not RoPE")

    # -- the prefill step on image + text sequences ---------------------
    off, rows_, cols = VLM_IMAGE
    n_patch = rows_ * cols
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab, (VLM_BATCH, VLM_SEQ)).astype(np.int32)
    batch = {
        "tokens": torch.tensor(tokens, device=dev),
        "positions3": torch.tensor(_mrope_positions(VLM_BATCH, VLM_SEQ,
                                                    VLM_IMAGE), device=dev),
        "patches": torch.tensor(rng.standard_normal(
            (VLM_BATCH, n_patch, cfg.d_model)).astype(np.float32),
            device=dev),
        "patch_positions": torch.arange(off, off + n_patch, device=dev,
                                        dtype=torch.int32).expand(
                                            VLM_BATCH, n_patch)}
    p3 = batch["positions3"][:, 0]
    if not (p3[:, off + n_patch - 1].tolist() == [off, off + rows_ - 1,
                                                   off + cols - 1]
            and int(p3[0, off + n_patch]) == off + max(rows_, cols)):
        raise AssertionError(f"18: positions3 off the Qwen2-VL layout: "
                             f"{p3[:, off - 1:off + n_patch + 2].tolist()}")
    pstep = steps.build_prefill_step(model, ShapeSpec(
        "prefill_1k", VLM_SEQ, VLM_BATCH, "prefill"))
    logits = pstep(params, batch)
    if not (tuple(logits.shape) == (VLM_BATCH, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"18: the prefill step's logits: "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    no_img = pstep(params, {"tokens": batch["tokens"],
                            "positions3": batch["positions3"]})
    row["patches_move_logits"] = float((logits - no_img).abs().max())
    if not row["patches_move_logits"] > 0:
        raise AssertionError("18: the patch embeddings left the logits as "
                             "they were")
    s, e = _mark(dev), _mark(dev)
    s.record()
    for _ in range(3):
        pstep(params, batch)
    e.record()
    _sync(dev)
    ms = s.elapsed_time(e) / 3
    row["prefill_step_ms"] = ms
    row["prefill_step_tokens_per_s"] = VLM_BATCH * VLM_SEQ / (ms / 1e3)
    log(f"18 {VLM_ARCH}: build_prefill_step on {VLM_BATCH} x {VLM_SEQ} "
        f"tokens ({n_patch} patches a sequence): {ms:.2f} ms "
        f"({row['prefill_step_tokens_per_s']:.0f} tokens/s); the patches "
        f"move the last logits by up to {row['patches_move_logits']:.3g}")
    del batch, logits, no_img
    _free(dev)

    # -- prefill a text prompt, then greedy serve steps with positions3 --
    prompt = torch.tensor(rng.integers(1, cfg.vocab, (VLM_BATCH,
                                                      VLM_PROMPT)),
                          device=dev)
    text3 = lambda t0, n: torch.arange(  # noqa: E731
        t0, t0 + n, device=dev, dtype=torch.int32).expand(3, VLM_BATCH, n)
    model.prefill(params, prompt, LM_MAX_SEQ, positions3=text3(0, VLM_PROMPT))
    s, e = _mark(dev), _mark(dev)
    s.record()
    lg, cache = model.prefill(params, prompt, LM_MAX_SEQ,
                              positions3=text3(0, VLM_PROMPT))
    e.record()
    _sync(dev)
    row["one_forward_prefill_ms_a_token"] = s.elapsed_time(e) / (
        VLM_BATCH * VLM_PROMPT)
    serve = steps.build_serve_step(model, ShapeSpec(
        "decode", LM_MAX_SEQ, VLM_BATCH, "decode"))
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    steps_ms, generated = [], [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        at = VLM_PROMPT + i
        s, e = _mark(dev), _mark(dev)
        s.record()
        tok, cache = serve(params, cache, tok,
                           torch.full((VLM_BATCH,), at, dtype=torch.int32,
                                      device=dev),
                           positions3=text3(at, 1))
        e.record()
        generated.append(tok)
        _sync(dev)
        steps_ms.append(s.elapsed_time(e))
    wall = time.perf_counter() - t0
    gen = torch.stack(generated[1:], 1)
    if not (tuple(gen.shape) == (VLM_BATCH, LM_GEN)
            and bool(((gen >= 0) & (gen < cfg.vocab)).all())):
        raise AssertionError(f"18: the serve steps' tokens: {gen.shape}")
    row.update({"prompt_tokens": VLM_BATCH * VLM_PROMPT,
                "generated_tokens": VLM_BATCH * LM_GEN,
                "decode_steps": LM_GEN, "wall_s": wall,
                "tokens_per_s": VLM_BATCH * LM_GEN / wall,
                "decode_ms_median": statistics.median(steps_ms),
                "decode_ms_min": min(steps_ms)})
    if dev.type == "cuda":
        pos = torch.full((VLM_BATCH,), VLM_PROMPT + LM_GEN,
                         dtype=torch.int32, device=dev)
        run_e = lambda: serve(params, cache, tok, pos,  # noqa: E731
                              positions3=text3(VLM_PROMPT + LM_GEN, 1))[0]
        row["eager_decode_ms"] = cuda_ms(run_e, 10)
        row["device_busy_ms"] = device_split(row, run_e, reps=5, names=None,
                                             need=("all",))["all"]
        row["eager_idle_share"] = 1 - row["device_busy_ms"] / row[
            "eager_decode_ms"]
    log(f"18 {VLM_ARCH}: prefill of {VLM_BATCH} x {VLM_PROMPT} text tokens "
        f"{row['one_forward_prefill_ms_a_token']:.3f} ms a token, then "
        f"{LM_GEN} eager serve steps at B={VLM_BATCH}: "
        f"{row['decode_ms_median']:.2f} ms a step (median), "
        f"{row['tokens_per_s']:.1f} generated tokens/s; the kernels' device "
        f"time {row.get('device_busy_ms', float('nan')):.2f} ms a step, "
        f"idle {100 * row.get('eager_idle_share', float('nan')):.1f}%")
    del cache, lg
    _free(dev)

    # -- decode against the forward at fp32, sections differing ---------
    seq = torch.tensor(rng.integers(1, cfg.vocab, (1, LM_CHECK_SEQ)),
                       device=dev)
    chk3 = torch.tensor(_mrope_positions(1, LM_CHECK_SEQ, (8, 4, 4)),
                        device=dev)
    cache = model.init_cache(1, LM_CHECK_SEQ, dtype=torch.float32,
                             device=dev)
    dec = []
    for t in range(LM_CHECK_SEQ):
        lg, cache = model.decode_step(
            params, cache, seq[:, t],
            torch.full((1,), t, dtype=torch.int32, device=dev),
            positions3=chk3[:, :, t:t + 1], compute_dtype=torch.float32)
        dec.append(lg)
    dec = torch.stack(dec, 1)
    with torch.inference_mode():
        h = transformer.forward_hidden(cfg, params, seq, positions3=chk3,
                                       compute_dtype=torch.float32,
                                       remat="none")
        full = transformer._logits(cfg, params, h)
    worst = float(((dec - full).abs() / (LM_DEC_TOL + LM_DEC_TOL
                                         * full.abs())).max())
    row["decode_vs_forward_worst"] = worst
    log(f"18 {VLM_ARCH}: decode vs forward at fp32 over {LM_CHECK_SEQ} "
        f"tokens (a 4 x 4 image's positions3 at token 8): worst "
        f"|d|/(atol+rtol|ref|) {worst:.3g} (rtol = atol = {LM_DEC_TOL})")
    if not worst <= 1.0:
        raise AssertionError(f"18 {VLM_ARCH}: decode off the forward")
    row["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else None)
    row["seconds"] = time.perf_counter() - t_case
    log(f"18 {VLM_ARCH} ({cfg.n_layers} layers, {n_params} params): peak "
        f"{row['peak_gib']} GiB; {row['seconds']:.1f} s")
    return row


def moe_phase(dev) -> dict:
    """Phase 18: mixtral-8x22b (4 of 56 layers, fp32) and arctic-480b (2
    of 35 layers, bf16 under 'lean') at their published widths through
    the graphed `SlotServer`, as phase 17 serves its models (`_lm_case`);
    then qwen2-vl-2b at full width and depth through the prefill and
    serve steps (`_vlm_case`). Each model is freed before the next. The
    numbers join the `lm_serve` line, one entry an arch."""
    t_phase = time.perf_counter()
    out = {}
    for arch, layers, slots, n_req in MOE_CASES:
        out[arch] = _lm_case(dev, arch, slots, n_req, layers=layers,
                             prompt=MOE_PROMPT, phase="18")
        _free(dev)
    out[VLM_ARCH] = _vlm_case(dev)
    _free(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 took {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 19: SSM, hybrid and encoder-decoder serving at full width
# ---------------------------------------------------------------------------

# (arch, slots, requests) at full width and depth, through the graphed
# server: mamba2-1.3b's 48 layers (1,343,740,928 fp32 params) and
# recurrentgemma-2b's 26 (2,894,574,080)
REC_CASES = (("mamba2-1.3b", 8, 16), ("recurrentgemma-2b", 8, 16))
REC_PROMPT = (32, 64)      # as phase 18's: the server feeds one token a step
REC_ALONE = (0, -1)        # requests served again alone in fresh servers:
                           # the first and the last (which takes a slot an
                           # earlier request used)
REC_CHECK_BATCH = 2        # decode against the fp32 forward: B = 2, S = 32
REC_PREFILL = (4, 1024)    # build_prefill_step: batch x tokens
WHISPER_ARCH = "whisper-medium"  # 24 + 24 layers, 758,469,632 fp32 params
WHISPER_BATCH = 4
WHISPER_CTX = 448          # Whisper's decoder context: the prefill's tokens
                           # and the serve cache's length


def _rec_case(dev, arch: str, slots: int, n_req: int) -> dict:
    """One recurrent model of phase 19 (see `rec_phase`); every tensor it
    makes is freed when it returns."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec

    t_case = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in
               rng.integers(REC_PROMPT[0], REC_PROMPT[1] + 1, n_req)]

    # -- the timed serve ----------------------------------------------
    srv = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                     max_gen=LM_GEN, device=dev, params=params)
    fresh = model.init_cache(slots, LM_MAX_SEQ, device=dev)
    row = {"cache_after_capture_is_init": all(
        torch.equal(a, b) for a, b in zip(tree_leaves(srv.cache),
                                          tree_leaves(fresh)))}
    if not row["cache_after_capture_is_init"]:
        raise AssertionError(f"19 {arch}: the server's cache after the "
                             "capture is not init_cache's")
    del fresh
    feed, steps_ms = [], []
    feed_prompt, step = srv._feed_prompt, srv.step

    def timed_feed(slot, req):
        t0 = time.perf_counter()
        feed_prompt(slot, req)          # ends in a host sync
        feed.append((len(req.prompt), time.perf_counter() - t0))

    def timed_step():
        s, e = _mark(dev), _mark(dev)
        s.record()
        step()                          # ends in a host sync
        e.record()
        _sync(dev)
        steps_ms.append(s.elapsed_time(e))

    srv._feed_prompt, srv.step = timed_feed, timed_step
    _sync(dev)
    t0 = time.perf_counter()
    done = srv.run([Request(i, p) for i, p in enumerate(prompts)])
    _sync(dev)
    wall = time.perf_counter() - t0
    full = {r.rid: r.generated for r in done}
    gen = sum(len(g) for g in full.values())
    prompt_tokens = sum(n for n, _ in feed)
    if len(done) != n_req or gen != n_req * LM_GEN:
        raise AssertionError(f"19 {arch}: {len(done)} of {n_req} requests, "
                             f"{gen} tokens generated")
    row.update({"layers": cfg.n_layers, "params": n_params,
                "param_dtype": "float32", "slots": slots, "requests": n_req,
                "max_seq": LM_MAX_SEQ, "prompt_tokens": prompt_tokens,
                "generated_tokens": gen, "wall_s": wall,
                "tokens_per_s": gen / wall,
                "all_tokens_per_s": (gen + prompt_tokens) / wall,
                "decode_steps": len(steps_ms),
                "decode_ms_median": statistics.median(steps_ms),
                "decode_ms_min": min(steps_ms),
                "prefill_ms_a_token": 1e3 * sum(s for _, s in feed)
                / prompt_tokens})
    del srv, feed_prompt, step, timed_feed, timed_step
    _free(dev)

    # -- isolation: requests served alone in fresh servers --------------
    # (the same tokens wherever the alone run's top two logits are
    # further apart than LM_BF16_TOL of the largest; after a near tie the
    # two runs may part, so the comparison stops there)
    row["isolation"] = {}
    for rid in (r % n_req for r in REC_ALONE):
        one = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                         max_gen=LM_GEN, device=dev, params=params)
        calls, step = [], one._step

        def recorded(p, cache, tok, pos, step=step, calls=calls):
            logits, cache = step(p, cache, tok, pos)
            calls.append(logits[0].float().clone())   # alone: slot 0
            return logits, cache
        one._step = recorded
        alone = one.run([Request(rid, prompts[rid])])[0].generated
        S = len(prompts[rid])
        clear = equal = 0
        stopped_at = None
        for k, (a, b) in enumerate(zip(alone, full[rid])):
            lg = calls[S + k]
            top2 = torch.topk(lg, 2).values
            is_clear = float(top2[0] - top2[1]) > LM_BF16_TOL * float(
                lg.abs().max())
            if a != b:
                if is_clear:
                    raise AssertionError(
                        f"19 {arch}: request {rid} alone gives token {a} "
                        f"at {k}, the full run {b}, a clear position")
                stopped_at = k
                break
            clear += is_clear
            equal += 1
        row["isolation"][str(rid)] = {"equal": equal, "clear": clear,
                                      "stopped_at_near_tie": stopped_at,
                                      "tokens": len(alone)}
        log(f"19 {arch}: request {rid} served alone in a fresh server: "
            f"{equal} of {len(alone)} tokens equal to the full run's "
            f"({clear} of them clear)"
            + ("" if stopped_at is None else
               f"; a near tie at {stopped_at}, compared no further"))
        if equal < LM_GEN // 2 and stopped_at is None:
            raise AssertionError(f"19 {arch}: isolation compared too few "
                                 "tokens")
        del one, calls, step, recorded
        _free(dev)

    # -- one decode step at B = slots: eager against the captured graph --
    graphed = SlotServer(model, slots=slots, max_seq=LM_MAX_SEQ, eos=None,
                         max_gen=1, device=dev, params=params)
    cache = model.init_cache(slots, LM_MAX_SEQ, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(1, cfg.vocab, (slots,), generator=g, device=dev,
                        dtype=torch.int32)
    pos = torch.arange(slots, dtype=torch.int32, device=dev) + REC_PROMPT[0]
    run_e = lambda: model.decode_step(params, cache, tok, pos)[0]  # noqa: E731
    run_g = lambda: graphed._step(params, graphed.cache, tok, pos)[0]  # noqa: E731
    row["graph_equals_eager"] = bool(torch.equal(run_e(), run_g()))
    if not row["graph_equals_eager"]:
        raise AssertionError(f"19 {arch}: the server's decode step's logits "
                             "differ from the eager step's")
    if dev.type == "cuda":
        row["eager_decode_ms"] = cuda_ms(run_e, 10)
        row["graph_decode_ms"] = cuda_ms(run_g, 10)
        row["device_busy_ms"] = device_split(row, run_e, reps=5, names=None,
                                             need=("all",))["all"]
        row["eager_idle_share"] = 1 - row["device_busy_ms"] / row[
            "eager_decode_ms"]
        log(f"19 {arch}: one decode step at B={slots}: eager "
            f"{row['eager_decode_ms']:.2f} ms, CUDA graph "
            f"{row['graph_decode_ms']:.2f} ms (the same bits), the kernels' "
            f"device time {row['device_busy_ms']:.2f} ms (profiler): the "
            f"eager step leaves the card idle "
            f"{100 * row['eager_idle_share']:.1f}% of its time")
    del graphed, cache, run_e, run_g
    _free(dev)

    # -- decode against the forward at fp32 -----------------------------
    seq = torch.tensor(np.stack([p[:LM_CHECK_SEQ] for p in
                                 prompts[:REC_CHECK_BATCH]]), device=dev)
    with torch.inference_mode():
        h = model.mod.forward_hidden(cfg, params, seq,
                                     compute_dtype=torch.float32,
                                     remat="none")
        full32 = h @ params["embed"].T
    cache = model.init_cache(REC_CHECK_BATCH, LM_CHECK_SEQ,
                             dtype=torch.float32, device=dev)
    dec = torch.stack([model.decode_step(
        params, cache, seq[:, t],
        torch.full((REC_CHECK_BATCH,), t, dtype=torch.int32, device=dev),
        compute_dtype=torch.float32)[0] for t in range(LM_CHECK_SEQ)], 1)
    worst = float(((dec - full32).abs() / (LM_DEC_TOL + LM_DEC_TOL
                                           * full32.abs())).max())
    row["decode_vs_forward_worst"] = worst
    log(f"19 {arch}: decode vs forward at fp32, B={REC_CHECK_BATCH} over "
        f"{LM_CHECK_SEQ} tokens: worst |d|/(atol+rtol|ref|) {worst:.3g} "
        f"(rtol = atol = {LM_DEC_TOL})")
    if not worst <= 1.0:
        raise AssertionError(f"19 {arch}: decode off the forward")
    del cache, dec, h, full32
    _free(dev)

    # -- the prefill step over long prompts -----------------------------
    B, S = REC_PREFILL
    pstep = steps.build_prefill_step(model, ShapeSpec(
        "prefill_1k", S, B, "prefill"))
    batch = {"tokens": torch.tensor(rng.integers(1, cfg.vocab, (B, S)),
                                    device=dev)}
    logits = pstep(params, batch)
    if not (tuple(logits.shape) == (B, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"19 {arch}: the prefill step's logits: "
                             f"{tuple(logits.shape)}")
    s, e = _mark(dev), _mark(dev)
    s.record()
    pstep(params, batch)
    e.record()
    _sync(dev)
    row["prefill_step_ms"] = s.elapsed_time(e)
    row["prefill_step_tokens_per_s"] = B * S / (row["prefill_step_ms"] / 1e3)
    log(f"19 {arch}: build_prefill_step on {B} x {S} tokens"
        + (f" (the chunked SSD, chunk {cfg.ssm_chunk})"
           if cfg.family == "ssm" else "")
        + f": {row['prefill_step_ms']:.2f} ms "
        f"({row['prefill_step_tokens_per_s']:.0f} tokens/s)")
    del batch, logits
    row["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else None)
    row["seconds"] = time.perf_counter() - t_case
    log(f"19 {arch} ({cfg.n_layers} layers, {n_params} params): {n_req} "
        f"requests, {prompt_tokens} prompt + {gen} generated tokens in "
        f"{wall:.2f} s ({row['tokens_per_s']:.1f} generated tokens/s); "
        f"decode {row['decode_ms_median']:.2f} ms a step at B={slots} "
        f"(median of {len(steps_ms)}, min {row['decode_ms_min']:.2f}); the "
        f"server's prefill {row['prefill_ms_a_token']:.2f} ms a prompt "
        f"token; peak {row['peak_gib']} GiB; {row['seconds']:.1f} s")
    return row


def _whisper_case(dev) -> dict:
    """whisper-medium at full width and depth (random fp32 weights, seed
    0): `encode` of WHISPER_BATCH x 1500 seeded frame embeddings,
    `build_cross_cache`, LM_GEN greedy eager `build_serve_step`s; decode
    against `decode_hidden`'s fp32 forward; `build_prefill_step` with
    frames on WHISPER_BATCH x WHISPER_CTX tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import build_model, whisper
    from repro_torch.models.config import ShapeSpec

    t_case = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g)
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, Se = WHISPER_BATCH, cfg.encoder_seq
    frames = torch.randn((B, Se, cfg.d_model), generator=g, device=dev)
    row = {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "params": n_params, "param_dtype": "float32", "batch": B,
           "frames": Se, "max_seq": WHISPER_CTX}

    def timed(fn):
        s, e = _mark(dev), _mark(dev)
        s.record()
        out = fn()
        e.record()
        _sync(dev)
        return out, s.elapsed_time(e)

    # -- encode, the cross K/V, LM_GEN greedy serve steps ----------------
    with torch.inference_mode():
        whisper.encode(cfg, params, frames)          # warm-up
        enc, row["encode_ms"] = timed(
            lambda: whisper.encode(cfg, params, frames))
    if not (tuple(enc.shape) == (B, Se, cfg.d_model)
            and bool(torch.isfinite(enc).all())):
        raise AssertionError(f"19 {WHISPER_ARCH}: the encoder output")
    cache = model.init_cache(B, WHISPER_CTX, device=dev)
    _, row["cross_cache_ms"] = timed(
        lambda: whisper.build_cross_cache(cfg, params, enc, cache))
    serve = steps.build_serve_step(model, ShapeSpec(
        "decode", WHISPER_CTX, B, "decode"))
    tok = torch.randint(1, cfg.vocab, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    steps_ms, generated = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        pos = torch.full((B,), i, dtype=torch.int32, device=dev)
        (tok, cache), ms = timed(lambda: serve(params, cache, tok, pos))
        steps_ms.append(ms)
        generated.append(tok)
    wall = time.perf_counter() - t0
    gen = torch.stack(generated, 1)
    if not (tuple(gen.shape) == (B, LM_GEN)
            and bool(((gen >= 0) & (gen < cfg.vocab)).all())):
        raise AssertionError(f"19 {WHISPER_ARCH}: the serve steps' tokens")
    row.update({"generated_tokens": B * LM_GEN, "decode_steps": LM_GEN,
                "wall_s": wall, "tokens_per_s": B * LM_GEN / wall,
                "decode_ms_median": statistics.median(steps_ms),
                "decode_ms_min": min(steps_ms)})
    if dev.type == "cuda":
        pos = torch.full((B,), LM_GEN, dtype=torch.int32, device=dev)
        run_e = lambda: serve(params, cache, tok, pos)[0]  # noqa: E731
        row["eager_decode_ms"] = cuda_ms(run_e, 10)
        row["device_busy_ms"] = device_split(row, run_e, reps=5, names=None,
                                             need=("all",))["all"]
        row["eager_idle_share"] = 1 - row["device_busy_ms"] / row[
            "eager_decode_ms"]
    log(f"19 {WHISPER_ARCH}: encode {B} x {Se} frames {row['encode_ms']:.2f} "
        f"ms, the cross K/V {row['cross_cache_ms']:.2f} ms, then {LM_GEN} "
        f"eager serve steps at B={B}: {row['decode_ms_median']:.2f} ms a "
        f"step (median), {row['tokens_per_s']:.1f} generated tokens/s; the "
        f"kernels' device time {row.get('device_busy_ms', float('nan')):.2f}"
        f" ms a step, idle "
        f"{100 * row.get('eager_idle_share', float('nan')):.1f}%")
    del cache, enc, gen, generated
    _free(dev)

    # -- decode against decode_hidden at fp32 ---------------------------
    n = REC_CHECK_BATCH
    seq = torch.randint(1, cfg.vocab, (n, LM_CHECK_SEQ), generator=g,
                        device=dev)
    with torch.inference_mode():
        enc32 = whisper.encode(cfg, params, frames[:n],
                               compute_dtype=torch.float32, remat="none")
        h = whisper.decode_hidden(cfg, params, seq, enc32,
                                  compute_dtype=torch.float32, remat="none")
        full32 = h @ params["embed"].T
    cache = whisper.build_cross_cache(
        cfg, params, enc32, model.init_cache(n, LM_CHECK_SEQ,
                                             dtype=torch.float32, device=dev),
        compute_dtype=torch.float32)
    dec = torch.stack([model.decode_step(
        params, cache, seq[:, t],
        torch.full((n,), t, dtype=torch.int32, device=dev),
        compute_dtype=torch.float32)[0] for t in range(LM_CHECK_SEQ)], 1)
    worst = float(((dec - full32).abs() / (LM_DEC_TOL + LM_DEC_TOL
                                           * full32.abs())).max())
    row["decode_vs_forward_worst"] = worst
    log(f"19 {WHISPER_ARCH}: decode vs decode_hidden at fp32, B={n} over "
        f"{LM_CHECK_SEQ} tokens: worst |d|/(atol+rtol|ref|) {worst:.3g} "
        f"(rtol = atol = {LM_DEC_TOL})")
    if not worst <= 1.0:
        raise AssertionError(f"19 {WHISPER_ARCH}: decode off the forward")
    del cache, dec, h, full32, enc32
    _free(dev)

    # -- the prefill step with frames -----------------------------------
    pstep = steps.build_prefill_step(model, ShapeSpec(
        "prefill_448", WHISPER_CTX, B, "prefill"))
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, WHISPER_CTX),
                                     generator=g, device=dev),
             "frames": frames}
    logits = pstep(params, batch)
    if not (tuple(logits.shape) == (B, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"19 {WHISPER_ARCH}: the prefill step's "
                             f"logits: {tuple(logits.shape)}")
    _, row["prefill_step_ms"] = timed(lambda: pstep(params, batch))
    row["prefill_step_tokens_per_s"] = B * WHISPER_CTX / (
        row["prefill_step_ms"] / 1e3)
    row["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else None)
    row["seconds"] = time.perf_counter() - t_case
    log(f"19 {WHISPER_ARCH}: build_prefill_step with frames on {B} x "
        f"{WHISPER_CTX} tokens: {row['prefill_step_ms']:.2f} ms "
        f"({row['prefill_step_tokens_per_s']:.0f} tokens/s); "
        f"{cfg.encoder_layers} + {cfg.n_layers} layers, {n_params} params; "
        f"peak {row['peak_gib']} GiB; {row['seconds']:.1f} s")
    return row


def rec_phase(dev) -> dict:
    """Phase 19: mamba2-1.3b and recurrentgemma-2b at full width and depth
    through the graphed `SlotServer` (the timed serve, the cache after
    the capture equal to init_cache, two requests served alone in fresh
    servers against the full run, graph = eager, decode against the fp32
    forward, the prefill step on 4 x 1024 tokens); then whisper-medium
    through `encode`, `build_cross_cache` and the serve and prefill
    steps (`_whisper_case`). Each model is freed before the next. The
    numbers join the `lm_serve` line, one entry an arch."""
    t_phase = time.perf_counter()
    out = {}
    for arch, slots, n_req in REC_CASES:
        out[arch] = _rec_case(dev, arch, slots, n_req)
        _free(dev)
    out[WHISPER_ARCH] = _whisper_case(dev)
    _free(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 took {out['seconds']:.1f}s")
    return out


def _leaf_names(tree, prefix=()):
    """Key paths of a nested dict's leaves in sorted-key order."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += _leaf_names(tree[key], prefix + (key,))
        else:
            out.append(prefix + (key,))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import rp
    from repro_torch.core import theory
    from repro_torch import kernels
    from repro_torch.kernels import _sweep, ops
    from repro_torch.serve import (ServeConfig, SketchServer, SketchStore,
                                   replay, synth_trace)

    # -- 1. device --------------------------------------------------------
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _sweep.build()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions ------------------------------------
    errs: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def hold(family, dims, k, rank, b, tag):
        op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank),
                               seed=7, device=dev)
        cores = kernel_operands(op, family)
        scale = 1.0 / math.sqrt(k)
        x = torch.randn((b,) + dims, generator=gen, device=dev)
        pplan = ops.plan_contraction(family, "project", k, b, dims, rank)
        got = _sweep.sweep_project(x, *cores, plan=pplan, scale=scale)
        ref = _sweep.sweep_project_plain(x, *cores, steps=pplan.steps,
                                         scale=scale)
        key = f"sweep_project:{family}"
        errs[key] = max(errs.get(key, 0.0),
                        check(f"K1 {family} {tag} dims={dims} k={k} "
                              f"R={rank} B={b}", got, ref))
        if not torch.equal(got, _sweep.sweep_project(x, *cores, plan=pplan,
                                                     scale=scale)):
            raise AssertionError(f"K1 {family} {tag}: a second call on the "
                                 "same inputs gave other bits")
        y = torch.randn((b, k), generator=gen, device=dev)
        rplan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
        got = _sweep.sweep_reconstruct(y, *cores, plan=rplan, scale=scale)
        ref = _sweep.sweep_reconstruct_plain(y, *cores, steps=rplan.steps,
                                             scale=scale)
        key = f"sweep_reconstruct:{family}"
        errs[key] = max(errs.get(key, 0.0),
                        check(f"K2 {family} {tag} dims={dims} k={k} "
                              f"R={rank} B={b}", got, ref))
        if not torch.equal(got, _sweep.sweep_reconstruct(
                y, *cores, plan=rplan, scale=scale)):
            raise AssertionError(f"K2 {family} {tag}: a second call on the "
                                 "same inputs gave other bits")
        torch.cuda.synchronize()

    for family in ("tt", "cp"):
        for order, dims in SMALL_DIMS.items():
            hold(family, dims, 37, 3, 3, f"order {order}")
        hold(family, (4, 4, 4, 4, 4, 4), 20, 2, 3, "order 6")
        hold(family, SLICE_DIMS, SLICE_K, SLICE_RANKS[family], 64, "slice")
        torch.cuda.empty_cache()

    # -- 3b. K3 / K6 / K5 vs plain versions -------------------------------
    from repro_torch.core import (BatchedCPTensor, random_cp, random_tt,
                                  stack_ragged_cp, stack_ragged_tt)
    from repro_torch.kernels import struct
    from repro_torch.kernels.struct import carry
    from repro_torch.kernels.struct import plan as splan

    def struct_batch(in_family, dims, ranks, b, weights=False, norm=None):
        mk = random_tt if in_family == "tt" else random_cp
        items = [mk(gen, dims, ranks[i % len(ranks)], norm=norm)
                 for i in range(b)]
        if in_family == "tt":
            return stack_ragged_tt(items)
        xb = stack_ragged_cp(items)
        if weights:
            xb = BatchedCPTensor(xb.factors, torch.rand(
                (b, xb.rank), generator=gen, device=dev) + 0.5)
        return xb

    def hold_carry(of, inf, dims, k, r_op, ranks, b, tag, weights=False,
                   double=True, twice=False):
        op = rp.make_projector(rp.ProjectorSpec(of, k, dims, r_op), seed=9,
                               device=dev)
        xb = struct_batch(inf, dims, ranks, b, weights)
        cores, n_op = struct_operands(op, of, xb, inf)
        r_in = struct.struct_rank(xb)
        scale = 1.0 / math.sqrt(k)
        kernels_ = [("carry_sweep_project", "K3", "serial",
                     carry.carry_sweep_project)]
        if double:
            kernels_.append(("carry_sweep_project_pipelined", "K6", "double",
                             carry.carry_sweep_project_pipelined))
        ref = None
        what = (f"{of}x{inf} {tag} dims={dims} k={k} R={r_op} "
                f"ranks={ranks} B={b}{' weighted' if weights else ''}")
        got = []
        for key, name, pipeline, fn in kernels_:
            plan = splan.plan_carry_sweep(of, inf, k, b, dims, r_op, r_in,
                                          pipeline=pipeline)
            if ref is None:
                ref = carry.carry_sweep_project_plain(
                    *cores, n_op=n_op, program=plan.program, scale=scale)
            y = fn(*cores, n_op=n_op, plan=plan, scale=scale)
            key = f"{key}:{of}x{inf}"
            errs[key] = max(errs.get(key, 0.0),
                            check(f"{name} {what}", y, ref))
            if twice and not torch.equal(y, fn(*cores, n_op=n_op, plan=plan,
                                               scale=scale)):
                raise AssertionError(f"{name} {what}: a second call on the "
                                     "same inputs gave other bits")
            got.append(y)
        if double:
            check(f"K6 vs K3 {what}", got[1], got[0])
        torch.cuda.synchronize()

    for of, inf in PAIRINGS:
        for order, dims in SMALL_CARRY_DIMS.items():
            hold_carry(of, inf, dims, 37, 3, (2, 3, 4), 3, f"order {order}",
                       weights=inf == "cp" and order % 2 == 0)
        # the serving shapes: a serve tick's B=8 bucket and B=64, each
        # twice for the same bits
        for b in (8, 64):
            hold_carry(of, inf, SLICE_DIMS, SLICE_K, SLICE_RANKS[of], (4,),
                       b, "slice", twice=True)
        # bonds of any size are more register tiles: TT(16)/CP(16) on
        # rank-16 inputs, and rank 17-24 inputs
        hold_carry(of, inf, (8, 8, 8), 37, 16, (16,), 3, "bond 16",
                   twice=True)
        hold_carry(of, inf, (6, 5, 7), 37, SLICE_RANKS[of], (17, 20, 24), 5,
                   "input ranks 17-24", twice=True)
    log("K3 and K6 gave the same bits on every second call")
    # a TT(180) operator: one value of d of its interior core row does not
    # fit twice in a block, so K3 stages it 155 bond rows a chunk
    hold_carry("tt", "tt", (3, 3, 3), 8, 180, (2, 3, 4), 3,
               "operator bond 180", double=False)
    # a TT(25) interior core row of 320 KB: K3 stages it a few values of d
    # at a time; K6, which holds a k-tile's operator cores whole, refuses it
    try:
        splan.plan_carry_sweep("tt", "tt", 37, 3, (8, 128, 64), 25, 4,
                               pipeline="double")
    except ValueError as e:
        log(f"K6 refuses TT(25) over a mode of 128: {e}")
    else:
        raise AssertionError("K6 planned an operator core row of 320 KB")
    hold_carry("tt", "tt", (8, 128, 64), 37, 25, (2, 3, 4), 3,
               "operator core row of 320 KB", double=False)

    def hold_k5(family, dims, k, rank, b, tag):
        op = rp.make_projector(rp.ProjectorSpec(family, k, dims, rank),
                               seed=7, device=dev)
        cores = kernel_operands(op, family)
        x = torch.randn((b,) + dims, generator=gen, device=dev)
        p1 = ops.plan_contraction(family, "project", k, b, dims, rank)
        p5 = ops.plan_contraction(family, "project", k, b, dims, rank,
                                  pipeline="double")
        scale = 1.0 / math.sqrt(k)
        y5 = _sweep.sweep_project_pipelined(x, *cores, plan=p5, scale=scale)
        ref = _sweep.sweep_project_pipelined_plain(
            x, *cores, steps=p5.steps, ba=p5.ba, scale=scale)
        key = f"sweep_project_pipelined:{family}"
        what = f"{family} {tag} dims={dims} k={k} R={rank} B={b}"
        errs[key] = max(errs.get(key, 0.0), check(f"K5 {what}", y5, ref))
        check(f"K5 vs K1 {what}", y5,
              _sweep.sweep_project(x, *cores, plan=p1, scale=scale))
        torch.cuda.synchronize()

    for family in ("tt", "cp"):
        for order, dims in SMALL_DIMS.items():
            hold_k5(family, dims, 37, 3, 3, f"order {order}")
        hold_k5(family, SLICE_DIMS, SLICE_K, SLICE_RANKS[family], 64,
                "slice")
        # ragged: orders 2 and 8, k = 37, T ragged against every chunk,
        # ranks above 8, B in {1, 3, 64}
        for dims, rank in RAGGED_PROJECT:
            for b in (1, 3, 64):
                hold(family, dims, 37, rank, b, "ragged")
                hold_k5(family, dims, 37, rank, b, "ragged")
    log("K1 and K2 gave the same bits on every second call")
    torch.cuda.empty_cache()

    # -- 4./5. serve dense traffic ----------------------------------------
    class TimedServer(SketchServer):
        """Records CUDA events around every tick that served requests."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.tick_events = []
            self.tick_structures = []
            self.tick_sizes = []

        def tick(self, now, *, force=False):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            before = rp.dispatch_breakdown()
            s.record()
            n = super().tick(now, force=force)
            e.record()
            if n:
                self.tick_events.append((s, e))
                self.tick_sizes.append(n)
                after = rp.dispatch_breakdown()
                self.tick_structures.append(next(
                    key[1] for key, c in after.items()
                    if c != before.get(key, 0)))
            return n

    launches = {"sweep_project": 0, "sweep_reconstruct": 0,
                "sweep_project_pipelined": 0, "carry_sweep_project": 0,
                "carry_sweep_project_pipelined": 0, "fused_update": 0}
    per_family = {}
    stores = {}

    def serve(family, n_requests):
        spec = rp.ProjectorSpec(family=family, k=SLICE_K, dims=SLICE_DIMS,
                                rank=SLICE_RANKS[family])
        store = SketchStore(spec, device=dev)
        server = TimedServer(ServeConfig(max_batch=64, flush_us=1000.0),
                             store, device=dev)
        trace = synth_trace(n_requests, [(spec, 0)], mix=(1.0, 0.0, 0.0),
                            mean_gap_us=200.0, seed=0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with rp.dispatch_stats() as st:
            report = replay(server, trace)
            torch.cuda.synchronize()
        k1 = _sweep.sweep_project.launches
        ticks = report["ticks"]
        if report["requests_done"] != n_requests:
            raise AssertionError(f"{report['requests_done']} of "
                                 f"{n_requests} requests served")
        if k1 != ticks or st.kernel_calls != ticks:
            raise AssertionError(f"{family}: K1 launches {k1}, "
                                 f"kernel_call_count {st.kernel_calls}, "
                                 f"ticks {ticks}")
        launches["sweep_project"] += k1
        per_family[f"sweep_project:{family}"] = k1
        dev_ms = [s.elapsed_time(e) for s, e in server.tick_events]
        log(f"serve {family.upper()}(R={spec.rank}) k={spec.k} dims="
            f"{spec.dims}: {n_requests} requests, {ticks} ticks, K1 "
            f"launches {k1} == kernel_call_count {st.kernel_calls} == "
            f"ticks; p50={report['p50_us']:.1f}us p99="
            f"{report['p99_us']:.1f}us (trace clock) occupancy="
            f"{report['occupancy_mean']:.3f} cache hit rate="
            f"{report['cache']['hit_rate']:.4f} wall={report['wall_s']:.3f}s"
            f" device ms/tick mean={sum(dev_ms) / len(dev_ms):.3f} "
            f"median={statistics.median(dev_ms):.3f} max={max(dev_ms):.3f}")
        # served sketches agree with the operator's einsum route
        op = server.cache.get(spec, 0)
        rows = [r for r in server.done if r.rid < 8]
        xs = torch.stack([rp.dispatch._coerce_dense(
            op, torch.as_tensor(trace[r.rid].payload, device=dev))
            for r in rows])
        check(f"served {family} sketches vs op.project",
              torch.stack([store.get(r.store_id) for r in rows]),
              op.project(xs))
        res = server.query(store.get(0), top_m=5)
        if int(res.ids[0]) != 0 or not math.isfinite(float(res.dist2[-1])):
            raise AssertionError(f"query of sketch 0 returned {res.ids}")
        pw = server.pairwise([0], [int(res.ids[-1])])
        log(f"query top-5 of sketch 0: ids {res.ids.tolist()} d2 "
            f"{[round(float(d), 2) for d in res.dist2]}; pairwise d2="
            f"{pw.dist2[0]:.2f} in [{pw.dist2_lo[0]:.2f}, "
            f"{pw.dist2_hi[0]:.2f}] (eps={pw.eps:.3f} @ delta={pw.delta})")
        stores[family] = (op, store)

    serve("tt", 1024)
    serve("cp", 256)

    # -- 5b. serve mixed dense/TT/CP traffic ------------------------------
    from repro_torch.core import CPTensor, TTTensor

    def on_card(x):
        if isinstance(x, TTTensor):
            return TTTensor(tuple(c.to(dev) for c in x.cores))
        return CPTensor(tuple(f.to(dev) for f in x.factors),
                        None if x.weights is None else x.weights.to(dev))

    from repro_torch.rp.plan import pow2ceil
    tick_ms = {}

    def serve_mixed(family, n_requests):
        spec = rp.ProjectorSpec(family=family, k=SLICE_K, dims=SLICE_DIMS,
                                rank=SLICE_RANKS[family])
        store = SketchStore(spec, device=dev)
        server = TimedServer(ServeConfig(max_batch=64, flush_us=1000.0),
                             store, device=dev)
        trace = synth_trace(n_requests, [(spec, 0)], mix=(1.0, 1.0, 1.0),
                            ranks=(2, 3, 4), mean_gap_us=200.0, seed=0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with rp.dispatch_stats() as st:
            report = replay(server, trace)
            torch.cuda.synchronize()
        k1 = _sweep.sweep_project.launches
        k3 = carry.carry_sweep_project.launches
        ticks = report["ticks"]
        by = {t: server.tick_structures.count(t) for t in ("dense", "tt",
                                                           "cp")}
        if report["requests_done"] != n_requests:
            raise AssertionError(f"{report['requests_done']} of "
                                 f"{n_requests} requests served")
        if (k1 != by["dense"] or k3 != by["tt"] + by["cp"]
                or st.kernel_calls != ticks or sum(by.values()) != ticks
                or min(by.values()) == 0):
            raise AssertionError(
                f"mixed {family}: ticks {ticks} {by}, K1 launches {k1}, K3 "
                f"launches {k3}, kernel_call_count {st.kernel_calls}")
        # the batch bucket of each K3 launch: a tick of n items is padded
        # to pow2ceil(n, 8) (rp/many.py); launches at the B=8 bucket go to
        # the B=8 rows of phase 7, any larger bucket to the B=64 rows
        k3_batches = [pow2ceil(n, 8) for n, t in zip(
            server.tick_sizes, server.tick_structures) if t != "dense"]
        buckets = {b: k3_batches.count(b) for b in sorted(set(k3_batches))}
        structured = [t for t in server.tick_structures if t != "dense"]
        for inf in ("tt", "cp"):
            small = sum(b <= 8 for b, t in zip(k3_batches, structured)
                        if t == inf)
            per_family[f"carry_sweep_project:{family}x{inf}:b8"] = small
            per_family[f"carry_sweep_project:{family}x{inf}"] = (
                by[inf] - small)
        log(f"mixed {family}: K3 launches by batch bucket {buckets}")
        launches["carry_sweep_project"] += k3
        ms = {t: [] for t in by}
        for (s, e), t in zip(server.tick_events, server.tick_structures):
            ms[t].append(s.elapsed_time(e))
        per_tick = ", ".join(f"{t} {by[t]} ticks {sum(v) / len(v):.3f} ms "
                             f"(median {statistics.median(v):.3f})"
                             for t, v in ms.items())
        log(f"serve mixed {family.upper()}(R={spec.rank}) k={spec.k} dims="
            f"{spec.dims}: {n_requests} requests, {ticks} ticks ({by}); K1 "
            f"launches {k1} == dense ticks, K3 launches {k3} == TT+CP ticks,"
            f" kernel_call_count {st.kernel_calls} == ticks; p50="
            f"{report['p50_us']:.1f}us p99={report['p99_us']:.1f}us (trace "
            f"clock) occupancy={report['occupancy_mean']:.3f} cache hit "
            f"rate={report['cache']['hit_rate']:.4f} wall="
            f"{report['wall_s']:.3f}s; device ms/tick by structure: "
            f"{per_tick}")
        tick_ms[family] = {t: sum(v) / len(v) for t, v in ms.items()}
        op = server.cache.get(spec, 0)
        # served sketches against the plain versions on the same operator
        for tag in ("dense", "tt", "cp"):
            rows = [r for r in server.done
                    if rp.structure_tag(trace[r.rid].payload) == tag][:8]
            if tag == "dense":
                want = op.project(torch.stack([rp.dispatch._coerce_dense(
                    op, torch.as_tensor(trace[r.rid].payload, device=dev))
                    for r in rows]))
            else:
                want = torch.stack([struct.struct_project(
                    op, on_card(trace[r.rid].payload), use_kernel=False)
                    for r in rows])
            check(f"served mixed {family} {tag} sketches vs plain", torch.stack(
                [store.get(r.store_id) for r in rows]), want)

    serve_mixed("tt", 1024)
    serve_mixed("cp", 256)

    # -- 6. reconstruct stored sketches -----------------------------------
    outs = {}
    for family, (op, store) in stores.items():
        y = store.get(range(64))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with rp.dispatch_stats() as st:
            outs[family] = rp.reconstruct(op, y)
            torch.cuda.synchronize()
        k2 = _sweep.sweep_reconstruct.launches
        if (k2 != 1 or st.kernel_calls != 1
                or _sweep.sweep_project.launches != 0):
            raise AssertionError(
                f"reconstruct {family}: K2 launches {k2}, K1 launches "
                f"{_sweep.sweep_project.launches}, kernel_call_count "
                f"{st.kernel_calls}; expected one K2 launch")
        launches["sweep_reconstruct"] += k2
        per_family[f"sweep_reconstruct:{family}"] = k2
        plan = ops.plan_contraction(family, "reconstruct", op.k, 64,
                                    op.in_dims, op.rank)
        ref = _sweep.sweep_reconstruct_plain(
            y, *kernel_operands(op, family), steps=plan.steps,
            scale=1.0 / math.sqrt(op.k))
        check(f"reconstruct {family} (64, {op.k}) -> "
              f"{tuple(outs[family].shape)}", outs[family], ref)
        log(f"reconstruct {family}: K2 launches {k2} == kernel_call_count "
            f"{st.kernel_calls}")
    del outs
    torch.cuda.empty_cache()

    # -- 6b. pipeline="double": K5 (dense) and K6 (structured) ------------
    for family, (op, _) in stores.items():
        batches = [("dense", torch.randn((64,) + op.in_dims, generator=gen,
                                         device=dev))]
        batches += [(inf, struct_batch(inf, op.in_dims, (4,), 64))
                    for inf in ("tt", "cp")]
        for tag, x in batches:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with rp.dispatch_stats() as st:
                got = rp.project(op, x, pipeline="double")
                torch.cuda.synchronize()
            counts = (_sweep.sweep_project_pipelined.launches,
                      carry.carry_sweep_project_pipelined.launches,
                      _sweep.sweep_project.launches,
                      carry.carry_sweep_project.launches)
            want = (1, 0, 0, 0) if tag == "dense" else (0, 1, 0, 0)
            if counts != want or st.kernel_calls != 1:
                raise AssertionError(
                    f"pipeline='double' {family} {tag}: (K5, K6, K1, K3) "
                    f"launches {counts}, expected {want}")
            name = ("sweep_project_pipelined:" + family if tag == "dense"
                    else f"carry_sweep_project_pipelined:{family}x{tag}")
            per_family[name] = 1
            launches[name.split(":")[0]] += 1
            check(f"rp.project {family} {tag} B=64 pipeline='double' vs "
                  "'serial'", got, rp.project(op, x))
            log(f"pipeline='double' {family} {tag}: (K5, K6, K1, K3) "
                f"launches {counts}")
    torch.cuda.empty_cache()

    # -- 7. times at the serving shapes -----------------------------------
    rows = []

    def time_row(key, program_flops, cheaper_flops, nbytes, kern, plain,
                 library, shape, reps=20, timer=cuda_ms):
        """Time one kernel beside its plain version and one torch.einsum
        (with `timer`); the bound takes the cheaper of the program's and
        the other route's flops."""
        name = key.split(":")[0]
        ms = timer(kern, reps=reps)
        plain_ms = timer(plain, reps=5, warmup=1)
        torch.cuda.empty_cache()
        library_ms = timer(library, reps=5, warmup=1)
        torch.cuda.empty_cache()
        flops = min(program_flops, cheaper_flops)
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        program_bound_ms = max(program_flops / PEAK_FP32 * 1e3, t_bytes)
        row = {"name": key, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name],
               "launches": per_family.get(key, 0),
               "max_abs_err": errs[key], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": library_ms, "shape": shape,
               "flops": flops, "bytes": nbytes,
               "program_flops": program_flops,
               "program_bound_ms": program_bound_ms}
        route = "program" if flops == program_flops else "cheaper"
        log(f"time {key} {shape}: kernel {ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({row['bound_by']}, {flops:.4g} flops by "
            f"the {route} route; {100 * bound_ms / ms:.1f}% of the "
            f"kernel's time), program's own bound {program_bound_ms:.3f} ms "
            f"({program_flops:.4g} flops), plain {plain_ms:.3f} ms, "
            f"torch.einsum {library_ms:.3f} ms")
        return row
    for family in ("tt", "cp"):
        op, store = stores[family]
        cores = kernel_operands(op, family)
        dims, k, rank, b = op.in_dims, op.k, op.rank, 64
        scale = 1.0 / math.sqrt(k)
        x = torch.randn((b,) + dims, generator=gen, device=dev)
        y = store.get(range(b))
        core_bytes = 4 * sum(c.numel() for c in cores)
        x_bytes, y_bytes = 4 * x.numel(), 4 * y.numel()
        letters = "abcdefgh"[:len(dims)]
        n_modes = len(dims)
        if family == "tt":
            bonds = "pqstuvw"
            terms = ([f"k{letters[0]}{bonds[0]}"]
                     + [f"k{bonds[i - 1]}{letters[i]}{bonds[i]}"
                        for i in range(1, n_modes - 1)]
                     + [f"k{bonds[n_modes - 2]}{letters[-1]}"])
            p_flops = theory.flops_project_dense_tt(k, dims, rank) * b
        else:
            terms = [f"k{c}r" for c in letters]
            p_flops = theory.flops_project_dense_cp(k, dims, rank) * b
        # the cheaper route at small B: the dense (k, prod(dims)) operator,
        # then one (B, D) x (D, k) product either way
        dense = (dense_operator_flops(family, k, dims, rank)
                 + 2 * b * k * math.prod(dims))
        p_spec = f"n{letters}," + ",".join(terms) + "->nk"
        r_spec = "nk," + ",".join(terms) + f"->n{letters}"
        pplan = ops.plan_contraction(family, "project", k, b, dims, rank)
        p5plan = ops.plan_contraction(family, "project", k, b, dims, rank,
                                      pipeline="double")
        rplan = ops.plan_contraction(family, "reconstruct", k, b, dims, rank)
        cases = [
            ("sweep_project", route_flops(pplan),
             x_bytes + core_bytes + y_bytes,
             lambda: _sweep.sweep_project(x, *cores, plan=pplan, scale=scale),
             lambda: _sweep.sweep_project_plain(x, *cores, steps=pplan.steps,
                                                scale=scale),
             lambda: torch.einsum(p_spec, x, *cores)),
            ("sweep_project_pipelined", route_flops(p5plan),
             x_bytes + core_bytes + y_bytes,
             lambda: _sweep.sweep_project_pipelined(x, *cores, plan=p5plan,
                                                    scale=scale),
             lambda: _sweep.sweep_project_pipelined_plain(
                 x, *cores, steps=p5plan.steps, ba=p5plan.ba, scale=scale),
             lambda: torch.einsum(p_spec, x, *cores)),
            ("sweep_reconstruct", route_flops(rplan),
             y_bytes + core_bytes + x_bytes,
             lambda: _sweep.sweep_reconstruct(y, *cores, plan=rplan,
                                              scale=scale),
             lambda: _sweep.sweep_reconstruct_plain(
                 y, *cores, steps=rplan.steps, scale=scale),
             lambda: torch.einsum(r_spec, y, *cores)),
        ]
        shape = f"B={b} k={k} dims={'x'.join(map(str, dims))} R={rank}"
        plans = {"sweep_project": pplan, "sweep_project_pipelined": p5plan,
                 "sweep_reconstruct": rplan}
        for name, program_flops, nbytes, kern, plain, library in cases:
            rows.append(time_row(f"{name}:{family}", program_flops, dense,
                                 nbytes, kern, plain, library, shape))
            plan = plans[name]
            rows[-1]["scratch_bytes"] = scratch_bytes(plan)
            rows[-1]["sweep_program_flops"] = (
                graft_flops(plan) if name == "sweep_reconstruct" else p_flops)
            split = device_split(rows[-1], kern)
            log(f"{name}:{family} device ms per call by kernel: "
                + ", ".join(f"{key} {v:.3f}" for key, v in split.items()))

    # K3 and K6 at the four pairings on the serving shapes, input rank 4,
    # at B=64 and (K3) at a serve tick's B=8 bucket; the cheaper route
    # densifies the inputs, then the cheaper dense product
    def carry_row(key, of, inf, cores, n_op, b, kern, plan, shape, scale):
        """A K3/K6 row: time, bound, plain and einsum (`time_row`), the
        kernel's device time from the profiler and the host time per
        call."""
        op_, dims = stores[of][0], SLICE_DIMS
        k, rank = op_.k, op_.rank
        dense_product = min(
            b * (theory.flops_project_dense_tt(k, dims, rank) if of == "tt"
                 else theory.flops_project_dense_cp(k, dims, rank)),
            dense_operator_flops(of, k, dims, rank)
            + 2 * b * k * math.prod(dims))
        inter = [t for pair in zip(cores[:n_op], cores[n_op:]) for t in pair]
        spec = struct_einsum_spec(of, inf, len(dims))
        run = lambda: kern(*cores, n_op=n_op, plan=plan, scale=scale)  # noqa: E731
        row = time_row(
            key, carry_flops(of, inf, cores, n_op),
            b * densify_flops(inf, dims, 4) + dense_product,
            4 * (sum(c.numel() for c in cores) + b * k), run,
            lambda: carry.carry_sweep_project_plain(
                *cores, n_op=n_op, program=plan.program, scale=scale),
            lambda: torch.einsum(spec, *inter), shape)
        device_split(row, run, names=CARRY_KERNELS, need=("carry",))
        row["host_us"] = host_us(run)
        row["tiles"] = {f: getattr(plan, f) for f in (
            "tk", "tb", "tps", "tpd", "dc", "uc", "ro", "ri", "smem_bytes")}
        log(f"{key} {shape}: device {row['device_split_ms']['carry']:.4f} ms "
            f"(profiler), host {row['host_us']:.1f} us a call, tiles "
            f"{row['tiles']}")
        return row

    for of in ("tt", "cp"):
        op, _ = stores[of]
        dims, k, rank = op.in_dims, op.k, op.rank
        scale = 1.0 / math.sqrt(k)
        for inf in ("tt", "cp"):
            for b, names in ((64, (("carry_sweep_project", "serial",
                                    carry.carry_sweep_project),
                                   ("carry_sweep_project_pipelined",
                                    "double",
                                    carry.carry_sweep_project_pipelined))),
                             (8, (("carry_sweep_project", "serial",
                                   carry.carry_sweep_project),))):
                xb = struct_batch(inf, dims, (4,), b)
                cores, n_op = struct_operands(op, of, xb, inf)
                shape = (f"B={b} k={k} dims={'x'.join(map(str, dims))} "
                         f"R={rank} input {inf.upper()} rank 4")
                for name, pipeline, kern in names:
                    plan = splan.plan_carry_sweep(of, inf, k, b, dims, rank,
                                                  4, pipeline=pipeline)
                    key = f"{name}:{of}x{inf}" + (":b8" if b == 8 else "")
                    if b == 8:
                        errs[key] = check(
                            f"K3 {of}x{inf} B=8 serving shape",
                            kern(*cores, n_op=n_op, plan=plan, scale=scale),
                            carry.carry_sweep_project_plain(
                                *cores, n_op=n_op, program=plan.program,
                                scale=scale))
                    rows.append(carry_row(key, of, inf, cores, n_op, b, kern,
                                          plan, shape, scale))
                if b == 8:
                    dev_ms = rows[-1]["device_split_ms"]["carry"]
                    tick = tick_ms[of][inf]
                    rows[-1]["tick_ms"] = tick
                    log(f"K3 {of}x{inf} B=8: {dev_ms:.4f} device ms of the "
                        f"{tick:.3f} device ms of a mixed serve's {inf} "
                        f"tick ({100 * dev_ms / tick:.1f}%)")

    # K3 in the paper's regime: TT(5), k=512, dims 8^8, unit-norm rank-10 TT
    # inputs (a dense item would be 16.7 M floats); the numbers go into the
    # TT x TT row as `paper_*`
    dims, k, rank, b = (8,) * 8, SLICE_K, 5, 64
    op = rp.make_projector(rp.ProjectorSpec("tt", k, dims, rank), seed=11,
                           device=dev)
    xb = struct_batch("tt", dims, (10,), b, norm="unit")
    cores, n_op = struct_operands(op, "tt", xb, "tt")
    inter = [t for pair in zip(cores[:n_op], cores[n_op:]) for t in pair]
    spec = struct_einsum_spec("tt", "tt", len(dims))
    plan = splan.plan_carry_sweep("tt", "tt", k, b, dims, rank, 10)
    scale = 1.0 / math.sqrt(k)
    paper_ref = carry.carry_sweep_project_plain(*cores, n_op=n_op,
                                                program=plan.program,
                                                scale=scale)
    paper_run = lambda: carry.carry_sweep_project(  # noqa: E731
        *cores, n_op=n_op, plan=plan, scale=scale)
    paper_y = paper_run()
    paper_err = check(f"K3 paper regime dims={dims} k={k} R={rank} input "
                      "rank 10", paper_y, paper_ref)
    if not torch.equal(paper_y, paper_run()):
        raise AssertionError("K3 paper regime: a second call on the same "
                             "inputs gave other bits")
    cheaper = (b * densify_flops("tt", dims, 10)
               + min(b * theory.flops_project_dense_tt(k, dims, rank),
                     dense_operator_flops("tt", k, dims, rank)
                     + 2 * b * k * math.prod(dims)))
    errs["carry_sweep_project:paper"] = paper_err
    paper = time_row(
        "carry_sweep_project:paper", carry_flops("tt", "tt", cores, n_op),
        cheaper, 4 * (sum(c.numel() for c in cores) + b * k), paper_run,
        lambda: carry.carry_sweep_project_plain(
            *cores, n_op=n_op, program=plan.program, scale=scale),
        lambda: torch.einsum(spec, *inter),
        f"B={b} k={k} dims=8^8 R={rank} input TT rank 10 (unit norm)")
    device_split(paper, paper_run, names=CARRY_KERNELS, need=("carry",))
    paper["host_us"] = host_us(paper_run)
    log(f"K3 paper regime: device {paper['device_split_ms']['carry']:.4f} "
        f"ms (profiler), host {paper['host_us']:.1f} us a call")
    row = next(r for r in rows if r["name"] == "carry_sweep_project:ttxtt")
    row.update({f"paper_{key}": paper[key] for key in (
        "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "program_bound_ms", "flops", "program_flops", "max_abs_err",
        "device_split_ms", "profile_windows", "host_us")})

    del stores, paper_ref
    torch.cuda.empty_cache()
    train_rows, k5_train = train_phases(dev, gen, errs, per_family,
                                        launches, time_row)
    rows += train_rows
    next(r for r in rows
         if r["name"] == "sweep_project_pipelined:tt").update(k5_train)

    # -- 12. the paper's Fig. 1 -------------------------------------------
    rows += fig1_phase(dev, errs, per_family, launches, time_row)

    # -- 13. telemetry at the serving shapes and on the train loop --------
    obs_phase(dev)

    # -- 14. checkpointing on the full-width train loop -------------------
    for key, n in zip(("sweep_project:train", "sweep_reconstruct:train",
                       "fused_update:tt"), ckpt_phase(dev)):
        next(r for r in rows if r["name"] == key)["launches"] += n
        launches[key.split(":")[0]] += n

    # -- 15. the cross-pod sketch collective -------------------------------
    pod = pod_phase(dev)
    for name, n in pod["launches"].items():
        next(r for r in rows if r["name"] == f"{name}:train")["launches"] += n
        launches[name] += n

    # -- 16. pod-mesh checkpoints ------------------------------------------
    pod_ckpt = pod_ckpt_phase(dev)
    for name, n in pod_ckpt["launches"].items():
        next(r for r in rows if r["name"] == f"{name}:train")["launches"] += n
        launches[name] += n

    # -- 17. LM serving at full width --------------------------------------
    lm = lm_phase(dev)

    # -- 18. MoE and M-RoPE serving at full width --------------------------
    moe = moe_phase(dev)
    lm.update({arch: row for arch, row in moe.items() if arch != "seconds"})
    lm["seconds_phase18"] = moe["seconds"]

    # -- 19. SSM, hybrid and encoder-decoder serving at full width ---------
    rec = rec_phase(dev)
    lm.update({arch: row for arch, row in rec.items() if arch != "seconds"})
    lm["seconds_phase19"] = rec["seconds"]

    for name in launches:
        total = sum(r["launches"] for r in rows
                    if r["name"].split(":")[0] == name)
        if total != launches[name]:
            raise AssertionError(f"{name}: per-family launches {total} != "
                                 f"counter {launches[name]}")
    retaken = {f"{r['name']}:{key}": n for r in rows for key, n in r.items()
               if key.endswith("profile_windows") and n > 1}
    log(f"profiler windows taken again (row: windows): {retaken or 'none'}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"collective": pod}))
    print(json.dumps({"pod_ckpt": pod_ckpt}))
    print(json.dumps({"lm_serve": lm}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
