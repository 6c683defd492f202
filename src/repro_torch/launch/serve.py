"""Batched serving driver: slot-based continuous batching over the decode
step (prefill on arrival, per-slot positions, greedy sampling).

Port of `repro/launch/serve.py`. Runs on the CUDA device unless
`--device cpu`:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --reduced --slots 4 --requests 8 --prompt-len 12 --gen 16 \
        --device cpu

The reference draws the parameters from `PRNGKey(0)`, which torch cannot
replay: `SlotServer` takes them from `params=` (a parameter dict on its
device, e.g. the reference's carried across with
`models.from_numpy_params`) or else draws them from a
`torch.Generator` seeded with `seed`. The cache is written in place by
each decode step. On a CUDA device the server captures its decode step
once as a CUDA graph: the same kernels on the same buffers, replayed
with one call instead of some 2,500 launches from the host; on the CPU
the step runs eagerly.

Every slot's sequence is independent of the others, for every family.
The reference feeds a prompt by running the whole-batch step once a
prompt token, the other slots repeating their current token at their
current position: an idempotent write to a KV cache, but a recurrent
state (mamba2's SSM and conv state, the RG-LRU's) advances at every
step whatever the position, and the reference never resets a reused
slot's state. So here `submit` resets the new slot's recurrent rows to
`init_cache`'s state, and `_feed_prompt` saves the other slots'
recurrent rows before the prompt's steps and copies them back in place
after (the CUDA graph's buffers stay the same). The attention rows need
nothing: a slot's next real step rewrites the position the prompt's
steps wrote. A cache without recurrent state (the decoder's) is not
touched. The CLI refuses the encoder-decoder (whisper), whose decode
attends to an encoded audio input the server does not take.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_leaves
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _restart(pairs, slot: int | None = None) -> None:
    """Copy `init_cache`'s state into each (cache leaf, its batch-1
    `init_cache` leaf) pair, in place: every row, or `slot`'s alone
    (every cache leaf holds the batch on dim 1)."""
    for t, fresh in pairs:
        dst = t if slot is None else t[:, slot:slot + 1]
        dst.copy_(fresh.expand_as(dst))


class _GraphedStep:
    """`model.decode_step(params, cache, token, pos)` captured once as a
    CUDA graph on static token and position buffers and on `cache`, which
    every replay writes in place; the logits come back in one static
    buffer, valid until the next call. `restart()` must bring the cache
    back to `init_cache`'s state."""

    def __init__(self, model, params: dict, cache: dict, slots: int,
                 device: torch.device, restart):
        self.params, self.cache = params, cache
        self.token = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=device)
        # capture needs one run first, on a side stream
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            model.decode_step(params, cache, self.token, self.pos)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model.decode_step(params, cache, self.token,
                                               self.pos)
        # that run wrote token 0 at position 0 of every sequence (and
        # advanced any recurrent state): restart the cache, so the server
        # starts from `init_cache`'s state
        restart()

    def __call__(self, params, cache, token, pos):
        if params is not self.params or cache is not self.cache:
            raise ValueError("the captured decode step runs on the params "
                             "and cache it was captured with")
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.graph.replay()
        return self.logits, cache


class SlotServer:
    """Minimal continuous-batching server over Model.decode_step.

    Fixed `slots` concurrent sequences; free slots accept queued requests;
    each decode step advances every active slot by one token. Per-slot
    positions make the shared KV cache ring-buffer correct.
    """

    def __init__(self, model, *, slots: int, max_seq: int, eos: int | None,
                 max_gen: int, device=None, params: dict | None = None,
                 seed: int = 0):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos
        self.max_gen = max_gen
        self.device = resolve_device(device)
        self.params = (params if params is not None else model.init(
            torch.Generator(device=self.device).manual_seed(seed)))
        self.cache = model.init_cache(slots, max_seq, device=self.device)
        # one sequence's `init_cache` state, leaf by leaf beside the cache
        fresh = model.init_cache(1, max_seq, device=self.device)
        self._all = list(zip(tree_leaves(self.cache), tree_leaves(fresh)))
        self._recurrent = [pair for key in model.recurrent_state
                           for pair in zip(tree_leaves(self.cache[key]),
                                           tree_leaves(fresh[key]))]
        self.pos = np.zeros((slots,), np.int32)
        self.gen_count = np.zeros((slots,), np.int32)
        self.active: list[Request | None] = [None] * slots
        self.cur_tok = np.zeros((slots,), np.int32)
        self._step = (_GraphedStep(model, self.params, self.cache, slots,
                                   self.device,
                                   lambda: _restart(self._all))
                      if self.device.type == "cuda" else model.decode_step)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _feed_prompt(self, slot: int, req: Request) -> None:
        """Whole-prompt prefill, shipped to the device in one transfer.

        Builds the (S, slots) token/position matrices the token-by-token
        loop would have fed step by step — other slots repeat their current
        token at their current position, an idempotent cache write — and
        runs S calls of the SAME decode step the generation loop runs,
        syncing the host only for the final argmax. Running the same step
        on the same inputs (rather than a separate batched forward over
        the prompt) is what makes greedy decode bit-identical to
        token-by-token stepping: a near-tie argmax can flip on ulp-level
        logit differences between two programs. The other slots'
        recurrent rows, which those steps advance, are saved first and
        copied back in place after.
        """
        S = len(req.prompt)
        if S == 0:
            raise ValueError(f"request {req.rid} has an empty prompt")
        toks = np.broadcast_to(self.cur_tok, (S, self.slots)).copy()
        toks[:, slot] = np.asarray(req.prompt, np.int32)
        poss = np.broadcast_to(self.pos, (S, self.slots)).copy()
        poss[:, slot] = self.pos[slot] + np.arange(S, dtype=np.int32)
        toks_d, poss_d = self._on_device(toks), self._on_device(poss)
        saved = []
        if self._recurrent:
            others = torch.tensor([s for s in range(self.slots) if s != slot],
                                  dtype=torch.int64, device=self.device)
            saved = [t.index_select(1, others) for t, _ in self._recurrent]
        logits = None
        for i in range(S):
            logits, self.cache = self._step(
                self.params, self.cache, toks_d[i], poss_d[i])
        for (t, _), rows in zip(self._recurrent, saved):
            t.index_copy_(1, others, rows)
        self.pos[slot] += S
        self.cur_tok[slot] = int(torch.argmax(logits[slot]))

    def submit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                self.active[s] = req
                self.pos[s] = 0
                self.gen_count[s] = 0
                _restart(self._recurrent, s)
                self._feed_prompt(s, req)
                return True
        return False

    def step(self) -> None:
        logits, self.cache = self._step(
            self.params, self.cache, self._on_device(self.cur_tok),
            self._on_device(self.pos))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            self.gen_count[s] += 1
            tok = int(nxt[s])
            req.generated.append(tok)
            if ((self.eos is not None and tok == self.eos)
                    or self.gen_count[s] >= self.max_gen
                    or self.pos[s] >= self.max_seq - 1):
                req.done = True
                self.active[s] = None
            else:
                self.cur_tok[s] = tok

    def run(self, queue: list[Request]) -> list[Request]:
        done: list[Request] = []
        pending = list(queue)
        while pending or any(r is not None for r in self.active):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            if any(r is not None for r in self.active):
                self.step()
            for r in queue:
                if r.done and r not in done:
                    done.append(r)
        return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.mrope_sections is not None:
        ap.error(f"{args.arch} rotates by M-RoPE positions (3, B, S), which "
                 "the slot server does not feed; serve it through "
                 "launch.steps.build_serve_step(...)(..., positions3=)")
    if cfg.family == "encdec":
        ap.error(f"{args.arch} is an encoder-decoder, whose decode attends "
                 "to an encoded audio input, which the slot server does "
                 "not take; serve it through launch.steps."
                 "build_prefill_step / build_serve_step after "
                 "models.whisper.build_cross_cache")
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, size=(args.prompt_len,)))
            for i in range(args.requests)]
    srv = SlotServer(model, slots=args.slots, max_seq=args.max_seq,
                     eos=None, max_gen=args.gen, device=args.device)
    done = srv.run(reqs)
    for r in done:
        print(f"req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> {len(r.generated)} tokens: {r.generated[:8]}...")
    print(f"[serve] completed {len(done)}/{args.requests} requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
