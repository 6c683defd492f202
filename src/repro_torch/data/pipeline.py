"""Deterministic, resumable, host-shardable synthetic LM data pipeline.

A copy of `repro/data/pipeline.py` (numpy only): the same seed gives the
same batches as the reference.

Every batch is a pure function of (seed, step, shard), so:
  * crash-restart resumes exactly (fast-forward = set the step counter),
  * multi-host training shards by host id with no coordination,
  * elastic re-sharding (different host count after restart) reproduces the
    same global token stream.

The synthetic stream is a mixture of Zipf-distributed unigrams and short
Markov motifs — enough structure that a language model's loss decreases, so
convergence tests (e.g. compressed vs uncompressed grad parity) mean
something.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # fixed motif table (the learnable structure)
        self.motifs = root.integers(0, v, size=(cfg.n_motifs, cfg.motif_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.unigram = p / p.sum()

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1):
        """Returns {'tokens', 'labels'} for this host's slice of the batch."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        b_local = cfg.global_batch // num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + shard)
        toks = rng.choice(cfg.vocab, size=(b_local, cfg.seq_len + 1),
                          p=self.unigram).astype(np.int32)
        # overwrite random spans with motifs (predictable structure)
        n_spans = cfg.seq_len // (cfg.motif_len * 4)
        for i in range(b_local):
            for _ in range(max(1, n_spans)):
                m = rng.integers(0, cfg.n_motifs)
                pos = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[i, pos:pos + cfg.motif_len] = self.motifs[m]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
