"""Byte-level tokenizer stub (real deployments plug a sentencepiece model in
behind the same interface). A copy of `repro/data/tokenizer.py`."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    vocab_size = 256 + 2
    bos = 256
    eos = 257

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids if int(i) < 256]
        return bytes(ids).decode("utf-8", errors="replace")
