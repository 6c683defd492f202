"""Model settings the dense path reads (attention and loss chunking).

Port of `repro/models/settings.py`: a contextvar consulted while the
forward runs, changed for a dynamic scope with `override(**kw)`. The
reference's mesh, unrolling and sharding knobs have nothing to act on in
a single-device eager port and are left out.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelSettings:
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    dense_below: int = 2048 * 2048   # use dense scores for Sq*Sk <= this
    ce_chunk: int = 512


_settings: contextvars.ContextVar[ModelSettings] = contextvars.ContextVar(
    "repro_torch_model_settings", default=ModelSettings())


def get() -> ModelSettings:
    return _settings.get()


@contextlib.contextmanager
def override(**kw):
    cur = _settings.get()
    token = _settings.set(dataclasses.replace(cur, **kw))
    try:
        yield _settings.get()
    finally:
        _settings.reset(token)


__all__ = ["ModelSettings", "get", "override"]
