"""Layout helpers for a mesh (partial port of `repro/launch/sharding.py`).

Only the sketch-bucket template is ported: `bucket_specs`, which the
checkpoint codec's sketcher reads (`ckpt/elastic.py`). The parameter
and batch layouts (`axis_rules`, `spec_for`, `param_specs`,
`input_batch_specs`, `shard_batch_seq`) go with the model's
`param_axes` (ROADMAP.md, queue 1 item 12.7).
"""
from __future__ import annotations

from .mesh import data_axes


def bucket_specs(mesh, *, exclude: tuple = ()) -> tuple:
    """Spec template for `(n_buckets, ...)` sketch-bucket arrays: the
    bucket dim over the mesh's data axes, minus `exclude` (the pod axis,
    whose ranks hold different trees). The sketcher falls back to the whole
    leaf where the axes do not divide a leaf's bucket count."""
    axes = tuple(a for a in data_axes(mesh) if a not in exclude)
    return (axes,) if axes else (None,)


__all__ = ["bucket_specs"]
