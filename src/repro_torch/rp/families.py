"""Built-in projector families: the paper's two maps.

family      operator     params (theory.*)
------      --------     ------------------
'tt'        TTRP         O(k N d R^2)
'cp'        CPRP         O(k N d R)

The 'gaussian' / 'sparse' baselines wait for a later slice (ROADMAP).
"""
from __future__ import annotations

from repro_torch.core.cp_rp import sample_cp_rp
from repro_torch.core.tt_rp import sample_tt_rp

from .protocol import ProjectorSpec
from .registry import register_family


@register_family("tt")
def _make_tt(spec: ProjectorSpec, generator):
    return sample_tt_rp(generator, spec.dims, spec.k, spec.rank,
                        dtype=spec.dtype)


@register_family("cp")
def _make_cp(spec: ProjectorSpec, generator):
    return sample_cp_rp(generator, spec.dims, spec.k, spec.rank,
                        dtype=spec.dtype)
