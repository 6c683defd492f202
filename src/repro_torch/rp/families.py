"""Built-in projector families: the paper's two maps and its two baselines.

family      operator     params (theory.*)        structured fast paths
------      --------     ------------------       ---------------------
'tt'        TTRP         O(k N d R^2)             TT, CP inputs
'cp'        CPRP         O(k N d R)               TT, CP inputs
'gaussian'  GaussianRP   k * D                    - (flat; streamed blocks)
'sparse'    VerySparseRP ~ k * D / sqrt(D)        - (flat; streamed blocks)
"""
from __future__ import annotations

from repro_torch.core.baselines import GaussianRP, VerySparseRP, base_seed
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


@register_family("gaussian", "dense")
def _make_gaussian(spec: ProjectorSpec, generator):
    return GaussianRP(seed=base_seed(generator), k=spec.k,
                      dim=spec.input_size, device=generator.device)


@register_family("sparse", "verysparse")
def _make_sparse(spec: ProjectorSpec, generator):
    return VerySparseRP(seed=base_seed(generator), k=spec.k,
                        dim=spec.input_size, device=generator.device)
