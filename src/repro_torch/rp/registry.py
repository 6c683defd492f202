"""Family registry: name -> factory(spec, generator) -> RPOperator.

Port of `repro/rp/registry.py`. A factory draws every random number from
the `torch.Generator` it is given, so an operator is fully determined by
(spec, seed, device).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.device import resolve_device

from .protocol import ProjectorSpec, RPOperator

Factory = Callable[[ProjectorSpec, torch.Generator], RPOperator]

_FAMILIES: dict[str, Factory] = {}
_ALIASES: dict[str, str] = {}


def register_family(name: str, *aliases: str) -> Callable[[Factory], Factory]:
    """Decorator registering `factory(spec, generator)` under `name`."""

    def deco(factory: Factory) -> Factory:
        for n in (name,) + aliases:
            if n in _FAMILIES or n in _ALIASES:
                raise ValueError(f"RP family {n!r} already registered")
        _FAMILIES[name] = factory
        for a in aliases:
            _ALIASES[a] = name
        return factory

    return deco


def list_families() -> tuple[str, ...]:
    """Canonical registered family names (aliases resolve but aren't listed)."""
    return tuple(sorted(_FAMILIES))


def get_family(name: str) -> Factory:
    try:
        return _FAMILIES[_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown RP family {name!r}; registered: {list_families()}"
        ) from None


def make_projector(spec: ProjectorSpec, seed: int = 0, *,
                   device=None) -> RPOperator:
    """Sample a projector for `spec` from a generator seeded with `seed`.

    `device=None` means CUDA (raises where it is unavailable). Deterministic
    given (spec, seed, device): the same call regenerates the same
    operator bitwise.
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return get_family(spec.family)(spec, gen)
