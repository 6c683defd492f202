"""Parameter trees shared by the model families.

Each family describes its parameters as a spec, `path -> (shape,
logical axes, init kind)`, under the reference's nested names
(`"layers/wq"`, `"groups/rec_a/w_x"`, ...), with the reference's logical
sharding axes (`launch.sharding.axis_rules` maps them onto a mesh). From
a spec this module draws the common init kinds from a `torch.Generator`,
carries the reference's numpy tree across (every shape checked), gives
the axes tree and the shape tree (meta tensors, nothing allocated), and
the `nn.Module` view of a parameter dict. `take` is how a forward reads
a leaf (or one layer of a stacked leaf): directly, or through the data
mesh's gather (`launch.fsdp.Sharded`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def assign(tree: dict, path: str, leaf) -> None:
    """Put `leaf` at the '/'-separated `path` of a nested dict."""
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def draw(kind: str, shape, generator: torch.Generator,
         dtype=torch.float32) -> torch.Tensor:
    """A leaf of a common init kind on the generator's device: 'ones',
    'zeros', 'embed' (normal, std 0.02) or 'fanin' (normal, std
    1/sqrt(shape[-2]))."""
    dev = generator.device
    if kind in ("ones", "zeros"):
        return (torch.ones if kind == "ones" else torch.zeros)(
            shape, dtype=dtype, device=dev)
    if kind not in ("embed", "fanin"):
        raise ValueError(f"unknown init kind {kind!r}")
    std = 0.02 if kind == "embed" else 1.0 / (shape[-2] ** 0.5)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=dev).mul_(std)   # no second copy


def uniform(shape, generator: torch.Generator, lo: float, hi: float,
            dtype=torch.float32) -> torch.Tensor:
    """U[lo, hi) on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u.mul_(hi - lo).add_(lo)


def from_numpy(spec: dict, tree: dict, name: str, *, device=None,
               dtype=torch.float32) -> dict:
    """The port's parameter dict from the reference's (numpy arrays under
    the same nested names); every leaf's shape is checked against the
    spec of the config `name`. `device=None` means CUDA."""
    dev = resolve_device(device)
    out: dict[str, Any] = {}
    for path, (shape, *_) in sorted(spec.items()):
        node = tree
        for p in path.split("/"):
            node = node[p]
        a = np.asarray(node, dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, the spec of "
                             f"{name} has {tuple(shape)}")
        assign(out, path, torch.tensor(a, dtype=dtype, device=dev))
    return out


def axes(spec: dict) -> dict:
    """The nested tree of each leaf's logical axes."""
    out: dict[str, Any] = {}
    for path, (_, ax, _) in sorted(spec.items()):
        assign(out, path, tuple(ax))
    return out


def shapes(spec: dict, dtype=torch.float32) -> dict:
    """The nested tree of meta tensors of each leaf's shape and `dtype`:
    no storage, nothing drawn."""
    out: dict[str, Any] = {}
    for path, (shape, *_) in sorted(spec.items()):
        assign(out, path, torch.empty(shape, dtype=dtype, device="meta"))
    return out


def take(gather, path: str, leaf: torch.Tensor, index: int | None = None
         ) -> torch.Tensor:
    """The leaf at `path` (layer `index` of a stacked leaf) as a forward
    reads it: `leaf[index]` without a gather, else through `gather(path,
    leaf, index)`, which puts a sharded leaf's blocks back together."""
    if gather is None:
        return leaf if index is None else leaf[index]
    return gather(path, leaf, index)


def take_all(gather, prefix: str, tree: dict, index: int | None = None
             ) -> dict:
    """`take` on every leaf of a flat dict of leaves under `prefix`."""
    return {k: take(gather, f"{prefix}{k}", t, index)
            for k, t in tree.items()}


class ParamTree(torch.nn.Module):
    """The `nn.Module` view of a nested parameter dict: each tensor is
    registered as a parameter (sharing storage, no copy), each sub-dict
    as a submodule, and `param_tree()` returns the nested dict under the
    reference's names."""

    def __init__(self, params: dict):
        super().__init__()
        for name, node in params.items():
            if isinstance(node, dict):
                self.add_module(name, ParamTree(node))
            else:
                self.register_parameter(name, torch.nn.Parameter(node))

    def param_tree(self) -> dict:
        tree: dict[str, Any] = dict(self._parameters)
        for name, mod in self._modules.items():
            tree[name] = mod.param_tree()
        return tree


class FamilyModule(ParamTree):
    """A family's module view: `forward(batch)` is the family's
    `loss_fn(cfg, param_tree(), batch)`, which subclasses set as
    `loss`."""

    loss = None

    def __init__(self, cfg, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: dict, **kw) -> torch.Tensor:
        return type(self).loss(self.cfg, self.param_tree(), batch, **kw)


__all__ = ["FamilyModule", "ParamTree", "assign", "axes", "draw",
           "from_numpy", "shapes", "take", "take_all", "uniform"]
