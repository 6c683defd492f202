"""Meshes: named axes over the ranks of `torch.distributed`.

Port of `repro/launch/mesh.py`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with named dims, wrapped with
the process groups the port's collectives run on:

  pod   — slow inter-pod data parallelism; the gradient sketch compressor
          syncs this axis (`optim/compress.py::compress_collective`).
  data  — in-pod data parallelism (the sketcher's bucket axis).
  model — tensor parallelism (waits for item 12's `param_axes`).

Every axis and every tuple of axes gets its group once, when the mesh is
built, on every rank in the same order (`new_group` must be entered by
all ranks alike, and DeviceMesh's `_flatten` is private). Global ranks
are laid out row-major in mesh order, so a group's ranks, and the blocks
a rank owns along a tuple of axes (`AxisGroup.index`), follow mesh order
too, whatever order a spec entry names them in.

`make_mesh` starts the default process group when none runs: `env://`
under `torchrun` (RANK, WORLD_SIZE, MASTER_ADDR set), else a world of one
through a `file://` store in a temporary directory. The backend is NCCL
on CUDA and gloo on the CPU unless the caller names one; gloo also takes
CUDA tensors, which is how two ranks share one card (NCCL runs one rank a
card and is refused, with the fix named, when ranks outnumber the cards).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

AXES = ("pod", "data", "model")


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's group along `axes` (mesh order): `size` ranks, this one
    at row-major `index` among them; `pg` is the process group."""

    mesh: "Mesh"
    axes: tuple[str, ...]
    size: int
    index: int
    pg: object


class Mesh:
    """A DeviceMesh with named dims and a group for every tuple of them.

    `shape` maps axis name -> size in mesh order and `axis_names` lists
    them, as a JAX mesh does, so the bucket-spec helpers read either.
    `device` is the torch device this rank computes on; `backend` the
    process groups' backend.
    """

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in device_mesh.mesh.shape)))
        self.rank = dist.get_rank()
        coord = device_mesh.get_coordinate()
        self.coordinate = dict(zip(self.axis_names, coord))
        self._groups: dict[tuple[str, ...], AxisGroup] = {}
        grid = device_mesh.mesh
        n = len(self.axis_names)
        for width in range(1, n + 1):
            for dims in itertools.combinations(range(n), width):
                axes = tuple(self.axis_names[d] for d in dims)
                self._groups[axes] = self._build(grid, dims, axes)

    def _build(self, grid, dims, axes) -> AxisGroup:
        n = len(self.axis_names)
        rest = [d for d in range(n) if d not in dims]
        # the axes' ranks for each coordinate of the other axes; every
        # rank enters every new_group call, in this order
        moved = grid.permute(*rest, *dims).reshape(-1, _prod(
            grid.shape[d] for d in dims))
        size = int(moved.shape[1])
        if len(dims) == 1:
            mine = self.device_mesh.get_group(self.axis_names[dims[0]])
        elif size == dist.get_world_size():
            mine = dist.group.WORLD
        else:
            mine = None
            for row in moved.tolist():
                pg = dist.new_group(row, backend=self.backend)
                if self.rank in row:
                    mine = pg
        index = 0
        for d in dims:
            index = index * int(grid.shape[d]) + self.coordinate[
                self.axis_names[d]]
        return AxisGroup(self, axes, size, index, mine)

    def group(self, axes) -> AxisGroup:
        """This rank's `AxisGroup` along `axes` (a name or a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or not axes:
            raise ValueError(f"axes {axes} are not a non-empty tuple of the "
                             f"mesh's axes {self.axis_names}")
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"device={self.device}, rank={self.rank})")


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def _local_ranks() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def _start(backend: str) -> None:
    """The default process group: env:// under torchrun, else a world of
    one through a file:// store."""
    if _launched():
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"),
                         "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=1, rank=0)


def make_mesh(shape, names, *, device=None, backend: str | None = None
              ) -> Mesh:
    """A `Mesh` of `shape` with axis `names` over every rank of the
    default group (started here when none runs). `device=None` means
    CUDA; `backend=None` NCCL on CUDA, gloo on the CPU."""
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} must pair "
                         "up one to one, with distinct names")
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected 'nccl' or "
                         "'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' needs CUDA tensors; pass "
                             "device='cuda' or backend='gloo'")
        if _local_ranks() > torch.cuda.device_count():
            raise ValueError(
                f"NCCL runs one rank a card, but {_local_ranks()} ranks "
                f"share this host's {torch.cuda.device_count()} visible "
                "card(s); pass backend='gloo' (--dist-backend gloo) to run "
                "several ranks on one card")
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        # set (and initialize) the device first: DeviceMesh picks one by
        # rank otherwise, which fails with more ranks than cards
        torch.cuda.set_device(dev)
        torch.cuda.init()
    if not dist.is_initialized():
        _start(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, the mesh asks for "
                         f"{backend!r}")
    world = dist.get_world_size()
    if _prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} holds "
                         f"{_prod(shape)} ranks, the process group {world}")
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=names)
    return Mesh(dm, dev, backend)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: str | None = None) -> Mesh:
    """The production mesh: (data 16, model 16), or (pod 2, data 16,
    model 16) with `multi_pod`; it needs that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES if multi_pod else AXES[1:]
    need = _prod(shape)
    have = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", "1")))
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a world of {need} ranks, found {have}; "
            f"launch with torchrun --nnodes ... --nproc-per-node ... so that "
            f"the world holds {need} ranks")
    return make_mesh(shape, axes, device=device, backend=backend)


def make_host_mesh(model: int = 1, *, device=None,
                   backend: str | None = None) -> Mesh:
    """(data, model) over whatever ranks the world holds (one without
    torchrun): tests and examples."""
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", "1")) if _launched() else 1)
    if model < 1 or n % model != 0:
        raise ValueError(
            f"model={model} must be a positive divisor of the {n} rank(s); "
            f"pick a model-parallel size that divides {n} (or launch more "
            "ranks with torchrun --nproc-per-node N)")
    return make_mesh((n // model, model), AXES[1:], device=device,
                     backend=backend)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


__all__ = ["AXES", "AxisGroup", "Mesh", "data_axes", "make_host_mesh",
           "make_mesh", "make_production_mesh", "model_size"]
