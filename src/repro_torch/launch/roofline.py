"""Three-term roofline of one rank's step, counted on meta tensors.

  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = per-device link bytes / LINK_BW

Port of `repro/launch/roofline.py`, with the reference's names and
arithmetic. The reference reads its flops and bytes from XLA's
`cost_analysis()` of the compiled step and its collectives from the HLO
text. The port has neither: `count_step` runs the eager step once on
'meta' tensors (`launch/dryrun.py`, under a fake process group standing
for the other ranks) and counts what it dispatches:

* flops: the formulas of `torch.utils.flop_counter` (the products and
  convolutions, as `FlopCounterMode` counts them; elementwise ops count
  nothing, as in XLA's analysis they count little);
* bytes: every aten op's tensor inputs and outputs, views excluded. These
  are eager bytes with nothing fused, so they overstate XLA's fused
  "bytes accessed": each elementwise op reads and writes its operands in
  full;
* collectives: the rows the step added to the process's
  `rp.shard.CollectiveLedger`, through the ring model of the reference's
  `parse_collectives` (`collectives_from_ledger`);
* memory: the bytes of the storages the step's arguments hold, and the
  peak of the storages it makes while it runs (`memory_stats`).

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, no sparsity, at the 700 W limit). The collective term takes one
link rate for every axis, NVLink's, as the reference takes one ICI rate
(a group that spans hosts crosses InfiniBand, slower than this).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.tree import tree_leaves
from repro_torch.rp import shard

# H100 SXM per-card constants (NVIDIA's data sheet)
PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 67e12    # fp32 outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink 4 bytes/s each way (900 GB/s both)

# the ledger's ops under the reference's HLO op names
_HLO_OP = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "gather": "gather"}


def _group_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def ring_traffic(op: str, nbytes: float, n: int) -> tuple[float, float]:
    """(output bytes, per-device link bytes) of a ledger row: `nbytes`
    this rank contributed to `op` over a group of `n`. The reference's
    ring model on the output (`parse_collectives`): an all-reduce moves
    2 out (n-1)/n, an all-gather out (n-1)/n, a reduce-scatter out (n-1);
    a gather (the checkpoint's, to one rank) one hop of the input."""
    if op == "all_reduce":
        return float(nbytes), 2.0 * nbytes * (n - 1) / max(n, 1)
    if op == "all_gather":
        out = float(nbytes) * n
        return out, out * (n - 1) / max(n, 1)
    if op == "reduce_scatter":
        out = float(nbytes) / n
        return out, out * (n - 1)
    if op == "gather":
        return float(nbytes) * n, float(nbytes)
    raise ValueError(f"unknown ledger op {op!r}; expected one of "
                     f"{sorted(_HLO_OP)}")


def collectives_from_ledger(rows, mesh) -> dict[str, Any]:
    """The reference's `parse_collectives` dict from ledger rows
    (`CollectiveLedger.table()`'s dicts): `per_type` under the HLO op
    names ({count, bytes (the outputs'), traffic}), `per_tag` the same by
    the ledger's tags, and `link_bytes_per_device`. A row over a group of
    one rank moves nothing and is left out, as XLA drops such an op."""
    per_type: dict[str, dict[str, float]] = {}
    per_tag: dict[str, dict[str, float]] = {}
    link = 0.0
    for r in rows:
        n = _group_size(mesh, r["axes"])
        if n <= 1:
            continue
        out, traffic = ring_traffic(r["op"], r["bytes"], n)
        for table, key in ((per_type, _HLO_OP[r["op"]]), (per_tag, r["tag"])):
            d = table.setdefault(key, {"count": 0, "bytes": 0.0,
                                       "traffic": 0.0})
            d["count"] += r["calls"]
            d["bytes"] += out
            d["traffic"] += traffic
        link += traffic
    return {"per_type": per_type, "per_tag": per_tag,
            "link_bytes_per_device": link}


def _flat(xs):
    """The tensors among an aten op's arguments or outputs (a tensor, or
    a list or tuple of them, one level deep)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (t for t in x if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Flops of every aten op that `torch.utils.flop_counter` has a
    formula for (the products and convolutions), bytes of every non-view
    aten op's tensor inputs and outputs, and the live bytes of the
    storages made inside the mode: each new storage is added when an op
    returns it and taken off by a finalizer when it is freed (a storage's
    Python object lives as long as the storage)."""

    def __init__(self, held):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()
        for t in held:
            self._seen.add(t.untyped_storage()._cdata)

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # a composite op reaches the mode whole under inference_mode
            # (the prefill and serve steps): count what it decomposes to,
            # as a step with autograd on dispatches it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        outs = list(_flat(out if isinstance(out, (list, tuple)) else (out,)))
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            for t in itertools.chain(_flat(args), _flat(kwargs.values()),
                                     outs):
                self.bytes += t.numel() * t.element_size()
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            nbytes = st.nbytes()
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, nbytes)
        return out


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def _ledger_delta(before: dict, after: dict) -> list[dict]:
    rows = []
    for key, (calls, nbytes, _) in sorted(after.items(),
                                          key=lambda kv: str(kv[0])):
        c0, b0 = before.get(key, (0, 0, 0.0))[:2]
        if calls > c0:
            tag, op, reduce, dtype, axes = key
            rows.append({"tag": tag, "op": op, "reduce": reduce or "",
                         "dtype": dtype, "axes": list(axes),
                         "calls": calls - c0, "bytes": nbytes - b0})
    return rows


@dataclasses.dataclass
class StepCount:
    """One eager run of a step, counted: flops, bytes (eager, unfused),
    the ledger rows it added, their ring-model traffic on `mesh`, the
    memory of the run (`memory_stats`) and the run's host seconds."""

    flops: float
    bytes: float
    ledger: list
    collective: dict
    memory: dict
    seconds: float


def count_step(fn, *args, mesh=None) -> tuple[Any, StepCount]:
    """Run `fn(*args)` once under the three counters; returns (its
    output, the `StepCount`). `mesh` gives the ledger rows' group sizes
    (None: one rank, whose collectives are none)."""
    held = _tensors(args)
    before = {k: tuple(v) for k, v in shard.collective_ledger().rows.items()}
    counter = _Counter(held)
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    rows = _ledger_delta(before, shard.collective_ledger().rows)
    args_b = _storage_bytes(held)
    outs_b = _storage_bytes(_tensors(out))
    alias = sum(b for k, b in outs_b.items() if k in args_b)
    new_out = sum(outs_b.values()) - alias
    memory = {"argument_size_in_bytes": float(sum(args_b.values())),
              "output_size_in_bytes": float(sum(outs_b.values())),
              "alias_size_in_bytes": float(alias),
              "temp_size_in_bytes": float(max(counter.peak - new_out, 0))}
    memory["peak_bytes_per_device"] = (
        memory["argument_size_in_bytes"] + memory["output_size_in_bytes"]
        + memory["temp_size_in_bytes"] - memory["alias_size_in_bytes"])
    coll = (collectives_from_ledger(rows, mesh) if mesh is not None else
            {"per_type": {}, "per_tag": {}, "link_bytes_per_device": 0.0})
    return out, StepCount(float(counter.flops), float(counter.bytes), rows,
                          coll, memory, seconds)


def memory_stats(count: StepCount) -> dict[str, float]:
    """The reference's memory dict of a counted run: the storages its
    arguments hold (state and batch), its outputs, the outputs that are
    arguments (the serve step's cache, written in place), and the temps,
    whose peak above the arguments is the run's peak of live storages
    made inside it; `peak_bytes_per_device` = argument + output + temp -
    alias, as the reference adds them."""
    return dict(count.memory)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective: dict
    model_flops: float           # 6*N*D (active params) for the global step
    memory_per_device: dict
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_frac: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops_per_device / PEAK_FLOPS
        self.memory_s = self.hlo_bytes_per_device / HBM_BW
        self.collective_s = self.collective["link_bytes_per_device"] / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total_hlo = self.hlo_flops_per_device * self.n_devices
        self.useful_flops_frac = (self.model_flops / total_hlo
                                  if total_hlo else 0.0)
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze_extrapolated(count1: StepCount, count2: StepCount, n1: float,
                         n2: float, n_full: float, *, arch: str, shape,
                         mesh_name: str, n_devices: int, cfg,
                         memory: dict) -> Roofline:
    """Linear-in-depth extrapolation from two shallow probes' counts.

    cost(n) = a + b*n  (n = pattern instances); the full cell evaluates at
    n_full. Exact for flops; collectives are per-type (and per-tag)
    linear too.
    """
    def extrap(v1, v2):
        slope = (v2 - v1) / (n2 - n1)
        return max(v1 + slope * (n_full - n1), 0.0)

    zero = {"count": 0, "bytes": 0.0, "traffic": 0.0}
    coll: dict[str, Any] = {}
    for table in ("per_type", "per_tag"):
        t1, t2 = count1.collective[table], count2.collective[table]
        coll[table] = {key: {k: extrap(t1.get(key, zero)[k],
                                       t2.get(key, zero)[k])
                             for k in ("count", "bytes", "traffic")}
                       for key in sorted(set(t1) | set(t2))}
    coll["link_bytes_per_device"] = extrap(
        count1.collective["link_bytes_per_device"],
        count2.collective["link_bytes_per_device"])
    coll["probe_instances"] = [n1, n2, n_full]
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        hlo_flops_per_device=extrap(count1.flops, count2.flops),
        hlo_bytes_per_device=extrap(count1.bytes, count2.bytes),
        collective=coll, model_flops=model_flops_for(cfg, shape),
        memory_per_device=memory,
    ).finalize()


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D_tokens (train) or 2*N_active*D (inference)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n_active * tokens


def analyze(count: StepCount, *, arch: str, shape, mesh_name: str,
            n_devices: int, cfg) -> Roofline:
    """The roofline of one counted run, as it stands (no extrapolation)."""
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        hlo_flops_per_device=count.flops, hlo_bytes_per_device=count.bytes,
        collective=count.collective, model_flops=model_flops_for(cfg, shape),
        memory_per_device=memory_stats(count),
    ).finalize()


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "PEAK_FLOPS_FP32", "Roofline",
           "StepCount", "analyze", "analyze_extrapolated",
           "collectives_from_ledger", "count_step", "memory_stats",
           "model_flops_for", "ring_traffic"]
