"""Atomic, VERIFIED, async-capable checkpoints of nested-dict tensor trees.

Port of `repro/ckpt/checkpointer.py`. The layout is the reference's:
<dir>/step_<n:010d>/{manifest.json, arr_<i>.npy ...}, one array a leaf in
the order of `core.tree` (sorted dict keys, as `jax.tree.flatten`), so a
dense checkpoint of float32 dict trees is readable by either package.
Writes go to a tmp directory that is atomically renamed; orphaned
``.tmp_*`` directories from a crash mid-save are swept on the next save
and when an `AsyncCheckpointer` starts.

Integrity: every array entry in the manifest carries a crc32 of its raw
bytes, and the manifest a sha256 over its canonical JSON with
``integrity`` blanked. ``verify`` re-hashes both; ``restore`` verifies by
default and, when the newest checkpoint is corrupt, falls back to the
newest one that verifies. Misuse raises typed errors (never asserts).

Port-specific:
  * ``"treedef"`` holds the tree's JSON description (or null); nothing
    reads it back, as in the reference.
  * bfloat16 leaves (numpy has none) are saved as their raw bits
    (uint16) with the manifest dtype ``"bfloat16"`` and come back bit
    for bit.
  * ``restore`` returns tensors on an explicit ``device=``, else on each
    example leaf's device (a meta example leaf: the CPU).
  * ``AsyncCheckpointer`` copies CUDA leaves into pinned host buffers on a
    side stream (``non_blocking``, one event the writer thread waits on),
    so the caller's critical path holds no transfer; the buffers are
    allocated once per checkpointer and reused.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tree import tree_flatten, tree_unflatten

BF16 = "bfloat16"   # manifest dtype of a leaf saved as its raw bits


class CheckpointError(ValueError):
    """Restore-path misuse or an unusable checkpoint: typed (survives
    ``python -O``) so supervisors can distinguish it from transient I/O."""


class CorruptionError(CheckpointError):
    """A checkpoint failed integrity verification (checksum/hash/shape)."""


def sweep_tmp(directory: str | os.PathLike) -> list[pathlib.Path]:
    """Remove orphaned ``.tmp_*`` directories left by a crash mid-save.
    Returns the paths removed."""
    directory = pathlib.Path(directory)
    removed = []
    if not directory.is_dir():
        return removed
    for tmp in directory.glob(".tmp_*"):
        if tmp.is_dir():
            shutil.rmtree(tmp, ignore_errors=True)
            removed.append(tmp)
    return removed


def _manifest_digest(manifest: dict) -> str:
    """sha256 over the canonical JSON body with ``integrity`` blanked."""
    body = dict(manifest)
    body.pop("integrity", None)
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (``arr.tobytes()``) without
    copying a contiguous array."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a leaf: a tensor is copied to the
    host (bf16 as its raw bits), anything else goes through np.asarray."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), BF16
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype == object:
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__} is "
                        "not a tensor or a numeric array")
    return arr, str(arr.dtype)


def _file_dtype(dtype: str) -> str:
    """The .npy dtype an array of manifest dtype `dtype` is stored as."""
    return "uint16" if dtype == BF16 else dtype


def _treedef_json(treedef):
    try:
        return json.loads(json.dumps(treedef))
    except TypeError:
        return None


def _default_io():
    # function-level import: ckpt stays importable without runtime
    from repro_torch.runtime.resilience import CheckpointIO
    return CheckpointIO()


def save(directory: str | os.PathLike, step: int, tree: Any, *,
         keep: int = 3, extra: dict | None = None, io=None,
         retries: int = 3, base_delay: float = 0.05) -> pathlib.Path:
    """Atomic synchronous save with integrity metadata. Returns the path.

    Transient OSErrors from the array writes and the final rename are
    retried up to `retries` times with capped exponential backoff; `io`
    injects the write/rename implementation (tests pass an
    IOFaultInjector).
    """
    from repro_torch.runtime.resilience import retry_with_backoff
    io = io if io is not None else _default_io()
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    sweep_tmp(directory)
    final = directory / f"step_{step:010d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_"))
    # on an AsyncCheckpointer this runs on the writer thread, which the
    # trace shows as its own track of the shared timeline
    with obs.span("ckpt.save", step=step) as sp:
        try:
            leaves, treedef = tree_flatten(tree)
            sp.set(n_arrays=len(leaves))
            paths = []
            for i, leaf in enumerate(leaves):
                arr, dtype = _to_numpy(leaf)
                retry_with_backoff(
                    lambda a=arr, p=tmp / f"arr_{i}.npy": io.write_array(p, a),
                    retries=retries, base_delay=base_delay)
                paths.append({"file": f"arr_{i}.npy", "dtype": dtype,
                              "shape": list(arr.shape),
                              "crc32": _crc32(arr)})
            manifest = {
                "step": step,
                "treedef": _treedef_json(treedef),
                "n_arrays": len(leaves),
                "arrays": paths,
                "time": time.time(),
                "extra": extra or {},
            }
            manifest["integrity"] = _manifest_digest(manifest)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():
                shutil.rmtree(final)
            retry_with_backoff(lambda: io.rename(tmp, final),
                               retries=retries, base_delay=base_delay)
            io.post_commit(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _gc(directory, keep)
    return final


def _gc(directory: pathlib.Path, keep: int) -> None:
    ckpts = sorted(directory.glob("step_*"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    ckpts = sorted(pathlib.Path(directory).glob("step_*"))
    if not ckpts:
        return None
    return int(ckpts[-1].name.split("_")[1])


def available_steps(directory: str | os.PathLike) -> list[int]:
    """All checkpoint steps under `directory`, ascending."""
    return sorted(int(p.name.split("_")[1])
                  for p in pathlib.Path(directory).glob("step_*"))


def verify(path: str | os.PathLike) -> dict:
    """Full integrity check of one checkpoint directory.

    Raises `CorruptionError` on: a missing or unparseable manifest, a
    manifest sha256 mismatch, a missing array file, an array whose bytes
    fail its crc32, or a shape/dtype that disagrees with the manifest.
    Returns the verified manifest. A manifest without ``integrity`` fails.
    """
    return _verify(pathlib.Path(path), None)


def _verify(path: pathlib.Path, keep: list | None) -> dict:
    """`verify`; appends each loaded array to `keep` when given, so a
    restore reads every file once."""
    with obs.span("ckpt.verify", path=str(path)):
        return _verify_body(path, path / "manifest.json", keep)


def _verify_body(path: pathlib.Path, mpath: pathlib.Path,
                 keep: list | None) -> dict:
    try:
        manifest = json.loads(mpath.read_text())
    except (OSError, ValueError) as e:
        # ValueError covers JSONDecodeError AND UnicodeDecodeError — a
        # flipped byte can break utf-8 before the JSON parser ever runs
        raise CorruptionError(f"unreadable manifest {mpath}: {e}") from e
    digest = manifest.get("integrity")
    if digest is None:
        raise CorruptionError(
            f"{mpath} has no integrity digest (pre-integrity checkpoint or "
            "stripped manifest); cannot be verified")
    if _manifest_digest(manifest) != digest:
        raise CorruptionError(
            f"manifest integrity hash mismatch in {mpath}: the manifest was "
            "modified after it was written")
    for meta in manifest["arrays"]:
        apath = path / meta["file"]
        try:
            arr = np.load(apath)
        except (OSError, ValueError) as e:
            raise CorruptionError(
                f"array {apath} unreadable/truncated: {e}") from e
        if (list(arr.shape) != list(meta["shape"])
                or str(arr.dtype) != _file_dtype(meta["dtype"])):
            raise CorruptionError(
                f"array {apath} header drift: got {arr.dtype}{arr.shape}, "
                f"manifest says {meta['dtype']}{tuple(meta['shape'])}")
        crc = _crc32(arr)
        if crc != meta["crc32"]:
            raise CorruptionError(
                f"array {apath} checksum mismatch: crc32 {crc:#010x} != "
                f"manifest {meta['crc32']:#010x} (bit flip or torn write)")
        if keep is not None:
            keep.append(arr)
    return manifest


def is_verified(directory: str | os.PathLike, step: int) -> bool:
    try:
        verify(pathlib.Path(directory) / f"step_{step:010d}")
        return True
    except CorruptionError:
        return False


def newest_verified_step(directory: str | os.PathLike) -> int | None:
    """The newest step whose checkpoint passes `verify`, else None."""
    for step in reversed(available_steps(directory)):
        if is_verified(directory, step):
            return step
    return None


def restore(directory: str | os.PathLike, example_tree: Any,
            step: int | None = None, *, device=None,
            verify_integrity: bool = True,
            fallback: bool = True) -> tuple[Any, int]:
    """Restore into the structure of `example_tree`. Returns (tree, step).

    `example_tree`'s leaves are tensors (meta tensors will do). Each leaf
    comes back as a tensor of its example leaf's dtype, on `device` when
    given, else on the example leaf's device (the CPU for a meta tensor). `verify_integrity` runs the full
    checksum/hash check first; `fallback` walks back from a checkpoint
    that fails it to the newest one that passes (`CorruptionError` only
    when none does). An explicit `step=` with `fallback=False` raises on
    that exact step.
    """
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with obs.span("ckpt.restore", step=step) as sp:
        loaded = None
        if verify_integrity:
            candidates = [step] + [s for s in
                                   reversed(available_steps(directory))
                                   if s < step]
            last_err: CorruptionError | None = None
            for cand in candidates:
                arrays: list = []
                try:
                    _verify(directory / f"step_{cand:010d}", arrays)
                except CorruptionError as e:
                    last_err = e
                    if not fallback:
                        raise
                    continue
                if cand != step:
                    # an attribute of the span, not an event: the train
                    # loop owns the (exactly-one) ckpt.fallback event
                    sp.set(fallback_from=step, step=cand)
                    step = cand
                loaded = arrays
                break
            else:
                raise CorruptionError(
                    f"no verifiable checkpoint under {directory} "
                    f"(newest failure: {last_err})")
        return _restore_body(directory, example_tree, step, device,
                             loaded), step


def _leaf_device(ref, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return ref.device if ref.device.type != "meta" else torch.device("cpu")


def _restore_body(directory: pathlib.Path, example_tree: Any, step: int,
                  device, loaded: list | None) -> Any:
    path = directory / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves, treedef = tree_flatten(example_tree)
    if manifest["n_arrays"] != len(leaves):
        raise CheckpointError(
            f"checkpoint {path} holds {manifest['n_arrays']} arrays but the "
            f"example tree has {len(leaves)} leaves: tree structure changed "
            "between save and restore")
    if loaded is None:
        loaded = [np.load(path / meta["file"]) for meta in manifest["arrays"]]
    new_leaves = []
    for i, (arr, meta, ref) in enumerate(zip(loaded, manifest["arrays"],
                                             leaves)):
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointError(
                f"array {i} of {path} has shape {tuple(arr.shape)} but the "
                f"example leaf expects {tuple(ref.shape)}: leaf shapes "
                "changed between save and restore")
        if meta["dtype"] == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        new_leaves.append(t.to(device=_leaf_device(ref, device),
                               dtype=ref.dtype))
    return tree_unflatten(treedef, new_leaves)


def read_manifest(directory: str | os.PathLike, step: int) -> dict:
    """The (unverified) manifest of one checkpoint step."""
    path = pathlib.Path(directory) / f"step_{step:010d}" / "manifest.json"
    return json.loads(path.read_text())


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training.

    `save` starts every CUDA leaf's device-to-host copy on a side stream
    into this checkpointer's pinned host buffers (`non_blocking`, one
    event after the last copy) and returns; a writer thread waits on the
    event, drops its references to the device tensors, then runs `save`
    (crc32 and np.save release the GIL, so the caller's next launches
    overlap them). The references keep the caching allocator from reusing
    a leaf's memory before its copy has landed. The port's train step is
    functional (it returns new tensors and writes none in place), so no
    device-side clone is taken. A background failure raises on the NEXT
    `save` and on `wait()`; as a context manager (or through the atexit
    hook) the in-flight save is drained, never dropped.
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 3, *,
                 io=None, retries: int = 3):
        self.directory = directory
        self.keep = keep
        self.io = io
        self.retries = retries
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._pinned: dict[int, torch.Tensor] = {}
        self._stream = None
        sweep_tmp(directory)  # crash-orphaned .tmp_* dirs from a prior run
        atexit.register(self._drain_at_exit)

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _snapshot(self, tree: Any):
        """(host tree, event or None, device tensors the copies read)."""
        leaves, treedef = tree_flatten(tree)
        on_card = [x for x in leaves
                   if isinstance(x, torch.Tensor) and x.is_cuda]
        if not on_card:
            return tree, None, []
        dev = on_card[0].device
        if any(x.device != dev for x in on_card):
            raise ValueError("AsyncCheckpointer.save: the tree's CUDA "
                             "leaves lie on more than one device")
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        host = []
        with torch.cuda.stream(self._stream):
            for i, x in enumerate(leaves):
                if not (isinstance(x, torch.Tensor) and x.is_cuda):
                    host.append(x)
                    continue
                buf = self._pinned.get(i)
                if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    self._pinned[i] = buf
                buf.copy_(x, non_blocking=True)
                host.append(buf)
            event = torch.cuda.Event()
            event.record(self._stream)
        return tree_unflatten(treedef, host), event, on_card

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        # a failed background save fails THIS call, before a new thread
        # launches — not just the next wait()
        self._raise_pending()
        self.wait()
        host_tree, event, held = self._snapshot(tree)

        def work():
            try:
                if event is not None:
                    event.synchronize()
                held.clear()   # the copies have landed
                save(self.directory, step, host_tree, keep=self.keep,
                     extra=extra, io=self.io, retries=self.retries)
            except BaseException as e:  # surfaced on next save()/wait()
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def close(self) -> None:
        """Drain the in-flight save, free the pinned buffers and
        unregister the atexit hook."""
        try:
            self.wait()
        finally:
            self._release()

    def _release(self) -> None:
        self._pinned.clear()
        atexit.unregister(self._drain_at_exit)

    def _drain_at_exit(self) -> None:
        # atexit: never raise, just make sure the bytes land
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> bool:
        if exc and exc[0] is not None:
            self._drain_at_exit()   # crashing: drain but keep the original
            self._release()
            return False
        self.close()
        return False


__all__ = ["AsyncCheckpointer", "CheckpointError", "CorruptionError",
           "available_steps", "is_verified", "latest_step",
           "newest_verified_step", "read_manifest", "restore", "save",
           "sweep_tmp", "verify"]
