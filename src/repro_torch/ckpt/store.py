# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Fault-tolerant checkpointing: manifest + per-leaf raw arrays, async
save (port of ``repro/ckpt/store.py``, same files on disk).

Layout (one directory per step):

    <root>/step_000123/
        MANIFEST.json      step, time, extra, and per leaf its file,
                           shape and dtype name
        <leaf-key>.npy     one raw array per leaf (``key`` with ``/``
                           replaced by ``__``)
        COMMITTED          written LAST — a directory without it is a torn
                           save (preemption mid-write) and is ignored/GC'd.

Keys are ``repro_torch.tree.leaves_with_keys``'s, the JAX store's scheme,
so a checkpoint written by either package loads into the other.  A
bfloat16 leaf is written as the raw 2-byte ``.npy`` (``|V2``) that the
JAX store writes for it, with manifest dtype ``"bfloat16"``, and read
back by reinterpreting its bits (``repro_torch.convert``).

Every save snapshots the tree to host memory (real copies: the pod steps
its state in place, so the next ingest overwrites the tensors) before it
returns.  ``save_async`` writes its files on a daemon thread from that
snapshot only; ``wait()`` joins it and re-raises its failure.  Saved
arrays are whole: ``load`` puts every leaf on one device.  A tree of
DTensors (training on a mesh) is written with no gather, each rank its
own block of every leaf into the leaf's one file (``_write_blocks``); a
restore into a DTensor donor reads each rank's block back on the
donor's placements.  Either way the files are a whole tree's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import dtype_name, leaf_to_numpy, tensor_from_numpy
from repro_torch.device import resolve_device
from repro_torch.tree import leaves_with_keys

COMMIT_MARK = "COMMITTED"
MANIFEST = "MANIFEST.json"

HostLeaves = Dict[str, Tuple[np.ndarray, str]]  # key -> (array, dtype name)


def host_snapshot(tree) -> HostLeaves:
    """Every leaf of ``tree`` copied to host memory with its dtype name
    (a bfloat16 leaf as its ``uint16`` bits); a DTensor leaf gathered
    whole first (a collective: every rank of its mesh snapshots)."""
    from repro_torch.launch.mesh import full_tensor

    return {k: (leaf_to_numpy(full_tensor(v)), dtype_name(v))
            for k, v in leaves_with_keys(tree).items()}


def _sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(v, DTensor)
               for v in leaves_with_keys(tree).values())


def _file_dtype(t: torch.Tensor):
    """The dtype of a leaf's ``.npy`` records (bfloat16: the raw 2-byte
    ``V2`` the JAX store writes)."""
    name = dtype_name(t)
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _file_of(key: str) -> str:
    return key.replace("/", "__") + ".npy"


class CheckpointStore:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ save
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:09d}"

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> Path:
        """Synchronous save: snapshot to host, write leaves, commit-mark.

        Joins (and re-raises any failure of) an in-flight async save
        first — sync and async writes must never race on a step dir.
        """
        with obs.span("ckpt_save", step=step, mode="sync"):
            self.wait()
            if _sharded(tree):
                return self._write_blocks(step, tree, extra or {})
            host = host_snapshot(tree)
            return self._write(step, host, extra or {}, mode="sync")

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        """Snapshot to host now; write files on a daemon thread.

        A failure of the in-flight write is never swallowed: it re-raises
        from the next ``wait()`` — which this method calls first, so a
        failed previous save surfaces here rather than looking committed.
        A sharded tree is saved synchronously (``_write_blocks``: every
        rank writes as the others do).
        """
        if _sharded(tree):
            self.save(step, tree, extra)
            return
        with obs.span("ckpt_save", step=step, mode="async"):
            # the span prices only the synchronous cost the caller pays
            # (join + host snapshot); the file write is the bg span below
            self.wait()
            host = host_snapshot(tree)

        def _bg():
            try:
                with obs.span("ckpt_write", step=step, mode="async"):
                    self._write(step, host, extra or {}, mode="async")
            except BaseException as e:  # surfaced by wait()
                self._async_exc = e

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the in-flight async save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise RuntimeError(
                f"async checkpoint save to {self.root} failed") from exc

    def _write(self, step: int, host: HostLeaves, extra: Dict,
               mode: str = "sync") -> Path:
        tmp = self._fresh_tmp(step)
        for key, (arr, dt) in host.items():
            # bfloat16 bits as the raw 2-byte records the JAX store writes
            np.save(tmp / _file_of(key),
                    arr.view("V2") if dt == "bfloat16" else arr)
        return self._commit(step, tmp, {k: (arr.shape, dt) for k, (arr, dt)
                                        in host.items()}, extra, mode)

    def _fresh_tmp(self, step: int) -> Path:
        tmp = self._step_dir(step).with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    def _write_blocks(self, step: int, tree, extra: Dict) -> Path:
        """A tree of DTensors (training on a mesh), saved with no gather:
        global rank 0 lays out each leaf's whole ``.npy`` file, every rank
        writes its own block of each leaf into it (a block that several
        ranks hold alike is written by the first of them), and rank 0
        commits once all have written.  The files are those of a whole
        tree."""
        import torch.distributed as dist
        from numpy.lib.format import open_memmap
        from torch.distributed.tensor import DTensor, Shard

        from repro_torch.launch.mesh import local_slices

        leaves = leaves_with_keys(tree)
        first = dist.get_rank() == 0
        tmp = self._step_dir(step).with_suffix(".tmp")
        if first:
            self._fresh_tmp(step)
            for key, v in leaves.items():
                open_memmap(tmp / _file_of(key), mode="w+",
                            dtype=_file_dtype(v), shape=tuple(v.shape))
        dist.barrier()
        for key, v in leaves.items():
            if isinstance(v, DTensor):
                pl, coord = v.placements, v.device_mesh.get_coordinate()
                if any(c and not isinstance(p, Shard)
                       for p, c in zip(pl, coord)):
                    continue
                block = local_slices(v.shape, v.device_mesh, pl)
                arr = leaf_to_numpy(v.to_local())
            elif first:
                block, arr = (), leaf_to_numpy(v)
            else:
                continue
            out = open_memmap(tmp / _file_of(key), mode="r+")
            out[block] = arr.view(out.dtype)
            out.flush()
            del out
        dist.barrier()
        d = self._step_dir(step)
        if first:
            self._commit(step, tmp, {k: (tuple(v.shape), dtype_name(v))
                                     for k, v in leaves.items()}, extra,
                         "sync")
        dist.barrier()  # every rank returns once the step is committed
        return d

    def _commit(self, step: int, tmp: Path, leaves: Dict, extra: Dict,
                mode: str) -> Path:
        """The manifest, the commit mark, the rename; then the GC."""
        d = self._step_dir(step)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "leaves": {key: {"file": _file_of(key), "shape": list(shape),
                             "dtype": dt}
                       for key, (shape, dt) in leaves.items()},
        }
        (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
        (tmp / COMMIT_MARK).write_text("ok")
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)
        self._gc()
        reg = obs.get_registry(None)
        if reg.enabled:  # counted only once COMMITTED exists
            reg.counter("ckpt_saves_total", "committed checkpoint saves",
                        ("mode",)).labels(mode=mode).inc()
            reg.counter("ckpt_saved_bytes_total",
                        "leaf bytes written into committed checkpoints"
                        ).inc(sum(math.prod(shape) * (
                            2 if dt == "bfloat16" else np.dtype(dt).itemsize)
                            for shape, dt in leaves.values()))
        return d

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # torn saves (no commit mark) from preemptions
        for p in self.root.glob("step_*"):
            if p.is_dir() and not (p / COMMIT_MARK).exists() \
                    and not p.suffix == ".tmp":
                shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------ load
    def committed_steps(self):
        out = []
        for p in sorted(self.root.glob("step_*")):
            if (p / COMMIT_MARK).exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def load(self, step: int, like, *, device=None) -> Tuple[Any, Dict]:
        """Restore the tree ``like`` (structure, shape and dtype donor; its
        leaves may be ``meta`` tensors, see
        ``SummarizerPod.abstract_state``) -> ``(tree, extra)``.  Every
        leaf goes to ``device``, or to the donor leaf's own device
        (``cuda`` for a ``meta`` donor); there is no ``shardings``
        argument: one card holds the whole tree."""
        # a DTensor donor leaf comes back a DTensor with its placements
        # (every rank reads the whole leaf and keeps its own shard)
        with obs.span("ckpt_restore", step=step):
            d = self._step_dir(step)
            manifest = json.loads((d / MANIFEST).read_text())

            def read(key, mmap=False):
                info = manifest["leaves"][key]
                return (np.load(d / info["file"],
                                mmap_mode="r" if mmap else None),
                        info["dtype"])
            return _rebuild_like(like, read, device), manifest["extra"]


def _rebuild_like(like, read: Callable[[str], Tuple[np.ndarray, str]],
                  device=None, prefix: str = ""):
    """``like`` rebuilt from host leaves fetched by key through ``read``
    (dataclasses, dicts, tuples and NamedTuples recursed, keyed as
    ``leaves_with_keys`` keys them; other non-tensor fields kept); each
    leaf must have the donor's shape and dtype."""
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild_like(getattr(like, f.name), read, device,
                                  f"{prefix}{f.name}/")
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild_like(v, read, device, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(
            _rebuild_like(v, read, device, f"{prefix}{k}/")
            for k, v in zip(like._fields, like)))
    if isinstance(like, tuple):
        return type(like)(_rebuild_like(v, read, device, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if not isinstance(like, torch.Tensor):
        return like
    from torch.distributed.tensor import DTensor

    key = prefix[:-1]
    sharded = isinstance(like, DTensor)
    arr, dt = read(key, mmap=True) if sharded else read(key)
    if dt != dtype_name(like) or tuple(arr.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {key!r} is {dt}{list(arr.shape)}, the donor "
            f"wants {dtype_name(like)}{list(like.shape)}")
    dev = (resolve_device(device) if device is not None
           else resolve_device(None) if like.device.type == "meta"
           else like.device)
    if sharded:  # only this rank's block is read from the file
        from repro_torch.launch.mesh import local_slices

        mesh, pl = like.device_mesh, like.placements
        local = tensor_from_numpy(arr[local_slices(arr.shape, mesh, pl)], dev)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=like.shape, stride=like.stride())
    return tensor_from_numpy(arr, dev)


class MemoryStore:
    """In-memory CheckpointStore: same save/load/latest_step surface,
    dict-backed, nothing touches disk.

    The pod handoff path exists for this store: a live migration
    snapshots the source pod's session rows for milliseconds — paying a
    directory write and a JSON manifest to move a few (K, d) rows between
    two pods in the same process would put disk latency inside the
    handoff's quiesce window.  Anything accepting a ``CheckpointStore``
    accepts one of these (``save``/``save_async``/``wait``/``load``/
    ``latest_step``/``committed_steps`` — saves are synchronous, a host
    snapshot is the whole cost).  Not fault-tolerant by design: it dies
    with the process; use the disk store for that.
    """

    def __init__(self, keep: int = 3):
        self.keep = keep
        self.root = "<memory>"  # error-message parity with the disk store
        self._steps: Dict[int, Tuple[HostLeaves, Dict]] = {}

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        self._steps[step] = (host_snapshot(tree), dict(extra or {}))
        if self.keep:
            for s in sorted(self._steps)[: -self.keep]:
                del self._steps[s]
        return step

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        self.save(step, tree, extra)  # the snapshot IS the cost; no thread

    def wait(self):
        pass

    def committed_steps(self):
        return sorted(self._steps)

    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    def load(self, step: int, like, *, device=None) -> Tuple[Any, Dict]:
        leaves, extra = self._steps[step]
        return (_rebuild_like(like, lambda k, mmap=False: leaves[k], device),
                dict(extra))
