"""Atomic, asynchronous checkpoints in the JAX package's on-disk format.

The torch counterpart of ``repro.distributed.checkpoint``; a directory
written by either package restores in the other:

    <dir>/step_000000123/
        manifest.json       # step, leaf names, shapes, dtypes, shard index
        leaf_<i>_<j>.npy    # shard j of leaf i (one shard per leaf here)
        _COMMITTED          # written last: torn checkpoints are never loaded

Leaves are named as ``train.tree.leaf_paths`` names them (``params/...``,
``opt/0/.mu/...``, ``opt/2``), exactly the JAX package's strings. A bf16
leaf is stored as raw 2-byte words (numpy ``V2``, the bytes the JAX package
writes for an ml_dtypes bfloat16 array) with ``"bfloat16"`` in the
manifest, and read back through ``view(torch.int16)`` / ``view(
torch.bfloat16)``: numpy has no bfloat16 of its own. Counts (Python ints)
are stored as int32, as the JAX package's are.

Guarantees, as in the JAX package:
  * atomicity: writes go to ``step_*.tmp``, fsynced, then ``os.rename``;
    readers only trust directories holding ``_COMMITTED`` and a manifest
    that parses; the parent directory is fsynced after the rename;
  * async: ``save(..., blocking=False)`` copies every leaf to host memory
    before it returns (the optimizer may then update the tensors in place)
    and writes on a background thread; ``wait()`` joins it, and the next
    save waits first (one write in flight);
  * retention: the newest ``keep`` committed checkpoints stay;
  * ``restore_latest`` walks committed steps newest first and skips one
    that fails to load.
A DTensor leaf (``launch/train --mesh``) is saved whole (gathered on every
rank, written by rank 0) and restored into each rank's own slice, so a
checkpoint moves between meshes; restore also reads a leaf saved as
several shards (a JAX checkpoint from a mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.train.tree import leaf_paths, unflatten

__all__ = ["CheckpointManager"]

BF16 = "bfloat16"


def _host(leaf):
    """(numpy copy of ``leaf``, the manifest's dtype name); a DTensor is
    gathered whole first (every rank takes part)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).to("cpu", copy=True).numpy()
            return words.view(np.dtype("V2")), BF16
        arr = t.to("cpu", copy=True).numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)  # a count, int32 as in JAX
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _copy_into(t, x):
    """``t.copy_(x)`` of a whole saved tensor: a DTensor target takes its
    own slice of x on each rank."""
    if not is_dtensor(t):
        return t.copy_(x)
    from torch.distributed.tensor import distribute_tensor
    loc = t.to_local()
    part = distribute_tensor(x.to(loc.device), t.device_mesh, t.placements,
                             src_data_rank=None)
    loc.copy_(part.to_local())
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree: Any, *, blocking: bool = True):
        """Snapshot ``tree`` (tensors, numpy arrays, ints) for ``step``.
        DTensor leaves are saved whole, so a checkpoint moves between
        meshes; every rank calls this, and rank 0 alone writes."""
        self.wait()
        entries = [(name, *_host(leaf)) for name, leaf in leaf_paths(tree)]
        if _rank() != 0:
            return

        def write():
            final = os.path.join(self.directory, f"step_{step:09d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for i, (name, arr, dtype) in enumerate(entries):
                fn = f"leaf_{i:05d}_0000.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append({
                    "name": name, "shape": list(arr.shape), "dtype": dtype,
                    "shards": [{"file": fn,
                                "index": [[0, int(n)] for n in arr.shape]}],
                })
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            # fsync the parent so the rename itself survives power loss
            dfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def _is_committed(self, d: str) -> bool:
        """True iff ``d`` holds the commit marker and a manifest that
        parses: a crash that raced the rename can leave a marker beside a
        torn manifest, and such a directory must never win over an older
        committed step."""
        if not os.path.exists(os.path.join(d, "_COMMITTED")):
            return False
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                json.load(f)
        except (OSError, ValueError):
            return False
        return True

    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.directory)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if self._is_committed(os.path.join(self.directory, d)):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, target: Any) -> tuple:
        """Restore the newest loadable checkpoint -> ``(step, tree)``,
        skipping committed steps that fail to load (torn shard files; the
        target's tensors they reached are overwritten by the next older
        step); ``FileNotFoundError`` when none restores."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, target)
            except (OSError, ValueError, KeyError):
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.directory}")

    def restore(self, step: int, target: Any) -> Any:
        """Rebuild the tree for ``step`` with ``target``'s structure. Each
        tensor leaf is read into the target's tensor in place, one leaf at a
        time through host memory, so a resume allocates no second copy of
        the params and optimizer state on the card; an int leaf comes back
        as an int, anything else as a numpy array. A saved shape or dtype
        other than a target tensor's raises ``ValueError``."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        if not os.path.exists(os.path.join(d, "_COMMITTED")):
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

        out = []
        for name, t in leaf_paths(target):
            meta = by_name[name]
            shape = tuple(meta["shape"])
            bf16 = meta["dtype"] == BF16
            full = np.zeros(shape, np.int16 if bf16 else np.dtype(meta["dtype"]))
            for shard in meta["shards"]:
                data = np.load(os.path.join(d, shard["file"]))
                if bf16:
                    data = data.view(np.int16)
                full[tuple(slice(lo, hi) for lo, hi in shard["index"])] = data
            if isinstance(t, torch.Tensor):
                x = torch.from_numpy(full)
                if bf16:
                    x = x.view(torch.bfloat16)
                if (tuple(t.shape), t.dtype) != (shape, x.dtype):
                    raise ValueError(f"{name}: saved {shape} {x.dtype}, "
                                     f"target {tuple(t.shape)} {t.dtype}")
                out.append(_copy_into(t, x))
            elif isinstance(t, int) and not isinstance(t, bool):
                out.append(int(full))
            else:
                out.append(full)
        return unflatten(target, out)
