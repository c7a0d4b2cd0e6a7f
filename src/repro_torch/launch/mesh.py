"""Mesh factory of the port, over ``torch.distributed.device_mesh``.

The torch counterpart of ``repro.launch.mesh``. The per-pod production mesh
is 16x16 = 256 devices, axes (data, model); the multi-pod mesh prepends a
pure data-parallel "pod" axis: (2, 16, 16) = 512. These are FUNCTIONS, and
importing this module touches no process group.

``init_world`` starts the default process group explicitly: under
``torchrun`` (``WORLD_SIZE`` and ``RANK`` in the environment) the real one,
NCCL on the card and gloo on the CPU; with no launcher a world of one; with
``fake_world=N`` the fake backend of N ranks in this one process, whose
collectives move no data (``launch.dryrun`` alone asks for it: the train and
serve paths never start a fake group).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch

__all__ = ["init_world", "make_mesh", "make_production_mesh", "use_mesh",
           "parse_mesh", "world_size"]


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def init_world(*, device="cuda", fake_world: Optional[int] = None) -> int:
    """Start the default process group once; returns its world size. A
    group already started is kept (its size is returned)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if fake_world is not None:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(fake_world))
        return int(fake_world)
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:  # a world of one, no launcher
        store = dist.HashStore()
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return dist.get_world_size()


def parse_mesh(spec: str):
    """"DxM" -> ((D, M), ("data", "model")); "PxDxM" -> ((P, D, M), ("pod",
    "data", "model")); "" -> None (one device, no mesh)."""
    if not spec:
        return None
    dims = tuple(int(x) for x in spec.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: want DxM or PxDxM")
    return dims, axes


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the started
    world, whose size must be the mesh's product."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks; the world has "
                         f"{world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def use_mesh(mesh):
    """Context manager activating ``mesh`` for the model code's sharding
    (``distributed.sharding.sharding_scope`` with the mesh's default
    rules); the JAX package enters meshes through its helper of this
    name."""
    from repro_torch.distributed.sharding import sharding_scope
    return sharding_scope(mesh) if mesh is not None \
        else contextlib.nullcontext()
