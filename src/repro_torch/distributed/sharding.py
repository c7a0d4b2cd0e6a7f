"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
mapped onto ``torch.distributed.tensor`` (DTensor) placements.

The torch counterpart of ``repro.distributed.sharding``. Model code never
names mesh axes: it tags tensor dims with *logical* names ("batch",
"heads", "mlp", "vocab", ...). A ``sharding_scope`` binds a mesh and a
rule table mapping logical names to mesh axes; ``spec_for`` turns a shape
and its names into a per-dim tuple of mesh axes (the JAX package's
``PartitionSpec``), ``placements_for`` turns that into DTensor placements,
``distribute_tree`` places a tree of tensors by a tree of names (the
counterpart of ``tree_shardings`` + ``device_put``), and ``constrain``
redistributes a DTensor activation to its rule's layout (the counterpart of
``with_sharding_constraint``: a ``Partial`` sum constrained to a sharded
layout becomes a reduce-scatter). Where the layout of a region is known,
the model runs it on each rank's shards with explicit placements
(``shard_map``; the dense products through ``matmul``, table lookups
through ``sharded_rows``), rather than leaving its reshapes to DTensor's
propagation, which differs between torch releases.

Fallback contract: a logical dim that is not divisible by its mesh-axes
product is *replicated* (the rule is dropped for that tensor), and a mesh
axis may appear only once in a spec (the first dim that asks for it wins).

A mesh here is anything with axis names and sizes: a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a ``MeshShape`` (names and sizes, no
process group), so layouts can be computed, and tested, without devices.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.train.tree import leaves, leaves_up_to, unflatten

__all__ = ["default_rules", "MeshShape", "mesh_axes", "sharding_scope",
           "current_ctx", "scoped", "spec_for", "placements_for", "local_shape",
           "distribute_tree", "constrain", "full_tree", "is_dtensor",
           "as_dtensor", "assign_", "local_offset", "local_tree",
           "shapes_only", "shard_map", "local_narrow", "sharded_rows",
           "matmul"]

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple[Any, ...]  # per dim: None, one axis name, or a tuple of names


def default_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": (),  # in-layer activations' sequence dim
        # the residual stream's sequence dim: sharding it over model
        # (Megatron-style sequence parallelism) bounds remat memory; enabled
        # per shape by the dry run (train cells)
        "res_seq": (),
        "kv_seq": (),  # KV-cache sequence dim
        "act_embed": (),  # activations' d_model dim
        "heads": ("model",),
        "kv_heads": ("model",),
        # fallback TP dim for attention projections: when heads don't divide
        # the model axis (starcoder2 36H, qwen2-vl 28H, gemma2 8H), Dh=128
        # still shards; the duplicate-axis rule drops it when heads win
        "head_dim": ("model",),
        # Ulysses-style attention sequence parallelism: per-arch override
        # for the same heads-indivisible archs (activations side)
        "attn_seq": (),
        "mlp": ("model",),
        "vocab": ("model",),
        "embed": (),  # weights' d_model dim; FSDP configs override to data
        "experts": ("model",),
        "expert_mlp": (),  # per-expert hidden dim (grok: ("model",))
        # expert matrices' d_model dim, separate from "embed" so FSDP can be
        # scoped to the expert weights alone
        "expert_embed": (),
        "ssm_heads": ("model",),
        "ssm_state": (),
        "heads_joined": ("model",),  # flattened H*Dh projections (LoRA B)
        "kv_joined": ("model",),
        "conv": (),
        "lora": (),
        "frames": (),  # encoder frames (audio)
        "stack": (),  # the layer-stacking leading axis: never sharded
    }


class MeshShape(NamedTuple):
    """A mesh's axis sizes and names without devices or a process group
    (the counterpart of JAX's ``AbstractMesh``)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a DeviceMesh or a MeshShape."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Any
    rules: Rules


_CTX: contextvars.ContextVar[Optional[ShardingCtx]] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)


@contextlib.contextmanager
def sharding_scope(mesh, rules: Optional[Rules] = None, **overrides):
    """Bind ``mesh`` and the rule table (the defaults of the mesh's kind,
    or ``rules``) with ``overrides`` merged over it. Over a DeviceMesh, a
    plain tensor that meets a DTensor inside the scope counts as
    replicated."""
    base = dict(default_rules("pod" in mesh_axes(mesh))) if rules is None \
        else dict(rules)
    base.update(overrides)
    token = _CTX.set(ShardingCtx(mesh=mesh, rules=base))
    try:
        if hasattr(mesh, "mesh_dim_names"):
            # plain tensors the model makes (positions, masks, zeros) meet
            # DTensors as replicated ones
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(token)


def current_ctx() -> Optional[ShardingCtx]:
    return _CTX.get()


def scoped(fn):
    """``fn`` run under the sharding scope bound where ``scoped`` is called
    (as it is, where that is none): a checkpointed block's recompute runs
    on the autograd engine's thread, where no scope is bound, and must lay
    its activations out as the forward did."""
    ctx = current_ctx()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        if current_ctx() is ctx:
            return fn(*args, **kwargs)
        with sharding_scope(ctx.mesh, ctx.rules):
            return fn(*args, **kwargs)

    return run


def _axes_for(name: Optional[str], dim: int, ctx: ShardingCtx):
    """Mesh axes for one logical dim, with divisibility fallback."""
    if name is None:
        return None
    sizes = mesh_axes(ctx.mesh)
    axes = tuple(a for a in ctx.rules.get(name, ()) if a in sizes)
    if not axes:
        return None
    if dim % math.prod(sizes[a] for a in axes) != 0:
        return None  # replicate: the fallback contract
    return axes if len(axes) > 1 else axes[0]


def _flat(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(shape, names) -> Spec:
    """The per-dim mesh axes of a tensor of ``shape`` whose dims carry the
    logical ``names`` under the current scope (``()`` outside one)."""
    ctx = current_ctx()
    if ctx is None:
        return ()
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} has {len(shape)} dims, names "
                         f"{names} {len(names)}")
    used: set = set()
    parts = []
    for dim, name in zip(shape, names):
        axes = _axes_for(name, dim, ctx)
        flat = _flat(axes)
        if any(a in used for a in flat):  # an axis may appear only once
            axes = None
        else:
            used.update(flat)
        parts.append(axes)
    return tuple(parts)


def placements_for(spec: Spec, mesh) -> list:
    """DTensor placements (one per mesh axis) of ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim d is split over, ``Replicate()`` on the
    rest. A dim split over several axes, as ("pod", "data"), takes them
    major to minor in the mesh's order, as JAX lays out such a dim; a spec
    that lists them in another order is refused. An axis of size 1 splits
    nothing and is ``Replicate()`` (DTensor refuses reshapes of a dim
    "split" one way)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    order = list(sizes)
    out = [Replicate() for _ in order]
    for d, entry in enumerate(spec):
        axes = _flat(entry)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} splits over {axes}: not in the "
                             f"mesh's major-to-minor order {order}")
        for i in idx:
            if sizes[order[i]] > 1:
                out[i] = Shard(d)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """Each device's shape of a tensor of ``shape`` laid out by ``spec``
    (JAX's ``NamedSharding.shard_shape``; the fallback makes every split
    even)."""
    sizes = mesh_axes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(sizes[a] for a in _flat(e))
                 for n, e in zip(shape, spec))


_DTENSOR = []  # the DTensor class, imported on first use


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def distribute_tree(tree, specs, *, src_data_rank: Optional[int] = 0):
    """Place every tensor leaf of ``tree`` on the scope's ``DeviceMesh`` by
    the logical names of the matching leaf of ``specs`` (a same-shaped tree
    of name tuples); non-tensor leaves (counts) stay as they are. Every rank
    passes the whole tensor; ``src_data_rank=0`` sends rank 0's values
    (``distribute_tensor``), ``None`` has each rank keep its own slice (meta
    tensors, or values every rank drew alike)."""
    from torch.distributed.tensor import distribute_tensor

    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("distribute_tree needs an active sharding_scope")
    mesh = ctx.mesh
    names = leaves_up_to(tree, specs)
    out = []
    for x, nm in zip(leaves(tree), names):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        pl = placements_for(spec_for(x.shape, nm), mesh)
        out.append(distribute_tensor(x, mesh, pl,
                                     src_data_rank=src_data_rank))
    return unflatten(tree, out)


def local_tree(tree, specs, make):
    """DTensors shaped as the tensor leaves of ``tree`` (meta tensors do)
    and laid out by ``specs``, whose local shards come from ``make(shape,
    dtype)`` on this rank alone: nothing of the global size is ever
    allocated. Non-tensor leaves stay as they are."""
    from torch.distributed.tensor import DTensor

    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("local_tree needs an active sharding_scope")
    mesh = ctx.mesh
    out = []
    for x, nm in zip(leaves(tree), leaves_up_to(tree, specs)):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        spec = spec_for(x.shape, nm)
        loc = make(local_shape(x.shape, spec, mesh), x.dtype)
        out.append(DTensor.from_local(loc, mesh, placements_for(spec, mesh),
                                      run_check=False, shape=x.shape,
                                      stride=_contiguous(x.shape)))
    return unflatten(tree, out)


def shapes_only(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a builder of ``meta`` tensors, with every
    dispatch mode off: a tree of shapes is no work, and a mode that tallies
    allocations (the dry run's) must not count its global sizes."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return fn(*args, **kwargs)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def full_tree(tree):
    """Every DTensor leaf gathered to its whole tensor (``full_tensor``);
    other leaves as they are."""
    return unflatten(tree, [x.full_tensor() if is_dtensor(x) else x
                            for x in leaves(tree)])


def constrain(x, *names: Optional[str]):
    """Redistribute DTensor ``x`` to the layout its logical ``names`` get
    under the current scope; a plain tensor, or any tensor outside a scope,
    comes back unchanged."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    pl = placements_for(spec_for(x.shape, names), mesh)
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    (the same on every rank) replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def assign_(dst, src):
    """``dst.copy_(src)`` for a cache slot: a DTensor ``dst`` takes ``src``
    redistributed to its own layout, each rank copying its local shard (an
    in-place copy that changed placements would be refused)."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return dst
    src = as_dtensor(src, dst.device_mesh).redistribute(dst.device_mesh,
                                                        dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst


def local_offset(x, placements=None) -> Tuple[int, ...]:
    """The global index of this rank's first element of DTensor ``x``, per
    dim, as ``x`` is laid out or would be under ``placements``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements if placements is None
        else placements)
    return tuple(off)


def shard_map(fn, mesh, in_placements, out_placements):
    """``fn`` run by each rank on its local shards (``local_map``, JAX's
    ``shard_map``): the DTensor arguments are redistributed to
    ``in_placements`` (one list per argument, None for a non-tensor), the
    local results wrapped as ``out_placements`` (a list, or a tuple of
    lists). An argument replicated over a mesh axis that splits the work
    (an output sharded or partial there) gets a partial-sum gradient: each
    rank's share of it is summed in backward."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    outs = out_placements if isinstance(out_placements, tuple) \
        else (out_placements,)
    split = [any(not isinstance(o[m], Replicate) for o in outs)
             for m in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if isinstance(p, Replicate) and s else p
                   for p, s in zip(pl, split)] for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def local_narrow(x, dim: int, k: int, n: int):
    """The k-th of n equal slices of DTensor ``x`` along ``dim`` taken on
    each rank's shard (a microbatch of each rank's own rows), placements
    kept."""
    from torch.distributed.tensor import DTensor

    loc = x.to_local()
    size = loc.shape[dim] // n
    shape = list(x.shape)
    shape[dim] = shape[dim] // n
    return DTensor.from_local(loc.narrow(dim, k * size, size).contiguous(),
                              x.device_mesh, x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def sharded_rows(table, ids):
    """``table[ids]`` for a DTensor ``table`` whose rows may be split (a
    vocabulary, a node table): on the axes that split the table, each rank
    looks up all the ids (gathered whole) in its own rows (zero for the
    others), and the partial rows are summed back onto the ids' own split
    there (a reduce-scatter; an all-reduce where the ids are not split on
    that axis); on the other axes the ids keep their split. So the rows
    come out laid out as the ids: a batch split over every axis (the graph
    cell's pairs) stays split, and what follows runs on each rank's own
    rows. The lookup and its backward run on each rank's shards
    (``shard_map``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    ids = as_dtensor(ids, mesh)
    t_pl, i_pl, o_pl, final = [], [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        keep = pi if isinstance(pi, Shard) else Replicate()
        final.append(keep)
        if isinstance(pt, Shard) and pt.dim == 0:
            t_pl.append(pt)
            i_pl.append(Replicate())
            o_pl.append(Partial())
        else:
            t_pl.append(Replicate())
            i_pl.append(keep)
            o_pl.append(keep)
    lo = local_offset(table.redistribute(mesh, t_pl))[0] \
        if any(isinstance(p, Shard) for p in t_pl) else 0

    def local(table, ids):
        n = table.shape[0]
        ids = ids.long() - lo
        mine = (ids >= 0) & (ids < n)
        # another rank's id reads a row spread by its value (a clamp would
        # send them all to one row, and the backward's accumulation into
        # that row runs one add after another)
        rows = table[ids.remainder(n)]
        return rows * mine[..., None].to(rows.dtype)

    out = shard_map(local, mesh, (t_pl, i_pl), o_pl)(table, ids)
    return out.redistribute(mesh, final)


def matmul(x, w, kdims: int = 1, local=None):
    """``x @ w`` contracting x's last ``kdims`` dims with w's first ones
    (``local(x, w)`` computes it on plain tensors; default ``x @ w``). On
    DTensors each rank multiplies its own shards (``shard_map``): x keeps
    its batch split (dim 0); w keeps its split of an output dim (the
    product is split likewise) or of a contracted dim (x is split to match
    and the product is a partial sum, for the next ``constrain`` to
    scatter), on the mesh axes the batch does not use, and is gathered on
    the others (FSDP). Every other split of x (a sequence-parallel one) is
    gathered first: DTensor's own matmul would reshape a split dim, which
    older releases refuse."""
    if local is None:
        def local(a, b):
            return a @ b
    if not (is_dtensor(x) or is_dtensor(w)):
        return local(x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (w if is_dtensor(w) else x).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    lead = x.ndim - kdims  # x's dims before the contracted ones
    x_pl, w_pl, o_pl = [], [], []
    for px, pw in zip(x.placements, w.placements):
        batch = isinstance(px, Shard) and px.dim == 0 and lead > 0
        if isinstance(pw, Shard) and not batch and pw.dim >= kdims:
            x_pl.append(Replicate())
            w_pl.append(pw)
            o_pl.append(Shard(lead + pw.dim - kdims))
        elif isinstance(pw, Shard) and not batch:
            x_pl.append(Shard(lead + pw.dim))
            w_pl.append(pw)
            o_pl.append(Partial())
        else:
            x_pl.append(px if batch else Replicate())
            w_pl.append(Replicate())
            o_pl.append(px if batch else Replicate())
    return shard_map(local, mesh, (x_pl, w_pl), o_pl)(x, w)
