"""Row-sharding plan for the serving stack's node-indexed device state.

The torch counterpart of ``repro.serve.shard``. ``ShardPlan`` lays every
*node-indexed* device array of the online stack — the ``EmbeddingStore``
table, the ``DynamicGraph`` ELL mirror, and the candidate matrices of the
fused h-index descent — out row-sharded over ``n_shards`` devices.

Sharding here is strictly a **placement** concern, never a semantics one:
the host-side state machines (slot assignment, LRU clocks, spill dicts,
core-repair control flow) are byte-identical across shard counts, and the
device work is the same integer/float math run on each shard's rows. So
``--shards N`` equals ``--shards 1`` bit for bit on every serve operation:
embeddings, core numbers, staleness, eviction counts.

Where the JAX package hands its arrays to GSPMD under one mesh, the port
keeps one process and one chunk per shard: a :class:`RowSharded` array is a
list of contiguous per-shard chunks, chunk ``s`` on ``plan.devices[s]``, and
the per-shard programs are plain functions over those chunks (a gather, a
whole-row / cell scatter, a partial top-k). Rows move between devices by
copies the host issues. A :class:`Replicated` array keeps one copy per
distinct device of the plan. ``devices`` may repeat a device: four shards on
one card run every per-shard program four times on it.

A disabled plan (``n_shards == 1``) is inert: callers skip every plan hook
and run the exact single-device code path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import metrics

__all__ = ["ShardPlan", "RowSharded", "Replicated", "ship", "map_rows",
           "take_rows", "put_rows", "put_cells", "row_chunks", "replicas",
           "to_host", "partial_topk", "merge_topk"]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Row-sharding of the node axis across ``devices``.

    Rows ``[0, n_rows)`` are split into ``n_shards`` contiguous chunks;
    shard ``s`` owns rows ``[s * chunk, (s + 1) * chunk)`` on
    ``devices[s]``, where ``chunk = n_rows / n_shards`` (callers pad row
    counts with ``pad_rows`` so the split is exact).

    ``traffic`` counts, per operation, the bytes the plan's arrays copy
    between a shard ``s >= 1`` and the primary device or the host: the
    copies a deployment with one card per shard makes over the
    interconnect (shards that share a card copy within it). The unsharded
    path makes none of them. Operations: ``place`` (host uploads and
    replicas), ``gather`` (rows read onto the primary), ``scatter`` (rows
    and cells written to their owners), ``topk`` (queries out, candidate
    lists back), ``descent`` (each sweep's estimates in, results out, the
    new estimates to every replica) and ``region`` (frontier slices out,
    discovered ids back).
    """

    n_shards: int = 1
    devices: Tuple[torch.device, ...] = ()
    traffic: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @staticmethod
    def build(n_shards: int = 1, *, device="cuda",
              devices=None) -> "ShardPlan":
        """Build a plan over ``n_shards`` devices (1 = disabled).

        Shard counts must be powers of two, as in the JAX package (the
        serve stack pads its row dimensions to powers of two). ``device``
        ``"cuda"`` puts shard ``s`` on ``cuda:s`` and refuses more shards
        than visible cards; ``"cpu"`` puts every chunk on the CPU (the
        counterpart of ``--xla_force_host_platform_device_count``). An
        explicit ``devices`` list (one per shard) may repeat a device.

        Plans are cached per arguments: every store and graph built for the
        same shard count shares one plan (and its ``traffic``).
        """
        devs = None if devices is None else tuple(str(d) for d in devices)
        return _build_cached(int(n_shards), str(device), devs)

    # ----------------------------------------------------------- predicates

    @property
    def enabled(self) -> bool:
        return self.n_shards > 1 and bool(self.devices)

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where gathered rows and host uploads land."""
        return self.devices[0]

    # ------------------------------------------------------------ placement

    def pad_rows(self, n_rows: int) -> int:
        """Smallest row count >= ``n_rows`` divisible by ``n_shards``."""
        if not self.enabled:
            return int(n_rows)
        return -(-int(n_rows) // self.n_shards) * self.n_shards

    def place_rows(self, x) -> "RowSharded":
        """Upload ``x`` (numpy or tensor) as a :class:`RowSharded`; axis 0
        must divide by ``n_shards`` (pad it with :meth:`pad_rows`)."""
        x = torch.as_tensor(x)
        if x.shape[0] % self.n_shards:
            raise ValueError(
                f"ShardPlan.place_rows: axis 0 ({x.shape[0]} rows) is not "
                f"divisible by n_shards={self.n_shards}; pad the row count "
                "with plan.pad_rows first"
            )
        metrics().counter("shard_row_placements_total").inc()
        c = x.shape[0] // self.n_shards
        return RowSharded(self, [
            ship(x[s * c:(s + 1) * c], d, self, s, "place", copy=True)
            for s, d in enumerate(self.devices)])

    def replicate(self, x) -> "Replicated":
        x = torch.as_tensor(x)
        self.note_fanout("place", x)
        return Replicated(self, x)

    # ----------------------------------------------------------- accounting

    def note(self, op: str, nbytes: int) -> None:
        """Add ``nbytes`` to ``traffic[op]``."""
        if nbytes:
            self.traffic[op] = self.traffic.get(op, 0) + int(nbytes)

    def note_fanout(self, op: str, *xs: torch.Tensor) -> None:
        """Count one copy of each of ``xs`` to every shard past the
        primary (a write to every replica)."""
        self.note(op, (self.n_shards - 1) * sum(_nbytes(x) for x in xs))

    def shard_of_rows(self, rows, n_rows: int) -> np.ndarray:
        """Owning shard of each row id under a ``n_rows``-row layout."""
        rows = np.asarray(rows, np.int64)
        if not self.enabled:
            return np.zeros(rows.shape, np.int64)
        chunk = max(self.pad_rows(n_rows) // self.n_shards, 1)
        return np.minimum(rows // chunk, self.n_shards - 1)

    def balance_of(self, rows, n_rows: int) -> np.ndarray:
        """(n_shards,) count of ``rows`` owned by each shard."""
        return np.bincount(
            self.shard_of_rows(rows, n_rows), minlength=max(self.n_shards, 1)
        )


@functools.lru_cache(maxsize=None)
def _build_cached(n_shards: int, device: str,
                  devices: Optional[tuple]) -> ShardPlan:
    if n_shards <= 1:
        return ShardPlan()
    if n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    if devices is not None:
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
        return ShardPlan(n_shards, tuple(resolve_device(d) for d in devices))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ShardPlan(n_shards, (dev,) * n_shards)
    if dev.type != "cuda":
        raise ValueError(f"cannot shard rows over {device!r}")
    avail = torch.cuda.device_count()
    if avail < n_shards:
        seen = [torch.cuda.get_device_name(i) for i in range(avail)]
        raise ValueError(
            f"ShardPlan needs {n_shards} CUDA devices but only {avail} are "
            f"visible ({seen}); pass devices=[...] to put several shards on "
            "one card, or device='cpu'"
        )
    return ShardPlan(n_shards, tuple(
        torch.device("cuda", i) for i in range(n_shards)))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def ship(x: torch.Tensor, device, plan, shard: int, op: str,
         copy: bool = False) -> torch.Tensor:
    """``x.to(device)`` for a copy between shard ``shard``'s memory and
    the primary device or the host, counted in ``plan.traffic[op]`` when
    ``shard >= 1`` (``plan`` None: no plan, nothing counted)."""
    if plan is not None and shard:
        plan.note(op, _nbytes(x))
    return x.to(device, copy=copy)


class RowSharded:
    """A row-sharded array: ``chunks[s]`` holds rows ``[s * chunk, (s + 1)
    * chunk)`` on ``plan.devices[s]``. Reads gather onto the plan's primary
    device; writes go to the owning shard's chunk in place."""

    def __init__(self, plan: ShardPlan, chunks):
        self.plan = plan
        self.chunks = list(chunks)
        self.chunk = int(self.chunks[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.chunk * len(self.chunks),
                           *self.chunks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.plan.primary

    def map(self, fn) -> "RowSharded":
        """``fn`` applied to every chunk (a per-row op keeps the layout)."""
        return RowSharded(self.plan, [fn(c) for c in self.chunks])

    def _route(self, rows: torch.Tensor):
        """Group ``rows`` by owning shard: ``(order, local rows in that
        order, rows per shard)``, one host read of the counts."""
        rows = rows.to(self.device, torch.long).reshape(-1)
        own = torch.div(rows, self.chunk, rounding_mode="floor")
        order = torch.argsort(own, stable=True)
        counts = torch.bincount(own, minlength=len(self.chunks)).tolist()
        return order, rows[order] - own[order] * self.chunk, counts

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``x[rows]`` on the primary device: each shard gathers the rows
        it owns, and the host copies them over (the all-gather)."""
        order, local, counts = self._route(rows)
        parts, at = [], 0
        for s, (c, n) in enumerate(zip(self.chunks, counts)):
            if n:
                li = ship(local[at:at + n], c.device, self.plan, s, "gather")
                parts.append(ship(c[li], self.device, self.plan, s, "gather"))
            at += n
        out = torch.empty((len(order), *self.chunks[0].shape[1:]),
                          dtype=self.dtype, device=self.device)
        if parts:
            out[order] = torch.cat(parts)
        return out

    def set_rows(self, rows: torch.Tensor, vals: torch.Tensor) -> None:
        """``x[rows] = vals`` (whole rows, any rank), each write on its
        owner's chunk (``index_copy_``)."""
        order, local, counts = self._route(rows)
        vals = vals.to(self.device)[order]
        at = 0
        for s, (c, n) in enumerate(zip(self.chunks, counts)):
            if n:
                sl = slice(at, at + n)
                c.index_copy_(
                    0, ship(local[sl], c.device, self.plan, s, "scatter"),
                    ship(vals[sl], c.device, self.plan, s, "scatter"))
            at += n

    def set_cells(self, rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> None:
        """``x[rows, cols] = vals`` on a rank-2 array, each cell on its
        owner's chunk."""
        order, local, counts = self._route(rows)
        cols = cols.to(self.device)[order]
        vals = vals.to(self.device)[order]
        at = 0
        for s, (c, n) in enumerate(zip(self.chunks, counts)):
            if n:
                sl = slice(at, at + n)
                r, k, v = (ship(t[sl], c.device, self.plan, s, "scatter")
                           for t in (local, cols, vals))
                c[r, k] = v
            at += n

    def to_host(self) -> np.ndarray:
        """The whole array as one host copy."""
        return np.concatenate([c.cpu().numpy() for c in self.chunks])


class Replicated:
    """One copy of an array per distinct device of a plan (shards that
    share a device share its copy)."""

    def __init__(self, plan: ShardPlan, x: torch.Tensor):
        self.plan = plan
        self.copies = {}
        for d in plan.devices:
            if d not in self.copies:
                self.copies[d] = x.to(d, copy=True)


# ---------------------------------------------------------------- helpers
# Callers hold either a plain tensor (no plan) or a RowSharded array; these
# take both, so the unsharded path runs the same code as one chunk.


def row_chunks(x):
    """``[(first row, chunk)]``: one chunk for a plain tensor."""
    if isinstance(x, RowSharded):
        return [(s * x.chunk, c) for s, c in enumerate(x.chunks)]
    return [(0, x)]


def replicas(x):
    """``{device: copy}``: the tensor itself for a plain tensor."""
    if isinstance(x, Replicated):
        return x.copies
    return {x.device: x}


def map_rows(x, fn):
    """``fn`` applied to every chunk (a per-row op keeps the layout)."""
    if isinstance(x, RowSharded):
        return x.map(fn)
    return fn(x)


def take_rows(x, rows: torch.Tensor) -> torch.Tensor:
    """``x[rows]`` on x's (primary) device."""
    if isinstance(x, RowSharded):
        return x.gather(rows)
    return x[rows.to(x.device, torch.long)]


def put_rows(x, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """``x[rows] = vals`` in place (whole rows)."""
    if isinstance(x, RowSharded):
        x.set_rows(rows, vals)
    else:
        x.index_copy_(0, rows.to(x.device, torch.long), vals.to(x.device))


def put_cells(x, rows: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``x[rows, cols] = vals`` in place."""
    if isinstance(x, RowSharded):
        x.set_cells(rows, cols, vals)
    else:
        x[rows.to(x.device), cols.to(x.device)] = vals.to(x.device)


def to_host(x) -> np.ndarray:
    """A host copy of the whole array."""
    if isinstance(x, RowSharded):
        return x.to_host()
    return x.cpu().numpy().copy()


# ------------------------------------------------------------ partial top-k


def partial_topk(q: torch.Tensor, table, valid: np.ndarray, k: int):
    """Shard-local partial top-k over a score table (one chunk unsharded).

    ``q`` (Q, D) on any device, ``table`` the (rows, D) candidates (a
    tensor or a ``RowSharded``), ``valid`` (rows,) bool (dead rows never
    enter) -> ``((S, Q, kl) float32, (S, Q, kl) int64)`` host arrays of
    global row indices, S chunks, kl = min(k, rows per chunk), -inf / -1
    where a chunk has fewer live rows. Each chunk scores the queries
    against its own rows only, through ``ops.top_k_scores`` on the chunk's
    device (the CUDA kernel on the card) under the (score desc, index asc)
    order; only the candidate lists leave the shard, and :func:`merge_topk`
    stitches them. Any global top-k row is in its owner's local top-k, so
    the stitch is exact.
    """
    plan = getattr(table, "plan", None)
    chunks = row_chunks(table)
    kl = min(int(k), chunks[0][1].shape[0])
    vals, idx = [], []
    for s, (off, t) in enumerate(chunks):
        n = t.shape[0]
        ok = torch.as_tensor(valid[off:off + n], device=t.device)
        v, i = ops.top_k_scores(ship(q, t.device, plan, s, "topk"), t, kl,
                                valid=ok)
        gi = torch.where(i >= 0, i.long() + off, -1)
        vals.append(ship(v, "cpu", plan, s, "topk").numpy())
        idx.append(ship(gi, "cpu", plan, s, "topk").numpy())
    return np.stack(vals), np.stack(idx)


def merge_topk(vals, idx, k: int):
    """Host-side stitch of per-shard partial top-k candidate lists.

    vals, idx: (S, Q, kl) shard-local candidates, each list in (score desc,
    index asc) order (global row indices, -inf/-1 padded) -> ``((Q, k)
    float32, (Q, k) int64)`` under the global order, -inf/-1 padded when
    fewer than k live candidates exist in total. One list is already in
    order and is only padded.
    """
    vals = np.asarray(vals, np.float32)
    idx = np.asarray(idx, np.int64)
    S, Q, kl = vals.shape
    v = np.swapaxes(vals, 0, 1).reshape(Q, S * kl)
    i = np.swapaxes(idx, 0, 1).reshape(Q, S * kl)
    if S > 1:
        ikey = np.where(i < 0, np.iinfo(np.int64).max, i)
        order = np.lexsort((ikey, -v), axis=-1)
        v = np.take_along_axis(v, order, 1)
        i = np.take_along_axis(i, order, 1)
    kk = min(k, S * kl)
    out_v = np.full((Q, k), -np.inf, np.float32)
    out_i = np.full((Q, k), -1, np.int64)
    out_v[:, :kk] = v[:, :kk]
    out_i[:, :kk] = i[:, :kk]
    out_i[~np.isfinite(out_v)] = -1
    return out_v, out_i
