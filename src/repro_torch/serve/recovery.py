"""Crash safety for the serving stack: WAL + atomic snapshots + recovery.

The torch counterpart of ``repro.serve.recovery``, in the same formats: a
WAL written by either package is read by the other byte for byte, and a
snapshot directory the JAX package committed restores here
(:func:`restore_service` maps its backend choices to the port's defaults in
:func:`_port_backend`).

Durability model, two layers:

* **Write-ahead edge log** (:class:`WriteAheadLog`) — every
  ``ingest_block`` / ``retract_block`` appends one checksummed record
  (*before* any mutation) and fsyncs it. A record is ``<IBQI`` header
  (magic, kind, sequence number, edge count) + ``n×2`` int64 edge pairs +
  a CRC32 trailer over header+payload. On open, the log scans itself and
  truncates a torn tail (short record, bad magic/CRC, non-monotonic seq) —
  a crash mid-append loses at most the record being written, never earlier
  ones.
* **Atomic snapshots** (:class:`SnapshotStore`) — the full serving state
  (adjacency + overflow side tables, exact core numbers + retrain
  baseline, store table/versions/spill/LRU, service counters, WAL offset)
  written with the same tmp-dir → fsync → ``_COMMITTED`` → rename
  protocol as ``distributed/checkpoint.py``. Readers skip torn directories
  (missing ``_COMMITTED``, unparseable manifest, payload CRC mismatch)
  even when they are the newest.

**Recovery = newest committed snapshot + WAL tail replay.** Replay drives
the edges back through the service's own ``ingest_block``/``retract_block``
(with WAL logging suppressed), so the recovered state is *bit-identical*
to a process that never crashed: same adjacency bytes, same core numbers,
same store table/slot assignment/version counters (retrains included: the
replay re-fires the auto-retrains, whose SGNS steps repeat their bits).
Snapshots call ``service.sync()`` first, a device synchronize at the block
boundary.

:class:`RecoveryManager` wires both layers into a live service: logging
before every mutation, snapshotting on a block-count (and optional
wall-clock) cadence with the serialization + fsync handed to a background
writer thread so ingest does not pause — the state is copied to host numpy
arrays on the serving thread first, so the writer never touches the device
— and a :meth:`RecoveryManager.recover`
classmethod that restores a service from the directory.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics
from repro_torch.obs import trace as obs

from . import faults

__all__ = [
    "WriteAheadLog",
    "SnapshotStore",
    "RecoveryManager",
    "capture_state",
    "restore_service",
]

_MAGIC = 0x57414C31  # "WAL1"
_HEADER = struct.Struct("<IBQI")  # magic, kind, seq, n_edges
_CRC = struct.Struct("<I")

KIND_INGEST = 1
KIND_RETRACT = 2


class WriteAheadLog:
    """Append-only checksummed edge log with torn-tail detection.

    ``fsync=False`` trades durability for speed in tests; the torn-tail
    scan still runs on open either way.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self.torn_truncated = 0  # bytes dropped from a torn tail on open
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.seq = 0  # last durable sequence number
        end = self._scan()
        self._f = open(path, "r+b" if os.path.exists(path) else "w+b")
        self._f.seek(0, os.SEEK_END)
        if self._f.tell() != end:  # torn tail: drop it before appending
            self.torn_truncated = self._f.tell() - end
            self._f.truncate(end)
            self._f.seek(end)

    def _scan(self) -> int:
        """Validate existing records; returns the clean end offset and
        leaves ``self.seq`` at the last valid record's sequence number."""
        if not os.path.exists(self.path):
            return 0
        end = 0
        with open(self.path, "rb") as f:
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                magic, kind, seq, n = _HEADER.unpack(head)
                if magic != _MAGIC or kind not in (KIND_INGEST, KIND_RETRACT):
                    break
                payload = f.read(16 * n)
                trailer = f.read(_CRC.size)
                if len(payload) < 16 * n or len(trailer) < _CRC.size:
                    break
                if _CRC.unpack(trailer)[0] != zlib.crc32(head + payload):
                    break
                if seq != self.seq + 1:  # non-monotonic: corrupt tail
                    break
                self.seq = seq
                end = f.tell()
        return end

    def append(self, kind: int, edges: np.ndarray) -> int:
        """Durably log one block; returns its sequence number.

        Injection points: ``wal_append`` fires *mid-record* (half the bytes
        reach the file — a real torn tail the next open must truncate);
        ``wal_fsync`` fires after the write but before the fsync (the
        record is cleanly lost, as an OS crash before writeback would)."""
        edges = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1, 2))
        seq = self.seq + 1
        head = _HEADER.pack(_MAGIC, kind, seq, len(edges))
        payload = edges.tobytes()
        buf = head + payload + _CRC.pack(zlib.crc32(head + payload))
        start = self._f.tell()
        try:
            faults.check("wal_append")
        except BaseException:
            self._f.write(buf[: max(len(buf) // 2, 1)])
            self._f.flush()
            os.fsync(self._f.fileno())
            raise
        self._f.write(buf)
        try:
            faults.check("wal_fsync")
        except BaseException:
            self._f.flush()
            self._f.truncate(start)
            self._f.seek(start)
            raise
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.seq = seq
        return seq

    def records(
        self, after_seq: int = 0
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield ``(seq, kind, edges)`` for every valid record past
        ``after_seq``, stopping silently at a torn tail."""
        with open(self.path, "rb") as f:
            last = 0
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return
                magic, kind, seq, n = _HEADER.unpack(head)
                if magic != _MAGIC or kind not in (KIND_INGEST, KIND_RETRACT):
                    return
                payload = f.read(16 * n)
                trailer = f.read(_CRC.size)
                if len(payload) < 16 * n or len(trailer) < _CRC.size:
                    return
                if _CRC.unpack(trailer)[0] != zlib.crc32(head + payload):
                    return
                if seq != last + 1:
                    return
                last = seq
                if seq > after_seq:
                    yield seq, kind, np.frombuffer(
                        payload, np.int64
                    ).reshape(-1, 2).copy()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class SnapshotStore:
    """Atomic snapshot directory: ``snap_<wal_seq>`` children, each
    committed via tmp-dir → fsync → ``_COMMITTED`` → rename."""

    def __init__(self, directory: str, *, keep: int = 2):
        self.directory = directory
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)

    def _path(self, wal_seq: int) -> str:
        return os.path.join(self.directory, f"snap_{wal_seq:012d}")

    def write(self, arrays: Dict[str, np.ndarray], manifest: dict) -> str:
        """Commit one snapshot; ``manifest['wal_seq']`` names the directory.

        Injection points: ``snapshot_write`` fires after the payload lands
        but before the manifest/``_COMMITTED`` (a torn dir recovery must
        skip); ``snapshot_commit`` fires after ``_COMMITTED`` but before
        the rename (the tmp dir is simply garbage — never visible)."""
        final = self._path(int(manifest["wal_seq"]))
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        manifest = dict(manifest, npz_crc=zlib.crc32(payload))
        with open(os.path.join(tmp, "state.npz"), "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        faults.check("snapshot_write")
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        faults.check("snapshot_commit")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._gc()
        return final

    def _gc(self) -> None:
        names = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("snap_") and not d.endswith(".tmp")
        )
        for d in names[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def _load(self, path: str) -> Tuple[Dict[str, np.ndarray], dict]:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "state.npz"), "rb") as f:
            payload = f.read()
        if zlib.crc32(payload) != manifest.get("npz_crc"):
            raise ValueError(f"snapshot payload CRC mismatch in {path}")
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
        return arrays, manifest

    def load_latest(
        self,
    ) -> Tuple[Optional[Dict[str, np.ndarray]], Optional[dict], int]:
        """Newest loadable snapshot -> ``(arrays, manifest, n_skipped)``.

        Torn directories — mid-write crash left no ``_COMMITTED``, or the
        manifest/payload fails to parse/verify — are skipped even when
        newest. ``(None, None, skipped)`` when nothing is loadable."""
        names = sorted(
            (d for d in os.listdir(self.directory)
             if d.startswith("snap_") and not d.endswith(".tmp")),
            reverse=True,
        )
        skipped = 0
        for d in names:
            path = os.path.join(self.directory, d)
            if not os.path.exists(os.path.join(path, "_COMMITTED")):
                skipped += 1
                continue
            try:
                arrays, manifest = self._load(path)
            except Exception:
                skipped += 1
                continue
            return arrays, manifest, skipped
        return None, None, skipped


# --------------------------------------------------------------- state I/O

_STATS_FIELDS = (
    "queries", "store_hits", "cold_starts", "unresolved", "flushes",
    "edges_ingested", "edges_removed", "ingest_blocks", "compactions",
    "retrains", "last_swap_version", "degraded_queries",
    "retrain_failures", "hangs",
)


def capture_state(svc, wal_seq: int) -> Tuple[Dict[str, np.ndarray], dict]:
    """Live service -> ``(arrays, manifest)`` for :class:`SnapshotStore`.

    Calls ``svc.sync()`` first (a device synchronize at the block boundary);
    every array is a host copy (the store's device table included), so the
    result can be handed to another thread. The manifest has the JAX
    package's keys; ``write_back``, ``impl`` and ``pipeline`` are written
    as the port runs (cold starts always written back, the default kernel
    dispatch, serial ingest).
    """
    svc.sync()
    arrays: Dict[str, np.ndarray] = {}
    for k, v in svc.graph.state_dict().items():
        arrays[f"g.{k}"] = v
    for k, v in svc.store.state_dict().items():
        arrays[f"s.{k}"] = v
    arrays["core"] = svc.cores._core.copy()
    arrays["baseline"] = svc.cores._baseline.copy()
    cores = svc.cores
    pol = cores.policy
    st = svc.stats
    manifest = {
        "wal_seq": int(wal_seq),
        "service": {
            "batch": svc.batch,
            "write_back": True,
            "compact_every": svc.compact_every,
            "k0": None if svc.k0 is None else int(svc.k0),
            "retrain_threshold": svc.retrain_threshold,
            "impl": "auto",
            "pipeline": False,
        },
        "cores": {
            "repeel_frac": cores.repeel_frac,
            "margin0": cores.margin0,
            "impl": cores.impl,
            "region_impl": cores.region_impl,
            "kernel_impl": cores.kernel_impl,
            "repeel_impl": cores.repeel_impl,
            "descend_budget": cores.descend_budget,
            "max_sweeps": cores.max_sweeps,
            "repair_policy": pol.mode,
            "crossover_margin": pol.crossover_margin,
            "cold_cells_per_arc": pol.cold_cells_per_arc,
        },
        "stats": {k: int(getattr(st, k)) for k in _STATS_FIELDS},
    }
    return arrays, manifest


# backend choices the port knows; anything else in a manifest (the JAX
# package's "pallas" kernels, say) maps to None, the port's own choice
_PORT_BACKENDS = {
    "kernel_impl": (None, "ref", "count", "cuda"),
    "region_impl": (None, "np", "jit"),
}


def _port_backend(key: str, value):
    """The one place where a manifest's backend choices meet the port.

    ``cores.kernel_impl`` and ``cores.region_impl`` keep a value the port
    knows and otherwise become None (the device's default: the CUDA kernel
    and device regions on the card, the counting search and numpy regions
    on the CPU). The service's ``impl`` (the JAX package's kernel dispatch
    for flushes and top-k) and ``pipeline`` (pipelined ingest) have no
    counterpart and are not read: the port dispatches by device and ingests
    serially. All of these choose how, never what: every backend gives the
    same cores and tables. (``write_back`` is not read either: the port
    always writes resolved cold starts back, the JAX package's default.)
    """
    return value if value in _PORT_BACKENDS[key] else None


def restore_service(
    arrays: Dict[str, np.ndarray], manifest: dict, *, device="cuda"
):
    """Snapshot payload (written by either package) -> a fresh
    ``EmbeddingService`` on ``device``, bit-identical to the one
    :func:`capture_state` saw."""
    from .kcore_inc import IncrementalCore
    from .service import EmbeddingService
    from .store import EmbeddingStore
    from .stream import DynamicGraph

    g_state = {k[2:]: v for k, v in arrays.items() if k.startswith("g.")}
    s_state = {k[2:]: v for k, v in arrays.items() if k.startswith("s.")}
    graph = DynamicGraph.from_state(g_state, device=device)
    store = EmbeddingStore.from_state(s_state, device=device)
    ccfg = manifest["cores"]
    cores = IncrementalCore(
        graph,
        np.asarray(arrays["core"], np.int32),
        repeel_frac=ccfg["repeel_frac"],
        margin0=ccfg["margin0"],
        impl=ccfg["impl"],
        region_impl=_port_backend("region_impl", ccfg["region_impl"]),
        kernel_impl=_port_backend("kernel_impl", ccfg["kernel_impl"]),
        repeel_impl=ccfg["repeel_impl"],
        descend_budget=ccfg["descend_budget"],
        max_sweeps=ccfg["max_sweeps"],
        repair_policy=ccfg["repair_policy"],
        crossover_margin=ccfg["crossover_margin"],
        cold_cells_per_arc=ccfg["cold_cells_per_arc"],
    )
    cores._baseline = np.asarray(arrays["baseline"], np.int32).copy()
    scfg = manifest["service"]
    svc = EmbeddingService(
        graph, cores, store,
        batch=scfg["batch"],
        compact_every=scfg["compact_every"],
        k0=scfg["k0"],
        retrain_threshold=scfg["retrain_threshold"],
    )
    for k, v in manifest.get("stats", {}).items():
        if hasattr(svc.stats, k):
            setattr(svc.stats, k, int(v))
    return svc


# ---------------------------------------------------------------- manager


class RecoveryManager:
    """Attach WAL + snapshot cadence to a live service.

    Every ``snapshot_every`` blocks the full state is captured on the ingest thread
    (host copies, the device table pulled down there) and committed by a
    background writer thread that sees numpy arrays only, so ingest never
    pauses for the fsyncs and no CUDA call leaves the serving thread.
    ``bootstrap=True`` writes snapshot 0 immediately so recovery always has
    a base to replay from.
    """

    def __init__(
        self,
        service,
        directory: str,
        *,
        snapshot_every: int = 64,
        keep: int = 2,
        fsync: bool = True,
        bootstrap: bool = True,
    ):
        self.service = service
        self.directory = directory
        self.snapshot_every = max(int(snapshot_every), 1)
        os.makedirs(directory, exist_ok=True)
        self.wal = WriteAheadLog(
            os.path.join(directory, "wal.log"), fsync=fsync
        )
        self.snapshots = SnapshotStore(
            os.path.join(directory, "snapshots"), keep=keep
        )
        self.snapshots_written = 0
        self._blocks_since_snap = 0
        self._replaying = False
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        service.attach_recovery(self)
        if bootstrap:
            self.snapshot(blocking=True)

    # -- called by the service ------------------------------------------

    def log_block(self, kind: int, edges: np.ndarray) -> None:
        """Durably log one block *before* the service mutates anything."""
        if self._replaying:
            return
        with obs.span("recovery.wal_append", edges=len(edges)):
            self.wal.append(kind, edges)
        metrics().counter("recovery_wal_records_total").inc()
        self._blocks_since_snap += 1

    def after_block(self) -> None:
        """Snapshot-cadence check; runs after a block fully lands."""
        if self._replaying:
            return
        self._raise_writer_error()
        if self._blocks_since_snap >= self.snapshot_every:
            self.snapshot(blocking=False)

    # -- snapshots ------------------------------------------------------

    def _raise_writer_error(self) -> None:
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Join any in-flight snapshot write (re-raising its error)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_writer_error()

    def snapshot(self, *, blocking: bool = True) -> None:
        """Capture now; commit inline (``blocking``) or on the writer
        thread. Capture itself always runs on the caller's thread — it
        reads mutable host state that must not race the next block, and
        device tensors, which only the serving thread touches."""
        self.wait()
        t0 = time.perf_counter()
        arrays, manifest = capture_state(self.service, self.wal.seq)
        self._blocks_since_snap = 0

        def commit():
            with obs.span("recovery.snapshot", wal_seq=manifest["wal_seq"]):
                self.snapshots.write(arrays, manifest)
            self.snapshots_written += 1
            metrics().counter("recovery_snapshots_total").inc()
            metrics().histogram("recovery_snapshot_seconds").observe(
                time.perf_counter() - t0
            )

        if blocking:
            commit()
            return

        def worker():
            try:
                commit()
            except BaseException as e:  # surfaced on the ingest thread
                self._writer_error = e

        self._writer = threading.Thread(
            target=worker, name="snapshot-writer", daemon=True
        )
        self._writer.start()

    def close(self) -> None:
        self.wait()
        self.wal.close()

    # -- recovery -------------------------------------------------------

    @classmethod
    def recover(
        cls,
        directory: str,
        *,
        device="cuda",
        configure: Optional[Callable] = None,
        snapshot_every: int = 64,
        keep: int = 2,
        fsync: bool = True,
    ):
        """Restore from ``directory`` -> ``(service, manager, report)``,
        the service on ``device``.

        ``configure(service)`` runs after the snapshot restore but *before*
        the WAL replay — reattach a Retrainer there so auto-retrains that
        fired during the original stream re-fire identically during replay.
        """
        t0 = time.perf_counter()
        snaps = SnapshotStore(os.path.join(directory, "snapshots"), keep=keep)
        arrays, manifest, skipped = snaps.load_latest()
        if arrays is None:
            raise FileNotFoundError(
                f"no committed snapshot under {directory!r} "
                f"({skipped} torn directories skipped)"
            )
        with obs.span("recovery.restore", wal_seq=manifest["wal_seq"]):
            svc = restore_service(arrays, manifest, device=device)
        if configure is not None:
            configure(svc)
        mgr = cls(
            svc, directory, snapshot_every=snapshot_every, keep=keep,
            fsync=fsync, bootstrap=False,
        )
        snap_seq = int(manifest["wal_seq"])
        replayed = replayed_edges = 0
        mgr._replaying = True
        try:
            with obs.span("recovery.replay", after_seq=snap_seq) as sp:
                for _, kind, edges in mgr.wal.records(after_seq=snap_seq):
                    if kind == KIND_INGEST:
                        svc.ingest_block(edges)
                    else:
                        svc.retract_block(edges)
                    replayed += 1
                    replayed_edges += len(edges)
                svc.sync()
                sp.set(records=replayed, edges=replayed_edges)
        finally:
            mgr._replaying = False
        metrics().counter("serve_recoveries_total").inc()
        metrics().counter("recovery_replayed_edges_total").inc(replayed_edges)
        report = {
            "snapshot_wal_seq": snap_seq,
            "wal_seq": int(mgr.wal.seq),
            "replayed_records": int(replayed),
            "replayed_edges": int(replayed_edges),
            "torn_wal_bytes": int(mgr.wal.torn_truncated),
            "snapshots_skipped": int(skipped),
            "recovery_seconds": float(time.perf_counter() - t0),
        }
        return svc, mgr, report
