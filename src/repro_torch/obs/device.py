"""Device-side observability hooks: profiler traces, dispatch costs, memory.

The torch counterpart of ``repro.obs.device``: the same three functions and
return shapes.

* :func:`device_profile` — context manager around ``torch.profiler``, so an
  ingest sweep or query replay can be captured as a Chrome trace (open it in
  Perfetto or chrome://tracing); on the card it records the kernels too.
* :func:`compiled_cost` — the cost of one call of a function on concrete
  arguments: FLOPs, bytes accessed and argument / output / temporary bytes.
  PyTorch cannot cost a program without running it, so this runs ``fn``
  once, counting the aten ops it dispatches and the work the hand kernels
  reckon (``kernels.cost``): the kernels launch through ``ctypes``, where
  no dispatch mode sees them.
* :func:`record_memory` — live per-device memory gauges
  (``device_bytes_in_use{device="cuda:0"}``) from ``torch.cuda``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost as kernel_cost

from .metrics import MetricsRegistry, metrics

__all__ = ["device_profile", "compiled_cost", "record_memory"]


@contextlib.contextmanager
def device_profile(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir`` (a Chrome trace file, named in the status as ``"trace"``).

    Yields a status dict: ``{"active": bool, "logdir": ..., "error": ...}``.
    A ``None``/empty ``logdir`` yields inactive. The profiler records the
    CPU always, and the card's kernels too when a card is present. A
    profiler that fails to start or to export records why in ``error``
    instead of raising; an exception raised by the enclosed block is never
    caught.
    """
    status: Dict[str, Any] = {"active": False, "logdir": logdir}
    if not logdir:
        yield status
        return
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
        status["active"] = True
    except Exception as e:  # profiler build / platform specific
        status["error"] = f"{type(e).__name__}: {e}"
        yield status
        return
    try:
        yield status
    finally:
        try:
            if on_card:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(
                logdir, f"trace.{os.getpid()}.{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            status["trace"] = path
        except Exception as e:
            status["error"] = f"{type(e).__name__}: {e}"


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteCount(TorchDispatchMode):
    """Adds up each aten op's tensor input and output bytes. Views and
    allocations move no bytes, and the kernels' cost formulas are not the
    call's work: all are skipped."""

    _FREE = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in self._FREE
                or kernel_cost.reckoning()):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def compiled_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Cost of one call of ``fn`` on concrete arguments, by running it once.

    Returns ``{"flops", "bytes_accessed", "argument_bytes", "output_bytes",
    "temp_bytes"}``: ``flops`` counted by ``FlopCounterMode`` (matmul-like
    ops) plus the operations the hand kernels reckon; ``bytes_accessed``
    the aten ops' tensor input and output bytes plus the kernels' reckoned
    bytes; ``argument_bytes`` / ``output_bytes`` the tensor arguments' and
    results' ``nbytes``; ``temp_bytes`` the CUDA peak above what was
    allocated before the call, less the outputs (0 on the CPU). The call's
    side effects happen, as in any call.
    """
    from torch.utils.flop_counter import FlopCounterMode

    on_card = any(t.is_cuda for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor))
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    flops = FlopCounterMode(display=False)
    count = _ByteCount()
    with kernel_cost.tally() as kernels, flops, count:
        out = fn(*args, **kwargs)
    out_bytes = _nbytes(out)
    temp = 0
    if on_card:
        torch.cuda.synchronize()
        temp = max(torch.cuda.max_memory_allocated() - before - out_bytes, 0)
    return {
        "flops": float(flops.get_total_flops() + kernels.operations),
        "bytes_accessed": float(count.bytes + kernels.bytes),
        "argument_bytes": int(_nbytes((args, kwargs))),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(temp),
    }


def record_memory(
    registry: Optional[MetricsRegistry] = None,
) -> Dict[str, int]:
    """Set ``device_bytes_in_use`` / ``device_bytes_limit`` /
    ``device_peak_bytes_in_use`` gauges for each CUDA device.

    Returns ``{"cuda:<i>": bytes_in_use}``; with no card this is an empty
    dict, not an error (as the JAX package's is on the CPU).
    """
    reg = metrics() if registry is None else registry
    seen: Dict[str, int] = {}
    if not torch.cuda.is_available():
        return seen
    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        in_use = int(torch.cuda.memory_allocated(i))
        reg.gauge("device_bytes_in_use", device=label).set(in_use)
        reg.gauge("device_bytes_limit", device=label).set(
            int(torch.cuda.get_device_properties(i).total_memory))
        reg.gauge("device_peak_bytes_in_use", device=label).set(
            int(torch.cuda.max_memory_allocated(i)))
        seen[label] = in_use
    return seen
