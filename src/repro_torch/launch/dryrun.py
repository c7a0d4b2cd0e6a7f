"""Multi-pod dry run of the port: run every (arch x shape) step once on the
production meshes, in one process, and record each device's share.

The torch counterpart of ``repro.launch.dryrun``, with the same flags, cell
builders and record keys, so one reader takes both files. Where the JAX
package lowers and compiles on 512 forced host devices, this runs the step
eagerly under a *fake* process group of 256 (single pod, 16x16) or 512
(two pods, 2x16x16) ranks, as rank 0: the arguments are DTensors whose
local shards are ``meta`` tensors (shapes and dtypes, no storage), laid out
by the logical rules (``distributed.sharding``), so the step's every op
runs through DTensor's sharding propagation and every collective it needs
is issued (and moves nothing). For each cell:

  * ``memory.argument_bytes``: the local shards' bytes of the arguments
    (params, optimizer state and batch, or params, cache and tokens; an
    optimizer count counts as the JAX package's int32 scalar);
    ``output_bytes`` the outputs' likewise; ``alias_bytes`` the outputs
    that are arguments updated in place (the JAX package donates them);
    ``temp_bytes`` the peak of the live local-shard bytes the step
    allocated, less its new outputs (storages followed through a dispatch
    mode); ``code_bytes`` is null: eager PyTorch compiles no program.
  * ``flops``: per device, the matmul-class FLOPs of
    ``torch.utils.flop_counter``'s formulas (elementwise work is not
    counted). An op on DTensors is counted at its global shape and divided
    by the number of ranks that split it (its output sharded or partial
    over that mesh axis): a replicated (fallback) dim counts in full on
    each device. Ops on local shards (the ``local_map`` regions: attention
    by heads, the mamba block by heads, flash-decode, the SGNS loss) count
    as they are. Unlike the
    JAX package's ``cost_analysis``, a layer loop counts every layer.
  * ``bytes_accessed``: per device, each op's local input and output bytes
    (views excluded): unfused eager ops, not XLA's fused program.
  * ``collective_bytes`` / ``collective_counts``: the ``_c10d_functional``
    collectives issued, under the JAX package's five names, bytes of each
    call's result (``collective-permute`` stays 0: DTensor has none);
    ``collective_largest`` (the port's alone) each kind's largest call.

``--real CELLS`` (arch:shape, comma separated) runs those cells a second
time for real: rank 0's local shards are made on ``--device`` with values
drawn from a seeded generator (ids within their ranges, every cache row at
its full length), the step runs once with the collectives faked, then 2
warm-ups and 5 timed runs; the record gains ``real``: ``peak_bytes``
(``torch.cuda.max_memory_allocated`` above the arguments), ``step_ms`` (the
median), the kernels' launch counts and the local shapes they were
launched at (``shapes``: flash-decode's (B, H, Hkv, Dh, S, cache dtype),
S the rank's own positions where the cache is split along its sequence,
SGNS's (B, K, D, dtype) for each kernel). Its values mean nothing (no
collective moves data); its memory and device time are the card's own
per-device figures for the production mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --mesh single --arch mamba2-2.7b --shape decode_32k --out /tmp/d.json
  python -m repro_torch.launch.dryrun --mesh single --arch all \\
      --shape all --include-graph --real qwen3-4b:decode_32k

The graph cell (the paper's own workload) also runs for real at any
``GraphEmbedConfig``'s size, on one device or a real mesh: ``graph_state``
draws its tables (the SGNS init, chunk by chunk, each rank its own rows)
and builds Adam's moments on each rank's shards, ``GraphPairs`` draws each
step's pairs (a seeded power law over the nodes; each rank keeps its own
block), and ``graph_step`` is the step the dry run measures.

Only this module starts a fake process group (``launch.mesh.init_world``);
one process holds one default group, so a caller that needs another group
runs this as a subprocess.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import REGISTRY, get_config, sharding_overrides
from repro_torch.configs.deepwalk_web import CONFIG as DW_CONFIG
from repro_torch.configs.shapes import (SHAPES, batch_logical_names,
                                        input_specs, shape_supported)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (is_dtensor, local_tree,
                                              sharding_scope)
from repro_torch.launch.mesh import init_world, make_production_mesh
from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import (cache_specs, init_model,
                                            model_specs)
from repro_torch.train import optim
from repro_torch.train.tree import leaves

__all__ = ["build_cell", "build_graph_cell", "graph_step", "graph_state",
           "GraphPairs", "cell_overrides", "run_cell",
           "ACCUM_OVERRIDES", "SkipCell", "COLLECTIVES", "Tally", "main"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# Microbatch gradient accumulation for the biggest trainers (the JAX
# package's): shrinks remat carries and per-layer backward peaks by the
# accumulation factor.
ACCUM_OVERRIDES = {"grok-1-314b": 4, "nemotron-4-15b": 2}

class SkipCell(Exception):
    pass


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _split(t) -> int:
    """How many ranks share the work of the op whose output is DTensor
    ``t``: the mesh axes it is sharded (strided too) or partial over."""
    n = 1
    for m, p in enumerate(t.placements):
        if not p.is_replicate():
            n *= t.device_mesh.size(m)
    return n


def _tensors(xs) -> list:
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments nest one level at most)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [y for y in x if isinstance(y, torch.Tensor)]
    return out


class Tally(TorchDispatchMode):
    """Per-device FLOPs, bytes, collectives and live local-shard bytes of
    what runs under it (see the module docstring). ``known`` storages (the
    arguments') are not counted as allocations."""

    def __init__(self, known_storages=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.coll_largest = {c: 0 for c in COLLECTIVES}
        self.known = {id(s) for s in known_storages}
        self.live = 0
        self.peak = 0
        self.sizes = {}

    def _free(self, key, n):
        self.sizes.pop(key, None)
        self.live -= n

    def _track(self, t):
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self.known or key in self.sizes:
            return
        n = st.nbytes()
        self.sizes[key] = n
        self.live += n
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        if func.namespace == "_c10d_functional":
            name = _COLLECTIVE_OPS.get(func.overloadpacket.__name__)
            if name is not None:
                n = sum(_nbytes(o) for o in outs)
                self.coll_counts[name] += 1
                self.coll_bytes[name] += n
                self.coll_largest[name] = max(self.coll_largest[name], n)
        packet = func.overloadpacket
        if packet in self.registry:
            f = self.registry[packet](*args, **kwargs, out_val=out)
            dts = [o for o in outs if is_dtensor(o)]
            self.flops += f / _split(dts[0]) if dts else f
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self._track(o)
        self.peak = max(self.peak, self.live)
        return out


# ------------------------------------------------------------------ cells --


def _maker(device, bounds=None):
    """``make(shape, dtype, path)`` of one rank's local shards: meta
    tensors, or values on ``device`` from a generator seeded 0 (floats
    normal x 0.02, masks 1, ids below their ``bounds``, cache lengths at the
    cache's last slot)."""
    if device == "meta":
        return lambda shape, dtype, path: torch.empty(shape, dtype=dtype,
                                                      device="meta")
    gen = torch.Generator(device=device).manual_seed(0)

    def make(shape, dtype, path):
        name = path.rsplit("/", 1)[-1]
        if dtype.is_floating_point:
            if name == "mask":
                return torch.ones(shape, dtype=dtype, device=device)
            x = torch.randn(shape, generator=gen, device=device)
            return (x * 0.02).to(dtype)
        if name == "len":
            return torch.full(shape, bounds["len"], dtype=dtype,
                              device=device)
        hi = bounds.get(name, 1)
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=dtype)
    return make


def _place(tree, specs, make, prefix):
    """``local_tree`` with the leaf's path passed to ``make``."""
    from repro_torch.train.tree import leaf_paths
    paths = iter([p for p, x in leaf_paths(tree)
                  if isinstance(x, torch.Tensor)])
    return local_tree(tree, specs, lambda shape, dt: make(
        shape, dt, f"{prefix}/{next(paths)}"))


def build_cell(arch: str, shape_name: str, mesh, make):
    """Returns (fn, args, donate) for one cell, its arguments placed on
    ``mesh`` with local shards from ``make``."""
    shape = SHAPES[shape_name]
    if arch == DW_CONFIG.name:
        return build_graph_cell(shape, mesh, make)
    cfg = get_config(arch)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise SkipCell(why)

    params_meta = init_model(cfg, None, device="meta")
    p_specs = model_specs(cfg)
    params = _place(params_meta, p_specs, make, "params")

    if shape.kind == "train":
        opt = optim.make_optimizer(cfg.optimizer, 1e-4)
        opt_specs = optim.optimizer_state_specs(cfg.optimizer, params_meta,
                                                p_specs)
        opt_state = _place(opt.init(params_meta), opt_specs, make, "opt")
        (batch,) = input_specs(cfg, shape)
        batch = _place(batch, batch_logical_names(cfg, train=True), make,
                       "batch")
        step = make_train_step(cfg, opt,
                               accum_steps=ACCUM_OVERRIDES.get(arch, 1))
        return step, (params, opt_state, batch), (0, 1)

    if shape.kind == "prefill":
        (batch,) = input_specs(cfg, shape)
        batch = _place(batch, batch_logical_names(cfg, train=False), make,
                       "batch")
        return make_prefill_step(cfg), (params, batch), ()

    cache, tokens = input_specs(cfg, shape)
    cache = _place(cache, cache_specs(cfg), make, "cache")
    tokens = _place(tokens, ("batch", None), make, "tokens")
    return make_decode_step(cfg), (params, cache, tokens), (1,)


GRAPH_LR = 0.025  # the graph cell's Adam rate
GRAPH_SPECS = {"emb_in": ("vocab", None), "emb_out": ("vocab", None)}
GRAPH_BATCH_SPECS = {"centers": ("batch",), "contexts": ("batch",),
                     "negatives": ("batch", None)}
GRAPH_SPREAD = 2654435761  # node of the r-th most frequent id: r x this mod V


def build_graph_cell(shape, mesh, make, config=DW_CONFIG):
    """The paper's own workload: the sharded SGNS train step
    (deepwalk-web1b, or ``config``: a ``GraphEmbedConfig`` sized otherwise),
    both SGNS kernels on each rank's pairs."""
    c = config
    V, D, K, B = c.n_nodes, c.dim, c.n_neg, c.global_batch
    pdt = getattr(torch, c.param_dtype)
    meta = {"emb_in": torch.empty((V, D), dtype=pdt, device="meta"),
            "emb_out": torch.empty((V, D), dtype=pdt, device="meta")}
    params = _place(meta, GRAPH_SPECS, make, "params")
    opt = optim.make_optimizer("adam", GRAPH_LR)
    opt_state = _place(opt.init(meta), optim.adam_state_specs(GRAPH_SPECS),
                       make, "opt")
    i32 = torch.int32
    batch = {"centers": torch.empty((B,), dtype=i32, device="meta"),
             "contexts": torch.empty((B,), dtype=i32, device="meta"),
             "negatives": torch.empty((B, K), dtype=i32, device="meta")}
    batch = _place(batch, GRAPH_BATCH_SPECS, make, "batch")
    return graph_step(opt), (params, opt_state, batch), (0, 1)


def graph_step(opt, metrics=False):
    """The graph cell's step ``(params, opt_state, batch) -> (params,
    opt_state, loss)``: the mean SGNS loss of the batch, its gradients, one
    ``opt`` step on the params in place. ``metrics``: the third output is
    ``{"loss", "grad_norm"}``, each reduced to every rank (the loss is a
    mean over pairs split over the mesh: a partial sum until then)."""
    from repro_torch.skipgram.model import batch_loss

    def whole(x):
        return x.full_tensor() if is_dtensor(x) else x

    def step(params, opt_state, batch):
        ws = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = batch_loss(ws, batch["centers"], batch["contexts"],
                              batch["negatives"])
            grads = dict(zip(ws, torch.autograd.grad(loss, list(
                ws.values()))))
        out = loss.detach()
        if metrics:
            out = {"loss": whole(out),
                   "grad_norm": whole(optim.global_norm(grads))}
        opt_state = opt.step(grads, opt_state, params)
        return params, opt_state, out

    return step


def graph_state(config=DW_CONFIG, *, device="cuda", seed=0):
    """The graph cell's (params, Adam state) for a real run: ``emb_in`` as
    ``skipgram.model.init_params`` draws it, chunk by chunk
    (``init_rows``), ``emb_out`` and the moments zeros. Under a sharding
    scope (the cell's rules: rows split over every mesh axis) each rank
    makes its own rows alone, bit-equal to the same rows of the whole
    table, and the moments on its own shards as ``launch/train --mesh``
    builds them; with none, whole tensors on ``device``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import current_ctx, local_offset
    from repro_torch.launch.train import sharded_state
    from repro_torch.skipgram.model import init_rows

    V, D = config.n_nodes, config.dim
    pdt = getattr(torch, config.param_dtype)
    dev = resolve_device(device)
    opt = optim.make_optimizer("adam", GRAPH_LR)
    if current_ctx() is None:
        params = {"emb_in": init_rows(0, V, V, D, seed, pdt, device=dev),
                  "emb_out": torch.zeros((V, D), dtype=pdt, device=dev)}
        return params, opt.init(params)
    meta = {"emb_out": torch.empty((V, D), dtype=pdt, device="meta")}
    out = local_tree(meta, {"emb_out": GRAPH_SPECS["emb_out"]},
                     lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                   device=dev))["emb_out"]
    lo, n = local_offset(out)[0], out.to_local().shape[0]
    emb_in = DTensor.from_local(init_rows(lo, lo + n, V, D, seed, pdt,
                                          device=dev),
                                out.device_mesh, out.placements,
                                run_check=False, shape=out.shape,
                                stride=out.stride())
    params = {"emb_in": emb_in, "emb_out": out}
    return params, sharded_state(opt, "adam", params, GRAPH_SPECS, dev)


class GraphPairs:
    """The graph cell's pairs for a real run, the same on every run and
    rank: ``pairs(step)`` draws the step's whole batch from a generator on
    ``device`` seeded by (seed, step) and, under a sharding scope, keeps
    each rank's own block (the batch split over every mesh axis). Centers
    and contexts follow a power law over the nodes (the r-th most frequent
    id's share is 1/(r + 1) of the harmonic sum), negatives that law to the
    3/4 power, as ``skipgram.corpus.noise_cdf`` raises a walk corpus's
    counts (a walk visits nodes in proportion to their degree); the r-th
    id is node r x ``GRAPH_SPREAD`` mod V, so that the hot rows fall on
    every rank's shard. Each law is inverted by a search of its float64
    CDF."""

    def __init__(self, config=DW_CONFIG, *, device="cuda", seed=0):
        self.config, self.seed = config, seed
        self.device = resolve_device(device)
        w = 1.0 / torch.arange(1, config.n_nodes + 1, dtype=torch.float64,
                               device=self.device)
        self.cdf = [self._cdf(w), self._cdf(w.pow_(0.75))]

    @staticmethod
    def _cdf(w):
        c = torch.cumsum(w, 0)
        return c.div_(c[-1].clone())

    def _ids(self, cdf, u):
        V = self.config.n_nodes
        r = torch.searchsorted(cdf, u, right=True).clamp_(max=V - 1)
        return r.mul_(GRAPH_SPREAD).remainder_(V).to(torch.int32)

    def __call__(self, step: int):
        from repro_torch.distributed.sharding import (current_ctx,
                                                      distribute_tree)

        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed << 32) + (1 << 31) + step)
        u = torch.rand((c.global_batch, 2 + c.n_neg), generator=gen,
                       dtype=torch.float64, device=self.device)
        pair = self._ids(self.cdf[0], u[:, :2].contiguous())
        batch = {"centers": pair[:, 0].contiguous(),
                 "contexts": pair[:, 1].contiguous(),
                 "negatives": self._ids(self.cdf[1], u[:, 2:].contiguous())}
        if current_ctx() is not None:
            batch = distribute_tree(batch, GRAPH_BATCH_SPECS,
                                    src_data_rank=None)
        return batch


def cell_overrides(arch: str, shape_name: str, model_axis: int = 16) -> dict:
    """Logical-rule overrides for one cell: per-arch + per-shape-kind."""
    overrides = sharding_overrides(arch)
    kind = SHAPES[shape_name].kind
    if kind == "train" and "res_seq" not in overrides:
        # sequence-parallel residual stream: bounds full-remat carries
        # (see distributed/sharding.py); train cells only
        overrides["res_seq"] = ("model",)
    if arch in REGISTRY and kind in ("decode", "prefill"):
        cfg = get_config(arch)
        if cfg.n_kv_heads % model_axis != 0 and "kv_seq" not in overrides:
            # KV heads can't shard the model axis: shard the cache's
            # sequence dim instead (flash-decode runs on each rank's own
            # positions and combines the partial softmaxes: an all-reduce)
            overrides["kv_seq"] = ("model",)
    return overrides


def _bounds(arch: str, shape_name: str) -> dict:
    shape = SHAPES[shape_name]
    if arch == DW_CONFIG.name:
        n = DW_CONFIG.n_nodes
        return {"centers": n, "contexts": n, "negatives": n}
    v = get_config(arch).vocab_size
    return {"tokens": v, "targets": v, "positions": shape.seq_len,
            "len": shape.seq_len - 1}


# ------------------------------------------------------------------- runs --


def _arg_bytes(tree) -> int:
    """Local-shard bytes of a tree; an int leaf (an optimizer count) as the
    JAX package's int32 scalar."""
    return sum(_nbytes(x) if isinstance(x, torch.Tensor) else 4
               for x in leaves(tree) if isinstance(x, (torch.Tensor, int)))


def _storages(tree):
    return [_local(x).untyped_storage() for x in leaves(tree)
            if isinstance(x, torch.Tensor)]


def _measure(fn, args):
    arg_st = [s for a in args for s in _storages(a)]
    arg_ids = {id(s) for s in arg_st}
    tally = Tally(arg_st)
    with tally:
        out = fn(*args)
    out_leaves = [x for x in leaves(out) if isinstance(x, torch.Tensor)]
    seen, out_bytes, alias, new_out = set(), 0, 0, 0
    for x in out_leaves:
        st = _local(x).untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        n = _nbytes(x)
        out_bytes += n
        if id(st) in arg_ids:
            alias += n
        elif id(st) in tally.sizes:
            new_out += tally.sizes[id(st)]
    memory = dict(argument_bytes=sum(_arg_bytes(a) for a in args),
                  output_bytes=out_bytes,
                  temp_bytes=max(tally.peak - new_out, 0),
                  alias_bytes=alias, code_bytes=None)
    return memory, tally


def _noting(fn, into, shape):
    def call(*args, **kwargs):
        into.add(shape(*args))
        return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def _launch_shapes():
    """Within: each launch of flash-decode or an SGNS kernel notes its
    local input shape into the yielded {kernel: set of shapes}."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import sgns as sg

    def dt(t):
        return str(t.dtype).split(".")[-1]

    def decode(q, k, *_):  # (B, H, Hkv, Dh, S, cache dtype)
        return (*q.shape[:2], *k.shape[2:], k.shape[1], dt(k))

    def pairs(c, x, n, *_):  # (B, K, D, dtype)
        return (*n.shape, dt(n))

    hooks = ((fd, "decode_attention_cuda", "flash_decode", decode),
             (sg, "sgns_fwd_cuda", "sgns_fwd", pairs),
             (sg, "sgns_bwd_cuda", "sgns_bwd", pairs))
    shapes = {key: set() for _, _, key, _ in hooks}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in hooks]
    for (mod, name, key, shape), (_, _, fn) in zip(hooks, saved):
        setattr(mod, name, _noting(fn, shapes[key], shape))
    try:
        yield shapes
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _real_run(arch, shape_name, mesh, device):
    """The cell once more with real local shards on ``device`` (see the
    module docstring) -> the record's ``real`` entry."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import sgns as sg

    def counts():
        return {"flash_decode": fd.launches, "sgns_fwd": sg.fwd_launches,
                "sgns_bwd": sg.bwd_launches}

    dev = torch.device(device)
    make = _maker(dev, _bounds(arch, shape_name))
    fn, args, _ = build_cell(arch, shape_name, mesh, make)
    is_cuda = dev.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(dev)

    def fresh():  # a step updates its donated arguments in place
        return tuple(_clone(a) for a in args)

    sync()
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if is_cuda else 0
    fd.launches = sg.fwd_launches = sg.bwd_launches = 0
    with _launch_shapes() as shapes:
        fn(*args)
    sync()
    launches = counts()
    peak = (torch.cuda.max_memory_allocated(dev) - base) if is_cuda else None
    times = []
    for i in range(7):
        a = fresh()
        sync()
        t0 = time.perf_counter()
        fn(*a)
        sync()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
        del a
    return {"peak_bytes": peak, "step_ms": statistics.median(times),
            "step_ms_all": times, "launches": launches,
            "shapes": {k: sorted(v) for k, v in shapes.items() if v},
            "device": torch.cuda.get_device_name(dev) if is_cuda
            else "cpu"}


def _clone(tree):
    from repro_torch.train.tree import unflatten
    return unflatten(tree, [x.clone() if isinstance(x, torch.Tensor) else x
                            for x in leaves(tree)])


def run_cell(arch: str, shape_name: str, multi_pod: bool, out, *,
             device: str = "cpu", real: bool = False):
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        overrides = cell_overrides(arch, shape_name)
        with sharding_scope(mesh, **overrides):
            fn, args, _ = build_cell(arch, shape_name, mesh, _maker("meta"))
            memory, tally = _measure(fn, args)
            del fn, args
            real_rec = _real_run(arch, shape_name, mesh, device) \
                if real else None
        rec.update(
            status="ok",
            compile_seconds=round(time.time() - t0, 2),
            memory=memory,
            flops=tally.flops,
            bytes_accessed=tally.bytes,
            collective_bytes=tally.coll_bytes,
            collective_counts=tally.coll_counts,
            collective_largest=tally.coll_largest,
        )
        if real_rec is not None:
            rec["real"] = real_rec
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"({rec['compile_seconds']}s)")
        print(f"  memory: args={memory['argument_bytes'] / 2**30:.3f}GiB "
              f"temp={memory['temp_bytes'] / 2**30:.3f}GiB "
              f"out={memory['output_bytes'] / 2**30:.3f}GiB "
              f"aliased={memory['alias_bytes'] / 2**30:.3f}GiB (per device)")
        print(f"  cost: flops={rec['flops']:.4e} "
              f"bytes={rec['bytes_accessed']:.4e} (per device)")
        print("  collectives: " + ", ".join(
            f"{k}={v / 2**20:.1f}MiB(x{tally.coll_counts[k]})"
            for k, v in tally.coll_bytes.items() if v))
        if real_rec is not None:
            pk = real_rec["peak_bytes"]
            print(f"  real on {real_rec['device']}: step_ms="
                  f"{real_rec['step_ms']:.3f} peak="
                  f"{'n/a' if pk is None else f'{pk / 2**30:.3f}GiB'} "
                  f"launches={real_rec['launches']}")
    except SkipCell as e:
        rec.update(status="skip", reason=str(e))
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP ({e})")
    except Exception as e:  # a failure here is a deliverable failure
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL {e}")
        traceback.print_exc(file=sys.stdout)
    out.append(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--include-graph", action="store_true",
                    help="also dry-run the paper's deepwalk-web1b SGNS step")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type and the --real cells' "
                         "device (the dry run itself runs on meta shards)")
    ap.add_argument("--real", default="",
                    help="arch:shape cells (comma separated) also run for "
                         "real on --device")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available")
    archs = sorted(REGISTRY) if args.arch == "all" else args.arch.split(",")
    if args.include_graph or args.arch == DW_CONFIG.name:
        if DW_CONFIG.name not in archs:
            archs.append(DW_CONFIG.name)
        if args.arch == DW_CONFIG.name:
            archs = [DW_CONFIG.name]
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    real = {tuple(c.split(":")) for c in args.real.split(",") if c}

    out = []
    for multi in meshes:
        # one fake group per mesh: a mesh spans its whole world
        init_world(fake_world=512 if multi else 256)
        for arch in archs:
            for shape in shapes:
                if arch == DW_CONFIG.name and shape != "train_4k":
                    continue  # graph workload has one canonical shape
                run_cell(arch, shape, multi, out, device=args.device,
                         real=(arch, shape) in real)
        torch.distributed.destroy_process_group()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # merge with existing records (other runs may write too)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    merged = {key(r): r for r in existing}
    merged.update({key(r): r for r in out})
    with open(args.out, "w") as f:
        json.dump(sorted(merged.values(), key=key), f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in out)
    n_skip = sum(r["status"] == "skip" for r in out)
    n_fail = sum(r["status"] == "fail" for r in out)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"-> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
