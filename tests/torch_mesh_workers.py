"""Worker processes of the port's mesh tests (``tests/test_torch_*.py``):
torch and the port only, no JAX, so each spawned rank starts in a few
seconds. ``spawn`` runs a worker on N CPU ranks of a gloo group (the OS
picks a free port; the whole run has a deadline and every process is
killed at its end); a worker writes its results with ``torch.save`` from
rank 0 alone.
"""
from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.models.steps import (loss_fn, make_decode_step,
                                      make_prefill_step)
from repro_torch.train.tree import leaves, unflatten

NEW = 4  # greedy decode steps after the prefill
B, S, T, P = 2, 20, 8, 4  # S + NEW = 24 splits over 2, 4 and 8 ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world
    init_world(device="cpu")
    try:
        fn(rank, *args)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 120.0):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; raise if a rank
    fails or the deadline passes."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive:
        raise TimeoutError(f"{len(alive)} of {world} ranks still ran after "
                           f"{timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")


def batch_for(cfg, seed=0, S=S):
    """A seeded numpy batch of ``B`` rows of ``S`` tokens with targets, a
    mask and the family's extra inputs (frames, patches and positions)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "encdec":
        b["src_embeds"] = (rng.standard_normal((B, T, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        b["vision_embeds"] = (rng.standard_normal((B, P, cfg.d_model))
                              * 0.02).astype(np.float32)
        i = np.arange(P)
        patch = np.stack([np.zeros_like(i), i // 2, i % 2])
        text = np.broadcast_to(2 + np.arange(S - P), (3, S - P))
        pos = np.concatenate([patch, text], axis=1).astype(np.int32)
        b["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, B, S)))
    return b


def serve_batch(batch):
    return {k: v for k, v in batch.items() if k not in ("targets", "mask")}


def run_port(cfg, params, batch):
    """The unsharded port on the same inputs: the loss and gradients, the
    prefill's logits and cache, ``NEW`` greedy decode steps."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ws = [x.detach().clone().requires_grad_() for x in leaves(params)]
    loss, _ = loss_fn(unflatten(params, ws), tb, cfg)
    out = {"loss": loss.detach(),
           "grads": list(torch.autograd.grad(loss, ws))}
    S = tb["tokens"].shape[1]
    logits, cache = make_prefill_step(cfg, max_len=S + NEW)(
        params, serve_batch(tb))
    out["prefill"] = logits
    out["prefill_cache"] = {k: v.clone() for k, v in cache.items()}
    decode = make_decode_step(cfg)
    steps = []
    for _ in range(NEW):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        logits, cache = decode(params, cache, tok)
        steps.append(logits)
    out["decode"], out["cache"] = steps, cache
    return out


def _model_batch(batch, train):
    keys = ["tokens", "src_embeds", "vision_embeds", "positions"]
    if train:
        keys += ["targets", "mask"]
    return {k: batch[k] for k in keys if k in batch}


def family_worker(rank, mesh_shape, path, overrides_train, overrides_serve):
    """One arch on a (data, model) mesh: the loss and every gradient of
    ``loss_fn``, the prefill's logits and cache, then ``NEW`` greedy decode
    steps (logits each step, the cache at the end); every result gathered
    whole. The inputs (config, params, batch) come from ``path``; the
    results go to ``path + ".out"``."""
    from repro_torch.distributed.sharding import (distribute_tree, full_tree,
                                                  sharding_scope)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.steps import (loss_fn, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models.transformer import model_specs
    from repro_torch.configs.shapes import batch_logical_names
    from repro_torch.train.tree import leaves, unflatten

    inp = torch.load(path, weights_only=False)
    cfg, params, batch = inp["cfg"], inp["params"], inp["batch"]
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    out = {}
    with sharding_scope(mesh, **overrides_train):
        p = distribute_tree(params, model_specs(cfg), src_data_rank=None)
        b = distribute_tree(_model_batch(batch, True),
                            batch_logical_names(cfg, train=True),
                            src_data_rank=None)
        ws = [x.detach().requires_grad_() for x in leaves(p)]
        loss, _ = loss_fn(unflatten(p, ws), b, cfg)
        grads = torch.autograd.grad(loss, ws)
        out["loss"] = loss.detach().full_tensor()
        out["grads"] = [g.full_tensor() for g in grads]
    with sharding_scope(mesh, **overrides_serve):
        p = distribute_tree(params, model_specs(cfg), src_data_rank=None)
        b = distribute_tree(_model_batch(batch, False),
                            batch_logical_names(cfg, train=False),
                            src_data_rank=None)
        S = batch["tokens"].shape[1]
        logits, cache = make_prefill_step(cfg, max_len=S + NEW)(p, b)
        out["prefill"] = logits.full_tensor()
        # a replicated leaf's full tensor is the live cache: copy it
        out["prefill_cache"] = {k: v.clone()
                                for k, v in full_tree(cache).items()}
        decode = make_decode_step(cfg)
        steps = []
        for _ in range(NEW):
            tok = out["prefill"] if not steps else steps[-1]
            tok = tok[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = decode(p, cache, distribute_tree(
                tok, ("batch", None), src_data_rank=None))
            steps.append(logits.full_tensor())
        out["decode"] = steps
        out["cache"] = full_tree(cache)
        out["k_placements"] = [str(p) for p in cache["k"].placements] \
            if "k" in cache else None
    if rank == 0:
        torch.save(out, path + ".out")


def families_worker(rank, mesh_shape, runs, worker):
    """``worker(rank, mesh_shape, path, overrides_train, overrides_serve)``
    for each (path, overrides_train, overrides_serve) of ``runs`` in turn,
    in one group: several archs for one spawn of the ranks."""
    for path, train, serve in runs:
        worker(rank, mesh_shape, path, train, serve)


def train_worker(rank, argv, path):
    """``launch.train.main(argv)`` on every rank; rank 0 saves the
    losses."""
    from repro_torch.launch import train
    losses = train.main(list(argv))
    if rank == 0:
        torch.save(losses, path)


def placement_worker(rank, path):
    """A dim split over ("pod", "data") on a (2, 2, 1) mesh: each rank's
    rows, by its mesh coordinate."""
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  sharding_scope)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    with sharding_scope(mesh):
        d = distribute_tree({"x": x}, {"x": ("batch", None)})["x"]
    got = [None] * 4
    torch.distributed.all_gather_object(
        got, (tuple(mesh.get_coordinate()), d.to_local()))
    if rank == 0:
        torch.save(got, path)


def bitwise_worker(rank, path):
    """The reduced qwen3-4b in bf16: a prefill of 4 rows of 64 and 8 greedy
    decode steps with no mesh, then the same on a 1x1 mesh (every tensor a
    DTensor, flash-decode through its sharded path): each step's logits
    and whether they are equal bit for bit."""
    from repro_torch.configs import get_config, sharding_overrides
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  sharding_scope)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_model, model_specs

    cfg = get_config("qwen3-4b").reduced(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def run(p, place):
        logits, cache = make_prefill_step(cfg, max_len=72)(
            p, {"tokens": place(tokens)})
        outs, decode = [full(logits)], make_decode_step(cfg)
        for _ in range(8):
            tok = outs[-1][:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = decode(p, cache, place(tok))
            outs.append(full(logits))
        return outs

    plain = run(params, lambda x: x)
    with sharding_scope(mesh, **sharding_overrides(cfg.name)):
        dist = run(distribute_tree(params, model_specs(cfg),
                                   src_data_rank=None),
                   lambda x: distribute_tree(x, ("batch",) + (None,) * (
                       x.dim() - 1), src_data_rank=None))
    torch.save([bool(torch.equal(a, b)) for a, b in zip(plain, dist)], path)


# flash-decode on a (data, model) mesh: (H, Hkv, int8 cache); the cache
# split along its sequence over model, the rows over data; q comes split
# by heads (H / 2 a rank) and each rank keeps its heads of the combined
# output: G = 4, G = 1, an int8 cache, and H = 6 on 3 KV heads (a rank's
# 3 heads span two groups)
DECODE_CASES = ((8, 2, False), (4, 4, False), (8, 2, True), (6, 3, False))


def kernels_worker(rank, path):
    """The two kernels' sharded paths on a 2x2 (data, model) mesh against
    their unsharded runs: the SGNS loss and both tables' gradients with
    the node tables and the pair batch split over both axes (and the
    looked-up rows' layout: each rank's own pairs), and flash-decode for
    each of ``DECODE_CASES`` (softcap and window on; its output's
    layout)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import (distribute_tree,
                                                  sharded_rows,
                                                  sharding_scope)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.skipgram.model import batch_loss

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(5)
    V, D, K, Bp = 64, 16, 3, 32
    tables = {k: torch.randn((V, D), generator=gen) * 0.3
              for k in ("emb_in", "emb_out")}
    ids = {"c": torch.randint(0, V, (Bp,), generator=gen),
           "x": torch.randint(0, V, (Bp,), generator=gen),
           "n": torch.randint(0, V, (Bp, K), generator=gen)}
    out = {}
    ws = {k: t.clone().requires_grad_() for k, t in tables.items()}
    loss = batch_loss(ws, ids["c"], ids["x"], ids["n"])
    out["sgns_want"] = [loss.detach()] + list(
        torch.autograd.grad(loss, list(ws.values())))
    axes = ("data", "model")
    with sharding_scope(mesh, vocab=axes, batch=axes):
        p = distribute_tree(tables, {k: ("vocab", None) for k in tables},
                            src_data_rank=None)
        b = distribute_tree(ids, {"c": ("batch",), "x": ("batch",),
                                  "n": ("batch", None)}, src_data_rank=None)
        ws = {k: t.detach().requires_grad_() for k, t in p.items()}
        loss = batch_loss(ws, b["c"], b["x"], b["n"])
        grads = torch.autograd.grad(loss, list(ws.values()))
        out["sgns_got"] = [loss.detach().full_tensor()] + [
            g.full_tensor() for g in grads]
        rows = sharded_rows(p["emb_out"], b["n"])
        out["rows_layout"] = (list(rows.placements),
                              tuple(rows.to_local().shape))
    out["decode"] = []
    B, S, Dh = 4, 24, 16
    lens = torch.tensor([24, 5, 17, 1])
    for H, Hkv, quant in DECODE_CASES:
        q = torch.randn((B, H, Dh), generator=gen)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=gen) for _ in "kv")
        scales = {}
        if quant:
            k, v = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                    for t in (k, v))
            scales = {n: torch.rand((B, S, Hkv), generator=gen) * 0.02
                      for n in ("k_scale", "v_scale")}
        want = ops.decode_attention(q, k, v, lens, softcap=20.0, window=9,
                                    **scales)
        cache_pl = [Shard(0), Shard(1)]  # rows over data, S over model
        got = ops.decode_attention(
            distribute_tensor(q, mesh, [Shard(0), Shard(1)],
                              src_data_rank=None),
            *(distribute_tensor(t, mesh, cache_pl, src_data_rank=None)
              for t in (k, v)),
            distribute_tensor(lens, mesh, [Shard(0), Replicate()],
                              src_data_rank=None),
            softcap=20.0, window=9,
            **{n: distribute_tensor(t, mesh, cache_pl, src_data_rank=None)
               for n, t in scales.items()})
        out["decode"].append((want, got.full_tensor(),
                              [str(x) for x in got.placements]))
    if rank == 0:
        torch.save(out, path)


class AllocTally:
    """The shape of every tensor a rank allocates on a real device (a list,
    in order), under a mesh its local one: a dispatch mode notes each op's
    outputs (a DTensor's local shard; view ops and ``meta`` tensors left
    out), and DTensor's redistributions (``redistribute_local_tensor``,
    explicit ones and those inside its op dispatch) note what they return.
    ``DTensor.full_tensor``, a test's own gather, is left out."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        shapes = self.shapes = []
        self.paused = paused = [False]

        def note(outs):
            if paused[0]:
                return
            for o in outs if isinstance(outs, (tuple, list)) else (outs,):
                if isinstance(o, DTensor):
                    o = o._local_tensor
                if isinstance(o, torch.Tensor) and o.device.type != "meta":
                    shapes.append(tuple(o.shape))

        self.note = note

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    note(out)
                return out

        self.mode = Mode()

    def __enter__(self):
        from torch.distributed.tensor import DTensor, _api, _dispatch, \
            _redistribute

        self.saved = [(m, m.redistribute_local_tensor)
                      for m in (_api, _dispatch, _redistribute)]
        redistribute = _redistribute.redistribute_local_tensor

        def noting(*a, **kw):
            out = redistribute(*a, **kw)
            self.note(out)
            return out

        for m, _ in self.saved:
            m.redistribute_local_tensor = noting
        self.full = full = DTensor.full_tensor
        paused = self.paused

        def full_tensor(x, *a, **kw):
            paused[0] = True
            try:
                return full(x, *a, **kw)
            finally:
                paused[0] = False

        DTensor.full_tensor = full_tensor
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor

        self.mode.__exit__(*exc)
        DTensor.full_tensor = self.full
        for m, f in self.saved:
            m.redistribute_local_tensor = f


def expert_alloc_worker(rank, mesh_shape, path, overrides_train,
                        overrides_serve):
    """``family_worker`` under an ``AllocTally``: the local shapes each
    rank allocated (training, prefill, decode), gathered into the results
    as ``allocs`` (one sorted list of the distinct shapes a rank)."""
    with AllocTally() as tally:
        family_worker(rank, mesh_shape, path, overrides_train,
                      overrides_serve)
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, sorted(set(tally.shapes)))
    if rank == 0:
        out = torch.load(path + ".out", weights_only=False)
        out["allocs"] = got
        torch.save(out, path + ".out")


def adafactor_worker(rank, path):
    """One adafactor step of the reduced grok-1-314b (``path``: the config,
    params and gradients, whole) on a 2x2 (data, model) mesh under its own
    rules, the state built on each rank's shards as the launcher builds
    it, under an ``AllocTally``: rank 0 saves the params after the
    step (gathered whole), the shapes the step allocated on each rank and
    the local shapes of the params and the state."""
    from repro_torch.configs import sharding_overrides
    from repro_torch.distributed.sharding import (distribute_tree, full_tree,
                                                  sharding_scope)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model_specs
    from repro_torch.train import optim

    inp = torch.load(path, weights_only=False)
    cfg = inp["cfg"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    opt = optim.make_optimizer("adafactor", 1e-2)
    with sharding_scope(mesh, **sharding_overrides(cfg.name)):
        specs = model_specs(cfg)
        params = distribute_tree(inp["params"], specs, src_data_rank=None)
        grads = distribute_tree(inp["grads"], specs, src_data_rank=None)
        state = train.sharded_state(opt, "adafactor", params, specs, "cpu")
        local = {tuple(x.to_local().shape) for x in leaves((params, state))
                 if isinstance(x, torch.Tensor)}
        with AllocTally() as tally:
            opt.step(grads, state, params)
        whole = full_tree(params)
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, sorted(set(tally.shapes)))
    if rank == 0:
        torch.save({"params": whole, "allocs": got, "local": local},
                   path + ".out")


def state_init_worker(rank, argv, path):
    """``launch.train.main(argv)`` (a --mesh run with a --ckpt-dir) with a
    dispatch-mode tally around its optimizer-state init, then the same
    steps from the whole-tree init (``opt.init`` of the whole params, then
    both trees distributed: the launcher's path before the state was built
    on shards). Rank 0 saves: the shapes the init allocated beside the
    state's local and whole leaf shapes, the launcher's checkpointed tree
    and the whole-tree path's, both gathered whole."""
    from repro_torch.configs import get_config, sharding_overrides
    from repro_torch.configs.shapes import batch_logical_names
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import (distribute_tree, full_tree,
                                                  sharding_scope)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model, model_specs
    from repro_torch.train import optim

    args = train.build_parser().parse_args(list(argv))
    build, seen = train.sharded_state, {}

    def tallied(*a, **kw):
        with AllocTally() as tally:
            state = build(*a, **kw)
        ts = [x for x in leaves(state) if isinstance(x, torch.Tensor)]
        seen.update(allocs=tally.shapes,
                    local=[tuple(x.to_local().shape) for x in ts],
                    whole=[tuple(x.shape) for x in ts])
        return state

    train.sharded_state = tallied
    try:
        train.main(list(argv))
    finally:
        train.sharded_state = build
    cfg = get_config(args.arch).reduced()
    dims, axes = parse_mesh(args.mesh)
    mesh = make_mesh(dims, axes, device="cpu")
    opt = optim.make_optimizer(cfg.optimizer, optim.warmup_cosine(
        args.lr, 10, max(args.steps, 20)))
    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq,
                           seed=args.seed)
    with sharding_scope(mesh, **sharding_overrides(cfg.name)):
        params = init_model(cfg, torch.Generator().manual_seed(args.seed),
                            "cpu")
        state = opt.init(params)
        specs = model_specs(cfg)
        state = distribute_tree(state, optim.optimizer_state_specs(
            cfg.optimizer, params, specs), src_data_rank=None)
        params = distribute_tree(params, specs, src_data_rank=None)
        step = make_train_step(cfg, opt)
        for s in range(args.steps):
            batch = distribute_tree(
                {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()},
                batch_logical_names(cfg, train=True), src_data_rank=None)
            params, state, _ = step(params, state, batch)
        want = full_tree({"params": params, "opt": state})
    if rank == 0:
        template = unflatten(want, [x.clone() if isinstance(x, torch.Tensor)
                                    else x for x in leaves(want)])
        got = CheckpointManager(args.ckpt_dir).restore(args.steps, template)
        torch.save({"seen": seen, "got": got, "want": want}, path)


def serve_mesh_worker(rank, cases, path):
    """``launch.serve`` under this world (``setup`` builds the (world, 1)
    mesh) for each ``cases`` entry (its flags): the streams, ``served``,
    ``n_decoded``, the last step's logits and the cache after it, gathered
    whole; rank 0 saves them."""
    from repro_torch.distributed.sharding import full_tree
    from repro_torch.launch import serve

    out = []
    for flags in cases:
        args, cfg, params, requests = serve.setup(list(flags))
        last = {}

        def on_step(step, cache, logits):
            last["logits"] = logits.full_tensor()

        try:
            res = serve.serve(cfg, params, requests, slots=args.slots,
                              max_new=args.max_new, device=args.device,
                              on_step=on_step)
            cache = {k: v.clone() for k, v in full_tree(res.cache).items()}
        finally:
            serve.close(args)
        out.append({"streams": res.streams, "served": res.served,
                    "n_decoded": res.n_decoded, "logits": last["logits"],
                    "cache": cache})
    if rank == 0:
        torch.save(out, path)


def ssd_heads_worker(rank, mesh_shape, path, overrides_train,
                     overrides_serve):
    """``family_worker`` with the number of heads each ``ssd_chunked``
    call (train, prefill) and each decode step (``_ssd_step``) saw on each
    rank noted, gathered into the results as ``ssd_heads`` (one set a
    rank)."""
    from repro_torch.models import mamba2

    seen = set()
    chunked, step = mamba2.ssd_chunked, mamba2._ssd_step

    def noting_chunked(x, *a, **kw):
        seen.add(("chunked", x.shape[2]))
        return chunked(x, *a, **kw)

    def noting_step(zg, window, dt, conv_w, conv_b, ssm, *a, **kw):
        seen.add(("step", ssm.shape[1]))
        return step(zg, window, dt, conv_w, conv_b, ssm, *a, **kw)

    mamba2.ssd_chunked, mamba2._ssd_step = noting_chunked, noting_step
    try:
        family_worker(rank, mesh_shape, path, overrides_train,
                      overrides_serve)
    finally:
        mamba2.ssd_chunked, mamba2._ssd_step = chunked, step
    world = torch.distributed.get_world_size()
    got = [None] * world
    torch.distributed.all_gather_object(got, sorted(seen))
    if rank == 0:
        out = torch.load(path + ".out", weights_only=False)
        out["ssd_heads"] = got
        torch.save(out, path + ".out")


def attn_rows_worker(rank, mesh_shape, path, overrides_train,
                     overrides_serve):
    """``family_worker`` with the query rows and the query offset of each
    ``attention_chunked`` call (train, its recomputation, prefill) on each
    rank noted, gathered into the results as ``attn_rows`` (one sorted
    list of (rows, offset) a rank)."""
    from repro_torch.models import attention

    seen = set()
    chunked = attention.attention_chunked

    def noting(q, k, v, **kw):
        seen.add((q.shape[1], kw.get("q_offset", 0)))
        return chunked(q, k, v, **kw)

    attention.attention_chunked = noting
    try:
        family_worker(rank, mesh_shape, path, overrides_train,
                      overrides_serve)
    finally:
        attention.attention_chunked = chunked
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, sorted(seen))
    if rank == 0:
        out = torch.load(path + ".out", weights_only=False)
        out["attn_rows"] = got
        torch.save(out, path + ".out")


def seq_decode_worker(rank, path):
    """flash-decode with the cache split along its sequence over a (1,
    world) (data, model) mesh, each case of ``path`` (inputs, keywords; q
    split by heads where they divide the world) -> the combined output,
    its placements, and the collectives the call issued (the dry run's
    tally: calls and largest call by kind), on rank 0."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import Tally
    from repro_torch.launch.mesh import make_mesh

    world = torch.distributed.get_world_size()
    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    out = []
    for t, kw in torch.load(path, weights_only=False):
        q_pl = [Replicate(), Shard(1) if t["q"].shape[1] % world == 0
                else Replicate()]
        seq = [Replicate(), Shard(1)]

        def place(x, pl):
            return distribute_tensor(x, mesh, pl, src_data_rank=None)

        scales = {n: place(t[n], seq) for n in ("k_scale", "v_scale")
                  if n in t}
        with Tally() as tally:
            got = ops.decode_attention(
                place(t["q"], q_pl), place(t["k"], seq), place(t["v"], seq),
                place(t["lens"], [Replicate(), Replicate()]), **kw,
                **scales)
        out.append((got.full_tensor(), [str(p) for p in got.placements],
                    tally.coll_counts, tally.coll_largest))
    if rank == 0:
        torch.save(out, path + ".out")


def thread_backward_worker(rank, arch, mesh_shape, path):
    """The reduced ``arch``'s loss and gradients on a (data, model) mesh
    under the dry run's train-cell rules, twice: the backward on this
    thread, and on another thread with no sharding scope bound (DTensor's
    implicit replication on), as the autograd engine runs a card's
    backward on its device thread, where each rematerialised block
    recomputes. Rank 0 saves both gradient lists, whole."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import batch_logical_names
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  sharding_scope)
    from repro_torch.launch.dryrun import cell_overrides
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_model, model_specs

    cfg = get_config(arch).reduced()
    assert cfg.remat == "full"
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg).items()}
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    got = []
    for threaded in (False, True):
        with sharding_scope(mesh, **cell_overrides(arch, "train_4k",
                                                   mesh_shape[1])):
            p = distribute_tree(params, model_specs(cfg), src_data_rank=None)
            b = distribute_tree(_model_batch(batch, True),
                                batch_logical_names(cfg, train=True),
                                src_data_rank=None)
            ws = [x.detach().requires_grad_() for x in leaves(p)]
            loss, _ = loss_fn(unflatten(p, ws), b, cfg)
        box = {}

        def backward():
            try:
                with implicit_replication():
                    box["grads"] = torch.autograd.grad(loss, ws)
            except Exception as e:  # raised again on the calling thread
                box["error"] = e

        if threaded:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        if "error" in box:
            raise box["error"]
        got.append([g.full_tensor() for g in box["grads"]])
    if rank == 0:
        torch.save(got, path)
