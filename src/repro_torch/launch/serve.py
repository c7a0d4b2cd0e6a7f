"""LM serving launcher: continuous-batched greedy decode.

``python -m repro_torch.launch.serve --arch qwen3-4b --preset reduced --device cpu``

Any decoder-only text arch of the registry: dense, MoE (moonshot-v1-16b-a3b,
grok-1-314b), SSM (mamba2-2.7b) and hybrid (zamba2-7b); encoder-decoder and
vision archs are refused, as the JAX launcher refuses them.

The torch counterpart of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; raises without CUDA). Slots are a fixed-size
batch: one prefill fills them, then every decode step advances all slots by
one token, and a slot whose budget is spent is swapped for a queued request
(a B = 1 prefill copied into that row of every cache tensor). The schedule
is the JAX launcher's, step for step, including two of its behaviours:

* a finished slot keeps decoding while other slots have budget left and the
  queue is empty; once its length reaches the cache's end its cache writes
  are dropped (``models.attention.apply_attention_decode``) while its
  length keeps growing;
* a swapped-in request decodes first from the token that the finished
  request's last step produced: the next tokens are taken before the swap,
  and the new row's prefill logits are not used.

Weights come from the port's ``init_model`` with a ``torch.Generator``
seeded by ``--seed`` (not the JAX package's numbers); the prompts are the
JAX launcher's, drawn by numpy from the same seed. ``main`` returns the
number of tokens decoded; ``serve`` also returns each request's tokens.

Under a launcher (``WORLD_SIZE`` in the environment, as ``torchrun`` sets
it) ``setup`` serves on the JAX launcher's mesh, (world, 1) over ("data",
"model"): one process a card (NCCL; gloo with ``--device cpu``), the
params laid out by their logical names under the arch's rule overrides
(replicated: the model axis is 1), the slots split over "data" (each rank
prefills and decodes its own rows, flash-decode on its local rows), or
replicated where the world does not divide them (the rules' fallback, as
in the JAX launcher). Each step's greedy tokens are gathered once, so
every rank runs the same schedule; a swapped-in row is written into the
rank that owns it. Rank 0 alone prints. A plain process serves on one
device with no mesh, which equals the JAX launcher's 1x1 mesh (DTensor
dispatch would only slow a decode that is host-bound)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-4b --preset full --slots 8 --requests 12 \
        --prompt-len 1024 --max-new 64
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, sharding_overrides
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.sharding import (current_ctx, distribute_tree,
                                              is_dtensor, local_offset,
                                              sharding_scope, spec_for)
from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import init_model, model_specs

__all__ = ["cache_batch_axes", "make_requests", "ServeResult", "serve",
           "setup", "close", "main"]


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Which axis of each cache tensor is the batch axis (the JAX
    launcher's table)."""
    axes = {"len": 0}
    if cfg.family in ("dense", "moe"):
        axes.update(k=1, v=1)
        if cfg.kv_quant:
            axes.update(k_scale=1, v_scale=1)
    if cfg.family == "ssm":
        axes.update(conv=1, ssd=1)
    if cfg.family == "hybrid":
        axes.update(conv=2, ssd=2, k=1, v=1, tail_conv=1, tail_ssd=1)
    return axes


def _set_row(buf, row, b: int, axis: int):
    """Copy ``row`` (batch size 1) into row ``b`` of ``buf``, in place. A
    DTensor ``buf`` (split along ``axis`` alone, as the serving mesh splits
    the slots) takes it on the ranks whose local slice holds row b; every
    rank calls this."""
    if not is_dtensor(buf):
        buf.narrow(axis, b, 1).copy_(row)
        return buf
    src = row.full_tensor() if is_dtensor(row) else row
    loc, lo = buf.to_local(), local_offset(buf)[axis]
    if lo <= b < lo + loc.shape[axis]:
        loc.narrow(axis, b - lo, 1).copy_(src)
    return buf


def _mesh():
    """The ``DeviceMesh`` of the active sharding scope, or None."""
    ctx = current_ctx()
    if ctx is None or not hasattr(ctx.mesh, "mesh_dim_names"):
        return None
    return ctx.mesh


def _greedy(logits):
    """The last position's argmax -> (the (B, 1) int32 tokens as the
    decode step takes them, the (B,) tokens whole on every rank). A
    DTensor's rows are kept split as they are (any other split gathered
    first), each rank takes its own rows' argmax, and the tokens are
    gathered once."""
    if not is_dtensor(logits):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        return tok, tok[:, 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in logits.placements]
    loc = logits.redistribute(mesh, rows).to_local()
    tok = DTensor.from_local(
        loc[:, -1].argmax(-1)[:, None].to(torch.int32), mesh, rows,
        run_check=False, shape=torch.Size((logits.shape[0], 1)),
        stride=(1, 1))
    return tok, tok.full_tensor()[:, 0]


def make_requests(vocab_size: int, n: int, prompt_len: int,
                  seed: int) -> List[np.ndarray]:
    """The JAX launcher's prompts: ``n`` int32 rows of ``prompt_len`` ids
    in [2, vocab) from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab_size, size=prompt_len).astype(np.int32)
            for _ in range(n)]


@dataclasses.dataclass
class ServeResult:
    n_decoded: int  # slots x decode steps
    served: int  # requests admitted (the initial slots count as served)
    streams: List[List[int]]  # per request: the tokens decoded on its budget
    step_tokens: np.ndarray  # (steps, slots): every slot's token per step
    prefill_seconds: float  # the first prefill, all slots
    swap_seconds: List[float]  # each swap: B = 1 prefill + row copies
    decode_seconds: float  # the decode loop, swaps included, on_step not
    cache: dict  # the cache after the last step
    schedule: List[tuple]  # (step, slot, request) of each token in streams


def serve(cfg: ModelConfig, params, requests: List[np.ndarray], *,
          slots: int, max_new: int, device,
          on_step: Optional[Callable] = None) -> ServeResult:
    """Serve ``requests`` (int32 prompts of one length) in ``slots`` slots,
    ``max_new`` tokens each, greedily. ``on_step(step, cache, logits)`` is
    called after every decode step, for callers that inspect the run; it
    must not change it. The device is synchronised around each call and
    the time spent in it is left out of ``decode_seconds``."""
    dev = resolve_device(device)
    queue = list(requests)
    n_requests, B = len(queue), slots
    prompt_len = len(queue[0])
    prefill = make_prefill_step(cfg, max_len=prompt_len + max_new)
    decode = make_decode_step(cfg)
    axes = cache_batch_axes(cfg)

    mesh = _mesh()

    def tokens_of(rows):
        t = torch.from_numpy(np.stack(rows)).to(dev)
        if mesh is None:
            return t
        return distribute_tree(t, ("batch", None), src_data_rank=None)

    synchronize(dev)
    t0 = time.perf_counter()
    if len(queue) >= B:
        first = [queue.pop(0) for _ in range(B)]
    else:  # fewer requests than slots: pad with zero prompts
        first = [queue.pop(0) if queue else np.zeros(prompt_len, np.int32)
                 for _ in range(B)]
    logits, cache = prefill(params, {"tokens": tokens_of(first)})
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    remaining = [max_new] * B
    served = B
    owner = [b if b < n_requests else None for b in range(B)]
    next_req = B
    tok, _ = _greedy(logits)
    step_toks, budget = [], []  # budget: (step, slot, request) entries
    swap_seconds: List[float] = []
    n_decoded = 0
    t_hooks = 0.0
    t0 = time.perf_counter()
    while True:
        logits, cache = decode(params, cache, tok)
        step = len(step_toks)
        n_decoded += B
        tok, whole = _greedy(logits)
        step_toks.append(whole)
        if on_step is not None:
            synchronize(dev)
            th = time.perf_counter()
            on_step(step, cache, logits)
            synchronize(dev)
            t_hooks += time.perf_counter() - th
        done = []
        for b in range(B):
            if remaining[b] > 0 and owner[b] is not None:
                budget.append((step, b, owner[b]))
            remaining[b] -= 1
            if remaining[b] <= 0:
                done.append(b)
        if done and queue:
            # continuous batching: swap finished rows for queued requests
            for b in done:
                if not queue:
                    break
                synchronize(dev)
                ts = time.perf_counter()
                prompt = queue.pop(0)
                _, row_cache = prefill(params, {"tokens": tokens_of([prompt])})
                for k in cache:
                    _set_row(cache[k], row_cache[k], b, axes[k])
                synchronize(dev)
                swap_seconds.append(time.perf_counter() - ts)
                remaining[b] = max_new
                owner[b] = next_req
                next_req += 1
                served += 1
        elif done and not queue:
            if all(r <= 0 for r in remaining):
                break
        if n_decoded > (n_requests + B) * max_new * 2:
            break  # safety
    toks = torch.stack(step_toks).cpu().numpy()
    synchronize(dev)
    t_decode = time.perf_counter() - t0 - t_hooks
    streams: List[List[int]] = [[] for _ in range(n_requests)]
    for step, b, r in budget:
        streams[r].append(int(toks[step, b]))
    return ServeResult(n_decoded, served, streams, toks, t_prefill,
                       swap_seconds, t_decode, cache, budget)


def setup(argv=None):
    """Parse the launcher's flags -> (args, cfg, params, requests). Under
    a launcher (``WORLD_SIZE`` set) this also starts the world, builds the
    (world, 1) mesh, enters its sharding scope and lays the params out on
    it; ``args.mesh`` is the mesh (None in a plain process), and ``close``
    leaves the scope (and the world, if this started it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--preset", choices=["reduced", "full"], default="reduced")
    ap.add_argument("--slots", type=int, default=4, help="batch slots")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    if cfg.family == "encdec" or cfg.frontend == "vision":
        raise SystemExit("serve demo targets decoder-only text archs")
    dev = resolve_device(args.device)
    args.mesh = args.scope = None
    args.rank, args.started = 0, False
    if "WORLD_SIZE" in os.environ:
        args.started = not torch.distributed.is_initialized()
        world = init_world(device=dev)
        args.rank = torch.distributed.get_rank()
        dev = resolve_device(dev.type)  # this rank's card
        args.mesh = make_mesh((world, 1), ("data", "model"), device=dev)
        args.scope = sharding_scope(args.mesh, **sharding_overrides(cfg.name))
        args.scope.__enter__()
        split = spec_for((args.slots,), ("batch",))[0] is not None
        if args.rank == 0:
            print(f"[serve] mesh ({world}, 1) (data, model): {args.slots} "
                  "slots, " + (f"{args.slots // world} a rank" if split else
                               f"replicated on every rank ({world} ranks "
                               "do not divide them)"))
    args.device = str(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, gen, dev)
    if args.mesh is not None:
        params = distribute_tree(params, model_specs(cfg), src_data_rank=None)
    requests = make_requests(cfg.vocab_size, args.requests, args.prompt_len,
                             args.seed)
    return args, cfg, params, requests


def close(args) -> None:
    """Leave the mesh's sharding scope ``setup`` entered, and destroy the
    world if ``setup`` started it (a plain process: nothing)."""
    if args.scope is not None:
        args.scope.__exit__(None, None, None)
        args.scope = None
        if args.started:
            torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    args, cfg, params, requests = setup(argv)
    try:
        res = serve(cfg, params, requests, slots=args.slots,
                    max_new=args.max_new, device=args.device)
    finally:
        close(args)
    if args.rank == 0:
        print(f"[serve] {res.served} requests, {res.n_decoded} tokens "
              "decoded")
        print(f"[serve] prefill {res.prefill_seconds * 1e3:.1f} ms; decode "
              f"{res.n_decoded / max(res.decode_seconds, 1e-9):.1f} tok/s "
              f"({res.decode_seconds * 1e3 / max(res.n_decoded, 1):.2f} "
              "ms/tok)")
    return res.n_decoded


if __name__ == "__main__":
    main()
