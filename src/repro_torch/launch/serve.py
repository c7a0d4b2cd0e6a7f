"""LM serving launcher: continuous-batched greedy decode.

``python -m repro_torch.launch.serve --arch qwen3-4b --preset reduced --device cpu``

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
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.config import ModelConfig
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import init_model

__all__ = ["cache_batch_axes", "make_requests", "ServeResult", "serve",
           "setup", "main"]


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Which axis of each cache tensor is the batch axis."""
    axes = {"len": 0, "k": 1, "v": 1}
    if cfg.kv_quant:
        axes.update(k_scale=1, v_scale=1)
    return axes


def _set_row(buf, row, b: int, axis: int):
    """Copy ``row`` (batch size 1) into row ``b`` of ``buf``, in place."""
    buf.narrow(axis, b, 1).copy_(row)
    return buf


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

    def tokens_of(rows):
        return torch.from_numpy(np.stack(rows)).to(dev)

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
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    step_toks, budget = [], []  # budget: (step, slot, request) entries
    swap_seconds: List[float] = []
    n_decoded = 0
    t_hooks = 0.0
    t0 = time.perf_counter()
    while True:
        logits, cache = decode(params, cache, tok)
        step = len(step_toks)
        n_decoded += B
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        step_toks.append(tok[:, 0])
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
                       swap_seconds, t_decode, cache)


def setup(argv=None):
    """Parse the launcher's flags -> (args, cfg, params, requests)."""
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
    if cfg.family != "dense":
        raise SystemExit(f"{cfg.name}: the {cfg.family} family is not "
                         "ported yet (ROADMAP.md)")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(cfg, gen, dev)
    requests = make_requests(cfg.vocab_size, args.requests, args.prompt_len,
                             args.seed)
    return args, cfg, params, requests


def main(argv=None) -> int:
    args, cfg, params, requests = setup(argv)
    res = serve(cfg, params, requests, slots=args.slots,
                max_new=args.max_new, device=args.device)
    print(f"[serve] {res.served} requests, {res.n_decoded} tokens decoded")
    print(f"[serve] prefill {res.prefill_seconds * 1e3:.1f} ms; decode "
          f"{res.n_decoded / max(res.decode_seconds, 1e-9):.1f} tok/s "
          f"({res.decode_seconds * 1e3 / max(res.n_decoded, 1):.2f} ms/tok)")
    return res.n_decoded


if __name__ == "__main__":
    main()
