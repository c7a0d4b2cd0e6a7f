"""Training launcher of the port: ``python -m repro_torch.launch.train``.

The torch counterpart of ``repro.launch.train``: a
decoder-only text LM (``--arch``, ``--preset reduced|full``; the MoE family
adds its aux losses, ``models.steps.loss_fn``; the encoder-decoder and
vision archs are refused, as the JAX launcher cannot train them) from
``init_model`` with a seeded generator, the optimizer of its config under a warmup-cosine
schedule, the deterministic synthetic data pipeline with a prefetch thread,
optional microbatch accumulation and int8 gradient compression with error
feedback, a straggler monitor, a hang watchdog, a SIGTERM stop, atomic
checkpoints in the JAX package's format with auto-resume, and a
``metrics.jsonl`` record per step. Returns the list of losses.

Unlike the JAX launcher, the compression residual carries from step to step
(``distributed/compression.py``; the JAX launcher stores a tracer, so every
step there compresses from zero). The residual is not checkpointed, in
either package: a resumed run starts it from zero.

``--mesh DxM`` (or ``PxDxM``, axes (pod,) data, model) trains on a mesh of
that many ranks, whose product must be the world size: under ``torchrun``
one process a device (NCCL on the card, gloo with ``--device cpu``), a
1x1 mesh also without it. The params, the optimizer state and each batch
are laid out by their logical names under the arch's rule overrides
(``distributed.sharding``; every rank draws the same params and reads the
same batch, and keeps its own slice; the optimizer state is built on each
rank's shards alone, ``sharded_state``), and checkpoints hold whole
tensors, so a run resumes on another mesh. Rank 0 alone writes the
metrics. "" (the default) trains on one device
with no mesh. ``--compress-grads`` is for the one-device run only.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --preset reduced --device cpu --steps 20 --batch 4 --seq 128 \\
      --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-4b --preset reduced --device cpu --mesh 2x2 --steps 3 \\
      --batch 4 --seq 32 --ckpt-dir "$(mktemp -d)"

A directory that holds a checkpoint is resumed from its newest step, into
the tensors just built (``CheckpointManager.restore`` copies in place).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import signal

import torch

from repro_torch.configs import get_config, sharding_overrides
from repro_torch.configs.shapes import batch_logical_names
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.compression import ErrorFeedbackInt8
from repro_torch.distributed.sharding import (distribute_tree, is_dtensor,
                                              local_tree, shapes_only,
                                              sharding_scope)
from repro_torch.distributed.watchdog import HangWatchdog, StragglerMonitor
from repro_torch.launch.mesh import init_world, make_mesh, parse_mesh
from repro_torch.models.steps import make_train_step
from repro_torch.models.transformer import init_model, model_specs
from repro_torch.train import optim
from repro_torch.train.tree import tree_map


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["reduced", "full"], default="reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help='"" (one device, no mesh), DxM or PxDxM (a mesh '
                         'of the world: under torchrun, or 1x1)')
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def sharded_state(opt, name: str, params, p_specs, device):
    """``opt.init(params)`` for DTensor ``params``, laid out as
    ``optim.optimizer_state_specs(name, ...)`` names it, built leaf by leaf
    on each rank's own shards on ``device`` (``sharding.local_tree``): no
    rank allocates a state leaf's whole size. Every optimizer of
    ``train.optim`` starts its state at zero (AdamW's moments, adafactor's
    row and column moments, SGD's velocity), so the shards are zeros, as
    the slices of a whole-tree init would be."""
    meta = shapes_only(tree_map, lambda p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), params)
    return local_tree(shapes_only(opt.init, meta),
                      optim.optimizer_state_specs(name, meta, p_specs),
                      lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                                       device=device))


def _scalar(x) -> float:
    """A metric as a float: a DTensor's (possibly partial) value reduced
    first."""
    return float(x.full_tensor() if is_dtensor(x) else x)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        mesh_dims = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if mesh_dims and args.compress_grads:
        ap.error("--compress-grads runs on one device only (no --mesh)")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if mesh_dims and math.prod(mesh_dims[0]) != world:
        ap.error(f"--mesh {args.mesh} needs {math.prod(mesh_dims[0])} "
                 f"ranks; the world has {world} (run under torchrun)")
    cfg = get_config(args.arch)
    if cfg.family == "encdec" or cfg.frontend == "vision":
        # the synthetic batch holds tokens, targets and mask only; the JAX
        # launcher's batch sharding names also ask for the frame or patch
        # embeddings (and positions), and it fails with a ValueError
        # before its first step: there is no reference run to hold one of
        # the port's to
        raise SystemExit(
            f"launch/train does not train {cfg.name}: the synthetic batch "
            "has no frame or patch embeddings, and the JAX launcher fails "
            "on this family for the same reason, so there is no reference "
            "to hold it to (models.steps.loss_fn takes such a batch)")
    device = resolve_device(args.device)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    mesh = scope = None
    if mesh_dims:
        dims, axes = mesh_dims
        started = not torch.distributed.is_initialized()
        init_world(device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(dims, axes, device=device)  # product == world size
        scope = sharding_scope(mesh, **sharding_overrides(cfg.name))
        scope.__enter__()

    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    opt = optim.make_optimizer(
        cfg.optimizer, optim.warmup_cosine(args.lr, 10, max(args.steps, 20)))

    compressor = ErrorFeedbackInt8() if args.compress_grads else None
    comp = {}

    def grad_transform(grads):
        if "state" not in comp:
            comp["state"] = compressor.init(grads)
        out, comp["state"] = compressor.compress_decompress(grads,
                                                            comp["state"])
        return out

    step_fn = make_train_step(cfg, opt, accum_steps=args.accum,
                              grad_transform=grad_transform if compressor
                              else None)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    stop = {"now": False}
    prev_handler = signal.signal(signal.SIGTERM,
                                 lambda *_: stop.update(now=True))
    mf = None
    try:
        params = init_model(cfg, torch.Generator(device).manual_seed(args.seed),
                            device)
        if mesh is None:
            opt_state = opt.init(params)
        else:  # each rank keeps its slice of the draw; the whole tree goes
            p_specs = model_specs(cfg)
            params = distribute_tree(params, p_specs, src_data_rank=None)
            opt_state = sharded_state(opt, cfg.optimizer, params, p_specs,
                                      device)
        start_step = 0
        if mgr is not None and mgr.latest_step() is not None:
            start_step = mgr.latest_step()
            tree = mgr.restore(start_step, {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            print(f"[train] resumed from step {start_step}")

        monitor = StragglerMonitor()
        metrics_path = args.metrics or (
            os.path.join(args.ckpt_dir, "metrics.jsonl") if args.ckpt_dir
            else "")
        rank0 = not torch.distributed.is_initialized() \
            or torch.distributed.get_rank() == 0
        mf = open(metrics_path, "a") if metrics_path and rank0 else None

        def batches():
            for s in range(start_step, args.steps):
                yield s, data.batch_at(s)

        wd = HangWatchdog(600.0, lambda: print("[train] WATCHDOG: step hang"))
        losses = []
        done = start_step
        for s, batch in PrefetchIterator(batches(), depth=2):
            if stop["now"]:
                break
            monitor.start_step()
            wd.arm()
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            if mesh is not None:
                batch = distribute_tree(batch, batch_logical_names(
                    cfg, train=True), src_data_rank=None)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = _scalar(metrics["loss"])
            wd.disarm()
            slow = monitor.end_step()
            losses.append(loss)
            done = s + 1
            rec = {"step": s, "loss": loss, "straggler": slow,
                   "grad_norm": _scalar(metrics["grad_norm"])}
            if mf:
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
            if s % 5 == 0 or s == args.steps - 1:
                print(f"[train] step {s} loss {loss:.4f}"
                      + (" (straggler)" if slow else ""))
            if mgr is not None and (s + 1) % args.ckpt_every == 0:
                mgr.save(s + 1, {"params": params, "opt": opt_state},
                         blocking=False)
        if mgr is not None:
            mgr.wait()
            mgr.save(done, {"params": params, "opt": opt_state})
            print(f"[train] checkpointed step {done}")
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if mf:
            mf.close()
        if scope is not None:
            scope.__exit__(None, None, None)
            if started:
                torch.distributed.destroy_process_group()
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} last loss "
              f"{losses[-1]:.4f} stragglers {monitor.straggler_fraction:.2%}")
    return losses


if __name__ == "__main__":
    main()
