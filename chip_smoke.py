#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA GPUs.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device (four for the four-card runs of the mesh path,
phase 14) and ``nvcc``; it imports nothing of JAX or of the
JAX package. Phases, each unguarded (any failure exits non-zero):

1. environment: the card's name and power limit, torch/CUDA versions, and
   the build of every kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) with its time;
2. the serving path: ``build_service`` on ``github-like`` at dim 128 on the
   card, ``stream_with_churn`` in blocks of 1024 with 10% churn, the
   incremental cores checked against the peeling oracle (0 mismatches),
   then embed, link-score and top-10 traffic. Every kernel's launch count
   is set to 0 just before and read just after; each must be > 0 (the
   top-k counts both of its kernels, ``topk_partial`` and ``topk_merge``:
   two launches per pass of up to 128 entries, each also counted on its
   own; the h-index counts its narrow and wide kernels on their own too).
   While this phase runs, a counting wrapper bound into
   ``ops.h_index_sweep`` tallies the (R, W) of every h-index launch; the
   5 most frequent shapes are printed with their counts and timed on the
   first call's inputs at each. The service runs with the stock SLO engine
   attached (``obs.slo.default_slos``); after the launch counts are read
   (``obs_checks``): every objective has events and the status is ok or
   alert, ``publish_metrics`` exports the SLO gauges;
   ``dispatch_cost_report`` (one fused flush under ``obs.compiled_cost``)
   launches the ELL mean once, counts at least its bytes and operations
   as ``kernels.cost`` reckons them, and leaves the table and slot map
   bit-equal; a ``device_profile`` of one top-10 call and one block of
   1,024 re-ingested edges writes a trace naming ``__global__`` functions
   of ``csrc/ellmean.cu``, ``hindex.cu`` and ``topk.cu`` (``PROFILED``),
   and the cores stay exact; ``record_memory`` reports cuda:0 with the
   card's total memory as its limit. Then ``serve_embed.main`` on the
   synthetic graph with ``--profile`` and ``--metrics-out``: one trace,
   and ``device_bytes_in_use{device="cuda:0"}`` in the exported JSON;
3. a small reference: the same path on a 300-node graph on the card and on
   the CPU (plain versions), cores equal after every block, embeddings and
   link scores within 1e-5, top-10 and top-40 ids (one pass of the top-k
   kernels each) equal off near-ties; then the serving repair with a hub
   (``generators.hub_with_cliques``: a node of degree 34,360, so its row of
   the descent is W = 65,536): 2,000 inner edges streamed in blocks of 250
   with 10% churn through ``DynamicGraph`` + ``IncrementalCore`` on the
   card, the repair pinned to the window descent, the counts set to 0
   before and read after (the fourth path, "hub"): 0 core mismatches
   against the peeling oracle after every block, hub-kernel launches > 0,
   no re-peel; and, after phase 4's serving shapes, the fifth path,
   "resilience" (``resilience_phase``):
   the serving configuration (``github-like``, dim 128, batch 64, blocks
   of 1024, 10% churn) over the stream's first 16 blocks with the
   drift-triggered retrainer attached (threshold ``RESIL_THRESHOLD``,
   budget 2: the CoreWalk + SGNS refresh on the card's SGNS kernels), run
   once uninterrupted (the twin), then, with the counts set to 0, under a
   ``RecoveryManager`` (WAL + a snapshot every 4 records, fsync on) that
   crashes at ``ingest_apply:12``, recovers (the retrainer re-attached
   before the WAL replay), takes the rest of the stream and serves top-10
   traffic. Held: one retrain before the snapshot the recovery starts from
   and one after it, re-fired in the replay; graph, store, cores, baseline
   and counters bit-identical to the twin; 0 core mismatches; h-index
   launches in the replay; SGNS forward and backward launches equal to the
   retrains' steps; every serving kernel launched. Printed: each retrain's
   stage times and steps, WAL append + fsync ms a block, snapshot and
   recovery seconds, the records replayed. Then the sixth path, "shard"
   (``shard_phase``): the same configuration over the stream's first 16
   blocks, built at one shard and row-sharded with
   ``ShardPlan.build(4, devices=["cuda:0"] * 4)``, the two driven in
   lockstep with the counts set to 0 before. Held after every block:
   cores equal, store and graph ``state_dict`` byte-equal; at the end: 0
   core mismatches, embeddings, link scores and top-10 ids and scores
   bit-equal, a 4-shard snapshot restored at 1 shard byte-equal, the ELL
   mean, h-index and top-k launched by the sharded service (its launches
   alone are the path's counts), every h-index launch there at a chunk's
   rows, and bytes moved between shards by every kind of copy; the
   three kernels checked at the shapes the path gave them. Printed: each
   service's ingest and query seconds and the ``shard_report()``.
   Where four cards are present, shard s lies on cuda:s.
   ``python3 chip_smoke.py --shard-only`` builds the kernels and runs this
   path alone, and prints no result line. Then the seventh path,
   "pipeline" (``pipeline_phase``): the resilience path's 16 blocks
   through a ``pipeline=False`` twin, then, with the counts set to 0,
   through a pipelined service (the default: each block's descent
   enqueued in chunks by ``begin_update``, read back once a chunk by
   ``finish_update``). Held: graph, store, cores, baseline and counters
   bit-equal to the twin's after every 4th block (the captures land the
   repair in flight), 0 core mismatches, h-index launches, at most 1 +
   ceil(log2(max_sweeps)) host reads a descent. Printed: each service's
   ingest and ``descend`` seconds, sweeps, sweeps enqueued and host reads
   a descent, h-index launches, and the share of descents still running
   when ``begin_update`` returned (a CUDA event queried at once).
   ``--pipeline-only`` runs this path alone, and prints no result line.
   The serving, resilience and shard paths ingest pipelined too (the
   default); ``lockstep`` syncs each service before comparing;
4. kernel parity and timing: each kernel against its plain PyTorch version
   on the same inputs, at the shapes the serving path gave it (taken from
   the live service; the h-index's two tiers also each on its own) and at
   one large shape (the top-k there at k = 11, 100 and 300: one pass, one
   and three, so the multi-pass path runs on the card; the h-index's hub
   kernel at R=64 W=65,536 and W = ``max_width()`` + 1, with est 0 rows and
   a row with no valid slot), with kernel,
   plain and library
   device times (``time_ms``: the calls queued behind a spin kernel, CUDA
   events around them, so the host's launch path is left out; the kernel
   timed through its own wrapper alone), the kernel's CUDA-event time over
   a loop of calls (``loop_ms``) and the bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, the H100 SXM's published peaks; the bytes
   and operations from ``kernels.cost``, the formulas the wrappers reckon
   into an open tally);
5. the offline path: the port's quick github table
   (``repro_torch.launch.tables``, seed 0: DeepWalk, the 13-core (Dw) row on
   the ``torch`` propagation backend, CoreWalk) at dim 150, batch 8192, with
   every count set to 0 before each row and read after it. Per row: no NaN,
   ``n_walks_run`` and ``n_sgns_steps`` equal to the JAX package's (CPU run,
   recorded in ``PERF.md``), F1 within 3 points of the JAX package's, one
   forward and one backward SGNS launch per step, and in the k-core row ELL
   mean launches and a torch propagation within 1e-4 of the scipy one
   (then the ELL mean at two of that row's propagation calls, see below);
6. the SGNS kernels against their plain versions at the training shape
   (B=8192 K=5 D=150 fp32, 1e-5), one large shape (B=65536 K=5 D=256
   bf16, 2e-2) and K = 2,048 negatives (B=64 D=150 fp32: 1e-5 against
   the same formulas in fp64, and 1e-5 x max(1, max|plain|) against the
   plain versions, whose fp32 sums of 2,048 terms drift) and the retrain's
   shape on the resilience path (B=4096 K=5 D=128 fp32, 1e-5), timed on
   inputs rotated through more than twice the L2;
7. where a training step's time goes: ``torch.profiler`` over 100 SGNS
   steps on the CoreWalk corpus at the table's settings, device time by
   kernel and the device's busy share of the window (reported, not held to
   a limit);
8. LM serving, four paths (``LM_PATHS``), each at its config's full width
   and depth, bf16, weights from its ``init_model`` with a seeded generator
   on the card, through ``repro_torch.launch.serve``: "lm" qwen3-4b (dense,
   36 layers, 32/8 heads), "moe" moonshot-v1-16b-a3b (48 layers, 16 heads
   of 128, 64 experts top-6 of 1408, vocabulary 163,840: 27.7 B params,
   55.5 GB), "ssm" mamba2-2.7b (64 mamba2 blocks) and "hybrid" zamba2-7b
   (81 mamba2 blocks, 13 calls of the shared attention block, 32 heads of
   112). Each: 12 requests in 8 slots, prompts of 1024, 64 new tokens: 128
   decode steps, four rows swapped in at step 64 while the other four run
   past their cache's end. Held: 1,024 tokens decoded, exactly one
   flash-decode launch per attention layer (or shared-block call) per step
   (36, 48, 0, 13 x 128), no NaN or inf in any logits, every token in [0,
   vocab), the swapped rows' cache holding their prefill (the KV prompt
   positions; the conv state shifted by the one step before the
   snapshot), peak memory below the card's. Printed: prefill and swap
   times, decode tokens/s and ms per step, peak memory. Then the two paths
   no launcher serves (``STEP_PATHS``: both launchers refuse these
   families, as the JAX package's do), through ``models.steps``'
   ``make_prefill_step`` and ``make_decode_step`` at full width and
   depth, bf16, weights from ``init_model`` with a seeded generator on the
   card, 8 rows and 64 greedy steps each: "encdec" seamless-m4t-large-v2
   (24 encoder and 24 decoder layers, MHA of Dh = 64, vocabulary 256,208;
   prompts of 1,024 tokens after 256 frames of seeded embeddings x 0.02)
   and "vl" qwen2-vl-7b (28 layers, 28 heads on 4 KV heads: G = 7; rows of
   2,048: 1,024 seeded patch embeddings x 0.02 of a 32 x 32 grid, then
   1,024 text tokens, at M-RoPE positions t = 0, h = i // 32, w = i % 32,
   then from 32 on all three streams). Held: 512 tokens decoded, exactly
   48 (24 self + 24 cross) and 28 flash-decode launches a step (3,072 and
   1,792), no NaN or inf, tokens in [0, V), every length prompt + 64, the
   cross K/V untouched by decoding, peak memory below the card's.
   Printed: prefill (the first call and a warm one), decode tokens/s and
   ms a step, peak memory;
9. decode parity at full width (each path with attention): one step from
   the live cache (ragged lengths, four rows past the end; the step paths'
   after their step 32, every row at one length) with the kernel
   and with the plain version bound into ``models.attention`` for that
   call (an MoE's plain step routed as the kernel's: ``Router``): caches
   equal bit for bit but where the first attention output reaches (the
   K/V rows written in layers 1 and up, the hybrid's later mamba states),
   which with the logits agree within 5e-2 x their largest magnitude; the
   cross K/V equal bit for bit; the
   routing flips of an unforced plain step and the greedy tokens'
   agreement over 8 teacher-forced steps (reported); ``torch.profiler``
   over ``LM_PROFILE_STEPS`` decode steps (device time by kernel class,
   launches per step, busy share; reported);
10. small LM references: each path's model at the reduced preset (fp32;
   qwen3-4b with G = 4) served on the card and on the CPU with the same
   weights and schedule: token streams equal, logits within 1e-4; the
   MoE's smallest router margin (reported); the step paths' reduced
   models (qwen2-vl at G = 7, a 4 x 4 patch grid) through a prefill and 8
   greedy steps on the card and on the CPU: tokens equal, logits within
   1e-4, the kernel launched per layer (encdec: twice) a step;
11. flash-decode against its plain version (``TOL_DECODE``: 2e-5 with fp32
   queries; rtol 1e-2 + atol 1e-3 with bf16 queries, bf16 or int8 cache)
   at each path's live inputs (two attention calls of one step, timed
   rotating through the K/V of several: qwen3-4b's, moonshot's G = 1,
   zamba2's Dh = 112, window 4096, seamless's self-attention (G = 1, Dh =
   64) and cross-attention (S = 256, every row full) and qwen2-vl's G = 7)
   and at a gemma2-2b shape (softcap 50,
   window 4096), a large ragged bf16 shape, the same with an int8 cache,
   and a large one at zamba2's heads (Dh = 112, G = 1), with the library
   time (one SDPA call, softcap 0 and no int8 only), the bound from the
   visible rows and the number of splits of S the launch used;
12. LM training, the "train" path (the LM serving phases' params
   and caches freed first): ``repro_torch.launch.train`` at qwen3-4b's full
   width and depth (bf16, AdamW, 20 steps of 4 x 1024 tokens; counts set
   to 0 before and read after: the path runs none of the kernels). Held: 20
   finite losses, the first within 1.5 nats of ln V, the last five's mean
   below the first five's, peak memory below the card's. Printed: step ms,
   tokens/s, model FLOP/s and its share of the bf16 dense peak, peak GB,
   device-busy ms per step (``torch.profiler`` over 3 steps). Then one
   AdamW step at qwen3-4b's widths and 2 layers, fp32, on the card and on
   the CPU from the same params (loss and grad_norm within 1e-5, the
   moments within 1e-4 x their leaf's max, the params within 1e-3 x the
   rate where sqrt(v_hat) > 100 eps and 2 x the rate everywhere), and the
   launcher at the reduced preset on the card:
   resumed from a checkpoint against an uninterrupted run (steps 8-11
   within 1e-6; the restore allocates at most one leaf on the card),
   ``--compress-grads`` (falling) and ``--accum 2`` (finite). Then the
   other families (``train_families_phase``, ``TRAIN_FAMILIES``), each at
   its config's full width in bf16, 12 steps, its depth cut only where
   AdamW's state for the whole depth does not fit the card:
   "train-moe" moonshot-v1-16b-a3b (6 of 48 layers, AdamW, the aux losses
   in the loss), "train-ssm" mamba2-2.7b (all 64), "train-hybrid"
   zamba2-7b (36 of 81: 6 shared-block calls), "train-adafactor"
   grok-1-314b (1 of 64 layers, its 8 experts of 32,768, adafactor), all
   four through ``launch/train.main`` (the cut config bound into it), 4 x
   1,024 tokens; "train-encdec" seamless-m4t-large-v2 (24 + 24 layers, 4
   x 1,024 tokens after 256 frames) and "train-vl" qwen2-vl-7b (12 of 28
   layers, 2 x 2,048: 1,024 patch embeddings, then text, M-RoPE positions,
   the mask 0 on the patches) through ``models.steps.make_train_step``,
   as the launchers refuse both; each under the launcher's schedule, its
   peak rate the default 3e-4 but where the widest diverge from this init
   (zamba2 1e-4, qwen2-vl 3e-5, grok-1 1e-5). Held as the train path's (the counts 0:
   none of the port's kernels lies on a training path), and the MoE's aux
   losses finite in every step's metrics; printed the same, with the
   params (and the MoE's active ones) and each path's seconds. Then each
   family at the reduced preset, fp32, one step on the card and on the CPU
   from the same params, held to ``TOL_TRAIN_*`` as the qwen3-4b step is
   (grok's adafactor on its analogous mask: ``held_entries``), and
   ``checkpoint_full``: seamless-m4t-large-v2 at full width and depth after
   2 steps, its params and AdamW state (13.7 GB) saved under ``build/``
   (the free disk printed first), step 3 from the live state, step 2
   restored into the live tensors and step 3 again: the restored tree and
   both step-3 losses bit-equal, save and restore seconds and GB/s
   printed, the directory deleted. ``python3 chip_smoke.py --train-only``
   builds the kernels and runs these three phases alone, and prints no
   result line;
13. the dry run of the production single-pod mesh, the "dryrun" path
   (``dryrun_phase``): (a) ``python -m repro_torch.launch.dryrun --mesh
   single --device cuda`` over every arch at ``DRYRUN_SHAPES`` and the
   graph cell, one process an arch, all started together (each cell rank
   0 of a fake process group of 256 ranks on meta shards).
   ``DRYRUN_DROPPED`` lists the cells the smoke leaves out for time (they
   are in the committed ``results/dryrun_torch.json``). Held: no
   ``fail``, the JAX package's skip set (the full-attention archs at
   long_500k), FLOPs on every ``ok`` cell; printed: a table of per-device
   argument and temp GiB, TFLOP and collective MiB, and the sweep's time.
   (b) ``--real`` on ``DRYRUN_REAL``: qwen3-4b decode_32k (flash-decode
   on rank 0's shards: the cache split along its sequence stays split,
   every query head runs over the rank's own 2,048 positions, and the
   ranks' partial outputs are combined by their log-sum-exps), qwen3-4b
   train_4k and deepwalk-web1b train_4k (both SGNS kernels on the rank's
   own pairs), rank 0's shards on the card with seeded values, the
   collectives faked. Held: exactly 36 flash-decode launches a decode
   step, SGNS forward and backward launches > 0, every launch at the
   rank's own shard shape (``DRYRUN_DECODE_SHAPE``,
   ``DRYRUN_SGNS_SHAPE``), the measured peak below the card's memory;
   printed: step ms (median of 5 after 2 warm-ups), the measured peak
   beside the tracker's temp and argument bytes, TFLOP, launches. These
   launches are the path's counts in the kernels line. Then flash-decode
   and both SGNS
   kernels at (b)'s per-device shapes, against their plain versions, with
   their bounds (and the SDPA time for flash-decode): rows of the kernels
   line's ``large``. Every flash-decode check (``check_decode``) also
   holds the kernel's log-sum-exp output against the plain version's and
   the output's bits equal with and without it;
14. the "mesh" path (``mesh_phase``). In the whole smoke, and under
   ``--mesh-only`` with fewer than four cards (``mesh_1x1_phase``):
   ``launch/serve`` at qwen3-4b's full width and depth (``MESH_ONE_FLAGS``:
   8 steps, four rows swapped in) as a plain process, then in this process
   under ``WORLD_SIZE=1`` as a launcher sets it (a real (1, 1) mesh, NCCL, a
   world of one: params, prompts, tokens and the cache DTensors,
   flash-decode through its sharded path): every step's logits bit-equal,
   tokens equal, 36 x 8 flash-decode launches at the whole batch; the mesh
   run's launches are the path's counts. ``python3 chip_smoke.py
   --mesh-only`` builds the kernels and runs this path alone, and prints no
   result line; with four cards or more it runs the four-card runs instead
   (``mesh_four``; the whole smoke's 1,200 s hold no room for them): the LM
   launchers under ``torchrun`` (``python -m torch.distributed.run
   --standalone``), one process a card, NCCL, in one subprocess of this
   script (``--mesh-rank``) whose ranks run the launchers in turn and write
   their records (launch counts set to 0 just before each launcher's run,
   peak memory, what the launcher returned) to ``build/mesh/``; any failure
   fails the smoke. The one-card references (the lm path's serve, the decode
   of (b), the first three steps of (c) and (d)) run first on cuda:0. (a)
   ``launch/serve`` on the (4, 1) data mesh with the lm path's flags (2
   slots a card): 1,024 tokens in 128 steps on every rank, 36 flash-decode
   launches a step on each at its local shape B=2 H=32 Hkv=8 Dh=128 S=1088,
   no NaN, the one-card run's schedule, and each request's stream equal to
   its one-card stream but where its first differing token is a near-tie of
   that run (its top two logits within 5e-2 x max |logit|) or its first
   token, decoded from the differing token the slot's previous request ended
   on (both counted and printed); tokens/s, ms a step and peak GB each rank;
   (b) qwen3-4b's decode on a cache split along its sequence
   (``mesh_decode_rank``): full width, a 1x4 mesh under decode_32k's rules
   (kv_seq on model), 8 rows of 32,768 positions at ragged lengths
   (``MESH_DECODE_LENS``: a rank holds no visible position of some rows),
   ``MESH_DECODE_STEPS`` steps fed seeded tokens, after the same steps with
   the cache split by its KV heads (the plain tensor-parallel baseline),
   and both first as an fp32 witness (params and cache in fp32, 4 of the
   rows), against the same steps on cuda:0 unsharded: the fp32 witness's
   logits and layer 0's attention within 1e-3 of one card's (a fault of
   the split or the combine is O(1e-1)), the bf16 logits within 0.1 x max
   |logit| (the mesh's bf16 rounding) and layer 0's attention within 2e-2,
   greedy tokens equal off near-ties, 36 flash-decode launches a step a
   rank at (8, 32, 8, 128, 8192), no cache gather (no all-gather as large
   as a layer's K slice in a profiler trace of a step, and each rank's
   peak below its params + cache + one layer's whole K and V); printed:
   each rank's collectives a step as the dry run's tally sees them and as
   the trace does, peak and ms a step (``--mesh-only decode``: this run
   alone, with its references and the kernel at its shape); (c)
   ``launch/train --mesh 2x2`` at
   qwen3-4b's full width and depth with the train path's flags for
   ``MESH_TRAIN_STEPS`` steps and (d) ``--mesh 1x4`` at mamba2-2.7b's (its
   SSD split by heads) for ``MESH_HELD_STEPS``: step 1's loss and grad norm
   within ``TOL_MESH_STEP`` of one card's, the losses of steps 2 and 3
   (after the sharded AdamW updates) within ``TOL_MESH_LOSS``, qwen3-4b's
   losses held as the train path's (the first five's mean against the last
   five's); (e) ``--mesh 1x4`` at zamba2-7b's full width and all 81 layers,
   AdamW at 1e-4: held likewise, each rank's peak below its card's; printed:
   ms a step, tokens/s, peak GB beside PR 26's, the params' and AdamW
   state's resident GB a rank against ``MESH_STATE_GB`` and the leaves no
   mesh axis splits; then flash-decode at (a)'s and (b)'s per-rank shapes
   against its plain version.

Every kernel record also holds ``x_bound`` (kernel / bound) and
``x_library`` (kernel / library, where there is a library call). Every
kernel is also held to give the same bits on a second call (all are
deterministic by design); the ELL mean is timed as well at two of
the offline k-core row's propagation calls (one shell's rows against the
table: the largest shell, and the largest that takes the row-split path)
and records which of its two paths each shape takes.

The line before the last is the ``nvidia-smi`` name and power limit; before
it, one JSON object with a record per kernel (``launches`` summed over the
serving, the hub, the resilience, the shard, the pipeline, the offline,
the four LM serving, the
two step, the train, the six training families', the dryrun and the mesh
path (every rank of every run), each path's count beside it; the h-index's hub kernel also as
a record of its own, ``h_index_hub``);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, operations/s
TOL_ELL = 1e-5
TOL_TOPK = 1e-5
TIE = 1e-6
STREAM_FRAC = 0.15  # the launcher's default: 42,303 streamed edges
TOL_SGNS = {"float32": 1e-5, "bfloat16": 2e-2}
L2_BYTES = 50e6  # H100 L2 cache
SPIN_HZ = 2.0e9  # cycles a second to size the spin kernel by (above the
# H100's clock, so that the spin lasts at least as long as asked)
# The JAX package's quick github table on the CPU, seed 0
# (``benchmarks.table_github.run(quick=True)``; PERF.md): F1 (a quality
# figure), walks and SGNS steps. Walks and steps depend only on the split
# and the cores, so they must match exactly; F1 within F1_BAND points, the
# walks and samples being another generator's.
JAX_GITHUB_QUICK = {
    "DeepWalk": (80.5409, 565500, 2070),
    "13-core (Dw)": (55.7147, 89940, 329),
    "CoreWalk": (72.5893, 124018, 454),
}
F1_BAND = 3.0
# LM serving at qwen3-4b's full width: 12 requests in 8 slots, 64 new tokens
# each, so 64 steps, a swap of four rows, and 64 more steps while the other
# four rows run past their cache's end (1088 positions)
def lm_flags(arch):
    return ["--arch", arch, "--preset", "full", "--slots", "8", "--requests",
            "12", "--prompt-len", "1024", "--max-new", "64", "--seed", "0",
            "--device", "cuda"]


def _flag(flags, name, value):
    """``flags`` with ``name``'s value replaced (or appended)."""
    flags = list(flags)
    if name in flags:
        flags[flags.index(name) + 1] = value
    else:
        flags += [name, value]
    return flags



# The LM serving paths, each at its config's full width and depth on the
# card: path -> (arch, the config fields that must hold (full width), its
# flash-decode launches a decode step, the layers (or shared-block calls)
# whose kernel inputs the parity phase keeps for timing: enough K/V to
# stream more than twice the L2)
LM_PATHS = {
    "lm": ("qwen3-4b", dict(n_layers=36, d_model=2560, n_heads=32,
                            n_kv_heads=8, head_dim=128, d_ff=9728,
                            vocab_size=151936, param_dtype="bfloat16"),
           36, (0, 7, 14, 21, 28, 35)),  # 6 x 35.6 MB
    "moe": ("moonshot-v1-16b-a3b",
            dict(n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
                 head_dim=128, vocab_size=163840, param_dtype="bfloat16",
                 moe=(64, 6, 1408)), 48, (0, 9, 19, 28, 38, 47)),  # 6 x 71
    "ssm": ("mamba2-2.7b", dict(n_layers=64, d_model=2560, vocab_size=50304,
                                param_dtype="bfloat16",
                                ssm=(128, 4, 2, 64, 8, 256)), 0, ()),
    "hybrid": ("zamba2-7b", dict(n_layers=81, d_model=3584, n_heads=32,
                                 n_kv_heads=32, head_dim=112, d_ff=14336,
                                 vocab_size=32000, param_dtype="bfloat16",
                                 shared_every=6, sliding_window=4096,
                                 ssm=(64, 4, 2, 64, 8, 256)),
               13, (0, 6, 12)),  # 3 x 125 MB
}
# The LM paths no launcher serves (both launchers refuse these families, as
# the JAX package's do), driven through ``models.steps``'
# make_prefill_step / make_decode_step at full width and depth, bf16: path
# -> (arch, the config fields that must hold, flash-decode launches a decode
# step, {label: the layers whose kernel inputs the parity phase keeps for
# timing, by the calls of a step: "self" the self-attention's, "cross" the
# cross-attention's over the encoder's output}): enough K/V to stream more
# than twice the L2
STEP_PATHS = {
    "encdec": ("seamless-m4t-large-v2",
               dict(n_layers=24, n_encoder_layers=24, d_model=1024,
                    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
                    vocab_size=256208, param_dtype="bfloat16"), 48,
               {"self": (0, 7, 15, 23),  # 4 x 35.6 MB
                "cross": tuple(range(24))}),  # 24 x 8.4 MB
    "vl": ("qwen2-vl-7b",
           dict(n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
                head_dim=128, d_ff=18944, vocab_size=152064,
                param_dtype="bfloat16", mrope_sections=(16, 24, 24),
                n_vision_patches=1024), 28,
           {"self": (0, 5, 11, 16, 22, 27)}),  # 6 x 34.6 MB
}
STEP_ROWS = 8
# prompt tokens: encdec's decoder prompts of 1,024 with 256 frames (S / 4,
# the JAX package's rule), vl's 1,024 patches then 1,024 text tokens
STEP_PROMPT = {"encdec": 1024, "vl": 2048}
STEP_NEW = 64
STEP_SNAP = 32  # the decode step after which the parity phases' cache is kept
# the reduced references: (reduced() overrides, prompt tokens, frames or
# the patch grid's side)
STEP_REFERENCES = {"encdec": ({}, 16, 8),
                   "vl": (dict(n_heads=14, n_kv_heads=2), 24, 4)}  # G = 7
LM_DECODED = 8 * 128
LM_STEPS = 128
SNAP_STEP = 64  # the step after the swap: the cache the parity phases take
LM_LOGIT_TOL = 5e-2  # x max|logit|: bf16 rounding of the attention output
# decode steps a serving path's profile window holds (20 until the training
# families came: reading a window's host and device events back took 25-64
# s a path, 230 s of the smoke's 1,200)
LM_PROFILE_STEPS = 5
# flash-decode against its plain version, (rtol, atol) by the queries' type.
# Both accumulate in fp32 and round once to q's type, so in bf16 they differ
# by at most one ulp (< 2**-7 x |out|, < 7.8e-4 below 0.1), well under 1e-2
# x |out| + 1e-3; outputs at the smoke's shapes are about 0.03-0.05 (mean of
# ~1,000-4,000 unit values), so a fixed 3e-2 would pass a wrong kernel
TOL_DECODE = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
# flash-decode's (B, H) log-sum-exp against the plain version's (rtol,
# atol): fp32 logits of the same products summed in another order; -inf
# (a row with no visible position) equal on both
TOL_LSE = (1e-5, 1e-4)
TOL_SDPA = 3e-2  # SDPA against the plain version: it rounds P to bf16
TRAIN_FLAGS = ["--arch", "qwen3-4b", "--preset", "full", "--steps", "20",
               "--batch", "4", "--seq", "1024", "--device", "cuda"]
TRAIN_PROFILE = (17, 20)  # the steps run under torch.profiler
PEAK_BF16 = 989e12  # H100 SXM bf16 dense tensor-core peak, FLOP/s
# one fp32 AdamW step at qwen3-4b's widths, card vs CPU: loss and grad_norm
# relative; mu and nu x their leaf's max |value|; the params x the rate
# where sqrt(v_hat) > 100 eps (elsewhere Adam turns a near-zero gradient's
# rounding into a step of up to the rate: 2 x the rate there). The first
# update is about the rate itself (3e-5), so a param check against the
# leaf's own magnitude would pass a skipped or negated update
TOL_TRAIN_METRIC = 1e-5
TOL_TRAIN_MOMENT = 1e-4
TOL_TRAIN_PARAM = (1e-3, 2.0)
# the share of each leaf that the 1e-3 bound must cover: the embedding's
# rows of tokens absent from the batch (tied, so their gradient is a
# softmax tail of ~1/V) mostly fall below 1e-6 (73% covered on the H100)
TRAIN_MASK_SHARE = 0.5
# LM training of the other families, each at its config's full width in
# bf16, the depth cut only where AdamW's state for the whole depth does not
# fit the card (the cut keeps the params at or under qwen3-4b's 4.02 B):
# path -> (arch, layers kept (None: all), rows, tokens a row, peak rate of
# the launcher's warmup-cosine: its default 3e-4 where the losses fall in 12
# steps; the widest models diverge there from this init, and take a rate
# about as much smaller as their widest product is wider: zamba2's d_ff
# 14,336 1e-4, qwen2-vl's 18,944 3e-5, grok-1's experts' 32,768 1e-5).
# The first four train through launch/train (``LAUNCHED_FAMILIES``), the
# last two through models.steps (both launchers refuse them); grok-1-314b
# trains with its config's adafactor, the rest with AdamW
TRAIN_FAMILIES = {
    "train-moe": ("moonshot-v1-16b-a3b", 6, 4, 1024, 3e-4),  # 3.76 B
    "train-ssm": ("mamba2-2.7b", None, 4, 1024, 3e-4),  # 3.00 B
    "train-hybrid": ("zamba2-7b", 36, 4, 1024, 1e-4),  # 3.28 B, 6 calls
    "train-adafactor": ("grok-1-314b", 1, 4, 1024, 1e-5),  # 5.73 B
    "train-encdec": ("seamless-m4t-large-v2", None, 4, 1024, 3e-4),  # 1.37 B
    "train-vl": ("qwen2-vl-7b", 12, 2, 2048, 3e-5),  # 3.89 B, 1,024 patches
}
LAUNCHED_FAMILIES = ("train-moe", "train-ssm", "train-hybrid",
                     "train-adafactor")
TRAIN_STEPS_FAMILY = 12
TRAIN_FAMILY_PROFILE = (9, 12)  # the steps run under torch.profiler
GROK_WIDTHS = dict(d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                   d_ff=32768, vocab_size=131072, param_dtype="bfloat16",
                   moe=(8, 2, 32768))
# flash-decode at made-up shapes, bf16: (label, B, H, Hkv, Dh, S, softcap,
# window, int8 cache); the last is the one before it with an int8 cache
DECODE_SHAPES = [
    ("gemma2-2b shape", 8, 8, 4, 256, 8192, 50.0, 4096, False),
    ("large", 32, 32, 8, 128, 8192, 0.0, 0, False),
    ("large int8", 32, 32, 8, 128, 8192, 0.0, 0, True),
    # zamba2-7b's heads (MHA, Dh = 112 on the 128-wide build)
    ("large Dh=112", 32, 32, 32, 112, 8192, 0.0, 0, False),
]
# the dry run's single-pod sweep (launch/dryrun) runs one subprocess per
# arch (and one for the graph cell), all started together.
# Left out of the smoke's sweep for time: the full-attention archs' 32k
# prefills (190-380 s each there, eight at once; their chunked attention
# is ~1,000 blocks a layer of eager ops on the host), grok-1-314b's
# train_4k (180 s) and nemotron-4-15b's decode_32k (120 s, which with its
# train_4k's 131 s in one process made the sweep 268 s). They are in the
# committed results/dryrun_torch.json, which the CPU makes
DRYRUN_DROPPED = tuple((a, "prefill_32k") for a in (
    "gemma2-2b", "grok-1-314b", "moonshot-v1-16b-a3b", "nemotron-4-15b",
    "qwen2-vl-7b", "qwen3-4b", "seamless-m4t-large-v2", "starcoder2-7b")) \
    + (("grok-1-314b", "train_4k"), ("nemotron-4-15b", "decode_32k"),
       ("nemotron-4-15b", "train_4k"))
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the cells run again for real on the card (rank 0's local shards):
# flash-decode on the KV-sequence-split cache, a train step, both SGNS
# kernels; flash-decode launches a decode step: one a layer
DRYRUN_REAL = (("qwen3-4b", "decode_32k"), ("qwen3-4b", "train_4k"),
               ("deepwalk-web1b", "train_4k"))
DRYRUN_DECODE_LAUNCHES = 36
# the graph cell's pairs on each of the single pod's 256 ranks (2^20 / 256)
DRYRUN_SGNS_SHAPE = (4096, 5, 128, "float32")
# qwen3-4b decode_32k on one rank: 8 of the 128 rows, all 32 query heads
# (q gathered over the model axis) on all 8 KV heads, the rank's own 2,048
# of the cache's 32,768 positions (kv_seq over the 16-way model axis)
DRYRUN_DECODE_SHAPE = (8, 32, 8, 128, 2048, "bfloat16")
# the "mesh" path (``mesh_phase``). Under --mesh-only with MESH_CARDS cards
# or more: the LM launchers under torchrun, one process a card. Otherwise
# (and always in the whole smoke, whose 1,200 s hold no room for the
# four-card runs' ~185 s): the serve launcher in this process on a 1x1
# mesh at the lm path's flags but 4 new tokens (8 steps, four rows swapped
# in at step 4), against the plain launcher
MESH_CARDS = 4
MESH_TIMEOUT = 600  # s a torchrun may take (the four-card one: three runs)
MESH_ONE_FLAGS = _flag(lm_flags("qwen3-4b"), "--max-new", "4")
# each rank's flash-decode on the (4, 1) serve: 2 of the 8 slots, every
# head, the cache's 1,088 positions (B, H, Hkv, Dh, S, cache dtype)
MESH_SERVE_SHAPE = (2, 32, 8, 128, 1088, "bfloat16")
# training on the mesh: the train path's flags (4 x 1,024, bf16, AdamW)
# with --mesh and the rate, 12 steps (the schedule's 20 as the train
# path's: its first 12 steps), held as the first five steps' mean against
# the last five's (qwen3-4b at 3e-4 is still in its warmup's spikes at
# step 10: 11.21 -> 11.75 over 10 steps on 2x2). zamba2-7b at all 81
# layers: 6.96 B params x 12 bytes (bf16 params and grads, fp32 moments)
# over 4 cards is MESH_STATE_GB a card
MESH_TRAIN_STEPS = 12
MESH_HELD_STEPS = 3
# label -> (arch, mesh, peak rate, steps). mamba2-2.7b (64 layers, the
# train-ssm path's rows and rate) on 1x4 runs by heads: 20 of its 80 SSD
# heads (two whole groups) a rank
MESH_TRAIN = {"train-2x2": ("qwen3-4b", "2x2", 3e-4, MESH_TRAIN_STEPS),
              "train-ssm-1x4": ("mamba2-2.7b", "1x4", 3e-4, MESH_HELD_STEPS),
              "train-hybrid-1x4": ("zamba2-7b", "1x4", 1e-4,
                                   MESH_TRAIN_STEPS)}
# the runs held step by step to one card's first MESH_HELD_STEPS steps
MESH_HELD = ("train-2x2", "train-ssm-1x4")
# the train cells as the JAX package lays them out (``mesh_cells``; in its
# own torchrun, ``--mesh-only cells`` alone), each held step by step to one
# card's first MESH_HELD_STEPS steps with the train path's flags:
# label -> (arch, mesh, peak rate, config changes (depth, dtypes), rows,
# tokens a row). gemma2-2b and starcoder2-7b: heads that do not divide the
# model axis, so attention runs on each rank's own S/4 query rows
# (Ulysses, attn_seq); gemma2's 8,192 tokens a row cross its 4,096 window
# at every rank boundary. starcoder2-7b at 16 of its 32 layers on both
# sides: 7.17 B x 12 bytes of AdamW state (86 GB) do not fit one card.
# grok-1-314b at one layer (the train-adafactor path's depth and rate),
# its experts 2D over (data, model) under its own rules, and its fp32
# twin (2 rows: one card holds its fp32 params, gradients and adafactor
# temporaries, ~68 GB). Rates: at 3e-4 one H100's loss rose within 3
# steps (gemma2 12.22 -> 9.67 -> 11.93, starcoder2 11.57 -> 26.83 ->
# 23.12), so they take the widths' rates of TRAIN_FAMILIES: d_ff 9,216
# 1e-4, 18,432 3e-5
MESH_CELLS = {
    "cell-gemma2-1x4": ("gemma2-2b", "1x4", 1e-4, {}, 1, 8192),
    "cell-starcoder2-1x4": ("starcoder2-7b", "1x4", 3e-5,
                            {"n_layers": 16}, 4, 1024),
    "cell-grok-2x2": ("grok-1-314b", "2x2", 1e-5, {"n_layers": 1}, 4, 1024),
    "cell-grok-2x2-fp32": ("grok-1-314b", "2x2", 1e-5, {
        "n_layers": 1, "param_dtype": "float32",
        "compute_dtype": "float32"}, 2, 1024),
}
# the step whose allocations the caching allocator records (its history,
# ``largest_allocs``) on every grok rank and on one card: no rank may
# allocate a block as large as one whole expert matrix (E x d x f bf16)
MESH_CELLS_RECORD = {"cell-grok-2x2": 1}
# the runs whose top-2 routing follows the mesh's bf16 rounding: the
# residual stream into the router differs from one card's by the bf16
# partial sums of the attention's out-projection, and a token whose
# second and third experts are that close to a tie goes elsewhere (at
# decode ~14% of the MoE's token-layers, which is why the moe path's plain
# step replays the kernel step's routing). Their losses are held at
# TOL_MESH_LOSS, their grad norms printed; the fp32 twin, whose router
# sees the same values to ~1e-6, is held at TOL_MESH_STEP
MESH_CELLS_ROUTED = ("cell-grok-2x2",)
MESH_STATE_GB = 20.9
# zamba2-7b at 81 layers on 1x4 in PR 26 (by rows: every rank ran every
# mamba block whole): ms a step (two runs) and peak GB a rank
MESH_HYBRID_BEFORE = (3812.5, 3827.0, 47.96)
# the sequence-split decode (``mesh_decode_rank``): qwen3-4b at full width
# on a 1x4 (data, model) mesh under decode_32k's rules (kv_seq on model:
# each rank holds 8,192 of the 32,768 positions of all 8 KV heads), 8
# rows, MESH_DECODE_STEPS steps fed the same seeded tokens as one card's
# unsharded run; the rows' lengths before the first step are ragged, so
# that a rank holds no visible position of some rows (100: ranks 1-3) and
# rows cross into the next rank's slice (8,184, 8,190)
MESH_DECODE = ("qwen3-4b", 8, 32768)
MESH_DECODE_STEPS = 16
MESH_DECODE_LENS = (32752, 8184, 8190, 100, 20000, 16380, 24600, 30000)
MESH_DECODE_SHAPE = (8, 32, 8, 128, 8192, "bfloat16")
# layer 0's attention output (its query not yet through any other layer),
# sequence or KV-heads split against one card's: the row's max |diff| over
# its max |out|. Both round bf16 once more than one card (a rank's partial
# outputs; the KV-heads split its own products), ~2^-8 relative; a
# combine that drops or misweighs a rank's positions is off by O(1)
TOL_MESH_ATTN = 2e-2
# the decode's fp32 witness: the same runs in fp32 (``fp32_twin``: the
# params cast from the same bf16 draws, the cache's bf16 values held in
# fp32) on these 4 of the 8 rows (all 8 in fp32 with the params, 93 GB, do
# not fit one card): the longest row, one that crosses into rank 1's slice
# at step 3, one that ranks 1-3 hold no position of, one across 3 ranks
MESH_DECODE_WITNESS = (0, 2, 3, 4)
# the fp32 witness's logits and layer 0's attention on 1x4 (either split,
# and the splits against each other) against one card's, over the row's
# max |logit| (|out|). Set before the witness's first run: a split or a
# combine that drops or misweighs positions, or a partial sum left
# unreduced, is off by O(1e-1) or more; fp32 rounding through 36 layers,
# where bf16's 2^-8 ends at ~7e-2, is ~1e-6
TOL_MESH_FP32 = 1e-3
# the bf16 run's logits on 1x4 (either split against one card's, and the
# splits against each other), over the row's max |logit|: the mesh's own
# bf16 rounding (each rank's partial sums of the out-projection and the
# MLP rounded to bf16, then summed), which the fp32 witness tells apart
# from a fault. Fixed from three runs' readings, 5.4e-2 to 7.35e-2 over 16
# steps each; above the lm path's LM_LOGIT_TOL, which the witness holds
TOL_MESH_LOGIT_BF16 = 0.1
# step 1's loss and grad norm on a mesh against one card, relative: the same
# params and batch, so only the order of the sums differs. Measured 7.9e-6
# and 2.7e-3 (4 x H100): the loss is fp32 over bf16 activations whose
# products split two ways; the grad norm is of bf16 gradients, each a sum
# over the data ranks and the model-split products rounded to bf16 (2^-8)
TOL_MESH_STEP = (1e-4, 1e-2)
# the losses of steps 2 to MESH_HELD_STEPS, after one and two sharded AdamW
# updates, against one card's, relative. Measured 4.6e-5 and 1.1e-4 (4 x
# H100): step 1's rounding, grown by the updates (an Adam step moves an
# entry by about the rate whatever its gradient's size). Two 2x2 runs gave
# bit-equal losses. 1e-3 is ~0.012 nats, under 1% of the 1.8 nats the
# first update moves the loss, so a wrong sharded update shows
TOL_MESH_LOSS = 1e-3

SOURCES = {
    "ell_mean": ("src/repro_torch/csrc/ellmean.cu",
                 "src/repro/kernels/ellmean.py:79"),
    "h_index": ("src/repro_torch/csrc/hindex.cu",
                "src/repro/kernels/hindex.py:88"),
    "h_index_hub": ("src/repro_torch/csrc/hindex.cu",
                    "src/repro/kernels/hindex.py:88"),
    "top_k": ("src/repro_torch/csrc/topk.cu",
              "src/repro/kernels/topk.py:117"),
    "sgns_fwd": ("src/repro_torch/csrc/sgns.cu",
                 "src/repro/kernels/sgns.py:66"),
    "sgns_bwd": ("src/repro_torch/csrc/sgns.cu",
                 "src/repro/kernels/sgns.py:86"),
    "decode_attention": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:134"),
}
SERVING = ("ell_mean", "h_index", "top_k")  # the kernels serving runs
# the ``__global__`` functions of each serving kernel's source, which the
# serving path's profile must name
PROFILED = {
    "csrc/ellmean.cu": ("ell_mean_scalar", "ell_mean_f32x4", "ell_mean_rows"),
    "csrc/hindex.cu": ("h_index_narrow", "h_index_wide", "h_index_hub"),
    "csrc/topk.cu": ("topk_partial", "topk_merge"),
}
# the serving repair with a hub: 34,000 leaves (and 2,000 random edges
# among them) and 12 cliques of 30, all joined to the hub; 2,000 of the
# inner edges streamed in blocks of 250 with 10% churn
HUB_GRAPH = (34000, 12, 30, 2000)
HUB_STREAM, HUB_BLOCK, HUB_CHURN = 2000, 250, 0.1
# the resilience path: the serving configuration over the stream's first 16
# blocks; a snapshot every 4 WAL records, a crash at the 12th block applied
# (ingest_apply counts ingests and retractions); the threshold puts one
# drift-triggered retrain before the snapshot the recovery starts from and
# one between it and the crash
RESIL_BLOCKS, RESIL_BLOCK, RESIL_CHURN = 16, 1024, 0.1
RESIL_SNAPSHOT_EVERY = 4
RESIL_CRASH = "ingest_apply:12:crash"
# the twin retrains in the tails of ops 5 and 11, which pipelined ingest
# runs at the start of ops 6 and 12 (``RetrainLog`` counts those)
RESIL_THRESHOLD = 0.01
RESIL_BUDGET = 2
RESIL_HANG_TIMEOUT = 120.0  # s: the watchdog around flushes and retrains
# the shard path: the serving configuration over the stream's first 16
# blocks, row-sharded over 4 shards on the one card, beside its unsharded twin
SHARD_N, SHARD_BLOCKS, SHARD_BLOCK, SHARD_CHURN = 4, 16, 1024, 0.1
# the pipeline path: the resilience path's 16 blocks, a pipelined service
# beside a serial twin, states compared after every PIPE_EVERY-th block
PIPE_EVERY = 4


T0 = time.perf_counter()  # the smoke's start: every log line's clock


def log(msg: str) -> None:
    print(f"[chip-smoke {time.perf_counter() - T0:7.1f} s] {msg}",
          flush=True)


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Counters:
    """The wrappers' launch counts by kernel name: ``reset`` sets every one
    to 0, ``read`` returns them."""

    def __init__(self, table):
        self.table = table  # name -> (module, attribute)

    def reset(self) -> None:
        for mod, attr in self.table.values():
            setattr(mod, attr, 0)

    def read(self) -> dict:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.table.items()}


def kernel_counters() -> Counters:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import ellmean, flash_decode, hindex, sgns, topk

    return Counters({
        "ell_mean": (ellmean, "launches"), "h_index": (hindex, "launches"),
        "top_k": (topk, "launches"), "sgns_fwd": (sgns, "fwd_launches"),
        "sgns_bwd": (sgns, "bwd_launches"),
        "decode_attention": (flash_decode, "launches"),
        # each kernel of the top-k's pass, and the h-index's two kernels
        "top_k.partial": (topk, "partial_launches"),
        "top_k.merge": (topk, "merge_launches"),
        "h_index.narrow": (hindex, "narrow_launches"),
        "h_index.wide": (hindex, "wide_launches"),
        "h_index.hub": (hindex, "hub_launches"),
        "h_index_hub": (hindex, "hub_launches"),  # its own record too
    })


class SweepTally:
    """While bound (``with``), counts the (R, W) of every h-index sweep
    through ``ops.h_index_sweep`` (the repair's and the k-core's entry) and
    keeps a copy of the first call's inputs at each shape; every call goes
    on to the kernel as before. Calls made while ``active`` is false are
    not tallied."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = {}
        self.first = {}
        self.active = True

    def __enter__(self):
        self.orig = self.ops.h_index_sweep
        self.ops.h_index_sweep = self
        return self

    def __exit__(self, *exc):
        self.ops.h_index_sweep = self.orig

    def __call__(self, values, valid, est, **kw):
        key = tuple(values.shape)
        if key[0] and self.active:  # the wrapper launches nothing for no rows
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.first:
                self.first[key] = (values.clone(), valid.clone(), est.clone())
        return self.orig(values, valid, est, **kw)

    def top(self, n):
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[:n]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing ----


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call with the host's launch time left out: the
    ``iters`` calls are queued behind a spin kernel that outlasts the
    host's queueing, so CUDA events around them time the device alone (the
    calls' kernels and the gaps between them). A kernel of a few
    microseconds is then timed by itself and not by the Python that
    launches it. If the host still took longer than the spin (a call that
    waits on the device), the spin is lengthened and the timing repeated;
    after three tries the time is returned host time included, and the log
    says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = max(2.0 * iters * (time.perf_counter() - t0), 1e-3)
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for _ in range(3):
        s.record()
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if queued_ms < s.elapsed_time(a):
            return a.elapsed_time(b) / iters
        spin_s *= 4
    log(f"time_ms: the host took {queued_ms:.3f} ms to queue {iters} calls, "
        "longer than the spin; this time includes host time")
    return a.elapsed_time(b) / iters


def loop_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls: the device
    time where the device is the limit, the host's launch rate where the
    host is."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(bytes_: float, ops: float):
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ratios(rec: dict) -> dict:
    """Add kernel / bound and kernel / library (None without a library
    call) to a kernel record."""
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    lib = rec.get("library_ms")
    rec["x_library"] = rec["ms"] / lib if lib else None
    return rec


# ------------------------------------------------------------ parity ----


def check_ell(torch, ops, ref, F, idx, valid, emb, label, iters=20):
    from repro_torch.kernels import cost, ellmean

    got = ops.ell_mean(idx, valid, emb, impl="cuda")
    want = ref.ell_mean_ref(idx, valid, emb)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    expect(torch.allclose(got.float(), want.float(), rtol=TOL_ELL,
                          atol=TOL_ELL),
           f"ell_mean {label}: max abs err {err}")
    expect(torch.equal(ops.ell_mean(idx, valid, emb, impl="cuda"), got),
           f"ell_mean {label}: a second call gave other bits")
    flat = idx[valid].long()
    offsets = torch.zeros(idx.shape[0], dtype=torch.long, device=idx.device)
    offsets[1:] = torch.cumsum(valid.sum(1), 0)[:-1]
    lib_out = F.embedding_bag(flat, emb, offsets, mode="mean")
    expect(torch.allclose(lib_out, want.float(), rtol=1e-4, atol=1e-4),
           f"ell_mean {label}: embedding_bag disagrees with the plain version")
    n, l = idx.shape
    d = emb.shape[1]
    cnt = int(valid.sum())
    b_ms, b_by = bound(*cost.ell_mean(idx, valid, emb))
    rec = {
        "shape": f"N={n} L={l} M={emb.shape[0]} D={d} valid={cnt}",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.ell_mean(idx, valid, emb,
                                                  impl="cuda"), iters),
        "loop_ms": loop_ms(torch, lambda: ops.ell_mean(idx, valid, emb,
                                                       impl="cuda"), iters),
        "plain_ms": time_ms(torch, lambda: ref.ell_mean_ref(idx, valid, emb),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: F.embedding_bag(
            flat, emb, offsets, mode="mean"), iters),
        "bound_ms": b_ms, "bound_by": b_by,
        "path": "row-split" if ellmean.row_split(n, l, emb.device)
                else "warp-per-row",
    }
    ratios(rec)
    log(f"ell_mean {label}: {rec}")
    return rec


def check_hindex(torch, ops, ref, tiers, label, iters=20):
    """``tiers``: list of (values, valid, est) swept together (one sweep of
    a two-tier descent is two launches); the record covers all of them,
    and with more than one tier holds each tier's own under "tiers"."""
    from repro_torch.kernels import cost

    errs = 0
    for values, valid, est in tiers:
        got = ops.h_index_sweep(values, valid, est, impl="cuda")
        want = ref.h_index_ref(values, valid, est)
        cnt = ops.h_index_sweep(values, valid, est, impl="count")
        torch.cuda.synchronize()
        errs += int((got != want).sum())
        expect(torch.equal(cnt, want), f"h_index {label}: count != ref")
        expect(torch.equal(ops.h_index_sweep(values, valid, est,
                                             impl="cuda"), got),
               f"h_index {label}: a second call gave other bits")
    expect(errs == 0, f"h_index {label}: {errs} rows differ from the ref")

    def run(impl):
        def f():
            for values, valid, est in tiers:
                ops.h_index_sweep(values, valid, est, impl=impl)
        return f

    # the padded rows of the serving shapes (est 0) cost 8 bytes each
    per_tier = [cost.h_index(*t) for t in tiers]
    b_ms, b_by = bound(sum(b for b, _ in per_tier),
                       sum(o for _, o in per_tier))
    rec = {
        "shape": " + ".join(f"R={v.shape[0]} W={v.shape[1]}"
                            for v, _, _ in tiers),
        "max_abs_err": 0.0,
        "ms": time_ms(torch, run("cuda"), iters),
        "loop_ms": loop_ms(torch, run("cuda"), iters),
        "plain_ms": time_ms(torch, run("ref"), max(iters // 4, 3)),
        "count_ms": time_ms(torch, run("count"), max(iters // 4, 3)),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if len(tiers) > 1:
        rec["tiers"] = [check_hindex(torch, ops, ref, [t],
                                     f"{label}, tier {n}", iters)
                        for n, t in enumerate(tiers)]
    ratios(rec)
    log(f"h_index {label}: {rec}")
    return rec


def topk_agree(torch, ref, got_v, got_i, q, table, k, valid):
    """Scores within TOL_TOPK; ids equal except at near-ties (scores within
    TIE of a neighbour), which are compared as sets against the plain
    top-(k + 8)."""
    want_v, want_i = ref.topk_ref(q, table, k + 8, valid=valid)
    want_v, want_i = want_v.cpu(), want_i.cpu()
    got_v, got_i = got_v.cpu(), got_i.cpu()
    err = float((got_v - want_v[:, :k]).abs().nan_to_num(0.0).max())
    expect(torch.allclose(got_v, want_v[:, :k], rtol=TOL_TOPK,
                          atol=TOL_TOPK), f"top-k scores: max abs err {err}")
    n_tie = 0
    for r in range(got_i.shape[0]):
        diff = (got_i[r] != want_i[r, :k]).nonzero().flatten().tolist()
        if not diff:
            continue
        wv = want_v[r]
        for j in diff:
            near = any(abs(float(wv[j]) - float(wv[o])) <= TIE
                       for o in (j - 1, j + 1) if 0 <= o < len(wv))
            expect(near, f"top-k row {r} pos {j}: id {int(got_i[r, j])} vs "
                         f"{int(want_i[r, j])} without a near-tie")
        lo = min(float(wv[j]) for j in diff) - TIE
        hi = max(float(wv[j]) for j in diff) + TIE
        pool = set(want_i[r][(wv >= lo) & (wv <= hi)].tolist())
        expect(set(got_i[r, diff].tolist()) <= pool,
               f"top-k row {r}: near-tied ids outside the plain tie set")
        n_tie += len(diff)
    return err, n_tie


def check_topk(torch, ops, ref, q, table, valid, k, label, iters=20):
    from repro_torch.kernels import cost, topk

    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid, impl="cuda")
    err, n_tie = topk_agree(torch, ref, got_v, got_i, q, table, k, valid)
    again_v, again_i = ops.top_k_scores(q, table, k, valid=valid,
                                        impl="cuda")
    expect(torch.equal(again_v, got_v) and torch.equal(again_i, got_i),
           f"top_k {label}: a second call gave other bits")
    bias = torch.zeros(table.shape[0], device=table.device)
    bias.masked_fill_(~valid, float("-inf"))
    n, d = table.shape
    nq = q.shape[0]
    b_ms, b_by = bound(*cost.top_k(q, table, k))
    rec = {
        "shape": f"Q={nq} N={n} D={d} k={k}",
        "max_abs_err": err, "near_tie_positions": n_tie,
        "passes": -(-k // topk.ROUND_K),  # topk_partial + topk_merge each
        # the kernels alone, on the bias that ops.top_k_scores makes
        "ms": time_ms(torch, lambda: topk.topk_cuda(q, table, bias, k),
                      iters),
        "loop_ms": loop_ms(torch, lambda: topk.topk_cuda(q, table, bias, k),
                           iters),
        "plain_ms": time_ms(torch, lambda: ref.topk_ref(q, table, k,
                                                        valid=valid),
                            max(iters // 4, 3)),
        "library_ms": time_ms(torch, lambda: torch.topk(
            q @ table.T + bias, k, dim=1), iters),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    ratios(rec)
    log(f"top_k {label}: {rec}")
    return rec


def large_shapes(torch, ops, ref, F):
    """Large shapes (one per kernel, two for the h-index), from a seeded
    generator on the card; a list of records per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    table = torch.randn((1 << 21, 128), generator=gen, device=dev)
    table = ops.normalize_rows(table)
    live = torch.rand(1 << 21, generator=gen, device=dev) < 0.9
    q = ops.normalize_rows(torch.randn((64, 128), generator=gen, device=dev))
    out = {"top_k": [check_topk(torch, ops, ref, q, table, live, k,
                                f"large k={k}", iters=10)
                     for k in (11, 100, 300)]}  # one pass, one, three
    n, l = 1 << 18, 32
    idx = torch.randint(0, 1 << 21, (n, l), generator=gen, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((n, l), generator=gen, device=dev) < 0.7
    out["ell_mean"] = [check_ell(torch, ops, ref, F, idx, valid, table,
                                 "large", iters=10)]
    del table, idx, valid
    tiers = []
    for r, w, vmax in ((1 << 20, 32, 64), (1 << 14, 2048, 400)):
        values = torch.randint(0, vmax, (r, w), generator=gen, device=dev,
                               dtype=torch.int32)
        deg = torch.randint(1, w + 1, (r,), generator=gen, device=dev)
        valid = torch.arange(w, device=dev)[None, :] < deg[:, None]
        est = torch.randint(0, vmax, (r,), generator=gen, device=dev,
                            dtype=torch.int32)
        tiers.append((values, valid, est))
    out["h_index"] = [
        check_hindex(torch, ops, ref, [t], f"large W={t[0].shape[1]}",
                     iters=10)
        for t in tiers
    ]
    return out


def hub_shapes(torch, ops, ref, live):
    """The h-index's hub kernel on ``live``, the hub tier of the hub
    serving phase's first sweep (R=64 W=65,536: the hub's row and 63 padded
    rows), and at R=64, W = 65,536 and W = ``max_width()`` + 1 (the
    narrowest hub row): values in [0, 40,000), left-packed rows of random
    degree, est random in [0, W + 10) but 0 on four rows, one row with no
    valid slot. Returns (the live record, the two others)."""
    from repro_torch.kernels import hindex

    gen = torch.Generator(device="cuda").manual_seed(5)
    recs = [check_hindex(torch, ops, ref, [live], "hub serving tier")]
    for w in (65536, hindex.max_width() + 1):
        r = 64
        values = torch.randint(0, 40000, (r, w), generator=gen,
                               device="cuda", dtype=torch.int32)
        deg = torch.randint(0, w + 1, (r,), generator=gen, device="cuda")
        valid = torch.arange(w, device="cuda")[None, :] < deg[:, None]
        est = torch.randint(0, w + 10, (r,), generator=gen, device="cuda",
                            dtype=torch.int32)
        est[:4] = 0
        valid[5] = False
        before = hindex.hub_launches
        recs.append(check_hindex(torch, ops, ref, [(values, valid, est)],
                                 f"hub R={r} W={w}", iters=10))
        expect(hindex.hub_launches > before,
               f"h_index W={w}: the hub kernel was not launched")
    return recs[0], recs[1:]


# ------------------------------------------------------------ serving ----


def top10_traffic(np, svc, rng, tag):
    """One untimed and four checked top-10 calls of 64 random queries on
    ``svc``: ids in range, never the query itself, scores in order.
    Returns the (p50, p99) seconds of the checked calls."""
    n_now = svc.graph.n_nodes
    svc.top_k_neighbors(rng.integers(0, n_now, size=64), 10)  # warmup
    svc.stats.topk_seconds.clear()
    for _ in range(4):
        nodes = rng.integers(0, n_now, size=64)
        ids, sc = svc.top_k_neighbors(nodes, 10)
        expect(ids.shape == (64, 10) and (ids >= -1).all()
               and (ids < n_now).all() and (ids != nodes[:, None]).all(),
               f"{tag}: top-k ids out of range or include the query")
        fin = np.where(np.isfinite(sc), sc, -2.0)
        expect((np.diff(fin, axis=1) <= 1e-6).all(),
               f"{tag}: top-k not ordered")
    return svc.topk_latency_percentiles()


def serve_phase(torch, np, counters):
    """The serving path on the card; returns (service, launch counts)."""
    from repro_torch.graph import datasets
    from repro_torch.launch.serve_embed import build_service

    t0 = time.perf_counter()
    g = datasets.load("github-like", seed=0)
    log(f"github-like: {g.n_nodes} nodes, {g.n_edges} edges, max degree "
        f"{int(g.degrees().max())} ({time.perf_counter() - t0:.1f} s to "
        f"generate); stream_frac {STREAM_FRAC}")
    counters.reset()
    t0 = time.perf_counter()
    svc, stream, _, k0 = build_service(
        g, stream_frac=STREAM_FRAC, dim=128, batch=64, device="cuda",
    )
    log(f"build_service: {time.perf_counter() - t0:.1f} s, k0={k0}, store "
        f"{svc.store.resident}/{svc.store.capacity} rows, dim 128")
    svc.attach_slo()  # the stock objectives (obs.slo.default_slos)
    t0 = time.perf_counter()
    n_in, n_out = svc.stream_with_churn(
        stream, block_size=1024, churn=0.1, rng=np.random.default_rng(2),
    )
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    mismatches = svc.cores.resync()
    pol = svc.cores.policy_report()
    log(f"ingest: {n_in} edges (+{n_out} retracted) in {t_ingest:.2f} s = "
        f"{(n_in + n_out) / t_ingest:.0f} edges/s, blocks of 1024, churn "
        f"0.1; {svc.stats.compactions} compactions; decisions "
        f"{pol['decisions']}; {svc.cores.descends} fused descents, "
        f"{svc.cores.sweeps} sweeps ({svc.cores.sweeps_enqueued} enqueued, "
        f"{svc.cores.descent_reads} host reads; ingest pipelined: "
        f"{svc.pipeline}); core mismatches vs oracle: {mismatches}")
    log("repair phases: " + "  ".join(
        f"{k} {v['seconds']:.3f}s[{v['impl']}]"
        for k, v in svc.cores.phase_report().items()))
    expect(mismatches == 0, f"{mismatches} core mismatches vs the oracle")

    from repro_torch.serve import ServiceStats

    rng = np.random.default_rng(1)
    n_now = svc.graph.n_nodes
    for _ in range(2):  # untimed warmup batches
        svc.embed(rng.integers(0, n_now, size=64))
    svc.stats = ServiceStats()
    t0 = time.perf_counter()
    n_embed = 0
    for _ in range(4):
        out = svc.embed(rng.integers(0, n_now, size=64))
        expect(out.shape == (64, 128) and np.isfinite(out).all(),
               f"embed returned {out.shape} / non-finite rows")
        n_embed += 64
    pairs = rng.integers(0, n_now, size=(256, 2))
    scores = svc.link_scores(pairs)
    expect(scores.shape == (256,) and np.isfinite(scores).all()
           and np.abs(scores).max() <= 1 + 1e-5, "link scores out of range")
    t_query = time.perf_counter() - t0
    p50, p99 = svc.latency_percentiles()
    st = svc.stats
    log(f"queries: {st.queries} in {st.flushes} flushes of 64, "
        f"{st.queries / t_query:.0f} queries/s; flush p50 {p50 * 1e3:.2f} "
        f"ms p99 {p99 * 1e3:.2f} ms; cold starts {st.cold_starts}, "
        f"unresolved {st.unresolved}")
    t50, t99 = top10_traffic(np, svc, rng, "serving")
    log(f"top-10: 256 queries over {svc.store.resident} resident rows, p50 "
        f"{t50 * 1e3:.2f} ms p99 {t99 * 1e3:.2f} ms per call of 64")
    counts = counters.read()
    log(f"kernel launches on the serving path: {counts}")
    for name in SERVING:
        expect(counts[name] > 0,
               f"kernel {name} was not launched on the serving path")
    return svc, counts


def obs_checks(torch, np, svc):
    """The serving path's observability on the card, after its launch
    counts were read: the SLO health of the stream and queries just served
    (every objective with events; status ok or alert) and its gauges in a
    published registry; ``dispatch_cost_report`` (the ELL mean's reckoned
    bytes and operations in it, one launch, the table and slot map
    untouched); a ``device_profile`` of one top-10 call and one block of
    ingest (re-ingesting 1,024 live edges retracted just before) whose
    trace names the ELL-mean, h-index and top-k kernels; ``record_memory``
    of cuda:0."""
    import shutil
    import tempfile

    from repro_torch.kernels import cost, ellmean
    from repro_torch.obs import MetricsRegistry, device_profile, record_memory

    health = svc.slo_health()
    names = sorted(health["objectives"])
    log("slo health: " + json.dumps(health))
    expect(names == ["degraded_serving", "flush_latency", "ingest_rate",
                     "staleness"], f"slo objectives {names}")
    for name in names:
        expect(health["objectives"][name]["events"] > 0,
               f"slo {name}: no events on the serving path")
    expect(health["status"] in ("ok", "alert"),
           f"slo status {health['status']}")
    reg = MetricsRegistry()
    svc.publish_metrics(reg)
    expect(all(reg.get("slo_compliance", slo=n) is not None
               for n in names) and reg.get("slo_healthy") is not None,
           "publish_metrics exported no SLO gauges")

    st, dev = svc.store, svc.device
    st.ensure_nodes(svc.graph.node_cap)
    idx = svc.graph.ell().neighbours[torch.zeros(svc.batch, dtype=torch.long,
                                                 device=dev)]
    valid = (idx != svc.graph.node_cap) & (
        st.slot_table_dev()[idx.long()] < st.capacity)
    n, l = idx.shape
    cnt = int(valid.sum())
    ell_bytes, ell_ops = cost.ell_mean(idx, valid, st.table())
    table, slot_map = st.table().clone(), st.slot_table().copy()
    before = ellmean.launches
    rep = svc.dispatch_cost_report()
    torch.cuda.synchronize()
    log(f"dispatch cost report (fused flush, batch {svc.batch}): "
        f"{json.dumps(rep)}; the ELL mean at N={n} L={l} D={st.dim} "
        f"valid={cnt}: {ell_bytes} bytes, {ell_ops} operations")
    expect(ellmean.launches == before + 1,
           "dispatch_cost_report: not one ELL-mean launch")
    expect(rep["flops"] > 0 and rep["flops"] >= ell_ops,
           f"dispatch_cost_report: flops {rep['flops']}")
    expect(rep["bytes_accessed"] >= ell_bytes,
           f"dispatch_cost_report: {rep['bytes_accessed']} bytes < the ELL "
           f"mean's {ell_bytes}")
    expect(torch.equal(st.table(), table)
           and np.array_equal(st.slot_table(), slot_map),
           "dispatch_cost_report changed the table or the slot map")

    rng = np.random.default_rng(12)
    src, dst = svc.graph.arc_arrays()
    arcs = np.stack([src, dst], 1)[src < dst]
    block = arcs[rng.choice(len(arcs), size=1024, replace=False)]
    expect(svc.retract_block(block) == 1024, "retract before the profile")
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    pdir = tempfile.mkdtemp(prefix="profile_", dir=build_dir)
    try:
        t0 = time.perf_counter()
        with device_profile(pdir) as prof:
            svc.top_k_neighbors(rng.integers(0, svc.graph.n_nodes, 64), 10)
            expect(len(svc.ingest_block(block)) == 1024,
                   "re-ingest in the profile")
        t_prof = time.perf_counter() - t0
        expect(prof["active"] and "error" not in prof,
               f"device_profile: {prof}")
        expect(Path(prof["trace"]).is_file(), "device_profile wrote no trace")
        with open(prof["trace"]) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        ours = {source: sorted(
                    k for k in kernels
                    if re.search(rf"::({'|'.join(names)})[<(]", k))
                for source, names in PROFILED.items()}
        log(f"device_profile: {len(events)} events, {len(kernels)} kernel "
            f"names ({Path(prof['trace']).stat().st_size} bytes, "
            f"{t_prof:.2f} s): {ours}")
        missing = [want for want, found in ours.items() if not found]
        expect(not missing, f"device_profile: no {missing} kernel in the "
               f"trace (categories {sorted({str(e.get('cat')) for e in events})})")
    finally:
        shutil.rmtree(pdir)
    mismatches = svc.cores.resync()
    expect(mismatches == 0, f"{mismatches} core mismatches after the profile")

    mem = record_memory(reg)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"record_memory: {mem}, limit {total}")
    expect(mem.get("cuda:0", 0) > 0, f"record_memory: {mem}")
    expect(reg.get("device_bytes_limit", device="cuda:0").value == total,
           "record_memory: the limit is not total_memory")


def launcher_obs_phase(torch):
    """``serve_embed.main`` on the card at the synthetic graph (2,000
    nodes) with ``--profile`` and ``--metrics-out``: a trace of the ingest
    window and the card's memory gauge in the exported JSON."""
    import shutil
    import tempfile

    from repro_torch.launch import serve_embed

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="launcher_", dir=build_dir))
    try:
        t0 = time.perf_counter()
        n = serve_embed.main([
            "--dataset", "synthetic", "--requests", "128", "--block-size",
            "256", "--churn", "0.1", "--topk", "10", "--verify",
            "--profile", str(tmp / "prof"),
            "--metrics-out", str(tmp / "metrics.json")])
        traces = list((tmp / "prof").glob("*.json"))
        with open(tmp / "metrics.json") as f:
            snap = json.load(f)
        in_use = [s for s in snap.get("device_bytes_in_use", {}).get(
            "series", []) if s["labels"] == {"device": "cuda:0"}]
        log(f"launcher --profile --metrics-out: {n} queries in "
            f"{time.perf_counter() - t0:.1f} s; traces {len(traces)} "
            f"({sum(t.stat().st_size for t in traces)} bytes); "
            f"device_bytes_in_use {in_use}")
        expect(n > 0 and len(traces) == 1, "launcher: no profile trace")
        expect(in_use and in_use[0]["value"] > 0,
               "launcher: no device_bytes_in_use{device=\"cuda:0\"}")
    finally:
        shutil.rmtree(tmp)


def sweep_tally(torch, ops, ref, tally, n=5):
    """The ``n`` most frequent (R, W) of the serving path's h-index
    launches, each timed on the first call's inputs at that shape; and the
    sum of launches x (time - bound) over them. Returns (tally record,
    timing records)."""
    total = sum(tally.counts.values())
    recs, weighted = [], 0.0
    for (r, w), count in tally.top(n):
        rec = check_hindex(torch, ops, ref, [tally.first[(r, w)]],
                           f"serving shape R={r} W={w} x {count}")
        rec["launches"] = count
        weighted += count * (rec["ms"] - rec["bound_ms"])
        recs.append(rec)
    covered = sum(rec["launches"] for rec in recs)
    out = {"launches": total, "shapes": len(tally.counts),
           "top": [{"R": r, "W": w, "launches": c}
                   for (r, w), c in tally.top(n)],
           "top_launches_x_excess_ms": weighted,
           "top_share_of_launches": covered / max(total, 1)}
    log(f"h_index shapes on the serving path: {out}")
    return out, recs


def lockstep(np, svcs, stream, block_size, churn, seed, check=None):
    """Drive services through the same blocks and churn, checking that
    their cores agree (and ``check(start)``, if given) after every block;
    each service's ``sync()`` lands its repair (and its tail) first."""
    rng = np.random.default_rng(seed)
    live = []
    for start in range(0, len(stream), block_size):
        block = stream[start:start + block_size]
        acc = [s.ingest_block(block) for s in svcs]
        expect(all(np.array_equal(acc[0], a) for a in acc),
               "accepted edges differ")
        live.extend(map(tuple, acc[0]))
        n_churn = min(int(round(churn * len(block))), len(live))
        if n_churn:
            pick = rng.choice(len(live), size=n_churn, replace=False)
            gone = set(pick.tolist())
            drop = np.array([live[i] for i in pick])
            for s in svcs:
                s.retract_block(drop)
            live = [e for i, e in enumerate(live) if i not in gone]
        for s in svcs:  # land each pipelined repair and its tail
            s.sync()
        cores = [s.cores.core for s in svcs]
        expect(all(np.array_equal(cores[0], c) for c in cores),
               f"cores differ after the block at {start}")
        if check is not None:
            check(start)


def reference_phase(torch, np):
    """The same small stream on the card and on the CPU (plain versions)."""
    from repro_torch.graph import generators
    from repro_torch.launch.serve_embed import build_service

    g = generators.barabasi_albert_varying(300, 4.0, seed=3)
    built = [build_service(g, stream_frac=0.3, dim=32, batch=16, device=d)
             for d in ("cuda", "cpu")]
    svcs = [b[0] for b in built]
    lockstep(np, svcs, built[0][1], 32, 0.1, 5)
    nodes = np.random.default_rng(7).integers(0, svcs[0].graph.n_nodes, 48)
    e_gpu, e_cpu = (s.embed(nodes) for s in svcs)
    err = float(np.abs(e_gpu - e_cpu).max())
    expect(np.allclose(e_gpu, e_cpu, rtol=1e-5, atol=1e-5),
           f"embeddings differ from the CPU path by {err}")
    pairs = np.stack([nodes, nodes[::-1]], 1)
    l_gpu, l_cpu = (s.link_scores(pairs) for s in svcs)
    expect(np.allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-5),
           "link scores differ from the CPU path")
    n_near = {}
    for k in (10, 40):  # one pass of the top-k kernels each
        # one more on the CPU, so a tie across the k-th position shows
        i_gpu, s_gpu = svcs[0].top_k_neighbors(nodes, k)
        i_cpu, s_cpu = svcs[1].top_k_neighbors(nodes, k + 1)
        expect(np.allclose(s_gpu, s_cpu[:, :k], rtol=1e-5, atol=1e-5),
               f"top-{k} scores differ from the CPU path")
        differ = i_gpu != i_cpu[:, :k]
        with np.errstate(invalid="ignore"):  # -inf padding
            gap = np.abs(np.diff(s_cpu, axis=1)) <= TIE
        near = np.zeros(s_cpu.shape, bool)
        near[:, 1:] |= gap
        near[:, :-1] |= gap
        near = near[:, :k]
        expect(not (differ & ~near).any(), f"top-{k} ids differ off near-ties")
        n_near[k] = int((differ & near).sum())
    log(f"reference: 300-node stream on cuda == cpu (cores every block, "
        f"embed max abs diff {err:.2e}, link scores, top-10 and top-40 ids; "
        f"near-tie positions that differ: {n_near})")


def hub_serve_phase(torch, np, counters):
    """The serving repair with a hub on the card (``DynamicGraph`` +
    ``IncrementalCore``, the layer ``EmbeddingService`` drives; the
    service's compaction would re-pack every row at 1.5x the hub's degree),
    pinned to the window descent: the region policy, never capped, so every
    repair sweeps the hub's row of W = 65,536. Returns (the launch counts,
    the first sweep's hub tier: values, valid, est)."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import generators
    from repro_torch.kernels import hindex, ops
    from repro_torch.serve import DynamicGraph, IncrementalCore

    t0 = time.perf_counter()
    g, inner = generators.hub_with_cliques(*HUB_GRAPH, seed=0)
    stream = inner[:HUB_STREAM]
    streamed = set(map(tuple, stream.tolist()))
    edges = g.edge_list()
    base = edges[[tuple(e) not in streamed for e in edges.tolist()]]
    dyn = DynamicGraph(g.n_nodes, base, width=16, device="cuda")
    inc = IncrementalCore(dyn, repair_policy="region", repeel_frac=1.0,
                          descend_budget=1 << 62)
    hub_deg = int(dyn.degrees()[0])
    expect(hub_deg > 32768, f"hub degree {hub_deg}")
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    live, mismatches, n_out = [], 0, 0
    counters.reset()
    t0 = time.perf_counter()
    with SweepTally(ops) as tally:
        for start in range(0, len(stream), HUB_BLOCK):
            acc = dyn.add_edges(stream[start:start + HUB_BLOCK])
            inc.on_edge_block(acc)
            live.extend(map(tuple, acc))
            pick = rng.choice(len(live), size=int(HUB_CHURN * HUB_BLOCK),
                              replace=False)
            gone = dyn.remove_edges(np.array([live[i] for i in pick]))
            inc.on_remove(gone)
            n_out += len(gone)
            drop = set(pick.tolist())
            live = [e for i, e in enumerate(live) if i not in drop]
            mismatches += int((inc.core != core_numbers_host(
                dyn.snapshot())).sum())
        torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    counts = counters.read()
    hub_keys = [k for k in tally.counts if k[1] > hindex.max_width()]
    log(f"hub serving: {g.n_nodes} nodes, hub degree {hub_deg} ({t_build:.1f}"
        f" s to build), {len(stream)} edges (+{n_out} retracted) in "
        f"{t_ingest:.2f} s, blocks of {HUB_BLOCK}; {inc.descends} descents, "
        f"{inc.sweeps} sweeps, {inc.repeels} re-peels; core mismatches vs "
        f"oracle: {mismatches}; launches {counts}; sweep shapes "
        f"{tally.top(4)}")
    expect(mismatches == 0, f"hub serving: {mismatches} core mismatches")
    expect(counts["h_index_hub"] > 0 and hub_keys,
           "hub serving: no hub-kernel launch")
    expect(inc.repeels == 0 and inc.phase_impl["descend"] == "fused[cuda]",
           "hub serving: the repair left the kernel's descent")
    return counts, tally.first[max(hub_keys, key=tally.counts.get)]


def serve_shapes(torch, np, ops, ref, F, svc):
    """Each kernel on the inputs the serving path gives it, from the live
    service: a flush batch's cold-start mean, the two tiers of an all-node
    descent sweep, and a top-11 over the resident table."""
    st = svc.store
    dev = svc.device
    rng = np.random.default_rng(11)
    nodes = torch.tensor(rng.integers(0, svc.graph.n_nodes, 64), device=dev)
    slot_of = st.slot_table_dev()
    idx = svc.graph.ell().neighbours[nodes]
    slots = slot_of[idx.long()]
    valid = (idx != svc.graph.node_cap) & (slots < st.capacity)
    out = {"ell_mean": check_ell(torch, ops, ref, F, slots.contiguous(),
                                 valid, st.table(), "serve")}
    out["h_index"] = check_hindex(torch, ops, ref,
                                  sweep_inputs(torch, np, svc), "serve")
    q, tn, live = topk_inputs(torch, ops, svc, nodes)
    out["top_k"] = check_topk(torch, ops, ref, q, tn, live, 11, "serve")
    return out


def sweep_inputs(torch, np, svc):
    """The two tiers (values, valid, est) of an all-node descent sweep of
    the live service, as its repair would launch them."""
    inc = svc.cores
    n = svc.graph.n_nodes
    cand = np.arange(n, dtype=np.int64)
    deg = svc.graph.degrees_of(cand)
    old = inc.core.astype(np.int64)
    seed = np.minimum(deg.astype(np.int64), old + 1024).astype(np.int32)
    pending = inc._descend_upload(cand, seed, old.astype(np.int32), 0,
                                  1 << 30, cand_deg=deg)
    a = pending["args"]
    est = a["est_full"].clone()
    est[a["cand"]] = a["seed"]
    parts = torch.split(a["seed"], [t[0].shape[0] for t in a["tiers"]])
    return [(est[i].contiguous(), v, p.contiguous())
            for (i, v), p in zip(a["tiers"], parts)]


def topk_inputs(torch, ops, svc, nodes):
    """(queries, table, live rows) of a top-k call of the live service:
    the embeddings of ``nodes`` against the resident table, normalised."""
    st = svc.store
    q = ops.normalize_rows(torch.tensor(svc.embed(nodes.cpu().numpy()),
                                        device=svc.device))
    tn = ops.normalize_rows(st.table())
    live = torch.tensor(st.row_valid(), device=svc.device)
    return q, tn, live


# --------------------------------------------------------- resilience ----


def resilience_ops(np, stream):
    """The resilience path's op list: the stream's first RESIL_BLOCKS
    blocks of RESIL_BLOCK edges, each followed by the retraction of a
    RESIL_CHURN share of it drawn from the edges submitted so far. A pure
    function of the stream, so ops map 1:1 onto WAL records and the durable
    sequence number is the resume index."""
    rng = np.random.default_rng(2)
    live, ops = [], []
    for start in range(0, RESIL_BLOCKS * RESIL_BLOCK, RESIL_BLOCK):
        block = np.asarray(stream[start:start + RESIL_BLOCK], np.int64)
        ops.append(("ingest", block))
        live.extend(map(tuple, block))
        pick = rng.choice(len(live), size=int(RESIL_CHURN * len(block)),
                          replace=False)
        ops.append(("retract", np.asarray([live[i] for i in pick],
                                          np.int64)))
        gone = set(pick.tolist())
        live = [e for i, e in enumerate(live) if i not in gone]
    return ops


def _apply_op(svc, op):
    kind, edges = op
    (svc.ingest_block if kind == "ingest" else svc.retract_block)(edges)


class RetrainLog:
    """Keeps the report of every retrain a service runs (auto retrains
    return theirs to no one) and the op during which each ran (a block's
    auto retrain runs in its tail: at the start of the next op when
    ingest is pipelined)."""

    def __init__(self):
        self.reports = []
        self.op = 0

    def attach(self, svc):
        from repro_torch.launch.serve_embed import attach_retrainer

        attach_retrainer(svc, seed=0, budget=RESIL_BUDGET)
        run = svc.retrainer.run

        def logged(between=None):
            rep = run(between)
            if rep is not None:
                self.reports.append((self.op, rep))
            return rep
        svc.retrainer.run = logged


def resilience_phase(torch, np, counters):
    """Drift-triggered retraining and crash safety on the card at the
    serving configuration's width (``github-like``, dim 128, batch 64,
    blocks of 1024, 10% churn), over the first RESIL_BLOCKS blocks of the
    stream. An uninterrupted twin runs first; then, with every count set to
    0, the path: a service under a ``RecoveryManager`` (WAL + a snapshot
    every RESIL_SNAPSHOT_EVERY records, fsync on) crashes at RESIL_CRASH,
    recovers from the newest snapshot plus the WAL tail (the retrainer
    re-attached before replay), takes the rest of the stream, and serves
    top-10 traffic. Held: the twin retrains before the snapshot the
    recovery starts from and after it, and the replay re-fires the later
    one; graph, store, cores, baseline and counters bit-identical to the
    twin; 0 core mismatches against the peeling oracle; h-index launches in
    the replay; SGNS forward and backward launches, and every serving
    kernel, on the path; no flush or retrain outlasting the services' hang
    watchdog (RESIL_HANG_TIMEOUT). Snapshot seconds run from the capture on the
    serving thread to the commit on the writer thread (which shares the
    GIL with ingest). Returns (launch counts, numbers)."""
    import shutil
    import tempfile

    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import datasets
    from repro_torch.kernels import hindex, sgns
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.obs import metrics
    from repro_torch.serve import RecoveryManager, faults
    from repro_torch.serve.recovery import capture_state

    g = datasets.load("github-like", seed=0)

    def fresh(log):
        t0 = time.perf_counter()
        svc, stream, _, k0 = build_service(
            g, stream_frac=STREAM_FRAC, dim=128, batch=64,
            retrain_threshold=RESIL_THRESHOLD,
            hang_timeout=RESIL_HANG_TIMEOUT, device="cuda")
        log.attach(svc)
        return svc, stream, k0, time.perf_counter() - t0

    def run_ops(svc, ops, log, start=0):
        for i in range(start, len(ops)):
            log.op = i + 1
            _apply_op(svc, ops[i])

    # --- the uninterrupted twin
    twin_log = RetrainLog()
    twin, stream, k0, t_build = fresh(twin_log)
    ops = resilience_ops(np, stream)
    t0 = time.perf_counter()
    run_ops(twin, ops, twin_log)
    twin.sync()
    t_twin = time.perf_counter() - t0
    truth, truth_man = capture_state(twin, 0)
    fired = [op for op, _ in twin_log.reports]
    log(f"resilience twin: k0={k0}, {len(ops)} ops ({RESIL_BLOCKS} blocks of "
        f"{RESIL_BLOCK}, churn {RESIL_CHURN}) in {t_twin:.2f} s "
        f"(build {t_build:.1f} s), retrain threshold {RESIL_THRESHOLD}: "
        f"retrains during ops {fired}")
    del twin

    # --- the path: crash, recover, resume, serve
    path_log = RetrainLog()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    waldir = tempfile.mkdtemp(prefix="resilience_", dir=build_dir)
    wal_s = []

    def timed_wal(mgr):
        append = mgr.wal.append

        def wrapped(kind, edges):
            t = time.perf_counter()
            out = append(kind, edges)
            wal_s.append(time.perf_counter() - t)
            return out
        mgr.wal.append = wrapped

    snap_hist = metrics().histogram("recovery_snapshot_seconds")
    snaps_before = len(snap_hist.values())
    counters.reset()
    svc, _, _, _ = fresh(path_log)
    mgr = RecoveryManager(svc, waldir, snapshot_every=RESIL_SNAPSHOT_EVERY)
    timed_wal(mgr)
    faults.install(faults.FaultPlan.parse(RESIL_CRASH))
    crashed = False
    t0 = time.perf_counter()
    try:
        run_ops(svc, ops, path_log)
    except faults.InjectedCrash as e:
        crashed = True
        log(f"resilience: {e} after {time.perf_counter() - t0:.2f} s")
    finally:
        faults.install(None)
    expect(crashed, f"resilience: {RESIL_CRASH} did not fire")
    try:
        mgr.wait()  # the dead run's snapshot writer
    except faults.InjectedCrash:
        pass  # it died with the run
    mgr.wal.close()
    del svc, mgr

    restored = {}
    path_log.op = None  # retrains in the replay

    def configure(s):
        path_log.attach(s)
        restored["retrains"] = s.stats.retrains
    h0 = hindex.launches
    svc, mgr, report = RecoveryManager.recover(
        waldir, device="cuda", snapshot_every=RESIL_SNAPSHOT_EVERY,
        configure=configure)
    replay_h = hindex.launches - h0
    refired = svc.stats.retrains - restored["retrains"]
    timed_wal(mgr)
    t0 = time.perf_counter()
    run_ops(svc, ops, path_log, start=report["wal_seq"])
    svc.sync()
    t_resume = time.perf_counter() - t0
    got, got_man = capture_state(svc, 0)
    bad = [k for k in sorted(set(truth) | set(got))
           if k not in truth or k not in got
           or not np.array_equal(truth[k], got[k])]
    oracle = core_numbers_host(svc.graph.snapshot())
    mismatches = int((svc.cores.core[: len(oracle)] != oracle).sum())
    snap = report["snapshot_wal_seq"]
    log(f"resilience: recovered from snapshot@wal_seq {snap} + "
        f"{report['replayed_records']} records ({report['replayed_edges']} "
        f"edges) in {report['recovery_seconds']:.3f} s ({replay_h} h-index "
        f"launches, {refired} retrain re-fired), resumed "
        f"{len(ops) - report['wal_seq']} ops in {t_resume:.2f} s; state "
        f"keys off the "
        f"twin: {bad}; counters equal: {got_man['stats'] == truth_man['stats']}"
        f"; core mismatches vs oracle: {mismatches}")
    expect(any(op <= snap for op in fired)
           and any(snap < op <= report["wal_seq"] for op in fired),
           f"resilience: twin retrains during ops {fired}, not on both sides "
           f"of the snapshot at {snap} before the crash at "
           f"{report['wal_seq']}")
    expect(restored["retrains"] >= 1 and refired >= 1,
           f"resilience: {restored['retrains']} retrains in the snapshot, "
           f"{refired} re-fired in the replay")
    expect(bad == [], f"resilience: state differs from the twin in {bad}")
    expect(got_man["stats"] == truth_man["stats"],
           f"resilience: counters {got_man['stats']} != the twin's "
           f"{truth_man['stats']}")
    expect(mismatches == 0, f"resilience: {mismatches} core mismatches")
    expect(replay_h > 0, "resilience: no h-index launch in the replay")
    expect(truth_man["stats"]["hangs"] == got_man["stats"]["hangs"] == 0,
           f"resilience: a flush or retrain outlasted the {RESIL_HANG_TIMEOUT}"
           f" s watchdog")

    # --- top-10 traffic on the recovered service
    t50, t99 = top10_traffic(np, svc, np.random.default_rng(1),
                             "resilience")
    counts = counters.read()
    mgr.close()
    shutil.rmtree(waldir, ignore_errors=True)

    reports = path_log.reports  # the crashed run's, the replay's, the rest's
    stages = ("plan", "walks", "train", "align", "propagate", "swap",
              "total")
    snaps = snap_hist.values()[snaps_before:]
    out = {
        "threshold": RESIL_THRESHOLD, "twin_retrains_during_ops": fired,
        "retrains": [{"during_op": op, "sgns_steps": r.sgns_steps,
                      "n_walks": r.n_walks, "core_size": r.core_size,
                      "drifted": r.drifted, "warm_rows": r.warm_rows,
                      "anchors": r.anchors, "rows_swapped": r.rows_swapped,
                      "seconds": {k: r.times[k] for k in stages}}
                     for op, r in reports],
        "wal_append_fsync_ms": {
            "blocks": len(wal_s),
            "mean": 1e3 * float(np.mean(wal_s)),
            "p50": 1e3 * float(np.percentile(wal_s, 50)),
            "max": 1e3 * float(np.max(wal_s))},
        "snapshot_s": [float(x) for x in snaps],
        "recovery_s": report["recovery_seconds"],
        "replayed_records": report["replayed_records"],
        "replayed_edges": report["replayed_edges"],
        "snapshot_wal_seq": snap, "replay_h_index_launches": replay_h,
        "topk_p50_ms": t50 * 1e3, "topk_p99_ms": t99 * 1e3,
        "launches": counts,
    }
    log("resilience: " + json.dumps(out))
    sgns_steps = sum(r.sgns_steps for _, r in reports)
    expect(counts["sgns_fwd"] == counts["sgns_bwd"] == sgns_steps > 0,
           f"resilience: SGNS launches {counts['sgns_fwd']}/"
           f"{counts['sgns_bwd']} != {sgns_steps} steps")
    for name in (*SERVING, "sgns_fwd", "sgns_bwd"):
        expect(counts[name] > 0,
               f"kernel {name} was not launched on the resilience path")
    return counts, out


# -------------------------------------------------------------- shard ----


def peer_copy_blocks(torch, spin_s: float = 0.2) -> dict:
    """Whether a copy from cuda:0 to cuda:1 (``.to(d)``, as the sharded
    descent's copies are) holds the host: host seconds of the call queued
    behind a spin kernel of ``spin_s`` on cuda:0, against the spin."""
    x = torch.ones(1 << 20, device="cuda:0")
    torch.cuda.synchronize("cuda:0")
    torch.cuda._sleep(int(spin_s * SPIN_HZ))
    t0 = time.perf_counter()
    y = x.to("cuda:1")
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize("cuda:0")
    torch.cuda.synchronize("cuda:1")
    expect(bool((y == 1).all()), "peer copy lost its values")
    return {"host_s": host_s, "spin_s": spin_s,
            "blocks_host": host_s > spin_s / 2}


class PathMeter:
    """Seconds and launch counts of one service's calls: ``with meter:``
    around them (or methods bound through ``wrap``) adds the counts'
    increase and the device-synchronised seconds to its totals, and sets
    ``tally.active`` meanwhile."""

    def __init__(self, torch, counters, tally=None):
        self.torch, self.counters, self.tally = torch, counters, tally
        self.counts = {k: 0 for k in counters.table}
        self.seconds = 0.0

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.before = self.counters.read()
        if self.tally is not None:
            self.tally.active = True
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - self.t0
        if self.tally is not None:
            self.tally.active = False
        for k, v in self.counters.read().items():
            self.counts[k] += v - self.before[k]

    def wrap(self, svc, *names):
        for name in names:
            fn = getattr(svc, name)

            def metered(*a, fn=fn, **kw):
                with self:
                    return fn(*a, **kw)
            setattr(svc, name, metered)


class FirstCall:
    """While bound (``with``), keeps clones of the tensor arguments of the
    first call to ``ops.<name>`` made while ``active``; every call goes on
    as before."""

    def __init__(self, torch, ops, name):
        self.torch, self.ops, self.name = torch, ops, name
        self.args = None
        self.active = False

    def __enter__(self):
        self.orig = getattr(self.ops, self.name)
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)

    def __call__(self, *a, **kw):
        if self.active and self.args is None:
            keep = [x.clone() if isinstance(x, self.torch.Tensor) else x
                    for x in (*a, *kw.values())]
            self.args = keep
        return self.orig(*a, **kw)


def shard_phase(torch, np, ops, ref, F, counters):
    """Row-sharded serving on the card (``serve/shard.py``): the serving
    configuration (``github-like``, dim 128, batch 64, blocks of 1024, 10%
    churn) over the stream's first SHARD_BLOCKS blocks, built twice: at
    one shard and with ``ShardPlan.build(SHARD_N, devices=["cuda:0"] *
    SHARD_N)``, driven in lockstep with the counts set to 0 before. Held
    after every block: cores equal, store and graph ``state_dict`` byte
    equal. Held at the end: 0 core mismatches against the peeling oracle,
    embeddings and link scores bit-equal, top-10 ids equal and scores
    bit-equal, a 4-shard snapshot restored at 1 shard byte-equal, the ELL
    mean, h-index and top-k launched on the sharded service, and every
    h-index launch there at a chunk's rows (per (R, W), a multiple of
    SHARD_N launches, SHARD_N x R a tier's row count). The path's counts
    are the sharded service's alone; its kernels are then checked at the
    shapes it gave them (a chunk's h-index sweep, the compact table's ELL
    mean, a chunk's top-11). With SHARD_N cards present, shard s lies on
    cuda:s instead and rows cross cards by peer copies. Returns (launch
    counts, records, numbers)."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import datasets
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.serve import ShardPlan
    from repro_torch.serve.recovery import capture_state, restore_service

    g = datasets.load("github-like", seed=0)
    many = torch.cuda.device_count() >= SHARD_N
    plan = ShardPlan.build(SHARD_N, devices=[
        f"cuda:{s if many else 0}" for s in range(SHARD_N)])
    svcs, t_build = [], []
    for shards in (1, plan):
        t0 = time.perf_counter()
        svc, stream, _, k0 = build_service(
            g, stream_frac=STREAM_FRAC, dim=128, batch=64, shards=shards,
            device="cuda")
        t_build.append(time.perf_counter() - t0)
        svcs.append(svc)
    one, sh = svcs
    stream = stream[: SHARD_BLOCKS * SHARD_BLOCK]

    def diff(a, b):
        return [k for k in sorted(set(a) | set(b)) if k not in a
                or k not in b or not np.array_equal(a[k], b[k])]

    def same_state(start):
        for part in ("store", "graph"):
            d = diff(getattr(one, part).state_dict(),
                     getattr(sh, part).state_dict())
            expect(d == [], f"shard: {part} state differs after the block "
                            f"at {start} in {d}")

    counters.reset()
    sh.store.reset_shard_traffic()  # the report covers the driven run
    tally = SweepTally(ops)
    tally.active = False
    meters = [PathMeter(torch, counters), PathMeter(torch, counters, tally)]
    for m, svc in zip(meters, svcs):
        m.wrap(svc, "ingest_block", "retract_block", "sync")
    with tally:
        lockstep(np, svcs, stream, SHARD_BLOCK, SHARD_CHURN, 2,
                 check=same_state)
    oracle = core_numbers_host(sh.graph.snapshot())
    mismatches = int((sh.cores.core[: len(oracle)] != oracle).sum())
    expect(mismatches == 0, f"shard: {mismatches} core mismatches")
    ingest_s = [m.seconds for m in meters]

    # queries: the ELL mean's and the top-k's inputs kept from the sharded
    # service's first calls
    rng = np.random.default_rng(1)
    n_now = one.graph.n_nodes
    warm = rng.integers(0, n_now, size=64)
    batches = [rng.integers(0, n_now, size=64) for _ in range(4)]
    pairs = rng.integers(0, n_now, size=(256, 2))
    query_s = []
    answers = []
    with FirstCall(torch, ops, "ell_mean") as ell, \
            FirstCall(torch, ops, "top_k_scores") as tk:
        for m, svc in zip(meters, svcs):
            ell.active = tk.active = svc is sh
            with m:  # a warmup, left out of the query seconds
                svc.top_k_neighbors(warm, 10)
            t0 = m.seconds
            with m:
                emb = [svc.embed(b) for b in batches]
                link = svc.link_scores(pairs)
                top = [svc.top_k_neighbors(b, 10) for b in batches]
            query_s.append(m.seconds - t0)
            answers.append((emb, link, top))
    (e1, l1, t1), (e4, l4, t4) = answers
    expect(all(np.array_equal(a, b) for a, b in zip(e1, e4)),
           "shard: embeddings differ from one shard's")
    expect(np.array_equal(l1, l4), "shard: link scores differ")
    for (i1, v1), (i4, v4) in zip(t1, t4):
        expect(np.array_equal(i1, i4), "shard: top-10 ids differ")
        expect(np.array_equal(v1, v4), "shard: top-10 scores differ")
    same_state("the queries")

    counts = meters[1].counts
    log(f"shard: launches on the {SHARD_N}-shard service: {counts}; "
        f"the unsharded twin's: {meters[0].counts}")
    for name in SERVING:
        expect(counts[name] > 0,
               f"kernel {name} was not launched on the shard path")
    bad = {k: c for k, c in tally.counts.items()
           if c % SHARD_N or (SHARD_N * k[0]) & (SHARD_N * k[0] - 1)
           or SHARD_N * k[0] < 64}
    expect(tally.counts and not bad,
           f"shard: h-index launches not at a chunk's rows: {bad}")

    # snapshot at 4 shards -> restore at 1: byte-equal
    t0 = time.perf_counter()
    arrays, manifest = capture_state(sh, 0)
    back = restore_service(arrays, manifest, device="cuda")
    d = diff(arrays, capture_state(back, 0)[0])
    expect(d == [], f"shard: a {SHARD_N}-shard snapshot restored at 1 "
                    f"shard differs in {d}")
    expect(diff(arrays, capture_state(one, 0)[0]) == [],
           "shard: the sharded snapshot differs from the twin's")
    t_snap = time.perf_counter() - t0
    report = sh.store.shard_report()
    moved = report["moved_bytes"]
    expect(all(moved.get(op, 0) > 0 for op in ("gather", "scatter", "topk",
                                                "descent", "region")),
           f"shard: an operation moved no bytes between shards: {moved}")
    out = {
        "shards": SHARD_N, "devices": [str(x) for x in plan.devices],
        "blocks": SHARD_BLOCKS, "build_s": t_build,
        "ingest_s": {"1": ingest_s[0], str(SHARD_N): ingest_s[1]},
        "query_s": {"1": query_s[0], str(SHARD_N): query_s[1]},
        "snapshot_restore_s": t_snap,
        "h_index_shapes": {f"R={r} W={w}": c
                           for (r, w), c in tally.top(8)},
        "shard_report": report, "launches": counts,
        "twin_launches": meters[0].counts,
    }
    if many:  # does a copy between cards hold the host (the descent's)?
        out["peer_copy"] = peer_copy_blocks(torch)
    log("shard: " + json.dumps(out))
    log(f"shard: {SHARD_BLOCKS} blocks of {SHARD_BLOCK} in "
        f"{ingest_s[1]:.2f} s at {SHARD_N} shards vs {ingest_s[0]:.2f} s "
        f"at 1; queries (4 x embed 64, 256 link scores, 4 x top-10 of 64) "
        f"{query_s[1]:.3f} s vs {query_s[0]:.3f} s; cores, stores, graphs, "
        f"embeddings, link scores, top-10 ids and scores bit-equal; shard "
        f"report {report}")

    # each kernel at the shapes the shard path gave it
    (r, w), _ = tally.top(1)[0]
    recs = {"h_index": check_hindex(torch, ops, ref, [tally.first[(r, w)]],
                                    f"shard chunk R={r} W={w}")}
    idx, valid, emb = ell.args[:3]
    # the flush's remapped indices are int64: the wrapper's cast to int32
    # is a kernel of its own, left out of the kernel's time here
    recs["ell_mean"] = check_ell(torch, ops, ref, F, idx.int(), valid, emb,
                                 "shard compact table")
    q, table, k, live = tk.args
    recs["top_k"] = check_topk(torch, ops, ref, q, table, live, k,
                               "shard chunk")
    del svcs, one, sh, back
    return counts, recs, out


# ----------------------------------------------------------- pipeline ----


def pipeline_phase(torch, np, counters):
    """Pipelined ingest on the card (``EmbeddingService(pipeline=True)``,
    ``IncrementalCore.begin_update`` / ``finish_update``): the serving
    configuration (``github-like``, dim 128, batch 64) over the resilience
    path's op list (the stream's first 16 blocks of 1024, 10% churn),
    through a ``pipeline=False`` twin first and then, with every count set
    to 0, through a pipelined service. Held: graph, store, cores, baseline
    and counters (``capture_state``, which lands the repair in flight)
    bit-equal to the twin's after every PIPE_EVERY-th block and at the end
    (reading them earlier would settle each block and hide the overlap);
    0 core mismatches against the peeling oracle; h-index launches on the
    path; every descent at most 1 + ceil(log2(max_sweeps)) host reads.
    Printed, for each service: ingest seconds (the ops and the final sync,
    the captures left out), the ``descend`` phase's seconds (pipelined: the
    host's enqueueing and the wait that was not overlapped), sweeps a
    descent, sweeps enqueued and host reads a descent, h-index launches,
    the host seconds in the descents' set-up, sweep enqueueing and reads
    (``_Descent.__init__`` / ``sweep`` / ``read``, a read waiting for the
    card); and the share of descents still running on the card when
    ``begin_update`` returned (a CUDA event recorded after the last
    enqueued sweep, queried at once; not held). Returns (launch counts,
    numbers)."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import datasets
    from repro_torch.kernels import hindex
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.serve import kcore_inc
    from repro_torch.serve.recovery import capture_state

    g = datasets.load("github-like", seed=0)
    host = {}  # host seconds by _Descent method, the running service's

    def timed(name, fn):
        def wrapped(*a, **kw):
            t, c = time.perf_counter(), time.process_time()
            try:
                return fn(*a, **kw)
            finally:
                host[name] = host.get(name, 0.0) + time.perf_counter() - t
                host[name + ".cpu"] = (host.get(name + ".cpu", 0.0)
                                       + time.process_time() - c)
        return wrapped

    def mallocs():
        st = torch.cuda.memory_stats()
        return st.get("segment.all.allocated", 0), st.get(
            "num_alloc_retries", 0)

    def run(pipeline, states):
        host.clear()
        t0 = time.perf_counter()
        svc, stream, _, _ = build_service(
            g, stream_frac=STREAM_FRAC, dim=128, batch=64,
            pipeline=pipeline, device="cuda")
        t_build = time.perf_counter() - t0
        inc = svc.cores
        reads, inflight = [], []
        read = inc._descend_read

        def counted_read(pending, **kw):
            out = read(pending, **kw)
            reads.append(pending["descent"].reads)
            return out
        inc._descend_read = counted_read
        begin = inc.begin_update

        def watched(*a, **kw):
            ticket = begin(*a, **kw)
            if not ticket.done:  # a descent left in flight
                ev = torch.cuda.Event()
                ev.record()
                inflight.append(not ev.query())
            return ticket
        inc.begin_update = watched
        ops = resilience_ops(np, stream)
        torch.cuda.synchronize()
        launches = hindex.launches
        seg0, retry0 = mallocs()
        t_ingest, n_blocks = 0.0, 0
        for i, op in enumerate(ops):
            t0 = time.perf_counter()
            _apply_op(svc, op)
            last = i + 1 == len(ops)
            if last:
                svc.sync()
            t_ingest += time.perf_counter() - t0
            n_blocks += op[0] == "retract"
            if last or (op[0] == "retract" and n_blocks % PIPE_EVERY == 0):
                states.append(capture_state(svc, 0))
        launches = hindex.launches - launches
        seg1, retry1 = mallocs()
        host_s = dict(host)
        oracle = core_numbers_host(svc.graph.snapshot())
        mismatches = int((svc.cores.core[: len(oracle)] != oracle).sum())
        d = max(inc.descends, 1)
        return svc, {
            "pipeline": pipeline, "build_s": t_build,
            "ingest_s": t_ingest,
            "descend_s": inc.phase_report().get(
                "descend", {"seconds": 0.0})["seconds"],
            "descends": inc.descends, "repeels": inc.repeels,
            "sweeps": inc.sweeps, "sweeps_per_descent": inc.sweeps / d,
            "enqueued_per_descent": inc.sweeps_enqueued / d,
            "reads_per_descent": inc.descent_reads / d,
            "max_reads_a_descent": max(reads, default=0),
            "h_index_launches": launches, "host_s": host_s,
            "cuda_mallocs": seg1 - seg0, "alloc_retries": retry1 - retry0,
            "us_per_enqueued_sweep": 1e6 * host_s.get("sweep", 0.0)
            / max(inc.sweeps_enqueued, 1),
            "us_per_read": 1e6 * host_s.get("read", 0.0)
            / max(inc.descent_reads, 1),
            "inflight_at_return": (sum(inflight) / len(inflight)
                                   if inflight else None),
            "dispatched": len(inflight), "mismatches": mismatches,
        }

    cls = kcore_inc._Descent
    methods = {k: getattr(cls, k) for k in ("__init__", "sweep", "read")}
    for k, fn in methods.items():
        setattr(cls, k, timed(k, fn))
    try:
        truth = []
        twin, serial = run(False, truth)
        del twin
        counters.reset()
        got = []
        svc, piped = run(True, got)
        counts = counters.read()
    finally:
        for k, fn in methods.items():
            setattr(cls, k, fn)
    bad = []
    for at, ((want, wman), (have, hman)) in enumerate(zip(truth, got)):
        keys = [k for k in sorted(set(want) | set(have))
                if k not in want or k not in have
                or not np.array_equal(want[k], have[k])]
        if keys or wman["stats"] != hman["stats"]:
            bad.append((at, keys, wman["stats"] == hman["stats"]))
    cap = 1 + math.ceil(math.log2(svc.cores.max_sweeps))
    out = {"serial": serial, "pipelined": piped,
           "compared": len(got), "launches": counts,
           "ingest_x": serial["ingest_s"] / max(piped["ingest_s"], 1e-9)}
    log("pipeline: " + json.dumps(out))
    log(f"pipeline: {RESIL_BLOCKS} blocks of {RESIL_BLOCK} (churn "
        f"{RESIL_CHURN}) pipelined in "
        f"{piped['ingest_s']:.2f} s (descend {piped['descend_s']:.3f} s "
        f"not overlapped) vs {serial['ingest_s']:.2f} s serial (descend "
        f"{serial['descend_s']:.3f} s); a descent: "
        f"{piped['sweeps_per_descent']:.2f} sweeps, "
        f"{piped['enqueued_per_descent']:.2f} enqueued, "
        f"{piped['reads_per_descent']:.2f} host reads (max "
        f"{piped['max_reads_a_descent']}; host us an enqueued sweep "
        f"{piped['us_per_enqueued_sweep']:.1f}, a read "
        f"{piped['us_per_read']:.1f}); h-index launches "
        f"{piped['h_index_launches']} vs {serial['h_index_launches']}; "
        f"descents still running at begin_update's return: "
        f"{piped['inflight_at_return']} of {piped['dispatched']}; states "
        f"compared {len(got)} times, differing: {bad}")
    expect(len(got) == len(truth) == RESIL_BLOCKS // PIPE_EVERY,
           f"pipeline: {len(got)} / {len(truth)} states captured")
    expect(bad == [], f"pipeline: state differs from the serial twin: {bad}")
    expect(piped["mismatches"] == serial["mismatches"] == 0,
           f"pipeline: core mismatches {piped['mismatches']} / "
           f"{serial['mismatches']}")
    expect(piped["max_reads_a_descent"] <= cap,
           f"pipeline: a descent took {piped['max_reads_a_descent']} host "
           f"reads, above 1 + ceil(log2(max_sweeps)) = {cap}")
    expect(counts["h_index"] > 0 and piped["dispatched"] > 0,
           "pipeline: no descent ran on the card")
    return counts, out


# ------------------------------------------------------------ offline ----


def offline_phase(torch, np, counters):
    """The port's quick github table on the card, row by row (the counts set
    to 0 before each row and read after it); returns (rows, counts summed
    over the rows, the split)."""
    from repro_torch.core import kcore
    from repro_torch.core.propagation import propagate
    from repro_torch.graph import datasets, splits
    from repro_torch.launch import tables

    t_phase = time.perf_counter()
    s, models = tables.table("github", quick=True)
    g = datasets.load(s.dataset)
    core = kcore.core_numbers_host(g)
    sp = splits.make_link_split(g, s.frac_removed, seed=0)
    log(f"offline: {s.dataset} split of {len(sp.pos_edges)} held-out edges, "
        f"degeneracy {kcore.degeneracy(core)}, dim {s.dim}, batch {s.batch}, "
        f"epochs {s.epochs} ({time.perf_counter() - t_phase:.1f} s to "
        f"generate and split)")
    rows, total = [], dict.fromkeys(counters.table, 0)
    for label, method, k0f in models:
        k0 = tables.k0_of(core, k0f)
        name = label if k0 is None else f"{k0}-core ({label})"
        counters.reset()
        out = tables.run_model(sp, method, k0, s, 0, "cuda")
        counts = counters.read()
        for key, n in counts.items():
            total[key] += n
        res = out["result"]
        steps = out["n_sgns_steps"]
        row = {"model": name, "f1": out["f1"], "f1_std": 0.0,
               "total": out["total"], "n_walks_run": out["n_walks_run"],
               "sgns_steps": steps, "final_loss": out["final_loss"],
               "sgns_steps_per_s": steps / out["times"]["embedding"],
               "launches": counts,
               **{k: v for k, v in out["times"].items() if k != "total"}}
        base = rows[0] if rows else row
        row["speedup"] = base["total"] / row["total"]
        row["drop"] = row["f1"] - base["f1"]
        log(tables.ROW_FMT.format(**row))
        log(f"  {name}: F1 {row['f1']:.4f}, n_walks_run {row['n_walks_run']}"
            f", n_sgns_steps {steps} ({row['sgns_steps_per_s']:.0f} steps/s)"
            f", final loss {row['final_loss']:.5f}, launches {counts}")
        want_f1, want_walks, want_steps = JAX_GITHUB_QUICK[name]
        expect(np.isfinite(res.embeddings).all()
               and math.isfinite(out["final_loss"]), f"{name}: NaN")
        expect((out["n_walks_run"], steps) == (want_walks, want_steps),
               f"{name}: walks/steps {out['n_walks_run']}/{steps} != the "
               f"JAX package's {want_walks}/{want_steps}")
        expect(abs(out["f1"] - want_f1) <= F1_BAND,
               f"{name}: F1 {out['f1']:.2f} is more than {F1_BAND} points "
               f"from the JAX package's {want_f1:.2f}")
        expect(counts["sgns_fwd"] == counts["sgns_bwd"] == steps,
               f"{name}: SGNS launches {counts['sgns_fwd']}/"
               f"{counts['sgns_bwd']} != {steps} steps")
        if k0 is not None:
            expect(counts["ell_mean"] > 0,
                   f"{name}: the ELL mean was not launched")
            host = propagate(sp.train_graph, res.core,
                             min(k0, res.degeneracy), res.embeddings,
                             n_iters=s.prop_iters, backend="scipy")
            err = float(np.abs(host - res.embeddings).max())
            row["prop_vs_scipy_max_abs"] = err
            log(f"  {name}: torch propagation vs scipy max abs diff {err:.2e}")
            expect(np.allclose(res.embeddings, host, rtol=1e-4, atol=1e-4),
                   f"{name}: torch propagation off scipy by {err}")
        rows.append(row)
    by = {r["model"]: r for r in rows}
    expect(by["CoreWalk"]["n_walks_run"] < by["DeepWalk"]["n_walks_run"]
           and by["CoreWalk"]["sgns_steps"] < by["DeepWalk"]["sgns_steps"],
           "CoreWalk did not shrink the corpus")
    n_steps = sum(r["sgns_steps"] for r in rows)
    expect(total["sgns_fwd"] + total["sgns_bwd"] == 2 * n_steps,
           f"SGNS launches {total} != 2 x {n_steps} steps")
    log(f"offline phase: {time.perf_counter() - t_phase:.1f} s, {n_steps} "
        f"SGNS steps; launches {total}")
    log("offline rows: " + json.dumps(rows))
    return rows, total, sp


def propagation_shapes(torch, np, ops, ref, F, sp):
    """The ELL mean at two of the k-core row's propagation calls on the
    split ``sp`` (``core/propagation.py``: one shell's ELL rows of the train
    graph against the (n + 1, dim) table; each call's shape is one shell's):
    the largest shell, and the largest shell that takes the row-split path.
    The table is seeded noise at the table's width."""
    from repro_torch.core import kcore
    from repro_torch.core.propagation import propagation_schedule
    from repro_torch.graph import datasets
    from repro_torch.kernels import ellmean
    from repro_torch.launch import tables

    s, models = tables.table("github", quick=True)
    k0f = next(f for _, _, f in models if f is not None)
    k0 = tables.k0_of(kcore.core_numbers_host(datasets.load(s.dataset)), k0f)
    g = sp.train_graph
    core = kcore.core_numbers_host(g)
    k0 = min(k0, kcore.degeneracy(core))
    nbr, _ = g.ell_arrays()
    core_ext = np.concatenate([core, [-1]])
    shells = [(int((core == k).sum()), k)
              for k in propagation_schedule(core, k0)]
    width = nbr.shape[1]
    paths = {k: ellmean.row_split(n, width, "cuda") for n, k in shells}
    log(f"propagation (k0 {k0}, L {width}, dim {s.dim}): shells (N, k) "
        f"{shells}; row-split path for k in "
        f"{sorted(k for k, r in paths.items() if r)}")
    picks = [max(shells)]
    split_shells = [x for x in shells if paths[x[1]]]
    if split_shells:
        picks.append(max(split_shells))
    gen = torch.Generator(device="cuda").manual_seed(17)
    table = torch.randn((g.n_nodes + 1, s.dim), generator=gen, device="cuda")
    recs = []
    for _, k in picks:
        rows = np.where(core == k)[0]
        idx = torch.tensor(nbr[rows], device="cuda")
        valid = torch.tensor((nbr[rows] != g.n_nodes)
                             & (core_ext[nbr[rows]] >= k), device="cuda")
        recs.append(check_ell(torch, ops, ref, F, idx, valid, table,
                              f"propagation shell {k}"))
    return recs


def step_profile(torch, sp):
    """Device time by kernel and the busy share of 100 SGNS steps (after 120
    unprofiled), on the CoreWalk corpus of the quick github table's split
    ``sp``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import kcore
    from repro_torch.core.corewalk import corewalk_plan
    from repro_torch.launch import tables
    from repro_torch.skipgram.corpus import build_corpus
    from repro_torch.skipgram.trainer import SGNSConfig, train_sgns

    s, _ = tables.table("github", quick=True)
    core = kcore.core_numbers_host(sp.train_graph)
    gen = torch.Generator(device="cuda").manual_seed(0)
    corpus = build_corpus(sp.train_graph.to_ell(device="cuda"),
                          corewalk_plan(core, s.n_walks), s.walk_length, gen)
    cfg = SGNSConfig(dim=s.dim, window=s.window, n_neg=s.n_neg,
                     batch=s.batch, seed=0)
    plain = train_sgns(corpus, cfg, steps=120)
    steps = 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = train_sgns(corpus, cfg, steps=steps)
    dev = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        n, us = dev.get(e.name, (0, 0.0))
        dev[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in dev.values()) / 1e3
    wall_ms = res.train_seconds * 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "steps": steps,
        "unprofiled_ms_per_step": plain.train_seconds * 1e3 / 120,
        "profiled_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches_per_step": sum(n for n, _ in dev.values()) / steps,
        "top_kernels": [{"name": k[:90], "calls": n,
                         "ms_per_step": us / 1e3 / steps}
                        for k, (n, us) in top],
    }
    if not dev:
        log("step profile: the profiler saw no device time (not measured)")
    log("step profile: " + json.dumps(out))
    return out


def rotation(torch, make, nbytes):
    """Enough independent input sets (from ``make``) that cycling through
    them streams more than twice the L2 per pass: every launch reads its
    inputs from device memory, as a training step finds them."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def time_rotating(torch, fn, sets, iters, timer=None, **kw):
    state = {"i": 0}

    def step():
        fn(*sets[state["i"] % len(sets)])
        state["i"] += 1
    return (timer or time_ms)(torch, step, iters, **kw)


def sgns_fp64(torch, c, x, n, dout):
    """The SGNS loss and gradients in float64, the formulas of the plain
    versions: the yardstick where fp32 sums of many negatives drift."""
    import torch.nn.functional as F

    c, x, n, g = (t.double() for t in (c, x, n, dout))
    pos = (c * x).sum(-1)
    negl = torch.einsum("bkd,bd->bk", n, c)
    loss = F.softplus(-pos) + F.softplus(negl).sum(-1)
    dpos = (torch.sigmoid(pos) - 1.0) * g
    dneg = torch.sigmoid(negl) * g[:, None]
    return loss, (dpos[:, None] * x + torch.einsum("bk,bkd->bd", dneg, n),
                  dpos[:, None] * c, dneg[:, :, None] * c[:, None, :])


def check_sgns(torch, ref, sgns, b, k, d, dtype, label, iters=20,
               fp64=False):
    """Both SGNS kernels against their plain versions at one shape; returns
    ``{"sgns_fwd": record, "sgns_bwd": record}``. With ``fp64`` (many
    negatives) the kernels are held to ``sgns_fp64`` within the tolerance,
    and to the plain versions within the tolerance x max(1, max|plain|):
    the plain version's fp32 sums over K terms drift by about 1e-6 x their
    magnitude (|dcenter| reaches about 80 at K = 2,048), the kernel's dc
    sum is compensated."""
    from repro_torch.kernels import cost

    tol = TOL_SGNS[str(dtype).split(".")[-1]]
    gen = torch.Generator(device="cuda").manual_seed(b + 31 * k + d)
    dt = getattr(torch, str(dtype).split(".")[-1])
    esize = torch.tensor([], dtype=dt).element_size()
    in_bytes = (2 * b * d + b * k * d) * esize

    def make():
        c, x = (torch.randn((b, d), generator=gen, device="cuda").mul_(0.3)
                .to(dt) for _ in range(2))
        n = torch.randn((b, k, d), generator=gen, device="cuda").mul_(0.3)
        return c, x, n.to(dt), torch.randn(b, generator=gen, device="cuda")

    sets = rotation(torch, make, in_bytes)
    c, x, n, dout = sets[0]
    loss = sgns.sgns_fwd_cuda(c, x, n)
    want = ref.sgns_loss_ref(c, x, n)
    grads = sgns.sgns_bwd_cuda(c, x, n, dout)
    want_g = ref.sgns_grads_ref(c, x, n, dout)
    torch.cuda.synchronize()
    what = ("loss", "dcenter", "dctx", "dneg")

    def atol(w):
        return tol * max(1.0, float(w.abs().max())) if fp64 else tol

    if fp64:
        exact = sgns_fp64(torch, c, x, n, dout)
        for got, w, name in zip((loss, *grads), (exact[0], *exact[1]),
                                what):
            e = float((got.double() - w).abs().max())
            expect(torch.allclose(got.double(), w, rtol=tol, atol=tol),
                   f"sgns {label}: {name} off the fp64 value by {e}")
    err_f = float((loss - want).abs().max())
    expect(torch.allclose(loss, want, rtol=tol, atol=atol(want)),
           f"sgns_fwd {label}: max abs err {err_f}")
    err_b = 0.0
    for got, w, name in zip(grads, want_g, what[1:]):
        expect(got.dtype == dt, f"sgns_bwd {label}: {name} is {got.dtype}")
        e = float((got.float() - w.float()).abs().max())
        err_b = max(err_b, e)
        expect(torch.allclose(got.float(), w.float(), rtol=tol,
                              atol=atol(w.float())),
               f"sgns_bwd {label}: {name} max abs err {e}")
    expect(torch.equal(sgns.sgns_fwd_cuda(c, x, n), loss),
           f"sgns_fwd {label}: a second call gave other bits")
    expect(all(torch.equal(a, g) for a, g in
               zip(sgns.sgns_bwd_cuda(c, x, n, dout), grads)),
           f"sgns_bwd {label}: a second call gave other bits")
    shape = f"B={b} K={k} D={d} {str(dt).split('.')[-1]}"
    fb_ms, fb_by = bound(*cost.sgns_fwd(c, n))
    bb_ms, bb_by = bound(*cost.sgns_bwd(c, n))
    recs = {
        "sgns_fwd": {
            "shape": shape, "max_abs_err": err_f,
            "ms": time_rotating(torch, lambda c, x, n, _: sgns.sgns_fwd_cuda(
                c, x, n), sets, iters),
            "loop_ms": time_rotating(torch, lambda c, x, n, _:
                                     sgns.sgns_fwd_cuda(c, x, n), sets,
                                     iters, loop_ms),
            "plain_ms": time_rotating(torch, lambda c, x, n, _:
                                      ref.sgns_loss_ref(c, x, n), sets,
                                      max(iters // 4, 3)),
            "library_ms": None, "bound_ms": fb_ms, "bound_by": fb_by,
        },
        "sgns_bwd": {
            "shape": shape, "max_abs_err": err_b,
            "ms": time_rotating(torch, sgns.sgns_bwd_cuda, sets, iters),
            "loop_ms": time_rotating(torch, sgns.sgns_bwd_cuda, sets, iters,
                                     loop_ms),
            "plain_ms": time_rotating(torch, ref.sgns_grads_ref, sets,
                                      max(iters // 4, 3)),
            "library_ms": None, "bound_ms": bb_ms, "bound_by": bb_by,
        },
    }
    for name, rec in recs.items():
        ratios(rec)
        log(f"{name} {label}: {rec}")
    return recs


# ------------------------------------------------------------- LM side ----


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _full_width(cfg, want) -> bool:
    got = {k: getattr(cfg, k) for k in want if k not in ("moe", "ssm")}
    if "moe" in want:
        got["moe"] = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert)
    if "ssm" in want:
        s = cfg.ssm
        got["ssm"] = (s.d_state, s.d_conv, s.expand, s.head_dim, s.n_groups,
                      s.chunk)
    return got == want


def lm_serve_phase(torch, np, counters, path):
    """An LM serving path (``LM_PATHS``) at its config's full width and
    depth on the card, through ``repro_torch.launch.serve`` (its flag
    parsing, its ``init_model`` from a seeded generator on the card, its
    continuous-batching loop): 12 requests in 8 slots, prompts of 1024, 64
    new tokens each. Returns (cfg, params, launch counts, the cache and
    next tokens right after the first swap)."""
    from repro_torch.launch import serve as lm
    from repro_torch.models.steps import make_prefill_step

    arch, want, per_step, _ = LM_PATHS[path]
    t0 = time.perf_counter()
    args, cfg, params, requests = lm.setup(lm_flags(arch))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    expect(_full_width(cfg, want), f"not {arch} at full width: {cfg}")
    log(f"{path}: {cfg.name} full width, {n_params / 1e9:.3f} B parameters "
        f"({n_bytes / 1e9:.2f} GB, init {t_init:.1f} s), {args.slots} "
        f"slots, {args.requests} requests, prompt {args.prompt_len}, "
        f"max_new {args.max_new}")
    state = {"bad": torch.zeros((), dtype=torch.bool, device=args.device)}

    def on_step(step, cache, logits):  # its time is not in decode_seconds
        state["bad"] |= ~torch.isfinite(logits).all()
        if step == SNAP_STEP:  # the first step after the swap: ragged
            state["snap"] = (_clone(cache), logits[:, -1].argmax(-1)[
                :, None].to(torch.int32))

    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    res = lm.serve(cfg, params, requests, slots=args.slots,
                   max_new=args.max_new, device=args.device, on_step=on_step)
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    steps = res.step_tokens.shape[0]
    log(f"{path} serve: {res.served} requests, {res.n_decoded} tokens in "
        f"{steps} decode steps; launches {counts}")
    expect(res.n_decoded == LM_DECODED and steps == LM_STEPS,
           f"n_decoded {res.n_decoded} != {LM_DECODED}")
    expect(counts["decode_attention"] == per_step * steps,
           f"flash_decode launches {counts['decode_attention']} != "
           f"{per_step} x {steps}")
    for name, n in counts.items():
        expect(name == "decode_attention" or n == 0,
               f"{name} launched {n} times on the {path} path")
    expect(not bool(state["bad"]), "NaN or inf in the decode logits")
    expect(0 <= int(res.step_tokens.min())
           and int(res.step_tokens.max()) < cfg.vocab_size,
           "a token outside [0, vocab)")
    expect(peak < torch.cuda.get_device_properties(0).total_memory,
           f"peak {peak} above the card's memory")
    # all rows start together, so rows 0-3 finish first and take requests
    # 8-11 in order: their rows hold those prompts' B = 1 prefill
    # (recomputed here): the KV cache's prompt positions, which no later
    # decode write reaches; the conv state, shifted by the one step before
    # the snapshot (its first d_conv - 2 positions are the prefill's last)
    expect(res.served == args.requests, f"served {res.served}")
    prefill = make_prefill_step(cfg, max_len=args.prompt_len + args.max_new)
    axes = lm.cache_batch_axes(cfg)
    snap = state["snap"][0]
    for b in range(args.requests - args.slots):
        _, row = prefill(params, {"tokens": torch.from_numpy(
            requests[args.slots + b][None]).to(args.device)})
        for key, ax in axes.items():
            if key in ("k", "v"):
                got = res.cache[key].select(ax, b).narrow(
                    ax, 0, args.prompt_len)
                ref_ = row[key].select(ax, 0).narrow(ax, 0, args.prompt_len)
            elif key.endswith("conv"):
                n = row[key].shape[ax + 1] - 1  # d_conv - 2
                got = snap[key].select(ax, b).narrow(ax, 0, n)
                ref_ = row[key].select(ax, 0).narrow(ax, 1, n)
            else:
                continue
            expect(torch.equal(got, ref_),
                   f"row {b}'s {key} cache lost its prefill")
        del row
    lens = res.cache["len"].tolist()
    s_max = args.prompt_len + args.max_new
    expect(max(lens) > s_max, f"no row ran past the cache's end: {lens}")
    swap_s = sum(res.swap_seconds)
    rec = {
        "arch": cfg.name, "params_b": n_params / 1e9,
        "param_gb": n_bytes / 1e9, "init_s": t_init,
        "n_decoded": res.n_decoded, "decode_steps": steps,
        "prefill_ms": res.prefill_seconds * 1e3,
        "prefill_tokens": args.slots * args.prompt_len,
        "swap_prefill_ms": [t * 1e3 for t in res.swap_seconds],
        "decode_s": res.decode_seconds,
        "decode_tokens_per_s": res.n_decoded / res.decode_seconds,
        "ms_per_step_with_swaps": res.decode_seconds * 1e3 / steps,
        "ms_per_step": (res.decode_seconds - swap_s) * 1e3 / steps,
        "peak_memory_gb": peak / 1e9, "final_lengths": lens,
        "flash_decode_launches": counts["decode_attention"],
    }
    log(f"{path} serve phase: " + json.dumps(rec))
    return cfg, params, counts, state["snap"]


def lm_decode_parity(torch, cfg, params, snap, keep_layers):
    """One decode step from the live cache ``snap`` (ragged lengths, four
    rows past the cache's end), with the kernel and with the plain version
    bound into ``models.attention`` for that call only. The caches are
    equal bit for bit except where the two steps' attention outputs reach:
    the K/V rows this step writes in layers (shared-block calls) 1 and up,
    which hold k, v projected from a hidden state that already carries the
    attention below, rounded differently in bf16, and the mamba states
    after the first attention (hybrid: groups 1 and up and the tail). Those
    and the logits must agree within 5e-2 x their largest magnitude. An MoE
    model's plain step takes the kernel step's expert selection (``Router``
    "replay"): a token whose k-th and (k+1)-th router probabilities nearly
    tie may pick another expert when the attention below it rounds
    differently, and that moves it by far more than the rounding; the
    selections of an unforced plain step are counted against the kernel's
    (reported, with the largest gap at which one flipped). Then the greedy
    tokens' agreement over 8 teacher-forced steps (reported). Returns the
    kernel's inputs at the attention calls ``keep_layers`` of the first
    step."""
    import functools

    from repro_torch.kernels import ops
    from repro_torch.models import attention as lm_attn
    from repro_torch.models.steps import make_decode_step

    decode = make_decode_step(cfg)
    cache0, tok = snap
    kernel = lm_attn.decode_attention
    plain = functools.partial(ops.decode_attention, impl="ref")
    seen = {"layer": 0, "inputs": {}}

    def record(q, k, v, lens, **kw):
        if seen["layer"] in keep_layers:
            seen["inputs"][seen["layer"]] = (q.clone(), k.clone(), v.clone(),
                                             lens.clone(), kw)
        seen["layer"] += 1
        return kernel(q, k, v, lens, **kw)

    def step(cache, tokens, attn):
        lm_attn.decode_attention = attn
        try:
            return decode(params, cache, tokens)
        finally:
            lm_attn.decode_attention = kernel

    moe = cfg.moe is not None
    null = contextlib.nullcontext
    routes = Router("record")
    ca, cb = _clone(cache0), _clone(cache0)
    with routes if moe else null():
        la, ca = step(ca, tok, record)
    routes.mode = "replay"
    with routes if moe else null():
        lb, cb = step(cb, tok, plain)
    if moe:
        routes.mode = "compare"
        with routes:
            step(_clone(cache0), tok, plain)
        log(f"{cfg.name}: an unforced plain step routes {routes.flips} of "
            f"{tok.shape[0] * cfg.n_layers} token-layers otherwise than the "
            f"kernel step, at router gaps up to {routes.flip_gap:.3g}")
    torch.cuda.synchronize()
    s_len = cache0["k"].shape[2]
    lens = cache0["len"].long()
    rows = (lens < s_len).nonzero().flatten()  # rows whose write lands
    at = lens[rows]
    kept = torch.ones(lens.shape[0], s_len, dtype=torch.bool,
                      device=lens.device)
    kept[rows, at] = False
    expect(torch.equal(ca["len"], cb["len"]), "lengths differ")
    diffs = {}
    for key in cache0:
        if key == "len":
            continue
        if key in ("cross_k", "cross_v"):  # decode never writes them
            expect(torch.equal(ca[key], cache0[key])
                   and torch.equal(cb[key], cache0[key]),
                   f"cache {key}: a decode step changed it")
            continue
        if key in ("k", "v"):
            expect(torch.equal(ca[key][:, kept], cb[key][:, kept])
                   and torch.equal(ca[key][0], cb[key][0]),
                   f"cache {key}: the kernel's and the plain step's differ "
                   "outside the rows written after the first attention")
            new_a = ca[key][1:, rows, at].float()
            new_b = cb[key][1:, rows, at].float()
        else:  # mamba states: (groups, ...) or the tail's, all after
            if key in ("conv", "ssd"):
                expect(torch.equal(ca[key][0], cb[key][0]),
                       f"cache {key}: the first group's state differs")
                new_a, new_b = ca[key][1:].float(), cb[key][1:].float()
            else:
                new_a, new_b = ca[key].float(), cb[key].float()
        err = float((new_a - new_b).abs().max())
        big = float(new_b.abs().max())
        diffs[key] = (err, big)
        expect(err <= LM_LOGIT_TOL * big,
               f"cache {key}: the kernel's and the plain step's differ by "
               f"{err} against max {big}")
    err = float((la - lb).abs().max())
    scale = float(lb.abs().max())
    where = ", ".join(f"{k} {e:.4g} of {m:.4g}" for k, (e, m) in
                      diffs.items())
    log(f"{cfg.name} decode parity (full width, lengths "
        f"{cache0['len'].tolist()}): caches equal bit for bit but where the "
        f"first attention output reaches, there max abs diff {where}; "
        f"logits max abs err {err:.4g} against max|logit| {scale:.4g} "
        f"(limit {LM_LOGIT_TOL} x)")
    expect(err <= LM_LOGIT_TOL * scale, f"logits differ by {err}")
    del ca, cb
    ca, cb = _clone(cache0), _clone(cache0)
    agree = 0
    for _ in range(8):
        la, ca = step(ca, tok, kernel)
        lb, cb = step(cb, tok, plain)
        ta, tb = la[:, -1].argmax(-1), lb[:, -1].argmax(-1)
        agree += int((ta == tb).sum())
        tok = ta[:, None].to(torch.int32)
    share = agree / (8 * tok.shape[0])
    log(f"{cfg.name} greedy agreement kernel vs plain over 8 teacher-forced "
        f"steps: {share:.4f}")
    return seen["inputs"]


class Router:
    """While bound (``with``), wraps ``models.moe._top_k_gates`` (every MoE
    layer's expert selection) in one of four modes: "margin" keeps the
    smallest gap between the k-th and (k+1)-th largest router probability
    of any token; "record" keeps each call's selection; "replay" routes each
    call as the recorded one did (the gates renormalised over the recorded
    experts); "compare" counts the tokens whose selection differs from the
    recorded one, with the largest such gap among them. A routing flip at
    a near-tie can then be told from a fault."""

    def __init__(self, mode="margin"):
        from repro_torch.models import moe

        self.moe, self.mode = moe, mode
        self.smallest, self.calls, self.i = math.inf, [], 0
        self.flips, self.flip_gap = 0, 0.0

    def __enter__(self):
        self.orig, self.i = self.moe._top_k_gates, 0
        self.moe._top_k_gates = self
        return self

    def __exit__(self, *exc):
        self.moe._top_k_gates = self.orig

    def __call__(self, probs, k):
        gates = self.orig(probs, k)
        top = probs.topk(k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]
        if self.mode == "margin":
            self.smallest = min(self.smallest, float(gap.min()))
        elif self.mode == "record":
            self.calls.append(gates > 0)
        else:
            sel = self.calls[self.i]
            self.i += 1
            if self.mode == "replay":
                gates = _gates_over(sel, probs)
            else:
                flipped = ((gates > 0) != sel).any(-1)
                self.flips += int(flipped.sum())
                if bool(flipped.any()):
                    self.flip_gap = max(self.flip_gap,
                                        float(gap[flipped].max()))
        return gates


def _gates_over(sel, probs):
    """Gates over the experts ``sel`` picks, normalised as the model's."""
    gates = probs * sel
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


LM_REFERENCES = {  # path -> (arch, reduced() overrides)
    "lm": ("qwen3-4b", dict(n_heads=8, n_kv_heads=2)),  # G = 4
    "moe": ("moonshot-v1-16b-a3b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-7b", {}),
}


def lm_reference_phase(torch, np, path):
    """The path's model at the reduced preset (fp32) served on the card and
    on the CPU with the same weights and schedule (2 slots, 5 requests of
    8 tokens, 4 new each): token streams equal, logits within 1e-4; for
    the MoE, the smallest router margin of the CPU run (reported)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm
    from repro_torch.models.transformer import init_model

    arch, over = LM_REFERENCES[path]
    cfg = get_config(arch).reduced(**over)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    requests = lm.make_requests(cfg.vocab_size, 5, 8, 0)
    out = {}
    margins = Router("margin")
    for dev in ("cuda", "cpu"):
        logs = []
        with margins if dev == "cpu" else contextlib.nullcontext():
            res = lm.serve(cfg, _tree_to(params, dev), requests, slots=2,
                           max_new=4, device=dev,
                           on_step=lambda s, c, lg: logs.append(lg.cpu()))
        out[dev] = (res, torch.stack(logs))
    (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
    err = float((lg - lc).abs().max())
    expect(rg.n_decoded == rc.n_decoded == 24, "n_decoded differs")
    expect(np.array_equal(rg.step_tokens, rc.step_tokens)
           and rg.streams == rc.streams, f"{arch}: token streams differ")
    expect(err <= 1e-4, f"{arch}: logits differ from the CPU's by {err}")
    margin = (f"; smallest router margin (k-th - (k+1)-th prob) "
              f"{margins.smallest:.3g}" if cfg.moe is not None else "")
    log(f"lm reference: reduced {arch} ({cfg.family}) served on cuda == "
        f"cpu: {rg.step_tokens.shape[0]} steps, token streams equal, logits "
        f"max abs diff {err:.2e}{margin}")


def mrope_positions(torch, rows, grid, text, dev):
    """(3, rows, grid^2 + text) int32 M-RoPE positions: a grid x grid patch
    grid (t = 0, h = i // grid, w = i % grid), then text from ``grid`` on
    all three streams."""
    i = torch.arange(grid * grid, device=dev)
    patch = torch.stack([torch.zeros_like(i), i // grid, i % grid])
    txt = (grid + torch.arange(text, device=dev)).expand(3, text)
    pos = torch.cat([patch, txt], 1).to(torch.int32)
    return pos[:, None].expand(3, rows, pos.shape[1]).contiguous()


def step_batch(torch, cfg, rows, prompt, side, dev, seed=0):
    """A seeded prefill batch: ``tokens`` (rows, prompt) in [2, V); encdec:
    ``src_embeds`` (rows, side, d) normal x 0.02; vision: the first side^2
    slots' ``vision_embeds`` normal x 0.02 and their M-RoPE ``positions``
    (a side x side grid, then the text)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (rows, prompt),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    dt, d = cfg.cdtype(), cfg.d_model
    if cfg.family == "encdec":
        batch["src_embeds"] = (torch.randn((rows, side, d), generator=gen,
                                           device=dev) * 0.02).to(dt)
    else:
        batch["vision_embeds"] = (torch.randn((rows, side * side, d),
                                              generator=gen, device=dev)
                                  * 0.02).to(dt)
        batch["positions"] = mrope_positions(torch, rows, side,
                                             prompt - side * side, dev)
    return batch


def step_side(cfg, path) -> int:
    """encdec: the frames (S / 4, at least 8); vl: the patch grid's side."""
    if path == "encdec":
        return max(STEP_PROMPT[path] // 4, 8)
    return math.isqrt(cfg.n_vision_patches)


def step_phase(torch, np, counters, path):
    """A ``STEP_PATHS`` path at its config's full width and depth on the
    card: ``init_model`` from a seeded generator on the card, then
    ``make_prefill_step`` on 8 rows and 64 greedy ``make_decode_step``
    steps, the counts set to 0 just before the prefill and read after the
    last step. Held: 512 tokens decoded, exactly the path's flash-decode
    launches a step (encdec: a self- and a cross-attention call a layer),
    no NaN or inf in any logits, tokens in [0, V), ``len`` = prompt + 64
    at the end, the cross K/V untouched by decoding, peak memory below the
    card's. Returns (cfg, params, launch counts, the cache and next tokens
    after step 32)."""
    from repro_torch.configs import get_config
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_model

    arch, want, per_step, _ = STEP_PATHS[path]
    cfg = get_config(arch)
    expect(_full_width(cfg, want), f"not {arch} at full width: {cfg}")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompt, side = STEP_PROMPT[path], step_side(cfg, path)
    batch = step_batch(torch, cfg, STEP_ROWS, prompt, side, "cuda")
    log(f"{path}: {cfg.name} ({cfg.family}) full width, "
        f"{n_params / 1e9:.3f} B parameters ({n_bytes / 1e9:.2f} GB, init "
        f"{t_init:.1f} s), {STEP_ROWS} rows, prompt {prompt}"
        + (f" after {side} frames" if path == "encdec" else
           f" ({side} x {side} patches first)") + f", {STEP_NEW} new")
    prefill = make_prefill_step(cfg, max_len=prompt + STEP_NEW)
    decode = make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    bad = ~torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks, t_decode = [], 0.0
    for part in (range(STEP_SNAP), range(STEP_SNAP, STEP_NEW)):
        t0 = time.perf_counter()
        for _ in part:
            logits, cache = decode(params, cache, tok)
            bad |= ~torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
        torch.cuda.synchronize()
        t_decode += time.perf_counter() - t0
        if part.stop == STEP_SNAP:
            snap = (_clone(cache), tok.clone())
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()  # again, warm: the first call loads kernels
    prefill(params, batch)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    toks = torch.cat(toks, 1)
    n_decoded = toks.numel()
    log(f"{path}: {n_decoded} tokens in {STEP_NEW} decode steps; launches "
        f"{counts}")
    expect(n_decoded == STEP_ROWS * STEP_NEW,
           f"n_decoded {n_decoded} != {STEP_ROWS * STEP_NEW}")
    expect(counts["decode_attention"] == per_step * STEP_NEW,
           f"flash_decode launches {counts['decode_attention']} != "
           f"{per_step} x {STEP_NEW}")
    for name, n in counts.items():
        expect(name == "decode_attention" or n == 0,
               f"{name} launched {n} times on the {path} path")
    expect(not bool(bad), "NaN or inf in the logits")
    expect(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
           "a token outside [0, vocab)")
    lens = cache["len"].tolist()
    expect(lens == [prompt + STEP_NEW] * STEP_ROWS, f"lengths {lens}")
    for key in ("cross_k", "cross_v"):
        if key in cache:
            expect(torch.equal(cache[key], snap[0][key]),
                   f"decoding changed {key}")
    expect(peak < torch.cuda.get_device_properties(0).total_memory,
           f"peak {peak} above the card's memory")
    rec = {
        "arch": cfg.name, "params_b": n_params / 1e9,
        "param_gb": n_bytes / 1e9, "init_s": t_init,
        "n_decoded": n_decoded, "decode_steps": STEP_NEW,
        "prefill_ms": t_prefill * 1e3, "prefill_warm_ms": t_warm * 1e3,
        "prefill_tokens": STEP_ROWS * prompt,
        "decode_s": t_decode, "decode_tokens_per_s": n_decoded / t_decode,
        "ms_per_step": t_decode * 1e3 / STEP_NEW,
        "peak_memory_gb": peak / 1e9, "final_lengths": lens,
        "flash_decode_launches": counts["decode_attention"],
    }
    log(f"{path} step phase: " + json.dumps(rec))
    return cfg, params, counts, snap


def step_calls(path):
    """{call index within a decode step: (label, layer)} of the kernel
    inputs the path's parity phase keeps (encdec calls the kernel twice a
    layer: self at 2 i, cross at 2 i + 1)."""
    keep = STEP_PATHS[path][3]
    if path != "encdec":
        return {lay: (f"{path} self", lay) for lay in keep["self"]}
    out = {2 * lay: (f"{path} self", lay) for lay in keep["self"]}
    out.update({2 * lay + 1: (f"{path} cross", lay)
                for lay in keep["cross"]})
    return out


def step_reference_phase(torch, np, path):
    """The path's model at the reduced preset (fp32; qwen2-vl at G = 7) on
    the card and on the CPU with the same weights and inputs (2 rows, a
    prefill, 8 greedy decode steps): tokens equal, logits within 1e-4, the
    kernel launched per_step x 8 times on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_model

    arch = STEP_PATHS[path][0]
    over, prompt, side = STEP_REFERENCES[path]
    cfg = get_config(arch).reduced(**over)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = step_batch(torch, cfg, 2, prompt, side, "cpu", seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        p = _tree_to(params, dev)
        logits, cache = make_prefill_step(cfg, max_len=prompt + 8)(
            p, _tree_to(batch, dev))
        decode = make_decode_step(cfg)
        logs, toks = [logits.cpu()], []
        before = flash_decode.launches
        for _ in range(8):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok.cpu())
            logits, cache = decode(p, cache, tok)
            logs.append(logits.cpu())
        if dev == "cuda":
            per = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
            expect(flash_decode.launches - before == 8 * per,
                   f"reduced {arch}: {flash_decode.launches - before} "
                   f"launches, not 8 x {per}")
        out[dev] = (torch.cat(toks, 1), torch.stack(logs))
    (tg, lg), (tc, lc) = out["cuda"], out["cpu"]
    err = float((lg - lc).abs().max())
    expect(torch.equal(tg, tc), f"reduced {arch}: tokens differ")
    expect(err <= 1e-4, f"reduced {arch}: logits differ from the CPU's by "
           f"{err}")
    log(f"step reference: reduced {arch} ({cfg.family}, G = "
        f"{cfg.q_per_kv}) on cuda == cpu: prefill + 8 greedy steps, tokens "
        f"equal, logits max abs diff {err:.2e}")


GEMM_WORDS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk", "nvjet")


def train_class(name: str) -> str:
    """A training step's kernel by what it does: bf16 or fp32 products
    (cuBLAS / CUTLASS names carry the type: "f32", "sgemm"), copies and
    casts, reductions, the rest."""
    low = name.lower()
    if any(w in low for w in GEMM_WORDS):
        return "gemm fp32" if ("f32" in low or "sgemm" in low) else "gemm bf16"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copies/casts"
    if "reduce" in low:
        return "reductions"
    return "elementwise/other"


def device_time(prof) -> dict:
    """{kernel name: (launches, device us)} from a ``torch.profiler``
    window."""
    dev = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        n, us = dev.get(e.name, (0, 0.0))
        dev[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return dev


def lm_profile(torch, cfg, params, snap, steps=LM_PROFILE_STEPS):
    """Device time by kernel class over ``steps`` decode steps from the live
    cache (after as many unprofiled ones), launches per step and the busy
    share (reported, not held)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.steps import make_decode_step

    decode = make_decode_step(cfg)
    cache, tok = _clone(snap[0]), snap[1]

    def run():
        nonlocal cache
        for _ in range(steps):
            _, cache = decode(params, cache, tok)
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, classes = device_time(prof), {}
    for name, (n, us) in dev.items():
        low = name.lower()
        if "flash_decode" in low:
            cls = "flash_decode"
        elif any(w in low for w in GEMM_WORDS):
            cls = "gemm/gemv"
        elif "memcpy" in low or "memset" in low:
            cls = "copies"
        else:
            cls = "elementwise/other"
        cn, cus = classes.get(cls, (0, 0.0))
        classes[cls] = (cn + n, cus + us)
    busy_ms = sum(us for _, us in dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "steps": steps, "unprofiled_ms_per_step": plain_ms,
        "profiled_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches_per_step": sum(n for n, _ in dev.values()) / steps,
        "by_class_ms_per_step": {c: us / 1e3 / steps
                                 for c, (_, us) in classes.items()},
        "launches_by_class_per_step": {c: n / steps
                                       for c, (n, _) in classes.items()},
        "top_kernels": [{"name": k[:90], "calls": n,
                         "ms_per_step": us / 1e3 / steps}
                        for k, (n, us) in top],
    }
    if not dev:
        log("lm profile: the profiler saw no device time (not measured)")
    log("lm profile: " + json.dumps(out))
    return out


# ---------------------------------------------------------- LM training ----


class TrainMeter:
    """Wraps a train step (``wrap``): synchronises around every call and
    keeps its seconds and its scalar metrics, notes every param leaf's size
    at the first call, and runs the calls ``window`` = (first, end) under
    ``torch.profiler``, the device's activity alone (a step of mamba2-2.7b's
    64 layers launches ~27,000 kernels; host events would multiply the
    trace to read back)."""

    def __init__(self, torch, window):
        self.torch, self.window = torch, window
        self.times, self.metrics, self.seen = [], [], {}

    def wrap(self, step):
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.train.tree import leaf_paths

        torch, seen = self.torch, self.seen

        def run(params, state, batch):
            i = len(self.times)
            if i == 0:
                seen["numel"] = {n: t.numel() for n, t in leaf_paths(params)}
                seen["dtype"] = str(params["embed"]["embedding"].dtype)
            if i == self.window[0]:
                seen["prof"] = profile(activities=[ProfilerActivity.CUDA])
                seen["prof"].__enter__()
                seen["t_prof"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, state, batch)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            if i == self.window[1] - 1:
                seen["prof"].__exit__(None, None, None)
                seen["wall"] = time.perf_counter() - seen["t_prof"]
            self.metrics.append({k: float(v) for k, v in out[2].items()})
            return out

        return run

    def report(self, np, tokens, flops) -> dict:
        """Step ms (the median of the unprofiled steps after the first two),
        tokens/s, model FLOP/s and its share of the bf16 dense peak, and the
        profile window's device time: busy ms a step and its share of the
        window's wall time, launches and ms a step by ``train_class``, the
        top 10 kernels."""
        p0, p1 = self.window
        step_s = float(np.median(self.times[2:p0]))
        dev = device_time(self.seen["prof"])
        n_prof, wall = p1 - p0, self.seen["wall"]
        busy_ms = sum(us for _, us in dev.values()) / 1e3 / n_prof
        classes = {}
        for name, (n, us) in dev.items():
            cn, cus = classes.get(train_class(name), (0, 0.0))
            classes[train_class(name)] = (cn + n, cus + us)
        top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:10]
        if not dev:
            log("train profile: the profiler saw no device time (not "
                "measured)")
        return {
            "step_ms_each": [t * 1e3 for t in self.times],
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "model_tflop_per_step": flops / 1e12,
            "model_tflop_per_s": flops / step_s / 1e12,
            "bf16_peak_share": flops / step_s / PEAK_BF16,
            "profile_steps": list(range(p0, p1)),
            "profiled_ms_per_step": wall * 1e3 / n_prof,
            "device_busy_ms_per_step": busy_ms if dev else None,
            "device_busy_share": busy_ms * n_prof / (wall * 1e3)
            if dev else None,
            "busy_of_unprofiled_step": busy_ms / (step_s * 1e3)
            if dev else None,
            "launches_per_step": sum(n for n, _ in dev.values()) / n_prof,
            "by_class_ms_per_step": {c: us / 1e3 / n_prof
                                     for c, (_, us) in classes.items()},
            "launches_by_class_per_step": {c: n / n_prof
                                           for c, (n, _) in classes.items()},
            "top_kernels": [{"name": k[:90], "calls": n,
                             "ms_per_step": us / 1e3 / n_prof}
                            for k, (n, us) in top],
        }


def train_flops(cfg, numel, rows, seq, frames=0) -> float:
    """Model FLOPs of one training step of ``rows`` x ``seq`` tokens: 6 x
    the params each token passes through (every leaf of ``numel``, {leaf
    path: size}; the MoE's experts at top-k of E; the encoder-decoder's
    encoder once a frame, ``frames`` a row) plus PaLM's attention term, 12
    L H Dh x the positions attended, a token of each attention layer (the
    hybrid's shared-block calls, its window; encdec's cross-attention over
    the frames and the encoder's over its own); the SSD's chunked products
    are not counted."""
    n = sum(numel.values())
    if cfg.moe is not None:
        m = cfg.moe
        n -= sum(v for k, v in numel.items() if "/moe/w_" in k) \
            * (m.n_experts - m.top_k) / m.n_experts
    enc = sum(v for k, v in numel.items()
              if k.startswith(("encoder/", "enc_norm/")))
    tokens, hd = rows * seq, cfg.n_heads * cfg.head_dim
    flops = 6 * ((n - enc) * tokens + enc * rows * frames)
    if cfg.family in ("dense", "moe", "encdec"):
        flops += 12 * cfg.n_layers * hd * (seq + frames) * tokens
    if cfg.family == "encdec":
        flops += 12 * cfg.n_encoder_layers * hd * frames * rows * frames
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_every
        flops += 12 * groups * hd * min(seq, cfg.sliding_window or seq) \
            * tokens
    return flops


def hold_training(np, label, losses, steps, vocab, peak, total, counts):
    """The training checks: ``steps`` finite losses, the first within 1.5
    nats of ln V, the mean of the last five below the mean of the first
    five (the JAX package's own check), peak memory below the card's, and
    no kernel of the port launched (training runs none)."""
    expect(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"{label}: losses {losses}")
    expect(abs(losses[0] - math.log(vocab)) < 1.5,
           f"{label}: first loss {losses[0]} is not near ln V = "
           f"{math.log(vocab):.2f}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    expect(last < first, f"{label}: losses do not fall ({first} -> {last})")
    expect(peak < total, f"{label}: peak {peak} B over the card's {total}")
    for name, n in counts.items():
        expect(n == 0, f"{name} launched {n} times on the {label} path")
    return float(first), float(last)


def train_phase(torch, np, counters):
    """LM training at qwen3-4b's full width and depth on the card, through
    ``repro_torch.launch.train.main`` (``TRAIN_FLAGS``: bf16 params, AdamW
    with fp32 moments, 20 steps of 4 x 1024 tokens, the weights from a
    seeded generator on the card; no checkpoint here: ``checkpoint_full``
    writes one of seamless-m4t-large-v2). A ``TrainMeter`` bound into the
    launcher's ``make_train_step`` synchronises around every step and runs
    steps ``TRAIN_PROFILE`` under ``torch.profiler``. Held
    (``hold_training``): 20 finite losses, the first within 1.5 nats of ln
    V, the mean of the last five below the mean of the first five, peak
    memory below the card's, and no kernel of the port launched. Printed:
    step ms (median of the unprofiled steps after the first two), tokens/s,
    model FLOP/s (``train_flops``: 6 N per token plus PaLM's attention term
    12 L H Dh S, against the bf16 dense peak), peak GB, device-busy ms per
    step. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lm_train

    cfg = get_config("qwen3-4b")
    make = lm_train.make_train_step
    meter = TrainMeter(torch, TRAIN_PROFILE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    lm_train.make_train_step = lambda *a, **kw: meter.wrap(make(*a, **kw))
    try:
        losses = lm_train.main(TRAIN_FLAGS)
    finally:
        lm_train.make_train_step = make
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    n_steps, B, S = (int(TRAIN_FLAGS[TRAIN_FLAGS.index(f) + 1])
                     for f in ("--steps", "--batch", "--seq"))
    first, last = hold_training(np, "train", losses, n_steps,
                                cfg.vocab_size, peak, total, counts)
    numel = meter.seen["numel"]
    rec = {
        "arch": cfg.name, "params": sum(numel.values()),
        "dtype": meter.seen["dtype"], "steps": n_steps, "batch": B,
        "seq": S, "losses_first_last": [losses[0], losses[-1]],
        "mean_first5_last5": [first, last],
        **meter.report(np, B * S, train_flops(cfg, numel, B, S)),
        "peak_allocated_gb": peak / 1e9, "card_gb": total / 1e9,
    }
    log("train phase: " + json.dumps(rec))
    return counts


def held_entries(torch, optimizer, state, grads, count):
    """Per param leaf, (mask, unmoved) bool tensors of a reference step's
    state after ``count`` steps. mask: where the update is insensitive to
    the rounding of the gradient it divides. AdamW's m_hat / (sqrt(v_hat)
    + eps) is about sign(g) where sqrt(v_hat) >> eps and turns a near-eps
    gradient's rounding into a step of up to the rate: sqrt(v_hat) > 100
    eps. Adafactor, the analogous mask (no looser): an unfactored leaf's
    g / sqrt(v), v = beta v + (1 - beta)(g^2 + eps), has sqrt(eps) = 1e-15
    where Adam has eps, so sqrt(v) > 100 sqrt(eps); a factored leaf divides
    by sqrt(r_i c_j / mean(r)), its moments built of the same g^2 + eps:
    sqrt(r_i c_j / mean(r)) > 100 sqrt(eps). unmoved: where the update is
    exactly 0 (AdamW: mu = 0, every gradient so far 0; adafactor: this
    step's gradient 0), whose params must not move at all."""
    from repro_torch.train.tree import leaves, leaves_up_to

    if optimizer == "adamw":
        c2 = 1 - 0.999 ** count  # adamw's default b2
        return ([torch.sqrt(v / c2) > 100 * 1e-8 for v in leaves(state[0].nu)],
                [m == 0 for m in leaves(state[0].mu)])
    floor, mask = 100 * 1e-15, []
    for vr, vc in zip(leaves(state.vr), leaves_up_to(state.vr, state.vc)):
        if isinstance(vc, tuple):
            mask.append(torch.sqrt(vr) > floor)
            continue
        r = vr / vr.mean(-1, keepdim=True).clamp_min(1e-30)
        mask.append(torch.sqrt(r[..., :, None] * vc[..., None, :]) > floor)
    return mask, [g == 0 for g in leaves(grads)]


def step_card_vs_cpu(torch, cfg, batch, sched, label, dev="cuda"):
    """One step of ``make_train_step`` with the config's optimizer under
    ``sched``, fp32 (TF32 off), on the card and on the CPU from the same
    params (one CPU generator, seed 0, copied to both) on the same batch
    (CPU tensors). Held (``TOL_TRAIN_*``): every metric (loss, xent,
    grad_norm, the MoE's aux losses) within 1e-5 relative; the optimizer's
    moments within 1e-4 x their leaf's max |value|; the params bit-equal
    where the update is exactly 0 and within 1e-3 x the rate on
    ``held_entries``' mask and there (at least ``TRAIN_MASK_SHARE`` of each
    leaf), within 2 x the rate everywhere, and within 1e-3 x their leaf's
    max |value| (a leaf that starts at 0, whose max |value| after a step
    is about the rate, on the mask: elsewhere it is held to 2 x the
    rate)."""
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.train import optim
    from repro_torch.train.tree import leaf_paths, leaves

    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    # leaves that start at 0 (zamba2's LoRA B): their magnitude after one
    # step is the step itself, so their max |value| bound reads the mask
    zero = [bool((t == 0).all()) for t in leaves(params)]
    out = {}
    for where in (dev, "cpu"):  # the CPU's step updates ``params`` itself
        got = {}

        def keep(g):  # the gradients the optimizer receives, unchanged
            got["grads"] = g
            return g

        p = _tree_to(params, where)
        opt = optim.make_optimizer(cfg.optimizer, sched)
        step = make_train_step(cfg, opt, grad_transform=keep)
        tb = {k: v.to(where) for k, v in batch.items()}
        t0 = time.perf_counter()
        p, state, m = step(p, opt.init(p), tb)
        metrics = {k: float(v) for k, v in m.items()}
        out[where] = (p, state, metrics, got.pop("grads"),
                      time.perf_counter() - t0)
    (pg, sg, mg, _, tg), (pc, sc, mc, gc, tc) = out[dev], out["cpu"]
    lr = sched(0)
    expect(set(mg) == set(mc), f"{label}: metrics {sorted(mg)} / "
           f"{sorted(mc)}")
    met = max((abs(mg[k] - mc[k]) / abs(mc[k]), k) for k in mc)
    mom = (0.0, "")
    for (name, a), (_, b) in zip(leaf_paths(sg), leaf_paths(sc)):
        if isinstance(a, int):
            expect(a == b, f"{label}: {name} is {a} on the card, {b} on "
                   "the CPU")
            continue
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
        mom = max(mom, (err, name))  # a leaf of zeros (LoRA A's mu) gives 0
    mask, unmoved = held_entries(torch, cfg.optimizer, sc, gc, 1)
    ok_err, all_err, share = (0.0, ""), (0.0, ""), (1.0, "")
    rel, still = (0.0, ""), 0  # the bound against each leaf's own max too
    for (name, a), b, ok, z, z0 in zip(leaf_paths(pg), leaves(pc), mask,
                                       unmoved, zero):
        d = (a.cpu() - b).abs()
        expect(bool((d[z] == 0).all()), f"{label}: {name} moved where its "
               "update is 0")
        still += int(z.sum())
        ok = ok | z
        rel = max(rel, (float((d[ok] if z0 else d).max())
                        / max(float(b.abs().max()), 1e-30), name))
        share = min(share, (float(ok.float().mean()), name))
        ok_err = max(ok_err, (float(d[ok].max()) / lr, name))
        all_err = max(all_err, (float(d.max()) / lr, name))
    log(f"train reference: {label}, one {cfg.optimizer} step at rate "
        f"{lr:.6g}: loss {mg['loss']!r} (card) / {mc['loss']!r} (CPU), "
        f"metrics within {met[0]:.3g} rel ({met[1]}); moments within "
        f"{mom[0]:.3g} x max|value| ({mom[1]}); params within "
        f"{ok_err[0]:.3g} x the rate on the mask and the {still} entries "
        f"whose update is 0 (bit-equal there; that covers at least "
        f"{share[0]:.4f} of a leaf, {share[1]}), {all_err[0]:.3g} x "
        f"everywhere ({all_err[1]}), {rel[0]:.3g} x max|value| ({rel[1]}); "
        f"{tg:.2f} s on the card (first call), {tc:.2f} s on the CPU")
    expect(met[0] <= TOL_TRAIN_METRIC, f"{label}: {met[1]} differs")
    expect(mom[0] <= TOL_TRAIN_MOMENT, f"{label}: moment {mom[1]} differs "
           f"by {mom[0]} x its max |value|")
    expect(share[0] > TRAIN_MASK_SHARE, f"{label}: the mask covers only "
           f"{share[0]} of {share[1]}")
    expect(ok_err[0] <= TOL_TRAIN_PARAM[0] and all_err[0] <= TOL_TRAIN_PARAM[1],
           f"{label}: params differ by {ok_err} / {all_err} x the rate")
    expect(rel[0] <= 1e-3, f"{label}: {rel[1]} differs by {rel[0]} x its "
           "max |value|")


def train_reference_phase(torch, np, dev="cuda"):
    """qwen3-4b's widths at 2 layers, fp32, one AdamW step on 1 x 256
    tokens at the launcher's schedule, card against CPU
    (``step_card_vs_cpu``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train import optim

    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    batch = SyntheticLMData(cfg.vocab_size, 1, 256, seed=0).batch_at(0)
    step_card_vs_cpu(torch, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                     optim.warmup_cosine(3e-4, 10, 20),
                     "qwen3-4b widths, 2 layers, fp32, 1 x 256 tokens", dev)


def train_reduced_phase(torch, np, dev="cuda"):
    """The launcher at the reduced preset on the card: 8 steps with a
    checkpoint every 4, resumed to 12, against an uninterrupted 12-step run
    (the losses of steps 8-11 within 1e-6 relative; whether their bits
    repeat is printed; ``metrics.jsonl`` holds steps 0-11; the resume's
    restore, into the tensors just built, grows the card's allocation by at
    most one leaf, and by how much is printed); 6 steps with
    ``--compress-grads`` (the last loss below the first); 4 with
    ``--accum 2`` (finite losses)."""
    import shutil
    import tempfile

    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch import train as lm_train
    from repro_torch.train.tree import leaves

    base = ["--arch", "qwen3-4b", "--preset", "reduced", "--batch", "2",
            "--seq", "32", "--device", dev]
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_", dir=build_dir)
    restore, seen = CheckpointManager.restore, {}

    def measured(self, step, target):  # the launcher's resume
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = restore(self, step, target)
        torch.cuda.synchronize()
        sizes = [t.numel() * t.element_size() for t in leaves(target)
                 if isinstance(t, torch.Tensor)]
        seen.update(grew=torch.cuda.max_memory_allocated() - before,
                    tree=sum(sizes), leaf=max(sizes))
        return out

    try:
        first = lm_train.main(base + ["--steps", "8", "--ckpt-dir", ckpt,
                                      "--ckpt-every", "4"])
        CheckpointManager.restore = measured
        try:
            resumed = lm_train.main(base + ["--steps", "12", "--ckpt-dir",
                                            ckpt, "--ckpt-every", "4"])
        finally:
            CheckpointManager.restore = restore
        with open(Path(ckpt) / "metrics.jsonl") as f:
            logged = [json.loads(line)["step"] for line in f]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    expect(seen.get("grew", 1 << 62) <= seen.get("leaf", 0),
           f"train resume: the restore grew the card's memory by {seen}")
    whole = lm_train.main(base + ["--steps", "12"])
    expect(len(first) == 8 and len(resumed) == 4 and len(whole) == 12,
           f"train resume: {len(first)} + {len(resumed)} losses, "
           f"uninterrupted {len(whole)}")
    expect(logged == list(range(12)), f"train resume: metrics steps {logged}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[8:]))
    expect(rel <= 1e-6, f"train resume: steps 8-11 differ by {rel} relative")
    comp = lm_train.main(base + ["--steps", "6", "--compress-grads"])
    expect(comp[-1] < comp[0], f"train --compress-grads: {comp}")
    acc = lm_train.main(["--arch", "qwen3-4b", "--preset", "reduced",
                         "--batch", "4", "--seq", "32", "--accum", "2",
                         "--steps", "4", "--device", dev])
    expect(len(acc) == 4 and all(math.isfinite(x) for x in acc),
           f"train --accum 2: {acc}")
    log(f"train reduced: resumed steps 8-11 {resumed} against uninterrupted "
        f"{whole[8:]} (max rel diff {rel:.3g}; bits repeat: "
        f"{first + resumed == whole}); the resume's restore grew the card's "
        f"allocation by {seen['grew']} B (params + optimizer state "
        f"{seen['tree']} B, largest leaf {seen['leaf']} B); "
        f"--compress-grads {comp[0]:.4f} -> "
        f"{comp[-1]:.4f}; --accum 2 {acc}")


def train_widths(arch) -> dict:
    """The config fields that make ``arch`` full width (``LM_PATHS``,
    ``STEP_PATHS`` or ``GROK_WIDTHS``), its depth left out."""
    for table in (LM_PATHS, STEP_PATHS):
        for name, want, *_ in table.values():
            if name == arch:
                return {k: v for k, v in want.items() if k != "n_layers"}
    return GROK_WIDTHS


def train_batch(torch, cfg, data, step, dev):
    """``data.batch_at(step)`` (tokens, targets, mask) on ``dev`` and the
    family's inputs (``step_batch``, seeded by the step): encdec S / 4
    frames; vision the patch embeddings of a sqrt(n_vision_patches)-wide
    grid in the first slots, their M-RoPE positions and the mask 0 there."""
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(step).items()}
    if cfg.family != "encdec" and cfg.frontend != "vision":
        return batch
    rows, seq = batch["tokens"].shape
    side = max(seq // 4, 8) if cfg.family == "encdec" \
        else math.isqrt(cfg.n_vision_patches)
    extra = step_batch(torch, cfg, rows, seq, side, dev, seed=step)
    del extra["tokens"]
    batch.update(extra)
    if cfg.frontend == "vision":
        batch["mask"][:, :side * side] = 0.0
    return batch


def family_steps(torch, cfg, rows, seq, lr, meter, steps, dev="cuda"):
    """``make_train_step`` driven as the launcher drives it, for the
    families it refuses: params from a seeded generator on the card, the
    config's optimizer under the launcher's schedule (warmup-cosine to
    ``lr``, 10 warm-up steps of max(steps, 20)), the synthetic batches of
    seed 0 with the family's inputs (``train_batch``) -> the losses."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.train import optim

    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = optim.make_optimizer(cfg.optimizer,
                               optim.warmup_cosine(lr, 10, max(steps, 20)))
    state = opt.init(params)
    step = meter.wrap(make_train_step(cfg, opt))
    data = SyntheticLMData(cfg.vocab_size, rows, seq, seed=0)
    losses = []
    for s in range(steps):
        params, state, m = step(params, state,
                                train_batch(torch, cfg, data, s, dev))
        losses.append(float(m["loss"]))
    return losses


def train_family_phase(torch, np, counters, path):
    """One of ``TRAIN_FAMILIES`` at its config's full width, bf16, its depth
    cut where AdamW's state for the whole depth does not fit the card:
    ``TRAIN_STEPS_FAMILY`` steps, the launcher's for the decoder-only
    families (``launch/train.main --preset full``, the cut config bound
    into it for its ``get_config``), ``family_steps`` for the two it
    refuses. A ``TrainMeter`` wraps the step (profile window
    ``TRAIN_FAMILY_PROFILE``); counts set to 0 before, read after. Held
    (``hold_training``): finite, falling losses, the first within 1.5 nats
    of ln V, peak memory below the card's, no kernel of the port launched;
    the MoE's load-balance and router z-losses finite in every step's
    metrics. Printed: params (and the MoE's active ones), step ms, tokens/s,
    model FLOP/s (``train_flops``) against the bf16 peak, peak GB, the
    profile's busy share and kernel classes, the path's seconds. Returns
    (the launch counts, the record)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train as lm_train

    t0 = time.perf_counter()
    arch, layers, rows, seq, lr = TRAIN_FAMILIES[path]
    whole = get_config(arch)
    cfg = whole if layers is None else dataclasses.replace(whole,
                                                           n_layers=layers)
    expect(_full_width(cfg, train_widths(arch)),
           f"{path}: {arch} is not at its full width")
    meter = TrainMeter(torch, TRAIN_FAMILY_PROFILE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    if path in LAUNCHED_FAMILIES:
        make, get = lm_train.make_train_step, lm_train.get_config
        lm_train.make_train_step = lambda *a, **kw: meter.wrap(make(*a, **kw))
        lm_train.get_config = lambda name: cfg
        try:
            losses = lm_train.main([
                "--arch", arch, "--preset", "full", "--steps",
                str(TRAIN_STEPS_FAMILY), "--batch", str(rows), "--seq",
                str(seq), "--lr", str(lr), "--device", "cuda"])
        finally:
            lm_train.make_train_step, lm_train.get_config = make, get
    else:
        losses = family_steps(torch, cfg, rows, seq, lr, meter,
                              TRAIN_STEPS_FAMILY)
    counts = counters.read()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    aux = {key: [m.get(key, math.nan) for m in meter.metrics]
           for key in ("grad_norm", "load_balance_loss", "router_z_loss")
           if key == "grad_norm" or cfg.moe is not None}
    numel = meter.seen["numel"]
    frames = seq // 4 if cfg.family == "encdec" else 0
    flops = train_flops(cfg, numel, rows, seq, frames)
    active = sum(numel.values())
    if cfg.moe is not None:
        m = cfg.moe
        active -= sum(v for k, v in numel.items() if "/moe/w_" in k) \
            * (m.n_experts - m.top_k) / m.n_experts
    rec = {
        "path": path, "arch": arch, "layers": cfg.n_layers,
        "of_layers": whole.n_layers, "optimizer": cfg.optimizer, "lr": lr,
        "params": sum(numel.values()), "active_params": active,
        "dtype": meter.seen["dtype"], "steps": TRAIN_STEPS_FAMILY,
        "batch": rows, "seq": seq, "frames": frames,
        "losses": losses, **aux, **meter.report(np, rows * seq, flops),
        "peak_allocated_gb": peak / 1e9, "card_gb": total / 1e9,
        "path_s": time.perf_counter() - t0,
    }
    log(f"train family {path}: " + json.dumps(rec))  # before the checks
    rec["mean_first5_last5"] = hold_training(
        np, path, losses, TRAIN_STEPS_FAMILY, cfg.vocab_size, peak, total,
        counts)
    for key in ("load_balance_loss", "router_z_loss"):
        if key in aux:
            expect(all(math.isfinite(x) for x in aux[key]),
                   f"{path}: {key} {aux[key]}")
    return counts, rec


def train_families_phase(torch, np, counters):
    """Every path of ``TRAIN_FAMILIES`` (``train_family_phase``) -> ({path:
    its launch counts}, {path: its record})."""
    counts, recs = {}, {}
    for path in TRAIN_FAMILIES:
        counts[path], recs[path] = train_family_phase(torch, np, counters,
                                                      path)
    return counts, recs


def train_families_reference(torch, np, dev="cuda"):
    """Each family of ``TRAIN_FAMILIES`` at the reduced preset, fp32 (TF32
    off): one step of ``make_train_step`` on the card and on the CPU from
    the same params on 2 x 64 tokens (``train_batch`` of seed 2, the
    family's inputs), under the launcher's schedule, held as
    ``train_reference_phase`` holds qwen3-4b (``step_card_vs_cpu``;
    grok-1-314b's adafactor on its analogous mask)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train import optim

    for path, (arch, *_) in TRAIN_FAMILIES.items():
        cfg = get_config(arch).reduced()
        data = SyntheticLMData(cfg.vocab_size, 2, 64, seed=2)
        step_card_vs_cpu(torch, cfg, train_batch(torch, cfg, data, 0, "cpu"),
                         optim.warmup_cosine(3e-4, 10, 20),
                         f"{path} reduced {arch}, 2 x 64 tokens", dev)


def checkpoint_full_phase(torch, np, dev="cuda"):
    """A full-width checkpoint round trip: seamless-m4t-large-v2 at its full
    width and depth (bf16 params, AdamW's fp32 moments), 2 steps of 4 x
    1,024 tokens (``train_batch``), then ``CheckpointManager.save`` of
    params and optimizer state into a fresh directory under ``build/``
    (the free disk printed first; less than the tree's bytes fails), step
    3 from the live state, ``restore`` of step 2 into the live tensors and
    step 3 again. Held: every restored leaf bit-equal to the step-2 state
    (a copy kept on the card), the counts equal, both step-3 losses
    bit-equal. Printed: the tree's GB, save and restore seconds and GB/s.
    The directory is deleted after."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.train import optim
    from repro_torch.train.tree import leaf_paths, leaves, tree_map

    t_phase = time.perf_counter()
    arch, want = STEP_PATHS["encdec"][:2]
    cfg = get_config(arch)
    expect(_full_width(cfg, want),
           f"checkpoint: {arch} is not at its full width and depth")
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    free = shutil.disk_usage(build_dir).free
    log(f"checkpoint full: {free / 1e9:.2f} GB free on the disk of "
        f"{build_dir}")
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = optim.make_optimizer(cfg.optimizer, optim.warmup_cosine(3e-4, 10,
                                                                  20))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    data = SyntheticLMData(cfg.vocab_size, 4, 1024, seed=0)
    for s in range(2):
        params, state, _ = step(params, state,
                                train_batch(torch, cfg, data, s, dev))
    tree = {"params": params, "opt": state}
    tensors = [t for t in leaves(tree) if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    expect(free > nbytes, f"checkpoint: {free} B free, the tree holds "
           f"{nbytes} B")
    kept = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)
    ckpt = tempfile.mkdtemp(prefix="ckpt_full_", dir=build_dir)
    try:
        mgr = CheckpointManager(ckpt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, tree)
        save_s = time.perf_counter() - t0
        written = sum(f.stat().st_size for f in Path(ckpt).rglob("*")
                      if f.is_file())
        batch = train_batch(torch, cfg, data, 2, dev)
        _, _, m = step(params, state, batch)
        live = float(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = mgr.restore(2, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    bad = []
    for (name, a), b in zip(leaf_paths(back), leaves(kept)):
        if isinstance(a, torch.Tensor):
            words = {2: torch.int16, 4: torch.int32}[a.element_size()]
            same = torch.equal(a.view(words), b.view(words))
        else:
            same = a == b
        if not same:
            bad.append(name)
    expect(not bad, f"checkpoint: {len(bad)} leaves differ after the "
           f"restore: {bad[:5]}")
    _, _, m = step(back["params"], back["opt"], batch)
    again = float(m["loss"])
    del kept, tree, back, params, state
    torch.cuda.empty_cache()
    expect(math.isfinite(live) and live == again,
           f"checkpoint: step 3 gives {live!r} from the live state, "
           f"{again!r} from the restored one")
    rec = {"arch": arch, "leaves": len(tensors), "tree_gb": nbytes / 1e9,
           "written_gb": written / 1e9, "disk_free_gb": free / 1e9,
           "save_s": save_s, "save_gb_per_s": nbytes / 1e9 / save_s,
           "restore_s": restore_s,
           "restore_gb_per_s": nbytes / 1e9 / restore_s,
           "step3_loss": live, "phase_s": time.perf_counter() - t_phase}
    log("checkpoint full: " + json.dumps(rec))
    return rec


def check_decode(torch, F, ops, ref, sets, label, softcap=0.0, window=0,
                 iters=20):
    """flash_decode against its plain version on ``sets`` (tuples q, k, v,
    lens[, k_scale, v_scale]; parity on the first, timing rotated through
    all), with the library time (one SDPA call, softcap 0 and no int8
    only) and the bound from the visible rows. Also its log-sum-exp
    output against the plain version's (``TOL_LSE``), and the output's
    bits equal with and without it. The plain version is asked for its
    lse too, so that a row with no visible position (a shard of a cache
    split along its sequence) is 0 on both sides, not the mean of V the
    plain version gives without; SDPA is held on the visible rows alone
    (it gives NaN on a row it may not see)."""
    def split(t):
        q, k, v, lens = t[:4]
        kw = {"softcap": softcap, "window": window}
        if len(t) > 4:
            kw.update(k_scale=t[4], v_scale=t[5])
        return q, k, v, lens, kw

    from repro_torch.kernels import cost, flash_decode

    q, k, v, lens, kw = split(sets[0])
    got = ops.decode_attention(q, k, v, lens, impl="cuda", **kw)
    want, want_lse = ref.decode_attention_ref(q, k, v, lens,
                                              return_lse=True, **kw)
    torch.cuda.synchronize()
    rtol, atol = TOL_DECODE[str(q.dtype).split(".")[-1]]
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    expect(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
           f"flash_decode {label}: max abs err {err} against max|out| "
           f"{scale} (rtol {rtol}, atol {atol})")
    expect(torch.equal(ops.decode_attention(q, k, v, lens, impl="cuda",
                                            **kw), got),
           f"flash_decode {label}: a second call gave other bits")
    lo = (lens - window).clamp_min(0) if window > 0 else torch.zeros_like(
        lens)
    with_lse, lse = flash_decode.decode_attention_cuda(
        q, k, v, lens.to(torch.int32), lo.to(torch.int32), softcap=softcap,
        k_scale=kw.get("k_scale"), v_scale=kw.get("v_scale"),
        return_lse=True)
    torch.cuda.synchronize()
    expect(torch.equal(with_lse, got), f"flash_decode {label}: the output's "
           "bits differ when the lse is asked for")
    seen = torch.isfinite(want_lse)
    lse_err = float((lse[seen] - want_lse[seen]).abs().max()) \
        if seen.any() else 0.0
    expect(torch.allclose(lse, want_lse, rtol=TOL_LSE[0], atol=TOL_LSE[1]),
           f"flash_decode {label}: lse max abs err {lse_err} (rtol "
           f"{TOL_LSE[0]}, atol {TOL_LSE[1]}), -inf rows "
           f"{int((~torch.isfinite(lse)).sum())} / "
           f"{int((~seen).sum())}")
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    vis = int((lens.clamp_max(s) - lo).clamp_min(0).sum())
    b_ms, b_by = bound(*cost.decode_attention(q, k, lens, lo,
                                              "k_scale" in kw))

    expect(all(torch.equal(t[3], lens) for t in sets),
           f"flash_decode {label}: the timed sets' lengths differ")

    def kern(*t):  # the kernel alone, on the window bound ops computes
        q, k, v, lens, kw = split(t)
        flash_decode.decode_attention_cuda(
            q, k, v, lens, lo, softcap=softcap, k_scale=kw.get("k_scale"),
            v_scale=kw.get("v_scale"))

    def plain(*t):
        q, k, v, lens, kw = split(t)
        ref.decode_attention_ref(q, k, v, lens, **kw)

    lib_ms = None
    if softcap == 0 and "k_scale" not in kw:
        pos = torch.arange(s, device=q.device)[None]

        def lib(*t):  # one SDPA call over the visible positions' mask
            q, k, v, lens, _ = split(t)
            lo = (lens - window).clamp_min(0) if window > 0 else \
                torch.zeros_like(lens)
            mask = (pos < lens[:, None]) & (pos >= lo[:, None])
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None, None, :], enable_gqa=True)[:, :, 0]

        lib_out = lib(*sets[0])
        seen = lens.clamp_max(s) > lo  # rows with a visible position
        expect(torch.allclose(lib_out[seen].float(), want[seen].float(),
                              rtol=TOL_SDPA, atol=TOL_SDPA),
               f"flash_decode {label}: SDPA disagrees with the plain version")
        lib_ms = time_rotating(torch, lib, sets, iters)
    rec = {
        "shape": f"B={b} H={h} Hkv={hkv} Dh={dh} S={s} "
                 f"{str(k.dtype).split('.')[-1]} softcap={softcap} "
                 f"window={window} visible={vis}",
        "max_abs_err": err, "max_abs_out": scale, "rtol": rtol, "atol": atol,
        "lse_max_abs_err": lse_err,
        "ms": time_rotating(torch, kern, sets, iters),
        "loop_ms": time_rotating(torch, kern, sets, iters, loop_ms),
        "plain_ms": time_rotating(torch, plain, sets, max(iters // 4, 3)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "splits": flash_decode.splits(q, k),
    }
    ratios(rec)
    log(f"flash_decode {label}: {rec}")
    return rec


def live_decode(torch, F, ops, ref, live, label):
    """flash_decode at an LM path's live inputs (``live``: the kernel's
    inputs at some attention calls of one decode step): parity at the
    first and last, timing rotated through all."""
    recs = []
    layers = sorted(live)
    for lay in (layers[0], layers[-1]):
        kw = live[lay][4]  # a cross-attention call passes none
        expect(kw.get("k_scale") is None, f"{label} layer {lay}: {kw}")
        recs.append(check_decode(
            torch, F, ops, ref, [live[lay][:4]] + [live[x][:4] for x in layers
                                                  if x != lay],
            f"{label} layer {lay}", softcap=kw.get("softcap", 0.0),
            window=kw.get("window", 0)))
    return recs


def decode_shapes(torch, F, ops, ref, dev="cuda"):
    """flash_decode at made-up shapes (``DECODE_SHAPES``): gemma2-2b's
    (softcap 50, window 4096), a large ragged bf16 one, the same with an
    int8 cache, and a large one at zamba2's heads (Dh = 112), each timed
    rotating through two caches (the second the first rolled by one batch
    row)."""
    from repro_torch.models.attention import quantize_kv_rows

    recs = []
    gen = torch.Generator(device=dev).manual_seed(13)
    for label, b, h, hkv, dh, s, softcap, window, int8 in DECODE_SHAPES:
        if not int8:
            q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
            k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                    .bfloat16() for _ in range(2))
            lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            lens[-1] = s + 7  # a finished row past the cache's end
            # a second cache to time against, so that no call finds the
            # previous one's rows in the L2
            k2, v2 = torch.roll(k, 1, 0), torch.roll(v, 1, 0)
            sets = [(q, k, v, lens), (q, k2, v2, lens)]
        else:  # the previous shape's inputs with an int8 cache
            sets = []
            for kk, vv in ((k, v), (k2, v2)):
                kq, ks = quantize_kv_rows(kk)
                vq, vs = quantize_kv_rows(vv)
                sets.append((q, kq, vq, lens, ks, vs))
            del k, v, k2, v2, kq, vq
        recs.append(check_decode(torch, F, ops, ref, sets, label,
                                 softcap=softcap, window=window, iters=10))
        del sets
    return recs


# ------------------------------------------------------------ dry run ----


def _dryrun(args, out, log_path):
    """Start ``python -m repro_torch.launch.dryrun`` on the card with
    ``args``, its records to ``out`` and its output to ``log_path``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logf = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cuda", "--mesh", "single", "--out", str(out), *args],
        cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT), logf


def _wait(procs, what):
    """Wait for every process; on a failure stop the others first."""
    try:
        for proc, logf in procs:
            code = proc.wait()
            expect(code == 0, f"{what}: launch/dryrun exited {code} (its "
                   f"log: {logf.name})")
    finally:
        for proc, logf in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()


def _dryrun_dir():
    work = ROOT / "build" / "dryrun"
    work.mkdir(parents=True, exist_ok=True)
    return work


def dryrun_phase(torch):
    """The dry run of the production single-pod mesh: (a) the sweep, (b)
    the real per-device cells. Returns the real cells' launch counts by
    kernel."""
    dryrun_sweep()
    return dryrun_real(torch)


def dryrun_sweep():
    """(a) The sweep's cells (every arch at ``DRYRUN_SHAPES`` and the graph
    cell, less ``DRYRUN_DROPPED``), one process an arch, held and
    tabled."""
    from repro_torch.configs import REGISTRY, get_config

    work = _dryrun_dir()
    for old in work.glob("sweep_*.json"):
        old.unlink()
    cells = {(a, s) for a in REGISTRY for s in DRYRUN_SHAPES}
    cells.add(("deepwalk-web1b", "train_4k"))
    want = cells - set(DRYRUN_DROPPED)
    archs = sorted({a for a, _ in want})
    t0 = time.perf_counter()
    procs = [_dryrun(["--arch", arch, "--shape", ",".join(
        sorted(s for a, s in want if a == arch))],
        work / f"sweep_{i}.json", work / f"sweep_{i}.log")
        for i, arch in enumerate(archs)]
    _wait(procs, "dryrun sweep")
    sweep_s = time.perf_counter() - t0
    recs = {}
    for i in range(len(archs)):
        for r in json.loads((work / f"sweep_{i}.json").read_text()):
            recs[(r["arch"], r["shape"])] = r
    expect(set(recs) == want, f"dryrun sweep: cells {sorted(set(recs) ^ want)}"
           " missing or extra")
    fails = [k for k, r in recs.items() if r["status"] == "fail"]
    expect(not fails, f"dryrun sweep: failed cells {fails}: " + "; ".join(
        recs[k]["error"][:200] for k in fails))
    skips = {k for k, r in recs.items() if r["status"] == "skip"}
    ref_skips = {(a, "long_500k") for a in REGISTRY
                 if get_config(a).family not in ("ssm", "hybrid")} & want
    expect(skips == ref_skips, f"dryrun sweep: skips {sorted(skips)}, the "
           f"JAX package's {sorted(ref_skips)}")
    no_flops = [k for k, r in recs.items()
                if r["status"] == "ok" and not r["flops"] > 0]
    expect(not no_flops, f"dryrun sweep: no FLOPs in {no_flops}")
    log(f"dryrun sweep (single pod, 256 fake ranks, {len(archs)} "
        f"processes): {sweep_s:.1f} s; "
        f"{len(recs) - len(skips)} ok, {len(skips)} skip, 0 fail; left out "
        f"for time: {', '.join(f'{a} {s}' for a, s in DRYRUN_DROPPED)}")
    log(f"  {'arch':24s} {'shape':12s} {'args GiB':>9s} {'temp GiB':>9s} "
        f"{'TFLOP':>9s} {'coll MiB':>10s}  (per device)")
    for (arch, shape), r in sorted(recs.items()):
        if r["status"] != "ok":
            log(f"  {arch:24s} {shape:12s} skip: {r['reason'][:40]}")
            continue
        m = r["memory"]
        log(f"  {arch:24s} {shape:12s} {m['argument_bytes'] / 2**30:9.3f} "
            f"{m['temp_bytes'] / 2**30:9.3f} {r['flops'] / 1e12:9.4g} "
            f"{sum(r['collective_bytes'].values()) / 2**20:10.1f}")

    return recs


def dryrun_real(torch):
    """(b) The real per-device runs (``DRYRUN_REAL``), one process ->
    their launch counts by kernel, and the local shapes flash-decode and
    the SGNS kernels were launched at (held to ``DRYRUN_DECODE_SHAPE`` and
    ``DRYRUN_SGNS_SHAPE``)."""
    work = _dryrun_dir()
    t0 = time.perf_counter()
    archs = ",".join(sorted({a for a, _ in DRYRUN_REAL}))
    shapes = ",".join(sorted({s for _, s in DRYRUN_REAL}))
    real = ",".join(f"{a}:{s}" for a, s in DRYRUN_REAL)
    _wait([_dryrun(["--arch", archs, "--shape", shapes, "--real", real],
                   work / "real.json", work / "real.log")], "dryrun --real")
    got = {(r["arch"], r["shape"]): r for r in
           json.loads((work / "real.json").read_text())}
    total = torch.cuda.get_device_properties(0).total_memory
    counts = {"decode_attention": 0, "sgns_fwd": 0, "sgns_bwd": 0}
    for cell in DRYRUN_REAL:
        r = got[cell]
        expect(r["status"] == "ok" and "real" in r,
               f"dryrun --real {cell}: {r.get('error', r['status'])}")
        rr = r["real"]
        expect(0 < rr["peak_bytes"] < total, f"dryrun --real {cell}: peak "
               f"{rr['peak_bytes']} bytes against the card's {total}")
        counts["decode_attention"] += rr["launches"]["flash_decode"]
        counts["sgns_fwd"] += rr["launches"]["sgns_fwd"]
        counts["sgns_bwd"] += rr["launches"]["sgns_bwd"]
        log(f"dryrun real {cell[0]} {cell[1]} (rank 0 of 256): step "
            f"{rr['step_ms']:.3f} ms (median of {len(rr['step_ms_all'])}), "
            f"peak {rr['peak_bytes'] / 2**30:.3f} GiB measured, tracker "
            f"temp {r['memory']['temp_bytes'] / 2**30:.3f} GiB + args "
            f"{r['memory']['argument_bytes'] / 2**30:.3f} GiB, "
            f"{r['flops'] / 1e12:.4g} TFLOP, launches {rr['launches']}")
    dec = got[("qwen3-4b", "decode_32k")]["real"]["launches"]
    expect(dec["flash_decode"] == DRYRUN_DECODE_LAUNCHES,
           f"dryrun real qwen3-4b decode_32k: {dec['flash_decode']} "
           f"flash-decode launches, want {DRYRUN_DECODE_LAUNCHES}")
    graph = got[("deepwalk-web1b", "train_4k")]["real"]["launches"]
    expect(graph["sgns_fwd"] > 0 and graph["sgns_bwd"] > 0,
           f"dryrun real deepwalk-web1b: SGNS launches {graph}")
    shapes = {}
    for cell, key, want in (
            (("qwen3-4b", "decode_32k"), "flash_decode", DRYRUN_DECODE_SHAPE),
            (("deepwalk-web1b", "train_4k"), "sgns_fwd", DRYRUN_SGNS_SHAPE),
            (("deepwalk-web1b", "train_4k"), "sgns_bwd", DRYRUN_SGNS_SHAPE)):
        seen = [tuple(x) for x in got[cell]["real"]["shapes"].get(key, [])]
        expect(seen == [want], f"dryrun real {cell}: {key} launched at "
               f"{seen}, want each rank's own shards {want}")
        shapes[key] = want
    log(f"dryrun --real: kernels launched at flash_decode "
        f"{shapes['flash_decode']}, sgns {shapes['sgns_fwd']} (rank 0's "
        f"shards); {time.perf_counter() - t0:.1f} s")
    return counts


def dryrun_decode_shape(torch, F, ops, ref, dev="cuda"):
    """flash-decode at the per-device shape the dry run's real decode cell
    launched it at (``DRYRUN_DECODE_SHAPE``): qwen3-4b decode_32k on the
    single pod (8 rows of its 128, all 32 query heads on the 8 KV heads,
    the rank's own 2,048 of the cache's 32,768 positions, every row full
    there), bf16; its output and log-sum-exp against the plain version
    (``check_decode``)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    b, h, hkv, dh, s, _ = DRYRUN_DECODE_SHAPE
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, dh), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    lens = torch.full((b,), s, device=dev, dtype=torch.int32)
    sets = [(q, k, v, lens), (q, torch.roll(k, 1, 0), torch.roll(v, 1, 0),
                              lens)]
    rec = check_decode(torch, F, ops, ref, sets, "dryrun qwen3-4b "
                       "decode_32k per device", iters=10)
    del sets, k, v
    return rec


# ---------------------------------------------------------------- mesh ----


def mesh_rank_main(argv) -> int:
    """``chip_smoke.py --mesh-rank OUT PLAN``: one rank of a ``torchrun``
    of the "mesh" path (``mesh_start``). Starts the world (so that the
    launchers keep it), then runs each entry of the JSON list PLAN in turn:
    ``{"tag", "kind": "serve" | "train" | "decode", "flags", "opts"}``,
    the launcher (or, for "decode", ``mesh_decode_rank``) with
    those flags (and the keywords ``opts``, where given), every kernel
    count set to 0 just before it and the peak
    memory reset; writes this rank's records {tag: record (the counts, the
    peak, what the launcher returned)} to ``OUT.<rank>.json``."""
    import torch

    from repro_torch.launch.mesh import init_world

    out, plan = argv
    counters = kernel_counters()
    init_world(device="cuda")
    rank = torch.distributed.get_rank()
    recs = {}
    try:
        for entry in json.loads(Path(plan).read_text()):
            run = {"serve": mesh_serve_rank, "train": mesh_train_rank,
                   "decode": mesh_decode_rank}[entry["kind"]]
            t0 = time.perf_counter()
            rec = run(torch, counters, entry["flags"],
                      **entry.get("opts", {}))
            torch.cuda.empty_cache()
            rec.update(rank=rank, world=torch.distributed.get_world_size(),
                       launches=counters.read(), run_s=time.perf_counter()
                       - t0, peak_bytes=torch.cuda.max_memory_allocated(),
                       card_bytes=torch.cuda.get_device_properties(
                           torch.cuda.current_device()).total_memory)
            recs[entry["tag"]] = rec
    finally:
        torch.distributed.destroy_process_group()
    Path(f"{out}.{rank}.json").write_text(json.dumps(recs))
    return 0


def mesh_serve_rank(torch, counters, flags, logits_out=None):
    """``launch/serve`` as its ``main`` runs it (``setup``: under a
    launcher the (world, 1) mesh; ``serve``; ``close``), the shapes of
    every flash-decode launch noted, each step's whole logits appended to
    ``logits_out`` if given -> the rank's record."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve as lm

    shapes, kernel = set(), fd.decode_attention_cuda

    def noting(q, k, *a, **kw):  # (B, H, Hkv, Dh, S, cache dtype)
        shapes.add((*q.shape[:2], *k.shape[2:], k.shape[1],
                    str(k.dtype).split(".")[-1]))
        return kernel(q, k, *a, **kw)

    t0 = time.perf_counter()
    args, cfg, params, requests = lm.setup(flags)
    init_s = time.perf_counter() - t0
    bad = torch.zeros((), dtype=torch.bool, device=args.device)

    def on_step(step, cache, logits):
        loc = logits.to_local() if is_dtensor(logits) else logits
        bad.logical_or_(~torch.isfinite(loc).all())
        if logits_out is not None:
            logits_out.append(logits.full_tensor() if is_dtensor(logits)
                              else logits)

    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    fd.decode_attention_cuda = noting
    try:
        res = lm.serve(cfg, params, requests, slots=args.slots,
                       max_new=args.max_new, device=args.device,
                       on_step=on_step)
    finally:
        fd.decode_attention_cuda = kernel
        lm.close(args)
    steps = res.step_tokens.shape[0]
    swap_s = sum(res.swap_seconds)
    return {"mesh": args.mesh is not None, "n_decoded": res.n_decoded,
            "served": res.served, "streams": res.streams,
            "step_tokens": res.step_tokens.tolist(), "steps": steps,
            "init_s": init_s, "prefill_ms": res.prefill_seconds * 1e3,
            "swap_ms": [t * 1e3 for t in res.swap_seconds],
            "decode_s": res.decode_seconds,
            "tokens_per_s": res.n_decoded / res.decode_seconds,
            "ms_per_step": (res.decode_seconds - swap_s) * 1e3 / steps,
            "schedule": res.schedule, "shapes": sorted(shapes),
            "bad": bool(bad)}


def mesh_train_rank(torch, counters, flags, changes=None, step_peaks=False,
                    record_step=None):
    """``launch/train.main(FLAGS)`` with its step wrapped: synchronised
    around every call, the seconds, loss and grad norm kept; at the first
    call the rank's resident bytes of params and optimizer state (local
    shards) and the leaves of more than 1 M entries that no mesh axis
    splits -> the rank's record. ``changes``: the arch's config with those
    fields changed (a cut depth, dtypes; bound into the launcher's
    ``get_config``). ``step_peaks``: the
    peak memory of each step (the peak reset before it). ``record_step``:
    that step (from 0) under the caching allocator's history
    (``largest_allocs``)."""
    import dataclasses

    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch import train as lm_train
    from repro_torch.train.tree import leaf_paths, leaves

    make, get = lm_train.make_train_step, lm_train.get_config
    times, metrics, seen, peaks = [], [], {}, []

    def scalar(x):
        return float(x.full_tensor() if is_dtensor(x) else x)

    def nbytes(tree):
        ts = [x.to_local() if is_dtensor(x) else x for x in leaves(tree)
              if isinstance(x, torch.Tensor)]
        return sum(t.numel() * t.element_size() for t in ts)

    def wrap(step):
        def run(params, state, batch):
            if not times:
                seen.update(
                    param_bytes=nbytes(params), state_bytes=nbytes(state),
                    init_peak_bytes=torch.cuda.max_memory_allocated(),
                    whole=[(name, list(p.shape)) for name, p in
                           leaf_paths(params) if p.numel() > 1 << 20
                           and not any(pl.is_shard() for pl in
                                       getattr(p, "placements", ()))])
            torch.cuda.synchronize()
            if step_peaks:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if len(times) == record_step:
                out, seen["largest_allocs"] = largest_allocs(
                    torch, lambda: step(params, state, batch))
            else:
                out = step(params, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if step_peaks:
                peaks.append(torch.cuda.max_memory_allocated())
            metrics.append({k: scalar(out[2][k])
                            for k in ("loss", "grad_norm")})
            return out
        return run

    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    lm_train.make_train_step = lambda *a, **kw: wrap(make(*a, **kw))
    if changes:
        lm_train.get_config = lambda name: dataclasses.replace(get(name),
                                                               **changes)
    try:
        losses = lm_train.main(flags)
    finally:
        lm_train.make_train_step, lm_train.get_config = make, get
    return {"losses": losses, "metrics": metrics,
            "step_ms_each": [t * 1e3 for t in times],
            "step_peak_bytes": peaks, **seen}


def largest_allocs(torch, fn, n=8, where=3):
    """``fn()`` under the caching allocator's history of this process's
    card (``torch.cuda.memory._record_memory_history``, Python stacks) ->
    (its result, {"sizes": the ``n`` largest blocks it allocated, bytes,
    largest first; "allocs": how many it allocated; "where": the port's
    and DTensor's frames that allocated the ``where`` largest}), from the
    allocator's own snapshot of the trace."""
    mem = torch.cuda.memory
    mem._record_memory_history(enabled="all", context="alloc",
                               stacks="python", max_entries=1 << 20)
    try:
        out = fn()
        torch.cuda.synchronize()
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    allocs = sorted((e for e in trace if e["action"] == "alloc"),
                    key=lambda e: -e["size"])
    frames = [[f"{Path(f['filename']).name}:{f['line']} {f['name']}"
               for f in e.get("frames", ())
               if "repro_torch" in f["filename"]
               or "distributed/tensor" in f["filename"]][:10]
              for e in allocs[:where]]
    return out, {"sizes": [e["size"] for e in allocs[:n]],
                 "allocs": len(allocs), "where": frames}


def fill_decode_cache(torch, k, v, slices, hkv, heads=None, rows=None):
    """The decode run's K and V cache into ``k``, ``v`` ((L, B', S', Hkv',
    Dh) each). The whole (L, B, S, Hkv, Dh) cache is ``MESH_CARDS`` slices
    of S / ``MESH_CARDS`` positions, slice j drawn layer by layer (K, then
    V) from a generator seeded by j alone and rounded to bf16; ``k`` and
    ``v`` take the slices ``slices`` in order and of each the rows
    ``rows`` (all where None) and the KV heads ``heads`` (a slice; all
    where None; ``hkv`` the whole cache's). One card's run takes every
    slice, a rank of the sequence split its own, a rank of the KV-heads
    split every slice of its heads: the same values, in bf16 or fp32."""
    lay_n, _, _, _, dh = k.shape
    width = MESH_DECODE[2] // MESH_CARDS
    gens = [torch.Generator(device=k.device).manual_seed(100 + j)
            for j in slices]
    for lay in range(lay_n):
        for i, gen in enumerate(gens):
            for t in (k, v):
                x = torch.randn((MESH_DECODE[1], width, hkv, dh),
                                generator=gen, device=t.device).bfloat16()
                if rows is not None:
                    x = x[list(rows)]
                t[lay, :, i * width:(i + 1) * width].copy_(
                    x if heads is None else x[:, :, heads])


class FirstAttention:
    """Within: the first self-attention decode output the model computes
    (layer 0's ``decode_attention``, (B, H, Dh)), whole, fp32, on the host:
    the attention before any other layer's rounding has reached it."""

    def __enter__(self):
        from repro_torch.models import attention

        self.mod, self.out = attention, None
        self.real = attention.decode_attention

        def first(*a, **kw):
            got = self.real(*a, **kw)
            if self.out is None:
                whole = got.full_tensor() if hasattr(got, "full_tensor") \
                    else got
                self.out = whole.float().cpu()
            return got

        attention.decode_attention = first
        return self

    def __exit__(self, *exc):
        self.mod.decode_attention = self.real


class CollectiveTrace:
    """Within: every collective this process issues, from a CPU trace of
    ``torch.profiler`` (the dispatcher records each op, those that DTensor
    issues inside its own dispatch too, which ``launch.dryrun.Tally``, a
    dispatch mode, does not see). ``calls``: {op name: [calls, elements of
    the input, largest input]} for the functional collectives
    (``_c10d_functional::``) and the backend's own calls (``nccl:``)."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU],
                            record_shapes=True)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.calls = {}
        for e in self.prof.events():
            name = e.name
            if not name.startswith(("_c10d_functional::", "nccl:")) or \
                    name.endswith(("wait_tensor", "_wrap_tensor_autograd")):
                continue
            shape = e.input_shapes[0] if e.input_shapes else []
            n = math.prod(shape) if shape else 0
            got = self.calls.setdefault(name, [0, 0, 0])
            got[0] += 1
            got[1] += n
            got[2] = max(got[2], n)

    def largest(self, kind):
        """The largest input of any call whose name holds ``kind``
        ("all_gather", "all_reduce", ...), in elements."""
        return max([c[2] for name, c in self.calls.items() if kind in name],
                   default=0)


def _local_bytes(tree):
    from repro_torch.train.tree import leaves

    return sum(x.to_local().nbytes if hasattr(x, "to_local") else x.nbytes
               for x in leaves(tree))


def mesh_decode_tokens(torch, vocab):
    """The decode run's (MESH_DECODE_STEPS, rows) tokens, one a row a step,
    seeded: every run is fed the same ones."""
    gen = torch.Generator().manual_seed(7)
    return torch.randint(2, vocab, (MESH_DECODE_STEPS, MESH_DECODE[1]),
                         generator=gen, dtype=torch.int32)


def fp32_twin(cfg, params):
    """``cfg`` and ``params`` (bf16, plain or DTensors) in fp32: the same
    values, computed in fp32."""
    import dataclasses

    from repro_torch.train.tree import leaves, unflatten

    return (dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32"),
            unflatten(params, [x.float() for x in leaves(params)]))


def mesh_decode_rank(torch, counters, flags):
    """One rank of the sequence-split decode: qwen3-4b (``MESH_DECODE``)
    at full width on a (1, world) (data, model) mesh, params from seed 0
    as one card's, the cache (``fill_decode_cache``) at
    ``MESH_DECODE_LENS``, ``MESH_DECODE_STEPS`` decode steps
    (``models.steps``) fed ``mesh_decode_tokens``, four times. First the
    fp32 witness (``fp32_twin``, rows ``MESH_DECODE_WITNESS``): the cache
    split by its KV heads ("heads32"), then along its sequence ("seq32").
    Then bf16 at all 8 rows: split by KV heads ("heads", the model axis's
    plain tensor parallelism: the same products and partial sums, every
    position of 2 KV heads a rank), and last under decode_32k's rules of
    the dry run ("seq", kv_seq on model: the cache split along its
    sequence, flash-decode on the rank's own positions, the partial
    outputs combined), every count set to 0 and the peak reset just
    before it. Every step synchronised and timed, layer 0's attention
    output of step 2 kept (``FirstAttention``); in the bf16 runs step 1
    under the dry run's tally of collectives (``launch.dryrun.Tally``:
    bytes, calls and largest call by kind) and a trace of every collective
    (``CollectiveTrace``); the shapes flash-decode was launched at in the
    last run noted. Rank 0 saves each run's ((steps, rows, V) last-position
    logits, that attention output) to ``flags[0]``. -> the rank's record
    (of the last run, its counts the run's, with the bytes of the rank's
    params and cache; the other runs' under "runs")."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  local_offset, local_tree,
                                                  shapes_only, sharding_scope)
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.dryrun import Tally, cell_overrides
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.steps import make_decode_step
    from repro_torch.models.transformer import (cache_specs, init_cache,
                                                init_model, model_specs)

    arch, rows, positions = MESH_DECODE
    cfg = get_config(arch)
    hkv = cfg.n_kv_heads
    dev = torch.device("cuda", torch.cuda.current_device())
    n = torch.distributed.get_world_size()
    mesh = make_mesh((1, n), ("data", "model"), device="cuda")
    rank = mesh.get_local_rank(1)
    seq_rules = cell_overrides(arch, "decode_32k")
    expect(seq_rules.get("kv_seq") == ("model",), f"{arch} decode_32k: "
           f"rules {seq_rules}")
    heads_rules = {k: v for k, v in seq_rules.items() if k != "kv_seq"}
    shapes, kernel = set(), fd.decode_attention_cuda

    def noting(q, k, *a, **kw):  # (B, H, Hkv, Dh, S, cache dtype)
        shapes.add((*q.shape[:2], *k.shape[2:], k.shape[1],
                    str(k.dtype).split(".")[-1]))
        return kernel(q, k, *a, **kw)

    t0 = time.perf_counter()
    with sharding_scope(mesh, **seq_rules):
        params = distribute_tree(
            init_model(cfg, torch.Generator(dev).manual_seed(0), dev),
            model_specs(cfg), src_data_rank=None)
    tokens = mesh_decode_tokens(torch, cfg.vocab_size).to(dev)
    runs, kept = {}, {}

    def run(split, c, p, picked):
        seq = split.startswith("seq")
        last = split == "seq"
        step = make_decode_step(c)
        with sharding_scope(mesh, **(seq_rules if seq else heads_rules)):
            cache = local_tree(
                shapes_only(init_cache, c, len(picked), positions,
                            device="meta"),
                cache_specs(c), lambda shape, dt: torch.empty(
                    shape, dtype=dt, device=dev))
            k, v = (cache[key].to_local() for key in ("k", "v"))
            off = local_offset(cache["k"])
            if seq:
                want = (positions // n, hkv, rank * positions // n, 0)
                fill_decode_cache(torch, k, v, [rank], hkv, rows=picked)
            else:
                want = (positions, hkv // n, 0, rank * hkv // n)
                fill_decode_cache(torch, k, v, range(n), hkv, slice(
                    want[3], want[3] + want[1]), rows=picked)
            expect((k.shape[2], k.shape[3], off[2], off[3]) == want,
                   f"decode rank {rank} ({split}): its cache slice "
                   f"{tuple(k.shape)} at {off}, want (S, Hkv, at) {want}")
            cache["len"].to_local().copy_(torch.tensor(
                [MESH_DECODE_LENS[b] for b in picked]))
            torch.cuda.synchronize()
            rec = {}
            if last:
                rec.update(init_s=time.perf_counter() - t0,
                           cache_bytes=_local_bytes(cache),
                           param_bytes=_local_bytes(p))
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                counters.reset()
                fd.decode_attention_cuda = noting
            times, outs, bad = [], [], False
            tally, trace = Tally(), CollectiveTrace()
            try:
                for t in range(MESH_DECODE_STEPS):
                    tok = distribute_tree(tokens[t][picked][:, None],
                                          ("batch", None),
                                          src_data_rank=None)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    if t == 0 and c is cfg:
                        with tally, trace:
                            logits, cache = step(p, cache, tok)
                    elif t == 1:
                        with FirstAttention() as first:
                            logits, cache = step(p, cache, tok)
                    else:
                        logits, cache = step(p, cache, tok)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                    final = logits.full_tensor()[:, -1].float()
                    bad = bad or not bool(torch.isfinite(final).all())
                    outs.append(final.cpu())
            finally:
                fd.decode_attention_cuda = kernel
            kept[split] = (torch.stack(outs), first.out)
            rec.update({
                "ms_each": times,
                "ms_per_step": statistics.median(times[1:]),
                "lens_after": cache["len"].full_tensor().tolist(),
                "bad": bad,
                "layer_k_slice": k[0].numel(),
                "layer_slice_bytes": 2 * k[0].numel() * k.element_size()})
            if c is cfg:  # the tally's view, and the trace's
                rec.update({key: {kind: x for kind, x in got.items() if x}
                            for key, got in (
                                ("collective_bytes", tally.coll_bytes),
                                ("collective_calls", tally.coll_counts),
                                ("collective_largest",
                                 tally.coll_largest))})
                rec.update(trace=trace.calls,
                           trace_largest_gather=trace.largest("all_gather"))
            runs[split] = rec
            del cache, k, v, logits

    cfg32, params32 = fp32_twin(cfg, params)
    for split in ("heads32", "seq32"):
        run(split, cfg32, params32, list(MESH_DECODE_WITNESS))
    del params32
    torch.cuda.empty_cache()
    for split in ("heads", "seq"):
        run(split, cfg, params, list(range(rows)))
    if rank == 0:
        torch.save(kept, flags[0])
    return {**runs.pop("seq"), "steps": MESH_DECODE_STEPS,
            "shapes": sorted(shapes), "runs": runs}


def mesh_decode_reference(torch, fp32=False):
    """The sequence-split decode's run on this process's card, no mesh:
    the same params, the whole cache (every slice of ``fill_decode_cache``)
    and tokens; ``fp32``: the witness (``fp32_twin``, the rows
    ``MESH_DECODE_WITNESS``) -> {each step's last-position logits (steps,
    rows, V) fp32 on the host, layer 0's attention output at step 2
    (``FirstAttention``), ms a step, the peak, the lengths after}."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models.steps import make_decode_step
    from repro_torch.models.transformer import init_model

    arch, rows, positions = MESH_DECODE
    cfg = get_config(arch)
    dev = torch.device("cuda", 0)
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    picked = list(range(rows))
    if fp32:
        cfg, params = fp32_twin(cfg, params)
        picked = list(MESH_DECODE_WITNESS)
    shape = (cfg.n_layers, len(picked), positions, cfg.n_kv_heads,
             cfg.head_dim)
    cache = {"len": torch.tensor([MESH_DECODE_LENS[b] for b in picked],
                                 dtype=torch.int32, device=dev),
             "k": torch.empty(shape, dtype=cfg.cdtype(), device=dev),
             "v": torch.empty(shape, dtype=cfg.cdtype(), device=dev)}
    fill_decode_cache(torch, cache["k"], cache["v"], range(MESH_CARDS),
                      cfg.n_kv_heads, rows=picked)
    tokens = mesh_decode_tokens(torch, cfg.vocab_size)[:, picked].to(dev)
    step = make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    for t in range(MESH_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == 1:
            with FirstAttention() as first:
                logits, cache = step(params, cache, tokens[t][:, None])
            attn0 = first.out
        else:
            logits, cache = step(params, cache, tokens[t][:, None])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits[:, -1].float().cpu())
    peak = torch.cuda.max_memory_allocated()
    lens = cache["len"].tolist()
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"logits": torch.stack(outs), "attn0": attn0,
            "ms_per_step": statistics.median(times[1:]), "peak_bytes": peak,
            "lens_after": lens}


def _worst(got, want):
    """max |got - want| over each (step, row)'s logits, over the row's max
    |logit| in ``want``: the worst step and row's ratio, and each step's
    worst."""
    ratio = (got - want).abs().amax(-1) / want.abs().amax(-1)
    return float(ratio.max()), ratio.amax(-1).tolist()


def _attn_err(got, want):
    """Layer 0's attention output: the worst row's max |diff| over its max
    |out|."""
    diff = (got - want).abs().flatten(1).amax(-1)
    return float((diff / want.abs().flatten(1).amax(-1)).max())


def _differ(got, ref):
    """The (step, row)s whose greedy tokens differ, with ``ref``'s top-two
    gap and max |logit| there."""
    top = ref.topk(2, -1).values
    gap, scale = top[..., 0] - top[..., 1], ref.abs().amax(-1)
    return [{"step": t, "row": b, "gap": float(gap[t, b]),
             "scale": float(scale[t, b])} for t, b in
            (got.argmax(-1) != ref.argmax(-1)).nonzero().tolist()]


def hold_mesh_decode(torch, recs, one, one32, kept):
    """The sequence-split decode's checks (``mesh_decode_rank``; ``kept``
    each run's logits and layer 0's attention, rank 0's; ``one`` and
    ``one32`` one card's bf16 run and fp32 witness), after its record is
    logged. On every rank, in the last run (bf16, the cache split along
    S): 36 flash-decode launches a step at ``MESH_DECODE_SHAPE``; no cache
    gather: no all-gather as large as a layer's K slice in the trace of
    step 1 (``CollectiveTrace``) nor a layer's K and V slice in the
    tally's, and the peak below the rank's params + cache + one layer's
    whole K and V. In every run: no NaN, the lengths one card's. The fp32
    witness (either split) within ``TOL_MESH_FP32`` of one card's fp32 run
    in layer 0's attention and in the logits, greedy tokens equal but
    where one card's top two are within twice that. The bf16 runs: layer
    0's attention within ``TOL_MESH_ATTN`` of one card's, the logits
    (either split against one card's and against each other) within
    ``TOL_MESH_LOGIT_BF16`` x max |logit|, greedy tokens equal but at
    near-ties (top two within ``LM_LOGIT_TOL`` x max |logit|). Recorded
    beside: the bf16 runs' witness rows against one card's fp32, the scale
    of bf16 rounding on one card -> the record."""
    from repro_torch.configs import get_config

    cfg = get_config(MESH_DECODE[0])
    w = list(MESH_DECODE_WITNESS)
    logits = {split: x for split, (x, _) in kept.items()}
    attn = {split: a for split, (_, a) in kept.items()}
    pairs = {"bf16": {"seq_vs_one": ("seq", one), "heads_vs_one":
                      ("heads", one), "seq_vs_heads": ("seq", "heads")},
             "fp32": {"seq_vs_one": ("seq32", one32), "heads_vs_one":
                      ("heads32", one32), "seq_vs_heads": ("seq32",
                                                           "heads32")}}
    errs, steps = {}, {}
    for kind, table in pairs.items():
        errs[kind], steps[kind] = {}, {}
        for name, (a, b) in table.items():
            ref = b["logits"] if isinstance(b, dict) else logits[b]
            errs[kind][name], steps[kind][name] = _worst(logits[a], ref)
    near = {"bf16_vs_heads": _differ(logits["seq"], logits["heads"]),
            "bf16_vs_one": _differ(logits["seq"], one["logits"]),
            "fp32_vs_one": _differ(logits["seq32"], one32["logits"])
            + _differ(logits["heads32"], one32["logits"])}
    vs_fp32 = {name: _worst(x[:, w], one32["logits"])[0] for name, x in
               (("one", one["logits"]), ("seq", logits["seq"]),
                ("heads", logits["heads"]))}
    rec = {"worst_of_max_logit": errs,
           "bf16_rows_vs_one_card_fp32": vs_fp32,
           "layer0_attention_vs_one": {
               "seq": _attn_err(attn["seq"], one["attn0"]),
               "heads": _attn_err(attn["heads"], one["attn0"]),
               "seq32": _attn_err(attn["seq32"], one32["attn0"]),
               "heads32": _attn_err(attn["heads32"], one32["attn0"])},
           "each_step": steps, "greedy_differ": near,
           "tokens": int(logits["seq"].shape[0] * logits["seq"].shape[1]),
           "one_card": {"ms_per_step": one["ms_per_step"],
                        "peak_gb": one["peak_bytes"] / 1e9,
                        "fp32_ms_per_step": one32["ms_per_step"],
                        "fp32_peak_gb": one32["peak_bytes"] / 1e9},
           "ranks": [{"ms_per_step": r["ms_per_step"],
                      "ms_per_step_by_run": {s: x["ms_per_step"] for s, x
                                             in r["runs"].items()},
                      "peak_gb": r["peak_bytes"] / 1e9,
                      "params_gb": r["param_bytes"] / 1e9,
                      "cache_gb": r["cache_bytes"] / 1e9,
                      "tally_collective_bytes_a_step":
                          r["collective_bytes"],
                      "tally_collective_calls_a_step":
                          r["collective_calls"],
                      "tally_largest_call": r["collective_largest"],
                      "trace_a_step": r["trace"],
                      "heads_split_tally_bytes_a_step":
                          r["runs"]["heads"]["collective_bytes"],
                      "heads_split_trace_a_step":
                          r["runs"]["heads"]["trace"],
                      "init_s": r["init_s"]} for r in recs]}
    log(f"mesh decode {MESH_DECODE[0]} on 1x{MESH_CARDS}, the cache split "
        f"along its sequence ({MESH_DECODE[1]} rows x {MESH_DECODE[2]} "
        f"positions, {MESH_DECODE_STEPS} steps, flash-decode at "
        f"{MESH_DECODE_SHAPE} a rank; beside the KV-heads split, and the "
        f"fp32 witness at rows {w}): " + json.dumps(rec))
    layer_kv = 2 * MESH_DECODE[1] * MESH_DECODE[2] * cfg.n_kv_heads \
        * cfg.head_dim * 2
    for r in recs:
        label = f"decode 1x{MESH_CARDS} rank {r['rank']}"
        expect(r["launches"]["decode_attention"]
               == cfg.n_layers * MESH_DECODE_STEPS,
               f"{label}: {r['launches']['decode_attention']} flash-decode "
               f"launches, want {cfg.n_layers} x {MESH_DECODE_STEPS}")
        expect([tuple(x) for x in r["shapes"]] == [MESH_DECODE_SHAPE],
               f"{label}: flash-decode at {r['shapes']}, want "
               f"{MESH_DECODE_SHAPE}")
        gathered = r["collective_largest"].get("all-gather", 0)
        expect(gathered < r["layer_slice_bytes"]
               and r["trace_largest_gather"] < r["layer_k_slice"],
               f"{label}: an all-gather of {gathered} bytes (tally) or "
               f"{r['trace_largest_gather']} elements (trace); a layer's "
               f"K and V slice {r['layer_slice_bytes']} bytes, its K "
               f"{r['layer_k_slice']} elements")
        room = r["param_bytes"] + r["cache_bytes"] + layer_kv
        expect(r["peak_bytes"] < room, f"{label}: peak {r['peak_bytes']} "
               f"bytes, not below params {r['param_bytes']} + cache "
               f"{r['cache_bytes']} + one layer's whole K and V {layer_kv}")
        for split, run in (("seq", r), *r["runs"].items()):
            lens = (one32 if split.endswith("32") else one)["lens_after"]
            expect(not run["bad"] and run["lens_after"] == lens,
                   f"{label} ({split}): NaN/inf {run['bad']}, lengths "
                   f"{run['lens_after']}, one card's {lens}")
        expect(r["peak_bytes"] < r["card_bytes"],
               f"{label}: peak {r['peak_bytes']}")
    for split in kept:
        want = (one32 if split.endswith("32") else one)["logits"]
        expect(logits[split].shape == want.shape, f"decode 1x{MESH_CARDS} "
               f"({split}): logits {tuple(logits[split].shape)}, one "
               f"card's {tuple(want.shape)}")
    for name, err in rec["layer0_attention_vs_one"].items():
        tol = TOL_MESH_FP32 if name.endswith("32") else TOL_MESH_ATTN
        expect(err <= tol, f"decode 1x{MESH_CARDS}: layer 0's attention "
               f"({name}) off one card's by {err} x the row's max |out| "
               f"(tolerance {tol})")
    for kind, tol in (("fp32", TOL_MESH_FP32), ("bf16", TOL_MESH_LOGIT_BF16)):
        for name, err in errs[kind].items():
            expect(err <= tol, f"decode 1x{MESH_CARDS} {kind}: logits "
                   f"{name} {err} x max |logit| (tolerance {tol})")
    for name, differ in near.items():
        tol = 2 * TOL_MESH_FP32 if name.startswith("fp32") else LM_LOGIT_TOL
        bad = [d for d in differ if d["gap"] > tol * d["scale"]]
        expect(not bad, f"decode 1x{MESH_CARDS}: greedy tokens differ "
               f"({name}) off near-ties: {bad}")
    return rec


def mesh_start(n, plan, tag):
    """``torchrun`` (``python -m torch.distributed.run --standalone``, a
    free port on localhost) of ``n`` ranks of this script in
    ``--mesh-rank`` mode running ``plan`` (see ``mesh_rank_main``), in a
    session of its own (so that a failure stops every rank), its output to
    ``build/mesh/<tag>.log``."""
    import os

    work = ROOT / "build" / "mesh"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob(f"{tag}.*"):
        old.unlink()
    out, log_path = work / tag, work / f"{tag}.log"
    plan_path = work / f"{tag}.plan.json"
    plan_path.write_text(json.dumps(plan))
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
         "--mesh-rank", str(out), str(plan_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
    return {"proc": proc, "logf": logf, "out": out, "log": log_path, "n": n,
            "tag": tag, "t0": time.perf_counter()}


def mesh_wait(run, timeout=MESH_TIMEOUT):
    """Wait for a ``mesh_start`` run -> each rank's records. Fails (the
    end of the log in the message) if it exits non-zero or outlasts
    ``timeout``; its session is killed if it still runs."""
    import os
    import signal

    try:
        code = run["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        code = f"timeout after {timeout} s"
    finally:
        if run["proc"].poll() is None:
            os.killpg(run["proc"].pid, signal.SIGKILL)
            run["proc"].wait()
        run["logf"].close()
    tail = run["log"].read_text(errors="replace")[-4000:]
    expect(code == 0, f"mesh {run['tag']}: torchrun exited {code}; the end "
           f"of {run['log']}:\n{tail}")
    recs = [json.loads(Path(f"{run['out']}.{r}.json").read_text())
            for r in range(run["n"])]
    wall = time.perf_counter() - run["t0"]
    log(f"mesh {run['tag']}: {run['n']} rank(s) collected {wall:.1f} s after "
        f"the start (runs: "
        + ", ".join(f"{tag} {r['run_s']:.1f} s" for tag, r in recs[0].items())
        + ")")
    return recs


def mesh_counts(recs):
    """The kernels' launches summed over every run of every rank of
    ``recs``."""
    out = {}
    for rank in recs:
        for r in rank.values():
            for name, n in r["launches"].items():
                out[name] = out.get(name, 0) + n
    return out


def mesh_phase(torch, np, counters, four, only=None):
    """The "mesh" path. ``four`` (``--mesh-only``) with ``MESH_CARDS``
    cards or more: ``mesh_four`` (``only`` passed on), the launchers under
    ``torchrun`` across four cards; otherwise ``mesh_1x1_phase``. Returns
    (the launch counts, the records)."""
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if four and n >= MESH_CARDS:
        return mesh_four(torch, np, only)
    log(f"mesh: {n} card(s); the four-card runs (qwen3-4b served on (4, 1), "
        f"decoded on a sequence-split cache on 1x4 and trained on 2x2, "
        f"mamba2-2.7b and zamba2-7b (81 layers) trained on 1x4, the train "
        f"cells of gemma2-2b, starcoder2-7b and grok-1-314b) "
        + (f"need {MESH_CARDS} cards" if n < MESH_CARDS else
           "run under --mesh-only") + "; the serve launcher on a 1x1 mesh")
    return mesh_1x1_phase(torch, counters)


def mesh_1x1_phase(torch, counters):
    """The "mesh" path on one card: ``launch/serve`` at qwen3-4b's full
    width and depth (``MESH_ONE_FLAGS``) as a plain process (no mesh), then
    in this process under ``WORLD_SIZE=1`` as a launcher sets it (a real
    (1, 1) mesh, NCCL, a world of one: params, prompts, tokens and the
    cache DTensors, flash-decode through its sharded path). Held: every
    step's logits bit-equal, as one rank moves no data; the step tokens,
    streams, served and n_decoded equal; one flash-decode launch a layer a
    step at the whole batch; no NaN. Returns (the mesh run's launch counts,
    its record)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import serve as lm

    t0 = time.perf_counter()
    args, cfg, params, requests = lm.setup(MESH_ONE_FLAGS)
    expect(args.mesh is None, "the plain launcher built a mesh")
    plain = []
    want = lm.serve(cfg, params, requests, slots=args.slots,
                    max_new=args.max_new, device=args.device,
                    on_step=lambda step, cache, logits: plain.append(logits))
    del params
    torch.cuda.empty_cache()
    expect(not dist.is_initialized(), "a process group before the 1x1 mesh")
    meshed = []
    os.environ["WORLD_SIZE"] = "1"
    try:
        r = mesh_serve_rank(torch, counters, MESH_ONE_FLAGS, meshed)
        counts = counters.read()
    finally:
        del os.environ["WORLD_SIZE"]
    expect(not dist.is_initialized(), "the launcher left its world")
    torch.cuda.synchronize()
    steps = want.step_tokens.shape[0]
    equal = [bool(torch.equal(a, b)) for a, b in zip(plain, meshed)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(plain, meshed))
    del plain, meshed
    torch.cuda.empty_cache()
    expect(r["mesh"], "WORLD_SIZE=1: the launcher built no mesh")
    expect(len(equal) == steps and all(equal), f"1x1 mesh: logits not "
           f"bit-equal to no mesh ({equal}, max abs diff {err})")
    expect(r["step_tokens"] == want.step_tokens.tolist()
           and r["streams"] == want.streams,
           "1x1 mesh: the tokens differ from the plain launcher's")
    expect((r["n_decoded"], r["served"]) == (want.n_decoded, want.served),
           f"1x1 mesh: n_decoded / served {r['n_decoded']} / "
           f"{r['served']}, plain {want.n_decoded} / {want.served}")
    expect(counts["decode_attention"] == cfg.n_layers * steps,
           f"1x1 mesh: {counts['decode_attention']} flash-decode launches, "
           f"want {cfg.n_layers} x {steps}")
    expect(all(sh[0] == args.slots for sh in r["shapes"]),
           f"1x1 mesh: flash-decode launched at {r['shapes']}")
    expect(not r["bad"], "1x1 mesh: NaN/inf in the logits")
    plain_ms = (want.decode_seconds - sum(want.swap_seconds)) * 1e3 / steps
    log(f"mesh (1x1, NCCL, a world of one, through launch/serve): qwen3-4b "
        f"full width, {r['n_decoded']} tokens in {steps} steps, "
        f"{r['served']} requests: logits bit-equal to the plain launcher's "
        f"at all {steps} steps, tokens equal; flash-decode "
        f"{counts['decode_attention']} launches at {r['shapes']}; "
        f"{r['ms_per_step']:.1f} ms a step on the mesh, {plain_ms:.1f} "
        f"plain; {time.perf_counter() - t0:.1f} s")
    return counts, r


class TopTwo:
    """An ``on_step`` hook keeping each step's (B,) gap between the top two
    last-position logits and max |logit| (``host`` gives both on the host,
    (steps, B))."""

    def __init__(self):
        self.gaps, self.scales = [], []

    def __call__(self, step, cache, logits):
        last = logits[:, -1].float()
        top = last.topk(2, -1).values
        self.gaps.append(top[:, 0] - top[:, 1])
        self.scales.append(last.abs().amax(-1))

    def host(self, torch):
        return torch.stack(self.gaps).cpu(), torch.stack(self.scales).cpu()


def mesh_serve_reference(torch):
    """The lm path's serve (``lm_flags("qwen3-4b")``) on this process's
    card, no mesh -> {its step tokens, streams, schedule, served, decode
    seconds, swap seconds, and ``TopTwo``'s gaps and scales}."""
    from repro_torch.launch import serve as lm

    args, cfg, params, requests = lm.setup(lm_flags("qwen3-4b"))
    top = TopTwo()
    res = lm.serve(cfg, params, requests, slots=args.slots,
                   max_new=args.max_new, device=args.device, on_step=top)
    del params
    torch.cuda.empty_cache()
    gaps, scales = top.host(torch)
    return {"step_tokens": res.step_tokens, "streams": res.streams,
            "schedule": res.schedule, "served": res.served,
            "decode_s": res.decode_seconds, "swap_s": sum(res.swap_seconds),
            "gaps": gaps, "scales": scales}


def mesh_train_reference(torch, flags):
    """The first ``MESH_HELD_STEPS`` steps of ``launch/train.main(flags)``
    (one card, no mesh; the schedule's length is the same) -> each step's
    metrics (``metrics.jsonl``)."""
    from repro_torch.launch import train as lm_train

    path = ROOT / "build" / "mesh" / "train1.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    lm_train.main(_flag(flags, "--steps", str(MESH_HELD_STEPS))
                  + ["--metrics", str(path)])
    torch.cuda.empty_cache()
    return [json.loads(line) for line in path.read_text().splitlines()]


def mesh_four(torch, np, only=None):
    """Four cards, one ``torchrun`` of 4 ranks running five runs in turn:
    (a) qwen3-4b served by ``launch/serve`` on the (4, 1) data mesh
    with the lm path's flags (12 requests of 1,024 tokens, 8 slots: 2 a
    card, 64 new): every rank decodes 1,024 tokens in 128 steps with
    exactly 36 flash-decode launches a step at its local
    ``MESH_SERVE_SHAPE``, no NaN; the schedule the one-card run's, and
    each request's stream equal to its one-card stream but where its first
    differing token is a near-tie of the one-card run (its top two logits
    there within ``LM_LOGIT_TOL`` x max |logit|; counted) or the request's
    first token, decoded from the token the slot's previous request ended
    on when that token differs already (counted). (b) qwen3-4b's decode on
    a cache split along its sequence over 1x4 (``mesh_decode_rank``, held
    by ``hold_mesh_decode``, beside the cache split by its KV heads). (c)
    qwen3-4b trained by ``launch/train
    --mesh 2x2`` with the train path's flags for ``MESH_TRAIN_STEPS``
    steps, (d) mamba2-2.7b, its SSD split by heads, by ``--mesh 1x4`` for
    ``MESH_HELD_STEPS`` steps (``MESH_HELD``): step 1's loss and grad norm
    within ``TOL_MESH_STEP`` of one card's, the losses of steps 2 to
    ``MESH_HELD_STEPS`` (after the sharded AdamW updates) within
    ``TOL_MESH_LOSS``, then ``hold_training`` (qwen3-4b) or its checks
    that need no falling losses (mamba2). (e) zamba2-7b at all 81 layers,
    ``--mesh 1x4``, AdamW at 1e-4: ``hold_training``, each rank's peak
    below its card's, its params' and AdamW state's resident bytes printed
    against ``MESH_STATE_GB`` and the leaves no axis splits named, its ms
    a step and peak beside PR 26's (``MESH_HYBRID_BEFORE``). The one-card
    references (the lm path's serve with ``TopTwo``, the decode and its
    fp32 witness, each held run's first ``MESH_HELD_STEPS`` steps) are run
    here first on cuda:0. Then the train cells (``mesh_cells``: gemma2-2b
    and starcoder2-7b on 1x4, grok-1-314b on 2x2) in a torchrun of their
    own. ``only="decode"``: (b) alone; ``only="cells"``: the cells
    alone."""
    from repro_torch.configs import get_config

    if only == "cells":
        return mesh_cells(torch, np)
    t0 = time.perf_counter()
    flags = {label: _flag(_flag(_flag(TRAIN_FLAGS, "--arch", arch),
                                "--steps", str(steps)), "--lr", str(lr))
             for label, (arch, _, lr, steps) in MESH_TRAIN.items()}
    alone = only == "decode"
    one = None if alone else mesh_serve_reference(torch)
    one_decode = mesh_decode_reference(torch)
    one_decode32 = mesh_decode_reference(torch, fp32=True)
    ref_steps = {} if alone else {
        label: mesh_train_reference(torch, flags[label])
        for label in MESH_HELD}
    log(f"mesh references (cuda:0, no mesh): decode {MESH_DECODE[0]} "
        f"{one_decode['ms_per_step']:.1f} ms a step, peak "
        f"{one_decode['peak_bytes'] / 1e9:.2f} GB (fp32 witness "
        f"{one_decode32['ms_per_step']:.1f} ms, "
        f"{one_decode32['peak_bytes'] / 1e9:.2f} GB); train steps 1-"
        f"{MESH_HELD_STEPS} " + json.dumps(ref_steps)
        + f"; {time.perf_counter() - t0:.1f} s")
    logits_path = ROOT / "build" / "mesh" / "decode_logits.pt"
    plan = [{"tag": "serve", "kind": "serve",
             "flags": lm_flags("qwen3-4b")},
            {"tag": "decode", "kind": "decode",
             "flags": [str(logits_path)]}]
    for label, (arch, mesh, lr, steps) in MESH_TRAIN.items():
        plan.append({"tag": label, "kind": "train",
                     "flags": flags[label] + ["--mesh", mesh]})
    if alone:
        plan = [e for e in plan if e["tag"] == "decode"]
    ranks = mesh_wait(mesh_start(MESH_CARDS, plan, "four"))
    out = {}
    if alone:
        out["decode"] = hold_mesh_decode(
            torch, [rank["decode"] for rank in ranks], one_decode,
            one_decode32, torch.load(logits_path))
        log(f"mesh path (4 cards, the decode alone): "
            f"{time.perf_counter() - t0:.1f} s")
        return mesh_counts(ranks), out
    # (a) serve on (4, 1)
    cfg = get_config("qwen3-4b")
    recs = [rank["serve"] for rank in ranks]
    for r in recs:
        expect(r["mesh"] and r["n_decoded"] == LM_DECODED
               and r["steps"] == LM_STEPS and r["served"] == one["served"],
               f"serve (4, 1) rank {r['rank']}: {r['n_decoded']} tokens, "
               f"{r['steps']} steps, {r['served']} served")
        expect(r["launches"]["decode_attention"] == cfg.n_layers * LM_STEPS,
               f"serve (4, 1) rank {r['rank']}: "
               f"{r['launches']['decode_attention']} flash-decode launches")
        expect([tuple(s) for s in r["shapes"]] == [MESH_SERVE_SHAPE],
               f"serve (4, 1) rank {r['rank']}: flash-decode at "
               f"{r['shapes']}, want {MESH_SERVE_SHAPE}")
        expect(not r["bad"] and r["peak_bytes"] < r["card_bytes"],
               f"serve (4, 1) rank {r['rank']}: NaN/inf {r['bad']}, peak "
               f"{r['peak_bytes']}")
        expect(r["step_tokens"] == recs[0]["step_tokens"],
               f"serve (4, 1): rank {r['rank']}'s tokens differ from rank 0's")
    expect([tuple(e) for e in recs[0]["schedule"]]
           == [tuple(e) for e in one["schedule"]],
           "serve (4, 1): the schedule differs from the one-card run's")
    got, want = np.asarray(recs[0]["step_tokens"]), one["step_tokens"]
    at = {}  # request -> the (step, slot) of each of its tokens
    for t, b, q in one["schedule"]:
        at.setdefault(q, []).append((t, b))
    ties, inherited = [], []
    for q, (g, w) in enumerate(zip(recs[0]["streams"], one["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            continue
        t, b = at[q][j]
        if j == 0 and t > 0 and got[t - 1, b] != want[t - 1, b]:
            # its first step decodes from the token the slot's previous
            # request ended on, which differs already
            inherited.append({"request": q, "slot": b, "step": t})
            continue
        gap, scale = float(one["gaps"][t, b]), float(one["scales"][t, b])
        expect(gap <= LM_LOGIT_TOL * scale,
               f"serve (4, 1): request {q} first differs at its token {j} "
               f"(step {t}, slot {b}), where the one-card run's top two "
               f"logits are {gap} apart (max |logit| {scale}): not a "
               "near-tie")
        ties.append({"request": q, "token": j, "slot": b, "step": t,
                     "gap": gap, "scale": scale})
    same = sum(s == w for s, w in zip(recs[0]["streams"], one["streams"]))
    keys = ("tokens_per_s", "ms_per_step", "prefill_ms", "init_s", "run_s")
    out["serve"] = {"ranks": [{k: r[k] for k in keys} | {
        "peak_gb": r["peak_bytes"] / 1e9} for r in recs],
        "streams_equal": same, "near_ties": ties,
        "inherited": inherited,
        "one_card": {"tokens_per_s": LM_DECODED / one["decode_s"],
                     "ms_per_step": (one["decode_s"] - one["swap_s"]) * 1e3
                     / LM_STEPS}}
    log(f"mesh serve qwen3-4b on (4, 1): {same} of {len(one['streams'])} "
        f"streams equal to one card's; requests first differing at a "
        f"near-tie: {len(ties)}, from the previous request's last token: "
        f"{len(inherited)}; " + json.dumps(out["serve"]))
    # (b) the sequence-split decode. A failed check of (b)-(e) is raised
    # once every run's record has been printed
    failed = []
    try:
        out["decode"] = hold_mesh_decode(
            torch, [rank["decode"] for rank in ranks], one_decode,
            one_decode32, torch.load(logits_path))
    except SmokeFailure as e:
        failed.append(str(e))
    # (c)-(e) training
    rows, seq = (int(TRAIN_FLAGS[TRAIN_FLAGS.index(f) + 1])
                 for f in ("--batch", "--seq"))
    for label, (arch, mesh, lr, steps) in MESH_TRAIN.items():
        recs = [rank[label] for rank in ranks]
        tcfg = get_config(arch)
        r0 = recs[0]
        step_ms = float(np.median(r0["step_ms_each"][2:]))
        rec = {"arch": arch, "mesh": mesh, "layers": tcfg.n_layers, "lr": lr,
               "losses": r0["losses"],
               "grad_norms": [m["grad_norm"] for m in r0["metrics"]],
               "step_ms": step_ms, "tokens_per_s": rows * seq / step_ms * 1e3,
               "run_s": r0["run_s"],
               "ranks": [{
                   "peak_gb": r["peak_bytes"] / 1e9,
                   "init_peak_gb": r["init_peak_bytes"] / 1e9,
                   "param_gb": r["param_bytes"] / 1e9,
                   "state_gb": r["state_bytes"] / 1e9} for r in recs],
               "whole_leaves": r0["whole"]}
        if label in MESH_HELD:  # steps 1.. against one card, relative
            rel = [[abs(m[k] - w[k]) / abs(w[k]) for k in ("loss",
                                                            "grad_norm")]
                   for m, w in zip(r0["metrics"], ref_steps[label])]
            rec["rel_diff_loss_grad_norm"] = rel
        else:
            rec["state_vs_reckoned_gb"] = MESH_STATE_GB
            rec["before_by_rows"] = {"ms": MESH_HYBRID_BEFORE[:2],
                                     "peak_gb": MESH_HYBRID_BEFORE[2]}
        out[label] = rec
        log(f"mesh {label}: {arch} ({tcfg.n_layers} layers) on {mesh}: "
            + json.dumps(rec))
        try:
            for r in recs:
                expect(r["losses"] == r0["losses"],
                       f"{label}: rank {r['rank']}'s losses differ from "
                       "rank 0's")
                if steps >= 10:
                    hold_training(np, f"{label} rank {r['rank']}",
                                  r["losses"], steps, tcfg.vocab_size,
                                  r["peak_bytes"], r["card_bytes"],
                                  r["launches"])
                    continue
                expect(len(r["losses"]) == steps
                       and all(math.isfinite(x) for x in r["losses"])
                       and r["peak_bytes"] < r["card_bytes"]
                       and not any(r["launches"].values()),
                       f"{label} rank {r['rank']}: losses {r['losses']}, "
                       f"peak {r['peak_bytes']}, launches {r['launches']}")
            if label in MESH_HELD:
                expect(len(rel) == MESH_HELD_STEPS,
                       f"{label}: {len(rel)} steps held against one card")
                expect(rel[0][0] <= TOL_MESH_STEP[0]
                       and rel[0][1] <= TOL_MESH_STEP[1],
                       f"{label}: step 1 loss / grad norm relative to one "
                       f"card's {rel[0]}, tolerance {TOL_MESH_STEP}")
                expect(all(x[0] <= TOL_MESH_LOSS for x in rel[1:]),
                       f"{label}: the losses of steps 2-{MESH_HELD_STEPS} "
                       f"relative to one card's {[x[0] for x in rel[1:]]}, "
                       f"tolerance {TOL_MESH_LOSS}")
        except SmokeFailure as e:
            failed.append(str(e))
    counts = mesh_counts(ranks)
    try:  # launches none: training runs no kernel of the port
        _, out["cells"] = mesh_cells(torch, np)
    except SmokeFailure as e:
        failed.append(str(e))
    expect(not failed, "; ".join(failed))
    log(f"mesh path (4 cards): {time.perf_counter() - t0:.1f} s")
    return counts, out


def mesh_cell_flags(label):
    """The train path's flags for a ``MESH_CELLS`` run: its arch, rate,
    rows and tokens a row, ``MESH_HELD_STEPS`` steps."""
    arch, _, lr, _, rows, seq = MESH_CELLS[label]
    flags = TRAIN_FLAGS
    for name, value in (("--arch", arch), ("--steps", MESH_HELD_STEPS),
                        ("--lr", lr), ("--batch", rows), ("--seq", seq)):
        flags = _flag(flags, name, str(value))
    return flags


def mesh_cell_opts(label):
    """``mesh_train_rank``'s keywords for a ``MESH_CELLS`` run."""
    return {"changes": MESH_CELLS[label][3], "step_peaks": True,
            "record_step": MESH_CELLS_RECORD.get(label)}


def mesh_cells_reference(torch):
    """Each ``MESH_CELLS`` run on this process's card, no mesh
    (``mesh_train_rank``) -> {label: its record, with its peak}."""
    t0 = time.perf_counter()
    ones = {}
    for label in MESH_CELLS:
        ones[label] = mesh_train_rank(torch, kernel_counters(),
                                      mesh_cell_flags(label),
                                      **mesh_cell_opts(label))
        ones[label]["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    log("mesh cells references (one card, no mesh): " + json.dumps(
        {label: {k: r[k] for k in ("metrics", "step_ms_each",
                                   "step_peak_bytes")}
         | {"peak_gb": r["peak_bytes"] / 1e9,
            "largest_allocs": r.get("largest_allocs")}
         for label, r in ones.items()})
        + f"; {time.perf_counter() - t0:.1f} s")
    return ones


def mesh_cells(torch, np):
    """The train cells as the JAX package lays them out, on four cards
    (``MESH_CELLS``): each first on cuda:0 with no mesh (``mesh_train_rank``
    in this process), then all in one ``torchrun`` of 4 ranks
    (``launch/train --mesh``, each arch's own rules). Held for each: every
    rank's losses rank 0's, finite, no kernel launched, peaks below the
    card's; step 1's loss and grad norm within ``TOL_MESH_STEP`` of one
    card's, the losses of steps 2 to ``MESH_HELD_STEPS`` within
    ``TOL_MESH_LOSS`` (``MESH_CELLS_ROUTED``: every step's loss within
    ``TOL_MESH_LOSS``, the grad norms printed; its fp32 twin held as the
    rest). grok-1-314b (``MESH_CELLS_RECORD``): at the recorded
    step, every rank's peak below one card's on the same step, and the
    largest block each rank allocated (the allocator's own history) below
    one whole expert matrix. Printed: ms a step (step 3), peak GB a rank
    beside one card's, the largest blocks -> (the launch counts, the
    records)."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    ones = mesh_cells_reference(torch)
    plan = [{"tag": label, "kind": "train", "opts": mesh_cell_opts(label),
             "flags": mesh_cell_flags(label) + ["--mesh", mesh]}
            for label, (_, mesh, *_) in MESH_CELLS.items()]
    ranks = mesh_wait(mesh_start(MESH_CARDS, plan, "cells"))
    out, failed = {}, []
    for label, (arch, mesh, lr, changes, rows, seq) in MESH_CELLS.items():
        recs, one = [rank[label] for rank in ranks], ones[label]
        cfg = dataclasses.replace(get_config(arch), **changes)
        r0 = recs[0]
        rel = [[abs(m[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")]
               for m, w in zip(r0["metrics"], one["metrics"])]
        rec = {"arch": arch, "mesh": mesh, "layers": cfg.n_layers,
               "of_layers": get_config(arch).n_layers, "lr": lr,
               "dtype": cfg.param_dtype,
               "rows": rows, "seq": seq, "losses": r0["losses"],
               "rel_diff_loss_grad_norm": rel,
               "step_ms": r0["step_ms_each"][-1],
               "step_ms_each": r0["step_ms_each"],
               "tokens_per_s": rows * seq / r0["step_ms_each"][-1] * 1e3,
               "run_s": r0["run_s"],
               "ranks": [{"peak_gb": r["peak_bytes"] / 1e9,
                          "step_peak_gb": [b / 1e9
                                           for b in r["step_peak_bytes"]],
                          "param_gb": r["param_bytes"] / 1e9,
                          "state_gb": r["state_bytes"] / 1e9,
                          "largest_allocs": r.get("largest_allocs")}
                         for r in recs],
               "whole_leaves": r0["whole"],
               "one_card": {"step_ms_each": one["step_ms_each"],
                            "peak_gb": one["peak_bytes"] / 1e9,
                            "step_peak_gb": [b / 1e9 for b in
                                             one["step_peak_bytes"]],
                            "largest_allocs": one.get("largest_allocs")}}
        at = MESH_CELLS_RECORD.get(label)
        if at is not None:
            m = cfg.moe
            rec["expert_matrix_bytes"] = whole = \
                m.n_experts * cfg.d_model * m.d_ff_expert * 2
        out[label] = rec
        log(f"mesh {label}: {arch} ({cfg.n_layers} of "
            f"{rec['of_layers']} layers, {rows} x {seq}) on {mesh}: "
            + json.dumps(rec))
        try:
            for r in recs:
                expect(r["losses"] == r0["losses"],
                       f"{label}: rank {r['rank']}'s losses differ from "
                       "rank 0's")
                expect(len(r["losses"]) == MESH_HELD_STEPS
                       and all(math.isfinite(x) for x in r["losses"])
                       and r["peak_bytes"] < r["card_bytes"]
                       and not any(r["launches"].values()),
                       f"{label} rank {r['rank']}: losses {r['losses']}, "
                       f"peak {r['peak_bytes']}, launches {r['launches']}")
                if at is not None:
                    expect(r["step_peak_bytes"][at]
                           < one["step_peak_bytes"][at],
                           f"{label} rank {r['rank']}: step {at + 1}'s peak "
                           f"{r['step_peak_bytes'][at]} B, one card's "
                           f"{one['step_peak_bytes'][at]}")
                    big = r["largest_allocs"]["sizes"][0]
                    expect(big < whole,
                           f"{label} rank {r['rank']}: a block of {big} B "
                           f"allocated in step {at + 1}, a whole expert "
                           f"matrix is {whole}")
            expect(len(rel) == MESH_HELD_STEPS,
                   f"{label}: {len(rel)} steps held against one card")
            routed = label in MESH_CELLS_ROUTED
            expect(routed or (rel[0][0] <= TOL_MESH_STEP[0]
                              and rel[0][1] <= TOL_MESH_STEP[1]),
                   f"{label}: step 1 loss / grad norm relative to one "
                   f"card's {rel[0]}, tolerance {TOL_MESH_STEP}")
            expect(all(x[0] <= TOL_MESH_LOSS for x in rel[routed:]),
                   f"{label}: the losses of steps {2 - routed}-"
                   f"{MESH_HELD_STEPS} relative to one card's "
                   f"{[x[0] for x in rel[routed:]]}, tolerance "
                   f"{TOL_MESH_LOSS}")
        except SmokeFailure as e:
            failed.append(str(e))
    expect(not failed, "; ".join(failed))
    log(f"mesh cells (4 cards): {time.perf_counter() - t0:.1f} s")
    return mesh_counts(ranks), out


def mesh_decode_shape(torch, F, ops, ref, dev="cuda"):
    """flash-decode at a rank's shape on the (4, 1) serve
    (``MESH_SERVE_SHAPE``: 2 of the 8 rows, every head, 1,088 positions;
    ragged lengths past the prompt), bf16, timed rotating through 12
    caches (more than twice the L2)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    b, h, hkv, dh, s, _ = MESH_SERVE_SHAPE
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    lens = torch.tensor([s, 1056], device=dev, dtype=torch.int32)
    sets = [(q, *(torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                  .bfloat16() for _ in range(2)), lens) for _ in range(12)]
    rec = check_decode(torch, F, ops, ref, sets, "mesh serve (4, 1) per "
                       "rank", iters=20)
    del sets
    return rec


def mesh_seq_decode_shape(torch, F, ops, ref, dev="cuda"):
    """flash-decode at a rank's shape on the 1x4 sequence-split decode
    (``MESH_DECODE_SHAPE``: the 8 rows, every head, the rank's 8,192
    positions) with rank 1's lengths after the last step (its slice of
    ``MESH_DECODE_LENS`` + ``MESH_DECODE_STEPS``: a row with no position
    there, two that end just inside it, four full), bf16, timed rotating
    through 2 caches."""
    gen = torch.Generator(device=dev).manual_seed(23)
    b, h, hkv, dh, s, _ = MESH_DECODE_SHAPE
    glob = torch.tensor(MESH_DECODE_LENS, device=dev) + MESH_DECODE_STEPS
    lens = (glob - s).clamp(0, s).to(torch.int32)
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    sets = [(q, *(torch.randn((b, s, hkv, dh), generator=gen, device=dev)
                  .bfloat16() for _ in range(2)), lens) for _ in range(2)]
    rec = check_decode(torch, F, ops, ref, sets, "mesh decode 1x4 "
                       "sequence-split, rank 1", iters=20)
    del sets
    return rec


# -------------------------------------------------------------- main ----


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test "
            "needs an NVIDIA GPU")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        log(f"FAIL: {src / 'repro_torch'} not found; run from a checkout")
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of the mesh path
        return mesh_rank_main(sys.argv[2:])
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops, ref, sgns

    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled: {', '.join(sorted(logs)) or 'cached'})")

    counters = kernel_counters()
    if sys.argv[1:] == ["--shard-only"]:
        shard_phase(torch, np, ops, ref, F, counters)
        log(f"smoke: {time.perf_counter() - t_start:.1f} s, shard path only")
        return 0
    if sys.argv[1:] == ["--pipeline-only"]:
        pipeline_phase(torch, np, counters)
        log(f"smoke: {time.perf_counter() - t_start:.1f} s, pipeline path "
            f"only")
        return 0
    if sys.argv[1:2] == ["--mesh-only"] and sys.argv[2:] in (
            [], ["decode"], ["cells"]):
        only = (sys.argv[2:] or [None])[0]
        mesh_phase(torch, np, counters, four=True, only=only)
        if torch.cuda.device_count() >= MESH_CARDS and only != "cells":
            if only is None:
                mesh_decode_shape(torch, F, ops, ref)
            mesh_seq_decode_shape(torch, F, ops, ref)
        log(f"smoke: {time.perf_counter() - t_start:.1f} s, mesh path only")
        return 0
    if sys.argv[1:] == ["--train-only"]:
        train_families_phase(torch, np, counters)
        train_families_reference(torch, np)
        checkpoint_full_phase(torch, np)
        log(f"smoke: {time.perf_counter() - t_start:.1f} s, training paths "
            f"only")
        return 0
    with SweepTally(ops) as tally:  # the serving phase only
        svc, serve_counts = serve_phase(torch, np, counters)
    obs_checks(torch, np, svc)
    launcher_obs_phase(torch)
    shape_tally, tally_recs = sweep_tally(torch, ops, ref, tally)
    reference_phase(torch, np)
    hub_counts, hub_tier = hub_serve_phase(torch, np, counters)
    serve_rec = serve_shapes(torch, np, ops, ref, F, svc)
    large_rec = large_shapes(torch, ops, ref, F)
    large_rec["h_index"] += tally_recs
    serve_rec["h_index_hub"], large_rec["h_index_hub"] = hub_shapes(
        torch, ops, ref, hub_tier)
    _, offline_counts, split = offline_phase(torch, np, counters)
    resil_counts, _ = resilience_phase(torch, np, counters)
    shard_counts, shard_rec, _ = shard_phase(torch, np, ops, ref, F,
                                             counters)
    for name, rec in shard_rec.items():
        large_rec[name].append(rec)
    pipe_counts, _ = pipeline_phase(torch, np, counters)
    large_rec["ell_mean"] += propagation_shapes(torch, np, ops, ref, F,
                                                split)
    train = check_sgns(torch, ref, sgns, 8192, 5, 150, torch.float32,
                       "train")
    large = check_sgns(torch, ref, sgns, 65536, 5, 256, torch.bfloat16,
                       "large", iters=10)
    many = check_sgns(torch, ref, sgns, 64, 2048, 150, torch.float32,
                      "K=2048", iters=10, fp64=True)
    retrain = check_sgns(torch, ref, sgns, 4096, 5, 128, torch.float32,
                         "retrain")
    for name in ("sgns_fwd", "sgns_bwd"):
        serve_rec[name] = train[name]
        large_rec[name] = [large[name], many[name], retrain[name]]
    step_profile(torch, split)
    lm_counts, live = {}, {}
    for path in LM_PATHS:  # each path's params and caches freed after it
        cfg, params, lm_counts[path], snap = lm_serve_phase(
            torch, np, counters, path)
        if LM_PATHS[path][2]:  # a path with attention
            live[path] = lm_decode_parity(torch, cfg, params, snap,
                                          LM_PATHS[path][3])
        lm_profile(torch, cfg, params, snap)
        del params, snap
        torch.cuda.empty_cache()
        lm_reference_phase(torch, np, path)
    for path in STEP_PATHS:
        cfg, params, lm_counts[path], snap = step_phase(torch, np, counters,
                                                        path)
        calls = step_calls(path)
        kept = lm_decode_parity(torch, cfg, params, snap, tuple(calls))
        for call, inputs in kept.items():
            label, lay = calls[call]
            live.setdefault(label, {})[lay] = inputs
        lm_profile(torch, cfg, params, snap)
        del params, snap, kept
        torch.cuda.empty_cache()
        step_reference_phase(torch, np, path)
    decode_live = {path: live_decode(torch, F, ops, ref, live[path], path)
                   for path in live}
    del live
    serve_rec["decode_attention"] = decode_live["lm"][0]
    large_rec["decode_attention"] = decode_live["lm"][1:] + [
        r for path in decode_live if path != "lm"
        for r in decode_live[path]] + decode_shapes(torch, F, ops, ref)
    train_counts = train_phase(torch, np, counters)
    train_reference_phase(torch, np)
    train_reduced_phase(torch, np)
    family_counts, _ = train_families_phase(torch, np, counters)
    train_families_reference(torch, np)
    checkpoint_full_phase(torch, np)
    dryrun_counts = {key: 0 for key in counters.table}
    dryrun_counts.update(dryrun_phase(torch))
    large_rec["decode_attention"].append(
        dryrun_decode_shape(torch, F, ops, ref))
    b, k, d, _ = DRYRUN_SGNS_SHAPE
    graph = check_sgns(torch, ref, sgns, b, k, d, torch.float32,
                       "dryrun deepwalk-web1b per device")
    for name in ("sgns_fwd", "sgns_bwd"):
        large_rec[name].append(graph[name])
    torch.cuda.empty_cache()
    mesh_c, _ = mesh_phase(torch, np, counters, four=False)

    keys = ("max_abs_err", "ms", "loop_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "x_bound", "x_library", "shape")
    kernels = []
    paths = (serve_counts, hub_counts, resil_counts, shard_counts,
             pipe_counts, offline_counts, *lm_counts.values(), train_counts,
             *family_counts.values(), dryrun_counts, mesh_c)
    for name, (src_path, replaces) in SOURCES.items():
        by_path = {"serve": serve_counts[name], "hub": hub_counts[name],
                   "resilience": resil_counts[name],
                   "shard": shard_counts[name],
                   "pipeline": pipe_counts[name],
                   "offline": offline_counts[name],
                   **{path: c[name] for path, c in lm_counts.items()},
                   "train": train_counts[name],
                   **{path: c[name] for path, c in family_counts.items()},
                   "dryrun": dryrun_counts[name], "mesh": mesh_c[name]}
        expect(sum(by_path.values()) > 0, f"kernel {name} never launched")
        rec = {
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: serve_rec[name][k] for k in keys},
            "large": [{k: b[k] for k in keys} for b in large_rec[name]],
        }
        parts = [key for key in counters.table
                 if key.startswith(name + ".")]
        if parts:  # the kernels of one wrapper, each counted
            rec["launches_by_kernel"] = {
                key.split(".")[1]: sum(c[key] for c in paths)
                for key in parts}
            expect(sum(rec["launches_by_kernel"].values()) == rec["launches"],
                   f"{name}: its kernels' launches do not sum to its count")
        if name == "h_index":
            rec["tiers"] = [{k: t[k] for k in keys}
                            for t in serve_rec[name]["tiers"]]
            rec["serving_shapes"] = shape_tally
        kernels.append(rec)
    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        sys.exit(1)
