#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and ``nvcc``; it imports nothing of JAX or of the
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
   recovery seconds, the records replayed;
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
   over 20 decode steps (device time by kernel class, launches per step,
   busy share; reported);
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
   ``--compress-grads`` (falling) and ``--accum 2`` (finite);
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
   on rank 0's shards: the cache split along its sequence and gathered,
   the rank's query heads kept and their KV head picked), qwen3-4b
   train_4k and deepwalk-web1b train_4k (both SGNS kernels on the rank's
   own pairs), rank 0's shards on the card with seeded values, the
   collectives faked. Held: exactly 36 flash-decode launches a decode
   step, SGNS forward and backward launches > 0, every launch at the
   rank's own shard shape (``DRYRUN_DECODE_SHAPE``,
   ``DRYRUN_SGNS_SHAPE``), the measured peak below the card's memory;
   printed: step ms (median of 5 after 2 warm-ups), the measured peak
   beside the tracker's temp and argument bytes, TFLOP, launches. These
   launches are the path's counts in the kernels line. (c) qwen3-4b at
   full width on a real 1x1 mesh (NCCL, a world of one): a prefill of 8 x
   1,024 and 8 greedy steps through ``distribute_tree`` and the sharded
   flash-decode, held bit-equal to the same steps with no mesh (36 x 8
   launches), the group destroyed after. Then flash-decode and both SGNS
   kernels at (b)'s per-device shapes, against their plain versions, with
   their bounds (and the SDPA time for flash-decode): rows of the kernels
   line's ``large``.

Every kernel record also holds ``x_bound`` (kernel / bound) and
``x_library`` (kernel / library, where there is a library call). Every
kernel is also held to give the same bits on a second call (all are
deterministic by design); the ELL mean is timed as well at two of
the offline k-core row's propagation calls (one shell's rows against the
table: the largest shell, and the largest that takes the row-split path)
and records which of its two paths each shape takes.

The line before the last is the ``nvidia-smi`` name and power limit; before
it, one JSON object with a record per kernel (``launches`` summed over the
serving, the hub, the resilience, the offline, the four LM serving, the
two step, the train and the dryrun path, each path's count beside it; the h-index's hub kernel also as
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
# flash-decode against its plain version, (rtol, atol) by the queries' type.
# Both accumulate in fp32 and round once to q's type, so in bf16 they differ
# by at most one ulp (< 2**-7 x |out|, < 7.8e-4 below 0.1), well under 1e-2
# x |out| + 1e-3; outputs at the smoke's shapes are about 0.03-0.05 (mean of
# ~1,000-4,000 unit values), so a fixed 3e-2 would pass a wrong kernel
TOL_DECODE = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
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
    + (("grok-1-314b", "train_4k"), ("nemotron-4-15b", "decode_32k"))
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the cells run again for real on the card (rank 0's local shards):
# flash-decode on the KV-sequence-split cache, a train step, both SGNS
# kernels; flash-decode launches a decode step: one a layer
DRYRUN_REAL = (("qwen3-4b", "decode_32k"), ("qwen3-4b", "train_4k"),
               ("deepwalk-web1b", "train_4k"))
DRYRUN_DECODE_LAUNCHES = 36
# the graph cell's pairs on each of the single pod's 256 ranks (2^20 / 256)
DRYRUN_SGNS_SHAPE = (4096, 5, 128, "float32")
# qwen3-4b decode_32k on one rank: 8 of the 128 rows, 2 of the 32 query
# heads and the one KV head they share, the 32,768 positions gathered
DRYRUN_DECODE_SHAPE = (8, 2, 1, 128, 32768, "bfloat16")
# the 1x1 mesh: qwen3-4b at full width, rows x prompt, then greedy steps
MESH_ROWS, MESH_PROMPT, MESH_STEPS = 8, 1024, 8

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
RESIL_THRESHOLD = 0.01  # the twin retrains after ops 5 and 11
RESIL_BUDGET = 2
RESIL_HANG_TIMEOUT = 120.0  # s: the watchdog around flushes and retrains


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


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


class SweepTally:
    """While bound (``with``), counts the (R, W) of every h-index sweep
    through ``ops.h_index_sweep`` (the repair's and the k-core's entry) and
    keeps a copy of the first call's inputs at each shape; every call goes
    on to the kernel as before."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = {}
        self.first = {}

    def __enter__(self):
        self.orig = self.ops.h_index_sweep
        self.ops.h_index_sweep = self
        return self

    def __exit__(self, *exc):
        self.ops.h_index_sweep = self.orig

    def __call__(self, values, valid, est, **kw):
        key = tuple(values.shape)
        if key[0]:  # the wrapper launches nothing for no rows
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
        f"{svc.cores.sweeps} sweeps; core mismatches vs oracle: {mismatches}")
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


def lockstep(np, svcs, stream, block_size, churn, seed):
    """Drive services through the same blocks and churn, checking that
    their cores agree after every block."""
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
        cores = [s.cores.core for s in svcs]
        expect(all(np.array_equal(cores[0], c) for c in cores),
               f"cores differ after the block at {start}")


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
    pending = inc._descend_dispatch(cand, seed, old.astype(np.int32), 0,
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
    return theirs to no one) and the op each fired after."""

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
        f"retrains after ops {fired}")
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
           f"resilience: twin retrains after ops {fired}, not on both sides "
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
        "threshold": RESIL_THRESHOLD, "twin_retrains_after_ops": fired,
        "retrains": [{"after_op": op, "sgns_steps": r.sgns_steps,
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


def lm_profile(torch, cfg, params, snap, steps=20):
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


def train_phase(torch, np, counters):
    """LM training at qwen3-4b's full width and depth on the card, through
    ``repro_torch.launch.train.main`` (``TRAIN_FLAGS``: bf16 params, AdamW
    with fp32 moments, 20 steps of 4 x 1024 tokens, the weights from a
    seeded generator on the card; no checkpoint: one at this width writes
    48 GB). A wrapper bound into the launcher's ``make_train_step``
    synchronises around every step and runs steps ``TRAIN_PROFILE`` under
    ``torch.profiler``. Held: 20 finite losses, the first within 1.5 nats
    of ln V, the mean of the last five below the mean of the first five
    (the JAX package's own check), peak memory below the card's, and no
    kernel of the port launched (training runs none). Printed: step ms
    (median of the unprofiled steps after the first two), tokens/s, model
    FLOP/s (6 N per token plus PaLM's attention term 12 L H Dh S, against
    the bf16 dense peak), peak GB, device-busy ms per step. Returns the
    launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as lm_train
    from repro_torch.train.tree import leaves

    cfg = get_config("qwen3-4b")
    make = lm_train.make_train_step
    times, seen = [], {}

    def timed(*a, **kw):
        step = make(*a, **kw)

        def run(params, state, batch):
            i = len(times)
            if i == 0:
                seen["n_params"] = sum(t.numel() for t in leaves(params))
                seen["dtype"] = str(params["embed"]["embedding"].dtype)
            if i == TRAIN_PROFILE[0]:
                seen["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
                seen["prof"].__enter__()
                seen["t_prof"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == TRAIN_PROFILE[1] - 1:
                seen["prof"].__exit__(None, None, None)
                seen["wall"] = time.perf_counter() - seen["t_prof"]
            return out

        return run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    lm_train.make_train_step = timed
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
    expect(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
           f"train: losses {losses}")
    expect(abs(losses[0] - math.log(cfg.vocab_size)) < 1.5,
           f"train: first loss {losses[0]} is not near ln V = "
           f"{math.log(cfg.vocab_size):.2f}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    expect(last < first, f"train: losses do not fall ({first} -> {last})")
    expect(peak < total, f"train: peak {peak} B over the card's {total}")
    for name, n in counts.items():
        expect(n == 0, f"{name} launched {n} times on the training path")
    step_s = float(np.median(times[2:TRAIN_PROFILE[0]]))
    tokens = B * S
    flops = tokens * (6 * seen["n_params"] + 12 * cfg.n_layers * cfg.n_heads
                      * cfg.head_dim * S)
    dev = device_time(seen["prof"])
    n_prof = TRAIN_PROFILE[1] - TRAIN_PROFILE[0]
    busy_ms = sum(us for _, us in dev.values()) / 1e3 / n_prof
    classes = {}
    for name, (n, us) in dev.items():
        cn, cus = classes.get(train_class(name), (0, 0.0))
        classes[train_class(name)] = (cn + n, cus + us)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:10]
    rec = {
        "arch": cfg.name, "params": seen["n_params"], "dtype": seen["dtype"],
        "steps": n_steps, "batch": B, "seq": S,
        "losses_first_last": [losses[0], losses[-1]],
        "mean_first5_last5": [float(first), float(last)],
        "step_ms_each": [t * 1e3 for t in times],
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "model_tflop_per_step": flops / 1e12,
        "model_tflop_per_s": flops / step_s / 1e12,
        "bf16_peak_share": flops / step_s / PEAK_BF16,
        "peak_allocated_gb": peak / 1e9, "card_gb": total / 1e9,
        "profile_steps": list(range(*TRAIN_PROFILE)),
        "profiled_ms_per_step": seen["wall"] * 1e3 / n_prof,
        "device_busy_ms_per_step": busy_ms if dev else None,
        "device_busy_share": busy_ms * n_prof / (seen["wall"] * 1e3)
        if dev else None,
        "busy_of_unprofiled_step": busy_ms / (step_s * 1e3) if dev else None,
        "launches_per_step": sum(n for n, _ in dev.values()) / n_prof,
        "by_class_ms_per_step": {c: us / 1e3 / n_prof
                                 for c, (_, us) in classes.items()},
        "launches_by_class_per_step": {c: n / n_prof
                                       for c, (n, _) in classes.items()},
        "top_kernels": [{"name": k[:90], "calls": n,
                         "ms_per_step": us / 1e3 / n_prof}
                        for k, (n, us) in top],
    }
    if not dev:
        log("train profile: the profiler saw no device time (not measured)")
    log("train phase: " + json.dumps(rec))
    return counts


def train_reference_phase(torch, np, dev="cuda"):
    """qwen3-4b's widths at 2 layers, fp32 (TF32 off), one AdamW step of
    ``make_train_step`` on the card and on the CPU from the same params (one
    generator, copied to both) on the same batch of 1 x 256 tokens. Held
    (``TOL_TRAIN_*``): loss and grad_norm within 1e-5 relative; mu and nu
    within 1e-4 x their leaf's max |value|; every parameter within 1e-3 x
    the rate where sqrt(v_hat) > 100 eps (at least half of each leaf) and
    2 x the rate everywhere, and within 1e-3 x its leaf's max |value|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.train import optim
    from repro_torch.train.tree import leaf_paths, leaves

    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLMData(cfg.vocab_size, 1, 256, seed=0).batch_at(0)
    sched = optim.warmup_cosine(3e-4, 10, 20)
    lr, b2, eps = sched(0), 0.999, 1e-8  # adamw's defaults
    out = {}
    for where in (dev, "cpu"):  # the CPU's step updates ``params`` itself
        p = _tree_to(params, where)
        opt = optim.make_optimizer(cfg.optimizer, sched)
        step = make_train_step(cfg, opt)
        tb = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        t0 = time.perf_counter()
        p, state, m = step(p, opt.init(p), tb)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        out[where] = (p, state, loss, norm, time.perf_counter() - t0)
    (pg, sg, lg, ng, tg), (pc, sc, lc, nc, tc) = out[dev], out["cpu"]
    mom = (0.0, "")
    for (name, a), (_, b) in zip(leaf_paths(sg), leaf_paths(sc)):
        if isinstance(a, int):
            expect(a == b, f"train: {name} is {a} on the card, {b} on the CPU")
            continue
        err = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        mom = max(mom, (err, name))
    ok_err, all_err, share = (0.0, ""), (0.0, ""), (1.0, "")
    rel = (0.0, "")  # the bound against each leaf's own magnitude too
    for (name, a), (_, b), v in zip(leaf_paths(pg), leaf_paths(pc),
                                    leaves(sc[0].nu)):
        d = (a.cpu() - b).abs()
        rel = max(rel, (float(d.max()) / float(b.abs().max()), name))
        ok = torch.sqrt(v / (1 - b2)) > 100 * eps  # v_hat after one step
        share = min(share, (float(ok.float().mean()), name))
        ok_err = max(ok_err, (float(d[ok].max()) / lr, name))
        all_err = max(all_err, (float(d.max()) / lr, name))
    log(f"train reference: qwen3-4b widths, 2 layers, fp32, 1 x 256 tokens, "
        f"one AdamW step at rate {lr:.6g}: loss {lg!r} (card) / {lc!r} "
        f"(CPU), rel {abs(lg - lc) / abs(lc):.3g}; grad_norm {ng!r} / {nc!r}, "
        f"rel {abs(ng - nc) / abs(nc):.3g}; moments within {mom[0]:.3g} x "
        f"max|value| ({mom[1]}); params within {ok_err[0]:.3g} x the rate "
        f"where sqrt(v_hat) > 100 eps ({ok_err[1]}; that mask covers at "
        f"least {share[0]:.4f} of a leaf, {share[1]}), {all_err[0]:.3g} x "
        f"everywhere ({all_err[1]}), {rel[0]:.3g} x max|value| ({rel[1]}); "
        f"{tg:.2f} s on the card (first call), "
        f"{tc:.2f} s on the CPU")
    expect(abs(lg - lc) <= TOL_TRAIN_METRIC * abs(lc), "train: loss differs")
    expect(abs(ng - nc) <= TOL_TRAIN_METRIC * abs(nc),
           "train: grad_norm differs")
    expect(mom[0] <= TOL_TRAIN_MOMENT, f"train: moment {mom[1]} differs by "
           f"{mom[0]} x its max |value|")
    expect(share[0] > TRAIN_MASK_SHARE, f"train: sqrt(v_hat) > 100 eps on "
           f"only {share[0]} of {share[1]}")
    expect(ok_err[0] <= TOL_TRAIN_PARAM[0] and all_err[0] <= TOL_TRAIN_PARAM[1],
           f"train: params differ by {ok_err} / {all_err} x the rate")
    expect(rel[0] <= 1e-3, f"train: {rel[1]} differs by {rel[0]} x its max "
           "|value|")


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


def check_decode(torch, F, ops, ref, sets, label, softcap=0.0, window=0,
                 iters=20):
    """flash_decode against its plain version on ``sets`` (tuples q, k, v,
    lens[, k_scale, v_scale]; parity on the first, timing rotated through
    all), with the library time (one SDPA call, softcap 0 and no int8
    only) and the bound from the visible rows."""
    def split(t):
        q, k, v, lens = t[:4]
        kw = {"softcap": softcap, "window": window}
        if len(t) > 4:
            kw.update(k_scale=t[4], v_scale=t[5])
        return q, k, v, lens, kw

    from repro_torch.kernels import cost, flash_decode

    q, k, v, lens, kw = split(sets[0])
    got = ops.decode_attention(q, k, v, lens, impl="cuda", **kw)
    want = ref.decode_attention_ref(q, k, v, lens, **kw)
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
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    lo = (lens - window).clamp_min(0) if window > 0 else torch.zeros_like(
        lens)
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
        expect(torch.allclose(lib_out.float(), want.float(), rtol=TOL_SDPA,
                              atol=TOL_SDPA),
               f"flash_decode {label}: SDPA disagrees with the plain version")
        lib_ms = time_rotating(torch, lib, sets, iters)
    rec = {
        "shape": f"B={b} H={h} Hkv={hkv} Dh={dh} S={s} "
                 f"{str(k.dtype).split('.')[-1]} softcap={softcap} "
                 f"window={window} visible={vis}",
        "max_abs_err": err, "max_abs_out": scale, "rtol": rtol, "atol": atol,
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
    the real per-device cells, (c) a 1x1 mesh against no mesh. Returns the
    real cells' launch counts by kernel."""
    dryrun_sweep()
    counts = dryrun_real(torch)
    mesh_1x1_phase(torch)
    return counts


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


def mesh_1x1_phase(torch):
    """(c) qwen3-4b at full width (bf16, seeded weights on the card): a
    prefill of ``MESH_ROWS`` x ``MESH_PROMPT`` and ``MESH_STEPS`` greedy
    decode steps with no mesh, then on a real 1x1 mesh (NCCL, a world of
    one: params and tokens DTensors through ``distribute_tree``,
    flash-decode through its ``local_map`` path): the logits of every step
    bit-equal, as one rank moves no data."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, sharding_overrides
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  sharding_scope)
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_model, model_specs

    t0 = time.perf_counter()
    cfg = get_config("qwen3-4b")
    params = init_model(cfg, torch.Generator("cuda").manual_seed(7), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (MESH_ROWS, MESH_PROMPT),
                           generator=torch.Generator("cuda").manual_seed(8),
                           device="cuda", dtype=torch.int32)

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def run(p, place):
        logits, cache = make_prefill_step(
            cfg, max_len=MESH_PROMPT + MESH_STEPS)(p, {"tokens": place(
                tokens)})
        outs, decode = [full(logits)], make_decode_step(cfg)
        for _ in range(MESH_STEPS):
            tok = outs[-1][:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = decode(p, cache, place(tok))
            outs.append(full(logits))
        return outs

    plain = run(params, lambda x: x)
    expect(not dist.is_initialized(), "a process group before the 1x1 mesh")
    init_world(device="cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        before = flash_decode.launches
        with sharding_scope(mesh, **sharding_overrides(cfg.name)):
            meshed = run(distribute_tree(params, model_specs(cfg),
                                         src_data_rank=None),
                         lambda x: distribute_tree(
                             x, ("batch",) + (None,) * (x.dim() - 1),
                             src_data_rank=None))
        launched = flash_decode.launches - before
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(plain, meshed)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(plain, meshed))
    expect(all(equal), f"1x1 mesh: logits not bit-equal to no mesh "
           f"({equal}, max abs diff {err})")
    expect(launched == cfg.n_layers * MESH_STEPS,
           f"1x1 mesh: {launched} flash-decode launches, want "
           f"{cfg.n_layers * MESH_STEPS}")
    log(f"1x1 mesh (NCCL, world 1): qwen3-4b full width, {MESH_ROWS} x "
        f"{MESH_PROMPT} prefill + {MESH_STEPS} steps: logits bit-equal to "
        f"no mesh at all {len(equal)} steps; {launched} flash-decode "
        f"launches on the mesh; {time.perf_counter() - t0:.1f} s")
    del params, plain, meshed
    torch.cuda.empty_cache()


def dryrun_decode_shape(torch, F, ops, ref, dev="cuda"):
    """flash-decode at the per-device shape the dry run's real decode cell
    launched it at (``DRYRUN_DECODE_SHAPE``): qwen3-4b decode_32k on the
    single pod (8 rows of its 128, the rank's 2 query heads and their one
    KV head, the cache's 32,768 positions gathered whole, every row
    full), bf16."""
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
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import (build, ellmean, flash_decode, hindex,
                                     ops, ref, sgns, topk)

    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled: {', '.join(sorted(logs)) or 'cached'})")

    counters = Counters({
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
    dryrun_counts = {key: 0 for key in counters.table}
    dryrun_counts.update(dryrun_phase(torch))
    large_rec["decode_attention"].append(
        dryrun_decode_shape(torch, F, ops, ref))
    b, k, d, _ = DRYRUN_SGNS_SHAPE
    graph = check_sgns(torch, ref, sgns, b, k, d, torch.float32,
                       "dryrun deepwalk-web1b per device")
    for name in ("sgns_fwd", "sgns_bwd"):
        large_rec[name].append(graph[name])

    keys = ("max_abs_err", "ms", "loop_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "x_bound", "x_library", "shape")
    kernels = []
    paths = (serve_counts, hub_counts, resil_counts, offline_counts,
             *lm_counts.values(), train_counts, dryrun_counts)
    for name, (src_path, replaces) in SOURCES.items():
        by_path = {"serve": serve_counts[name], "hub": hub_counts[name],
                   "resilience": resil_counts[name],
                   "offline": offline_counts[name],
                   **{path: c[name] for path, c in lm_counts.items()},
                   "train": train_counts[name],
                   "dryrun": dryrun_counts[name]}
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
