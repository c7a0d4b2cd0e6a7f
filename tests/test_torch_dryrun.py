"""The port's dry run (``launch/dryrun.py``) on the CPU, in subprocesses
(one fake process group of 256 or 512 ranks each; the test process starts
none), mirroring the JAX package's dry-run tests; its per-device FLOPs
held to the unsharded step's; the committed sweep; and the
encoder-decoder and vision families sharded on real CPU ranks, plus the
decode whose KV heads do not divide the model axis (the cache split along
its sequence, ``kv_seq``), against the unsharded port and the JAX package
(``torch_mesh_cases.check_family``).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.transformer import init_model
from torch_mesh_cases import check_family

SWEEP = "results/dryrun_torch.json"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath("src")
    return env


def _run_cells(tmp_path, arch, shapes, mesh, extra=()):
    out = tmp_path / "dr.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--mesh", mesh, "--arch", arch, "--shape", shapes, "--out",
         str(out), *extra],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with open(out) as f:
        return json.load(f)


def test_importing_the_dry_run_starts_no_group():
    """The module starts its fake group in ``main`` only, and sets no
    device flag on import (the JAX package's forces 512 host devices)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun  # noqa: F401
    assert not dist.is_initialized()
    assert "=512" not in os.environ.get("XLA_FLAGS", "")


def test_dryrun_decode_cell_single_pod(tmp_path):
    (rec,) = _run_cells(tmp_path, "mamba2-2.7b", "decode_32k", "single")
    assert rec["status"] == "ok"
    assert rec["flops"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["code_bytes"] is None
    assert sum(rec["collective_counts"].values()) > 0


def test_dryrun_multi_pod_mesh_shards_pod_axis(tmp_path):
    (rec,) = _run_cells(tmp_path, "mamba2-2.7b", "train_4k", "multi")
    assert rec["status"] == "ok"
    # the pod axis is pure data parallelism: the gradient all-reduce exists
    assert rec["collective_bytes"]["all-reduce"] > 0
    # the train step updates params and optimizer state in place
    assert rec["memory"]["alias_bytes"] > 0


def test_dryrun_skips_long500k_for_full_attention(tmp_path):
    (rec,) = _run_cells(tmp_path, "qwen3-4b", "long_500k", "single")
    assert rec["status"] == "skip"
    assert "sub-quadratic" in rec["reason"]


def _sgns_flops_per_pair():
    """FLOPs a (center, context, 5 negatives) pair of dim 128 costs the
    unsharded SGNS step (loss and both tables' gradients), counted by the
    dry run's ``Tally`` on 64 pairs."""
    import torch

    from repro_torch.launch.dryrun import Tally
    from repro_torch.skipgram.model import batch_loss

    gen = torch.Generator().manual_seed(0)
    V, D, K, B = 64, 128, 5, 64
    ws = {k: torch.randn((V, D), generator=gen).requires_grad_()
          for k in ("emb_in", "emb_out")}
    c, x = (torch.randint(0, V, (B,), generator=gen) for _ in "cx")
    n = torch.randint(0, V, (B, K), generator=gen)
    with Tally() as tally:
        loss = batch_loss(ws, c, x, n)
        torch.autograd.grad(loss, list(ws.values()))
    return tally.flops / B


def test_dryrun_graph_cell(tmp_path):
    """The graph cell on both meshes: the argument bytes of its 256-way
    layout, and the SGNS work of its own pairs alone on each device
    (2^20 / 256 = 4,096; the pod axis replicates): per-device FLOPs are
    1/256 of the unsharded step's, within 1%."""
    recs = _run_cells(tmp_path, "deepwalk-web1b", "train_4k", "both")
    assert sorted(r["mesh"] for r in recs) == ["multi", "single"]
    whole = _sgns_flops_per_pair() * (1 << 20)
    for rec in recs:
        assert rec["status"] == "ok" and rec["flops"] > 0
        # the two 2^27 x 128 fp32 tables and their Adam moments, split 256
        # ways, the pair batch 2^20 / 256, and the two int32 counts
        table = (1 << 27) * 128 * 4 // 256
        batch = (1 << 20) // 256 * (1 + 1 + 5) * 4
        assert rec["memory"]["argument_bytes"] == 6 * table + batch + 2 * 4
        assert abs(rec["flops"] * 256 - whole) <= 0.01 * whole


def test_real_runs_note_the_kernels_local_shapes():
    """``--real`` notes the shape each flash-decode and SGNS launch takes
    (the launchers are wrapped only while the counted step runs; here on
    the CPU each launcher raises after its shape is noted)."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import sgns as sg
    from repro_torch.launch.dryrun import _launch_shapes

    launchers = (fd.decode_attention_cuda, sg.sgns_fwd_cuda,
                 sg.sgns_bwd_cuda)
    c = torch.zeros((6, 16))
    n = torch.zeros((6, 3, 16))
    q = torch.zeros((2, 4, 32), dtype=torch.bfloat16)
    k = torch.zeros((2, 40, 2, 32), dtype=torch.int8)
    lens = torch.ones(2, dtype=torch.int32)
    with _launch_shapes() as shapes:
        for call in (lambda: sg.sgns_fwd_cuda(c, c, n),
                     lambda: sg.sgns_bwd_cuda(c, c, n, c[:, 0]),
                     lambda: fd.decode_attention_cuda(q, k, k, lens, lens)):
            with pytest.raises(Exception):
                call()
    assert shapes == {"sgns_fwd": {(6, 3, 16, "float32")},
                      "sgns_bwd": {(6, 3, 16, "float32")},
                      "flash_decode": {(2, 4, 2, 32, 40, "int8")}}
    assert (fd.decode_attention_cuda, sg.sgns_fwd_cuda,
            sg.sgns_bwd_cuda) == launchers


_FLOPS = textwrap.dedent("""
    import json, sys, torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.distributed.sharding import local_tree, sharding_scope
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.models.transformer import init_model, model_specs
    from repro_torch.configs.shapes import batch_logical_names
    cfg = get_config("qwen3-4b").reduced()
    params = init_model(cfg, None, device="meta")
    (batch,) = input_specs(cfg, ShapeSpec("p", "prefill", 64, 4))
    step = make_prefill_step(cfg)
    with dryrun.Tally() as whole:
        step(params, batch)
    init_world(fake_world=4)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    with sharding_scope(mesh):
        p = local_tree(params, model_specs(cfg), meta)
        b = local_tree(batch, batch_logical_names(cfg, train=False), meta)
        with dryrun.Tally() as part:
            step(p, b)
    print(json.dumps([whole.flops, part.flops]))
""")


def test_per_device_flops_times_world_is_the_unsharded_step(tmp_path):
    """The reduced qwen3-4b prefill (B 4, S 64) on a fake 2x2 mesh, where
    every matmul splits (4 heads, 4 KV heads, the MLP and the vocabulary
    over 2, the batch over 2): per-device FLOPs x 4 = the unsharded
    step's, within 1%."""
    script = tmp_path / "flops.py"
    script.write_text(_FLOPS)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    whole, part = json.loads(proc.stdout.strip().splitlines()[-1])
    assert whole > 0
    assert abs(part * 4 - whole) <= 0.01 * whole


def _visible_pairs(S, cq, ckv):
    """Query-key pairs in the causal attention's processed blocks
    (``attention_chunked`` skips a block only when every key follows every
    query)."""
    return sum(cq * ckv for q0 in range(0, S, cq)
               for k0 in range(0, S, ckv) if k0 <= q0 + cq - 1)


def test_committed_prefill_flops_are_2NT_plus_attention():
    """qwen3-4b prefill_32k on the single pod: per-device FLOPs x 256
    within 15% of 2 N T + 4 B H Dh L P + 2 B d V, where N is the layers'
    parameter count, T = B S the tokens, P the visible query-key pairs of
    the chunked causal attention (QK^T and PV, 2 FLOPs a multiply-add)
    and the last term the last position's logits."""
    if not os.path.exists(SWEEP):
        pytest.skip("the sweep has not been committed in this checkout")
    with open(SWEEP) as f:
        (rec,) = [r for r in json.load(f) if (r["arch"], r["shape"],
                  r["mesh"]) == ("qwen3-4b", "prefill_32k", "single")]
    cfg, shape = get_config("qwen3-4b"), SHAPES["prefill_32k"]
    B, S = shape.global_batch, shape.seq_len
    params = init_model(cfg, None, device="meta")
    N = sum(x.numel() for x in _leaves(params["layers"]))
    pairs = _visible_pairs(S, cfg.attn_chunk_q, cfg.attn_chunk_kv)
    want = (2 * N * B * S
            + 4 * B * cfg.n_heads * cfg.head_dim * cfg.n_layers * pairs
            + 2 * B * cfg.d_model * cfg.vocab_size)
    got = rec["flops"] * 256
    assert abs(got - want) <= 0.15 * want, (got, want)


def test_jax_dry_run_counts_a_scanned_layer_once():
    """The JAX dry run's ``flops`` are XLA's ``cost_analysis``, which
    counts a scan's body once; the port counts every layer. The reduced
    qwen3-4b prefill (4 layers, B 2, S 128, no mesh): the JAX count is
    under a third of the port's, and the port's is within 10% of 2 N T +
    4 B H Dh L P (N the layers' parameters, P the visible pairs)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jget_config
    from repro.models import steps as jsteps
    from repro.models import transformer as jtf
    from repro_torch.launch.dryrun import Tally
    from repro_torch.models.steps import make_prefill_step

    B, S = 2, 128
    jcfg, cfg = jget_config("qwen3-4b").reduced(), \
        get_config("qwen3-4b").reduced()
    avals = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    compiled = jax.jit(jsteps.make_prefill_step(jcfg)).lower(
        avals, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    params = init_model(cfg, None, device="meta")
    with Tally() as tally:
        make_prefill_step(cfg)(params, {"tokens": torch.empty(
            (B, S), dtype=torch.int32, device="meta")})
    N = sum(x.numel() for x in _leaves(params["layers"]))
    pairs = _visible_pairs(S, min(cfg.attn_chunk_q, S),
                           min(cfg.attn_chunk_kv, S))
    want = 2 * N * B * S + 4 * B * cfg.n_heads * cfg.head_dim * \
        cfg.n_layers * pairs
    assert cost["flops"] < tally.flops / 3
    assert abs(tally.flops - want) <= 0.1 * want, (tally.flops, want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_full_sweep_results_are_green():
    """The committed sweep covers every (arch, shape, mesh) cell of the
    JAX package's sweep plus the graph cell on both meshes, with no
    failure, its skip set (the full-attention archs at long_500k) and
    FLOPs on every cell that ran."""
    if not os.path.exists(SWEEP):
        pytest.skip("the sweep has not been committed in this checkout")
    with open(SWEEP) as f:
        recs = json.load(f)
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    want = {(a, s, m) for a in REGISTRY for s in SHAPES
            for m in ("single", "multi")}
    want |= {("deepwalk-web1b", "train_4k", m) for m in ("single", "multi")}
    assert set(got) == want
    assert not [k for k, r in got.items() if r["status"] == "fail"]
    skips = {k for k, r in got.items() if r["status"] == "skip"}
    assert skips == {(a, "long_500k", m) for a in REGISTRY
                     for m in ("single", "multi")
                     if get_config(a).family not in ("ssm", "hybrid")}
    assert all(r["flops"] > 0 for r in got.values() if r["status"] == "ok")


# the single pod's all-gather GB a decode_32k step, where the cache is
# split along its sequence, while flash-decode gathered it whole (the
# sweep committed before the partial-softmax combine)
GATHERED_DECODE_GB = {"qwen3-4b": 38.655, "gemma2-2b": 27.918,
                      "grok-1-314b": 70.306, "nemotron-4-15b": 34.36,
                      "starcoder2-7b": 17.18, "qwen2-vl-7b": 15.033}
# the SSM cells' temp GiB a device while the mamba block ran by rows
BY_ROWS_TEMP_GIB = {("mamba2-2.7b", "train_4k"): 56.49,
                    ("zamba2-7b", "train_4k"): 371.04,
                    ("mamba2-2.7b", "prefill_32k"): 28.47,
                    ("zamba2-7b", "prefill_32k"): 36.43}


def test_committed_sweep_splits_the_model_axis():
    """The committed sweep moves no cache gather and splits the SSD by
    heads. Every decode_32k cell whose KV cache is split along its
    sequence (its KV heads do not divide the model axis), on both meshes:
    the device's slice holds S / 16 positions, and no all-gather call is
    as large as one layer's K on the device gathered whole along S (the
    port's call before the combine; ``collective_largest``; grok-1-314b's
    largest, 96 MiB, gathers FSDP weights); on the single pod the step's
    all-gather at most 0.5 GB for qwen3-4b and 1/20 of the gathered
    cache's (``GATHERED_DECODE_GB``) for the rest. The SSM
    cells (``BY_ROWS_TEMP_GIB``): train_4k temp at most 35 GiB (mamba2)
    and 100 GiB (zamba2), prefill_32k at most half of the by-rows temp."""
    from repro_torch.distributed.sharding import (MeshShape, local_shape,
                                                  sharding_scope, spec_for)
    from repro_torch.launch.dryrun import cell_overrides
    from repro_torch.models.transformer import cache_specs, init_cache

    if not os.path.exists(SWEEP):
        pytest.skip("the sweep has not been committed in this checkout")
    with open(SWEEP) as f:
        got = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    meshes = {"single": MeshShape((16, 16), ("data", "model")),
              "multi": MeshShape((2, 16, 16), ("pod", "data", "model"))}
    split = [a for a in REGISTRY if "k" in cache_specs(get_config(a))
             and "kv_seq" in cell_overrides(a, "decode_32k")]
    assert sorted(split) == sorted(GATHERED_DECODE_GB)
    for arch in split:
        cfg = get_config(arch)
        shape = SHAPES["decode_32k"]
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        for name, mesh in meshes.items():
            with sharding_scope(mesh, **cell_overrides(arch, "decode_32k")):
                names = cache_specs(cfg)["k"]
                local = local_shape(cache["k"].shape,
                                    spec_for(cache["k"].shape, names), mesh)
            assert local[2] == shape.seq_len // 16, (arch, name, local)
            gathered = shape.seq_len * cache["k"].element_size()
            for n in (local[1], *local[3:]):
                gathered *= n
            ag = got[(arch, "decode_32k", name)]["collective_largest"][
                "all-gather"]
            assert ag < gathered, (arch, name, ag, gathered)
        ag = got[(arch, "decode_32k", "single")]["collective_bytes"][
            "all-gather"] / 1e9
        bound = 0.5 if arch == "qwen3-4b" else GATHERED_DECODE_GB[arch] / 20
        assert ag <= bound, (arch, ag, bound)
    bounds = {"train_4k": {"mamba2-2.7b": 35.0, "zamba2-7b": 100.0}}
    for (arch, shape), before in BY_ROWS_TEMP_GIB.items():
        temp = got[(arch, shape, "single")]["memory"]["temp_bytes"] / 2**30
        bound = bounds.get(shape, {}).get(arch, before / 2)
        assert temp <= bound, (arch, shape, temp, bound)


# the single pod's train_4k temp GiB a device while the heads-indivisible
# archs gathered their split query sequence for attention and grok-1-314b
# left its expert products to DTensor (the sweep before the train cells
# were laid out as the JAX package lays them out), and the bound each
# holds now: the JAX package's dry run reads 16.15, 14.62, 9.84 and 21.65
GATHERED_TRAIN_TEMP_GIB = {"starcoder2-7b": (81.34, 24.0),
                           "qwen2-vl-7b": (64.80, 22.0),
                           "gemma2-2b": (33.59, 15.0),
                           "grok-1-314b": (784.66, 32.0)}


def test_committed_sweep_lays_out_the_train_cells():
    """The committed sweep's single-pod train_4k cells of the three
    heads-indivisible archs (attention on each rank's own query rows) and
    of grok-1-314b (its expert products on each rank's 2D shards) within
    their bounds (``GATHERED_TRAIN_TEMP_GIB``), on both meshes ok."""
    if not os.path.exists(SWEEP):
        pytest.skip("the sweep has not been committed in this checkout")
    with open(SWEEP) as f:
        got = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    for arch, (before, bound) in GATHERED_TRAIN_TEMP_GIB.items():
        assert all(got[(arch, "train_4k", m)]["status"] == "ok"
                   for m in ("single", "multi"))
        temp = got[(arch, "train_4k", "single")]["memory"]["temp_bytes"]
        assert temp / 2**30 <= bound < before, (arch, temp / 2**30, bound)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-7b"])
def test_family_sharded_on_2x2_matches(arch, tmp_path):
    check_family(arch, tmp_path)


def test_decode_with_the_cache_split_along_its_sequence(tmp_path):
    """The reduced qwen3-4b on a 1x8 mesh: its 4 KV heads do not divide
    the 8-way model axis, so the cache is split along its sequence
    (``kv_seq``): flash-decode runs on each rank's own positions and the
    partial outputs are combined by their log-sum-exps (``ops.
    decode_attention``; 24 positions, 3 a rank: the last rank holds no
    visible position of the 20-token prompts until the decode reaches
    it), and each rank writes the new token only into its own slice."""
    got = check_family("qwen3-4b", tmp_path, mesh_shape=(1, 8),
                       serve_overrides={"kv_seq": ("model",)})
    assert got["k_placements"] == ["R", "S(2)"]  # (L, B, S, Hkv, Dh)
