"""The port on real meshes of CPU ranks (gloo, ``torch.multiprocessing``):
``launch/train --mesh`` against the one-device run and across meshes, the
layout of a dim split over two mesh axes, and the dense and MoE families
sharded against themselves unsharded and against the JAX package
(``torch_mesh_cases.check_family``: loss, every gradient, prefill, 4
greedy decode steps and the caches; fp32, rtol = atol = 1e-5 against the
unsharded port), and the SGNS loss and flash-decode on each rank's own
shards against their unsharded runs. The launcher's optimizer state,
built on each rank's shards, against the whole-tree init it replaced.
Each test spawns its ranks once, with a deadline.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train
from torch_mesh_cases import check_family
from torch_mesh_workers import (DECODE_CASES, bitwise_worker,
                                kernels_worker, placement_worker, spawn,
                                state_init_worker, train_worker)
from repro_torch.train.tree import leaf_paths

LAUNCH = ["--arch", "qwen3-4b", "--preset", "reduced", "--device", "cpu",
          "--batch", "4", "--seq", "32", "--ckpt-every", "100"]


def test_train_mesh_2x2_matches_one_device_and_resumes_on_1x4(tmp_path):
    """3 steps on a 2x2 mesh give the one-device run's losses (rtol = atol
    = 1e-5); the 2x2 run's checkpoint (whole tensors) resumes on a 1x4
    mesh for 2 more steps, and those losses are the one-device run's
    resumed from its own step-3 checkpoint."""
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    want = train.main(LAUNCH + ["--steps", "3", "--ckpt-dir", str(one)])
    want += train.main(LAUNCH + ["--steps", "5", "--ckpt-dir", str(one)])
    out = str(tmp_path / "losses.pt")
    spawn(train_worker, 4, LAUNCH + ["--mesh", "2x2", "--steps", "3",
                                     "--ckpt-dir", str(mesh)], out,
          timeout=120)
    got = torch.load(out)
    spawn(train_worker, 4, LAUNCH + ["--mesh", "1x4", "--steps", "5",
                                     "--ckpt-dir", str(mesh)], out,
          timeout=120)
    got += torch.load(out)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nemotron_train_steps_on_1x4_match_one_device(tmp_path):
    """Reduced nemotron-4-15b (squared ReLU, LayerNorm, RoPE on half of
    each head, an untied unembedding) trained 3 steps by the launcher on
    1x4 under its rules, as the four-card cell lays it out (heads, MLP and
    vocabulary split four ways): the one-device run's losses, each after
    the sharded AdamW updates before it (rtol = atol = 1e-5)."""
    flags = ["--arch", "nemotron-4-15b", "--preset", "reduced", "--device",
             "cpu", "--batch", "4", "--seq", "32", "--ckpt-every", "100",
             "--steps", "3"]
    want = train.main(flags + ["--ckpt-dir", str(tmp_path / "one")])
    out = str(tmp_path / "losses.pt")
    spawn(train_worker, 4, flags + ["--mesh", "1x4", "--ckpt-dir",
                                    str(tmp_path / "mesh")], out,
          timeout=120)
    got = torch.load(out)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_mesh_must_fill_the_world():
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--steps", "1", "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--steps", "1", "--mesh", "2x2x2x2"])
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--steps", "1", "--mesh", "1x1",
                             "--compress-grads"])


def test_dim_split_over_pod_and_data_is_major_to_minor(tmp_path):
    """("pod", "data") on one dim: rank (p, d, 0) of a (2, 2, 1) mesh holds
    block p * 2 + d of the rows, as JAX lays out a dim over an axis
    tuple."""
    out = str(tmp_path / "rows.pt")
    spawn(placement_worker, 4, out, timeout=60)
    x = torch.arange(8 * 3).reshape(8, 3)
    got = torch.load(out)
    assert sorted(c for c, _ in got) == [(p, d, 0) for p in (0, 1)
                                         for d in (0, 1)]
    for (p, d, _), rows in got:
        blk = p * 2 + d
        assert torch.equal(rows, x[2 * blk:2 * blk + 2])


def test_one_rank_mesh_is_bitwise_the_unsharded_run(tmp_path):
    """On a 1x1 mesh no collective moves data: a bf16 prefill and 8 greedy
    decode steps give the unsharded run's logits bit for bit."""
    out = str(tmp_path / "eq.pt")
    spawn(bitwise_worker, 1, out, timeout=60)
    assert torch.load(out) == [True] * 9


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_family_sharded_on_2x2_matches(arch, tmp_path):
    check_family(arch, tmp_path)


def test_kernels_on_each_rank_s_shards_match_unsharded(tmp_path):
    """On a 2x2 (data, model) mesh: the SGNS loss and both tables'
    gradients, the tables and the pairs split over both axes (the graph
    cell's layout), equal the unsharded run's (fp32, rtol = atol = 1e-5),
    and the looked-up rows come out split as the pairs (8 of 32 a rank:
    the kernel runs on each rank's own pairs). flash-decode with the cache
    split along its sequence (rows whose visible range misses a rank's
    half included): each case equals the unsharded run's, and the output
    keeps q's heads split (each rank combines the partial outputs of
    every head and keeps its own), H = 6 on 3 KV heads too."""
    out = str(tmp_path / "kernels.pt")
    spawn(kernels_worker, 4, out, timeout=90)
    got = torch.load(out, weights_only=False)
    for g, w in zip(got["sgns_got"], got["sgns_want"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    pl, local = got["rows_layout"]
    assert [str(p) for p in pl] == ["S(0)", "S(0)"] and local == (8, 3, 16)
    layouts = []
    for (H, Hkv, _), (want, dec, placements) in zip(DECODE_CASES,
                                                     got["decode"]):
        np.testing.assert_allclose(dec.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"H={H} Hkv={Hkv}")
        layouts.append(placements)
    assert layouts == [["S(0)", "S(1)"]] * 4


@pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b"])
def test_train_mesh_builds_optimizer_state_on_each_rank_s_shards(arch,
                                                                 tmp_path):
    """3 steps of the launcher on 2x2 (qwen3-4b: AdamW; grok-1-314b:
    adafactor, its factored row and column moments) leave the params and
    the optimizer state bit-equal to the same steps from the whole-tree
    init (``opt.init`` of the whole params, then distributed), and the
    state's init allocates each leaf's local shard on the rank and nothing
    else: no tensor of a split leaf's whole size."""
    path = str(tmp_path / "state.pt")
    argv = ["--arch", arch, "--preset", "reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--steps", "3", "--mesh", "2x2",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "100"]
    spawn(state_init_worker, 4, argv, path, timeout=150)
    out = torch.load(path, weights_only=False)
    seen = out["seen"]
    assert sorted(seen["allocs"]) == sorted(seen["local"])
    split = {w for w, loc in zip(seen["whole"], seen["local"]) if w != loc}
    assert split and not split & set(seen["allocs"])
    got, want = dict(leaf_paths(out["got"])), dict(leaf_paths(out["want"]))
    assert got.keys() == want.keys()
    assert any("vc" in name for name in want) == (arch == "grok-1-314b")
    for name, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[name], w), name
        else:
            assert int(got[name]) == int(w), name
