"""The mamba block split by heads over the model axis (``models.mamba2.
_by_heads``), as the JAX package's rule splits the SSD's input
("batch", "seq", "ssm_heads", None): the reduced mamba2-2.7b (16 heads in
2 groups) on gloo meshes of CPU ranks against the unsharded port and the
JAX package (``torch_mesh_cases.check_family``: loss, every gradient,
prefill, its cache, 4 greedy decode steps and the final cache; fp32,
rtol = atol = 1e-5 against the unsharded port). On 2x2 each of the two
model ranks holds one whole group (8 heads); on 1x8 one group spans four
ranks of 2 heads each, so the gated norm sums each group's squares across
them. Every ``ssd_chunked`` call and every decode step on every rank sees
the rank's h / n heads. And the rematerialised blocks' backward run on
another thread, with no sharding scope bound, as a card's autograd engine
runs it (mamba2-2.7b and zamba2-7b on 1x4): the same gradients.
"""
import pytest
import torch

from repro_torch.configs import get_config
from torch_mesh_cases import check_family
from torch_mesh_workers import spawn, ssd_heads_worker, thread_backward_worker


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 8)])
def test_mamba_split_by_heads_matches(mesh_shape, tmp_path):
    got = check_family("mamba2-2.7b", tmp_path, mesh_shape=mesh_shape,
                       worker=ssd_heads_worker)
    s = get_config("mamba2-2.7b").reduced().ssm
    h = s.n_heads(128)
    assert (h, s.n_groups) == (16, 2)
    per = h // mesh_shape[1]
    assert got["ssd_heads"] == [[("chunked", per), ("step", per)]] * (
        mesh_shape[0] * mesh_shape[1])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_backward_on_the_engine_s_thread_matches(arch, tmp_path):
    """On a card the autograd engine runs the backward, and so each
    rematerialised block's recomputation, on its device thread, where the
    sharding scope (a context variable) is not bound: the block must take
    the same by-heads path there. The reduced model (full remat) on a 1x4
    gloo mesh, its backward run on another thread: the same gradients as
    on the calling thread, bit for bit."""
    path = str(tmp_path / "grads.pt")
    spawn(thread_backward_worker, 4, arch, (1, 4), path, timeout=120)
    here, there = torch.load(path)
    assert len(here) == len(there)
    for i, (a, b) in enumerate(zip(here, there)):
        assert torch.equal(a, b), (arch, i, float((a - b).abs().max()))
