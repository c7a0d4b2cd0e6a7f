"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch and ``nvcc``:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: the ELL mean 1e-5 in fp32 and 2e-2 in bf16 (summation order),
the h-index exact, the top-k scores at 1e-5 with ids equal off near-ties
(fp32 dot products of width d summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ellmean, hindex, ops, ref, topk

ELL_CASES = [(8, 4, 16, 128), (16, 7, 32, 128), (5, 3, 8, 150),
             (12, 1, 4, 256), (64, 1766, 37701, 128)]
H_CASES = [(1, 1), (3, 5), (17, 130), (200, 7), (1000, 2048), (4096, 32)]
TOPK_CASES = [(1, 1, 1, 1), (4, 100, 16, 5), (8, 1024, 32, 10),
              (3, 7, 8, 10), (17, 513, 130, 13), (64, 37701, 128, 11),
              (130, 5000, 64, 32), (5, 300, 16, 33), (64, 37701, 128, 75),
              (3, 50, 8, 70), (9, 2000, 40, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,m,d", ELL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_mean_kernel_matches_plain(cuda, n, l, m, d, dtype):
    rng = np.random.default_rng(n + l)
    idx, valid, emb = _on(cuda, rng.integers(0, m, (n, l)).astype(np.int32),
                          rng.random((n, l)) < 0.7,
                          rng.standard_normal((m, d)).astype(np.float32))
    emb = emb.to(dtype)
    before = ellmean.launches
    got = ops.ell_mean(idx, valid, emb)  # auto: the kernel on the card
    assert ellmean.launches == before + 1 and got.dtype == dtype
    want = ref.ell_mean_ref(idx, valid, emb)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("r,w", H_CASES)
def test_h_index_kernel_matches_plain(cuda, r, w):
    rng = np.random.default_rng(r * 31 + w)
    vals, valid, est = _on(cuda, rng.integers(0, 40, (r, w)).astype(np.int32),
                           rng.random((r, w)) < 0.6,
                           rng.integers(0, 45, r).astype(np.int32))
    before = hindex.launches
    got = ops.h_index_sweep(vals, valid, est)
    assert hindex.launches == before + 1
    assert torch.equal(got, ref.h_index_ref(vals, valid, est))
    assert torch.equal(got, ref.h_index_count(vals, valid, est))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d,k", TOPK_CASES)
def test_topk_kernel_matches_plain(cuda, nq, n, d, k):
    rng = np.random.default_rng(nq * 7 + n)
    q, table, valid = _on(cuda, rng.normal(size=(nq, d)).astype(np.float32),
                          rng.normal(size=(n, d)).astype(np.float32),
                          rng.random(n) < 0.8)
    before = topk.launches
    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid)
    assert topk.launches == before + 2 * -(-k // topk.ROUND_K)
    want_v, want_i = (x.cpu().numpy() for x in
                      ref.topk_ref(q, table, k + 1, valid=valid))
    got_v, got_i = got_v.cpu().numpy(), got_i.cpu().numpy()
    tol = 1e-5 * max(1.0, float(np.sqrt(d)))
    np.testing.assert_allclose(got_v, want_v[:, :k], rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):  # -inf padding
        gap = np.abs(np.diff(want_v, axis=1)) <= tol
    near = np.zeros(want_v.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not ((got_i != want_i[:, :k]) & ~near[:, :k]).any()


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ellmean.ell_mean_cuda(x.long(), x.bool(), x)
    with pytest.raises(ValueError, match="contiguous"):
        hindex.h_index_cuda(x.int().T, x.bool().T, x[:, 0].int())
    with pytest.raises(ValueError, match="k must be"):
        topk.topk_cuda(x, x, x[:, 0].contiguous(), 0)


@pytest.mark.cuda
def test_service_on_the_card_matches_the_cpu(cuda):
    from repro_torch.graph import generators
    from repro_torch.launch.serve_embed import build_service

    g = generators.barabasi_albert_varying(300, 4.0, seed=3)
    built = [build_service(g, stream_frac=0.3, dim=32, batch=16, device=d)
             for d in ("cuda", "cpu")]
    svcs = [b[0] for b in built]
    stream = built[0][1]
    rng = np.random.default_rng(5)
    for start in range(0, len(stream), 32):
        acc = [s.ingest_block(stream[start:start + 32]) for s in svcs]
        np.testing.assert_array_equal(acc[0], acc[1])
        drop = acc[0][rng.permutation(len(acc[0]))[:3]]
        for s in svcs:
            s.retract_block(drop)
        np.testing.assert_array_equal(svcs[0].cores.core, svcs[1].cores.core)
    assert svcs[0].cores.phase_impl["descend"] == "fused[cuda]"
    nodes = rng.integers(0, svcs[0].graph.n_nodes, 48)
    np.testing.assert_allclose(svcs[0].embed(nodes), svcs[1].embed(nodes),
                               rtol=1e-5, atol=1e-5)
    for k in (10, 40):  # one round of the kernel, then two
        (_, s_gpu), (_, s_cpu) = (s.top_k_neighbors(nodes, k) for s in svcs)
        np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)
