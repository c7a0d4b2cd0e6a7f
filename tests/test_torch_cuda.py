"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports neither JAX nor the JAX
package, so it runs on a machine with only PyTorch and ``nvcc``:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: the SGNS loss and gradients 1e-5 in fp32 and 2e-2 in bf16
(fp32 dots summed in another order, then one bf16 rounding; at K = 2,048
also against the fp64 formulas, and against the plain versions scaled by
their largest magnitude, as their fp32 sums of 2,048 terms drift), the ELL
mean 1e-5 in fp32 and 2e-2 in bf16 (summation order), the h-index exact
(at every width, hub rows included; the chunked descent on the card against
the CPU's counting search), the top-k scores at 1e-5 with ids
equal off near-ties
(fp32 dot products of width d summed in another order), flash-decode 2e-5
with fp32 queries (fp32 or int8 cache) and rtol 1e-2 + atol 1e-3 with bf16
ones (one bf16 rounding of the same fp32 result; int8 caches as their
queries) and its log-sum-exp rtol 1e-5 + atol 1e-4 (fp32 logits summed in
another order), the LM decode step on the card against the CPU
1e-4 (logits) and 1e-5 (caches), with an int8 cache one quantisation step
and 1e-2 (logits); the reduced MoE, SSM and hybrid models served on the
card against the CPU: token streams equal, logits 1e-4; the reduced
encoder-decoder and vision models' prefill and 8 decode steps on the card
against the CPU: tokens equal, logits 1e-4; one LM train step on the card against the CPU
(reduced qwen3-4b, and each family of ``TRAIN_FAMILIES`` with its config's
optimizer, grok-1-314b's adafactor included): the metrics 1e-5, the
moments 1e-4 x their largest magnitude, the params 1e-3 x the rate where
the optimizer does not amplify a gradient's rounding (``held_entries``);
checkpointed card tensors bit for bit, restored in place. Each kernel
wrapper's cost tally (``kernels.cost``) holds exactly the bytes and
operations ``chip_smoke.py`` bounds the call by, and ``obs.compiled_cost``
of a lone ``ops.ell_mean`` counts them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (ellmean, flash_decode, hindex, ops, ref,
                                 sgns, topk)

ELL_CASES = [(8, 4, 16, 128), (16, 7, 32, 128), (5, 3, 8, 150),
             (12, 1, 4, 256), (64, 1766, 37701, 128),
             # few long rows: the row-split kernel (a block per row)
             (1, 1766, 37701, 128), (3, 5000, 1000, 128),
             (64, 5000, 37701, 128), (3, 1766, 500, 150),
             (3, 1766, 500, 256), (2, 300, 100, 600)]
H_CASES = [(1, 1), (3, 5), (17, 130), (200, 7), (1000, 2048), (4096, 32)]
TOPK_CASES = [(1, 1, 1, 1), (4, 100, 16, 5), (8, 1024, 32, 10),
              (3, 7, 8, 10), (17, 513, 130, 13), (64, 37701, 128, 11),
              (130, 5000, 64, 32), (5, 300, 16, 33), (64, 37701, 128, 75),
              (3, 50, 8, 70), (9, 2000, 40, 128), (64, 37701, 128, 100),
              (64, 20000, 128, 128), (64, 20000, 128, 129),
              (64, 37701, 128, 300), (70, 9000, 150, 300), (2, 600, 33, 129)]
# h-index with scattered (not left-packed) masks: (R, W)
H_SCATTER = [(300, 33), (64, 2049), (40, 5000), (2000, 32), (500, 2048)]


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


def _sparse_ell(dev, n, l, m, d, dtype, seed):
    """ELL rows as the serving flush and the propagation give them: each
    row's valid slots first (its degree), some of them not resident; row 0
    has none, row 2 (if any) every slot."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, n)
    deg[0] = 0
    if n > 2:
        deg[2] = l
    valid = (np.arange(l)[None, :] < deg[:, None]) & (rng.random((n, l))
                                                       < 0.8)
    valid[0] = False
    idx, valid, emb = _on(dev, rng.integers(0, m, (n, l)).astype(np.int32),
                          valid,
                          rng.standard_normal((m, d)).astype(np.float32))
    return idx, valid, emb.to(dtype)


def _ell_holds(idx, valid, emb):
    """The kernel once (one launch) against the plain version, then again:
    the same bits. Returns the output."""
    before = ellmean.launches
    got = ops.ell_mean(idx, valid, emb)
    assert ellmean.launches == before + 1 and got.dtype == emb.dtype
    want = ref.ell_mean_ref(idx, valid, emb)
    tol = 1e-5 if emb.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(ops.ell_mean(idx, valid, emb), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,l", [(1, 1766), (3, 5000), (64, 1766),
                                 (64, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_mean_few_long_rows(cuda, n, l, dtype):
    """The row-split kernel at the serving flush's shape and longer rows:
    sparse rows, an empty row (0), a full row, fp32 sums in bf16 too, and
    two calls bit-identical."""
    assert ellmean.row_split(n, l, cuda)
    idx, valid, emb = _sparse_ell(cuda, n, l, 37701, 128, dtype, n + l)
    got = _ell_holds(idx, valid, emb)
    assert not got[0].any()


@pytest.mark.cuda
def test_ell_mean_path_threshold(cuda):
    """Both sides of the rule: fewer than 8 rows per SM with rows of at
    least 256 slots take the row-split kernel, anything else a warp per
    row; each side matches the plain version and repeats its bits."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, l, d, rows in ((8 * sms - 8, 256, 128, True),
                          (8 * sms, 256, 128, False),
                          (8 * sms - 8, 255, 150, False),
                          (1, 256, 150, True), (1, 255, 128, False),
                          (8 * sms - 7, 300, 64, False)):
        assert ellmean.row_split(n, l, cuda) is rows, (n, l)
        for dtype in (torch.float32, torch.bfloat16):
            _ell_holds(*_sparse_ell(cuda, n, l, 5000, d, dtype, n + l))


def _sgns_fp64(c, x, n, dout):
    """The SGNS loss and gradients in float64 (the plain versions'
    formulas)."""
    c, x, n, g = (t.double() for t in (c, x, n, dout))
    pos = (c * x).sum(-1)
    negl = torch.einsum("bkd,bd->bk", n, c)
    loss = (torch.nn.functional.softplus(-pos)
            + torch.nn.functional.softplus(negl).sum(-1))
    dpos = (torch.sigmoid(pos) - 1.0) * g
    dneg = torch.sigmoid(negl) * g[:, None]
    return loss, (dpos[:, None] * x + torch.einsum("bk,bkd->bd", dneg, n),
                  dpos[:, None] * c, dneg[:, :, None] * c[:, None, :])


def _sgns_holds(c, x, n, dout, dtype, many=False):
    """Both SGNS kernels against their plain versions (one launch each),
    and the same bits on a second call. ``many`` (K in the thousands): the
    kernels are also held to the fp64 formulas at the tolerance, and to the
    plain versions at the tolerance x max(1, max|plain|), whose fp32 sums
    of K terms drift by about 1e-6 of their magnitude."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    before = (sgns.fwd_launches, sgns.bwd_launches)
    loss = sgns.sgns_fwd_cuda(c, x, n)
    grads = sgns.sgns_bwd_cuda(c, x, n, dout)
    assert (sgns.fwd_launches, sgns.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)

    def atol(want):
        return tol * max(1.0, float(want.abs().max())) if many else tol

    if many:
        exact_loss, exact_grads = _sgns_fp64(c, x, n, dout)
        for got, want in zip((loss, *grads), (exact_loss, *exact_grads)):
            torch.testing.assert_close(got.double(), want, rtol=tol,
                                       atol=tol)
    want = ref.sgns_loss_ref(c, x, n)
    torch.testing.assert_close(loss, want, rtol=tol, atol=atol(want))
    for got, want in zip(grads, ref.sgns_grads_ref(c, x, n, dout)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=atol(want.float()))
    assert torch.equal(sgns.sgns_fwd_cuda(c, x, n), loss)
    for again, got in zip(sgns.sgns_bwd_cuda(c, x, n, dout), grads):
        assert torch.equal(again, got)


def _sgns_inputs(dev, b, d, k, dtype, seed):
    rng = np.random.default_rng(seed)
    c, x, n, dout = _on(dev, *[(rng.standard_normal(s) * 0.3).astype(
        np.float32) for s in ((b, d), (b, d), (b, k, d), (b,))])
    return (*(t.to(dtype) for t in (c, x, n)), dout)


# D: one element a lane (1, 7), 8-byte fp32 vectors in lane groups of 16
# (150), 16-byte vectors (256), rows wider than the registers hold (1030)
SGNS_D = [1, 7, 150, 256, 1030]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 8193])
@pytest.mark.parametrize("d", SGNS_D)
@pytest.mark.parametrize("k", [1, 5, 15])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgns_kernels_match_plain(cuda, b, d, k, dtype):
    _sgns_holds(*_sgns_inputs(cuda, b, d, k, dtype, b * 131 + d * 7 + k),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 33])
@pytest.mark.parametrize("d", SGNS_D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgns_kernels_take_any_k(cuda, b, d, dtype):
    """K = 2,048 negatives (K = 13: a chunk's tail), which the first design
    refused above 1,536 (their logits sat in shared memory)."""
    for k in (13, 2048):
        _sgns_holds(*_sgns_inputs(cuda, b, d, k, dtype, b + d + k), dtype,
                    many=k > 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 8, 150, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgns_kernels_on_unaligned_rows(cuda, d, dtype):
    """Inputs and outputs whose storage starts one element past a 16-byte
    boundary take narrower vectors (or none), with the same results."""
    c, x, n, dout = _sgns_inputs(cuda, 65, d, 5, dtype, d)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    _sgns_holds(shifted(c), shifted(x), shifted(n), dout, dtype)


@pytest.mark.cuda
def test_sgns_loss_autograd_runs_both_kernels(cuda):
    """``ops.sgns_loss`` on CUDA tensors: one forward and one backward
    launch, gradients (through the stride-0 dout of ``.mean()``) equal to
    autograd of the plain loss."""
    rng = np.random.default_rng(3)
    ins = _on(cuda, *[(rng.standard_normal(s) * 0.3).astype(np.float32)
                      for s in ((64, 150), (64, 150), (64, 5, 150))])
    leaves = [t.clone().requires_grad_() for t in ins]
    plain = [t.clone().requires_grad_() for t in ins]
    before = (sgns.fwd_launches, sgns.bwd_launches)
    ops.sgns_loss(*leaves).mean().backward()
    assert (sgns.fwd_launches, sgns.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref.sgns_loss_ref(*plain).mean().backward()
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="contiguous"):
        sgns.sgns_bwd_cuda(*ins, torch.ones((), device=cuda).expand(64))


@pytest.mark.cuda
def test_train_sgns_on_the_card_lowers_the_loss(cuda):
    from repro_torch.core.corewalk import deepwalk_plan
    from repro_torch.graph import datasets
    from repro_torch.skipgram.corpus import build_corpus
    from repro_torch.skipgram.trainer import SGNSConfig, train_sgns

    g = datasets.load("tiny")
    gen = torch.Generator(device=cuda).manual_seed(0)
    corpus = build_corpus(g.to_ell(device=cuda),
                          deepwalk_plan(g.n_nodes, 10), 20, gen)
    cfg = SGNSConfig(dim=32, batch=512, seed=0)
    before = (sgns.fwd_launches, sgns.bwd_launches)
    first = train_sgns(corpus, cfg, steps=1)
    res = train_sgns(corpus, cfg, steps=60)
    assert (sgns.fwd_launches - before[0], sgns.bwd_launches - before[1]) \
        == (61, 61)
    assert res.embeddings.shape == (g.n_nodes, 32)
    assert np.isfinite(res.embeddings).all()
    assert res.final_loss < first.final_loss - 0.5, (first, res)


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
@pytest.mark.parametrize("r,w", H_SCATTER)
def test_h_index_kernel_scattered_masks(cuda, r, w):
    """Valid slots anywhere in the row (the kernel counts the mask itself),
    est 0, est above W, rows with no valid slot, values above est; the
    narrow and wide kernels by W, each the same bits on a second call."""
    rng = np.random.default_rng(r + 7 * w)
    vmax = min(w, 400) + 8
    vals = rng.integers(0, vmax, (r, w)).astype(np.int32)
    valid = rng.random((r, w)) < rng.random((r, 1))
    est = rng.integers(0, vmax + 10, r).astype(np.int32)
    est[0], est[1] = 0, w + 50
    valid[2] = False
    vals[3] = vmax + 100
    vals, valid, est = _on(cuda, vals, valid, est)
    before = (hindex.narrow_launches, hindex.wide_launches)
    got = ops.h_index_sweep(vals, valid, est)
    wide = int(w > hindex.NARROW_MAX)
    assert (hindex.narrow_launches - before[0],
            hindex.wide_launches - before[1]) == (1 - wide, wide)
    assert torch.equal(got, ref.h_index_ref(vals, valid, est))
    assert torch.equal(ops.h_index_sweep(vals, valid, est), got)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [1, 3, None])
def test_h_index_kernel_refuses_too_wide_rows(cuda, over):
    """Rows wider than ``max_width()``, which the wrapper once refused,
    take the hub kernel: at ``max_width() + 1`` (a multiple of 16: vector
    loads), ``max_width() + 3`` (scalar loads) and W = 65,536 (the serving
    repair's width for a degree above 32,768), exact against the plain
    versions, with est 0, est above W, a row with no valid slot and values
    above est among the rows, and the same bits on a second call."""
    w = 65536 if over is None else hindex.max_width() + over
    assert w > hindex.max_width()
    rng = np.random.default_rng(w)
    r = 24
    vals = rng.integers(0, 40000, (r, w)).astype(np.int32)
    valid = rng.random((r, w)) < rng.random((r, 1))
    est = rng.integers(0, w + 100, r).astype(np.int32)
    est[0], est[1], est[4] = 0, w + 50, 7
    valid[2] = False
    vals[3] = w + 100
    vals, valid, est = _on(cuda, vals, valid, est)
    before = (hindex.launches, hindex.hub_launches, hindex.wide_launches)
    got = ops.h_index_sweep(vals, valid, est)
    assert (hindex.launches - before[0], hindex.hub_launches - before[1],
            hindex.wide_launches - before[2]) == (1, 1, 0)
    assert torch.equal(got, ref.h_index_ref(vals, valid, est))
    assert torch.equal(got, ref.h_index_count(vals, valid, est))
    assert torch.equal(ops.h_index_sweep(vals, valid, est), got)
    assert int(got[0]) == 0 and int(got[2]) == 0 and int(got.max()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d,k", TOPK_CASES)
def test_topk_kernel_matches_plain(cuda, nq, n, d, k):
    rng = np.random.default_rng(nq * 7 + n)
    q, table, valid = _on(cuda, rng.normal(size=(nq, d)).astype(np.float32),
                          rng.normal(size=(n, d)).astype(np.float32),
                          rng.random(n) < 0.8)
    before = (topk.launches, topk.partial_launches, topk.merge_launches)
    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid)
    rounds = -(-k // topk.ROUND_K)  # one pass over the table for k <= 128
    assert (topk.launches - before[0], topk.partial_launches - before[1],
            topk.merge_launches - before[2]) == (2 * rounds, rounds, rounds)
    again_v, again_i = ops.top_k_scores(q, table, k, valid=valid)
    assert torch.equal(again_v, got_v) and torch.equal(again_i, got_i)
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
@pytest.mark.parametrize("k", [7, 100, 300])
def test_topk_kernel_repeated_rows_keep_index_order(cuda, k):
    """Repeated table rows tie exactly. Small integer entries make every
    score an exact integer in fp32 whatever the summation order, so ties
    (repeated rows and distinct rows alike) are exact in both versions, and
    the ids must be the plain version's: the lower index first, across the
    blocks' ranges and the rounds."""
    rng = np.random.default_rng(k)
    base = rng.integers(-3, 4, (700, 32)).astype(np.float32)
    table = base[rng.integers(0, 700, 30000)]  # every row ~43 times
    q = rng.integers(-3, 4, (16, 32)).astype(np.float32)
    q, table, valid = _on(cuda, q, table, rng.random(30000) < 0.9)
    got_v, got_i = ops.top_k_scores(q, table, k, valid=valid)
    want_v, want_i = ref.topk_ref(q, table, k, valid=valid)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


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
    for k in (10, 40):  # one pass of the kernels each
        (_, s_gpu), (_, s_cpu) = (s.top_k_neighbors(nodes, k) for s in svcs)
        np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)


def _decode_inputs(dev, b, h, hkv, dh, s, kind, seed):
    """q, k, v, lengths (ragged, one above S), scales (int8 kinds) on dev."""
    rng = np.random.default_rng(seed)
    q, k, v = _on(dev, *[rng.standard_normal(shape).astype(np.float32)
                         for shape in ((b, h, dh), (b, s, hkv, dh),
                                       (b, s, hkv, dh))])
    lens = rng.integers(1, s + 1, b)
    lens[-1] = s + 5  # a finished row decoding past its cache's end
    lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
    qdt = torch.bfloat16 if kind in ("bfloat16", "int8-bf16") else \
        torch.float32
    scales = {}
    if kind.startswith("int8"):
        from repro_torch.models.attention import quantize_kv_rows

        k, scales["k_scale"] = quantize_kv_rows(k)
        v, scales["v_scale"] = quantize_kv_rows(v)
    elif kind == "bfloat16":
        k, v = k.bfloat16(), v.bfloat16()
    return q.to(qdt), k, v, lens, scales


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 80, 96, 112, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8",
                                  "int8-bf16"])
def test_flash_decode_kernel_matches_plain(cuda, dh, g, kind):
    """GQA groups (G = 7: qwen2-vl's, a block's last query rows empty),
    head dims (the built widths, and 80, 96, 112 on the next one up), cache
    types; S not a multiple of 32 (48, 1000); B in {1, 3,
    8}; softcap and window; ragged lengths with one above S."""
    # bf16 queries: both round an fp32 result once, so at most one ulp apart
    # (< 1e-2 x |out| + 1e-3); fp32 queries: 2e-5
    rtol, atol = (1e-2, 1e-3) if "bf16" in kind or kind == "bfloat16" \
        else (2e-5, 2e-5)
    for b, s in ((1, 48), (3, 1000), (8, 48)):
        q, k, v, lens, scales = _decode_inputs(cuda, b, 2 * g, 2, dh, s,
                                               kind, b * 1000 + dh + g)
        for softcap, window in ((0.0, 0), (50.0, 0), (0.0, 16), (30.0, 40)):
            before = flash_decode.launches
            got = ops.decode_attention(q, k, v, lens, softcap=softcap,
                                       window=window, **scales)
            assert flash_decode.launches == before + 1
            assert got.dtype == q.dtype and got.shape == q.shape
            want = ref.decode_attention_ref(q, k, v, lens, softcap=softcap,
                                            window=window, **scales)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)


SPLIT_CASES = [
    # label, B, H, Hkv, Dh, S, lengths, window, softcap
    ("B=1 S=8192", 1, 32, 8, 128, 8192, [8192], 0, 0.0),
    ("lengths of 1 and shorter than a split", 4, 32, 8, 128, 4096,
     [1, 5, 200, 4096], 0, 0.0),
    ("a window of 40: most splits empty", 2, 16, 4, 128, 4096, [4096, 3000],
     40, 0.0),
    ("a length above S", 3, 8, 2, 64, 2048, [2048, 2100, 999], 0, 0.0),
    ("gemma2-2b: Dh=256 G=2", 2, 8, 4, 256, 8192, [8192, 5000], 4096, 50.0),
    # Dh = 112 on the 128-wide build: a column at Dh or above stored would
    # land in the next head's row
    ("zamba2-7b: Dh=112 G=1", 8, 32, 32, 112, 1088,
     [1088, 1025, 1088, 1025, 1088, 1025, 1088, 1100], 4096, 0.0),
    ("Dh=80 G=4, a window", 3, 16, 4, 80, 2048, [2048, 1500, 900], 300, 0.0),
    # qwen2-vl-7b: 28 query heads on 4 KV heads
    ("qwen2-vl-7b: G=7", 8, 28, 4, 128, 2112, [2080] * 7 + [2112], 0, 0.0),
    # seamless-m4t-large-v2's cross-attention: MHA at Dh = 64, every row
    # at the encoder's full length
    ("seamless cross: G=1 Dh=64, full rows", 8, 16, 16, 64, 256, [256] * 8,
     0, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8-bf16"])
def test_flash_decode_splits_match_plain(cuda, case, kind):
    """Shapes where S is split across a cluster of blocks: one launch, the
    plain version's result, and the same bits from a second call."""
    _, b, h, hkv, dh, s, lens, window, softcap = case
    q, k, v, _, scales = _decode_inputs(cuda, b, h, hkv, dh, s, kind, s + dh)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert flash_decode.splits(q, k) > 1
    rtol, atol = (2e-5, 2e-5) if kind == "float32" else (1e-2, 1e-3)
    before = flash_decode.launches
    got = ops.decode_attention(q, k, v, lens, softcap=softcap, window=window,
                               **scales)
    assert flash_decode.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, lens, softcap=softcap,
                                    window=window, **scales)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    again = ops.decode_attention(q, k, v, lens, softcap=softcap,
                                 window=window, **scales)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_flash_decode_row_with_no_visible_position_is_zero(cuda, kind):
    """A row whose window starts at or past its end gives 0 (as the Pallas
    kernel does), with no NaN from its empty splits, and leaves every other
    row's bits as they are."""
    q, k, v, lens, _ = _decode_inputs(cuda, 3, 16, 4, 128, 1024, kind, 21)
    lens[:] = torch.tensor([1024, 700, 333], dtype=torch.int32)
    assert flash_decode.splits(q, k) > 1
    fd = flash_decode.decode_attention_cuda
    lo = torch.zeros_like(lens)
    full = fd(q, k, v, lens, lo)
    lo[1] = 700
    got = fd(q, k, v, lens, lo)
    assert torch.isfinite(got.float()).all()
    assert not got[1].any()
    assert torch.equal(got[[0, 2]], full[[0, 2]])
    rtol, atol = (2e-5, 2e-5) if kind == "float32" else (1e-2, 1e-3)
    want = ref.decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got[[0, 2]].float(), want[[0, 2]].float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_decode_split_threshold(cuda):
    """Both sides of the splitting rule: S = 127 is one split, S = 128 two
    (at most one per two 32-position tiles); enough (b, c) pairs to fill two
    waves of blocks leave S whole. Each matches the plain version."""
    res = torch.cuda.get_device_properties(cuda).multi_processor_count * 16
    for b, hkv, s, one in ((2, 2, 127, True), (2, 2, 128, False),
                           (-(-2 * res // 8), 8, 256, True)):
        q, k, v, lens, _ = _decode_inputs(cuda, b, 4 * hkv, hkv, 128, s,
                                          "bfloat16", s)
        n = flash_decode.splits(q, k)
        assert (n == 1) if one else (n == 2), (b, s, n)
        got = ops.decode_attention(q, k, v, lens)
        want = ref.decode_attention_ref(q, k, v, lens)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-3)


@pytest.mark.cuda
def test_flash_decode_window_as_data(cuda):
    q, k, v, lens, _ = _decode_inputs(cuda, 3, 8, 2, 128, 300, "float32", 9)
    for w in (0, 50):
        got = ops.decode_attention(q, k, v, lens, window=torch.tensor(
            w, device=cuda))
        torch.testing.assert_close(got, ops.decode_attention(
            q, k, v, lens, window=w), rtol=0, atol=0)


# the log-sum-exp output: (label, B, H, Hkv, Dh, S, global lengths, window,
# softcap, the shard's first global position (None: the whole cache))
LSE_CASES = [
    ("serving: qwen3-4b's heads, 8 rows of 1,088", 8, 32, 8, 128, 1088,
     [1088, 1056, 1, 700, 1088, 1025, 40, 1100], 0, 0.0, None),
    ("gemma2-2b: softcap and window", 4, 8, 4, 256, 2048,
     [2048, 1500, 333, 2100], 600, 50.0, None),
    # a shard [4096, 6144) of a sequence-split cache: rows that end before
    # it (no position here), that end inside it, run past it, and whose
    # window starts past its end
    ("sequence-split shard", 8, 32, 8, 128, 2048,
     [32768, 100, 5000, 4096, 8000, 6144, 4097, 7000], 900, 0.0, 4096),
    # enough rows that S is not split across a cluster
    ("one split", -1, 32, 8, 128, 256, None, 0, 0.0, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LSE_CASES, ids=[c[0] for c in LSE_CASES])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8-bf16"])
def test_flash_decode_lse_matches_plain(cuda, case, kind):
    """The kernel's (B, H) log-sum-exp and output against the plain
    version's, at a serving shape, with softcap and window, on one shard
    of a cache split along its sequence (``ops._decode_seq_shard``: rows
    with no position on it give -inf and 0 on both), and with S in one
    split; the output's bits the same with and without the lse."""
    label, b, h, hkv, dh, s, lens, window, softcap, off = case
    if b < 0:  # two waves of resident blocks without splitting S
        b = -(-2 * torch.cuda.get_device_properties(
            cuda).multi_processor_count * 16 // hkv)
    q, k, v, ragged, scales = _decode_inputs(cuda, b, h, hkv, dh, s, kind,
                                             s + b)
    lens = ragged if lens is None else torch.tensor(
        lens, dtype=torch.int32, device=cuda)
    ks, vs = scales.get("k_scale"), scales.get("v_scale")
    assert (flash_decode.splits(q, k) == 1) == (label == "one split")
    at = off or 0  # the whole cache is the shard at 0
    got, lse = ops._decode_seq_shard(q, k, v, lens, window, at, softcap, ks,
                                     vs, "cuda")
    want, wlse = ops._decode_seq_shard(q, k, v, lens, window, at, softcap,
                                       ks, vs, "ref")
    lo = (ops._window_lo(lens, window) - at).clamp(0, s).to(torch.int32)
    hi = (lens - at).clamp(0, s).to(torch.int32)
    empty = hi <= lo
    assert not empty.all()
    if off is not None:
        assert empty.any()
    assert torch.equal(lse[empty], torch.full_like(lse[empty],
                                                   -float("inf")))
    assert not got[empty].any()
    rtol, atol = (2e-5, 2e-5) if kind == "float32" else (1e-2, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    # fp32 logits summed in another order: a few ulps of the lse's size
    torch.testing.assert_close(lse, wlse, rtol=1e-5, atol=1e-4)
    plain = flash_decode.decode_attention_cuda(
        q, k, v, hi.contiguous(), lo.contiguous(), softcap=softcap, **scales)
    assert torch.equal(plain, got)


@pytest.mark.cuda
def test_flash_decode_wrapper_refuses_what_it_cannot_take(cuda):
    q, k, v, lens, _ = _decode_inputs(cuda, 2, 8, 2, 64, 40, "float32", 1)
    lo = torch.zeros_like(lens)
    fd = flash_decode.decode_attention_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        fd(q.cpu(), k.cpu(), v.cpu(), lens.cpu(), lo.cpu())
    with pytest.raises(ValueError, match="must be one of"):
        fd(q, k.half(), v.half(), lens, lo)
    with pytest.raises(ValueError, match="must be one of"):
        fd(q, k, v, lens.long(), lo)
    with pytest.raises(ValueError, match="contiguous"):
        fd(q, k.transpose(1, 2), v.transpose(1, 2), lens, lo)
    with pytest.raises(ValueError, match="k_scale"):
        fd(q, k.to(torch.int8), v.to(torch.int8), lens, lo)
    # head dims: below 32, not a multiple of 8, above 256 (the plain
    # version takes any); nothing is launched
    before = flash_decode.launches
    for dh in (24, 44, 100, 264):
        qd, kd, vd, _, _ = _decode_inputs(cuda, 2, 8, 2, dh, 40, "float32",
                                          1)
        with pytest.raises(ValueError, match="head_dim"):
            fd(qd, kd, vd, lens, lo)
    assert flash_decode.launches == before


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over,tol", [
    ("qwen3-4b", dict(n_heads=8, n_kv_heads=2), 1e-4),
    ("gemma2-2b", dict(sliding_window=6), 1e-4),
    # int8 cache: a value next to a rounding midpoint may quantise one step
    # apart (1/127 of its row's max), which moves the logits by about 1e-3
    ("qwen3-4b", dict(n_heads=8, n_kv_heads=2, kv_quant=True), 1e-2),
])
def test_decode_step_on_the_card_matches_the_cpu(cuda, arch, over, tol):
    """The reduced model's prefill and one decode step (through the
    flash-decode kernel) on the card against the CPU (the plain version),
    the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch).reduced(**over)
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (3, 8)))
    nxt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (3, 1)))
    out = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        _, cache = transformer.forward_prefill(p, cfg, tokens=toks.to(dev),
                                               max_len=12)
        before = flash_decode.launches
        logits, cache = transformer.forward_decode(p, cache, nxt.to(dev), cfg)
        if dev != "cpu":
            assert flash_decode.launches == before + cfg.n_layers
        out[str(dev)] = (logits.cpu(), _tree_to(cache, "cpu"))
    (lc, cc), (lg, cg) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(lg, lc, rtol=tol, atol=tol)
    for key in cc:
        if cc[key].dtype == torch.int32:
            assert torch.equal(cg[key], cc[key]), key
        elif cc[key].dtype == torch.int8:
            # k and v differ in the last fp32 bits (another matmul order), so
            # a value next to a rounding midpoint may land one step apart
            diff = (cg[key].int() - cc[key].int()).abs()
            assert int(diff.max()) <= 1 and float(
                (diff > 0).float().mean()) < 1e-3, key
        else:
            torch.testing.assert_close(cg[key], cc[key], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("seamless-m4t-large-v2", {}),
    ("qwen2-vl-7b", dict(n_heads=14, n_kv_heads=2)),  # G = 7
])
def test_encdec_and_vl_steps_on_the_card_match_the_cpu(cuda, arch, over):
    """The reduced encoder-decoder and vision models (fp32), through
    ``make_prefill_step`` and 8 greedy ``make_decode_step`` steps on the
    card and on the CPU with the same weights and inputs (frame embeddings;
    patch embeddings with M-RoPE positions from a 4 x 4 grid): tokens
    equal, logits within 1e-4, and flash-decode launched once per layer a
    step (encdec: twice, self and cross)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.steps import make_decode_step, make_prefill_step

    cfg = get_config(arch).reduced(**over)
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        prompt = 16
        extra = {"src_embeds": rng.standard_normal((2, 8, cfg.d_model))}
    else:
        grid, prompt = 4, 24
        i = np.arange(grid * grid)
        pos = np.concatenate([np.stack([0 * i, i // grid, i % grid]),
                              np.broadcast_to(grid + np.arange(8), (3, 8))],
                             1)
        extra = {"vision_embeds": rng.standard_normal((2, 16, cfg.d_model)),
                 "positions": np.stack([pos, pos], 1).astype(np.int32)}
    batch = {k: torch.from_numpy(v * 0.02 if v.dtype == np.float64 else v)
             .to(torch.float32 if v.dtype == np.float64 else torch.int32)
             for k, v in extra.items()}
    batch["tokens"] = torch.from_numpy(
        rng.integers(2, cfg.vocab_size, (2, prompt)).astype(np.int32))
    per_step = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
    out = {}
    for dev in ("cpu", cuda):
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
        if dev != "cpu":
            assert flash_decode.launches - before == 8 * per_step
        out[str(dev)] = (torch.cat(toks, 1), torch.stack(logs))
    (tc, lc), (tg, lg) = out["cpu"], out[str(cuda)]
    assert torch.equal(tg, tc)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b",
                                  "mamba2-2.7b", "zamba2-7b"])
def test_lm_families_served_on_the_card_match_the_cpu(cuda, arch):
    """The reduced MoE, SSM and hybrid models (fp32) served by
    ``launch/serve`` on the card and on the CPU with the same weights and
    schedule (2 slots, 5 requests of 12 tokens, 4 new each): the token
    streams equal, every step's logits within 1e-4, and flash-decode
    launched once per attention layer (MoE), per shared-block call (hybrid)
    or never (SSM) in each of the 12 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config(arch).reduced()
    params = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    requests = serve.make_requests(cfg.vocab_size, 5, 12, 0)
    per_step = cfg.n_layers if cfg.family == "moe" else 0
    if cfg.family == "hybrid":
        per_step = transformer.hybrid_layout(cfg)[0]
    out = {}
    for dev in ("cpu", cuda):
        logs = []
        before = flash_decode.launches
        res = serve.serve(cfg, _tree_to(params, dev), requests, slots=2,
                          max_new=4, device=dev,
                          on_step=lambda s, c, lg: logs.append(lg.cpu()))
        if dev != "cpu":
            assert flash_decode.launches - before == per_step * 12
        out[str(dev)] = (res, torch.stack(logs))
    (rc, lc), (rg, lg) = out["cpu"], out[str(cuda)]
    assert rg.n_decoded == rc.n_decoded == 24
    assert np.array_equal(rg.step_tokens, rc.step_tokens)
    assert rg.streams == rc.streams
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_serve_launcher_on_a_world_of_one_nccl_mesh_is_bitwise(cuda,
                                                               monkeypatch):
    """``launch/serve`` under a launcher's environment of one rank (NCCL,
    a (1, 1) mesh: params, prompts, tokens and the cache DTensors, the
    swaps written into the rank's slice) at the reduced qwen3-4b (fp32),
    8 slots, 12 requests, 4 new: the streams and every step's logits
    bit-equal to the same launcher in a plain process with no mesh (one
    rank moves no data), and flash-decode launched once a layer a step."""
    import socket

    from repro_torch.distributed.sharding import full_tree
    from repro_torch.launch import serve

    argv = ["--arch", "qwen3-4b", "--preset", "reduced", "--slots", "8",
            "--requests", "12", "--prompt-len", "16", "--max-new", "4",
            "--device", str(cuda)]
    def run():
        args, cfg, params, requests = serve.setup(argv)
        logs = []
        before = flash_decode.launches
        try:
            res = serve.serve(cfg, params, requests, slots=args.slots,
                              max_new=args.max_new, device=args.device,
                              on_step=lambda s, c, lg: logs.append(
                                  full_tree({"x": lg})["x"].clone()))
            cache = {k: v.clone() for k, v in full_tree(res.cache).items()}
        finally:
            serve.close(args)
        return (args.mesh is not None, res, torch.stack(logs), cache,
                flash_decode.launches - before)

    plain = run()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, val in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, val)
    meshed = run()
    assert not torch.distributed.is_initialized()
    assert (plain[0], meshed[0]) == (False, True)
    assert meshed[1].streams == plain[1].streams
    assert meshed[1].n_decoded == plain[1].n_decoded == 64
    assert torch.equal(meshed[2], plain[2])
    for key, want in plain[3].items():
        assert torch.equal(meshed[3][key], want), key
    assert meshed[4] == plain[4] == serve.get_config(
        "qwen3-4b").reduced().n_layers * 8


@pytest.mark.cuda
def test_hub_ingest_on_the_card_matches_the_oracle(cuda):
    """A hub of degree 34,280 streamed through the serving repair on the
    card, pinned to the window descent: its row of width 65,536 goes
    through the hub kernel, and the cores equal the peeling oracle after
    every block of inserts and churn."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import generators
    from repro_torch.serve import DynamicGraph, IncrementalCore

    g, inner = generators.hub_with_cliques(34000, 10, 28, 2000, seed=0)
    stream = inner[:600]
    streamed = set(map(tuple, stream.tolist()))
    edges = g.edge_list()
    base = edges[[tuple(e) not in streamed for e in edges.tolist()]]
    dyn = DynamicGraph(g.n_nodes, base, width=16, device=cuda)
    inc = IncrementalCore(dyn, repair_policy="region", repeel_frac=1.0,
                          descend_budget=1 << 62)
    before = hindex.hub_launches
    rng = np.random.default_rng(2)
    live = []
    for start in range(0, len(stream), 100):
        acc = dyn.add_edges(stream[start:start + 100])
        inc.on_edge_block(acc)
        live.extend(map(tuple, acc))
        pick = rng.choice(len(live), size=10, replace=False)
        gone = dyn.remove_edges(np.array([live[i] for i in pick]))
        inc.on_remove(gone)
        live = [e for i, e in enumerate(live) if i not in set(pick.tolist())]
        np.testing.assert_array_equal(inc.core,
                                      core_numbers_host(dyn.snapshot()))
    assert hindex.hub_launches > before and inc.repeels == 0
    assert inc.phase_impl["descend"] == "fused[cuda]"


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["github-like", "hub"])
def test_chunked_descent_on_the_card_matches_the_cpu(cuda, graph):
    """The all-node descent (the card's re-peel) enqueued in chunks on the
    card against the counting search on the CPU, at the serving tiers'
    shapes (github-like: R=65,536 W=32 + R=4,096 W=2,048) and with a hub
    row of W = 65,536: equal cores (the peeling oracle's) and ``sweeps``,
    with first chunks of 1 sweep and of the history rule, each descent at
    most 1 + ceil(log2(max_sweeps)) host reads."""
    import math

    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.graph import datasets, generators
    from repro_torch.serve import DynamicGraph, IncrementalCore

    if graph == "hub":
        g, _ = generators.hub_with_cliques(34000, 10, 28, 2000, seed=0)
    else:
        g = datasets.load("github-like", seed=0)
    n = g.n_nodes
    want = core_numbers_host(g)
    runs = []
    for dev, first in (("cpu", None), (cuda, None), (cuda, 1)):
        d = DynamicGraph(n, g.edge_list(), width=16, device=dev)
        inc = IncrementalCore(d, np.zeros(n, np.int32))
        inc._first_chunk = first
        deg = d.degrees_of(np.arange(n))
        for _ in range(2):  # the second descent's first chunk from history
            pending = inc._descend_dispatch(
                np.arange(n, dtype=np.int64), deg, np.zeros(n, np.int32),
                0, 1 << 30, cand_deg=deg)
            res = inc._descend_read(pending)
            out = np.zeros(n, np.int32)
            out[pending["cand"]] = res[0]
            np.testing.assert_array_equal(out, want)
        widths = [t[0].shape[1] for t in pending["args"]["tiers"]]
        assert widths[-1] == (65536 if graph == "hub" else 2048)
        assert inc.descent_reads <= 2 * (1 + math.ceil(math.log2(512)))
        runs.append((inc.sweeps, inc.sweeps_enqueued, inc.descent_reads))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert runs[2][2] > runs[1][2] >= 2  # chunks from 1 take more reads


@pytest.mark.cuda
def test_sharded_service_on_four_chunks_of_one_card(cuda):
    """``ShardPlan`` with 4 shards on one card against one shard: stream,
    flush and top-k bit-equal; per-shard launches counted (each top-k pass
    a partial kernel per shard, each h-index sweep a launch per chunk)."""
    from repro_torch.graph import generators
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.serve import ShardPlan

    plan = ShardPlan.build(4, devices=[cuda] * 4)
    g = generators.barabasi_albert_varying(400, 5.0, seed=0)
    svcs = [build_service(g, seed=0, batch=32, compact_every=128,
                          shards=s, device=cuda) for s in (1, plan)]
    stream = svcs[0][1]
    svcs = [s[0] for s in svcs]
    h = []
    for svc in svcs:
        before = hindex.launches
        svc.stream_with_churn(stream, block_size=64, churn=0.2,
                              rng=np.random.default_rng(11))
        h.append(hindex.launches - before)
    np.testing.assert_array_equal(svcs[0].cores.core, svcs[1].cores.core)
    assert h[1] > 0 and h[1] % 4 == 0
    q = np.random.default_rng(12).integers(0, svcs[0].graph.n_nodes, 32)
    out, parts, ells = [], [], []
    for svc in svcs:
        e0, p0 = ellmean.launches, topk.partial_launches
        emb = svc.embed(q)
        ells.append(ellmean.launches - e0)
        ids, sc = svc.top_k_neighbors(q, 10)
        parts.append(topk.partial_launches - p0)
        out.append((emb, svc.link_scores(np.stack([q, q[::-1]], 1)), ids,
                    sc))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert ells == [1, 1] and parts == [1, 4]
    s1, s4 = (s.store.state_dict() for s in svcs)
    assert all(np.array_equal(s1[k], s4[k]) for k in s1)


# -------------------------------------------- retraining and crash safety --


def _resilience_service(dev, *, capacity=200):
    """A small service with the drift-triggered retrainer attached (auto,
    budget 2), on ``dev``: the crash sweep's configuration."""
    from repro_torch.graph import generators
    from repro_torch.launch.serve_embed import build_service
    from repro_torch.serve import RetrainConfig, Retrainer
    from repro_torch.skipgram.trainer import SGNSConfig

    g = generators.barabasi_albert_varying(300, 4.0, seed=3)
    svc, stream, _, _ = build_service(
        g, seed=3, batch=16, dim=16, stream_frac=0.3, compact_every=256,
        capacity=capacity, device=dev)

    def attach(s):
        cfg = RetrainConfig(
            n_walks=6, walk_length=12, min_sgns_steps=60,
            sgns=SGNSConfig(dim=16, epochs=0.1, seed=3),
            prop_iters=6, swap_chunk=64, seed=3)
        s.retrain_threshold = 0.02
        s.set_retrainer(Retrainer(s, cfg), auto=True, budget=2)
    attach(svc)
    return svc, stream, attach


def _resilience_ops(stream, block=24, churn=0.25, seed=21):
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for s in range(0, len(stream), block):
        blk = np.asarray(stream[s:s + block], np.int64)
        ops.append(("ingest", blk))
        live.extend(map(tuple, blk))
        pick = rng.choice(len(live), size=min(int(round(churn * len(blk))),
                                              len(live)), replace=False)
        ops.append(("retract", np.asarray([live[i] for i in pick], np.int64)))
        gone = set(pick.tolist())
        live = [e for i, e in enumerate(live) if i not in gone]
    return ops


def _run(svc, ops, start=0):
    for kind, blk in ops[start:]:
        (svc.ingest_block if kind == "ingest" else svc.retract_block)(blk)
    svc.sync()


@pytest.mark.cuda
def test_retrain_on_the_card_matches_the_cpu_counts_and_repeats(cuda):
    """The same stream on the card and on the CPU fires the same auto
    retrains with the same walk, step, warm-row, anchor and swap counts
    (the walks differ: CUDA and CPU generators draw differently), the SGNS
    kernels run every retrain step on the card, and a second retrain from
    the same state gives the same table bits (sha256)."""
    import hashlib

    from repro_torch.serve import Retrainer

    reports, svcs = {}, {}
    for dev in ("cuda", "cpu"):
        svc, stream, _ = _resilience_service(dev)
        rlog = []
        run = svc.retrainer.run
        svc.retrainer.run = lambda between=None, run=run, rlog=rlog: (
            rlog.append(run(between)) or rlog[-1])
        f0, b0 = sgns.fwd_launches, sgns.bwd_launches
        _run(svc, _resilience_ops(stream))
        if dev == "cuda":
            steps = sum(r.sgns_steps for r in rlog)
            assert sgns.fwd_launches - f0 == sgns.bwd_launches - b0 == steps
        reports[dev], svcs[dev] = rlog, svc
    assert len(reports["cuda"]) == len(reports["cpu"]) == 2
    for a, b in zip(reports["cuda"], reports["cpu"]):
        for k in ("k0", "core_size", "drifted", "n_walks", "sgns_steps",
                  "warm_rows", "anchors", "aligned", "rows_swapped",
                  "version"):
            assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(svcs["cuda"].cores.core,
                                  svcs["cpu"].cores.core)

    svc = svcs["cuda"]
    pre, base = svc.store.state_dict(), svc.cores.baseline.copy()
    digests = []
    for _ in range(2):
        svc.store.load_state_dict(pre)
        svc.cores._baseline[: len(base)] = base
        assert Retrainer(svc, svc.retrainer.cfg).run() is not None
        digests.append(hashlib.sha256(
            svc.store.table().cpu().numpy().tobytes()).hexdigest())
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_crash_and_recover_on_the_card_is_bit_identical(cuda, tmp_path):
    """A crash in the second retrain's training, recovered on the card from
    the snapshot plus the WAL tail (the retrain re-fired in the replay),
    then the rest of the stream: the state equals an uninterrupted twin's
    on the card bit for bit, and the cores the peeling oracle's."""
    from repro_torch.core.kcore import core_numbers_host
    from repro_torch.serve import RecoveryManager, faults
    from repro_torch.serve.recovery import capture_state

    twin, stream, _ = _resilience_service("cuda")
    ops = _resilience_ops(stream)
    _run(twin, ops)
    truth, truth_man = capture_state(twin, 0)
    assert twin.stats.retrains == 2

    svc, _, attach = _resilience_service("cuda")
    mgr = RecoveryManager(svc, str(tmp_path), snapshot_every=4, fsync=False)
    faults.install(faults.FaultPlan.parse("retrain_train:2:crash"))
    try:
        with pytest.raises(faults.InjectedCrash):
            _run(svc, ops)
    finally:
        faults.install(None)
    mgr.wait()
    mgr.wal.close()
    before = hindex.launches
    svc, mgr, report = RecoveryManager.recover(
        str(tmp_path), device="cuda", snapshot_every=4, fsync=False,
        configure=attach)
    assert report["replayed_records"] >= 1 and hindex.launches > before
    _run(svc, ops, start=report["wal_seq"])
    got, man = capture_state(svc, 0)
    assert [k for k in truth if not np.array_equal(truth[k], got[k])] == []
    assert man["stats"] == truth_man["stats"]
    oracle = core_numbers_host(svc.graph.snapshot())
    np.testing.assert_array_equal(svc.cores.core[: len(oracle)], oracle)
    mgr.close()


# the families trained past qwen3-4b: MoE (AdamW, aux losses), SSM, hybrid,
# MoE with adafactor, encoder-decoder, vision
TRAIN_FAMILIES = ["moonshot-v1-16b-a3b", "mamba2-2.7b", "zamba2-7b",
                  "grok-1-314b", "seamless-m4t-large-v2", "qwen2-vl-7b"]
# the least share of the entries held to 1e-3 x the rate: of a leaf (the
# smoke's TRAIN_MASK_SHARE) and of all the params (moonshot's experts: 97.2%
# at the port's init, seed 0: hidden units that a few tokens' GELU all but
# closes get gradients of ~1e-7, and sit below Adam's mask)
SHARE_OF_LEAF, SHARE_OF_TREE = 0.5, 0.95


def family_batch(cfg, step=0, rows=2, seq=64, grid=4, seed=2):
    """numpy: the synthetic LM batch of ``step`` and the family's inputs:
    S / 4 frames of 0.02 x N(0, 1) for the encoder-decoder; for the vision
    frontend, patch embeddings of 0.02 x N(0, 1) in the first grid^2 slots,
    their M-RoPE positions (t = 0, h = i // grid, w = i % grid, then text
    from ``grid`` on all three streams) and the mask 0 there."""
    from repro_torch.data.pipeline import SyntheticLMData

    b = SyntheticLMData(cfg.vocab_size, rows, seq, seed=seed).batch_at(step)
    rng = np.random.default_rng(10 + step)
    if cfg.family == "encdec":
        b["src_embeds"] = (rng.standard_normal((rows, seq // 4, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.frontend == "vision":
        P = grid * grid
        b["vision_embeds"] = (rng.standard_normal((rows, P, cfg.d_model))
                              * 0.02).astype(np.float32)
        i = np.arange(P)
        pos = np.concatenate([np.stack([0 * i, i // grid, i % grid]),
                              np.broadcast_to(grid + np.arange(seq - P),
                                              (3, seq - P))], axis=1)
        b["positions"] = np.ascontiguousarray(np.broadcast_to(
            pos[:, None].astype(np.int32), (3, rows, seq)))
        b["mask"][:, :P] = 0.0
    return b


def held_entries(optimizer, state, grads, count):
    """Per param leaf, (mask, unmoved) bool tensors after ``count`` steps.

    mask: where the update is insensitive to the rounding of the gradient
    it divides. AdamW's m_hat / (sqrt(v_hat) + eps) is about sign(g) where
    sqrt(v_hat) >> eps; near eps it turns a gradient's rounding into a step
    of up to the rate: sqrt(v_hat) > 100 eps. Adafactor (the analogous
    mask): an unfactored leaf's g / sqrt(v), v = beta v + (1 - beta)(g^2 +
    eps), has sqrt(eps) = 1e-15 where Adam has eps: sqrt(v) > 100
    sqrt(eps); a factored leaf divides by sqrt(r_i c_j / mean(r)), each
    moment built of the same g^2 + eps: sqrt(r_i c_j / mean(r)) > 100
    sqrt(eps). unmoved: where the update is exactly 0 (AdamW: mu = 0, every
    gradient so far 0; adafactor: this step's gradient 0), whose params
    must not move at all."""
    from repro_torch.train import tree

    if optimizer == "adamw":
        c2 = 1 - 0.999 ** count
        return ([torch.sqrt(v / c2) > 100 * 1e-8
                 for v in tree.leaves(state[0].nu)],
                [m == 0 for m in tree.leaves(state[0].mu)])
    floor, mask = 100 * 1e-15, []
    for vr, vc in zip(tree.leaves(state.vr),
                      tree.leaves_up_to(state.vr, state.vc)):
        if isinstance(vc, tuple):
            mask.append(torch.sqrt(vr) > floor)
            continue
        r = vr / vr.mean(-1, keepdim=True).clamp_min(1e-30)
        mask.append(torch.sqrt(r[..., :, None] * vc[..., None, :]) > floor)
    return mask, [g == 0 for g in tree.leaves(grads)]


def hold_step_params(named, want, held, lr):
    """The params after a step (``[(name, tensor)]``) against ``want``'s
    (tensors, leaf for leaf): bit-equal where unmoved; within 1e-3 x the
    rate on the mask and the unmoved entries, which cover more than half of
    every leaf and 95% of the params (a leaf of a few per-head scalars can
    sit mostly below the mask at init: mamba's ``a_log``); within 2 x the
    rate everywhere."""
    kept = total = 0
    for (name, a), b, ok, z in zip(named, want, *held):
        d = (a.float() - b.float()).abs()
        assert ok.shape == d.shape == z.shape, name
        assert bool((d[z] == 0).all()), name
        ok = ok | z
        kept, total = kept + int(ok.sum()), total + ok.numel()
        assert float(ok.float().mean()) > SHARE_OF_LEAF, name
        assert float(d[ok].max()) <= 1e-3 * lr, (name, float(d[ok].max()))
        assert float(d.max()) <= 2 * lr, (name, float(d.max()))
    assert kept / total > SHARE_OF_TREE


@pytest.mark.cuda
@pytest.mark.parametrize("arch,accum", [("qwen3-4b", 1), ("qwen3-4b", 2)]
                         + [(arch, 1) for arch in TRAIN_FAMILIES])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, accum):
    """One step of ``make_train_step`` on the card and on the CPU from the
    same params, fp32: reduced qwen3-4b (G = 4, AdamW, 4 x 64 tokens, at
    accum 1 and 2), and each of ``TRAIN_FAMILIES`` reduced with its
    config's optimizer on ``family_batch`` (2 x 64 tokens; grok-1-314b's
    adafactor). Loss, xent and grad_norm 1e-5 (and the MoE's aux losses); the
    optimizer's moments 1e-4 x their leaf's largest magnitude; the
    parameters 1e-3 x the rate where ``held_entries``' mask holds (Adam
    turns a near-zero gradient's rounding into a step of up to the rate,
    held to 2 x the rate everywhere): for qwen3-4b on 98% of every leaf,
    for the families as ``hold_step_params`` says."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.train import optim, tree

    if arch == "qwen3-4b":
        cfg = get_config(arch).reduced(n_heads=8, n_kv_heads=2)
        batch = SyntheticLMData(cfg.vocab_size, 4, 64, seed=1).batch_at(0)
    else:
        cfg = get_config(arch).reduced()
        batch = family_batch(cfg)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    sched = optim.warmup_cosine(3e-3, 2, 20)
    out, grads = {}, {}
    for dev in (cuda, "cpu"):  # the CPU's step updates ``params`` itself

        def keep(g, dev=str(dev)):  # unchanged: the unmoved entries' test
            grads[dev] = tree.tree_map(lambda t: t.cpu(), g)
            return g

        p = _tree_to(params, dev)
        opt = optim.make_optimizer(cfg.optimizer, sched)
        p, state, m = make_train_step(cfg, opt, accum_steps=accum,
                                      grad_transform=keep)(
            p, opt.init(p), {k: torch.from_numpy(v).to(dev)
                             for k, v in batch.items()})
        out[str(dev)] = (tree.tree_map(lambda t: t.cpu(), p),
                         tree.tree_map(lambda t: t.cpu()
                                       if isinstance(t, torch.Tensor) else t,
                                       state),
                         {k: float(v) for k, v in m.items()})
    (pg, sg, mg), (pc, sc, mc) = out[str(cuda)], out["cpu"]
    assert set(mg) == set(mc)
    for key in mc:
        assert mg[key] == pytest.approx(mc[key], rel=1e-5), key
    for a, b in zip(tree.leaves(sg), tree.leaves(sc)):
        if isinstance(a, int):
            assert a == b
        else:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    lr = sched(0)
    if arch != "qwen3-4b":
        hold_step_params(tree.leaf_paths(pg), tree.leaves(pc),
                         held_entries(cfg.optimizer, sc, grads["cpu"], 1),
                         lr)
        return
    for a, b, v in zip(tree.leaves(pg), tree.leaves(pc),
                       tree.leaves(sc[0].nu)):
        d = (a - b).abs()
        ok = torch.sqrt(v / (1 - 0.999)) > 100 * 1e-8
        assert float(ok.float().mean()) > 0.98
        assert float(d[ok].max()) <= 1e-3 * lr and float(d.max()) <= 2 * lr


@pytest.mark.cuda
def test_checkpoint_bf16_round_trip_on_card_tensors(cuda, tmp_path):
    """Card tensors (bf16, fp32) and a count saved asynchronously come back
    on the card bit for bit, as they were when ``save`` returned: the leaves
    are copied to the host before it returns, so an in-place update right
    after it does not reach the files."""
    from repro_torch.distributed.checkpoint import CheckpointManager

    x = torch.randn(64, 33, device=cuda).bfloat16()
    y = torch.randn(5, device=cuda)
    want = (x.clone(), y.clone())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": x, "f": y, "n": 5}, blocking=False)
    x.add_(1.0)
    y.mul_(2.0)
    mgr.wait()
    got = mgr.restore(3, {"w": torch.empty_like(x), "f": torch.empty_like(y),
                          "n": 0})
    assert got["n"] == 5
    assert got["w"].device == x.device and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got["f"], want[1])


@pytest.mark.cuda
def test_checkpoint_restores_card_tensors_in_place(cuda, tmp_path):
    """A restore into card tensors fills them in place: the same storage
    comes back, and the card's allocator grows by at most one leaf while it
    reads (64 MiB bf16 and fp32 leaves), never by a second copy of the
    tree."""
    from repro_torch.distributed.checkpoint import CheckpointManager

    gen = torch.Generator(cuda).manual_seed(0)
    tree = {"a": torch.randn(4096, 8192, device=cuda, generator=gen)
            .bfloat16(),
            "b": torch.randn(2048, 8192, device=cuda, generator=gen),
            "n": 9}
    want = {k: tree[k].clone() for k in ("a", "b")}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    for k in ("a", "b"):
        tree[k].zero_()
    ptrs = {k: tree[k].data_ptr() for k in ("a", "b")}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = mgr.restore(2, tree)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert got["n"] == 9
    for k in ("a", "b"):
        assert got[k] is tree[k] and got[k].data_ptr() == ptrs[k]
    assert torch.equal(got["a"].view(torch.int16), want["a"].view(torch.int16))
    assert torch.equal(got["b"], want["b"])
    assert grew <= 64 * 2**20, grew


def _probes(values, valid, est):
    """The sort-free search's compares on these inputs (``chip_smoke``'s
    ``probes_of``): each live row's valid count, once a probe."""
    vals = torch.where(valid, values, -1)
    deg = valid.sum(1)
    lo = torch.zeros_like(est)
    hi = est.clamp_min(0).clamp_max(vals.shape[1])
    total = 0
    while bool((lo < hi).any()):
        live = lo < hi
        total += int(deg[live].sum())
        mid = (lo + hi + 1) // 2
        ok = (vals >= mid[:, None]).sum(1) >= mid
        lo = torch.where(live & ok, mid, lo)
        hi = torch.where(live & ~ok, mid - 1, hi)
    return total


def _cost_cases(dev):
    """name -> (the kernel's wrapper, its arguments, the (bytes,
    operations) of the call's bound)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    n, l, m, d = 64, 300, 5000, 128
    idx = torch.randint(0, m, (n, l), generator=gen, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((n, l), generator=gen, device=dev) < 0.6
    emb = torch.randn((m, d), generator=gen, device=dev)
    cnt = int(valid.sum())
    out["ell_mean"] = (ellmean.ell_mean_cuda, (idx, valid, emb),
                       (cnt * d * 4 + n * l * 5 + n * d * 4, cnt * d))
    r, w = 500, 64
    values = torch.randint(0, 80, (r, w), generator=gen, device=dev,
                           dtype=torch.int32)
    hvalid = torch.rand((r, w), generator=gen, device=dev) < 0.7
    est = torch.randint(0, 80, (r,), generator=gen, device=dev,
                        dtype=torch.int32)
    est[:7] = 0
    out["h_index"] = (
        hindex.h_index_cuda, (values, hvalid, est),
        (int(hvalid[est > 0].sum()) * 5 + r * 8,
         _probes(values, hvalid, est)))
    nq, nt, k = 64, 9000, 150  # two rounds of the top-k
    q = torch.randn((nq, d), generator=gen, device=dev)
    table = torch.randn((nt, d), generator=gen, device=dev)
    bias = torch.zeros(nt, device=dev)
    out["top_k"] = (topk.topk_cuda, (q, table, bias, k),
                    (nt * d * 4 + nt * 4 + nq * d * 4 + nq * k * 8,
                     2.0 * nq * nt * d))
    b, kn, dd = 4096, 5, 150
    c, x = (torch.randn((b, dd), generator=gen, device=dev) for _ in "cx")
    ng = torch.randn((b, kn, dd), generator=gen, device=dev)
    dout = torch.randn(b, generator=gen, device=dev)
    in_bytes = (2 * b * dd + b * kn * dd) * 4
    flops = 2.0 * b * dd * (kn + 1)
    out["sgns_fwd"] = (sgns.sgns_fwd_cuda, (c, x, ng),
                       (in_bytes + 4 * b, flops))
    out["sgns_bwd"] = (sgns.sgns_bwd_cuda, (c, x, ng, dout),
                       (2 * in_bytes + 4 * b,
                        flops + 3.0 * b * dd * (kn + 1)))
    bq, h, hkv, dh, s, window = 8, 32, 8, 128, 1088, 700
    qd = torch.randn((bq, h, dh), generator=gen, device=dev).bfloat16()
    kd, vd = (torch.randn((bq, s, hkv, dh), generator=gen,
                          device=dev).bfloat16() for _ in "kv")
    lens = torch.randint(1, s + 40, (bq,), generator=gen, device=dev,
                         dtype=torch.int32)
    lo = (lens - window).clamp_min(0)
    vis = int((lens.clamp_max(s) - lo).clamp_min(0).sum())
    out["decode_attention"] = (
        flash_decode.decode_attention_cuda, (qd, kd, vd, lens, lo),
        (vis * hkv * dh * 2 * 2 + 2 * qd.numel() * 2 + 8 * bq,
         4.0 * vis * h * dh))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ell_mean", "h_index", "top_k", "sgns_fwd",
                                  "sgns_bwd", "decode_attention"])
def test_kernel_wrappers_reckon_the_smoke_formulas(cuda, name):
    """Each wrapper adds, per call, the bytes and operations of the bound
    formulas (written out here apart from ``kernels.cost``, which
    ``chip_smoke.py`` bounds the kernels with) to an open tally."""
    from repro_torch.kernels import cost

    fn, args, (nbytes, nops) = _cost_cases(cuda)[name]
    fn(*args)  # the first call loads the kernel
    with cost.tally() as t:
        fn(*args)
        fn(*args)
    torch.cuda.synchronize()
    assert (t.bytes, t.operations) == (2.0 * nbytes, 2.0 * nops)


@pytest.mark.cuda
def test_compiled_cost_counts_a_lone_ell_mean(cuda):
    """``obs.compiled_cost`` of one ``ops.ell_mean`` call on the card: its
    FLOPs are the kernel's reckoned operations (no aten op of the call does
    arithmetic), its bytes at least the kernel's reckoned bytes, its
    argument and output bytes the tensors' ``nbytes``."""
    from repro_torch.obs import compiled_cost

    _, (idx, valid, emb), (nbytes, nops) = _cost_cases(cuda)["ell_mean"]
    rep = compiled_cost(ops.ell_mean, idx, valid, emb)
    assert rep["flops"] == nops > 0
    assert rep["bytes_accessed"] >= nbytes
    assert rep["argument_bytes"] == idx.nbytes + valid.nbytes + emb.nbytes
    assert rep["output_bytes"] == idx.shape[0] * emb.shape[1] * 4
    assert rep["temp_bytes"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 256, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_with_a_query_offset_on_the_card(cuda, offset,
                                                           dtype):
    """A rank's own 256 query rows of a sequence split four ways (Ulysses:
    rows ``offset:offset + 256`` of 1,024 at ``q_offset``) against every
    key, at gemma2-2b's head dim 256 on its 8 heads and 4 KV heads, logit
    softcap 50 and a window of 300 (it crosses the rank's first row): the
    chunked attention on the card equals the same call on the CPU (fp32
    1e-5, bf16 one rounding of the same fp32 result: rtol 1e-2, atol
    1e-3), and rows ``offset:`` of the whole call."""
    from repro_torch.models.attention import attention_chunked

    gen = torch.Generator().manual_seed(offset)
    S, rows = 1024, 256
    q = torch.randn((1, S, 8, 256), generator=gen).to(dtype)
    k, v = (torch.randn((1, S, 4, 256), generator=gen).to(dtype)
            for _ in "kv")
    kw = dict(causal=True, window=300, softcap=50.0, chunk_q=128,
              chunk_kv=256)
    mine = q[:, offset:offset + rows]
    want = attention_chunked(mine, k, v, q_offset=offset, **kw)
    got = attention_chunked(mine.to(cuda), k.to(cuda), v.to(cuda),
                            q_offset=offset, **kw).cpu()
    whole = attention_chunked(q.to(cuda), k.to(cuda), v.to(cuda),
                              **kw)[:, offset:offset + rows].cpu()
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    for name, x in (("cpu", want), ("whole call", whole)):
        np.testing.assert_allclose(got.float().numpy(), x.float().numpy(),
                                   rtol=tol[0], atol=tol[1], err_msg=name)
