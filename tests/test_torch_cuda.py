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
(at every width, hub rows included), the top-k scores at 1e-5 with ids
equal off near-ties
(fp32 dot products of width d summed in another order), flash-decode 2e-5
with fp32 queries (fp32 or int8 cache) and rtol 1e-2 + atol 1e-3 with bf16
ones (one bf16 rounding of the same fp32 result; int8 caches as their
queries), the LM decode step on the card against the CPU
1e-4 (logits) and 1e-5 (caches), with an int8 cache one quantisation step
and 1e-2 (logits).
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
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8",
                                  "int8-bf16"])
def test_flash_decode_kernel_matches_plain(cuda, dh, g, kind):
    """GQA groups, head dims, cache types; S not a multiple of 32 (48,
    1000); B in {1, 3, 8}; softcap and window; ragged lengths with one above
    S."""
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
    with pytest.raises(ValueError, match="head_dim"):
        fd(q[..., :48].contiguous(), k[..., :48].contiguous(),
           v[..., :48].contiguous(), lens, lo)


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
