"""The port's kernel entry points against the JAX package's.

The same numpy inputs go through ``repro.kernels`` (the jnp references and
the Pallas kernels in interpret mode, as ``tests/kernels/`` runs them) and
through ``repro_torch.kernels`` (the plain PyTorch versions, which the CPU
runs). Tolerances: the ELL mean 1e-6 in fp32 and 2e-2 in bf16 (summation
order), the h-index exact (integer), the top-k ids exact off near-ties and
scores at 1e-6. The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

ELL_CASES = [
    (8, 4, 16, 128),
    (16, 7, 32, 128),
    (5, 3, 8, 150),
    (12, 1, 4, 256),
]
H_CASES = [(1, 1), (3, 5), (8, 16), (17, 130), (128, 256), (5, 300), (200, 7)]
TOPK_CASES = [
    (1, 1, 1, 1),
    (4, 100, 16, 5),
    (8, 1024, 32, 10),
    (3, 7, 8, 10),
    (17, 513, 130, 13),
    (2, 300, 8, 140),
]
TIE = 1e-6


def _ell_inputs(n, l, m, d, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=(n, l)).astype(np.int32)
    valid = rng.random((n, l)) < 0.7
    emb = rng.standard_normal((m, d)).astype(np.float32)
    return idx, valid, emb


def _h_inputs(r, w, seed=0, max_val=25):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, max_val, (r, w)).astype(np.int32)
    valid = rng.random((r, w)) < 0.6
    est = rng.integers(0, max_val + 5, r).astype(np.int32)
    return vals, valid, est


def _topk_inputs(nq, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < 0.8
    return q, table, valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_topk_close(got_v, got_i, want_v, want_i, tol=1e-6, tie=TIE):
    """Scores at ``tol``; ids equal except at positions whose wanted score is
    within ``tie`` of a neighbour's, compared there as sets."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i, np.int64), np.asarray(want_i, np.int64)
    np.testing.assert_allclose(got_v, want_v, rtol=tol, atol=tol)
    with np.errstate(invalid="ignore"):  # -inf padding: -inf - -inf
        gap = np.abs(np.diff(want_v, axis=1)) <= tie
    near = np.zeros(want_v.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not ((got_i != want_i) & ~near).any()
    for r in range(len(got_i)):
        assert set(got_i[r][near[r]]) == set(want_i[r][near[r]])


# ------------------------------------------------------------- ELL mean ----


@pytest.mark.parametrize("n,l,m,d", ELL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_mean_matches_jax_ref(n, l, m, d, dtype):
    idx, valid, emb = _ell_inputs(n, l, m, d, seed=n * 7 + d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jref.ell_mean_ref(jnp.asarray(idx), jnp.asarray(valid),
                             jnp.asarray(emb, dtype=jdt))
    got = ops.ell_mean(_t(idx), _t(valid), _t(emb).to(tdt))
    assert got.dtype == tdt and got.shape == (n, d)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n,l,m,d", ELL_CASES[:3])
def test_ell_mean_matches_pallas_interpret(n, l, m, d):
    idx, valid, emb = _ell_inputs(n, l, m, d, seed=n + l)
    want = jops.ell_mean(jnp.asarray(idx), jnp.asarray(valid),
                         jnp.asarray(emb), impl="pallas_interpret")
    got = ops.ell_mean(_t(idx), _t(valid), _t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_ell_mean_empty_rows_are_zero():
    idx, valid, emb = _ell_inputs(6, 5, 10, 128, seed=1)
    valid[2] = False
    got = ops.ell_mean(_t(idx), _t(valid), _t(emb))
    assert torch.equal(got[2], torch.zeros(128))


# -------------------------------------------------------------- h-index ----


@pytest.mark.parametrize("r,w", H_CASES)
@pytest.mark.parametrize("impl", ["ref", "count"])
def test_h_index_matches_jax_ref(r, w, impl):
    vals, valid, est = _h_inputs(r, w, seed=r * 31 + w)
    want = np.asarray(jref.h_index_ref(jnp.asarray(vals), jnp.asarray(valid),
                                       jnp.asarray(est)))
    got = ops.h_index_sweep(_t(vals), _t(valid), _t(est), impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,w", H_CASES[:4])
def test_h_index_count_matches_pallas_interpret(r, w):
    vals, valid, est = _h_inputs(r, w, seed=r + w)
    want = np.asarray(jops.h_index_sweep(
        jnp.asarray(vals), jnp.asarray(valid), jnp.asarray(est),
        impl="pallas_interpret",
    ))
    got = ops.h_index_sweep(_t(vals), _t(valid), _t(est))  # auto = count
    np.testing.assert_array_equal(got.numpy(), want)


def test_h_index_all_invalid_rows_are_zero():
    vals, valid, est = _h_inputs(6, 9, seed=3)
    valid[2] = False
    for impl in ("ref", "count"):
        got = ops.h_index_sweep(_t(vals), _t(valid), _t(est), impl=impl)
        assert int(got[2]) == 0


# ---------------------------------------------------------------- top-k ----


@pytest.mark.parametrize("nq,n,d,k", TOPK_CASES)
def test_topk_matches_jax_ref(nq, n, d, k):
    q, table, valid = _topk_inputs(nq, n, d, seed=nq * 7 + n)
    want_v, want_i = jref.topk_ref(jnp.asarray(q), jnp.asarray(table), k,
                                   valid=jnp.asarray(valid))
    got_v, got_i = ops.top_k_scores(_t(q), _t(table), k, valid=_t(valid))
    assert got_v.shape == (nq, k) and got_i.dtype == torch.int32
    assert_topk_close(got_v.numpy(), got_i.numpy(), want_v, want_i)


@pytest.mark.parametrize("nq,n,d,k", TOPK_CASES[1:4])
def test_topk_matches_pallas_interpret(nq, n, d, k):
    q, table, valid = _topk_inputs(nq, n, d, seed=nq * 13 + n + 1)
    want_v, want_i = jops.top_k_scores(
        jnp.asarray(q), jnp.asarray(table), k, valid=jnp.asarray(valid),
        impl="pallas_interpret",
    )
    got_v, got_i = ops.top_k_scores(_t(q), _t(table), k, valid=_t(valid))
    assert_topk_close(got_v.numpy(), got_i.numpy(), want_v, want_i)


def test_topk_ties_break_toward_lower_index():
    table = np.ones((10, 4), np.float32)
    q = np.ones((2, 4), np.float32)
    vals, idx = ops.top_k_scores(_t(q), _t(table), 4)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1, 2, 3]] * 2)
    assert torch.equal(vals, torch.full((2, 4), 4.0))


def test_topk_pads_when_few_rows_are_live():
    q, table, _ = _topk_inputs(3, 6, 8, seed=2)
    valid = np.array([True, False, True, False, False, False])
    vals, idx = ops.top_k_scores(_t(q), _t(table), 4, valid=_t(valid))
    assert (idx.numpy()[:, 2:] == -1).all()
    assert torch.isinf(vals[:, 2:]).all()
    assert set(idx.numpy()[:, :2].ravel()) <= {0, 2}


def test_normalize_rows_matches_jax():
    x = np.random.default_rng(4).normal(size=(7, 33)).astype(np.float32)
    x[3] = 0.0
    want = np.asarray(jops.normalize_rows(jnp.asarray(x)))
    np.testing.assert_allclose(ops.normalize_rows(_t(x)).numpy(), want,
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- dispatch ----


@pytest.mark.parametrize("op", ["ell_mean", "h_index_sweep", "top_k_scores"])
def test_cuda_impl_on_cpu_tensors_raises(op):
    """A CPU tensor never reaches a kernel: asking for one raises."""
    idx, valid, emb = _ell_inputs(4, 3, 8, 16)
    vals, hval, est = _h_inputs(4, 3)
    q, table, tvalid = _topk_inputs(2, 8, 16)
    call = {
        "ell_mean": lambda: ops.ell_mean(_t(idx), _t(valid), _t(emb),
                                         impl="cuda"),
        "h_index_sweep": lambda: ops.h_index_sweep(_t(vals), _t(hval),
                                                   _t(est), impl="cuda"),
        "top_k_scores": lambda: ops.top_k_scores(_t(q), _t(table), 3,
                                                 impl="cuda"),
    }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_unknown_impl_raises():
    idx, valid, emb = _ell_inputs(4, 3, 8, 16)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ell_mean(_t(idx), _t(valid), _t(emb), impl="pallas")


def test_topk_chunking_covers_the_table():
    from repro_torch.kernels import topk

    for n, nq in [(1, 1), (37701, 64), (1 << 21, 64), (5000, 200)]:
        chunks, rows = topk.chunking(n, nq)
        assert rows % 64 == 0 and chunks * rows >= n > (chunks - 1) * rows
    for d in (1, 4, 128, 130, 436):
        dp = topk.padded_width(d)
        assert dp >= d and dp % 4 == 0 and (dp // 4) % 8 == 1
