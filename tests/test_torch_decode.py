"""The port's decode attention against the JAX package's.

The same numpy inputs go through ``repro.kernels`` (the jnp reference and
the Pallas flash-decode kernel in interpret mode, as
``tests/kernels/test_flash_decode.py`` runs it) and through
``repro_torch.kernels`` (the plain PyTorch version, which the CPU runs).
Tolerances are those of the JAX kernel tests: 2e-5 in fp32 and 3e-2 in bf16
(the same fp32 arithmetic in another order, then one bf16 rounding of the
output). The CUDA kernel runs only on the card: ``tests/test_torch_cuda.py``
holds it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import quantize_kv_rows as jquantize
from repro_torch.kernels import flash_decode, ops, ref
from repro_torch.models.attention import quantize_kv_rows

CASES = [
    # B, H, Hkv, Dh, S
    (2, 8, 4, 128, 512),
    (1, 4, 4, 128, 1024),  # MHA (G=1)
    (2, 16, 2, 128, 256),
    (3, 8, 8, 256, 512),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(b, h, hkv, dh, s, seed=0, lo=1, hi=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    lens = rng.integers(lo, (hi or s) + 1, b).astype(np.int32)
    return q, k, v, lens


def _both(dtype, *arrays):
    """(jnp arrays, torch tensors) of the numpy arrays, floats in dtype
    (both round float32 to bf16 to nearest even)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
         for a in arrays]
    t = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,H,Hkv,Dh,S", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_jax(B, H, Hkv, Dh, S, dtype):
    (jq, jk, jv, jl), (q, k, v, lens) = _both(dtype,
                                              *_inputs(B, H, Hkv, Dh, S))
    got = ops.decode_attention(q, k, v, lens)  # auto on the CPU: the ref
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jref.decode_attention_ref(jq, jk, jv, jl)
    pallas = jops.decode_attention(jq, jk, jv, jl, impl="pallas_interpret",
                                   block_s=128)
    _close(got, want, TOL[dtype])
    _close(got, pallas, TOL[dtype])


@pytest.mark.parametrize("softcap,window", [(50.0, 0), (0.0, 128),
                                            (30.0, 64)])
def test_decode_variants_match_jax(softcap, window):
    (jq, jk, jv, jl), (q, k, v, lens) = _both(
        "float32", *_inputs(2, 8, 4, 128, 512, seed=1))
    want = jref.decode_attention_ref(jq, jk, jv, jl, softcap=softcap,
                                     window=window)
    pallas = jops.decode_attention(jq, jk, jv, jl, softcap=softcap,
                                   window=window, impl="pallas_interpret",
                                   block_s=128)
    for win in (window, torch.tensor(window)):  # an int or data
        got = ops.decode_attention(q, k, v, lens, softcap=softcap,
                                   window=win)
        _close(got, want, 2e-5)
        _close(got, pallas, 2e-5)


def test_decode_int8_cache_matches_jax():
    """The int8 path of ``tests/unit/test_kv_quant.py``: the rows quantise
    to the same int8 values and scales, and the dequantising decode matches
    the JAX reference and the Pallas kernel."""
    q_, k_, v_, _ = _inputs(2, 8, 4, 128, 256, seed=2)
    lens_ = np.array([77, 200], np.int32)
    (jq, jk, jv, jl), (q, k, v, lens) = _both("float32", q_, k_, v_, lens_)
    jkq, jks = jquantize(jk)
    jvq, jvs = jquantize(jv)
    kq, ks = quantize_kv_rows(k)
    vq, vs = quantize_kv_rows(v)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(jvq))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-7)
    want = jref.decode_attention_ref(jq, jkq, jvq, jl, k_scale=jks,
                                     v_scale=jvs)
    pallas = jops.decode_attention(jq, jkq, jvq, jl, impl="pallas_interpret",
                                   block_s=64, k_scale=jks, v_scale=jvs)
    got = ops.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs)
    _close(got, want, 2e-5)
    _close(got, pallas, 2e-5)


def test_decode_ragged_lengths_ignore_padding():
    q_, k_, v_, _ = _inputs(2, 8, 4, 128, 512, seed=3)
    lens = torch.tensor([100, 333], dtype=torch.int32)
    q, k, v = (torch.from_numpy(a) for a in (q_, k_, v_))
    out1 = ops.decode_attention(q, k, v, lens, softcap=30.0, window=64)
    poison_k, poison_v = k.clone(), v.clone()
    for b, n in enumerate(lens.tolist()):
        poison_k[b, n:] = 1e4
        poison_v[b, n:] = -1e4
    out2 = ops.decode_attention(q, poison_k, poison_v, lens, softcap=30.0,
                                window=64)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    jl = jnp.asarray(lens.numpy())
    pallas = jops.decode_attention(
        jnp.asarray(q_), jnp.asarray(poison_k.numpy()),
        jnp.asarray(poison_v.numpy()), jl, softcap=30.0, window=64,
        impl="pallas_interpret", block_s=128)
    _close(out2, pallas, 2e-5)


def test_decode_lengths_above_cache_end():
    """A finished row that keeps decoding has a length above S: it sees the
    S cached positions (the window measured from its length), as the JAX
    reference and the Pallas kernel's mask give."""
    q_, k_, v_, _ = _inputs(3, 8, 2, 64, 48, seed=4)
    lens_ = np.array([48, 53, 60], np.int32)  # 60 - 16 < 48: visible
    (jq, jk, jv, jl), (q, k, v, lens) = _both("float32", q_, k_, v_, lens_)
    for window in (0, 16):
        got = ops.decode_attention(q, k, v, lens, window=window)
        want = jref.decode_attention_ref(jq, jk, jv, jl, window=window)
        pallas = jops.decode_attention(jq, jk, jv, jl, window=window,
                                       impl="pallas_interpret", block_s=16)
        _close(got, want, 2e-5)
        _close(got, pallas, 2e-5)
    clamped = ops.decode_attention(q, k, v, lens.clamp_max(48))
    torch.testing.assert_close(ops.decode_attention(q, k, v, lens), clamped,
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs on the CPU: it refuses CPU tensors before
    building or launching anything, and ``impl="cuda"`` does not fall back."""
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _inputs(1, 4, 2, 32, 16, seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_decode.decode_attention_cuda(q, k, v, lens, torch.zeros_like(
            lens))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.decode_attention(q, k, v, lens, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.decode_attention(q, k, v, lens, impl="pallas")


# ---- the CUDA kernel's split-and-combine arithmetic, on the CPU ----------
#
# ``csrc/flash_decode.cu`` cuts each row's visible range into ``nsplit`` runs
# of whole 32-position tiles; in a run each of 4 warps keeps an online
# softmax (m, l, acc) over its 8 positions of every tile; the warps are
# combined in warp order into the run's partial, and the runs' partials in
# split order. ``_split_decode`` renders exactly that in plain torch (never
# on a main path) so that the combine, empty runs included, is checked
# where there is no card.

TILE, WARPS = 32, 4
NEG = -1e30


def _combine(m, l, acc):
    """Partials (P, ...), (P, ...), (P, ..., Dh) combined in index order,
    as the kernel's epilogue does: (m, l, acc) of the whole."""
    mx = m.max(0).values
    f = torch.exp(m - mx)
    tot, a = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for j in range(m.shape[0]):
        tot = tot + l[j] * f[j]
        a = a + acc[j] * f[j][..., None]
    return mx, tot, a


def _split_decode(q, k, v, lens, win_lo, nsplit, *, softcap=0.0,
                  k_scale=None, v_scale=None):
    """(B, H, Dh) float32: the kernel's partials per split, per warp."""
    b, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, dh)
    out = torch.zeros(b, hkv, g, dh)
    for bi in range(b):
        end = min(int(lens[bi]), s)
        lo = max(int(win_lo[bi]), 0)
        n = max(end - lo, 0)
        per = -(-(-(-n // nsplit)) // TILE) * TILE
        parts = []
        for j in range(nsplit):
            s_lo = min(lo + j * per, max(end, lo))
            s_hi = min(s_lo + per, end)
            m = torch.full((WARPS, hkv, g), NEG)
            l = torch.zeros(WARPS, hkv, g)
            acc = torch.zeros(WARPS, hkv, g, dh)
            for t0 in range(s_lo, s_hi, TILE):
                pos = torch.arange(t0, t0 + TILE)
                live = pos < s_hi
                at = pos.clamp_max(s - 1)
                kk = k[bi, at].float() * live[:, None, None]  # zero-filled
                vv = v[bi, at].float() * live[:, None, None]
                ks = vs = torch.ones(TILE, hkv)
                if k_scale is not None:
                    ks = k_scale[bi, at] * live[:, None]
                    vs = v_scale[bi, at] * live[:, None]
                d = torch.einsum("cgd,tcd->cgt", qf[bi], kk)
                d = d * ks.T[:, None, :] * float(1.0 / np.sqrt(dh))
                if softcap > 0.0:
                    d = softcap * torch.tanh(d / softcap)
                d = torch.where(live, d, torch.tensor(NEG))
                # warp w owns positions 8w .. 8w + 7 of the tile
                d = d.reshape(hkv, g, WARPS, TILE // WARPS).permute(2, 0, 1, 3)
                mnew = torch.maximum(m, d.max(-1).values)
                p = torch.exp(d - mnew[..., None])
                p = torch.where(live.reshape(WARPS, 1, 1, -1), p,
                                torch.tensor(0.0))
                alpha = torch.exp(m - mnew)
                l = l * alpha + p.sum(-1)
                pv = p * vs.T.reshape(hkv, 1, WARPS, -1).permute(2, 0, 1, 3)
                vw = vv.reshape(WARPS, TILE // WARPS, hkv, dh)
                acc = acc * alpha[..., None] + torch.einsum(
                    "wcgt,wtcd->wcgd", pv, vw)
                m = mnew
            parts.append(_combine(m, l, acc))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        _, tot, a = _combine(m, l, acc)
        out[bi] = a / tot.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, dh)


def _win_lo(lens, window):
    return (lens - window).clamp_min(0) if window > 0 else \
        torch.zeros_like(lens)


SPLIT_CASES = [
    # label, B, H, Hkv, Dh, S, lens, window, softcap
    ("one tile, lengths of 1", 3, 8, 4, 32, 96, [1, 2, 96], 0, 0.0),
    ("rows shorter than a split", 4, 8, 2, 64, 512, [5, 33, 70, 512], 0,
     0.0),
    ("window: the last split only", 2, 4, 4, 32, 512, [512, 300], 40, 0.0),
    ("lengths above S, softcap", 3, 8, 2, 64, 200, [200, 257, 230], 64,
     30.0),
    ("gemma2-2b-like", 2, 8, 4, 256, 384, [384, 129], 100, 50.0),
]


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_combine_matches_jax_ref(case, nsplit):
    """Per split (m, l, acc), the warps and the splits combined in order,
    with empty splits, windows, lengths above S and softcap, against the
    JAX reference. fp32 2e-5: the same fp32 terms summed in another order
    (by tile, warp and split instead of one softmax)."""
    _, b, h, hkv, dh, s, lens_, window, softcap = case
    q_, k_, v_, _ = _inputs(b, h, hkv, dh, s, seed=nsplit + dh)
    lens_ = np.array(lens_, np.int32)
    (jq, jk, jv, jl), (q, k, v, lens) = _both("float32", q_, k_, v_, lens_)
    got = _split_decode(q, k, v, lens, _win_lo(lens, window), nsplit,
                        softcap=softcap)
    want = jref.decode_attention_ref(jq, jk, jv, jl, softcap=softcap,
                                     window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("nsplit", [1, 5])
def test_split_combine_int8_matches_jax_ref(nsplit):
    """The int8 cache: the K scale on the finished dot product, the V scale
    on the softmax weight, as the kernel applies them."""
    q_, k_, v_, _ = _inputs(2, 8, 4, 128, 256, seed=12)
    lens_ = np.array([77, 256], np.int32)
    (jq, jk, jv, jl), (q, k, v, lens) = _both("float32", q_, k_, v_, lens_)
    jkq, jks = jquantize(jk)
    jvq, jvs = jquantize(jv)
    kq, ks = quantize_kv_rows(k)
    vq, vs = quantize_kv_rows(v)
    got = _split_decode(q, kq, vq, lens, _win_lo(lens, 0), nsplit,
                        k_scale=ks, v_scale=vs)
    want = jref.decode_attention_ref(jq, jkq, jvq, jl, k_scale=jks,
                                     v_scale=jvs)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("nsplit", [1, 4])
def test_split_combine_empty_row_is_zero_as_pallas(nsplit):
    """A row with no visible position (its window starts past the cache's
    end) combines to 0, as the Pallas kernel gives; every split of it is
    empty, and no NaN appears. The other rows match the JAX reference."""
    q_, k_, v_, _ = _inputs(3, 8, 2, 64, 64, seed=13)
    lens_ = np.array([64, 100, 40], np.int32)  # row 1: 100 - 16 >= 64
    (jq, jk, jv, jl), (q, k, v, lens) = _both("float32", q_, k_, v_, lens_)
    got = _split_decode(q, k, v, lens, _win_lo(lens, 16), nsplit)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    pallas = jops.decode_attention(jq, jk, jv, jl, window=16,
                                   impl="pallas_interpret", block_s=16)
    _close(got, pallas, 2e-5)
    want = jref.decode_attention_ref(jq, jk, jv, jl, window=16)
    _close(got[[0, 2]], np.asarray(want)[[0, 2]], 2e-5)
