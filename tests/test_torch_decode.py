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
