"""The port's SSM and hybrid families against the JAX package's, on the CPU.

``models/mamba2`` (the chunked SSD and its sequential oracle, the block's
full forward with its state, one-token decode), ``rms_norm_groups``, and
for reduced mamba2-2.7b (4 mamba blocks) and reduced zamba2-7b (7 blocks:
3 groups of 2, each followed by the shared attention block with its LoRA,
and 1 trailing block) the prefill and decode, and the continuous-batching
schedule of ``launch/serve``: the same weights (the JAX ``init_model``
tree carried across by ``from_jax_params``) and numpy inputs through both
packages, fp32. The reduced chunk is 32; the prompts here are not multiples
of it: at 48 the chunk halves to 16 as in the JAX package, at 12 it is the
whole prompt.
Tolerances: a single module 1e-5, a whole model's logits 1e-4, caches 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtf
from repro.models.steps import make_decode_step as jmake_decode_step
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import layers, mamba2, transformer
from test_torch_lm import _check_cache, _jax_schedule, _leaves, _np

ARCHS = ["mamba2-2.7b", "zamba2-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _weights(jcfg, tcfg, seed=0):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    return jparams, tparams


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_configs_match_jax(arch, full):
    assert arch in list_archs()
    j, t = jget_config(arch), get_config(arch)
    if not full:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                     "embed_scale": False}
    assert t.ssm.d_inner(t.d_model) == j.ssm.d_inner(j.d_model)
    assert t.ssm.n_heads(t.d_model) == j.ssm.n_heads(j.d_model)
    if arch == "zamba2-7b":
        assert transformer.hybrid_layout(t) == jtf.hybrid_layout(j)


def test_zamba2_layout():
    """Full width: 13 groups of 6 mamba blocks and 3 trailing; reduced: 3
    groups of 2 and 1 trailing."""
    assert transformer.hybrid_layout(get_config("zamba2-7b")) == (13, 6, 3)
    assert transformer.hybrid_layout(get_config("zamba2-7b").reduced()) == \
        (3, 2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_tree_matches_jax(arch):
    """The port's own ``init_model``: the JAX tree's names, shapes and
    dtypes, with the JAX package's deterministic leaves (norms, conv bias,
    skip; a_log = log(1..h) within an fp32 ulp: another log) and its
    dt_bias in the range of its draw."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert _leaves(tparams) == _leaves(jparams)
    tm, jm = tparams["layers"]["mamba"], jparams["layers"]["mamba"]
    for key in ("conv_b", "d_skip", "norm_scale"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    np.testing.assert_allclose(tm["a_log"].numpy(), np.asarray(jm["a_log"]),
                               rtol=2e-7, atol=0)
    dt0 = torch.nn.functional.softplus(tm["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001
    if arch == "zamba2-7b":
        assert not tparams["loras"]["qB"].any()  # LoRAs start as identity


def test_rms_norm_groups_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rms_norm_groups(jnp.asarray(x), jnp.asarray(scale), 4)
    got = layers.rms_norm_groups(torch.from_numpy(x), torch.from_numpy(scale),
                                 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ssd_inputs(S, seed=0, B=2, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    Bi = (rng.standard_normal((B, S, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((B, S, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, Bi, C


@pytest.mark.parametrize("S,chunk", [(48, 32), (64, 32), (64, 16)])
def test_ssd_matches_jax(S, chunk):
    """``ssd_chunked`` (S = 48: the chunk halves to 16; S = 64: two or four
    chunks) and ``ssd_reference`` against the JAX package's both; the
    chunked form against the sequential oracle at the JAX unit test's
    2e-4 (fp32 sums of another shape)."""
    args = _ssd_inputs(S)
    kw = dict(h_per_g=2)
    jref = jmamba.ssd_reference(*map(jnp.asarray, args), **kw)
    jch = jmamba.ssd_chunked(*map(jnp.asarray, args), chunk=chunk, **kw)
    targs = [torch.from_numpy(a) for a in args]
    tref = mamba2.ssd_reference(*targs, **kw)
    tch = mamba2.ssd_chunked(*targs, chunk=chunk, **kw)
    for got, want in ((tref, jref), (tch, jch)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for g, w in zip(tch, tref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_mamba_forward_and_decode_match_jax():
    """``mamba_forward`` with its state (S = 48) and three ``mamba_decode``
    steps chained from it, against the JAX package's, output and state."""
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp = jax.tree.map(np.asarray, jmamba.init_mamba(jax.random.PRNGKey(1),
                                                    jcfg))
    tp = _t(jp)
    x = (np.random.default_rng(1).standard_normal((2, 51, tcfg.d_model))
         * 0.3).astype(np.float32)
    jy, jstate = jmamba.mamba_forward(jp, jnp.asarray(x[:, :48]), jcfg,
                                      return_state=True)
    ty, tstate = mamba2.mamba_forward(tp, torch.from_numpy(x[:, :48]), tcfg,
                                      return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for t in range(48, 51):
        for g, w in zip(tstate, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        jy, jstate = jmamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                         *jstate, jcfg)
        ty, tstate = mamba2.mamba_decode(tp, torch.from_numpy(
            x[:, t:t + 1]), *tstate, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    conv, ssd = mamba2.init_mamba_cache(3, tcfg, device="cpu")
    jconv, jssd = jmamba.init_mamba_cache(3, jcfg)
    assert conv.shape == jconv.shape and ssd.shape == jssd.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``forward_prefill`` over 48 positions (logits and every cache leaf:
    conv, ssd and, for zamba2, one KV pair per group and the tail's state),
    then four teacher-forced ``forward_decode`` steps, the in-place cache
    against the JAX functional one."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _weights(jcfg, tcfg)
    rng = np.random.default_rng(0)
    prompt, new = 48, 4
    toks = rng.integers(2, tcfg.vocab_size, (2, prompt)).astype(np.int32)
    forced = rng.integers(2, tcfg.vocab_size, (2, new)).astype(np.int32)
    max_len = prompt + new
    jh, jcache = jax.jit(lambda p, t: jtf.forward_prefill(
        p, jcfg, tokens=t, max_len=max_len))(jparams, jnp.asarray(toks))
    th, tcache = transformer.forward_prefill(
        tparams, tcfg, tokens=torch.from_numpy(toks), max_len=max_len)
    np.testing.assert_allclose(
        _np(transformer.logits_from_hidden(tparams, th, tcfg)),
        _np(jtf.logits_from_hidden(jparams, jh, jcfg)), rtol=1e-4, atol=1e-4)
    _check_cache(tcache, jcache, 1e-5)
    jdecode = jax.jit(jmake_decode_step(jcfg))
    for t in range(new):
        tok = forced[:, t:t + 1]
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = transformer.forward_decode(
            tparams, tcache, torch.from_numpy(tok), tcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4)
        _check_cache(tcache, jcache, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_matches_jax(arch):
    """The training forward (remat per block or per group) against the JAX
    package's: hidden states, and no aux losses."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _weights(jcfg, tcfg)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 24))
    jh, jaux = jtf.forward_full(jparams, jcfg, tokens=jnp.asarray(toks))
    th, taux = transformer.forward_full(tparams, tcfg,
                                        tokens=torch.from_numpy(toks))
    assert taux == {} and jaux == {}
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_schedule_matches_jax(arch):
    """``--slots 2 --requests 5 --prompt-len 12 --max-new 4`` on both
    packages with the same weights: every slot's token at every step, the
    rows swapped (each swap copies a B = 1 prefill into the row of every
    cache leaf on its batch axis: 1 for conv/ssd of mamba2, 2 for zamba2's
    grouped conv/ssd, 1 for its KV and tail), and the final caches equal."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _weights(jcfg, tcfg)
    requests = serve.make_requests(tcfg.vocab_size, 5, 12, seed=0)
    want, n, jcache, swaps = _jax_schedule(jcfg, jparams, requests, 2, 4)
    res = serve.serve(tcfg, tparams, requests, slots=2, max_new=4,
                      device="cpu")
    assert res.n_decoded == n == 24 and res.served == 5
    assert swaps == [0, 1, 0]
    np.testing.assert_array_equal(res.step_tokens, want)
    _check_cache(res.cache, jcache, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_axes_match_jax(arch):
    from repro.launch import serve as jserve

    jcfg, tcfg = _cfgs(arch)
    axes = serve.cache_batch_axes(tcfg)
    assert axes == jserve.cache_batch_axes(jcfg)
    cache = transformer.init_cache(tcfg, 3, 16, device="cpu")
    assert set(cache) == set(axes)
    for key, ax in axes.items():
        assert cache[key].shape[ax] == 3, key


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_as_jax_does(arch):
    from repro.launch import serve as jserve

    flags = ["--arch", arch, "--preset", "reduced", "--slots", "2",
             "--requests", "3", "--prompt-len", "8", "--max-new", "3"]
    assert serve.main(flags + ["--device", "cpu"]) == jserve.main(flags)
