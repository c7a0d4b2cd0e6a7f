"""The port's LM serving path against the JAX package's, on the CPU.

Layers, prefill attention, the dense transformer's prefill and decode, and
the continuous-batching schedule of ``launch/serve``: the same weights (the
JAX ``init_model`` tree carried across by ``from_jax_params``) and the same
numpy inputs through both packages. Configs: reduced qwen3-4b with
``n_heads=8, n_kv_heads=2`` (G = 4: ``reduced()`` alone gives G = 1),
reduced gemma2-2b with ``sliding_window=6`` (the window masks at a prompt
length of 8; softcaps, post-norms, GeGLU, the embedding scale), and the
qwen3 one with an int8 KV cache. Tolerances, fp32: logits 1e-4 (four
layers of matmuls of width 128-256, summed in another order), caches 1e-5,
int8 caches equal; one bf16 case within 3e-2 x max|logit| (bf16 rounds at other places in the
two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.steps import make_decode_step as jmake_decode_step
from repro.models.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import attention, layers, transformer

CONFIGS = {
    "qwen3-gqa": ("qwen3-4b", dict(n_heads=8, n_kv_heads=2), {}),
    "gemma2-window": ("gemma2-2b", dict(sliding_window=6), {}),
    "qwen3-int8": ("qwen3-4b", dict(n_heads=8, n_kv_heads=2),
                   dict(kv_quant=True)),
    "qwen3-bf16": ("qwen3-4b", dict(n_heads=8, n_kv_heads=2),
                   dict(param_dtype="bfloat16", compute_dtype="bfloat16")),
}
B, PROMPT, NEW = 2, 8, 4


def _cfgs(name):
    arch, red, extra = CONFIGS[name]
    jcfg = dataclasses.replace(jget_config(arch).reduced(**red), **extra)
    tcfg = dataclasses.replace(get_config(arch).reduced(**red), **extra)
    return jcfg, tcfg


def _weights(jcfg, tcfg, seed=0):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    return jparams, tparams


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-2b"])
def test_configs_match_jax(arch):
    assert arch in list_archs()
    for over in ({}, dict(n_heads=8, n_kv_heads=2)):
        for full in (True, False):
            j, t = jget_config(arch), get_config(arch)
            if not full:
                j, t = j.reduced(**over), t.reduced(**over)
            # embed_scale is the port's own field: the JAX package takes
            # the sqrt(d) embedding scale from the name
            assert t.embed_scale == j.name.startswith("gemma")
            assert dataclasses.asdict(dataclasses.replace(
                t, embed_scale=False)) == {**dataclasses.asdict(j),
                                           "embed_scale": False}
            assert t.q_per_kv == j.q_per_kv
            assert [t.layer_is_local(i) for i in range(t.n_layers)] == \
                [j.layer_is_local(i) for i in range(j.n_layers)]
            assert t.pdtype() == getattr(torch, j.pdtype().name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_model_tree_matches_jax(name):
    """The port's own ``init_model`` gives the JAX tree's shapes and dtypes,
    and draws the same distributions (std 1/sqrt(fan-in), 0.02, norms 1)."""
    jcfg, tcfg = _cfgs(name)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.init_model(
        tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _leaves(tparams) == _leaves(jparams)
    wq = tparams["layers"]["attn"]["wq"].float()
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    emb = tparams["embed"]["embedding"].float()
    assert abs(float(emb.std()) / 0.02 - 1) < 0.05
    assert bool((tparams["final_norm"]["scale"] == 1).all())


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(norm_type):
    jcfg, tcfg = _cfgs("qwen3-gqa")
    jcfg = dataclasses.replace(jcfg, norm_type=norm_type)
    tcfg = dataclasses.replace(tcfg, norm_type=norm_type)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(128).astype(np.float32),
         "bias": rng.standard_normal(128).astype(np.float32)}
    if norm_type == "rmsnorm":
        del p["bias"]
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction):
    jcfg, tcfg = _cfgs("qwen3-gqa")
    jcfg = dataclasses.replace(jcfg, rope_fraction=fraction)
    tcfg = dataclasses.replace(tcfg, rope_fraction=fraction)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 6)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    inv, rot = layers.rope_frequencies(32, fraction, tcfg.rope_theta)
    jinv, jrot = jlayers.rope_frequencies(32, fraction, jcfg.rope_theta)
    assert rot == jrot
    np.testing.assert_array_equal(inv, np.asarray(jinv))


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_jax(mlp_type):
    jcfg, tcfg = _cfgs("qwen3-gqa")
    jcfg = dataclasses.replace(jcfg, mlp_type=mlp_type)
    tcfg = dataclasses.replace(tcfg, mlp_type=mlp_type)
    jp = jlayers.init_mlp(jax.random.PRNGKey(2), jcfg, 128, 256)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 128)).astype(
        np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = layers.apply_mlp(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 24, 0.0), (True, 0, 50.0), (False, 0, 30.0),
    (True, 40, 50.0)])
def test_prefill_attention_matches_jax(causal, window, softcap):
    """Chunked (online softmax, skipped invisible chunks) and reference
    prefill attention, G = 4, against the JAX package's."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 128, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_ref = attention.attention_reference(tq, tk, tv, **kw)
    got_chunk = attention.attention_chunked(tq, tk, tv, chunk_q=32,
                                            chunk_kv=32, **kw)
    want_chunk = jattn.attention_chunked(*map(jnp.asarray, (q, k, v)),
                                         chunk_q=32, chunk_kv=32, **kw)
    for got in (got_ref, got_chunk):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got_chunk.numpy(), np.asarray(want_chunk),
                               rtol=1e-5, atol=1e-5)


def _prompts(vocab, n=B, length=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (n, length)).astype(
        np.int32)


def _check_cache(tcache, jcache, tol):
    assert set(tcache) == set(jcache)
    for key in jcache:
        want = np.asarray(jcache[key])
        got = tcache[key]
        if want.dtype in (np.int8, np.int32):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
        else:
            np.testing.assert_allclose(_np(got), want.astype(np.float32),
                                       rtol=tol, atol=tol, err_msg=key)


def _close_logits(got, want, name):
    if name == "qwen3-bf16":
        tol = 3e-2 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_match_jax(name):
    """``forward_prefill`` logits (every position) and cache, then four
    teacher-forced ``forward_decode`` steps: logits and the cache after each
    (the in-place update against the JAX functional one)."""
    jcfg, tcfg = _cfgs(name)
    jparams, tparams = _weights(jcfg, tcfg)
    toks = _prompts(tcfg.vocab_size)
    forced = _prompts(tcfg.vocab_size, length=NEW, seed=1)
    max_len = PROMPT + NEW
    jh, jcache = jax.jit(lambda p, t: jtf.forward_prefill(
        p, jcfg, tokens=t, max_len=max_len))(jparams, jnp.asarray(toks))
    jlog = jtf.logits_from_hidden(jparams, jh, jcfg)
    th, tcache = transformer.forward_prefill(
        tparams, tcfg, tokens=torch.from_numpy(toks), max_len=max_len)
    tlog = transformer.logits_from_hidden(tparams, th, tcfg)
    bf16 = name == "qwen3-bf16"
    _close_logits(_np(tlog), _np(jlog), name)
    if not bf16:
        _check_cache(tcache, jcache, 1e-5)
    jdecode = jax.jit(jmake_decode_step(jcfg))
    for t in range(NEW):
        tok = forced[:, t:t + 1]
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = transformer.forward_decode(
            tparams, tcache, torch.from_numpy(tok), tcfg)
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        _close_logits(_np(tlog), _np(jlog), name)
        if not bf16:
            _check_cache(tcache, jcache, 1e-5)


def _jax_schedule(jcfg, jparams, requests, slots, max_new):
    """The JAX launcher's loop (``repro.launch.serve.main``) on the JAX
    package's steps, ``cache_batch_axes`` and ``_set_row``, recording every
    slot's token at every decode step and the row of every swap."""
    queue = list(requests)
    prefill = jax.jit(jmake_prefill_step(jcfg, max_len=len(queue[0])
                                         + max_new))
    decode = jax.jit(jmake_decode_step(jcfg))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(
        np.stack([queue.pop(0) for _ in range(slots)]))})
    remaining = [max_new] * slots
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    steps, n_decoded, swaps = [], 0, []
    while True:
        logits, cache = decode(jparams, cache, tok)
        n_decoded += slots
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(tok[:, 0]))
        done = []
        for b in range(slots):
            remaining[b] -= 1
            if remaining[b] <= 0:
                done.append(b)
        if done and queue:
            for b in done:
                if not queue:
                    break
                _, row = prefill(jparams, {"tokens": jnp.asarray(
                    queue.pop(0)[None])})
                axes = jserve.cache_batch_axes(jcfg)
                cache = {k: jserve._set_row(cache[k], row[k], b, axes[k])
                         for k in cache}
                remaining[b] = max_new
                swaps.append(b)
        elif done and not queue:
            if all(r <= 0 for r in remaining):
                break
    return np.stack(steps), n_decoded, cache, swaps


@pytest.mark.parametrize("name", ["qwen3-gqa", "gemma2-window"])
def test_serving_schedule_matches_jax(name):
    """``--slots 2 --requests 5 --prompt-len 8 --max-new 4`` on both
    packages with the same weights: the same 12 steps, every slot's token
    equal at every step (two swap rounds, three rows swapped in, and a
    finished row that decodes past its cache's end for four steps, its
    writes dropped), and the final caches and lengths equal."""
    jcfg, tcfg = _cfgs(name)
    jparams, tparams = _weights(jcfg, tcfg)
    requests = serve.make_requests(tcfg.vocab_size, 5, PROMPT, seed=0)
    want, n, jcache, swaps = _jax_schedule(jcfg, jparams, requests, 2, NEW)
    res = serve.serve(tcfg, tparams, requests, slots=2, max_new=NEW,
                      device="cpu")
    assert res.n_decoded == n == 24 and res.served == 5
    assert swaps == [0, 1, 0]  # the rows the reference swapped
    np.testing.assert_array_equal(res.step_tokens, want)
    assert [len(s) for s in res.streams] == [NEW] * 5
    assert int(res.cache["len"].max()) > PROMPT + NEW  # over-ran its cache
    _check_cache(res.cache, jcache, 1e-5)


def test_main_n_decoded_matches_jax():
    flags = ["--arch", "qwen3-4b", "--preset", "reduced", "--slots", "2",
             "--requests", "5", "--prompt-len", "8", "--max-new", "4"]
    assert serve.main(flags + ["--device", "cpu"]) == jserve.main(flags)


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--preset", "reduced"])
