"""The port's encoder-decoder family against the JAX package's, on the CPU.

Reduced seamless-m4t-large-v2 (2 encoder + 4 decoder blocks, MHA, layernorm,
GELU, a tied embedding), fp32: the same weights (the JAX ``init_model`` tree
carried across by ``from_jax_params``) and the same numpy inputs (decoder
prompts of 16 tokens, 8 frames of audio embeddings: S / 4, at least 8, the
JAX package's rule) through both packages. Held: the init tree (a cross
block has no qk-norm scales), the cross-attention sublayer (``kv_override``)
and non-causal attention (1e-5), ``forward_full`` (1e-5), ``loss_fn``
(loss 1e-5, every gradient 1e-4), the prefill step (logits and every cache
leaf, ``cross_k`` / ``cross_v`` included, 1e-5) and four greedy decode
steps, each of which runs flash-decode's plain version twice a layer (self
and cross; tokens equal, logits and cache 1e-5). Both launchers refuse the
family, as the JAX package's do (its training launcher by a ValueError).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.steps import loss_fn as jloss_fn
from repro.models.steps import make_decode_step as jmake_decode_step
from repro.models.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import attention, transformer
from repro_torch.models.steps import (loss_fn, make_decode_step,
                                      make_prefill_step)
from test_torch_lm import _check_cache, _leaves, _np

ARCH = "seamless-m4t-large-v2"
B, S, T, NEW = 2, 16, 8, 4
TOL = 1e-5


def _cfgs(**extra):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **extra),
            dataclasses.replace(get_config(ARCH).reduced(), **extra))


def _weights(jcfg, tcfg, seed=0):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    return jparams, tparams


def _batch(vocab, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, vocab, (B, S)).astype(np.int32),
            "src_embeds": (rng.standard_normal((B, T, d)) * 0.02).astype(
                np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_init_model_tree_matches_jax(qk_norm):
    """The port's own ``init_model``: the JAX tree's names, shapes and dtypes
    (``encoder``, ``enc_norm``, each decoder block's ``cross_norm`` and
    ``cross_attn``; with qk-norm on, the self-attention blocks have its
    scales and the cross blocks none), and the JAX package's
    distributions."""
    jcfg, tcfg = _cfgs(qk_norm=qk_norm)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert _leaves(tparams) == _leaves(jparams)
    assert {"encoder", "enc_norm"} <= set(tparams)
    assert {"cross_norm", "cross_attn"} <= set(tparams["layers"])
    assert "cross_attn" not in tparams["encoder"]
    assert ("q_norm" in tparams["layers"]["attn"]) == qk_norm
    assert "q_norm" not in tparams["layers"]["cross_attn"]
    wq = tparams["layers"]["cross_attn"]["wq"]
    assert wq.shape[0] == tcfg.n_layers
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05


@pytest.mark.parametrize("mode", ["cross", "non-causal"])
def test_attention_sublayer_matches_jax(mode):
    """``apply_attention`` as the cross sublayer (queries of 16 positions
    over ``kv_override``, 8 frames, no rope) and as the encoder's
    non-causal self-attention, against the JAX package's."""
    jcfg, tcfg = _cfgs()
    cross = mode == "cross"
    jp = jattn.init_attention(jax.random.PRNGKey(3), jcfg, cross=cross)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    if cross:
        want = jattn.apply_attention(jp, jnp.asarray(x), jcfg, causal=False,
                                     kv_override=jnp.asarray(enc))
        got = attention.apply_attention(tp, torch.from_numpy(x), tcfg,
                                        causal=False,
                                        kv_override=torch.from_numpy(enc))
    else:
        want = jattn.apply_attention(jp, jnp.asarray(x), jcfg, causal=False)
        got = attention.apply_attention(tp, torch.from_numpy(x), tcfg,
                                        causal=False)
        causal = attention.apply_attention(tp, torch.from_numpy(x), tcfg)
        assert not torch.allclose(causal, got, atol=1e-3)
    _close(got, want)


def test_forward_full_matches_jax():
    """The encoder over the frames, then the decoder cross-attending to it:
    the hidden states of every position."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(jcfg, tcfg)
    jb, tb = _both(_batch(tcfg.vocab_size, tcfg.d_model))
    jh, jaux = jax.jit(lambda p, b: jtf.forward_full(
        p, jcfg, tokens=b["tokens"], enc_embeds=b["src_embeds"]))(jparams, jb)
    th, taux = transformer.forward_full(tparams, tcfg, tokens=tb["tokens"],
                                        enc_embeds=tb["src_embeds"])
    assert th.shape == (B, S, tcfg.d_model) and taux == {} == jaux
    _close(th, jh)
    # the frames matter: other frames, another decoder output
    other, _ = transformer.forward_full(tparams, tcfg, tokens=tb["tokens"],
                                        enc_embeds=tb["src_embeds"] * 2)
    assert not torch.allclose(other, th, atol=1e-4)


def test_loss_fn_matches_jax():
    """``loss_fn`` with ``src_embeds`` in the batch: the loss, and the
    gradient of every leaf (the encoder's through the cross-attention)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(tcfg.vocab_size, tcfg.d_model, seed=5)
    rng = np.random.default_rng(6)
    batch["targets"] = rng.integers(0, tcfg.vocab_size, (B, S)).astype(
        np.int32)
    batch["mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    jb, tb = _both(batch)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jcfg), has_aux=True)(jparams)
    leaves = [p.requires_grad_() for p in jax.tree.leaves(tparams)]
    tloss, tm = loss_fn(tparams, tb, tcfg)
    assert set(tm) == set(jm) == {"xent", "loss"}
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(tloss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    names = list(_leaves(jgrads))
    assert any(n.startswith("/encoder") for n in names)
    for name, g, jg in zip(sorted(names), grads, jleaves):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(jg).max()),
                                   err_msg=name)


def _prefill_both(jcfg, tcfg, jparams, tparams, batch):
    jb, tb = _both(batch)
    max_len = S + NEW
    jlog, jcache = jax.jit(jmake_prefill_step(jcfg, max_len=max_len))(
        jparams, jb)
    tlog, tcache = make_prefill_step(tcfg, max_len=max_len)(tparams, tb)
    return jlog, jcache, tlog, tcache


def test_prefill_step_matches_jax():
    """``make_prefill_step`` with ``src_embeds``: the last position's
    logits, and every cache leaf (``k``, ``v`` of the decoder's
    self-attention, ``cross_k``, ``cross_v`` of the encoder's output, T
    positions a layer; ``len``)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(jcfg, tcfg)
    jlog, jcache, tlog, tcache = _prefill_both(
        jcfg, tcfg, jparams, tparams, _batch(tcfg.vocab_size, tcfg.d_model))
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    _close(tlog, jlog)
    assert set(tcache) == {"len", "k", "v", "cross_k", "cross_v"}
    assert tcache["cross_k"].shape == (tcfg.n_layers, B, T, tcfg.n_kv_heads,
                                       tcfg.head_dim)
    _check_cache(tcache, jcache, TOL)


def test_greedy_decode_matches_jax():
    """Prefill, then four greedy ``make_decode_step`` steps on both
    packages: the same tokens, logits and caches after every step (the
    cross K/V untouched, ``len`` + 1 a step)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(jcfg, tcfg)
    jlog, jcache, tlog, tcache = _prefill_both(
        jcfg, tcfg, jparams, tparams,
        _batch(tcfg.vocab_size, tcfg.d_model, seed=1))
    cross = tcache["cross_k"].clone()
    jdecode = jax.jit(jmake_decode_step(jcfg))
    tdecode = make_decode_step(tcfg)
    for step in range(NEW):
        jtok = jnp.argmax(jlog[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ttok = tlog[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = jdecode(jparams, jcache, jtok)
        tlog, tcache = tdecode(tparams, tcache, ttok)
        _close(tlog, jlog, msg=f"step {step}")
        _check_cache(tcache, jcache, TOL)
    assert torch.equal(tcache["cross_k"], cross)
    assert tcache["len"].tolist() == [S + NEW] * B


def check_launchers_refuse(arch):
    """Both of the port's launchers refuse ``arch`` with a message, as the
    JAX package's serving launcher does; the JAX training launcher fails on
    it with a ValueError (its batch sharding names ask for inputs its
    synthetic batch lacks)."""
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain

    flags = ["--arch", arch, "--preset", "reduced"]
    with pytest.raises(SystemExit, match="decoder-only text archs"):
        serve.main(flags + ["--device", "cpu", "--requests", "2"])
    with pytest.raises(SystemExit, match="decoder-only text archs"):
        jserve.main(flags + ["--requests", "2"])
    with pytest.raises(SystemExit, match=f"does not train {arch}"):
        train.main(flags + ["--device", "cpu", "--steps", "2", "--batch",
                            "2", "--seq", "32"])
    with pytest.raises(ValueError, match="Dict key mismatch"):
        jtrain.main(flags + ["--steps", "2", "--batch", "2", "--seq", "32"])


def test_launchers_refuse_encdec():
    check_launchers_refuse(ARCH)
