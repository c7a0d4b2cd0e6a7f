"""The port's M-RoPE / vision frontend against the JAX package's, on the CPU.

Reduced qwen2-vl-7b with ``n_heads=14, n_kv_heads=2`` (G = 7: ``reduced()``
alone gives G = 1; M-RoPE sections (8, 4, 4) of head dim 32), fp32, the
same weights (the JAX ``init_model`` tree carried across by
``from_jax_params``) and numpy inputs through both packages. The prompt is
a 4 x 4 grid of patch embeddings in the first 16 slots, then 8 text tokens;
its M-RoPE positions differ by stream (t = 0, h = i // 4, w = i % 4 on the
grid, then 4, 5, ... on all three), so a section that took the wrong
stream would show. Held: ``apply_mrope`` at the full head dim (128,
sections (16, 24, 24)) and the reduced one (1e-6), attention at (3, B, S)
positions with and without sections (the latter rotates by stream 0),
``forward_full`` (1e-5), ``loss_fn`` (loss 1e-5, gradients 1e-4), the
prefill step (1e-5) and four greedy decode steps (flash-decode's plain
version at G = 7; tokens equal, logits and cache 1e-5), the decode's
rotation at the cache length on all three streams in both packages, and
both launchers' refusals. The port's train step at ``accum_steps=2``
(``positions`` split along axis 1) is held to its unsplit step (rtol
1e-5, atol 1e-6): the JAX package's fails on this batch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.steps import loss_fn as jloss_fn
from repro.models.steps import make_decode_step as jmake_decode_step
from repro.models.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config
from repro_torch.models import attention, layers, transformer
from repro_torch.models.steps import (loss_fn, make_decode_step,
                                      make_prefill_step)
from test_torch_encdec import check_launchers_refuse
from test_torch_lm import _check_cache, _leaves, _np

ARCH = "qwen2-vl-7b"
GQA = dict(n_heads=14, n_kv_heads=2)  # G = 7
B, GRID, TEXT, NEW = 2, 4, 8, 4
P = GRID * GRID
S = P + TEXT
TOL = 1e-5


def _cfgs(**over):
    return jget_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)


def _weights(jcfg, tcfg, seed=0):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    return jparams, tparams


def mrope_positions(b, grid, text):
    """(3, b, grid^2 + text) int32: a grid x grid patch grid (t = 0,
    h = i // grid, w = i % grid), then text from ``grid`` on all three
    streams."""
    i = np.arange(grid * grid)
    patch = np.stack([np.zeros_like(i), i // grid, i % grid])
    txt = np.broadcast_to(grid + np.arange(text), (3, text))
    pos = np.concatenate([patch, txt], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b,
                                                               pos.shape[1])))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "vision_embeds": (rng.standard_normal((B, P, cfg.d_model))
                              * 0.02).astype(np.float32),
            "positions": mrope_positions(B, GRID, TEXT)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def test_mrope_positions_differ_by_stream():
    pos = mrope_positions(1, GRID, TEXT)[:, 0]
    assert pos.shape == (3, S)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    assert pos[:, P:].tolist() == [list(range(GRID, GRID + TEXT))] * 3
    assert pos.max() == GRID + TEXT - 1 < S - 1


@pytest.mark.parametrize("preset", ["full", "reduced"])
def test_apply_mrope_matches_jax(preset):
    """At qwen2-vl's full head dim (128, sections (16, 24, 24)) and the
    reduced one (32, (8, 4, 4)), positions from a 4 x 4 grid and text: the
    JAX package's values within 1e-6; with all three streams equal, plain
    RoPE's."""
    jcfg, tcfg = (jget_config(ARCH), get_config(ARCH)) if preset == "full" \
        else _cfgs(**GQA)
    assert tcfg.mrope_sections == jcfg.mrope_sections
    assert sum(tcfg.mrope_sections) == tcfg.head_dim // 2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, 3, tcfg.head_dim)).astype(np.float32)
    pos = mrope_positions(B, GRID, TEXT) * 37  # angles well past 2 pi
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    same = torch.from_numpy(pos[:1]).expand(3, B, S)
    assert torch.equal(layers.apply_mrope(torch.from_numpy(x), same, tcfg),
                       layers.apply_rope(torch.from_numpy(x), same[0], tcfg))


@pytest.mark.parametrize("sections", [True, False])
def test_attention_at_mrope_positions_matches_jax(sections):
    """``apply_attention`` (G = 7) at (3, B, S) positions: M-RoPE with the
    config's sections; without sections, RoPE at stream 0 (t), as the JAX
    package does."""
    jcfg, tcfg = _cfgs(**GQA)
    if not sections:
        jcfg = dataclasses.replace(jcfg, mrope_sections=None)
        tcfg = dataclasses.replace(tcfg, mrope_sections=None)
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    pos = mrope_positions(B, GRID, TEXT)
    want = jattn.apply_attention(
        jp, jnp.asarray(x), jcfg,
        inputs=jattn.AttnInputs(positions=jnp.asarray(pos)))
    got = attention.apply_attention(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.from_numpy(pos))
    _close(got, want)
    t_only = attention.apply_attention(tp, torch.from_numpy(x), tcfg,
                                       positions=torch.from_numpy(pos[0]))
    assert torch.equal(t_only, got) != sections


def test_init_model_tree_matches_jax():
    jcfg, tcfg = _cfgs(**GQA)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert _leaves(tparams) == _leaves(jparams)
    assert "unembed" in tparams["embed"]
    assert tparams["layers"]["attn"]["wk"].shape[2] == 2


def _inputs(tcfg, tparams, batch):
    """The embeddings the steps build: the patch embeddings in the first P
    slots, the text tokens' after them."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    h = transformer.embed_tokens(tparams, tb["tokens"], tcfg)
    return torch.cat([tb["vision_embeds"], h[:, P:]], 1), tb["positions"]


def test_forward_full_matches_jax():
    """``forward_full`` of the embeddings (patches, then text) at (3, B, S)
    positions: every position's hidden state."""
    jcfg, tcfg = _cfgs(**GQA)
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(tcfg)
    emb, pos = _inputs(tcfg, tparams, batch)
    jh, _ = jax.jit(lambda p, e, q: jtf.forward_full(
        p, jcfg, embeds=e, positions=q))(jparams, jnp.asarray(emb.numpy()),
                                         jnp.asarray(batch["positions"]))
    th, aux = transformer.forward_full(tparams, tcfg, embeds=emb,
                                       positions=pos)
    assert aux == {} and th.shape == (B, S, tcfg.d_model)
    _close(th, jh)


def test_loss_fn_matches_jax():
    """``loss_fn`` with ``vision_embeds`` and ``positions`` in the batch:
    the loss and every gradient (the embedding's rows of the replaced
    slots get none, in both packages)."""
    jcfg, tcfg = _cfgs(**GQA)
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(tcfg, seed=3)
    rng = np.random.default_rng(4)
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
    for name, g, jg in zip(sorted(_leaves(jgrads)), grads, jleaves):
        jg = np.asarray(jg)
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
    """``make_prefill_step`` with ``vision_embeds`` and M-RoPE positions:
    the last position's logits and every cache leaf (the K rotated by
    M-RoPE)."""
    jcfg, tcfg = _cfgs(**GQA)
    jparams, tparams = _weights(jcfg, tcfg)
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               _batch(tcfg))
    _close(tlog, jlog)
    assert set(tcache) == {"len", "k", "v"}
    _check_cache(tcache, jcache, TOL)


def test_greedy_decode_matches_jax():
    """Prefill, then four greedy decode steps (flash-decode's plain version
    at G = 7): the same tokens, logits and caches after every step."""
    jcfg, tcfg = _cfgs(**GQA)
    jparams, tparams = _weights(jcfg, tcfg)
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               _batch(tcfg, seed=1))
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


def test_decode_rotates_at_the_cache_length_in_both_packages():
    """The decode step rotates the new token at the cache length (S) on all
    three M-RoPE streams, not at the prompt's largest position + 1 (here
    GRID + TEXT): in each package the decode logits equal those of a full
    forward over prompt + token at position S on every stream, and differ
    from those at GRID + TEXT. The port copies the JAX package here, so
    that the two compare (``ROADMAP.md``, queue 3)."""
    jcfg, tcfg = _cfgs(**GQA)
    jparams, tparams = _weights(jcfg, tcfg)
    batch = _batch(tcfg, seed=2)
    jlog, jcache, tlog, tcache = _prefill_both(jcfg, tcfg, jparams, tparams,
                                               batch)
    tok = tlog[:, -1].argmax(-1)[:, None].to(torch.int32)
    jdec, _ = jmake_decode_step(jcfg)(jparams, jcache, jnp.asarray(tok))
    tdec, _ = make_decode_step(tcfg)(tparams, tcache, tok)
    emb, pos = _inputs(tcfg, tparams, batch)
    emb = torch.cat([emb, transformer.embed_tokens(tparams, tok, tcfg)], 1)
    for at, equal in ((S, True), (GRID + TEXT, False)):
        full = torch.cat([pos, torch.full((3, B, 1), at, dtype=pos.dtype)],
                         2)
        th, _ = transformer.forward_full(tparams, tcfg, embeds=emb,
                                         positions=full)
        want_t = transformer.logits_from_hidden(tparams, th[:, -1:], tcfg)
        jh, _ = jtf.forward_full(jparams, jcfg, embeds=jnp.asarray(
            emb.numpy()), positions=jnp.asarray(full.numpy()))
        want_j = jtf.logits_from_hidden(jparams, jh[:, -1:], jcfg)
        for got, want in ((tdec, want_t), (jdec, want_j)):
            close = np.allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
            assert close == equal, (at, equal)


def test_launchers_refuse_vl():
    check_launchers_refuse(ARCH)


def test_accumulation_splits_mrope_positions_along_the_batch_axis():
    """``make_train_step(accum_steps=2)`` on a qwen2-vl batch: the (3, B, S)
    ``positions`` split along axis 1, every other entry along axis 0. With
    an all-ones mask the two microbatches hold equal token counts, so the
    accumulated gradients equal the unsplit step's (fp32, rtol 1e-5,
    atol 1e-6). The JAX package cannot be the reference here: its step
    splits ``positions`` along axis 0 and fails."""
    from repro_torch.models.steps import make_train_step
    from repro_torch.train import optim
    from repro_torch.train.tree import leaves

    jcfg, tcfg = _cfgs(**GQA)
    _, tparams = _weights(jcfg, tcfg)
    batch = _batch(tcfg, seed=5)
    batch["targets"] = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    batch["mask"] = np.ones((B, S), np.float32)
    tb = _both(batch)[1]
    grads = {}
    for accum in (1, 2):
        seen = []
        opt = optim.sgd(0.0)  # the params stay as they are
        step = make_train_step(tcfg, opt, accum_steps=accum,
                               grad_transform=lambda g: seen.append(g) or g)
        step(tparams, opt.init(tparams), tb)
        grads[accum] = leaves(seen[0])
    assert len(grads[1]) == len(grads[2])
    for i, (g2, g1) in enumerate(zip(grads[2], grads[1])):
        np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"leaf {i}")
