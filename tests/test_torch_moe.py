"""The port's MoE family against the JAX package's, on the CPU.

``models/moe.apply_moe`` (top-k routing with ties, grouping, capacity and
its overflow, the aux losses), the MoE transformer's prefill and decode,
the continuous-batching schedule of ``launch/serve`` and ``loss_fn`` with
its aux losses and gradients, for reduced moonshot-v1-16b-a3b (8 experts
top-2, MHA) and reduced grok-1-314b (softcaps, GQA); the same weights (the
JAX ``init_model`` tree carried across by ``from_jax_params``) and numpy
inputs through both packages, fp32. Also the repaired ``layers.normal``:
a leaf above ``DRAW_BYTES`` is drawn slice by slice, and the dense configs
keep their bits; a ``meta`` leaf is not drawn. Tolerances: a single module 1e-5, a whole model's logits
1e-4 (four layers of matmuls summed in another order), caches 1e-5.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.steps import loss_fn as jloss_fn
from repro.models.steps import make_decode_step as jmake_decode_step
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import layers, moe, transformer
from repro_torch.models.steps import loss_fn
from test_torch_lm import _check_cache, _jax_schedule, _leaves, _np

ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b"]
B, PROMPT, NEW = 2, 8, 4


def _cfgs(arch, **over):
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _weights(jcfg, tcfg, seed=0):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_configs_match_jax(arch, full):
    assert arch in list_archs()
    j, t = jget_config(arch), get_config(arch)
    if not full:
        j, t = j.reduced(), t.reduced()
    assert not t.embed_scale
    assert dataclasses.asdict(t) == {**dataclasses.asdict(j),
                                     "embed_scale": False}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_tree_matches_jax(arch):
    """The port's own ``init_model``: the JAX tree's names, shapes and
    dtypes (the router fp32), and the JAX package's distributions."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert _leaves(tparams) == _leaves(jparams)
    m = tparams["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    for key, fan_in in (("w_up", tcfg.d_model), ("w_down",
                                                 tcfg.moe.d_ff_expert)):
        std = float(m[key].float().std()) * np.sqrt(fan_in)
        assert abs(std - 1) < 0.05, key


MOE_CASES = {
    # name: (config overrides, batch, seq)
    "moonshot": ("moonshot-v1-16b-a3b", {}, 3, 10),
    "grok": ("grok-1-314b", {}, 2, 16),
    # capacity C = max(ceil(16 / 8 * 0.5 * 2), 2) = 2 of 16 tokens a group:
    # most routed tokens overflow and lose that expert's mass
    "overflow": ("moonshot-v1-16b-a3b", dict(capacity_factor=0.5), 2, 16),
    # group_size 16 over T = 24 tokens: Tg halves to 8, three groups
    "groups": ("moonshot-v1-16b-a3b", dict(group_size=16), 3, 8),
}


def _moe_cfgs(arch, moe_over):
    jcfg, tcfg = _cfgs(arch)
    jm = dataclasses.replace(jcfg.moe, **moe_over)
    tm = dataclasses.replace(tcfg.moe, **moe_over)
    return (dataclasses.replace(jcfg, moe=jm),
            dataclasses.replace(tcfg, moe=tm))


def _check_moe(jcfg, tcfg, jp, x):
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    return tp


def _routing(tcfg, tp, x):
    """(tokens routed to more than k experts, routed token-expert pairs
    dropped by capacity), recomputed from the port's routing."""
    G, Tg, C = moe.group_shape(tcfg, x.shape[0] * x.shape[1])
    logits = torch.from_numpy(x).reshape(G, Tg, -1) @ tp["router"]
    routed = moe._top_k_gates(torch.softmax(logits, -1), tcfg.moe.top_k) > 0
    pos = torch.cumsum(routed.int(), 1) * routed.int() - 1
    over = int((routed.sum(-1) > tcfg.moe.top_k).sum())
    return over, int((routed & (pos >= C)).sum())


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_apply_moe_matches_jax(name):
    arch, moe_over, b, s = MOE_CASES[name]
    jcfg, tcfg = _moe_cfgs(arch, moe_over)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(3).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    tp = _check_moe(jcfg, tcfg, jp, x)
    if name == "overflow":
        assert _routing(tcfg, tp, x)[1] > 0


def test_apply_moe_tied_router_columns_select_more_than_k():
    """Two router columns equal: their probabilities tie exactly, and a
    token whose k-th largest is one of them goes to both (k + 1 experts),
    in both packages."""
    jcfg, tcfg = _moe_cfgs("moonshot-v1-16b-a3b", {})
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(4), jcfg))
    router = jp["router"].copy()
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    jp = {**jp, "router": router}
    x = np.random.default_rng(4).standard_normal(
        (4, 16, tcfg.d_model)).astype(np.float32)
    tp = _check_moe(jcfg, tcfg, jp, x)
    over, _ = _routing(tcfg, tp, x)
    assert over > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """``forward_prefill`` logits and cache, then four teacher-forced
    ``forward_decode`` steps (the B tokens of a step form one group, so the
    slots share the experts' capacity), the in-place cache against the JAX
    functional one."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _weights(jcfg, tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forced = rng.integers(2, tcfg.vocab_size, (B, NEW)).astype(np.int32)
    max_len = PROMPT + NEW
    jh, jcache = jax.jit(lambda p, t: jtf.forward_prefill(
        p, jcfg, tokens=t, max_len=max_len))(jparams, jnp.asarray(toks))
    th, tcache = transformer.forward_prefill(
        tparams, tcfg, tokens=torch.from_numpy(toks), max_len=max_len)
    np.testing.assert_allclose(
        _np(transformer.logits_from_hidden(tparams, th, tcfg)),
        _np(jtf.logits_from_hidden(jparams, jh, jcfg)), rtol=1e-4, atol=1e-4)
    _check_cache(tcache, jcache, 1e-5)
    jdecode = jax.jit(jmake_decode_step(jcfg))
    for t in range(NEW):
        tok = forced[:, t:t + 1]
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = transformer.forward_decode(
            tparams, tcache, torch.from_numpy(tok), tcfg)
        np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=1e-4,
                                   atol=1e-4)
        _check_cache(tcache, jcache, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_schedule_matches_jax(arch):
    """``--slots 2 --requests 5 --prompt-len 8 --max-new 4`` on both
    packages with the same weights: every slot's token at every step, the
    rows swapped, and the final caches equal."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _weights(jcfg, tcfg)
    requests = serve.make_requests(tcfg.vocab_size, 5, PROMPT, seed=0)
    want, n, jcache, swaps = _jax_schedule(jcfg, jparams, requests, 2, NEW)
    res = serve.serve(tcfg, tparams, requests, slots=2, max_new=NEW,
                      device="cpu")
    assert res.n_decoded == n == 24 and res.served == 5
    assert swaps == [0, 1, 0]
    np.testing.assert_array_equal(res.step_tokens, want)
    _check_cache(res.cache, jcache, 1e-5)


def test_launcher_serves_moe_as_jax_does():
    from repro.launch import serve as jserve

    flags = ["--arch", "moonshot-v1-16b-a3b", "--preset", "reduced",
             "--slots", "2", "--requests", "3", "--prompt-len", "8",
             "--max-new", "3"]
    assert serve.main(flags + ["--device", "cpu"]) == jserve.main(flags)


def test_loss_fn_matches_jax():
    """``loss_fn`` on reduced moonshot: xent, both aux losses and the total
    (xent + 0.01 lb + 1e-3 z), and every gradient."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    jparams, tparams = _weights(jcfg, tcfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 16)),
             "targets": rng.integers(0, tcfg.vocab_size, (2, 16)),
             "mask": (rng.random((2, 16)) < 0.8).astype(np.float32)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           jcfg), has_aux=True)(jparams)
    leaves = [p.requires_grad_() for p in jax.tree.leaves(tparams)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, tm = loss_fn(tparams, tb, tcfg)
    assert set(tm) == set(jm) == {"xent", "loss", "load_balance_loss",
                                   "router_z_loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(tm["loss"].detach()) > float(tm["xent"].detach())
    grads = torch.autograd.grad(tloss, leaves)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(jg).max()))


# ------------------------------------------------------------- init draws --


def test_normal_draws_a_large_leaf_slice_by_slice(monkeypatch):
    """A leaf above ``DRAW_BYTES`` is drawn slice by slice along its leading
    axes from the same generator in order: no fp32 draw larger than the
    limit, each slice the draw it would be alone, the dtype cast."""
    monkeypatch.setattr(layers, "DRAW_BYTES", 4 * 100)
    sizes = []
    real = torch.randn

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    got = layers.normal(torch.Generator().manual_seed(7), (3, 4, 5, 6), 0.5,
                        torch.bfloat16, "cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (3, 4, 5, 6)
    assert sizes == [30] * 12 and max(sizes) * 4 <= layers.DRAW_BYTES
    gen = torch.Generator().manual_seed(7)
    want = torch.stack([(real((5, 6), generator=gen) * 0.5).to(
        torch.bfloat16) for _ in range(12)]).reshape(3, 4, 5, 6)
    assert torch.equal(got, want)


def test_normal_on_meta_draws_nothing(monkeypatch):
    """On ``meta`` (the dry run's and the smoke's parameter counts) a leaf
    is a shape alone: no draw, whatever its size, so that a leaf above
    ``DRAW_BYTES`` (nemotron-4-15b's 256,000-row embedding) is not walked
    slice by slice."""
    monkeypatch.setattr(torch, "randn", None)  # any draw would raise
    got = layers.normal(None, (256000, 6144), 0.02, torch.bfloat16, "meta")
    assert got.is_meta and got.shape == (256000, 6144)
    assert got.dtype == torch.bfloat16


# sha256 of every leaf's bytes, in the tree's order, of ``init_model`` at the
# reduced preset from ``torch.Generator().manual_seed(0)``, as the port drew
# them before ``normal`` sliced large leaves
DENSE_INIT_SHA256 = {
    "qwen3-4b":
        "2dda409d29c47ac3b36da787bf2b4e658c70d40630f997f26d52265f6eb39b5e",
    "gemma2-2b":
        "a0fe4589a7fba21b7f1033d8258fb0fef24f6e256b72d467855b3dbc953873be",
    "starcoder2-7b":
        "5407a96c32d28b3bf72a8b95404f1b9752ebf63c3e30e4e6fa130d0e790d456b",
    "nemotron-4-15b":
        "1a12d2c0ee4e78d9256da9235b25652df429f716168e64a9949420fd38874236",
}


def _init_sha256(arch):
    params = transformer.init_model(get_config(arch).reduced(),
                                    torch.Generator().manual_seed(0), "cpu")
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(params):
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(DENSE_INIT_SHA256))
def test_init_model_keeps_the_dense_bits(arch):
    assert _init_sha256(arch) == DENSE_INIT_SHA256[arch]


@pytest.mark.parametrize("arch,sliced", [
    ("qwen3-4b", set()), ("gemma2-2b", set()),
    ("moonshot-v1-16b-a3b", {"w_down", "w_gate", "w_up"})])
def test_which_leaves_are_drawn_in_slices_at_full_width(arch, sliced):
    """At full width (shapes from the JAX package's ``init_model`` under
    ``jax.eval_shape``, nothing allocated): every leaf of qwen3-4b and
    gemma2-2b fits one draw, as before the repair, so the card draws the
    same bits; moonshot's three stacked expert weights (35.4 GB each in
    fp32) are drawn by layer."""
    shapes = jax.eval_shape(lambda k: jtf.init_model(k, jget_config(arch)),
                            jax.random.PRNGKey(0))
    big = {path[-1].key for path, leaf in
           jax.tree_util.tree_leaves_with_path(shapes)
           if 4 * np.prod(leaf.shape) > layers.DRAW_BYTES}
    assert big == sliced
