"""The port's LM training path against the JAX package's, on the CPU.

The optimizers and schedules (``train/optim.py``), the data pipeline, int8
compression with error feedback, checkpoints (both directions, torn
directories), ``forward_full`` + ``lm_loss`` and their gradients for the
four reduced dense configs, ``make_train_step`` at ``accum`` 1 and 2, and
the launcher's resume, compression and accumulation runs. The same numpy
inputs go through both packages; the JAX side runs jitted on the CPU, as
its own tests run it. Tolerances: optimizer updates and states 1e-6 (fp32;
XLA and torch round ``pow`` and ``cos`` apart by an ulp); int8 values and
scales equal; the data pipeline byte-equal; losses 1e-5 relative and
gradients 1e-4 x their leaf's largest magnitude (four layers of fp32
matmuls summed in another order); the train step's parameters 1e-3 x
the step's rate where Adam does not amplify a gradient's rounding (see
the test).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as jcomp
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.train import optim as joptim
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.distributed import checkpoint, compression
from repro_torch.launch import train
from repro_torch.models import attention, steps, transformer
from repro_torch.train import optim, tree

ARCHS = ["qwen3-4b", "gemma2-2b", "starcoder2-7b", "nemotron-4-15b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_trees(mine, theirs, rtol, atol_of_max=None, atol=0.0):
    """Leaf by leaf (JAX flattening order), ints equal."""
    a, b = tree.leaves(mine), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, int):
            assert x == int(np.asarray(y))
            continue
        y = _np(y)
        tol = atol if atol_of_max is None else atol_of_max * max(
            float(np.abs(y).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(_np(x), y, rtol=rtol, atol=tol)


# ------------------------------------------------------------ optimizers --


def _params(rng, dtype=np.float32):
    shapes = {"w": (12, 10), "big": (130, 128), "s": (), "v": (5,),
              "layers": {"a": (3, 9, 16), "b": (3, 7)}}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(dtype),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _sched(mod):
    return mod.warmup_cosine(0.1, 3, 10)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(_sched(m), momentum=0.9),
    "adamw": lambda m: m.adamw(_sched(m), weight_decay=0.01),
    "adam": lambda m: m.make_optimizer("adam", 0.05),
    "adafactor": lambda m: m.adafactor(_sched(m), min_dim_size_to_factor=8,
                                       weight_decay=0.01),
    "adafactor-default": lambda m: m.make_optimizer("adafactor", 0.05),
    "sgd-make": lambda m: m.make_optimizer("sgd", m.constant_schedule(0.1)),
    "clip+adamw": lambda m: m.chain(m.clip_by_global_norm(1.0),
                                    m.adamw(_sched(m))),
    "scale": lambda m: m.chain(m.scale(0.5),
                               m.scale_by_schedule(_sched(m))),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax_step_by_step(name):
    """Five steps from the same params and gradients: the functional
    ``update`` against the JAX package's (updates and state), and the
    in-place ``step`` against ``update`` + ``apply_updates`` bit for bit;
    then the JAX state carried across by ``from_jax_opt_state``."""
    rng = np.random.default_rng(0)
    p_np = _params(rng)
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jparams = jax.tree.map(jnp.asarray, p_np)
    tparams = tree.tree_map(_t, p_np)
    live = tree.tree_map(torch.clone, tparams)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    live_state = topt.init(live)
    for _ in range(5):
        g_np = jax.tree.map(lambda p: 3 * rng.standard_normal(p.shape)
                            .astype(np.float32), p_np)
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate,
                                   jparams)
        tupd, tstate = topt.update(tree.tree_map(_t, g_np),
                                   tstate, tparams)
        _close_trees(tupd, jupd, 1e-6, atol=1e-6)
        _close_trees(tstate, jstate, 1e-6, atol=1e-6)
        jparams = joptim.apply_updates(jparams, jupd)
        tparams = optim.apply_updates(tparams, tupd)
        live_state = topt.step(tree.tree_map(_t, g_np),
                               live_state, live)
        for a, b in zip(tree.leaves(live), tree.leaves(tparams)):
            assert torch.equal(a, b)
    _close_trees(tparams, jparams, 1e-6, atol=1e-6)
    carried = transformer.from_jax_opt_state(
        jax.tree.map(np.asarray, jstate), topt.init(tparams), device="cpu")
    _close_trees(carried, jstate, 0.0)


def test_adam_state_is_fp32_for_bf16_params():
    """bf16 params keep fp32 moments; the update is cast back to bf16 and
    lands where the JAX package's does (within one bf16 rounding)."""
    rng = np.random.default_rng(1)
    p32 = rng.standard_normal((64,)).astype(np.float32)
    g32 = rng.standard_normal((64,)).astype(np.float32)
    jp = {"w": jnp.asarray(p32, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p32).bfloat16()}
    jopt, topt = joptim.adam(0.01), optim.make_optimizer("adam", 0.01)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert tstate[0].mu["w"].dtype == torch.float32
    jupd, jstate = jopt.update({"w": jnp.asarray(g32, jnp.bfloat16)}, jstate,
                               jp)
    tstate = topt.step({"w": torch.from_numpy(g32).bfloat16()}, tstate, tp)
    assert tp["w"].dtype == torch.bfloat16
    _close_trees(tstate, jstate, 1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tp["w"]),
                               _np(joptim.apply_updates(jp, jupd)["w"]),
                               rtol=2 ** -8)


@pytest.mark.parametrize("sched", ["warmup_cosine", "constant"])
def test_schedules_match_jax(sched):
    make = {"warmup_cosine": lambda m: m.warmup_cosine(3e-4, 10, 40),
            "constant": lambda m: m.constant_schedule(3e-4)}[sched]
    js, ts = make(joptim), make(optim)
    for c in range(0, 50):
        assert ts(c) == pytest.approx(float(js(jnp.asarray(c))), rel=1e-6)


def test_clip_by_global_norm_and_its_place_in_a_chain():
    g = {"a": torch.full((4,), 10.0), "b": torch.ones((3, 2))}
    t = optim.clip_by_global_norm(1.0)
    upd, _ = t.update(g, t.init(g), None)
    assert float(optim.global_norm(upd)) == pytest.approx(1.0, rel=1e-5)
    jupd, _ = joptim.clip_by_global_norm(1.0).update(
        jax.tree.map(lambda x: jnp.asarray(x.numpy()), g), (), None)
    _close_trees(upd, jupd, 1e-6)
    assert float(optim.global_norm(g)) == pytest.approx(
        float(joptim.global_norm(jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                                              g))), rel=1e-6)
    late = optim.chain(optim.scale(2.0), optim.clip_by_global_norm(1.0))
    with pytest.raises(ValueError, match="first in a chain"):
        late.update(g, late.init(g), None)


def test_adafactor_factored_state_shapes():
    opt = optim.adafactor(0.01, min_dim_size_to_factor=8)
    params = {"m": torch.zeros((16, 32)), "v": torch.zeros((4,)),
              "t": torch.zeros((3, 16, 32))}
    state = opt.init(params)
    assert state.vr["m"].shape == (16,) and state.vc["m"].shape == (32,)
    assert state.vr["t"].shape == (3, 16) and state.vc["t"].shape == (3, 32)
    assert state.vr["v"].shape == (4,) and state.vc["v"] == ()
    jstate = joptim.adafactor(0.01, min_dim_size_to_factor=8).init(
        jax.tree.map(lambda x: jnp.asarray(x.numpy()), params))
    assert [tuple(x.shape) for x in tree.leaves(state)[1:]] == \
        [tuple(x.shape) for x in jax.tree.leaves(jstate)[1:]]


# ----------------------------------------------------------- compression --


@pytest.mark.parametrize("kind", ["normal", "tiny", "zeros", "bf16"])
def test_quantize_int8_matches_jax(kind):
    rng = np.random.default_rng(2)
    x = {"normal": rng.standard_normal((33, 17)) * 5,
         "tiny": rng.standard_normal((200,)) * 1e-7,
         "zeros": np.zeros((8,)),
         "bf16": rng.standard_normal((64, 3))}[kind].astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if kind == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    q, s = compression.quantize_int8(tx)
    jq, js = jcomp.quantize_int8(jx)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s.item()) == np.float32(js)
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))


def test_error_feedback_telescopes_over_50_steps():
    """Sum of what the wire delivered + the final residual = sum of the
    gradients (the error does not accumulate), and every step equals the
    JAX package's when the state is carried."""
    rng = np.random.default_rng(3)
    shapes = {"a": (40, 7), "b": {"c": (13,)}}
    ef, jef = compression.ErrorFeedbackInt8(), jcomp.ErrorFeedbackInt8()
    g0 = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    state = ef.init(tree.tree_map(torch.from_numpy, g0))
    jstate = jef.init(g0)
    sent = tree.tree_map(lambda x: torch.zeros(x.shape), g0)
    total = tree.tree_map(lambda x: torch.zeros(x.shape), g0)
    for _ in range(50):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * rng.uniform(0.1, 10)).astype(np.float32),
                         g0)
        out, state = ef.compress_decompress(tree.tree_map(torch.from_numpy, g),
                                            state)
        jout, jstate = jef.compress_decompress(g, jstate)
        _close_trees(out, jout, 1e-6, atol=1e-6)
        _close_trees(state, jstate, 1e-6, atol=1e-6)
        sent = tree.tree_map(torch.add, sent, out)
        total = tree.tree_map(lambda t, x: t + torch.from_numpy(x), total, g)
    for s, r, t in zip(tree.leaves(sent), tree.leaves(state.residual),
                       tree.leaves(total)):
        torch.testing.assert_close(s + r, t, rtol=1e-5, atol=1e-4)
        assert float(r.abs().max()) < float(t.abs().max()) * 0.05


# --------------------------------------------------------- data pipeline --


def test_synthetic_data_is_byte_equal():
    for seed in (0, 5):
        a = pipeline.SyntheticLMData(512, 3, 17, seed=seed)
        b = jpipe.SyntheticLMData(512, 3, 17, seed=seed)
        for step in (0, 1, 7, 123):
            x, y = a.batch_at(step), b.batch_at(step)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
        for x, y, _ in zip(a, b, range(3)):
            assert all(x[k].tobytes() == y[k].tobytes() for k in x)


def test_pack_documents_is_byte_equal():
    rng = np.random.default_rng(4)
    docs = [rng.integers(2, 100, rng.integers(0, 20)) for _ in range(9)]
    for seq in (1, 7, 64):
        (t, m), (jt, jm) = (pipeline.pack_documents(docs, seq),
                            jpipe.pack_documents(docs, seq))
        assert t.tobytes() == jt.tobytes() and m.tobytes() == jm.tobytes()
        assert t.dtype == jt.dtype and m.dtype == jm.dtype


def _raises_after(n):
    yield from range(n)
    raise KeyError("boom")


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_iterator_order_and_errors(depth):
    for mod in (pipeline, jpipe):
        assert list(mod.PrefetchIterator(iter(range(20)), depth=depth)) == \
            list(range(20))
        got = []
        with pytest.raises(KeyError, match="boom"):
            for x in mod.PrefetchIterator(_raises_after(6), depth=depth):
                got.append(x)
        assert got == list(range(6))


# ------------------------------------------------ forward, loss, grads --


def _cfgs(arch, **over):
    return (jget_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _batch(vocab, b, s, seed=1, step=0):
    return jpipe.SyntheticLMData(vocab, b, s, seed=seed).batch_at(step)


def _port_loss_grads(params, batch, cfg):
    ws = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss, _ = steps.loss_fn(tree.unflatten(params, ws),
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            cfg)
    grads = torch.autograd.grad(loss, ws)
    return loss.detach(), tree.unflatten(params, list(grads))


def _jax_loss_grads(jparams, batch, jcfg):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jsteps.loss_fn(p, b, jcfg)[0]))
    return fn(jparams, jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_loss_and_grads_match_jax(arch):
    """B=2, S=128: two loss chunks and two query chunks of 64 (the causal
    mask skips a KV chunk), the reduced config's four layers."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    batch = _batch(jcfg.vocab_size, 2, 128)
    jh, _ = jtf.forward_full(jparams, jcfg, tokens=jnp.asarray(batch["tokens"]))
    th, aux = transformer.forward_full(tparams, tcfg,
                                       tokens=torch.from_numpy(batch["tokens"]))
    assert aux == {}
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
    jloss, jgrads = _jax_loss_grads(jparams, batch, jcfg)
    tloss, tgrads = _port_loss_grads(tparams, batch, tcfg)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert abs(float(tloss) - np.log(jcfg.vocab_size)) < 1.5
    _close_trees(tgrads, jgrads, 0.0, atol_of_max=1e-4)


def test_remat_modes_give_the_same_loss_and_grads():
    _, cfg = _cfgs("qwen3-4b")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_model(cfg, gen, "cpu")
    batch = _batch(cfg.vocab_size, 2, 64)
    base = None
    for remat in ("none", "dots", "full"):
        loss, grads = _port_loss_grads(params, batch,
                                       dataclasses.replace(cfg, remat=remat))
        if base is None:
            base = (loss, grads)
            continue
        assert float(loss) == float(base[0])
        for a, b in zip(tree.leaves(grads), tree.leaves(base[1])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_chunked_attention_backward_with_fully_masked_chunk_rows():
    """A window of 3 over chunks of 4: in the first KV chunk a query block
    sees, some of its rows see no key (every score NEG_INF). The backward
    stays finite and equals the JAX package's."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, Dh = 2, 16, 4, 2, 8
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32) for s in
                     ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh),
                      (B, S, H, Dh)))
    kw = dict(causal=True, window=3, softcap=0.0, chunk_q=4, chunk_kv=4)

    def jf(q, k, v):
        return jnp.sum(jattn.attention_chunked(q, k, v, **kw) * dout)

    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.attention_chunked(*ts, **kw)
    (out * torch.from_numpy(dout)).sum().backward()
    for t, g in zip(ts, jg):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------- the step --


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """Three AdamW steps (warmup-cosine), the port restarting each step from
    the JAX package's params and state (``from_jax_params``,
    ``from_jax_opt_state``), on the same batches: loss, xent and grad_norm
    1e-5, moments 1e-4 x their leaf's largest magnitude. Adam's
    g / (sqrt(v) + eps) turns a gradient's rounding into a step of up to lr
    where the moments nearly cancel, and the rounding differs between the
    two packages, so each step's parameters are held to 1e-3 x lr where
    sqrt(v_hat) > 100 eps (98% of every leaf or more), and to 2 x lr
    everywhere."""
    jcfg, tcfg = _cfgs("qwen3-4b", n_heads=8, n_kv_heads=2)
    jparams = jtf.init_model(jax.random.PRNGKey(1), jcfg)
    sched = (joptim.warmup_cosine(3e-3, 2, 20), optim.warmup_cosine(3e-3, 2, 20))
    jopt, topt = joptim.adamw(sched[0]), optim.adamw(sched[1])
    jstate = jopt.init(jparams)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, accum_steps=accum))
    tstep = steps.make_train_step(tcfg, topt, accum_steps=accum)
    data = jpipe.SyntheticLMData(jcfg.vocab_size, 4, 64, seed=2)
    for s in range(3):
        tparams = transformer.from_jax_params(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        tstate = transformer.from_jax_opt_state(
            jax.tree.map(np.asarray, jstate), topt.init(tparams),
            device="cpu")
        _close_trees(tstate, jstate, 0.0, atol=0.0)
        batch = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        tparams, tstate, tm = tstep(tparams, tstate, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "xent", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
        assert tstate[0].count == tstate[2] == s + 1
        _close_trees(tstate[0].mu, jstate[0].mu, 0.0, atol_of_max=1e-4)
        _close_trees(tstate[0].nu, jstate[0].nu, 0.0, atol_of_max=1e-4)
        lr = sched[1](s)
        c2 = 1 - 0.999 ** (s + 1)
        for p, jp, v in zip(tree.leaves(tparams), jax.tree.leaves(jparams),
                            jax.tree.leaves(jstate[0].nu)):
            d = np.abs(_np(p) - _np(jp))
            ok = np.sqrt(np.asarray(v) / c2) > 100 * 1e-8
            assert ok.mean() > 0.98
            assert d[ok].max() <= 1e-3 * lr and d.max() <= 2 * lr


# ------------------------------------------------------------ checkpoints --


def _after_one_jax_step(jcfg, seed=3):
    jparams = jtf.init_model(jax.random.PRNGKey(seed), jcfg)
    jopt = joptim.adamw(joptim.warmup_cosine(3e-3, 2, 20))
    jstate = jopt.init(jparams)
    step = jax.jit(jsteps.make_train_step(jcfg, jopt))
    data = jpipe.SyntheticLMData(jcfg.vocab_size, 2, 64, seed=4)
    jparams, jstate, _ = step(jparams, jstate,
                              jax.tree.map(jnp.asarray, data.batch_at(0)))
    return jparams, jstate, step, data


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """The JAX package saves params + AdamW state after one step; the port
    restores them (bf16 leaves as their raw 2-byte words) bit for bit and
    takes the next step to the loss the JAX package's next step gives.
    The JAX package cannot read back a bf16 leaf it wrote (queue 3 of
    ``ROADMAP.md``), so in that case its next step starts from the tree it
    saved."""
    over = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg, tcfg = _cfgs("qwen3-4b", **over)
    jparams, jstate, jstep, data = _after_one_jax_step(jcfg)
    jckpt.CheckpointManager(str(tmp_path)).save(1, {"params": jparams,
                                                    "opt": jstate})
    if dtype == "float32":
        restored = jckpt.CheckpointManager(str(tmp_path)).restore(
            1, {"params": jparams, "opt": jstate})
        jparams, jstate = restored["params"], restored["opt"]
    tparams = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    topt = optim.adamw(optim.warmup_cosine(3e-3, 2, 20))
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    got = mgr.restore(1, {"params": tparams, "opt": topt.init(tparams)})
    for a, b in zip(tree.leaves(got), jax.tree.leaves({"params": jparams,
                                                       "opt": jstate})):
        if isinstance(a, int):
            assert a == int(b)
            continue
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        want = np.asarray(b)
        if dtype == "bfloat16" and a.dtype == torch.bfloat16:
            a, want = a.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(a.numpy(), want)
    batch = data.batch_at(1)
    _, _, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch))
    _, _, tm = steps.make_train_step(tcfg, topt)(
        got["params"], got["opt"], {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=rel)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port saves params + AdamW state after one step; the JAX package
    restores them with its own target tree, equal bit for bit, under the
    same leaf names as its own checkpoint, and its next step gives the
    port's next loss."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    jparams0 = jtf.init_model(jax.random.PRNGKey(3), jcfg)
    tparams = transformer.from_jax_params(jax.tree.map(np.asarray, jparams0),
                                          tcfg, device="cpu")
    topt = optim.adamw(optim.warmup_cosine(3e-3, 2, 20))
    tstep = steps.make_train_step(tcfg, topt)
    data = jpipe.SyntheticLMData(jcfg.vocab_size, 2, 64, seed=4)
    tb = lambda s: {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
    tparams, tstate, _ = tstep(tparams, topt.init(tparams), tb(0))
    checkpoint.CheckpointManager(str(tmp_path / "port")).save(
        1, {"params": tparams, "opt": tstate})

    jopt = joptim.adamw(joptim.warmup_cosine(3e-3, 2, 20))
    target = {"params": jparams0, "opt": jopt.init(jparams0)}
    jckpt.CheckpointManager(str(tmp_path / "jax")).save(1, target)
    names = [
        [leaf["name"] for leaf in json.load(open(
            tmp_path / d / "step_000000001" / "manifest.json"))["leaves"]]
        for d in ("port", "jax")]
    assert names[0] == names[1]
    got = jckpt.CheckpointManager(str(tmp_path / "port")).restore(1, target)
    for a, b in zip(jax.tree.leaves(got), tree.leaves({"params": tparams,
                                                       "opt": tstate})):
        if isinstance(b, int):
            assert int(a) == b and a.dtype == jnp.int32
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(
        got["params"], got["opt"], jax.tree.map(jnp.asarray, data.batch_at(1)))
    _, _, tm = tstep(tparams, tstate, tb(1))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)


def test_bf16_leaves_round_trip_and_match_the_jax_bytes(tmp_path):
    """A bf16 leaf is written as the JAX package writes one (2-byte words,
    "bfloat16" in the manifest) and comes back bit for bit. The JAX
    package's own restore fails on such a leaf, whichever package wrote it
    (numpy cannot cast its ``V2`` words to ml_dtypes' bfloat16)."""
    x = torch.randn(5, 7).bfloat16()
    checkpoint.CheckpointManager(str(tmp_path / "port")).save(
        2, {"w": x, "n": 3})
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jckpt.CheckpointManager(str(tmp_path / "jax")).save(
        2, {"w": jx, "n": jnp.asarray(3, jnp.int32)})
    for d in ("port", "jax"):
        step_dir = tmp_path / d / "step_000000002"
        meta = json.load(open(step_dir / "manifest.json"))["leaves"]
        assert [(m["name"], m["dtype"]) for m in meta] == \
            [("n", "int32"), ("w", "bfloat16")]
        words = np.load(step_dir / "leaf_00001_0000.npy")
        assert words.dtype.itemsize == 2 and words.dtype.kind == "V"
        np.testing.assert_array_equal(words.view(np.int16),
                                      x.view(torch.int16).numpy())
        got = checkpoint.CheckpointManager(str(tmp_path / d)).restore(
            2, {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "n": 0})
        assert got["n"] == 3 and torch.equal(got["w"].view(torch.int16),
                                             x.view(torch.int16))
        with pytest.raises(ValueError):
            jckpt.CheckpointManager(str(tmp_path / d)).restore(
                2, {"w": jx, "n": jnp.asarray(0, jnp.int32)})


def _tree_at(v):
    return {"w": torch.full((4, 3), float(v)), "step": v}


def test_checkpoint_skips_torn_dirs_even_when_newest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree_at(1))
    mgr.save(2, _tree_at(2), blocking=False)
    mgr.wait()
    torn = tmp_path / "step_000000003"
    torn.mkdir()
    (torn / "leaf_00000_0000.npy").write_bytes(b"\x93NUMPY")
    assert mgr.all_steps() == [1, 2]
    torn2 = tmp_path / "step_000000004"
    torn2.mkdir()
    (torn2 / "manifest.json").write_text('{"step": 4, "leaves": [{"na')
    (torn2 / "_COMMITTED").write_text("ok")
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    step, got = mgr.restore_latest(_tree_at(0))
    assert step == 2 and got["step"] == 2
    assert torch.equal(got["w"], _tree_at(2)["w"])


def test_checkpoint_restore_latest_falls_back_past_torn_shards(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree_at(1))
    mgr.save(2, _tree_at(2))
    os.remove(tmp_path / "step_000000002" / "leaf_00001_0000.npy")
    step, got = mgr.restore_latest(_tree_at(0))
    assert step == 1 and got["step"] == 1
    assert torch.equal(got["w"], _tree_at(1)["w"])
    os.remove(tmp_path / "step_000000001" / "leaf_00001_0000.npy")
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest(_tree_at(0))


def test_checkpoint_keeps_the_newest_three(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    for s in range(1, 6):
        mgr.save(s, _tree_at(s), blocking=s % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [3, 4, 5]
    with pytest.raises(ValueError, match="saved"):
        mgr.restore(5, {"w": torch.zeros(3, 4), "step": 0})


def test_checkpoint_restores_into_the_target_in_place(tmp_path):
    """``restore`` fills the target's own tensors (a resume allocates no
    second copy of the state) and refuses a saved dtype other than the
    target's."""
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(6.0).reshape(2, 3),
                 "h": torch.ones(4).bfloat16(), "step": 7})
    target = {"w": torch.zeros(2, 3), "h": torch.zeros(4).bfloat16(),
              "step": 0}
    ptrs = {k: target[k].data_ptr() for k in ("w", "h")}
    got = mgr.restore(1, target)
    assert got["step"] == 7
    for k in ("w", "h"):
        assert got[k] is target[k] and got[k].data_ptr() == ptrs[k]
    assert torch.equal(target["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(target["h"], torch.ones(4).bfloat16())
    with pytest.raises(ValueError, match="saved"):
        mgr.restore(1, {"w": torch.zeros(2, 3, dtype=torch.float64),
                        "h": torch.zeros(4).bfloat16(), "step": 0})


# ------------------------------------------------------------- launcher --

LAUNCH = ["--arch", "qwen3-4b", "--preset", "reduced", "--batch", "2",
          "--seq", "32", "--device", "cpu"]


def test_train_checkpoint_resume_continuity(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    losses1 = train.main(LAUNCH + ["--steps", "8", "--ckpt-dir", ckpt,
                                   "--ckpt-every", "4"])
    assert len(losses1) == 8
    losses2 = train.main(LAUNCH + ["--steps", "12", "--ckpt-dir", ckpt,
                                   "--ckpt-every", "4"])
    assert len(losses2) == 4
    assert np.mean(losses2) < np.mean(losses1[:4])
    recs = [json.loads(line) for line in open(os.path.join(ckpt,
                                                           "metrics.jsonl"))]
    assert [r["step"] for r in recs] == list(range(12))
    # an uninterrupted run gives the same losses from the same seed
    again = train.main(LAUNCH + ["--steps", "12"])
    np.testing.assert_allclose(again, losses1 + losses2, rtol=1e-6)


def test_train_with_grad_compression(tmp_path):
    losses = train.main(LAUNCH + ["--steps", "6", "--compress-grads",
                                  "--metrics", str(tmp_path / "m.jsonl")])
    assert losses[-1] < losses[0]


def test_train_with_accumulation(tmp_path):
    losses = train.main(["--arch", "qwen3-4b", "--preset", "reduced",
                         "--steps", "4", "--batch", "4", "--seq", "32",
                         "--accum", "2", "--device", "cpu",
                         "--metrics", str(tmp_path / "m.jsonl")])
    assert len(losses) == 4 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_train_launcher_runs_each_dense_config(arch, tmp_path):
    """gemma2-2b, starcoder2-7b and nemotron-4-15b through the launcher at
    the reduced preset (none of them fits one card for training at full
    width): finite losses, its metrics file one record per step."""
    path = tmp_path / "m.jsonl"
    losses = train.main(["--arch", arch, "--preset", "reduced", "--steps",
                         "3", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--metrics", str(path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert [json.loads(line)["step"] for line in open(path)] == [0, 1, 2]


def test_train_refuses_a_mesh_and_a_missing_card():
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--steps", "1", "--mesh", "2x1"])
    assert train.main(LAUNCH + ["--steps", "1", "--mesh", "1x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--arch", "qwen3-4b", "--steps", "1"])


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def test_compression_residual_carries_in_the_port_not_in_jax(tmp_path,
                                                             monkeypatch):
    """The JAX launcher stores the error-feedback state from inside its
    jitted step: the stored residual is a tracer, and compression ran once
    (at trace time) for three steps. The port compresses every step from
    the residual the step before left."""
    calls = {"jax": [], "port": []}

    def recorder(base, key):
        class Recording(base):
            def compress_decompress(self, grads, state):
                out, new = super().compress_decompress(grads, state)
                calls[key].append((state, new))
                return out, new
        return Recording

    seen = {}
    make = jtrain.make_train_step

    def capture(cfg, opt, accum_steps=1, grad_transform=None):
        seen["gt"] = grad_transform
        return make(cfg, opt, accum_steps=accum_steps,
                    grad_transform=grad_transform)

    monkeypatch.setattr(jtrain, "make_train_step", capture)
    monkeypatch.setattr(jtrain, "ErrorFeedbackInt8",
                        recorder(jcomp.ErrorFeedbackInt8, "jax"))
    monkeypatch.setattr(train, "ErrorFeedbackInt8",
                        recorder(compression.ErrorFeedbackInt8, "port"))
    args = ["--arch", "qwen3-4b", "--preset", "reduced", "--steps", "3",
            "--batch", "2", "--seq", "32", "--compress-grads"]
    assert len(jtrain.main(args + ["--metrics", str(tmp_path / "j")])) == 3
    stored = _closure(seen["gt"])["comp_state"]["s"]
    assert all(isinstance(x, jax.core.Tracer)
               for x in jax.tree.leaves(stored))
    assert len(calls["jax"]) == 1

    assert len(train.main(args + ["--device", "cpu"])) == 3
    assert len(calls["port"]) == 3
    assert all(float(r.abs().max()) == 0
               for r in tree.leaves(calls["port"][0][0].residual))
    for (_, before), (after, _) in zip(calls["port"], calls["port"][1:]):
        assert before is after
        assert max(float(r.abs().max())
                   for r in tree.leaves(after.residual)) > 0
