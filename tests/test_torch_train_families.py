"""Training the MoE, SSM, hybrid, encoder-decoder and vision families: the
port's train step against the JAX package's, and the port's launcher, on
the CPU.

``make_train_step`` runs two steps for reduced moonshot-v1-16b-a3b (AdamW,
with the load-balance and router z-losses in the loss), mamba2-2.7b,
zamba2-7b (the shared block under remat), grok-1-314b (adafactor, its
config's optimizer), seamless-m4t-large-v2 (``src_embeds``: S / 4 frames)
and qwen2-vl-7b (``vision_embeds`` in the first 16 slots, (3, B, S) M-RoPE
positions, the mask 0 on the patch slots): ``test_torch_cuda.family_batch``.
Each step the port restarts from the JAX package's params and optimizer
state (``from_jax_params``, ``from_jax_opt_state``) on the same batch, and
is held as ``test_torch_train.test_train_step_matches_jax`` holds qwen3-4b:
loss, xent, grad_norm (and the MoE's aux losses) 1e-5 relative; the
optimizer's moments 1e-4 x their leaf's largest magnitude; the params 1e-3
x the step's rate where the optimizer does not amplify a gradient's
rounding and 2 x the rate everywhere (``test_torch_cuda.held_entries``: for
adafactor the analogous mask, no looser than Adam's). Entries whose update
is exactly 0 (an expert no token reached, zamba2's LoRA A factors while B
is 0, qwen2-vl's untied embedding rows of absent tokens) must not move in
either package: those params are held bit-equal. The entries held to 1e-3
x the rate cover 95% of the params and more than half of every leaf
(``test_torch_cuda.hold_step_params``; chip_smoke's ``TRAIN_MASK_SHARE``),
where qwen3-4b's test asks 98% of every leaf: a leaf of a few per-head
scalars can sit mostly below the mask at init (mamba's ``a_log``: 9 of
zamba2's 16 tail heads pass at step 1), and so can the MoE experts' hidden
units that GELU all but closes for their few tokens.

The launcher trains moonshot, mamba2, zamba2 and grok-1 at the reduced
preset for 3 steps: finite losses and one ``metrics.jsonl`` record a step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.train import optim as joptim
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import steps, transformer
from repro_torch.train import optim, tree
from test_torch_cuda import (TRAIN_FAMILIES, family_batch, held_entries,
                             hold_step_params)
from test_torch_train import _close_trees

LAUNCHED = TRAIN_FAMILIES[:4]  # the launcher refuses encdec and vision


def _sched(mod):
    return mod.warmup_cosine(3e-3, 2, 20)


def _moments(state, cfg):
    if cfg.optimizer == "adamw":
        return [state[0].mu, state[0].nu]
    return [state.vr, state.vc]


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_matches_jax(arch):
    """Two steps of the config's optimizer under warmup-cosine (3e-3, 2
    warm-up steps), B = 2 rows of S = 64, the port restarting each step
    from the JAX package's params and state: the tolerances of the module
    docstring."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jparams = jtf.init_model(jax.random.PRNGKey(1), jcfg)
    jopt = joptim.make_optimizer(jcfg.optimizer, _sched(joptim))
    topt = optim.make_optimizer(tcfg.optimizer, _sched(optim))
    jstate = jopt.init(jparams)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
    grads = []

    def keep(g):  # the gradients the optimizer receives, unchanged
        grads[:] = [g]
        return g

    tstep = steps.make_train_step(tcfg, topt, grad_transform=keep)
    keys = {"loss", "xent", "grad_norm"}
    if tcfg.moe is not None:
        keys |= {"load_balance_loss", "router_z_loss"}
    for s in range(2):
        tparams = transformer.from_jax_params(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        tstate = transformer.from_jax_opt_state(
            jax.tree.map(np.asarray, jstate), topt.init(tparams),
            device="cpu")
        batch = family_batch(tcfg, s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        tparams, tstate, tm = tstep(tparams, tstate, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tm) == keys
        for key in keys:
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-5), key
        assert tree.leaves(tstate)[0] == s + 1  # the count
        for mine, theirs in zip(_moments(tstate, tcfg),
                                _moments(jstate, jcfg)):
            _close_trees(mine, theirs, 0.0, atol_of_max=1e-4)
        hold_step_params(
            tree.leaf_paths(tparams),
            [torch.from_numpy(np.array(p, np.float32))
             for p in jax.tree.leaves(jparams)],
            held_entries(tcfg.optimizer, tstate, grads[0], s + 1),
            _sched(optim)(s))


@pytest.mark.parametrize("arch", LAUNCHED)
def test_train_launcher_trains_each_family(arch, tmp_path):
    """``launch/train.main`` at the reduced preset on the CPU, 3 steps of
    2 x 32 tokens with the config's optimizer: finite losses and grad
    norms, the first loss within 1.5 nats of ln V, and the metrics file one
    record a step."""
    path = tmp_path / "m.jsonl"
    losses = train.main(["--arch", arch, "--preset", "reduced", "--steps",
                         "3", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--metrics", str(path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["grad_norm"]) for r in recs)
    vocab = get_config(arch).reduced().vocab_size
    assert abs(losses[0] - np.log(vocab)) < 1.5


SLICED = {
    "adamw": lambda: optim.adamw(_sched(optim), weight_decay=0.01),
    "adam": lambda: optim.make_optimizer("adam", 0.05),
    "sgd-momentum": lambda: optim.sgd(_sched(optim), momentum=0.9),
    "clip+adamw": lambda: optim.chain(optim.clip_by_global_norm(1.0),
                                      optim.adamw(_sched(optim))),
}


@pytest.mark.parametrize("name", sorted(SLICED))
def test_sliced_step_keeps_the_bits(name, monkeypatch):
    """An elementwise transform's ``step`` takes a leaf above
    ``SLICE_BYTES`` in slices of its leading axis (one row of a (7, 5, 6)
    leaf at a time, ten rows of a (40, 3) one; bf16 params with fp32
    moments): three steps give the params and state of the unsliced step
    bit for bit. Adafactor, which reads a whole leaf (its moments' means,
    the RMS clip), is never sliced."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (7, 5, 6), "b": (40, 3), "c": (4,)}
    base = {k: torch.randn(s, generator=gen).bfloat16()
            for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen).bfloat16()
              for k, s in shapes.items()} for _ in range(3)]
    out = []
    for limit in (optim.SLICE_BYTES, 4 * 30):
        monkeypatch.setattr(optim, "SLICE_BYTES", limit)
        opt = SLICED[name]()
        assert opt.elementwise
        params = {k: v.clone() for k, v in base.items()}
        state = opt.init(params)
        for g in grads:
            state = opt.step(g, state, params)
        out.append((params, state))
    assert [len(optim._row_slices(grads[0][k])) for k in "abc"] == [7, 4, 1]
    (p1, s1), (p2, s2) = out
    for a, b in zip(tree.leaves((p1, s1)), tree.leaves((p2, s2))):
        if isinstance(a, int):
            assert a == b
        else:
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                               else a, b.view(torch.int16)
                               if b.dtype == torch.bfloat16 else b)
    assert not optim.make_optimizer("adafactor", 0.05).elementwise
