"""The port's SGNS loss, gradients, autograd wiring and train step against
the JAX package's, on the same numpy inputs.

Tolerances: the loss 1e-6 in fp32 (fp32 dots summed in another order) and
2e-2 in bf16 (as ``tests/kernels/test_sgns.py``); gradients 1e-6 absolute
(they are O(1e-2) here) with 1e-5 relative; a train step's loss, both
gradient tables and the parameters after Adam 1e-6. The CUDA kernels run
only on the card (``tests/test_torch_cuda.py``); here the autograd
``Function`` is wired to the plain callables, which checks the same
plumbing: the saved inputs, the stride-0 ``dout`` of a ``.mean()`` and the
gradient dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corewalk as jcorewalk
from repro.graph import datasets as jdatasets
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.skipgram import corpus as jcorpus
from repro.skipgram import model as jmodel
from repro.train import optim as joptim
from repro_torch.kernels import ops, ref, sgns
from repro_torch.skipgram import model
from repro_torch.skipgram.trainer import loss_and_grads
from repro_torch.train import optim

SHAPES = [(8, 128, 5), (32, 128, 1), (64, 256, 8), (16, 150, 5),
          (256, 128, 20)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, d, k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((b, d), (b, d), (b, k, d))]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,d,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_loss_matches_jax(b, d, k, dtype):
    j_in, t_in = _both(_inputs(b, d, k), dtype)
    tol = DTYPES[dtype][2]
    got = ops.sgns_loss(*t_in)  # auto on CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b,)
    for want in (jref.sgns_loss_ref(*j_in),
                 jops.sgns_loss(*j_in, impl="pallas_interpret")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,d,k", [(8, 128, 5), (16, 150, 3), (7, 1, 15)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_grads_match_jax_and_autograd(b, d, k, dtype):
    arrays = _inputs(b, d, k, seed=1)
    dout = np.random.default_rng(2).standard_normal(b).astype(np.float32)
    j_in, t_in = _both(arrays, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = ref.sgns_grads_ref(*t_in, torch.from_numpy(dout))
    want = jref.sgns_grads_ref(*j_in, jnp.asarray(dout))
    leaves = [t.clone().requires_grad_() for t in t_in]
    ref.sgns_loss_ref(*leaves).backward(torch.from_numpy(dout))
    for g, w, leaf, t in zip(got, want, leaves, t_in):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol / 10)
        np.testing.assert_allclose(g.float().numpy(),
                                   leaf.grad.float().numpy(),
                                   rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_function_wired_to_the_plain_callables(dtype):
    """``SGNSLoss`` (the wiring the CUDA path uses) with the plain fwd/bwd:
    the backward of ``.mean()`` gets a contiguous fp32 dout, and the
    gradients match autograd of the plain loss in the inputs' dtype."""
    _, t_in = _both(_inputs(9, 150, 5, seed=3), dtype)
    seen = []

    def bwd(c, x, n, dout):
        seen.append((dout.dtype, dout.is_contiguous(), dout.stride()))
        return ref.sgns_grads_ref(c, x, n, dout)

    leaves = [t.clone().requires_grad_() for t in t_in]
    loss = ops.SGNSLoss.apply(*leaves, ref.sgns_loss_ref, bwd)
    loss.mean().backward()
    assert seen == [(torch.float32, True, (1,))]
    plain = [t.clone().requires_grad_() for t in t_in]
    ref.sgns_loss_ref(*plain).mean().backward()
    tol = DTYPES[dtype][2]
    for a, b in zip(leaves, plain):
        assert a.grad.dtype == a.dtype
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol,
                                   atol=tol / 100)
    torch.testing.assert_close(loss, ref.sgns_loss_ref(*t_in))


def test_sgns_cuda_impl_refuses_cpu_tensors():
    _, t_in = _both(_inputs(4, 8, 2), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.sgns_loss(*t_in, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgns.sgns_bwd_cuda(*t_in, torch.ones(4))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.sgns_loss(*t_in, impl="pallas")


@pytest.fixture(scope="module")
def jax_corpus():
    g = jdatasets.load("tiny")
    plan = jcorewalk.deepwalk_plan(g.n_nodes, 4)
    return jcorpus.build_corpus(g.to_ell(), plan, 12, jax.random.PRNGKey(0))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_corpus, steps):
    """Train steps from JAX ``init_params`` on ids from JAX ``_sample``.

    Each step starts from the JAX parameters and Adam state, carried across
    by ``from_jax_params``, and checks: the loss and both gradient tables;
    Adam applied to the JAX gradients (the optimizer alone: parameters and
    moments); and the port's whole step on its own gradients. Adam's
    ``g / (sqrt(v) + eps)`` amplifies a gradient difference near eps (an
    entry whose sum cancels to 1e-9 moves by up to lr * 1e-3 when the two
    sums differ only in their order), so that last check covers the entries
    with ``sqrt(v_hat) > 100 eps`` and each step restarts from the JAX state.
    """
    dim, batch, window, n_neg, lr = 16, 96, 4, 5, 0.025
    c = jax_corpus
    jparams = jmodel.init_params(c.n_nodes, dim, jax.random.PRNGKey(1))
    jopt, topt = joptim.adam(lr), optim.adam(lr)
    jstate = jopt.init(jparams)
    for s in range(steps):
        tparams, tstate = model.from_jax_params(
            jax.tree.map(np.asarray, jparams),
            jax.tree.map(np.asarray, jstate), device="cpu")
        assert tstate.count == s
        ids = jcorpus._sample(c.walks, c.noise_cdf, jax.random.PRNGKey(10 + s),
                              batch, window, n_neg, c.length, c.n_real)
        jloss, jgrads = jax.value_and_grad(jmodel.batch_loss)(
            jparams, *ids, "ref")
        upd, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        tloss, tgrads = loss_and_grads(
            tparams, *(torch.tensor(np.asarray(i)).long() for i in ids))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                                   atol=1e-6)
        from_j = {k: torch.tensor(np.asarray(g)) for k, g in jgrads.items()}
        upd_j, state_j = topt.update(from_j, tstate, tparams)
        after_j = optim.apply_updates(tparams, upd_j)
        upd_t, state_t = topt.update(tgrads, tstate, tparams)
        after_t = optim.apply_updates(tparams, upd_t)
        c2 = 1 - 0.999 ** (s + 1)
        for k in ("emb_in", "emb_out"):
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(tgrads[k].numpy(),
                                       np.asarray(jgrads[k]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(after_j[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
            for mine, theirs in ((state_j.mu, jstate[0].mu),
                                 (state_j.nu, jstate[0].nu)):
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]), rtol=1e-6,
                                           atol=1e-12)
            ok = np.sqrt(state_t.nu[k].numpy() / c2) > 1e-6
            assert ok.any() or (s == 0 and k == "emb_in")  # emb_out is 0
            np.testing.assert_allclose(after_t[k].numpy()[ok], want[ok],
                                       rtol=1e-6, atol=1e-6)
    assert float(jnp.abs(jgrads["emb_in"]).max()) > 0 or steps == 1
